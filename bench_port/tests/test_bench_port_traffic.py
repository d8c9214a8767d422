"""The traffic generator: the same seed gives the same inputs, another
seed other inputs of the same sizes."""

import numpy as np
import pytest

from harness import traffic

CLUSTERS = {"requests": 2, "clusters": 3, "points": 300}
CAMERA = {"table_points": 2000, "far_outliers": 60, "object_points": 500, "objects": [2, 3, 4],
          "slots": [[-0.3, -0.2], [0.0, -0.2], [0.3, -0.2], [-0.3, 0.2]], "scene_seconds": 1.0,
          "depth_sd": 0.001, "max_dropout": 0.05}


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


@pytest.mark.parametrize("make", [
    lambda s: traffic.cluster_pool(CLUSTERS, s),
    lambda s: traffic.training_split({"per_class": 2, "num_points": 64}, s),
    lambda s: traffic.camera(CAMERA, s, 3.0, 2.0),
], ids=["clusters", "training_split", "camera"])
def test_deterministic_by_seed(make):
    big = 2**31 + 12345
    assert _same(make(big), make(big))
    assert not _same(make(big), make(big + 1))


def test_cluster_pool_sizes():
    pool = traffic.cluster_pool(CLUSTERS, 5)
    assert pool.shape == (2, 3, 300, 3) and pool.dtype == np.float32


def test_training_split_is_balanced():
    split = traffic.training_split({"per_class": 3, "num_points": 32}, 7)
    assert split["points"].shape == (21, 32, 3)
    assert np.bincount(split["labels"]).tolist() == [3] * 7


def test_camera_schedule_has_the_same_work_for_every_seed():
    for seed in (1, 2):
        frames, scene_of, warm = traffic.camera({**CAMERA, "warm_frames": 3}, seed, 3.0, 2.0)
        assert len(frames) == 6 and scene_of == [0, 0, 1, 1, 2, 2] and len(warm) == 9
    # a scene's size is fixed by its objects' categories, whatever else the seed draws
    for seed in (1, 2, 3):
        sizes = [len(traffic.scene(CAMERA, cats, np.random.default_rng(seed))) for cats in ([0, 2], [0, 2, 5])]
        assert sizes == [3060, 3560]


def test_frames_face_the_camera():
    frame = traffic.scene(CAMERA, [0, 5], np.random.default_rng(0))
    assert (frame[:2000, 2] > 0.69).all() and (frame[2000:3000, 2] < 0.67).all()


def test_set_up_frames_are_drawn_apart_from_the_window():
    frames, scene_of, warm = traffic.camera({**CAMERA, "warm_frames": 3}, 9, 3.0, 2.0)
    # the whole frame of each scene first, then the others scene by scene
    whole = [len(w) for w in warm[:3]]
    assert all(len(f) <= whole[j] for f, j in zip(frames, scene_of))
    assert all(len(w) < whole[0] for w in warm[3:5]) and len(warm[-1]) < whole[2]
    assert not any(len(w) == len(f) and np.array_equal(w, f) for w in warm for f in frames)
