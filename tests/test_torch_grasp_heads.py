"""The grasp request on the heads ``PipelineConfig`` names: the MSG request
against the benchmark's plain reference (``bench_port/reference/msg.py``)
on seeded random weights, the default configuration's models and answers,
the refusal of a head of the wrong kind, the count of grouped bytes
(``ops/grouping.py`` ``count_grouped``), and how a program keeps every
registered counter (``utils/counters.py``). CPU only, small sizes."""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels.bn_relu import plain_bn_relu_eval
from pointnet_like_pose_estimation_tpu_torch.models import build_model, init_like_flax
from pointnet_like_pose_estimation_tpu_torch.nn.layers import BatchNormF32
from pointnet_like_pose_estimation_tpu_torch.ops.grouping import count_grouped
from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
from pointnet_like_pose_estimation_tpu_torch.pipeline.infer import MODEL_KEYS
from pointnet_like_pose_estimation_tpu_torch.utils import counters
from pointnet_like_pose_estimation_tpu_torch.utils.programs import ProgramCache, _Program

BENCH = Path(__file__).resolve().parents[1] / "bench_port"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import grasp, traffic  # noqa: E402
from harness.weights import make_state  # noqa: E402
from reference import msg  # noqa: E402

MSG = {"classifier": "pointnet2_cls_msg", "rotation": "rotation_msg", "sign": "sign_msg",
       "translation": "translation_msg", "width": "width"}
VANILLA = {"classifier": "pointnet2_cls_ssg", "rotation": "rotation", "sign": "sign",
           "translation": "translation", "width": "width"}


@pytest.mark.parametrize("seed", [3180000001, 2**31 + 17])
def test_msg_request_matches_the_plain_reference(seed):
    """The MSG request through ``infer_clusters`` (4 clusters of 512 points,
    resampled to 256 by FPS: one bucket, no padding) against the plain
    reference, judged as the benchmark judges it (``harness/grasp.py``:
    the reference follows the class and the hard sign the port served).
    Both run the same float32 operations in the same order on the CPU, so
    the gaps are expected to be 0; the limits, 1e-6 on the log-probabilities
    and 1e-6 of each head output's largest value, leave room only for a
    BLAS that blocks a sum otherwise, and lie far below what a bfloat16
    request or a swapped radius gives (1e-2 and more)."""
    states = {key: make_state(msg.build(name), (seed * 8 + i) % 2**63, "cpu")
              for i, (key, name) in enumerate(MSG.items())}
    cfg = PipelineConfig(num_points=256, **MSG)
    models = {}
    for key in MODEL_KEYS:
        models[key] = build_model(MSG[key])
        models[key].load_state_dict(states[key], strict=True)
    pipe = GraspPipeline(cfg, models, device="cpu")
    clusters = traffic.cluster_pool({"requests": 1, "clusters": 4, "points": 512}, seed)[0]
    served = pipe.infer_clusters(clusters)
    assert pipe.programs.keys() == [("request", 4, 512)]
    ref = msg.GraspReference(states, MSG, 256, 7, "float32", "cpu")
    gaps = grasp.gaps(ref, torch.from_numpy(clusters), served)
    assert gaps["class_err"] <= 1e-6 and gaps["head_err"] <= 1e-6, gaps


def test_the_default_config_serves_the_vanilla_heads_bit_for_bit():
    """``PipelineConfig()`` builds the PointNet++ SSG classifier and the
    PointNet heads, and serves the answers of models built by those names
    on the same weights, bit for bit."""
    cfg = PipelineConfig(num_points=256)
    assert {key: getattr(cfg, key) for key in MODEL_KEYS} == VANILLA
    pipe = GraspPipeline.from_random(cfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    by_name = {key: init_like_flax(build_model(VANILLA[key]), gen) for key in MODEL_KEYS}
    for key in MODEL_KEYS:
        assert type(pipe.models[key]) is type(by_name[key])
        got, want = pipe.models[key].state_dict(), by_name[key].state_dict()
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    clusters = traffic.cluster_pool({"requests": 1, "clusters": 3, "points": 300}, 5)[0]
    served = pipe.infer_clusters(clusters)
    again = GraspPipeline(cfg, by_name, device="cpu").infer_clusters(clusters)
    assert served.keys() == again.keys()
    for k in served:
        np.testing.assert_array_equal(served[k], again[k], err_msg=k)


@pytest.mark.parametrize("key,name", [("rotation", "sign_msg"), ("rotation", "translation_msg"),
                                      ("sign", "rotation_msg"), ("translation", "width"),
                                      ("translation", "rotation_ssg"), ("width", "sign"),
                                      ("classifier", "rotation_msg"), ("classifier", "pose_classify")])
def test_a_head_of_the_wrong_kind_is_refused(key, name):
    with pytest.raises(ValueError, match=f"PipelineConfig.{key}: '{name}'"):
        GraspPipeline.from_random(PipelineConfig(**{key: name}), device="cpu")


@pytest.mark.parametrize("key,name", [("classifier", "pointnet2_cls_msg"), ("classifier", "pointnet_cls"),
                                      ("rotation", "rotation_msg"), ("rotation", "pose"),
                                      ("sign", "sign_ssg"), ("translation", "translation_msg"),
                                      ("translation", "translation_no_mlp"), ("translation", "pose_mean")])
def test_a_head_of_the_right_kind_is_built(key, name):
    model = GraspPipeline._make(PipelineConfig(**{key: name}), key)
    assert type(model) is type(build_model(name))


def _msg_level(B, S, ks, channels):
    return sum(4 * B * S * k * channels for k in ks)


# bytes of the grouped tensors of one forward at B = 2, from the layers' shapes:
# MSG levels of 512 centroids (K 16/32/128) and 128 (K 32/64/128), the global level over
# the last level's centroids; the SSG levels of 512 (K 32) and 128 (K 64) centroids
GROUPED = {
    "pointnet2_cls_msg": (3, _msg_level(2, 512, (16, 32, 128), 3) + _msg_level(2, 128, (32, 64, 128), 320 + 3)
                          + 4 * 2 * 128 * (3 + 640)),
    "rotation_msg": (10, _msg_level(2, 512, (16, 32, 128), 10) + _msg_level(2, 128, (32, 64, 128), 320 + 10)
                     + 4 * 2 * 128 * (10 + 640)),
    "sign_msg": (10, _msg_level(2, 512, (16, 32, 128), 10) + 4 * 2 * 512 * (10 + 320)),
    "pointnet2_cls_ssg": (3, 4 * 2 * 512 * 32 * 3 + 4 * 2 * 128 * 64 * (3 + 128) + 4 * 2 * 128 * (3 + 256)),
    "width": (10, 0),
}


@pytest.mark.parametrize("name", sorted(GROUPED))
def test_grouped_bytes_count_the_shapes_and_add_up(name):
    channels, want = GROUPED[name]
    model = build_model(name).eval()
    x = torch.rand(2, 600, channels, generator=torch.Generator().manual_seed(0))
    before = count_grouped.bytes
    with torch.no_grad():
        model(x)
        assert count_grouped.bytes - before == want
        model(x)
    assert count_grouped.bytes - before == 2 * want


def _count_outside():
    """A counter of no module of the package, registered by the test."""
    _count_outside.launches += 1


# counter -> a call on the CPU that moves it, and by how much
COUNTING = {
    "grouped_bytes": (lambda: count_grouped(torch.zeros(3, 5)), 60),
    "bn_relu_eval_plain": (lambda: plain_bn_relu_eval(torch.ones(2, 4), BatchNormF32(4).eval()), 1),
    "outside": (_count_outside, 1),
}


@pytest.mark.parametrize("name", sorted(COUNTING))
def test_a_replay_adds_the_grouped_bytes_its_capture_recorded(name, monkeypatch):
    """A capture (here under a stand-in graph, no card) takes back what
    every registered counter counted and records the counters it moved;
    each replay adds them again: the grouped bytes, a kernel wrapper's
    launches (``kernels/bn_relu.py``, which ``utils/programs.py`` does not
    import) and a counter registered from outside the package. On the CPU a
    program is its function, which counts as it runs."""

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(counters, "_REGISTRY", dict(counters._REGISTRY))
    counters.counted("outside")(_count_outside)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, pool: contextlib.nullcontext())
    count, step = COUNTING[name]
    cache = ProgramCache("cpu")
    prog = _Program(fn=lambda: (count(), "out")[1], inputs=())
    before = counters.read()
    cache._capture(prog)
    assert counters.read() == before and prog.counts == {name: step}
    assert cache.replay(prog) == "out" and cache.replay(prog) == "out"
    assert counters.read() == {**before, name: before[name] + 2 * step}
    x = torch.rand(1, 300, 3)
    out = cache(("f", 1), lambda t: (count(), t * 2)[1], (x,))
    assert counters.read()[name] == before[name] + 3 * step and torch.equal(out, x * 2)
    assert cache.counts(("f", 1)) == {}
