"""The reference against the port at a tiny size on the CPU: the same
weights give the same grasps, the same frame gives the same clusters, and
the same generator state gives the same three train steps. (A test may
import both; the reference imports nothing of the port.)"""

import numpy as np
import pytest
import torch

from harness import grasp, traffic
from harness.weights import make_state
from reference import pipeline as RP
from reference import train as T
from reference.models import build

CONFIG = {"pipeline": {"num_points": 1024, "num_classes": 7, "dtype": "float32", "classifier": "pointnet2_cls_ssg"}}
FRAME_CFG = {"clip_range": [0.0, 2.0], "clip_axis": 2, "plane_threshold": 0.006, "plane_iterations": 1000,
             "radius_nb_points": 200, "radius": 0.05, "eps": 0.03, "min_points": 500}


@pytest.fixture(scope="module")
def weights():
    return grasp.states(CONFIG, 11, "cpu")


@pytest.mark.parametrize("M", [700, 1024, 1300])
def test_a_request_equals_the_ports(weights, M):
    pipe = grasp.port_pipeline({"pipeline": {**CONFIG["pipeline"]}}, weights, "cpu")
    clusters = traffic.cluster_pool({"requests": 1, "clusters": 3, "points": M}, 4)[0]
    served = pipe.infer_clusters(clusters)
    gaps = grasp.gaps(grasp.reference(CONFIG, weights, "cpu"), torch.from_numpy(clusters), served)
    # the port pads K to a multiple of 4, which may sum a product in another order on the CPU
    assert gaps["class_err"] < 1e-5 and gaps["head_err"] < 1e-5


def test_weights_are_the_seeds(weights):
    again = grasp.states(CONFIG, 11, "cpu")
    assert all(torch.equal(weights[k][n], again[k][n]) for k in weights for n in weights[k])
    other = make_state(build("rotation"), 12, "cpu")
    assert not torch.equal(other["mlp_pre.dense_0.weight"], weights["rotation"]["mlp_pre.dense_0.weight"])


def _blob_cloud(rng):
    """Two dense blobs, a sparse one and noise: clusters, border points and noise."""
    parts = [rng.normal(c, s, (n, 3)) for c, s, n in (((0, 0, 0), 0.02, 900), ((0.2, 0, 0), 0.02, 700),
                                                      ((0, 0.3, 0), 0.08, 300))]
    return np.concatenate(parts + [rng.uniform(-0.5, 0.5, (200, 3))]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dbscan_equals_the_ports(seed):
    from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess as pp

    pts = _blob_cloud(np.random.default_rng(seed))
    pts = pts[np.random.default_rng(seed + 10).permutation(len(pts))]
    for eps, mp in ((0.03, 60), (0.05, 120)):
        assert np.array_equal(RP.dbscan(pts, eps, mp, "cpu"), pp.dbscan(pts, eps, mp))


def test_a_frame_equals_the_ports(weights):
    mix = {"table_points": 20000, "far_outliers": 60, "object_points": 4000, "slots": [[-0.3, -0.2], [0.3, 0.2]]}
    frame = traffic.scene(mix, [0, 4], np.random.default_rng(3))
    pipe = grasp.port_pipeline({"pipeline": {**CONFIG["pipeline"]}}, weights, "cpu")
    served = pipe(frame)
    clusters, xyz = RP.frame_clusters(frame, FRAME_CFG, "cpu")
    assert served is not None and np.array_equal(served["clusters"], clusters)
    assert grasp.gaps(grasp.reference(CONFIG, weights, "cpu"), xyz, served)["class_err"] < 1e-5


def test_three_train_steps_follow_the_ports():
    from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig
    from pointnet_like_pose_estimation_tpu_torch.train.state import make_optimizer
    from pointnet_like_pose_estimation_tpu_torch.train.steps import make_epoch_runner

    torch.manual_seed(0)
    split = traffic.training_split({"per_class": 2, "num_points": 1024}, 5)
    data = {k: torch.from_numpy(v) for k, v in split.items()}
    cfg = TrainConfig.for_model("pointnet2_cls_ssg", batch_size=4)
    w = make_state(build("pointnet2_cls_ssg"), 5, "cpu")
    model = build_model("pointnet2_cls_ssg")
    model.load_state_dict(w)
    opt, _ = make_optimizer(cfg, model.parameters())
    runner = make_epoch_runner(get_model_spec("pointnet2_cls_ssg"), cfg, 3)
    gen = torch.Generator().manual_seed(9)
    gen_r = torch.Generator().manual_seed(9)
    tr = T.Trainer(w, 7, "float32", 1e-3, 1e-4, "cpu")
    for k in range(3):
        calls = iter(range(3))
        sums, n = runner(model, opt, data, gen, stop=lambda: next(calls) >= 1)
        rows, d = next(T.epoch_batches(gen_r, data, 4, 3, 1))
        loss, _ = tr.step(data["points"][rows], data["labels"][rows], d)
        # Adam's first steps turn the rounding of near-zero gradients into
        # whole steps of the learning rate, so the later losses part a little
        assert n == 1 and float(sums[0]) == pytest.approx(loss, rel=1e-6 if k == 0 else 1e-3)
        if k == 0:
            got = model.state_dict()
            for name, v in tr.leaves().items():
                assert torch.allclose(got[name], v, rtol=1e-5, atol=1e-7), name
