"""The port's tensor parallelism and head fan-out on the CPU against the
JAX package's ``parallel/``:

- ``tensor_parallel_specs`` of ``rotation``, parameter by parameter and
  BatchNorm statistic by statistic, and ``count_sharded``, equal to JAX's
  on the same model under the name map (a Linear ``weight`` is JAX's
  ``kernel`` transposed, so its spec is JAX's reversed);
- two DP x TP steps of ``rotation`` on ``{"data": 2, "model": 2}`` (4
  ranks spawned by ``torch_parallel_workers.spawn``) against the
  single-process step on the same draws: loss at rtol 1e-4, BatchNorm
  statistics at rtol 1e-3 / atol 1e-5 (JAX's
  ``test_tp_step_matches_single_device_step`` bounds), the gradients of
  the second step at 1e-6 of their scale (both sides run in float64);
- a model not sharded over ``tp_axis`` is refused;
- ``MultiHeadParallel`` over two CPU devices against
  ``GraspPipeline.infer_clusters`` at ``rtol=1e-4, atol=1e-5`` and
  against JAX's ``MultiHeadParallel`` on the committed checkpoints at the
  serving tests' ``rtol=atol=1e-4`` (``JAX_TOL``).
"""

import os

import jax
import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu.parallel import (
    MultiHeadParallel as JaxMultiHeadParallel,
    count_sharded as jax_count_sharded,
    make_mesh as jax_make_mesh,
    tensor_parallel_specs as jax_tensor_parallel_specs,
)
from pointnet_like_pose_estimation_tpu.pipeline import GraspPipeline as JaxPipeline
from pointnet_like_pose_estimation_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.nn import pre_bn_biases
from pointnet_like_pose_estimation_tpu_torch.parallel import MultiHeadParallel
from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, draw_step, make_optimizer, make_train_step
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import from_flax_variables
from test_torch_parallel_dp import _batch
from test_torch_registry import perturbed_variables
from torch_parallel_workers import _tensors, spawn, tp_worker

WORLD, B, N = 4, 8, 32
# the port's serving outputs against the JAX package's, as in
# test_torch_pipeline.py: float32 products and sums in another order put a
# rotation of ~1 degree 1.7e-4 from JAX's on these clusters
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = {
    "classifier": "log/classification/r3_pointnet2_cls_ssg/checkpoints/best.msgpack",
    "rotation": "log/pose/r3_rotation/checkpoints/best.msgpack",
    "sign": "log/pose/r3_sign/checkpoints/best.msgpack",
    "translation": "log/pose/r3_translation_ref/checkpoints/best.msgpack",
    "width": "log/pose/r3_width_ref/checkpoints/best.msgpack",
}


@pytest.fixture(scope="module")
def case():
    _, variables = perturbed_variables("rotation")
    weights = from_flax_variables(variables)
    cfg = dict(num_points=N, batch_size=B, augment=False)
    model = build_model("rotation", 7)
    steps = []
    for seed in (0, 1):
        batch = _batch(B, N, seed)
        draws = draw_step(TrainConfig.for_model("rotation", **cfg), model, _tensors(batch, torch.float64),
                          torch.Generator().manual_seed(seed))
        steps.append((batch, {"augment": None, "dropout": {k: v.double() for k, v in draws["dropout"].items()}}))
    return {"variables": variables, "weights": weights, "cfg": cfg, "steps": steps}


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    port_case = {k: v for k, v in case.items() if k != "variables"}
    return spawn(tp_worker, WORLD, tmp_path_factory.mktemp("tp"), port_case)


def test_tensor_parallel_specs_and_count_match_jax(case, ranks):
    jmesh = jax_make_mesh({"data": 2, "model": WORLD}, devices=jax.devices()[:2 * WORLD])
    jspecs = jax_tensor_parallel_specs(case["variables"], jmesh)
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        names = [str(getattr(k, "key", k)) for k in path]
        flat[tuple(names)] = spec
    # the name map: flax paths onto state_dict keys, through from_flax_variables
    keyed = {}
    for names, spec in flat.items():
        leaf_dict = {"params": {}, "batch_stats": {}}
        node = leaf_dict
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = np.zeros((2, 2) if names[-1] == "kernel" else (2,), np.float32)
        (key,) = [k for k in from_flax_variables(leaf_dict) if not k.endswith("num_batches_tracked")]
        axes = tuple(spec) + (None,) * (2 - len(tuple(spec)))
        keyed[key] = axes[::-1] if names[-1] == "kernel" else axes[:1]
    got = ranks[0]["specs"]
    assert set(got) - {k for k in got if k.endswith("num_batches_tracked")} == set(keyed)
    for key, spec in keyed.items():
        assert tuple(got[key]) == spec, key
    assert ranks[0]["count"] == jax_count_sharded(case["variables"]["params"], jmesh)
    sharded, total = ranks[0]["count"]
    assert sharded > total * 0.5                  # the 1024-wide layers and the 1024-512-256 head
    assert any(s == ("model", None) for s in got.values()) and any(s == (None, "model") for s in got.values())


def test_tp_step_matches_the_single_step(case, ranks):
    cfg = TrainConfig.for_model("rotation", **case["cfg"])
    model = build_model("rotation", 7)
    model.load_state_dict(case["weights"])
    model = model.double()
    opt, _ = make_optimizer(cfg, model.parameters())
    step = make_train_step(get_model_spec("rotation"), cfg)
    noisy = pre_bn_biases(model)
    for i, (batch, draws) in enumerate(case["steps"]):
        out = step(model, opt, _tensors(batch, torch.float64), draws=draws)
        grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
        scale = max(np.abs(g).max() for g in grads.values())
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        for r in ranks:
            got = r["steps"][i]
            np.testing.assert_allclose(got["loss"], float(out["loss"]), rtol=1e-4)
            for k, v in state.items():
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(got["state"][k], v[r["index"][k]], rtol=1e-3, atol=1e-5, err_msg=k)
            for k, g in grads.items():
                if k not in noisy:
                    np.testing.assert_allclose(got["grads"][k], g[r["index"][k]], rtol=1e-6, atol=1e-6 * scale,
                                               err_msg=k)
    assert "shard_state_tp" in ranks[0]["unsharded"]


def test_multihead_fan_out_matches_infer_clusters_and_jax():
    paths = {k: os.path.join(ROOT, v) for k, v in CHECKPOINTS.items()}
    pipe = GraspPipeline.from_checkpoints(PipelineConfig(), paths, device="cpu")
    mhp = MultiHeadParallel(pipe.models, num_classes=7, devices=["cpu", "cpu"])
    assert [d.type for d in mhp.placement.values()] == ["cpu"] * 5
    jax_mhp = JaxMultiHeadParallel(JaxPipeline.from_checkpoints(JaxPipelineConfig(), paths).models, num_classes=7)
    rng = np.random.default_rng(3)
    xyz = (rng.uniform(-0.5, 0.5, (6, 1, 3)) + 0.05 * rng.standard_normal((6, 1024, 3))).astype(np.float32)
    got = mhp(xyz)
    for want, tol in ((pipe.infer_clusters(xyz), dict(rtol=1e-4, atol=1e-5)), (jax_mhp(xyz), JAX_TOL)):
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["pred_class"], np.asarray(want["pred_class"]))
        for k in got:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k, **tol)
