"""The port's data-parallel layer on the CPU (gloo, ranks spawned by
``torch_parallel_workers.spawn``) against the JAX package's
``parallel/`` on conftest's virtual devices and against the port's own
single-process step.

- meshes of ``{"data": 4}`` and ``{"data": 2, "points": 2}`` and
  ``shard_batch``'s rows, the rows of JAX's addressable shards on the same
  mesh; a mesh past the world raises JAX's message;
- the synced BatchNorm over 4 ranks, forward and backward, equal to one
  process's BatchNorm over the global batch (float64, 1e-10);
- the DP step of ``pointnet_cls`` (B = 16, 4 ranks, ``augment=False``,
  dropout off on both sides) against JAX's ``make_parallel_train_step``,
  both in float64: loss, metric, BatchNorm statistics and gradients at
  ``test_torch_train.py``'s 1e-4;
- the same step with augmentation and dropout against the port's
  single-process step on the same draws split by rows (float64 but the
  float32 log-softmax, 1e-6);
- ``rotation``, ``sign`` and ``translation`` DP steps on each rank's own
  draws come out finite;
- ``collective_traffic`` of a float32 ``pointnet_cls`` step on 4 ranks:
  the gradient all-reduce moves 4 bytes a parameter exactly, and the total
  lies within the bounds of JAX's ``test_collective_traffic_from_hlo``;
- ``train(data_parallel=True, multihost=True)`` over 2 ranks through
  ``env://``: an epoch, then a resumed one, only rank 0 writing.
"""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu.models import get_model_spec as jax_model_spec
from pointnet_like_pose_estimation_tpu.parallel import (
    make_mesh as jax_make_mesh,
    make_parallel_train_step as jax_parallel_step,
    replicate as jax_replicate,
    shard_batch as jax_shard_batch,
)
from pointnet_like_pose_estimation_tpu.train import loop as jax_loop
from pointnet_like_pose_estimation_tpu.train.config import TrainConfig as JaxTrainConfig
from pointnet_like_pose_estimation_tpu.utils.hlo import compiled_collective_traffic
from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.nn import BatchNormF32, pre_bn_biases
from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, draw_step, make_optimizer, make_train_step
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import from_flax_variables
from test_torch_registry import perturbed_variables
from test_torch_train import _f64, _numpy, _recording, no_jax_dropout  # noqa: F401
from torch_parallel_workers import _tensors, dp_worker, spawn, train_worker

WORLD, B, N, TOL = 4, 16, 32, 1e-4
# DP against the single-process step, both float64 but for the classifier's
# log-softmax, which both packages take in float32 (a loss of ~2.3 rounds at
# ~1e-7): 1e-6
SPLIT_TOL = dict(rtol=1e-6, atol=1e-6)


def _batch(Bn, Nn, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bn, Nn, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    return {
        "points": (x + rng.uniform(-0.3, 0.3, (Bn, 1, 3))).astype(np.float32),
        "labels": rng.integers(0, 7, Bn).astype(np.int32),
        "rot": rng.uniform(0, 90, (Bn, 3)).astype(np.float32),
        "tran": rng.uniform(-0.5, 0.5, (Bn, 3)).astype(np.float32),
        "sign": np.where(rng.random(Bn) > 0.5, 1.0, -1.0).astype(np.float32),
        "width": rng.uniform(0.02, 0.1, (Bn, 1)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def case():
    _, variables = perturbed_variables("pointnet_cls")
    weights = from_flax_variables(variables)
    rng = np.random.default_rng(5)
    step_batch = _batch(B, N, 8)
    cfg = dict(num_points=N, batch_size=B, augment=False)
    model = build_model("pointnet_cls", 7)
    draws = draw_step(TrainConfig.for_model("pointnet_cls", **{**cfg, "augment": True}), model,
                      _tensors(step_batch, torch.float64), torch.Generator().manual_seed(3))
    draws = {part: {k: v.double() for k, v in d.items()} for part, d in draws.items()}
    return {
        "batch": {"labels": np.arange(B), "points": np.zeros((B, 2, 3), np.float32)},
        "bn": (rng.standard_normal((B, 6)) * 3 + 1, rng.uniform(0.5, 1.5, 6), rng.standard_normal(6),
               rng.standard_normal((B, 6))),
        "variables": variables, "weights": weights, "step_batch": step_batch, "cfg": cfg, "draws": draws,
        "small_batch": _batch(8, 32, 9), "traffic_batch": _batch(8, 64, 10),
    }


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    cfg = {k: v for k, v in case.items() if k != "variables"}
    return spawn(dp_worker, WORLD, tmp_path_factory.mktemp("dp"), cfg)


def test_mesh_shapes_and_shard_batch_rows_match_jax(case, ranks):
    for mesh_key, axes in (("mesh", {"data": 4}), ("mesh22", {"data": 2, "points": 2})):
        jmesh = jax_make_mesh(axes, devices=jax.devices()[:4])
        shards = jax_shard_batch({"labels": jnp.asarray(case["batch"]["labels"])}, jmesh)["labels"]
        want = {s.device.id: np.asarray(s.data) for s in shards.addressable_shards}
        for rank, got in enumerate(ranks):
            assert got[mesh_key]["shape"] == dict(jmesh.shape)
            np.testing.assert_array_equal(got[mesh_key]["rows"], want[jax.devices()[rank].id])
        assert [r[mesh_key]["data"] for r in ranks] == (
            [0, 1, 2, 3] if mesh_key == "mesh" else [0, 0, 1, 1])
    assert [r["mesh22"]["points"] for r in ranks] == [0, 1, 0, 1]
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh({"data": 8}, devices=jax.devices()[:4])
    assert ranks[0]["too_big"] == str(jax_err.value)


def test_synced_batchnorm_equals_one_batchnorm_over_the_global_batch(case, ranks):
    x, w, b, cot = (torch.from_numpy(a) for a in case["bn"])
    bn = BatchNormF32(x.shape[1]).double().train()
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    xg = x.clone().requires_grad_()
    y = bn(xg)
    (y * cot).sum().backward()
    tol = dict(rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.concatenate([r["bn"]["y"] for r in ranks]), y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([r["bn"]["gx"] for r in ranks]), xg.grad.numpy(), **tol)
    # each rank's parameter gradients are its rows' share; they sum to the whole
    np.testing.assert_allclose(sum(r["bn"]["gw"] for r in ranks), bn.weight.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(r["bn"]["gb"] for r in ranks), bn.bias.grad.numpy(), **tol)
    for r in ranks:
        np.testing.assert_allclose(r["bn"]["mean"], bn.running_mean.numpy(), **tol)
        np.testing.assert_allclose(r["bn"]["var"], bn.running_var.numpy(), **tol)


def test_dp_step_matches_jax_parallel_step(case, ranks, no_jax_dropout):  # noqa: F811
    with jax.enable_x64(True):
        jcfg = JaxTrainConfig.for_model("pointnet_cls", num_points=N, batch_size=B, augment=False)
        _, _, state = jax_loop.build_state(jcfg)
        v64 = _f64(case["variables"])
        tx = _recording(state.tx)
        state = state.replace(params=v64["params"], batch_stats=v64["batch_stats"], tx=tx,
                              opt_state=tx.init(v64["params"]))
        mesh = jax_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
        jbatch = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype)
                  for k, v in case["step_batch"].items()}
        step = jax_parallel_step(jax_model_spec("pointnet_cls"), jcfg, mesh)
        new_state, metrics = step(jax_replicate(state, mesh), jax_shard_batch(jbatch, mesh))
        jgrads = from_flax_variables({"params": _numpy(new_state.opt_state[0])})
        stats = from_flax_variables(_numpy({"params": new_state.params, "batch_stats": new_state.batch_stats}))
        metrics = _numpy(metrics)
    for r in ranks:
        got = r["vs_jax"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["metric"], float(metrics["metric"]), rtol=TOL, atol=TOL)
        assert set(got["grads"]) == set(jgrads)
        for k, g in jgrads.items():
            np.testing.assert_allclose(got["grads"][k], g.numpy(), rtol=TOL, atol=TOL, err_msg=k)
        for k, v in stats.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got["state"][k], v.numpy(), rtol=TOL, atol=TOL, err_msg=k)


def test_dp_step_matches_the_single_process_step_on_split_draws(case, ranks):
    cfg = TrainConfig.for_model("pointnet_cls", **{**case["cfg"], "augment": True})
    model = build_model("pointnet_cls", 7)
    model.load_state_dict(case["weights"])
    model = model.double()
    opt, _ = make_optimizer(cfg, model.parameters())
    out = make_train_step(get_model_spec("pointnet_cls"), cfg)(
        model, opt, _tensors(case["step_batch"], torch.float64), draws=case["draws"])
    noisy = pre_bn_biases(model)
    params = dict(model.named_parameters())
    for r in ranks:
        got = r["vs_single"]
        np.testing.assert_allclose(got["loss"], float(out["loss"]), **SPLIT_TOL)
        np.testing.assert_allclose(got["metric"], float(out["metric"]), **SPLIT_TOL)
        for k, p in params.items():
            np.testing.assert_allclose(got["grads"][k], p.grad.numpy(), err_msg=k, **SPLIT_TOL)
        for k, v in model.state_dict().items():
            if k not in params:
                np.testing.assert_allclose(got["state"][k], v.numpy(), err_msg=k, **SPLIT_TOL)
                continue
            # Adam's first step follows the sign of a gradient at its rounding
            # floor: the pre-BN biases and gradients under 1e-6 move by at
            # most the learning rate on both sides
            floor = np.abs(params[k].grad.numpy()) < 1e-6
            if k in noisy:
                floor[...] = True
            np.testing.assert_allclose(got["state"][k][floor], v.numpy()[floor], rtol=0,
                                       atol=2 * cfg.learning_rate, err_msg=k)
            np.testing.assert_allclose(got["state"][k][~floor], v.numpy()[~floor], err_msg=k, **SPLIT_TOL)


@pytest.mark.parametrize("name", ["rotation", "sign", "translation"])
def test_dp_step_of_the_pose_heads_is_finite_and_agreed(ranks, name):
    values = [r["finite"][name] for r in ranks]
    assert all(np.isfinite(v).all() for v in values)
    assert all(v == values[0] for v in values)          # the global means, on every rank


def test_collective_traffic_of_a_dp_step(ranks):
    """JAX counts the step's HLO (``utils/hlo.py``); the port counts what it
    issues. The gradients are one all-reduce of 4 bytes a parameter."""
    n_params = ranks[0]["n_params"]
    traffic = ranks[0]["traffic"]
    assert all(r["traffic"] == traffic for r in ranks)
    assert traffic["by_site"]["gradients"]["all-reduce"]["bytes"] == 4 * n_params
    assert traffic["by_op"]["all-reduce"]["count"] >= 1
    assert n_params * 4 <= traffic["total_bytes"] <= n_params * 4 * 4, traffic

    jcfg = JaxTrainConfig.for_model("pointnet_cls", num_points=64, batch_size=8)
    spec, _, state = jax_loop.build_state(jcfg)
    assert sum(x.size for x in jax.tree.leaves(state.params)) == n_params
    mesh = jax_make_mesh({"data": 4}, devices=jax.devices()[:4])
    step = jax_parallel_step(jax_model_spec("pointnet_cls"), jcfg, mesh)
    zeros = {"points": jnp.zeros((8, 64, 3)), "labels": jnp.zeros((8,), jnp.int32), "rot": jnp.zeros((8, 3)),
             "tran": jnp.zeros((8, 3)), "sign": jnp.ones((8,)), "width": jnp.zeros((8, 1))}
    compiled = jax.jit(step).lower(jax_replicate(state, mesh), jax_shard_batch(zeros, mesh)).compile()
    print(f"pointnet_cls DP step on 4 ranks, {n_params} parameters: the port issues "
          f"{traffic['total_bytes']} bytes {traffic['by_site']}; JAX's compiled step "
          f"{compiled_collective_traffic(compiled)}")


def test_train_data_parallel_through_env_resumes_and_only_rank_zero_writes(tmp_path):
    rng = np.random.default_rng(11)

    def ds(M):
        b = _batch(M, 32, int(rng.integers(1 << 30)))
        return {"points": b["points"], "labels": b["labels"], "rot": b["rot"], "tran": b["tran"],
                "sign": b["sign"], "width": b["width"][:, 0]}

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    log_dir = str(tmp_path / "log")
    got = spawn(train_worker, 2, tmp_path, port, log_dir, ds(16), ds(8), store=False)
    assert [r["world"] for r in got] == [2, 2]
    for r in got:
        assert [row["epoch"] for row in r[1]] == [0] and [row["epoch"] for row in r[2]] == [1]
        assert r[1][0]["train_loss"] == got[0][1][0]["train_loss"]
        assert np.isfinite(r[2][0]["train_loss"])
    assert got[1]["wrote"] == []
    assert got[0]["wrote"] == ["best.pt", "latest.pt", "history.json", "latest.pt", "history.json"] or \
        got[0]["wrote"] == ["best.pt", "latest.pt", "history.json", "best.pt", "latest.pt", "history.json"]
    for k, v in got[0]["state"].items():
        np.testing.assert_array_equal(got[1]["state"][k], v, err_msg=k)
    exp = os.path.join(log_dir, "pose", "dp")
    assert os.path.exists(os.path.join(exp, "config.json"))
    with open(os.path.join(exp, "history.json")) as f:
        assert [row["epoch"] for row in json.load(f)] == [0, 1]
    # a resumed run started from latest.pt: the second call's model is the
    # first call's trained on
    model = build_model("rotation", 7)
    model.load_state_dict(torch.load(os.path.join(exp, "checkpoints", "latest.pt"), weights_only=True)["model"])
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[0]["state"][k], err_msg=k)
