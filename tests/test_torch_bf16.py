"""The port in bfloat16 on the CPU against the JAX package in bfloat16.

In both packages the compute dtype reaches only the Linear (flax ``Dense``)
layers: the product and then the bias add are rounded to bfloat16, while
parameters, BatchNorm (``batch_norm_f32`` in JAX, ``BatchNormF32`` here),
ReLU, the max over a group and the losses stay float32. Each comparison
states two numbers (``test_torch_registry.assert_bf16_close``): the port's
bfloat16 output against JAX's bfloat16 output at ``BF16_TOL``, and its gap
from JAX's float32 output, which may not exceed twice JAX's own.

- the layers (``PointwiseMLP``, the three ``DenseHead`` styles, SA, MSG SA,
  the T-Net) in eval mode; every registry model is in
  ``test_torch_registry.py``;
- one train step of ``translation`` at batch 16 against JAX's bfloat16
  step run op by op, on JAX's augmentation draws with dropout off (see
  ``test_torch_train.py``); the gradients by relative L2 (constants below);
- ``evaluate`` of the committed ``r5_pn2_ssg_bf16`` checkpoint in
  bfloat16 against JAX ``evaluate`` in bfloat16;
- the grasp pipeline in bfloat16 against the JAX one.
"""

import dataclasses
import os

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu import nn as jnn
from pointnet_like_pose_estimation_tpu.data import dataset as jax_dataset
from pointnet_like_pose_estimation_tpu.models import get_model_spec as jax_model_spec
from pointnet_like_pose_estimation_tpu.train import loop as jax_loop
from pointnet_like_pose_estimation_tpu.train import steps as jax_steps
from pointnet_like_pose_estimation_tpu.train.config import TrainConfig as JaxTrainConfig
from pointnet_like_pose_estimation_tpu_torch import nn as tnn
from pointnet_like_pose_estimation_tpu_torch.data.dataset import PoseDataset
from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.nn import pre_bn_biases, set_compute_dtype
from pointnet_like_pose_estimation_tpu_torch.train import (
    TrainConfig,
    evaluate,
    load_checkpoint,
    make_optimizer,
    make_train_step,
)
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import from_flax_variables
from test_torch_registry import BF16_TOL, assert_bf16_close, perturbed_variables
from test_torch_train import _jax_draws, _numpy, _recording, no_jax_dropout, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one bfloat16 train step (translation, batch 16): loss within LOSS_TOL of
# JAX's bfloat16 loss (measured 2.1e-3); every gradient tensor's relative L2
# gap from JAX's float32 gradient within twice JAX's own bfloat16 gap, or
# within GRAD_FLOOR where that is smaller (measured: at most 2.07 times
# JAX's gap, on gaps under 6e-3); all gradients together within
# GRAD_REL_L2 of JAX's bfloat16 ones (measured 0.13: each backward rounds
# its products to bfloat16, and a one-ulp difference in a forward value
# moves the gradients of the BatchNorms that follow by percents, in JAX's
# own bfloat16 step as much: 0.22 from its float32 step); BatchNorm
# statistics, which stay float32, within STATS_TOL (measured 2.1e-3).
LOSS_TOL, GRAD_FLOOR, GRAD_REL_L2, STATS_TOL = 5e-3, 1e-2, 0.25, 5e-3


def _perturbed(jmodule, *inputs, seed=0):
    """flax variables of ``jmodule`` as numpy, with BatchNorm statistics and
    affine parameters moved off their initial values and a T-Net's zero
    output kernel given small values (as ``perturbed_variables`` does)."""
    variables = flax.core.unfreeze(jmodule.init(jax.random.PRNGKey(seed), *inputs, train=False))
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(variables)
    for path, v in flat.items():
        v = np.array(v, np.float32)
        if path[-1] == "mean":
            v += 0.1 * rng.standard_normal(v.shape)
        elif path[-1] == "var":
            v *= rng.uniform(0.5, 1.5, v.shape)
        elif path[-1] == "scale":
            v *= rng.uniform(0.8, 1.2, v.shape)
        elif path[-1] == "bias" and path[-2].startswith("bn"):
            v += 0.05 * rng.standard_normal(v.shape)
        elif path[-1] == "kernel" and path[-2] == "out":
            v += 0.02 * rng.standard_normal(v.shape)
        flat[path] = v.astype(np.float32)
    return flax.traverse_util.unflatten_dict(flat)


def _cloud(B, N, P, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    if P > 3:
        x = np.concatenate([x, np.abs(rng.standard_normal((B, N, P - 3))).astype(np.float32)], -1)
    return x


LAYERS = {
    # name: (JAX module factory taking dtype, port module, inputs)
    "PointwiseMLP": (lambda dt: jnn.PointwiseMLP([32, 48, 16], dtype=dt),
                     lambda: tnn.PointwiseMLP(6, [32, 48, 16]), [_cloud(2, 64, 6, 1)]),
    "DenseHead cls_v1": (lambda dt: jnn.DenseHead([32, 16, 7], style="cls_v1", dtype=dt),
                         lambda: tnn.DenseHead(24, [32, 16, 7], style="cls_v1"),
                         [_cloud(4, 1, 24, 2)[:, 0]]),
    "DenseHead cls_v2": (lambda dt: jnn.DenseHead([32, 16, 7], style="cls_v2", dtype=dt),
                         lambda: tnn.DenseHead(24, [32, 16, 7], style="cls_v2"),
                         [_cloud(4, 1, 24, 3)[:, 0]]),
    "DenseHead pose": (lambda dt: jnn.DenseHead([32, 16, 3], style="pose", dtype=dt),
                       lambda: tnn.DenseHead(24, [32, 16, 3], style="pose"),
                       [_cloud(4, 1, 24, 4)[:, 0]]),
    "SetAbstraction": (lambda dt: jnn.SetAbstraction(32, 16, 0.4, [32, 64], dtype=dt),
                       lambda: tnn.SetAbstraction(32, 16, 0.4, 3 + 5, [32, 64]),
                       [_cloud(2, 128, 3, 5), _cloud(2, 128, 8, 6)[..., 3:]]),
    "SetAbstractionMSG": (lambda dt: jnn.SetAbstractionMSG(32, [8, 16], [0.2, 0.4], [[16, 32], [32, 32]],
                                                          dtype=dt),
                          lambda: tnn.SetAbstractionMSG(32, [8, 16], [0.2, 0.4], 5 + 3,
                                                        [[16, 32], [32, 32]]),
                          [_cloud(2, 128, 3, 7), _cloud(2, 128, 8, 8)[..., 3:]]),
    "TNet": (lambda dt: jnn.TNet(k=4, dtype=dt), lambda: tnn.TNet(4), [_cloud(2, 64, 4, 9)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax_bfloat16(name):
    jax_make, port_make, inputs = LAYERS[name]
    jin = [jnp.asarray(x) for x in inputs]
    variables = _perturbed(jax_make(None), *jin)
    want32 = jax_make(None).apply(variables, *jin, train=False)
    want16 = jax_make(jnp.bfloat16).apply(variables, *jin, train=False)
    port = set_compute_dtype(port_make(), "bfloat16").eval()
    port.load_state_dict(from_flax_variables(variables), strict=True)
    with torch.no_grad():
        got = port(*[torch.from_numpy(x) for x in inputs])
    if name.startswith("Set"):                  # (centroids, features): float32 centroids, equal
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want16[0]))
        got, want16, want32 = got[1], want16[1], want32[1]
    assert str(got.dtype) == f"torch.{want16.dtype}"
    assert_bf16_close(got, want16, want32, name)


def test_tnet_transform_promotes_to_float32():
    """A float32 cloud times a bfloat16 transform is a float32 product, as
    ``jnp.einsum`` promotes; the orthogonality penalty of a bfloat16
    transform stays bfloat16 (JAX's too) until the float32 loss takes it."""
    x = torch.from_numpy(_cloud(2, 16, 3, 10))
    t = torch.eye(3).expand(2, 3, 3).to(torch.bfloat16)
    out = tnn.apply_transform(x, t)
    assert out.dtype == torch.float32 and torch.equal(out, x)
    assert tnn.orthogonality_regularizer(t).dtype == torch.bfloat16


def test_compute_dtype_reaches_every_linear_and_nothing_else():
    model = build_model("pointnet_cls", dtype="bfloat16")
    linears = [m for m in model.modules() if isinstance(m, torch.nn.Linear)]
    assert linears and all(m.compute_dtype == torch.bfloat16 for m in linears)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(m.compute_dtype is None for m in build_model("pointnet_cls").modules()
               if isinstance(m, torch.nn.Linear))
    with pytest.raises(ValueError, match="unknown compute dtype"):
        build_model("pointnet_cls", dtype="float16")


def test_train_step_matches_jax_bfloat16_step(no_jax_dropout):  # noqa: F811
    """One train step of ``translation`` at batch 16 in bfloat16: JAX's
    bfloat16 and float32 steps run op by op (``make_train_step`` with jit
    disabled, as ``test_torch_train.py`` runs them) on the same variables,
    batch and augmentation draws. The constants and what they measured are
    at the top of this file; the pre-BN biases, whose true gradient is 0,
    are left out of the gradient comparison."""
    name, B, N = "translation", 16, 128
    _, variables = perturbed_variables(name)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    batch = {"points": (x / np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
                        + rng.uniform(-0.3, 0.3, (B, 1, 3))).astype(np.float32),
             "labels": rng.integers(0, 7, B).astype(np.int32),
             "rot": rng.uniform(0, 90, (B, 3)).astype(np.float32),
             "tran": rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32),
             "sign": np.where(rng.random(B) > 0.5, 1.0, -1.0).astype(np.float32),
             "width": rng.uniform(0.02, 0.1, (B, 1)).astype(np.float32)}

    def jax_step(dtype):
        jcfg = JaxTrainConfig.for_model(name, num_points=N, batch_size=B, dtype=dtype)
        _, _, state = jax_loop.build_state(jcfg)
        tx = _recording(state.tx)
        state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"], tx=tx,
                              opt_state=tx.init(variables["params"]))
        _, aug_key, _ = jax.random.split(state.rng, 3)        # as make_train_step splits
        with jax.disable_jit():
            new_state, metrics = jax_steps.make_train_step(jax_model_spec(name), jcfg)(
                state, {k: jnp.asarray(v) for k, v in batch.items()})
        return (_jax_draws(aug_key, batch["points"]), float(metrics["loss"]),
                from_flax_variables({"params": _numpy(new_state.opt_state[0])}),
                from_flax_variables({"batch_stats": _numpy(new_state.batch_stats)}))

    draws, loss16, grads16, stats16 = jax_step("bfloat16")
    _, loss32, grads32, stats32 = jax_step("float32")

    tcfg = TrainConfig.for_model(name, num_points=N, batch_size=B, dtype="bfloat16")
    model = build_model(name, 7, "bfloat16")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    opt, _ = make_optimizer(tcfg, model.parameters())
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    tbatch["labels"] = tbatch["labels"].long()
    out = make_train_step(get_model_spec(name), tcfg)(model, opt, tbatch,
                                                      draws={"augment": draws, "dropout": None})

    loss = float(out["loss"])
    assert abs(loss - loss16) <= LOSS_TOL
    assert abs(loss - loss32) <= max(2 * abs(loss16 - loss32), LOSS_TOL)
    noisy = pre_bn_biases(model)
    keys = [k for k, _ in model.named_parameters() if k not in noisy]
    params = dict(model.named_parameters())

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for k in keys:
        g = params[k].grad.numpy()
        assert params[k].grad.dtype == torch.float32
        gap, jax_gap = rel(g, grads32[k].numpy()), rel(grads16[k].numpy(), grads32[k].numpy())
        assert gap <= max(2 * jax_gap, GRAD_FLOOR), (k, gap, jax_gap)
    flat = lambda d: np.concatenate([np.asarray(d[k]).ravel() for k in keys])  # noqa: E731
    got = np.concatenate([params[k].grad.numpy().ravel() for k in keys])
    assert rel(got, flat({k: grads16[k].numpy() for k in keys})) <= GRAD_REL_L2
    state = model.state_dict()
    for k, v in stats16.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0, atol=STATS_TOL, err_msg=k)
            assert state[k].dtype == torch.float32


def test_evaluate_committed_bf16_checkpoint_matches_jax():
    """``r5_pn2_ssg_bf16`` (trained in bfloat16 by the JAX package, its
    parameters stored as float32) loads as it is; ``evaluate`` in bfloat16
    on 7 seeded test clouds of 256 points at batch 3 gives JAX's bfloat16
    figures: accuracies equal, the loss to BF16_TOL."""
    path = os.path.join(ROOT, "log", "classification", "r5_pn2_ssg_bf16", "checkpoints", "best.msgpack")
    split = jax_dataset.load_dataset(jax_dataset.build_dataset(2, seed=5, n_points=256), "test")
    kw = dict(num_points=256, batch_size=3, dtype="bfloat16")
    jcfg, tcfg = JaxTrainConfig.for_model("pointnet2_cls_ssg", **kw), TrainConfig.for_model(
        "pointnet2_cls_ssg", **kw)
    _, _, state = jax_loop.build_state(jcfg)
    state, meta = jax_loop.load_checkpoint(path, state)
    want = jax_loop.evaluate(jcfg, state, split)
    model, tmeta = load_checkpoint(path, build_model("pointnet2_cls_ssg"))
    assert tmeta == meta
    got = evaluate(tcfg, model, PoseDataset(**dataclasses.asdict(split)), device="cpu")
    assert all(m.compute_dtype == torch.bfloat16 for m in model.modules() if isinstance(m, torch.nn.Linear))
    assert set(got) == set(want)
    for key in ("instance_acc", "class_acc", "per_class_acc", "metric"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["loss"], want["loss"], **BF16_TOL)


def test_pipeline_bfloat16_inference():
    """The counterpart of ``tests/test_pipeline.py``'s bfloat16 test: a
    seeded pipeline with ``dtype="bfloat16"`` gives float32 outputs, finite,
    with orthonormal rotation matrices; and the same variables in the JAX
    pipeline in bfloat16 give the same grasps (classes equal, floats by
    ``assert_bf16_close`` against the JAX pipeline in bfloat16 and float32)."""
    from pointnet_like_pose_estimation_tpu.pipeline import GraspPipeline as JaxPipeline
    from pointnet_like_pose_estimation_tpu.pipeline import PipelineConfig as JaxConfig
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    names = {"classifier": "pointnet_cls", "rotation": "rotation", "sign": "sign",
             "translation": "translation", "width": "width"}
    jmodels, tmodels = {}, {}
    for key, name in names.items():
        jmodel, variables = perturbed_variables(name, seed=4)
        jmodels[key] = (jmodel, variables)
        tmodels[key] = build_model(name)
        tmodels[key].load_state_dict(from_flax_variables(variables), strict=True)
    cfg = dict(num_points=32, classifier="pointnet_cls")
    port = GraspPipeline(PipelineConfig(**cfg, dtype="bfloat16"), tmodels, device="cpu")
    assert all(m.compute_dtype == torch.bfloat16 for model in port.models.values()
               for m in model.modules() if isinstance(m, torch.nn.Linear))
    clusters = (0.05 * np.random.default_rng(0).standard_normal((4, 40, 3))).astype(np.float32)
    got = port.infer_clusters(clusters)
    assert all(v.dtype == np.float32 for k, v in got.items() if k != "pred_class")
    assert all(np.isfinite(v).all() for v in got.values())
    eye = np.einsum("kij,klj->kil", got["rotation_matrix"], got["rotation_matrix"])
    np.testing.assert_allclose(eye, np.eye(3)[None].repeat(4, 0), atol=2e-2)

    def jax_pipe(dtype):
        bf16 = {k: (jax_bf16(names[k]) if dtype == "bfloat16" else m, v) for k, (m, v) in jmodels.items()}
        return JaxPipeline(JaxConfig(**cfg, dtype=dtype), bf16).infer_clusters(clusters)

    from test_torch_registry import jax_bf16_model as jax_bf16

    want16, want32 = jax_pipe("bfloat16"), jax_pipe("float32")
    np.testing.assert_array_equal(got["pred_class"], np.asarray(want16["pred_class"]))
    for key in ("log_probs", "rotation_deg", "sign_prob", "translation", "width"):
        assert_bf16_close(got[key], want16[key], want32[key], key)
