"""Every model of the registry on the CPU against the JAX package: the
variables of a JAX ``model.init`` (through ``build_state``), with the
BatchNorm statistics and affine parameters perturbed and the T-Nets' zero
output kernels given small values so that the transforms are not the
identity, are carried over by ``from_flax_variables`` with ``strict=True``
and both models run in eval mode on the same numpy-seeded inputs. Widths
are the published ones; only the point count is narrowed (N = 128, so the
512 and 128 centroids of the set-abstraction levels repeat points, on both
sides alike). Floats agree to rtol = atol = 1e-4 (float32 products summed
in another order), classes and hard signs exactly.

In bfloat16 (``dtype="bfloat16"`` on both sides) each model is held to
JAX's bfloat16 outputs at ``BF16_TOL`` and, against JAX's float32 outputs,
to within twice JAX's own bfloat16 gap (``assert_bf16_close``). Measured on
these inputs: the port's bfloat16 outputs equal JAX's bit for bit for 14
of the 19 models; elsewhere they part by at most 1.9e-3
(``pointnet2_cls_msg``'s global feature, 2 of 2048 values) and 3.0e-3
relative (``rotation_msg``), where the two libraries' float32
accumulations of a bfloat16 product round to neighbouring bfloat16 values.
"""

import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from pointnet_like_pose_estimation_tpu.train.config import TrainConfig as JaxTrainConfig
from pointnet_like_pose_estimation_tpu.train.loop import build_state
from pointnet_like_pose_estimation_tpu_torch.models import (
    MODEL_REGISTRY,
    build_model,
    get_model_spec,
)
from pointnet_like_pose_estimation_tpu_torch.nn import TNet
from pointnet_like_pose_estimation_tpu_torch.pipeline.infer import _lecun_normal_
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import from_flax_variables

B, N, NUM_CLASSES, TOL = 2, 128, 7, 1e-4
# the port's bfloat16 against JAX's: half a bfloat16 ulp (2^-8) at 1
BF16_TOL = dict(rtol=4e-3, atol=4e-3)


def perturbed_variables(name, seed=0):
    """(JAX model, variables as nested dicts of numpy arrays)."""
    _, jmodel, state = build_state(JaxTrainConfig(model=name, num_classes=NUM_CLASSES, num_points=N))
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(
        flax.core.unfreeze({"params": state.params, "batch_stats": state.batch_stats}))
    out = {}
    for path, value in flat.items():
        v = np.array(value, np.float32)
        leaf, is_bn = path[-1], path[-2].startswith("bn")
        if leaf == "mean":
            v = v + 0.1 * rng.standard_normal(v.shape)
        elif leaf == "var":
            v = v * rng.uniform(0.5, 1.5, v.shape)
        elif leaf == "scale":
            v = v * rng.uniform(0.8, 1.2, v.shape)
        elif leaf == "bias" and is_bn:
            v = v + 0.05 * rng.standard_normal(v.shape)
        elif leaf == "kernel" and path[-2] == "out":          # a T-Net's zero output kernel
            v = v + 0.02 * rng.standard_normal(v.shape)
        out[path] = v.astype(np.float32)
    return jmodel, flax.traverse_util.unflatten_dict(out)


def model_inputs(name, seed=1):
    spec = get_model_spec(name)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    if spec.input_kind == "xyz":
        return (x,)
    onehot = np.zeros((B, N, NUM_CLASSES), np.float32)
    onehot[np.arange(B), :, rng.integers(0, NUM_CLASSES, B)] = 1.0
    spliced = np.concatenate([x, onehot], axis=-1)
    if spec.input_kind == "spliced_mean":
        return spliced, rng.standard_normal((B, 3)).astype(np.float32)
    return (spliced,)


def assert_outputs_match(name, got, want):
    task = get_model_spec(name).task
    if task == "classify":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    elif task == "sign":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _f32(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a).astype(jnp.float32))


def assert_bf16_close(got16, want16, want32, what=""):
    """The port's bfloat16 output against JAX's bfloat16 output (BF16_TOL)
    and against JAX's float32 output: its largest gap from float32 stays
    within twice JAX's own, or within BF16_TOL's atol where JAX's gap is
    smaller than that."""
    got16, want16, want32 = _f32(got16), _f32(want16), _f32(want32)
    np.testing.assert_allclose(got16, want16, **BF16_TOL, err_msg=what)
    port_gap, jax_gap = np.abs(got16 - want32).max(), np.abs(want16 - want32).max()
    assert port_gap <= max(2 * jax_gap, BF16_TOL["atol"]), (what, port_gap, jax_gap)


def jax_bf16_model(name):
    """The JAX registry model ``name`` computing in bfloat16."""
    spec = JAX_REGISTRY[name]
    kw = {"num_classes": NUM_CLASSES} if spec.task == "classify" else {}
    return spec.make(dtype=jnp.bfloat16, **kw)


def assert_bf16_outputs_match(name, got, want16, want32):
    """Floats by ``assert_bf16_close`` and in JAX's dtype; classes and hard
    signs equal wherever JAX's bfloat16 decision is not within 1e-2 (a
    bfloat16 ulp at 1) of a tie."""
    task = get_model_spec(name).task
    if task == "classify":
        top2 = np.sort(_f32(want16[0]), axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 1e-2
        assert_bf16_close(got[0], want16[0], want32[0], f"{name} log-probabilities")
        if got[1].is_floating_point():      # the global feature or the feature transform
            assert_bf16_close(got[1], want16[1], want32[1], f"{name} aux")
            assert str(got[1].dtype) == f"torch.{want16[1].dtype}"
        else:                               # pose_classify's (-1)**choice
            np.testing.assert_array_equal(got[1].numpy()[sure], np.asarray(want16[1])[sure])
        np.testing.assert_array_equal(got[2].numpy()[sure], np.asarray(want16[2])[sure])
    elif task == "sign":
        assert_bf16_close(got[0], want16[0], want32[0], f"{name} probability")
        sure = np.abs(_f32(want16[0]) - 0.5) > 1e-2
        np.testing.assert_array_equal(got[1].numpy()[sure], np.asarray(want16[1])[sure])
    else:
        assert_bf16_close(got, want16, want32, name)
        assert got.dtype == torch.bfloat16 and str(want16.dtype) == "bfloat16"


def test_registry_has_the_jax_package_names_and_kinds():
    """Every name of the JAX package's registry is in the port's with the
    same task and input kind; beyond them the port has its own Point
    Transformer classifier, which the JAX package does not."""
    for name, jspec in JAX_REGISTRY.items():
        spec = MODEL_REGISTRY[name]
        assert (spec.name, spec.task, spec.input_kind) == (name, jspec.task, jspec.input_kind)
    assert set(MODEL_REGISTRY) - set(JAX_REGISTRY) == {"point_transformer_cls"}
    with pytest.raises(KeyError, match="unknown model"):
        build_model("no_such_model")


@pytest.mark.parametrize("dtype,reason", [("float32", "device"), ("bfloat16", "dtype")])
def test_the_port_s_own_classifier_routes_its_attention(dtype, reason, monkeypatch):
    """``point_transformer_cls``, which the JAX package has not: its 13
    attention layers say why they stay composed on the CPU (the one-pass
    kernel, the counter ``pt_attention``, is the card's), in either dtype;
    its kNN and attention counters are registered with the others."""
    from pointnet_like_pose_estimation_tpu_torch.nn import point_transformer
    from pointnet_like_pose_estimation_tpu_torch.utils import counters

    assert {"knn", "pt_attention", "fps", "ball_query"} <= set(counters.read())
    reasons = []
    saved = point_transformer.attention_reason
    monkeypatch.setattr(point_transformer, "attention_reason",
                        lambda *args: reasons.append(saved(*args)) or reasons[-1])
    model = build_model("point_transformer_cls", NUM_CLASSES, dtype).eval()
    x = np.random.default_rng(2).standard_normal((B, 256, 3)).astype(np.float32)    # 256, 64, 16, 4, 1 a stage
    before = counters.read()["pt_attention"]
    with torch.no_grad():
        log_probs, _, _ = model(torch.from_numpy(x / np.linalg.norm(x, axis=-1).max()))
    assert reasons == [reason] * 13 and counters.read()["pt_attention"] == before
    assert log_probs.shape == (B, NUM_CLASSES) and bool(torch.isfinite(log_probs).all())


# float32 cases keep the bare model name as their id
@pytest.mark.parametrize("name,dtype", [pytest.param(n, d, id=n if d == "float32" else f"{n}-{d}")
                                        for d in ("float32", "bfloat16") for n in sorted(JAX_REGISTRY)])
def test_model_matches_jax_in_eval_mode(name, dtype):
    jmodel, variables = perturbed_variables(name)
    tmodel = build_model(name, NUM_CLASSES, dtype).eval()
    tmodel.load_state_dict(from_flax_variables(variables), strict=True)
    inputs = model_inputs(name)
    want = jmodel.apply(variables, *map(jnp.asarray, inputs), train=False)
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, inputs))
    if dtype == "bfloat16":
        want16 = jax_bf16_model(name).apply(variables, *map(jnp.asarray, inputs), train=False)
        assert_bf16_outputs_match(name, got, want16, want)
        return
    assert_outputs_match(name, got, want)
    if name == "pose_classify":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))     # (-1)**choice


def test_dead_tnet_holds_parameters_and_changes_nothing():
    """``compat_dead_tnet``: the JAX variables (with the dead T-Net's) load
    with strict=True and the output equals the head without it."""
    from pointnet_like_pose_estimation_tpu.models.heads import VanillaHead as JaxVanillaHead
    from pointnet_like_pose_estimation_tpu_torch.models import VanillaHead

    import jax

    x = model_inputs("rotation")[0]
    jmodel = JaxVanillaHead(out_dim=3, compat_dead_tnet=True)
    variables = jax.tree_util.tree_map(
        np.asarray, flax.core.unfreeze(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)))
    dead = VanillaHead(3 + NUM_CLASSES, out_dim=3, compat_dead_tnet=True).eval()
    dead.load_state_dict(from_flax_variables(variables), strict=True)
    assert any(k.startswith("dead_tnet.") for k in dead.state_dict())
    with torch.no_grad():
        got = dead(torch.from_numpy(x))
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_seeded_init_keeps_the_tnet_identity():
    model = build_model("pointnet_cls")
    _lecun_normal_(model, torch.Generator().manual_seed(0))
    tnets = [m for m in model.modules() if isinstance(m, TNet)]
    assert len(tnets) == 2
    for t in tnets:
        assert not t.out.weight.any()
        assert torch.equal(t.out.bias, torch.eye(t.k).reshape(-1))
    assert model.head.fc_0.weight.abs().sum() > 0
    x = torch.from_numpy(model_inputs("pointnet_cls")[0])
    with torch.no_grad():
        _, trans, _ = model.eval()(x)
    assert torch.equal(trans, torch.eye(64).expand(B, 64, 64))
