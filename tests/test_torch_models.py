"""The port's models on the CPU at full width against the JAX models, with
the weights of a JAX ``build_state`` init carried over by
``from_flax_variables``. Outputs agree to 1e-4 (float32 matmuls summed in
another order); predicted classes are equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointnet_like_pose_estimation_tpu.train.config import TrainConfig
from pointnet_like_pose_estimation_tpu.train.loop import build_state
from pointnet_like_pose_estimation_tpu_torch.models import build_model
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import from_flax_variables

B, N, NUM_CLASSES = 2, 256, 7


def _pair(name):
    _, jmodel, state = build_state(TrainConfig(model=name, num_classes=NUM_CLASSES, num_points=N))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    tmodel = build_model(name, NUM_CLASSES).eval()
    tmodel.load_state_dict(from_flax_variables(variables), strict=True)
    return jmodel, variables, tmodel


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_pointnet2_cls_ssg():
    jmodel, variables, tmodel = _pair("pointnet2_cls_ssg")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    jlp, jg, jpred = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        lp, g, pred = tmodel(torch.from_numpy(x))
    _close(lp, jlp)
    _close(g, jg)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))


def test_pointnet2_cls_msg():
    """Full widths at B = 1, N = 128: three radius scales per level, the
    grouped channels in the reference's [features, centred coords] order."""
    _, jmodel, state = build_state(TrainConfig(model="pointnet2_cls_msg", num_classes=NUM_CLASSES,
                                               num_points=128))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    tmodel = build_model("pointnet2_cls_msg", NUM_CLASSES).eval()
    tmodel.load_state_dict(from_flax_variables(variables), strict=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 128, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    jlp, jg, jpred = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        lp, g, pred = tmodel(torch.from_numpy(x))
    _close(lp, jlp)
    _close(g, jg)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))


@pytest.mark.parametrize("name", ["rotation", "sign", "translation", "width"])
def test_vanilla_heads(name):
    jmodel, variables, tmodel = _pair(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, N, 3 + NUM_CLASSES)).astype(np.float32)
    mean = rng.standard_normal((B, 3)).astype(np.float32)
    args = (x, mean) if name == "translation" else (x,)
    want = jmodel.apply(variables, *map(jnp.asarray, args), train=False)
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, args))
    if name == "sign":
        _close(got[0], want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        _close(got, want)
