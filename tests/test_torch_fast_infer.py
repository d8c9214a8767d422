"""The port's fused set abstraction and eval executor on the CPU against the
JAX package: ``fused_sa_reference`` against the Pallas ``fused_sa_infer``
(interpret mode) on single SA layers, ``fold_dense_bn`` against JAX's, and
both executors against the port's models and JAX ``model.apply`` in eval,
with randomized BatchNorm so that folding is exercised. Float outputs agree
to 1e-4 (float32 sums in another order, BN folded into the weights);
predicted classes are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu.kernels.fused_sa import fused_sa_infer as jax_fused_sa
from pointnet_like_pose_estimation_tpu.models import fast_infer as jax_fast_infer
from pointnet_like_pose_estimation_tpu.train.config import TrainConfig
from pointnet_like_pose_estimation_tpu.train.loop import build_state
from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_reference
from pointnet_like_pose_estimation_tpu_torch.kernels.fused_sa import (
    fused_sa_infer,
    fused_sa_reference,
    launch_plan,
)
from pointnet_like_pose_estimation_tpu_torch.models import build_model
from pointnet_like_pose_estimation_tpu_torch.models.fast_infer import (
    _permute_first_w,
    build_pn2_msg_infer,
    build_pn2_ssg_infer,
    fold_dense_bn,
)
from pointnet_like_pose_estimation_tpu_torch.nn import BatchNormF32
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import from_flax_variables

TOL = 1e-4


def _unit_clouds(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    return x / np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]


def _folded(rng, P, layer_widths):
    out = []
    for widths in layer_widths:
        cin = P
        for cout in widths:
            out += [(rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32),
                    (0.1 * rng.standard_normal(cout)).astype(np.float32)]
            cin = cout
    return out


@pytest.mark.parametrize(
    "D,radii,ks,widths,msg,offset",
    [
        (0, (0.2,), (16,), ((16, 16, 32),), False, 0.0),
        (8, (0.4,), (16,), ((16, 16, 32),), False, 0.0),
        (8, (0.1, 0.2, 0.4), (8, 16, 32), ((8, 8, 16), (16, 16, 32), (16, 24, 32)), True, 0.0),
        (0, (0.2,), (16,), ((16, 16, 32),), False, 5.0),
    ],
    ids=["ssg_xyz", "ssg_features", "msg_permuted", "empty_balls"],
)
def test_fused_sa_reference_matches_pallas(D, radii, ks, widths, msg, offset):
    """One SA layer, B = 1, N = 128, S = 16. For MSG, layer-1 rows are made
    in the model's [features, coords] order and each package permutes its
    own copy to the kernel's [coords, features]."""
    rng = np.random.default_rng(0)
    N, S = 128, 16
    xyz = _unit_clouds(rng, (1, N, 3))
    pts = np.concatenate([xyz, rng.standard_normal((1, N, D)).astype(np.float32)], -1)
    cent = np.ascontiguousarray(xyz[:, ::8] + offset)
    weights = _folded(rng, 3 + D, widths)
    jw = [jnp.asarray(w) for w in weights]
    tw = [torch.from_numpy(w) for w in weights]
    if msg:
        first = np.cumsum([0] + [2 * len(ws) for ws in widths[:-1]])
        for i in first:
            jw[i] = jax_fast_infer._permute_first_w([jw[i]], D)[0]
            tw[i] = _permute_first_w([tw[i]], D)[0]
            np.testing.assert_array_equal(tw[i].numpy(), np.asarray(jw[i]))
    want = jax_fused_sa(jnp.asarray(pts), jnp.asarray(cent), tuple(jw), radii, ks, widths,
                        interpret=True)
    got = fused_sa_reference(torch.from_numpy(pts), torch.from_numpy(cent), tw, radii, ks, widths)
    assert got.shape == (1, S, sum(ws[-1] for ws in widths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_fold_dense_bn_matches_jax():
    rng = np.random.default_rng(1)
    dense = torch.nn.Linear(5, 7)
    bn = BatchNormF32(7)
    with torch.no_grad():
        for t, v in [(dense.weight, rng.standard_normal((7, 5))), (dense.bias, rng.standard_normal(7)),
                     (bn.weight, rng.uniform(0.5, 1.5, 7)), (bn.bias, rng.normal(0, 0.2, 7)),
                     (bn.running_mean, rng.normal(0, 0.3, 7)), (bn.running_var, rng.uniform(0.5, 2, 7))]:
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    w, b = fold_dense_bn(dense, bn)
    jw, jb = jax_fast_infer.fold_dense_bn(
        {"kernel": jnp.asarray(dense.weight.detach().numpy().T), "bias": jnp.asarray(dense.bias.detach().numpy())},
        {"scale": jnp.asarray(bn.weight.detach().numpy()), "bias": jnp.asarray(bn.bias.detach().numpy())},
        {"mean": jnp.asarray(bn.running_mean.numpy()), "var": jnp.asarray(bn.running_var.numpy())},
    )
    # the same float32 operations in the same order; 1e-6 leaves XLA room to fuse
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


_BN_DRAWS = {
    "scale": lambda rng, s: rng.uniform(0.5, 1.5, s),
    "bias": lambda rng, s: rng.normal(0.0, 0.2, s),
    "mean": lambda rng, s: rng.normal(0.0, 0.3, s),
    "var": lambda rng, s: rng.uniform(0.5, 2.0, s),
}


def _randomize_bn(tree, rng, in_bn=False):
    """Draw every leaf of a ``bn_*`` module from ``rng``; keep the rest."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng, k.startswith("bn_"))
        else:
            out[k] = _BN_DRAWS[k](rng, np.shape(v)).astype(np.float32) if in_bn else np.asarray(v)
    return out


def _random_bn_variables(name, num_points, seed):
    _, jmodel, state = build_state(TrainConfig(model=name, num_classes=7, num_points=num_points))
    rng = np.random.default_rng(seed)
    return jmodel, {"params": _randomize_bn(state.params, rng),
                    "batch_stats": _randomize_bn(state.batch_stats, rng)}


@pytest.mark.parametrize(
    "name,B,N,build",
    [("pointnet2_cls_ssg", 2, 256, build_pn2_ssg_infer),
     ("pointnet2_cls_msg", 1, 128, build_pn2_msg_infer)],
    ids=["ssg", "msg"],
)
def test_executor_matches_model_and_jax(name, B, N, build):
    jmodel, variables = _random_bn_variables(name, N, seed=2)
    tmodel = build_model(name).eval()
    tmodel.load_state_dict(from_flax_variables(variables), strict=True)
    x = _unit_clouds(np.random.default_rng(3), (B, N, 3))
    jlp, _, jpred = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        mlp, _, mpred = tmodel(torch.from_numpy(x))
    lp, pred = build(tmodel, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(lp.numpy(), mlp.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(pred.numpy(), mpred.numpy())
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))


def _layer(P=3, D=0):
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(_unit_clouds(rng, (2, 64, 3 + D)))
    cent = pts[:, ::8, :3].contiguous()
    weights = [torch.from_numpy(w) for w in _folded(rng, 3 + D, ((8, 16),))]
    return pts, cent, weights, (0.3,), (8,), ((8, 16),)


def test_cpu_call_takes_the_plain_version():
    """No launch is counted; idx_out receives the ball query's indices."""
    pts, cent, weights, radii, ks, widths = _layer()
    before = fused_sa_infer.launches
    idx = torch.empty((2, 8, 8), dtype=torch.int32)
    got = fused_sa_infer(pts, cent, weights, radii, ks, widths, idx_out=idx)
    assert fused_sa_infer.launches == before
    assert torch.equal(got, fused_sa_reference(pts, cent, weights, radii, ks, widths))
    assert torch.equal(idx, ball_query_reference(pts, cent, radii, ks))


def test_fused_sa_refuses_devices_without_a_kernel():
    pts, cent, weights, radii, ks, widths = _layer()
    meta = [t.to("meta") for t in (pts, cent, *weights)]
    with pytest.raises(ValueError, match="no kernel"):
        fused_sa_infer(meta[0], meta[1], meta[2:], radii, ks, widths)


def _bad(case):
    pts, cent, weights, radii, ks, widths = _layer()
    idx_out = None
    if case == "float64":
        pts = pts.double()
    elif case == "non_contiguous":
        pts = torch.cat([pts, pts], -1)[..., ::2]
    elif case == "batch_mismatch":
        cent = cent[:1]
    elif case == "centroid_channels":
        cent = pts[:, ::8]
    elif case == "two_channels":
        pts = pts[..., :2].contiguous()
    elif case == "weight_count":
        weights = weights[:-1]
    elif case == "weight_shape":
        weights[2] = weights[2].t().contiguous()
    elif case == "scale_count":
        radii = (0.3, 0.4)
    elif case == "too_many_layers":
        widths = ((8, 8, 8, 8, 16),)
    elif case == "shared_memory":
        pts = torch.zeros((2, 64, 1700))
        weights = [torch.zeros((1700, 8)), torch.zeros(8), torch.zeros((8, 16)), torch.zeros(16)]
    elif case == "idx_out":
        idx_out = torch.empty((2, 8, 8), dtype=torch.int64)
    return pts, cent, weights, radii, ks, widths, idx_out


@pytest.mark.parametrize("case", [
    "float64", "non_contiguous", "batch_mismatch", "centroid_channels", "two_channels",
    "weight_count", "weight_shape", "scale_count", "too_many_layers", "shared_memory", "idx_out",
])
def test_fused_sa_validates_arguments(case):
    pts, cent, weights, radii, ks, widths, idx_out = _bad(case)
    if case == "shared_memory":
        # the kernel's limit: refused by its launch plan, which a CUDA tensor
        # passes through before any launch; a CPU tensor takes the plain version
        with pytest.raises(ValueError, match="fused_sa.*shared memory"):
            launch_plan(pts.shape[-1], ks, widths)
        return
    with pytest.raises(ValueError, match="fused_sa"):
        fused_sa_infer(pts, cent, weights, radii, ks, widths, idx_out=idx_out)


def test_builders_default_to_the_card():
    """No card and no device='cpu': the builders raise, they never carry on
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pn2_ssg_infer(build_model("pointnet2_cls_ssg"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pn2_msg_infer(build_model("pointnet2_cls_msg"))


def test_builders_refuse_the_other_model():
    with pytest.raises(TypeError, match="PointNet2ClsSSG"):
        build_pn2_ssg_infer(build_model("pointnet2_cls_msg"), device="cpu")
