"""A grouped set abstraction's first Linear taken per point, on the CPU:
``ops/grouping.py`` ``per_point_products`` and the plain version of the
gathered eval pass (``kernels/bn_relu.py`` ``eval_gather_reference``)
against the grouped route (gather, centre, concatenate, ``Linear``, the
plain eval pair) in both column orders and without features, the set
abstractions routed through it against their grouped route, and each case
of ``nn/set_abstraction.py`` ``per_point_reason``. The kernel itself is
held against its plain version on the card in ``tests/test_torch_cuda.py``.

Tolerance: the per-point route sums the first layer's products in another
order (``W [x_j, f_j] - W_x c`` in place of ``W [x_j - c, f_j]``), so its
outputs are held within 1e-5 of the largest output, not bit for bit."""

import copy
import types

import pytest
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels.bn_relu import (
    INT32_ELEMENTS,
    bn_relu_eval_gather,
    eval_gather_reference,
    plain_bn_relu_eval,
)
from pointnet_like_pose_estimation_tpu_torch.nn import SetAbstraction, SetAbstractionMSG, set_abstraction
from pointnet_like_pose_estimation_tpu_torch.nn.layers import BatchNormF32, PointwiseMLP, set_compute_dtype
from pointnet_like_pose_estimation_tpu_torch.nn.set_abstraction import per_point_reason
from pointnet_like_pose_estimation_tpu_torch.ops import index_points
from pointnet_like_pose_estimation_tpu_torch.ops.grouping import count_grouped, per_point_products
from pointnet_like_pose_estimation_tpu_torch.parallel.context import point_sharding

# the reassociated first layer's gap, relative to the largest output
REL = 1e-5


def _close(got, want):
    scale = float(want.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=REL, atol=REL * scale)


def _eval_stats(module, seed=0):
    """Running statistics of a trained model's kind on every BatchNorm."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, BatchNormF32):
            C = m.num_features
            with torch.no_grad():
                m.running_mean.copy_(0.3 * torch.randn(C, generator=g))
                m.running_var.copy_(torch.rand(C, generator=g) * 1.5 + 0.5)
                m.weight.copy_(torch.rand(C, generator=g) + 0.5)
                m.bias.copy_(torch.rand(C, generator=g) - 0.5)
    return module.eval()


def _cloud(B, N, P, seed):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand(B, N, P, generator=g) * 2 - 1
    if P > 3:                                          # a pose head's spliced one-hot channels
        pts[..., 3:] = 0.0
        pts[torch.arange(B), :, 3 + torch.arange(B) % (P - 3)] = 1.0
    return pts


def _idx(B, S, K, N, kind, seed):
    """Neighbours as the ball query gives them: sorted indices below N, or
    with empty slots repeating the first, or an empty ball (all N - 1)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.sort(torch.randint(0, N, (B, S, K), generator=g), dim=-1).values
    if kind == "empty":
        idx[:, ::3, K // 2:] = idx[:, ::3, :1]         # short balls: the first slot repeated
        idx[:, 1::4] = N - 1                           # empty balls
    return idx.to(torch.int32)


LAYOUTS = {  # name: (P, D, coords_first)
    "coords_first": (3, 16, True),
    "features_first": (3, 16, False),
    "no_features_p3": (3, 0, True),
    "no_features_p10": (10, 0, False),
}


@pytest.mark.parametrize("kind", ["sorted", "empty"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gathered_first_pair_equals_the_grouped_route(layout, kind):
    """``per_point_products`` and ``eval_gather_reference`` against the
    first pair of the grouped route: the grouped ``[x_j - c, f_j]`` (or
    ``[f_j, x_j - c]``) rows through ``Linear`` and the plain eval pair,
    with short and empty balls (the first index repeated, N - 1)."""
    P, D, coords_first = LAYOUTS[layout]
    B, N, S, K, C = 2, 96, 24, 16, 32
    torch.manual_seed(1)
    mlp = _eval_stats(PointwiseMLP(P + D, [C, 8]))
    points = _cloud(B, N, P, seed=2)
    features = torch.randn(B, N, D) if D else None
    centroids = index_points(points, torch.randint(0, N, (B, S)))
    idx = _idx(B, S, K, N, kind, seed=3)
    with torch.no_grad():
        grouped = index_points(points, idx) - centroids[:, :, None, :]
        if features is not None:
            gf = index_points(features, idx)
            grouped = torch.cat([grouped, gf] if coords_first else [gf, grouped], dim=-1)
        want = plain_bn_relu_eval(mlp.dense_0(grouped), mlp.bn_0)
        pf, qc = per_point_products(mlp.dense_0.weight, points, features, centroids, coords_first)
        bn = mlp.bn_0
        got = eval_gather_reference(pf, qc, idx, mlp.dense_0.bias, bn.running_mean, bn.running_var, bn.weight,
                                    bn.bias, bn.eps)
        g0 = bn_relu_eval_gather.launches
        wrapped = bn_relu_eval_gather(pf, qc, idx, mlp.dense_0.bias, bn)
    assert pf.shape == (B, N, C) and qc.shape == (B, S, C) and got.shape == (B, S, K, C)
    assert torch.equal(wrapped, got) and bn_relu_eval_gather.launches == g0   # the CPU: the plain version
    _close(got, want)


def _layers(kind, P, D):
    torch.manual_seed(4)
    if kind == "ssg":
        return SetAbstraction(32, 16, 0.5, P + D, [16, 24, 32])
    return SetAbstractionMSG(32, [8, 16, 24], [0.3, 0.5, 0.8], P + D, [[8, 16], [16, 16, 24], [12, 20]])


@pytest.mark.parametrize("kind,P,D", [("ssg", 3, 0), ("ssg", 3, 12), ("ssg", 10, 0), ("msg", 3, 0),
                                      ("msg", 3, 20), ("msg", 10, 0), ("msg", 10, 20)])
def test_per_point_set_abstraction_equals_its_grouped_route(monkeypatch, kind, P, D):
    """A set abstraction routed per point (the reason function forced to
    None, so the CPU takes the plain versions) against its twin on the
    grouped route: the same centroids, the features within the tolerance,
    no grouped bytes counted and one gathered pair a scale, where the twin
    counts its grouped tensors."""
    sa = _eval_stats(_layers(kind, P, D))
    twin = copy.deepcopy(sa)
    points = _cloud(2, 128, P, seed=5)
    features = torch.randn(2, 128, D) if D else None
    calls = []
    gather = set_abstraction.PointwiseMLP.forward_max_grouped
    with torch.no_grad():
        b0 = count_grouped.bytes
        want_c, want = twin(points, features)
        grouped_bytes = count_grouped.bytes - b0
        monkeypatch.setattr(set_abstraction, "per_point_reason", lambda *a: None)
        monkeypatch.setattr(set_abstraction.PointwiseMLP, "forward_max_grouped",
                            lambda self, *a: calls.append(a[2].shape) or gather(self, *a))
        b0 = count_grouped.bytes
        got_c, got = sa(points, features)
    assert grouped_bytes > 0 and count_grouped.bytes == b0
    scales = sa.scales()
    assert calls == [(2, 32, K) for _, K in scales]
    assert torch.equal(got_c, want_c) and got.shape == want.shape
    _close(got, want)


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lies on the card: the reason function's
    other conditions, without a card."""

    @property
    def is_cuda(self):
        return True


CASES = ["engaged", "train", "grad", "bfloat16", "float64", "cpu", "group_all", "sharded", "depth", "width",
         "module", "size"]


# the MSG layer has no global form
@pytest.mark.parametrize("case,msg", [(c, m) for c in CASES for m in (False, True) if not (m and c == "group_all")],
                         ids=lambda v: {False: "ssg", True: "msg"}.get(v, v) if isinstance(v, bool) else v)
def test_per_point_reason_names_each_case(case, msg):
    """Each condition of ``per_point_reason`` on a layer that meets every
    other one (an eval-mode float32 layer, its input on the card, no
    gradient wanted): only then None. On the CPU the same layer gives
    ``"device"``."""
    P, D = 3, 8
    widths = [[14 if case == "width" else 16] + ([] if case == "depth" else [16])] * 3
    S = 2**25 if case == "size" else 16
    if msg:
        layer = SetAbstractionMSG(S, [4, 8, 16], [0.2, 0.4, 0.8], P + D, widths)
    else:
        layer = SetAbstraction(S, 16, 0.4, P + D, widths[0], group_all=case == "group_all")
    layer.train(case == "train")
    dtype = torch.float64 if case == "float64" else torch.float32
    if case == "float64":
        layer.double()
    if case == "bfloat16":
        set_compute_dtype(layer, "bfloat16")
    if case == "module":
        for mlp, _ in layer.scales():
            mlp.dense_0 = type("OtherLinear", (set_abstraction.Linear,), {})(P + D, 16)
    points = torch.zeros(1, 64, P, dtype=dtype)
    features = torch.zeros(1, 64, D, dtype=dtype)
    if case != "cpu":
        points = points.as_subclass(_CudaLike)
    want = {"engaged": None, "train": "train", "grad": "eval", "bfloat16": "dtype", "float64": "dtype",
            "cpu": "device", "group_all": "group_all", "sharded": "sharded", "depth": "depth", "width": "width",
            "module": "module", "size": "size"}[case]
    if case == "sharded":
        mesh = types.SimpleNamespace(mesh_dim_names=("points",), shape=(2,))
        with point_sharding(mesh), torch.no_grad():
            assert per_point_reason(layer, points, features) == want
        return
    if case == "grad":
        assert per_point_reason(layer, points, features) == want
        return
    with torch.no_grad():
        assert per_point_reason(layer, points, features) == want
        assert per_point_reason(layer, points.as_subclass(torch.Tensor), features) == (want or "device")
    if case == "size":
        rows = points.shape[0] * S * min(K for _, K in layer.scales())
        assert rows * 16 >= INT32_ELEMENTS


def test_eval_set_abstraction_on_the_cpu_keeps_the_grouped_route():
    """On the CPU an eval-mode set abstraction under ``torch.no_grad``
    takes the grouped route (``"device"``): it counts its grouped tensors
    and runs every pair through the plain eval pair, bit for bit with the
    MLP's forward and the max."""
    sa = _eval_stats(_layers("msg", 3, 0))
    points = _cloud(2, 128, 3, seed=6)
    with torch.no_grad():
        assert per_point_reason(sa, points, None) == "device"
        b0, e0 = count_grouped.bytes, plain_bn_relu_eval.launches
        _, got = sa(points, None)
    assert count_grouped.bytes > b0 and plain_bn_relu_eval.launches - e0 == 2 + 3 + 2
    assert got.shape == (2, 32, 16 + 24 + 20)
