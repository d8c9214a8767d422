"""Eval executor: the flagship classifiers rebuilt on the fused
set-abstraction kernel (``kernels/fused_sa.py``). Counterpart of
``models/fast_infer.py`` of the JAX package.

The eval forward of ``PointNet2ClsSSG`` / ``PointNet2ClsMSG`` writes every
``[B, S, K, C]`` grouped tensor and MLP activation to device memory. Eval
BatchNorm is an affine map, so it folds into the Linear before it, and each
of SA1 and SA2 becomes one fused kernel call over all its radius scales:

    fwd = build_pn2_ssg_infer(model)              # or build_pn2_msg_infer
    log_probs, pred = fwd(points)                 # [B, N, 3] -> ([B, C], [B])

BN is folded once, at build time, from the model's weights and running
statistics. FPS runs on the port's FPS kernel and the centroids are
gathered with ``index_points``; SA3 (group all) and the head stay plain
``torch.matmul``. The radii, neighbour counts and widths are read off the
model. Inference only: the folded weights hold no BN state to update.

Each forward is one compiled program per input shape (B, N), as the JAX
package's executors are one ``jax.jit`` each: on a card a CUDA graph
captured at the first call of that shape and replayed, on the CPU the same
function called directly (``utils/programs.py``; ``fwd.programs`` is the
executor's cache, ``fwd.body`` the function it captures).
"""

from __future__ import annotations

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.kernels.fused_sa import fused_sa_infer
from pointnet_like_pose_estimation_tpu_torch.models.classifiers import (
    PointNet2ClsMSG,
    PointNet2ClsSSG,
)
from pointnet_like_pose_estimation_tpu_torch.nn import (
    DenseHead,
    PointwiseMLP,
    SetAbstractionMSG,
)
from pointnet_like_pose_estimation_tpu_torch.ops import farthest_point_sample, index_points
from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device
from pointnet_like_pose_estimation_tpu_torch.utils.programs import ProgramCache


def fold_dense_bn(dense: nn.Linear, bn: nn.BatchNorm1d):
    """Fold eval-mode BatchNorm into the preceding Linear: y = z*g/s +
    (b_bn - mu*g/s) with z = xW + b composes to W' = W*(g/s),
    b' = b*(g/s) + b_bn - mu*(g/s). Returns ``(W' [in, out], b' [out])``."""
    g_over_s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    w = dense.weight.t() * g_over_s[None, :]
    b = dense.bias * g_over_s + bn.bias - bn.running_mean * g_over_s
    return w.detach().contiguous(), b.detach().contiguous()


def _fold_mlp(mlp: PointwiseMLP) -> list[torch.Tensor]:
    """Folded (W, b) pairs of a PointwiseMLP, flat."""
    out = []
    for i in range(mlp.n):
        out += fold_dense_bn(getattr(mlp, f"dense_{i}"), getattr(mlp, f"bn_{i}"))
    return out


def _permute_first_w(weights: list[torch.Tensor], d_feat: int) -> list[torch.Tensor]:
    """Reorder layer-1 W rows from the MSG input order [feats(D), coords(3)]
    to the kernel's [coords(3), feats(D)] layout."""
    w = weights[0]
    weights[0] = torch.cat([w[d_feat:], w[:d_feat]], dim=0)
    return weights


def _fold_head(head: DenseHead) -> list[torch.Tensor]:
    """The cls_v2 head's hidden layers with BN folded, then the last Linear."""
    out = []
    for i in range(head.n - 1):
        out += fold_dense_bn(getattr(head, f"fc_{i}"), getattr(head, f"bn_{i}"))
    last = getattr(head, f"fc_{head.n - 1}")
    return out + [last.weight.detach().t().contiguous(), last.bias.detach()]


def _dense_relu(x: torch.Tensor, weights) -> torch.Tensor:
    for w, b in zip(weights[::2], weights[1::2]):
        x = torch.relu(x @ w + b)
    return x


def _head_logits(g: torch.Tensor, weights) -> torch.Tensor:
    """DenseHead style=cls_v2 eval: dropout is identity, BN affine."""
    return _dense_relu(g, weights[:-2]) @ weights[-2] + weights[-1]


def _group_all_feature(p: torch.Tensor, f: torch.Tensor, weights) -> torch.Tensor:
    """SA3 (group all): [coords, feats] over the whole cloud, MLP, max."""
    return _dense_relu(torch.cat([p, f], dim=-1), weights).amax(dim=-2)


def fold_sa_level(sa: nn.Module):
    """One SA level as the fused kernel takes it: ``(S, radii, ks, widths,
    weights)``. MSG groups [features, coords], so its layer-1 rows move."""
    if isinstance(sa, SetAbstractionMSG):
        mlps = [getattr(sa, f"mlp_{i}") for i in range(len(sa.radius_list))]
        radii, ks = sa.radius_list, sa.num_neighbors_list
        d_feat = mlps[0].dense_0.in_features - 3
    else:
        mlps, radii, ks, d_feat = [sa.mlp], (sa.radius,), (sa.num_neighbors,), 0
    weights = []
    for mlp in mlps:
        weights += _permute_first_w(_fold_mlp(mlp), d_feat) if d_feat else _fold_mlp(mlp)
    widths = tuple(
        tuple(getattr(m, f"dense_{i}").out_features for i in range(m.n)) for m in mlps
    )
    return sa.num_centroids, tuple(radii), tuple(ks), widths, weights


def _build(model: nn.Module, kind: type, device):
    if not isinstance(model, kind):
        raise TypeError(f"fast_infer: want a {kind.__name__}, got {type(model).__name__}")
    dev = resolve_device(device, "fast_infer")

    def to_dev(ws):
        return tuple(w.to(dev) for w in ws)

    levels = []
    for sa in (model.sa1, model.sa2):
        S, radii, ks, widths, weights = fold_sa_level(sa)
        levels.append((S, radii, ks, widths, to_dev(weights)))
    sa3_w = to_dev(_fold_mlp(model.sa3.mlp))
    head_w = to_dev(_fold_head(model.head))

    def body(p):
        ptsfeat = p
        for S, radii, ks, widths, weights in levels:
            cent = index_points(p, farthest_point_sample(p, S))
            f = fused_sa_infer(ptsfeat, cent, weights, radii, ks, widths)
            p, ptsfeat = cent, torch.cat([cent, f], dim=-1)
        logits = _head_logits(_group_all_feature(p, f, sa3_w), head_w)
        log_probs = torch.log_softmax(logits, dim=-1)
        return log_probs, torch.argmax(log_probs, dim=-1)

    programs = ProgramCache(dev)

    def fwd(points):
        p = torch.as_tensor(points, dtype=torch.float32)
        # the program's own outputs, which its next replay overwrites: the caller's are copies
        return tuple(t.clone() for t in programs(("executor", *p.shape), body, (p,)))

    fwd.programs, fwd.body = programs, body
    return fwd


def build_pn2_ssg_infer(model: PointNet2ClsSSG, device="cuda"):
    """Fused-kernel eval forward for pointnet2_cls_ssg."""
    return _build(model, PointNet2ClsSSG, device)


def build_pn2_msg_infer(model: PointNet2ClsMSG, device="cuda"):
    """Fused-kernel eval forward for pointnet2_cls_msg (one fused call per
    SA level serves every radius scale)."""
    return _build(model, PointNet2ClsMSG, device)
