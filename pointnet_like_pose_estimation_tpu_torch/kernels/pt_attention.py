"""Point Transformer's vector attention in one pass: the CUDA kernel and its
plain PyTorch version.

``pt_attention(p, q, k, v, idx, attn, bn2)`` computes, for an eval-mode
``nn/point_transformer.py`` ``PointTransformerLayer`` ``attn`` whose
``q``, ``k``, ``v`` Linears gave ``q, k, v [B, N, C]``, the attention of
each point of ``p [B, N, 3]`` over its neighbours ``idx [B, N, K]`` and
then its block's ``bn2`` eval BatchNorm + ReLU: the position encoding,
the relation, the weight MLP, the softmax over the neighbours and the
weighted sum, with no ``[B, N, K, .]`` tensor formed. It replaces no TPU
kernel (the JAX package has no Point Transformer); the layer takes it
where ``nn/point_transformer.py`` ``attention_reason`` is None. A CPU
tensor takes ``pt_attention_reference``; a CUDA tensor launches
``csrc/pt_attention.cu`` or raises. The kernel's design and what bounds
it are noted in the source.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from pointnet_like_pose_estimation_tpu_torch.kernels import _build
from pointnet_like_pose_estimation_tpu_torch.kernels.bn_relu import _aligned, _eval_args, eval_reference
from pointnet_like_pose_estimation_tpu_torch.ops.geometry import index_points
from pointnet_like_pose_estimation_tpu_torch.utils.counters import counted

# what csrc/pt_attention.cu takes (kThreads, kTileElements, kMaxC,
# kMaxPlanes, kMaxK, kPad, kPosFloats, kMaxSharedBytes); the neighbours'
# indices are held as 32-bit ints, and a block row a cloud (gridDim.y)
THREADS = 256
TILE_ELEMENTS = 8192
MAX_C = 512
MAX_PLANES = 64
MAX_K = 16
PAD = 4
POS_FLOATS = 24
MAX_SHARED_BYTES = 227 * 1024
MAX_POINTS = 2**31 - 1
MAX_CLOUDS = 65535


class PtAttentionPlan(NamedTuple):
    """One launch of the attention kernel."""

    tile: int          # queries a block, their K neighbour rows each
    threads: int
    shared_bytes: int  # the staged weights and the tile's intermediates


def pt_attention_plan(B: int, N: int, K: int, C: int, share_planes: int) -> PtAttentionPlan:
    """Launch plan of ``csrc/pt_attention.cu`` for B clouds of N points, K
    neighbours each, at C channels whose weights are shared by
    ``share_planes`` groups: a block a tile of one cloud's queries, as many
    as keep their neighbour rows times C within ``TILE_ELEMENTS`` (one at
    least, N at most), ``THREADS`` threads. Raises ``ValueError`` for what
    the kernel does not take: K outside ``[1, min(MAX_K, N)]``, N above
    ``MAX_POINTS``, B outside ``[1, MAX_CLOUDS]``, C above ``MAX_C`` or not
    dividing into ``share_planes`` groups of a multiple of 4 channels up to
    ``MAX_PLANES``, C / 4 not dividing ``THREADS``, a layout beyond a
    block's shared memory (C = 4 in one group)."""
    c = C // share_planes if share_planes > 0 and C % share_planes == 0 else 0
    fits = (0 < B <= MAX_CLOUDS and 0 < K <= min(MAX_K, N) and N <= MAX_POINTS and 0 < C <= MAX_C
            and 0 < c <= MAX_PLANES and c % 4 == 0 and THREADS % (C // 4) == 0)
    tile = min(N, max(1, TILE_ELEMENTS // (K * C))) if fits else 0
    rows = tile * K
    floats = (c * (C + PAD) + c * (c + PAD) + 6 * c + POS_FLOATS + rows * (C + PAD) + 2 * rows * (c + PAD)
              + 4 * rows + rows)
    if not fits or 4 * floats > MAX_SHARED_BYTES:
        raise ValueError(f"pt_attention: no plan for B={B}, N={N}, K={K}, C={C}, share_planes={share_planes} "
                         f"(K <= min({MAX_K}, N), C <= {MAX_C}, C / share_planes a multiple of 4 up to "
                         f"{MAX_PLANES}, C / 4 dividing {THREADS}, {MAX_SHARED_BYTES} shared bytes)")
    return PtAttentionPlan(tile, THREADS, 4 * floats)


def pt_attention_reference(p, q, k, v, idx, attn, bn2) -> torch.Tensor:
    """Plain version: the kernel's function in PyTorch's own operations,
    each BatchNorm + ReLU the eval pass's (``kernels/bn_relu.py``
    ``eval_reference``); ``[B, N, C]``."""
    B, N, K = idx.shape
    C = q.shape[-1]
    s = attn.share_planes
    pos, mlp = attn.pos, attn.weight_mlp
    rel = index_points(p, idx) - p[:, :, None, :]
    hidden = eval_reference(F.linear(rel, pos.dense_0.weight, pos.dense_0.bias), *_eval_args(pos.bn_0))
    delta = F.linear(hidden, pos.dense_1.weight, pos.dense_1.bias)
    h = eval_reference((index_points(k, idx) - q[:, :, None, :]) + delta, *_eval_args(attn.weight_bn))
    u = eval_reference(F.linear(h, mlp.dense_0.weight, mlp.dense_0.bias), *_eval_args(mlp.bn_0))
    w = torch.softmax(F.linear(u, mlp.dense_1.weight, mlp.dense_1.bias), dim=2)
    vd = (index_points(v, idx) + delta).view(B, N, K, s, C // s)
    y = (vd * w[:, :, :, None, :]).sum(dim=2).view(B, N, C)
    return eval_reference(y, *_eval_args(bn2))


def _weights(attn, bn2) -> list[torch.Tensor]:
    """The kernel's parameter pointers in its entry's order."""
    pos, mlp = attn.pos, attn.weight_mlp
    linears = [pos.dense_0, pos.dense_1, mlp.dense_0, mlp.dense_1]
    bns = [pos.bn_0, attn.weight_bn, mlp.bn_0, bn2]
    return [_aligned(t) for m in linears for t in (m.weight, m.bias)] + \
        [t.contiguous() for bn in bns for t in (bn.running_mean, bn.running_var, bn.weight, bn.bias)]


@counted("pt_attention")
def pt_attention(p: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
                 attn, bn2) -> torch.Tensor:
    """``relu(bn2(y))`` ``[B, N, C]`` of the attention ``y`` of ``attn``
    (an eval-mode ``PointTransformerLayer``) over the neighbours ``idx``
    (int64), from its ``q``, ``k``, ``v`` and the points ``p``; ``bn2`` an
    eval-mode ``BatchNormF32``. One pass on the card; gives no gradient."""
    B, N, K = idx.shape
    C = q.shape[-1]
    if p.shape != (B, N, 3) or any(t.shape != (B, N, C) for t in (q, k, v)):
        raise ValueError(f"pt_attention: want p [B, N, 3], q, k, v [B, N, C] for idx {tuple(idx.shape)}, got "
                         f"{tuple(p.shape)}, {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not p.is_cuda:
        return pt_attention_reference(p, q, k, v, idx, attn, bn2)
    weights = _weights(attn, bn2)
    tensors = (p, q, k, v, idx, *weights)
    if any(t.device != p.device for t in tensors):
        raise ValueError("pt_attention: every input and parameter on one device")
    if idx.dtype != torch.int64 or any(t.dtype != torch.float32 for t in tensors if t is not idx):
        raise ValueError("pt_attention: want float32 points, features and parameters and int64 indices")
    plan = pt_attention_plan(B, N, K, C, attn.share_planes)
    out = torch.empty((B, N, C), dtype=torch.float32, device=p.device)
    eps = [float(bn.eps) for bn in (attn.pos.bn_0, attn.weight_bn, attn.weight_mlp.bn_0, bn2)]
    _build.call("plpe_pt_attention", p.contiguous(), _aligned(q), _aligned(k), _aligned(v), idx.contiguous(),
                out, *weights, B, N, K, C, C // attn.share_planes, *plan, *eps)
    pt_attention.launches += 1
    return out
