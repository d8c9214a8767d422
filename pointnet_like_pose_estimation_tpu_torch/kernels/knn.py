"""Exact k-nearest-neighbour query: the CUDA kernel and its plain PyTorch
version.

``knn(points, queries, k)`` gives, for every query of a ``[B, S, 3]``
batch, the indices of the k points of its ``[B, N, 3]`` cloud nearest to
it, nearest first, a tie in distance going to the lower index. It replaces
no TPU kernel (the JAX package selects no neighbours by rank); Point
Transformer's attention and TransitionDown (``nn/point_transformer.py``)
group by it. A CPU tensor takes ``knn_reference``; a CUDA tensor launches
``csrc/knn.cu`` or raises. The kernel's design and what bounds it are
noted in the source.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build
from pointnet_like_pose_estimation_tpu_torch.utils.counters import counted

# what csrc/knn.cu takes (kMaxK, kMaxPoints, kMaxWarps, kMaxTile)
MAX_K = 16
MAX_POINTS = 16384
MAX_WARPS = 8
MAX_TILE = 32


class KnnPlan(NamedTuple):
    """One launch of the kNN kernel."""

    threads: int       # a warp a query, up to MAX_WARPS warps a block
    tile: int          # queries a block, taken in turn by its warps
    shared_bytes: int  # the staged cloud, 12 bytes a point


def knn_plan(N: int, S: int, k: int) -> KnnPlan:
    """Launch plan of ``csrc/knn.cu`` for S queries of clouds of N points:
    one warp a query, ``MAX_WARPS`` warps a block (fewer where S is
    smaller), a tile of ``MAX_TILE`` queries a block (S where fewer), each
    block staging its cloud in shared memory. Raises ``ValueError`` for
    what the kernel does not take: ``k`` outside ``[1, min(MAX_K, N)]``, N
    above ``MAX_POINTS``."""
    if N <= 0 or S <= 0 or not 0 < k <= min(MAX_K, N) or N > MAX_POINTS:
        raise ValueError(f"knn: no plan for N={N}, S={S}, k={k} (k <= min({MAX_K}, N), N <= {MAX_POINTS})")
    return KnnPlan(32 * min(MAX_WARPS, S), min(MAX_TILE, S), 12 * N)


def knn_reference(points: torch.Tensor, queries: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: ``[B, N, 3]`` points, ``[B, S, 3]`` queries -> ``[B,
    S, k]`` int64, the k nearest points of each query by a stable sort of
    every squared distance ``(dx*dx + dy*dy) + dz*dz``, each step rounded
    on its own as the kernel rounds it (ties to the lower index)."""
    diff = points[:, None, :, :] - queries[:, :, None, :]
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


@counted("knn")
def knn(points: torch.Tensor, queries: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, S, k]`` int64 indices into the N axis of ``points`` of each
    query's k nearest points, nearest first: int64, the type the gathers
    take, so that none converts them. The indices carry no gradient, so
    points and queries are taken detached."""
    points, queries = points.detach(), queries.detach()
    k = int(k)
    if points.dim() != 3 or points.shape[-1] != 3 or queries.dim() != 3 or queries.shape[-1] != 3 \
            or queries.shape[0] != points.shape[0]:
        raise ValueError(f"knn: want [B, N, 3] points and [B, S, 3] queries, got {tuple(points.shape)} "
                         f"and {tuple(queries.shape)}")
    B, N, _ = points.shape
    S = queries.shape[1]
    if not 0 < k <= N:
        raise ValueError(f"knn: k={k} outside [1, N={N}]")
    if points.device.type == "cpu":
        return knn_reference(points, queries, k)
    if points.device.type != "cuda" or queries.device != points.device:
        raise ValueError(f"knn: no kernel for points on {points.device} and queries on {queries.device}")
    if points.dtype != torch.float32 or queries.dtype != torch.float32:
        raise ValueError("knn: want float32 points and queries")
    plan = knn_plan(N, S, k)
    out = torch.empty((B, S, k), dtype=torch.int64, device=points.device)
    _build.call("plpe_knn", points.contiguous(), queries.contiguous(), out, B, N, S, k, *plan)
    knn.launches += 1
    return out
