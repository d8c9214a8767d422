"""Ball query: the CUDA kernel and its plain PyTorch version.

``ball_query_multi`` replaces the TPU kernel ``pointnet_like_pose_estimation_
tpu/kernels/ball_group.py`` (``_ball_query_kernel`` via
``ball_query_multi_pallas`` / ``ball_query_pallas``). A CPU tensor takes
``ball_query_reference``; a CUDA tensor launches ``csrc/ball_group.cu`` or
raises. The kernel's design and what bounds it are noted in the source.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build
from pointnet_like_pose_estimation_tpu_torch.ops.geometry import square_distance
from pointnet_like_pose_estimation_tpu_torch.utils.counters import counted

MAX_SCALES = 8
MAX_CHANNELS = 32
# what csrc/ball_group.cu takes (kernel constants mirrored below)
MAX_SHARED_BYTES = 227 * 1024
# (centroids a block, threads a centroid), in the order they are tried
_TILE_AND_SPLIT = ((64, 4), (128, 2), (64, 2), (128, 1), (64, 1), (32, 1))
_SPLIT_MAX_INDICES = 64             # kSplitMaxIndices: sum(ks) up to which four threads share a centroid
STEP = 16                           # PLPE_BQ_STEP: points a thread forms together


class BallQueryPlan(NamedTuple):
    """One launch of the ball-query kernel."""

    tile: int          # centroids a block
    split: int         # threads that share a centroid, each scanning a part of the points
    held: int          # scales the kernel holds in registers: 1, 3 or MAX_SCALES
    cloud_bytes: int   # the staged cloud; 0 takes the kernel's global path
    shared_bytes: int  # the staged cloud, the index segments and the parts' counts


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ball_query_plan(N: int, P: int, ks) -> BallQueryPlan:
    """Launch plan of ``csrc/ball_group.cu`` for clouds of N points of P
    channels queried with ``ks`` neighbours per scale.

    A block stages its cloud in shared memory, each point as ``|p|^2`` and
    its P channels padded to a multiple of four floats, N rounded up to a
    whole number of steps: ``16 * ceil((P + 1) / 4) * round_up(N, STEP)``
    bytes. Beside it lie one index segment of ``sum(ks)`` ints and ``held``
    counts for each of the block's ``tile * split`` threads. ``(tile,
    split)`` is the first of (64, 4), (128, 2), (64, 2), (128, 1), (64, 1),
    (32, 1) that fits in ``MAX_SHARED_BYTES`` with the cloud, four threads a
    centroid only while ``sum(ks)`` is at most 64 (more indices, and the
    segments of a card's worth of blocks no longer fit on its SMs at once);
    if none fits, the cloud stays in global memory (``cloud_bytes`` 0, the
    global path of the same kernel) and the first that fits alone is taken.
    ``STEP``, the points a thread forms together between two tests whether
    its warp's balls are full, is one constant for every shape, picked by
    measurement (``scripts/tune_torch_ball_query.py``, recorded in PERF.md).
    The plan depends on the shape alone, not on the number of clouds or
    centroids. The kernel computes the same figures and refuses a launch
    whose plan differs. Raises ``ValueError`` when even 32 rows of indices do not fit.
    """
    if N <= 0 or not 0 < P <= MAX_CHANNELS or not 0 < len(ks) <= MAX_SCALES or min(ks) <= 0:
        raise ValueError(f"ball_query: no plan for N={N}, P={P}, ks={tuple(ks)}")
    held = 1 if len(ks) == 1 else 3 if len(ks) <= 3 else MAX_SCALES
    staged = 16 * (_round_up(P + 1, 4) // 4) * _round_up(N, STEP)
    for cloud in (staged, 0):
        for tile, split in _TILE_AND_SPLIT:
            if split == 4 and sum(ks) > _SPLIT_MAX_INDICES:
                continue
            nbytes = cloud + 4 * tile * split * (sum(ks) + held)
            if nbytes <= MAX_SHARED_BYTES:
                return BallQueryPlan(tile, split, held, cloud, nbytes)
    raise ValueError(f"ball_query: ks={tuple(ks)} exceed the kernel's {MAX_SHARED_BYTES} bytes "
                     f"of shared memory ({nbytes} for 32 centroids)")


def _radius_sq(radius: float) -> float:
    # the f32 threshold PyTorch and JAX compare against: r*r in double, rounded once
    return float(np.float32(float(radius) * float(radius)))


def ball_query_reference(
    points: torch.Tensor, centroids: torch.Tensor, radii, ks
) -> torch.Tensor:
    """Plain version: ``[B, N, P]`` points, ``[B, S, P]`` centroids ->
    ``[B, S, sum(ks)]`` int32, scale l at K-offset ``sum(ks[:l])``.

    Per scale: the K lowest indices with d2 <= r^2, empty slots repeating
    the first in-ball index, a ball with no point filled with N-1.
    """
    N = points.shape[1]
    d2 = square_distance(centroids, points)                   # [B, S, N]
    ids = torch.arange(N, dtype=torch.int32, device=points.device)
    out = []
    for radius, K in zip(radii, ks):
        keys = torch.where(d2 <= _radius_sq(radius), ids, N)
        idx = torch.topk(keys, int(K), dim=-1, largest=False, sorted=True).values
        idx = torch.where(idx == N, idx[..., :1], idx)
        out.append(torch.clamp(idx, max=N - 1))
    return torch.cat(out, dim=-1).to(torch.int32)


@counted("ball_query")
def ball_query_multi(
    points: torch.Tensor, centroids: torch.Tensor, radii, ks
) -> torch.Tensor:
    """Multi-scale ball query over all P channels of the points:
    ``[B, S, sum(ks)]`` int32 indices into the N axis. The indices carry no
    gradient, so points and centroids are taken detached."""
    points, centroids = points.detach(), centroids.detach()
    radii = tuple(float(r) for r in radii)
    ks = tuple(int(k) for k in ks)
    if len(radii) != len(ks) or not 0 < len(ks) <= MAX_SCALES or min(ks) <= 0:
        raise ValueError(f"ball_query: bad scales radii={radii} ks={ks}")
    if points.device.type == "cpu":
        return ball_query_reference(points, centroids, radii, ks)
    if points.device.type != "cuda":
        raise ValueError(f"ball_query: no kernel for device {points.device}")
    if points.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise ValueError("ball_query: want float32 points and centroids")
    B, N, P = points.shape
    if centroids.dim() != 3 or centroids.shape[0] != B or centroids.shape[2] != P:
        raise ValueError(f"ball_query: centroids {tuple(centroids.shape)} vs points {tuple(points.shape)}")
    if not 0 < P <= MAX_CHANNELS:
        raise ValueError(f"ball_query: P={P} outside (0, {MAX_CHANNELS}]")
    if centroids.device != points.device:
        raise ValueError("ball_query: points and centroids on different devices")
    S = centroids.shape[1]
    if N == 0 or S == 0:
        raise ValueError(f"ball_query: want N, S > 0, got points {tuple(points.shape)}, S={S}")
    plan = ball_query_plan(N, P, ks)
    points, centroids = points.contiguous(), centroids.contiguous()
    out = torch.empty((B, S, sum(ks)), dtype=torch.int32, device=points.device)
    r2 = (ctypes.c_float * len(ks))(*[_radius_sq(r) for r in radii])
    kk = (ctypes.c_int * len(ks))(*ks)
    _build.call("plpe_ball_query", points, centroids, out, B, N, S, P, r2, kk, len(ks), *plan)
    ball_query_multi.launches += 1
    return out


def ball_query(
    points: torch.Tensor, centroids: torch.Tensor, radius: float, num_neighbors: int
) -> torch.Tensor:
    """Single-scale ball query: ``[B, S, K]`` int32 indices."""
    return ball_query_multi(points, centroids, (radius,), (num_neighbors,))
