"""Plain PyTorch geometry for the benchmark's reference: frozen copies of
the port's plain versions at commit aa745b2 (``ops/geometry.py``,
``kernels/fps.py`` ``fps_reference``, ``kernels/ball_group.py``
``ball_query_reference``, ``ops/grouping.py``).

Imports nothing of the port. Every distance is summed element by element
in channel order, so each term rounds as the port's kernels round it
(they are built with ``-fmad=false``): a point on a ball's edge or an FPS
tie falls the same way on both sides.
"""

from __future__ import annotations

import numpy as np
import torch


def _dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``[..., N, M]``: ``-2 src.dst + |src|^2 + |dst|^2``."""
    inner = _dot_last(src[..., :, None, :], dst[..., None, :, :])
    return -2.0 * inner + _dot_last(src, src)[..., :, None] + _dot_last(dst, dst)[..., None, :]


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, ...s, :] = points[b, idx[b, ...s], :]``."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).long().expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def normalize_cloud(points: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Centre on the float64 mean and scale by the float64 root of the
    largest squared norm, each rounded once to float32."""
    mean = points.mean(dim=-2, keepdim=True, dtype=torch.float64).to(points.dtype)
    centered = points - mean
    sq = centered * centered
    norm2 = sq[..., 0]
    for c in range(1, sq.shape[-1]):
        norm2 = norm2 + sq[..., c]
    scale = torch.sqrt(norm2.amax(dim=-1, keepdim=True).double()).to(points.dtype)[..., None]
    return centered / (scale + eps)


def euler_rotation_matrix(angles_rad: torch.Tensor) -> torch.Tensor:
    """``Rx @ Ry @ Rz`` of ``[..., 3]`` radians."""
    a, b, c = angles_rad.unbind(-1)
    ca, sa, cb, sb, cc, sc = a.cos(), a.sin(), b.cos(), b.sin(), c.cos(), c.sin()
    z, o = torch.zeros_like(a), torch.ones_like(a)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat([[o, z, z], [z, ca, -sa], [z, sa, ca]])
    ry = mat([[cb, z, sb], [z, o, z], [-sb, z, cb]])
    rz = mat([[cc, -sc, z], [sc, cc, z], [z, z, o]])
    return rx @ ry @ rz


def fps(points: torch.Tensor, num_samples: int, start: int = 0) -> torch.Tensor:
    """Farthest point sampling from point ``start``: ``[B, S]`` int64, the
    first maximal index on a tie."""
    points = points.detach()
    B, N, C = points.shape
    far = torch.full((B,), start, dtype=torch.long, device=points.device)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=points.device)
    out = torch.empty((B, num_samples), dtype=torch.long, device=points.device)
    rows = torch.arange(B, device=points.device)
    for i in range(num_samples):
        out[:, i] = far
        centroid = points[rows, far]
        t = points[..., 0] - centroid[:, None, 0]
        d = t * t
        for c in range(1, C):
            t = points[..., c] - centroid[:, None, c]
            d = d + t * t
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1)
    return out


def radius_sq(radius: float) -> float:
    """``r * r`` in double, rounded once to float32."""
    return float(np.float32(float(radius) * float(radius)))


def ball_query(points: torch.Tensor, centroids: torch.Tensor, radius: float, k: int) -> torch.Tensor:
    """``[B, S, k]``: the k lowest indices within ``radius``, empty slots
    repeating the first, an empty ball N-1."""
    points, centroids = points.detach(), centroids.detach()
    N = points.shape[1]
    d2 = square_distance(centroids, points)
    ids = torch.arange(N, dtype=torch.long, device=points.device)
    keys = torch.where(d2 <= radius_sq(radius), ids, N)
    idx = torch.topk(keys, int(k), dim=-1, largest=False, sorted=True).values
    idx = torch.where(idx == N, idx[..., :1], idx)
    return torch.clamp(idx, max=N - 1)


def sample_and_group(points, features, num_centroids: int, k: int, radius: float):
    """FPS centroids, ball query, gather, centre: ``(centroids, [B, S, k,
    P (+D)])`` with the centred coordinates first."""
    centroids = index_points(points, fps(points, num_centroids))
    idx = ball_query(points, centroids, radius, k)
    grouped = index_points(points, idx) - centroids[:, :, None, :]
    if features is not None:
        grouped = torch.cat([grouped, index_points(features, idx)], dim=-1)
    return centroids, grouped


def sample_and_group_all(points, features):
    B, _, C = points.shape
    centroids = torch.zeros((B, 1, C), dtype=points.dtype, device=points.device)
    grouped = points[:, None]
    if features is not None:
        grouped = torch.cat([grouped, features[:, None]], dim=-1)
    return centroids, grouped
