"""Geometric primitives on batched, channels-last (``[B, N, C]``) clouds.

Counterparts of ``pointnet_like_pose_estimation_tpu/ops/geometry.py``.
"""

from __future__ import annotations

import torch


def _dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of a*b, one elementwise term at a time in
    channel order, so each product and sum is rounded on its own."""
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dist[..., n, m] = ||src[..., n] - dst[..., m]||^2`` as
    ``-2 src.dst + ||src||^2 + ||dst||^2`` (the JAX package's form).

    Computed elementwise rather than with a matrix product, so the CUDA
    ball-query kernel, which rounds the same terms in the same order, agrees
    bit for bit and no point crosses a radius boundary between the two.
    """
    inner = _dot_last(src[..., :, None, :], dst[..., None, :, :])  # [..., N, M]
    s2 = _dot_last(src, src)[..., :, None]
    d2 = _dot_last(dst, dst)[..., None, :]
    return -2.0 * inner + s2 + d2


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather ``out[b, ...s, :] = points[b, idx[b, ...s], :]``.

    ``points`` is ``[B, N, C]``; ``idx`` is ``[B, S]`` or ``[B, S, K]``.
    """
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).long().expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def normalize_cloud(points: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Center each cloud at its centroid and scale it into the unit sphere.

    The result feeds FPS and the ball query, whose selections turn on the
    last bit of a distance, so it must come out the same on the CPU and on
    the card. Two steps do not: the mean, whose sum is taken in another
    order on each, and the float32 square root, which is not rounded alike
    on both. The mean is accumulated in float64 and the one root per cloud
    is taken in float64, each rounded once to float32. The rest is float32
    as in the JAX package: subtraction, the squared norm summed term by term
    in channel order and division are rounded alike on both, and a maximum
    does not round (so the root of the largest squared norm is the largest
    norm).
    """
    mean = points.mean(dim=-2, keepdim=True, dtype=torch.float64).to(points.dtype)
    centered = points - mean
    sq = centered * centered
    norm2 = sq[..., 0]
    for c in range(1, sq.shape[-1]):
        norm2 = norm2 + sq[..., c]
    scale = torch.sqrt(norm2.amax(dim=-1, keepdim=True).double()).to(points.dtype)[..., None]
    return centered / (scale + eps)


def euler_rotation_matrix(angles_rad: torch.Tensor) -> torch.Tensor:
    """X.Y.Z Euler rotation ``R = Rx @ Ry @ Rz`` of ``[..., 3]`` radians."""
    a, b, c = angles_rad.unbind(-1)
    ca, sa, cb, sb, cc, sc = a.cos(), a.sin(), b.cos(), b.sin(), c.cos(), c.sin()
    z, o = torch.zeros_like(a), torch.ones_like(a)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat([[o, z, z], [z, ca, -sa], [z, sa, ca]])
    ry = mat([[cb, z, sb], [z, o, z], [-sb, z, cb]])
    rz = mat([[cc, -sc, z], [sc, cc, z], [z, z, o]])
    return rx @ ry @ rz


def rotate_euler(points: torch.Tensor, angles_rad: torch.Tensor) -> torch.Tensor:
    """Rotate ``[..., N, 3]`` clouds by X.Y.Z Euler angles ``[..., 3]``
    (broadcast over the leading dims): ``points @ R^T``."""
    return points @ euler_rotation_matrix(angles_rad).transpose(-1, -2)
