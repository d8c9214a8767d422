"""Fused eval-mode set abstraction: the CUDA kernel and its plain PyTorch
version.

``fused_sa_infer`` replaces the TPU kernel ``pointnet_like_pose_estimation_
tpu/kernels/fused_sa.py`` (``_fused_sa_kernel`` via ``fused_sa_infer``). A
CPU tensor takes ``fused_sa_reference``; a CUDA tensor launches
``csrc/fused_sa.cu`` or raises. The kernel's design and what bounds it are
noted in the source.
"""

from __future__ import annotations

import ctypes

import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build
from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import (
    _radius_sq,
    ball_query_reference,
)
from pointnet_like_pose_estimation_tpu_torch.ops.geometry import index_points

# what csrc/fused_sa.cu takes: one warp selects each scale, at most 4
# layers a scale, and its shared memory (kernel constants mirrored below)
MAX_SCALES = 8
MAX_LAYERS = 4
MAX_SHARED_BYTES = 227 * 1024 - 1024
_PITCH = 36        # kMaxRows + 4: a channel's row of one neighbour chunk
_GROUPS = 4        # kMaxRows / kRowsPerItem


def shared_bytes(P: int, ks, layer_widths) -> int:
    """Dynamic shared memory the kernel needs: the gathered chunk and the
    ping-pong activations (channel-major), the running max, the indices."""
    buf0, buf1 = P, 0
    for widths in layer_widths:
        for li, c in enumerate(widths[:-1]):
            if li % 2:
                buf0 = max(buf0, c)
            else:
                buf1 = max(buf1, c)
    pool = max(widths[-1] for widths in layer_widths)
    return 4 * ((buf0 + buf1) * _PITCH + _GROUPS * pool + sum(ks))


def fused_sa_reference(
    ptsfeat: torch.Tensor, centroids: torch.Tensor, weights, radii, ks, layer_widths
) -> torch.Tensor:
    """Plain version: ball query on the first 3 channels, gather, centre the
    coordinates, ``relu(x @ W + b)`` per layer, max over the K rows."""
    idx = ball_query_reference(ptsfeat[..., :3], centroids, radii, ks)
    w = iter(weights)
    out, k_off = [], 0
    for K, widths in zip(ks, layer_widths):
        g = index_points(ptsfeat, idx[..., k_off:k_off + K])      # [B, S, K, P]
        k_off += K
        x = torch.cat([g[..., :3] - centroids[:, :, None, :], g[..., 3:]], dim=-1)
        for _ in widths:
            x = torch.relu(x @ next(w) + next(w))
        out.append(x.amax(dim=-2))
    return torch.cat(out, dim=-1)


def _validate(ptsfeat, centroids, weights, radii, ks, layer_widths, idx_out):
    if ptsfeat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_sa: no kernel for device {ptsfeat.device}")
    if ptsfeat.dim() != 3 or centroids.dim() != 3:
        raise ValueError("fused_sa: want ptsfeat [B, N, P] and centroids [B, S, 3]")
    B, N, P = ptsfeat.shape
    if centroids.shape[0] != B or centroids.shape[2] != 3:
        raise ValueError(f"fused_sa: centroids {tuple(centroids.shape)} vs ptsfeat {tuple(ptsfeat.shape)}")
    if P < 3 or N == 0 or centroids.shape[1] == 0:
        raise ValueError(f"fused_sa: want P >= 3 and N, S > 0, got ptsfeat {tuple(ptsfeat.shape)}")
    if not len(radii) == len(ks) == len(layer_widths) or not 0 < len(ks) <= MAX_SCALES:
        raise ValueError(f"fused_sa: bad scales radii={radii} ks={ks} widths={layer_widths}")
    if min(ks) <= 0 or any(not 0 < len(ws) <= MAX_LAYERS or min(ws) <= 0 for ws in layer_widths):
        raise ValueError(f"fused_sa: bad ks={ks} or widths={layer_widths}")
    if shared_bytes(P, ks, layer_widths) > MAX_SHARED_BYTES:
        raise ValueError(f"fused_sa: P={P}, ks={ks}, widths={layer_widths} exceed the kernel's "
                         f"{MAX_SHARED_BYTES} bytes of shared memory")
    shapes = []
    for widths in layer_widths:
        cin = P
        for cout in widths:
            shapes += [(cin, cout), (cout,)]
            cin = cout
    if len(weights) != len(shapes):
        raise ValueError(f"fused_sa: {len(weights)} weights, want {len(shapes)} (W, b per layer)")
    for t, shape in zip([ptsfeat, centroids, *weights], [None, None, *shapes]):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != ptsfeat.device:
            raise ValueError("fused_sa: want contiguous float32 tensors on one device")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused_sa: weight {tuple(t.shape)}, want {shape}")
    if idx_out is not None and (
        idx_out.dtype != torch.int32 or not idx_out.is_contiguous()
        or tuple(idx_out.shape) != (B, centroids.shape[1], sum(ks))
        or idx_out.device != ptsfeat.device
    ):
        raise ValueError("fused_sa: idx_out must be a contiguous int32 [B, S, sum(ks)] beside ptsfeat")


def fused_sa_infer(
    ptsfeat: torch.Tensor,
    centroids: torch.Tensor,
    weights,
    radii,
    ks,
    layer_widths,
    idx_out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused eval-mode set abstraction.

    Args:
      ptsfeat: ``[B, N, 3+D]`` coords-first point channels, float32.
      centroids: ``[B, S, 3]`` query centroids (from FPS and a gather).
      weights: flat sequence, per scale then per layer, of ``W [Cin, Cout]``
        and ``b [Cout]`` with BN folded (``models.fast_infer.fold_dense_bn``).
        Layer-1 ``W`` rows are ordered [coords, features].
      radii, ks: per-scale ball radius and neighbour count.
      layer_widths: per-scale tuple of output widths.
      idx_out: optional ``[B, S, sum(ks)]`` int32 tensor that receives the
        selected neighbour indices.

    Returns ``[B, S, sum(last widths)]`` float32 max-pooled features.
    """
    radii = tuple(float(r) for r in radii)
    ks = tuple(int(k) for k in ks)
    layer_widths = tuple(tuple(int(c) for c in ws) for ws in layer_widths)
    weights = tuple(weights)
    _validate(ptsfeat, centroids, weights, radii, ks, layer_widths, idx_out)
    if ptsfeat.device.type == "cpu":
        if idx_out is not None:
            idx_out.copy_(ball_query_reference(ptsfeat[..., :3], centroids, radii, ks))
        return fused_sa_reference(ptsfeat, centroids, weights, radii, ks, layer_widths)

    B, N, P = ptsfeat.shape
    S = centroids.shape[1]
    out = torch.empty((B, S, sum(ws[-1] for ws in layer_widths)), dtype=torch.float32,
                      device=ptsfeat.device)
    n = len(ks)
    r2 = (ctypes.c_float * n)(*[_radius_sq(r) for r in radii])
    kk = (ctypes.c_int * n)(*ks)
    counts = (ctypes.c_int * n)(*[len(ws) for ws in layer_widths])
    flat = [c for ws in layer_widths for c in ws]
    widths = (ctypes.c_int * len(flat))(*flat)
    ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    lib = _build.library("fused_sa")
    lib.plpe_fused_sa.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
    )
    lib.plpe_fused_sa.restype = ctypes.c_int
    code = lib.plpe_fused_sa(
        ptsfeat.data_ptr(), centroids.data_ptr(), out.data_ptr(),
        None if idx_out is None else idx_out.data_ptr(), B, N, S, P, n,
        ctypes.addressof(r2), ctypes.addressof(kk), ctypes.addressof(counts),
        ctypes.addressof(widths), ctypes.addressof(ptrs),
        torch.cuda.current_stream(ptsfeat.device).cuda_stream,
    )
    _build.check(lib, code, "fused_sa")
    fused_sa_infer.launches += 1
    return out


fused_sa_infer.launches = 0
