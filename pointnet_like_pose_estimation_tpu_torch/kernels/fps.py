"""Farthest point sampling: the CUDA kernel and its plain PyTorch version.

``fps`` replaces the TPU kernel ``pointnet_like_pose_estimation_tpu/kernels/
fps.py`` (``_fps_kernel`` / ``fps_pallas``). A CPU tensor takes
``fps_reference``; a CUDA tensor launches ``csrc/fps.cu`` or raises. The
kernel's design and what bounds it are noted in the source.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build

# the shared path keeps one float of running distance per point in shared
# memory; above it the global path keeps them in a [B, N] scratch tensor
MAX_SHARED_POINTS = (227 * 1024 - 1024) // 4
# the register path: C == 3 and at most 8 points a thread (csrc/fps.cu)
MAX_REGISTER_POINTS = 4096
# points_per_thread codes of the two paths without registers (csrc/fps.cu
# kSharedPath, kGlobalPath)
SHARED_PATH, GLOBAL_PATH = 0, -1
# int32 indices, and a block's stride past the last point, below 2^31
_MAX_N = 2**31 - 1 - 1024


def fps_plan(N: int, C: int = 3) -> tuple[int, int]:
    """Launch plan ``(threads, points_per_thread)`` for clouds of N >= 1 points.

    ``points_per_thread`` in {1, 2, 4, 8} takes the kernel's register path
    (coordinates and running distances in registers); ``SHARED_PATH`` its
    shared path (distances in shared memory), for C != 3 or N above
    ``MAX_REGISTER_POINTS``; ``GLOBAL_PATH`` its global path (distances in
    a scratch tensor in device memory), for N above ``MAX_SHARED_POINTS``.
    Few, full threads keep the one barrier of a step cheap; the table was
    picked by measurement (``scripts/tune_torch_fps.py``, recorded in
    PERF.md).
    """
    if N < 1:
        raise ValueError(f"fps: N={N} outside the clouds FPS takes (N >= 1)")
    if N > MAX_SHARED_POINTS:
        return 1024, GLOBAL_PATH
    if C != 3 or N > MAX_REGISTER_POINTS:
        return 1024, SHARED_PATH
    if N <= 128:
        return 32 * ((N + 31) // 32), 1
    if N <= 256:
        return 128, 2
    if N <= 2048:
        return 256, 2 if N <= 512 else 4 if N <= 1024 else 8
    return 512, 8


def _start_tensor(start_idx, B: int, N: int, device) -> torch.Tensor:
    if isinstance(start_idx, numbers.Integral):
        if not 0 <= start_idx < N:
            raise ValueError(f"fps: start_idx {start_idx} outside [0, {N})")
        return torch.full((B,), int(start_idx), dtype=torch.int32, device=device)
    start = torch.as_tensor(start_idx, dtype=torch.int32, device=device)
    if start.shape != (B,):
        raise ValueError(f"fps: start_idx must be an int or [{B}], got {tuple(start.shape)}")
    if bool(((start < 0) | (start >= N)).any()):
        raise ValueError(f"fps: start_idx outside [0, {N})")
    return start.contiguous()


def fps_reference(
    points: torch.Tensor, num_samples: int, start_idx=0
) -> torch.Tensor:
    """Plain version: ``[B, N, C]`` clouds -> ``[B, S]`` int32 indices.

    Distances are summed elementwise in channel order, so each term is
    rounded exactly as in the kernel; ``argmax`` returns the first maximal
    index, the kernel's and ``jnp.argmax``'s tie rule.
    """
    B, N, C = points.shape
    far = _start_tensor(start_idx, B, N, points.device).long()
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=points.device)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=points.device)
    rows = torch.arange(B, device=points.device)
    for i in range(num_samples):
        out[:, i] = far
        centroid = points[rows, far]                          # [B, C]
        t = points[..., 0] - centroid[:, None, 0]
        d = t * t
        for c in range(1, C):
            t = points[..., c] - centroid[:, None, c]
            d = d + t * t
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1)
    return out


def fps(points: torch.Tensor, num_samples: int, start_idx=0) -> torch.Tensor:
    """FPS over ``[B, N, C]`` float32 clouds; ``start_idx`` is an int or a
    ``[B]`` tensor of first centroids. Returns ``[B, S]`` int32 indices.
    The indices carry no gradient, so the points are taken detached."""
    points = points.detach()
    if points.device.type == "cpu":
        return fps_reference(points, num_samples, start_idx)
    if points.device.type != "cuda":
        raise ValueError(f"fps: no kernel for device {points.device}")
    if points.dtype != torch.float32 or points.dim() != 3:
        raise ValueError(f"fps: want [B, N, C] float32, got {points.dtype} {tuple(points.shape)}")
    B, N, C = points.shape
    if num_samples <= 0 or not 0 < C <= 16:
        raise ValueError(f"fps: S={num_samples} <= 0 or C={C} outside (0, 16]")
    if N > _MAX_N:
        raise ValueError(f"fps: N={N} above {_MAX_N}: the indices are int32")
    threads, points_per_thread = fps_plan(N, C)
    points = points.contiguous()
    start = _start_tensor(start_idx, B, N, points.device)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=points.device)
    # the global path's running distances, allocated on the caller's stream
    scratch = (torch.empty((B, N), dtype=torch.float32, device=points.device)
               if points_per_thread == GLOBAL_PATH else None)
    lib = _build.library("fps")
    lib.plpe_fps.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    code = lib.plpe_fps(
        points.data_ptr(), start.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, N, C, num_samples,
        threads, points_per_thread,
        torch.cuda.current_stream(points.device).cuda_stream,
    )
    _build.check(lib, code, "fps")
    fps.launches += 1
    return out


fps.launches = 0
