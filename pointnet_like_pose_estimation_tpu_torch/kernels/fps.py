"""Farthest point sampling: the CUDA kernel and its plain PyTorch version.

``fps`` replaces the TPU kernel ``pointnet_like_pose_estimation_tpu/kernels/
fps.py`` (``_fps_kernel`` / ``fps_pallas``). A CPU tensor takes
``fps_reference``; a CUDA tensor launches ``csrc/fps.cu`` or raises. The
kernel's design and what bounds it are noted in the source.
"""

from __future__ import annotations

import numbers

import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build
from pointnet_like_pose_estimation_tpu_torch.utils.counters import counted

# the shared path keeps one float of running distance per point in the
# dynamic shared memory of one block (csrc/fps.cu kMaxSharedBytes); a block
# of the cluster path does so for its slice, beside an inbox of 2 * 16
# candidates of 18 words (kMaxSliceBytes)
MAX_SHARED_POINTS = (227 * 1024 - 1024) // 4
MAX_SLICE_POINTS = (227 * 1024 - 1024 - 2 * 16 * 18 * 4) // 4
# the register path: C in REGISTER_CHANNELS (which have cluster-path
# instances of their own too), at most 8 points a thread and 512 threads
# (csrc/fps.cu kMaxPointsPerThread, kRegisterThreads)
MAX_REGISTER_POINTS = 4096
REGISTER_CHANNELS = (3, 10)
# the cluster path: one cloud over CLUSTER_BLOCKS blocks of 512 threads, or
# of 1024 where a slice holds more than CLUSTER_SMALL_SLICE points and C has
# an instance of its own (the any-C instance takes at most 512,
# kAnyChannelThreads). Below shared memory it also takes clouds of more than
# MAX_REGISTER_POINTS while all B clusters fit on the card's SMS at once.
# Above MAX_CLUSTER_POINTS the global path keeps the distances in a [B, N]
# scratch tensor.
CLUSTER_BLOCKS, CLUSTER_SMALL_SLICE, SMS = 16, 8192, 132
MAX_CLUSTER_POINTS = CLUSTER_BLOCKS * MAX_SLICE_POINTS
# points_per_thread codes of the paths without registers (csrc/fps.cu
# kSharedPath, kGlobalPath, kClusterPath)
SHARED_PATH, GLOBAL_PATH, CLUSTER_PATH = 0, -1, -2
# int32 indices, and a block's stride past the last point, below 2^31
_MAX_N = 2**31 - 1 - 1024


def fps_plan(N: int, C: int = 3, B: int = 1) -> tuple[int, int]:
    """Launch plan ``(threads, points_per_thread)`` for B clouds of N >= 1 points.

    ``points_per_thread`` in {1, 2, 4, 8} takes the kernel's register path
    (coordinates and running distances in registers), for C in
    ``REGISTER_CHANNELS`` and N up to ``MAX_REGISTER_POINTS``;
    ``CLUSTER_PATH`` its cluster path (one cloud over a cluster of
    ``CLUSTER_BLOCKS`` blocks) above ``MAX_SHARED_POINTS`` up to
    ``MAX_CLUSTER_POINTS``, and above ``MAX_REGISTER_POINTS`` for as few
    clouds as fit on the card at once; ``SHARED_PATH`` its shared path
    (distances in shared memory) for the rest up to ``MAX_SHARED_POINTS``;
    ``GLOBAL_PATH`` its global path (distances in a scratch tensor in device
    memory) above ``MAX_CLUSTER_POINTS``. Few, full threads keep the one
    barrier of a step cheap; the table was picked by measurement
    (``scripts/tune_torch_fps.py``, recorded in PERF.md).
    """
    if N < 1:
        raise ValueError(f"fps: N={N} outside the clouds FPS takes (N >= 1)")
    if N > MAX_CLUSTER_POINTS:
        return 1024, GLOBAL_PATH
    if N > MAX_SHARED_POINTS or (N > MAX_REGISTER_POINTS and B * CLUSTER_BLOCKS <= SMS):
        large = -(-N // CLUSTER_BLOCKS) > CLUSTER_SMALL_SLICE and C in REGISTER_CHANNELS
        return 1024 if large else 512, CLUSTER_PATH
    if C not in REGISTER_CHANNELS or N > MAX_REGISTER_POINTS:
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


@counted("fps")
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
    threads, points_per_thread = fps_plan(N, C, B)
    points = points.contiguous()
    start = _start_tensor(start_idx, B, N, points.device)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=points.device)
    # the global path's running distances, allocated on the caller's stream
    scratch = (torch.empty((B, N), dtype=torch.float32, device=points.device)
               if points_per_thread == GLOBAL_PATH else None)
    _build.call("plpe_fps", points, start, out, scratch, B, N, C, num_samples, threads, points_per_thread,
                CLUSTER_BLOCKS)
    fps.launches += 1
    return out
