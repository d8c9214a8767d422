"""Fused eval-mode set abstraction: the CUDA kernel and its plain PyTorch
version.

``fused_sa_infer`` replaces the TPU kernel ``pointnet_like_pose_estimation_
tpu/kernels/fused_sa.py`` (``_fused_sa_kernel`` via ``fused_sa_infer``). A
CPU tensor takes ``fused_sa_reference``; a CUDA tensor launches
``csrc/fused_sa.cu`` or raises. The kernel's design and what bounds it are
noted in the source. Its MLP products run on the tensor cores as
error-compensated TF32 (``matmul_3xtf32`` spells the arithmetic in plain
PyTorch), so its features agree with the plain version to about 1e-5 at
the model's widths, not bit for bit; the selected neighbours are exact.
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
from pointnet_like_pose_estimation_tpu_torch.utils.counters import counted

# what csrc/fused_sa.cu takes (kernel constants mirrored below)
MAX_SCALES = 8
MAX_LAYERS = 4
MAX_SHARED_BYTES = 227 * 1024 - 1024
_RING_FLOATS = 3 * 32 * (128 + 8)   # kStages * kSliceRows * kStagePitch
_WARPS = 16                         # kThreads / 32
_MAX_CHUNK_GROUPS = 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def launch_plan(P: int, ks, layer_widths) -> tuple[int, int, int]:
    """``(rows, centroids_per_block, shared_bytes)`` of one kernel launch.

    A block owns ``centroids_per_block`` centroids and runs a scale's MLP
    over chunks of ``rows`` neighbour rows: 128 where the two activation
    buffers (row-major, pitch ``round_up(width, 8) + 4``), the weight ring,
    the running max ``[centroids, sum C_last]``, the centroids, the selected
    indices and the biases fit in ``MAX_SHARED_BYTES``, else 64. K is padded
    to a multiple of 16 rows, and a block takes as many centroids as fill
    one chunk at the smallest K, times 2 or 4 while its (centroid, scale)
    pairs leave selecting warps idle: the block's set-up is then shared by
    more chunks. The plan depends on the channels, the neighbour counts and
    the widths alone, not on the number of clouds or centroids. The kernel
    computes the same shared-memory figure and refuses a launch whose plan
    differs. Raises ``ValueError`` for widths off the 8-column MMA tile and
    when even 64 rows do not fit.
    """
    if any(c % 8 for ws in layer_widths for c in ws):
        raise ValueError(f"fused_sa: widths={layer_widths} must be multiples of 8 (MMA tiles)")
    width0, width1 = (4 if P == 3 else P), 0
    for widths in layer_widths:
        for li, c in enumerate(widths[:-1]):
            if li % 2:
                width0 = max(width0, c)
            else:
                width1 = max(width1, c)
    pitches = _round_up(width0, 8) + 4 + (_round_up(width1, 8) + 4 if width1 else 0)
    c_total = sum(widths[-1] for widths in layer_widths)
    biases = sum(sum(widths) for widths in layer_widths)
    for rows in (128, 64):
        base = max(1, rows // min(_round_up(k, 16) for k in ks))
        groups = 1
        while groups < _MAX_CHUNK_GROUPS and base * groups * len(ks) < _WARPS:
            groups *= 2
        centroids = base * groups
        nbytes = 4 * (rows * pitches + _RING_FLOATS + centroids * (c_total + 4 + sum(ks)) + biases)
        if nbytes <= MAX_SHARED_BYTES:
            return rows, centroids, nbytes
    raise ValueError(f"fused_sa: P={P}, ks={ks}, widths={layer_widths} exceed the kernel's "
                     f"{MAX_SHARED_BYTES} bytes of shared memory ({nbytes} at 64 rows)")


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operand split, in plain PyTorch: ``hi`` is float32 ``x``
    with its mantissa rounded to TF32's 10 bits (to nearest, ties away from
    zero), ``lo`` is ``x - hi`` with its mantissa cut to 10 bits."""
    def bits(v):
        return v.contiguous().view(torch.int32)

    hi = ((bits(x) + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, (bits(x - hi) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel forms it: three products of the TF32 halves,
    small terms first, summed in float32."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mma_tile_selftest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [16, 8] @ b [8, 8]`` on the card through the kernel's MMA fragment
    layout and compensated product, one warp: a check of the layout against
    any other product of the same tile."""
    for t, shape in ((a, (16, 8)), (b, (8, 8))):
        if (t.device.type != "cuda" or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"mma_tile_selftest: want a contiguous float32 CUDA tensor {shape}")
    out = torch.empty((16, 8), dtype=torch.float32, device=a.device)
    _build.call("plpe_fused_sa_mma_selftest", a, b, out)
    return out


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


@counted("fused_sa")
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

    # what only the kernel asks for: its MMA tiles, its shared memory, its 16-byte copies
    B, N, P = ptsfeat.shape
    rows, tile, nbytes = launch_plan(P, ks, layer_widths)
    if any(w.dim() == 2 and w.data_ptr() % 16 for w in weights):
        raise ValueError("fused_sa: want 16-byte aligned weight matrices (asynchronous copies)")
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
    _build.call("plpe_fused_sa", ptsfeat, centroids, out, idx_out, B, N, S, P, n, r2, kk, counts, widths, ptrs,
                rows, tile, nbytes)
    fused_sa_infer.launches += 1
    return out
