"""BatchNorm + ReLU over channels-last ``[R, C]``: the CUDA kernels, their
plain PyTorch versions, and, in train mode, the autograd Function that
joins forward and backward.

``bn_relu(x, bn)`` computes ``torch.relu(bn(x))`` for a train-mode
``nn/layers.py`` ``BatchNormF32`` in one ``torch.autograd.Function``: the
batch's mean and biased variance by ``torch.var_mean`` (the plain pair's
own reduction, so that the forward equals the plain pair's bit for bit;
``csrc/bn_relu.cu`` says why), then on a CUDA tensor two kernels forward
and three backward (``csrc/bn_relu.cu``, whose note gives the design and
what bounds it), on a CPU tensor the plain versions below. ``PointwiseMLP``
decides which pairs take it (``nn/layers.py`` ``plain_reason``); the others
go through ``plain_bn_relu``. It replaces no TPU kernel: XLA fused these
ops on the TPU, and PyTorch runs them as some ten passes of its own kernels.

In eval mode ``bn_relu_eval(x, bn)`` computes ``torch.relu(bn(x))`` from
the running statistics in one pass, and ``bn_relu_eval_pool(x, bn)``
``torch.relu(bn(x)).amax(dim=-2)`` in one pass that writes only the
maxima, both rounded as PyTorch's own eval BatchNorm rounds, so that they
equal the plain pair bit for bit (``csrc/bn_relu.cu``, "Eval mode"). They
have no backward: ``plain_reason`` sends an eval pair whose output needs a
gradient to the plain path.

``bn_relu_eval_gather(pf, qc, idx, bias, bn)`` is the first eval-mode pair
of a set abstraction that took its first Linear per point
(``ops/grouping.py`` ``per_point_products``): it gathers each neighbour's
product, subtracts its centroid's, adds the Linear's bias and applies the
eval BatchNorm + ReLU as ``bn_relu_eval`` does, in one pass that writes
the ``[B, S, K, C]`` output and reads nothing of that size
(``csrc/bn_relu.cu``, "Gathered eval mode").

Every path counts (``utils/counters.py``): ``bn_relu.launches`` the fused
train forwards on the card, ``bn_relu_eval.launches`` and
``bn_relu_eval_pool.launches`` the eval passes there,
``plain_bn_relu.launches`` and ``plain_bn_relu_eval.launches`` the train-
and eval-mode pairs that took the plain path, ``bn_relu_eval_gather.launches``
the gathered first pairs on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build
from pointnet_like_pose_estimation_tpu_torch.ops.geometry import index_points
from pointnet_like_pose_estimation_tpu_torch.utils.counters import counted

# what csrc/bn_relu.cu takes (kThreads, kMaxRowBlocks: four blocks of 256
# threads on each of the card's 132 SMs)
THREADS = 256
MAX_ROW_BLOCKS = 4 * 132
# what its pooled eval pass takes (kPoolThreads: the threads that fill the
# card, 512 on each SM; kMinPieceRows: the fewest rows of a piece of a group)
POOL_THREADS = 512 * 132
MIN_PIECE_ROWS = 8
# PyTorch's eval BatchNorm takes its channels-last kernel, whose rounding
# the eval passes repeat, for a tensor of fewer elements than this
# (canUse32BitIndexMath); from it on its general kernel, which rounds
# otherwise, so larger pairs keep the plain path (nn/layers.py plain_reason)
INT32_ELEMENTS = 2**31 - 1


class BnReluPlan(NamedTuple):
    """The launch geometry of ``csrc/bn_relu.cu``."""

    tpr: int      # threads a row, one 16-byte column group (4 channels) each
    rpi: int      # rows a block takes at once
    chunks: int   # column chunks of THREADS groups (gridDim.y)
    slab: int     # rows a block, a multiple of rpi
    blocks: int   # row blocks, each writing one partial per channel


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def bn_relu_plan(R: int, C: int) -> BnReluPlan:
    """Launch plan for ``[R, C]``: ``min(C / 4, THREADS)`` threads span a
    row, the rows go in at most ``MAX_ROW_BLOCKS`` slabs of whole steps. The
    kernel computes the same figures and refuses a launch whose ``blocks``
    differs. Raises ``ValueError`` where R < 1 or C is no multiple of 4."""
    if R < 1 or C < 4 or C % 4:
        raise ValueError(f"bn_relu: no plan for R={R}, C={C} (want R >= 1, C a multiple of 4)")
    groups = C // 4
    tpr = min(groups, THREADS)
    rpi = THREADS // tpr
    blocks = min(_ceil_div(R, rpi), MAX_ROW_BLOCKS)
    slab = _ceil_div(_ceil_div(R, blocks), rpi) * rpi
    return BnReluPlan(tpr, rpi, _ceil_div(groups, tpr), slab, _ceil_div(R, slab))


def forward_reference(x, mean, rstd, weight, bias) -> torch.Tensor:
    """Plain version of the apply pass: ``max((x - mean) * (rstd * w) + b, 0)``."""
    return torch.relu((x - mean) * (rstd * weight) + bias)


def backward_reference(x, dy, mean, rstd, weight, bias) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: ``(dx, grad_weight, grad_bias)`` from
    ``x``, the output's gradient ``dy`` and the forward's mean and rstd. The
    ReLU passes ``dy`` where the forward's ``(x - mean) * scale + b`` was
    positive; with ``xh = (x - mean) * rstd``, ``grad_bias = sum g``,
    ``grad_weight = sum g * xh`` and ``dx = scale * ((g - sum g / R) - xh *
    (sum g * xh / R))``."""
    R = x.shape[0]
    scale = rstd * weight
    d = x - mean
    g = torch.where(d * scale + bias <= 0, torch.zeros_like(dy), dy)
    xh = d * rstd
    sg, sgx = g.sum(dim=0), (g * xh).sum(dim=0)
    return scale * ((g - sg / R) - xh * (sgx / R)), sgx, sg


class BnReluPoolPlan(NamedTuple):
    """The launch geometry of the pooled eval pass of ``csrc/bn_relu.cu``."""

    tpr: int          # threads a lane, one 16-byte column group (4 channels) each
    rpi: int          # lanes a block, one piece of a group each
    chunks: int       # column chunks of THREADS groups (gridDim.y)
    pieces: int       # pieces a group, merged by atomicMax where above 1
    piece_rows: int   # rows a piece (the last may have fewer)
    blocks: int       # gridDim.x


def bn_relu_pool_plan(G: int, K: int, C: int) -> BnReluPoolPlan:
    """Launch plan for ``[G, K, C]`` pooled over K: ``min(C / 4, THREADS)``
    threads span a row; a group is one piece unless ``G * C / 4`` threads
    fall short of ``POOL_THREADS``, then as many more pieces as fill it, of
    at least ``MIN_PIECE_ROWS`` rows. The kernel computes the same figures
    and refuses a launch whose ``pieces`` differs. Raises ``ValueError``
    where G or K is below 1 or C is no multiple of 4."""
    if G < 1 or K < 1 or C < 4 or C % 4:
        raise ValueError(f"bn_relu: no pooled plan for G={G}, K={K}, C={C} "
                         "(want G, K >= 1, C a multiple of 4)")
    groups = C // 4
    tpr = min(groups, THREADS)
    rpi = THREADS // tpr
    pieces = max(1, min(_ceil_div(POOL_THREADS, G * groups), K // MIN_PIECE_ROWS))
    piece_rows = _ceil_div(K, pieces)
    pieces = _ceil_div(K, piece_rows)
    return BnReluPoolPlan(tpr, rpi, _ceil_div(groups, tpr), pieces, piece_rows, _ceil_div(G * pieces, rpi))


def eval_reference(x, running_mean, running_var, weight, bias, eps: float) -> torch.Tensor:
    """Plain version of the eval pass over ``[R, C]``: ``relu(w * (x -
    running_mean) * invstd + b)`` with ``invstd = rsqrt(running_var +
    eps)``, rounded as PyTorch's eval BatchNorm on the card rounds it:
    ``w * (x - mean)`` rounded, then ``* invstd + b`` rounded once, as a
    fused multiply-add (the product is exact in float64, and the sum
    rounded there and again to float32 parts from one rounding only where
    the float64 sum lies on a float32 tie)."""
    p = weight * (x - running_mean)
    t = p.double() * torch.rsqrt(running_var + eps).double() + bias.double()
    return torch.relu(t.to(x.dtype))


def eval_max_reference(x, running_mean, running_var, weight, bias, eps: float) -> torch.Tensor:
    """Plain version of the pooled eval pass: ``eval_reference`` of ``[G,
    K, C]`` and its max over K (``amax``: a NaN in a group gives NaN)."""
    G, K, C = x.shape
    return eval_reference(x.reshape(G * K, C), running_mean, running_var, weight, bias, eps).reshape(
        G, K, C).amax(dim=1)


def eval_gather_reference(pf, qc, idx, bias, running_mean, running_var, weight, bn_bias, eps: float):
    """Plain version of the gathered eval pass: ``x = (pf[b, idx[b, s, k]]
    - qc[b, s]) + bias``, each step rounded on its own, then
    ``eval_reference`` of ``x``; ``[B, S, K, C]``."""
    x = (index_points(pf, idx) - qc[:, :, None, :]) + bias
    return eval_reference(x, running_mean, running_var, weight, bn_bias, eps)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte boundary (the kernels read float4)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _validate(x: torch.Tensor, *vectors: torch.Tensor) -> None:
    R, C = x.shape
    if x.dtype != torch.float32 or R < 1 or C % 4:
        raise ValueError(f"bn_relu: want float32 [R >= 1, C % 4 == 0], got {x.dtype} {tuple(x.shape)}")
    _validate_vectors(C, x.device, vectors)


def _validate_vectors(C: int, device: torch.device, vectors) -> None:
    for v in vectors:
        if v.dtype != torch.float32 or v.shape != (C,) or not v.is_contiguous() or v.device != device:
            raise ValueError(f"bn_relu: want contiguous float32 [{C}] vectors beside x, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _forward_kernel(x, mean, var, weight, bias, running_mean, running_var, momentum: float, eps: float):
    _validate(x, mean, var, weight, bias, running_mean, running_var)
    R, C = x.shape
    plan = bn_relu_plan(R, C)
    y = torch.empty_like(x)
    rstd, scale = (torch.empty(C, dtype=torch.float32, device=x.device) for _ in range(2))
    _build.call("plpe_bn_relu_forward", x, y, mean, var, weight, bias, running_mean, running_var, rstd, scale,
                R, C, plan.blocks, 1.0 - momentum, momentum, eps)
    return y, rstd


def _backward_kernel(x, dy, mean, rstd, weight, bias):
    _validate(x, mean, rstd, weight, bias)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"bn_relu: gradient {dy.dtype} {tuple(dy.shape)} for x {x.dtype} {tuple(x.shape)}")
    R, C = x.shape
    plan = bn_relu_plan(R, C)
    dx = torch.empty_like(x)
    grad_w, grad_b = (torch.empty(C, dtype=torch.float32, device=x.device) for _ in range(2))
    coef = torch.empty((2, C), dtype=torch.float32, device=x.device)
    part = torch.empty((2, plan.blocks, C), dtype=torch.float32, device=x.device)
    _build.call("plpe_bn_relu_backward", x, dy, mean, rstd, weight, bias, dx, grad_w, grad_b, coef, part,
                R, C, plan.blocks)
    return dx, grad_w, grad_b


def _eval_kernel(x, running_mean, running_var, weight, bias, eps: float) -> torch.Tensor:
    _validate(x, running_mean, running_var, weight, bias)
    R, C = x.shape
    y = torch.empty_like(x)
    _build.call("plpe_bn_relu_eval", x, y, running_mean, running_var, weight, bias, R, C,
                bn_relu_plan(R, C).blocks, eps)
    return y


def _eval_max_kernel(x, running_mean, running_var, weight, bias, eps: float) -> torch.Tensor:
    G, K, C = x.shape
    _validate(x.reshape(G * K, C), running_mean, running_var, weight, bias)
    y = torch.empty((G, C), dtype=x.dtype, device=x.device)
    _build.call("plpe_bn_relu_eval_max", x, y, running_mean, running_var, weight, bias, G, K, C,
                bn_relu_pool_plan(G, K, C).pieces, eps)
    return y


def _rows(t: torch.Tensor, dtype: torch.dtype, name: str) -> int:
    """The row stride of ``t`` ``[B, R, C]``, whose rows are contiguous and
    evenly spaced (a slice of columns of a contiguous tensor); raises where
    the gathered pass cannot read it (float rows at a 16-byte boundary and
    a stride of whole 16-byte groups)."""
    ld = t.stride(1)
    ok = t.dim() == 3 and t.dtype == dtype and t.stride(2) == 1 and t.stride(0) == t.shape[1] * ld
    if ok and dtype == torch.float32:
        ok = ld % 4 == 0 and t.data_ptr() % 16 == 0
    if not ok:
        raise ValueError(f"bn_relu_eval_gather: {name} {t.dtype} {tuple(t.shape)} strides {t.stride()} "
                         f"is no [B, R, C] {dtype} of evenly spaced contiguous rows")
    return ld


def _eval_gather_kernel(pf, qc, idx, bias, running_mean, running_var, weight, bn_bias, eps: float):
    B, N, C = pf.shape
    _, S, K = idx.shape
    if qc.shape != (B, S, C) or idx.shape[0] != B or C % 4 or K < 1:
        raise ValueError(f"bn_relu_eval_gather: pf {tuple(pf.shape)}, qc {tuple(qc.shape)}, idx "
                         f"{tuple(idx.shape)} (want [B, N, C], [B, S, C], [B, S, K], C % 4 == 0)")
    strides = _rows(pf, torch.float32, "pf"), _rows(qc, torch.float32, "qc"), _rows(idx, torch.int32, "idx")
    _validate_vectors(C, pf.device, (bias, running_mean, running_var, weight, bn_bias))
    y = torch.empty((B, S, K, C), dtype=pf.dtype, device=pf.device)
    _build.call("plpe_bn_relu_eval_gather", pf, qc, idx, bias, running_mean, running_var, weight, bn_bias, y,
                B, N, S, K, C, *strides, eps)
    return y


class BatchNormReLU(torch.autograd.Function):
    """``relu(batch_norm(x))`` in train mode over ``[R, C]``, updating the
    running statistics in place. Keeps ``x``, the mean and rstd for the
    backward; the normalised tensor and the ReLU's mask are formed again
    there. CUDA tensors take the kernels, CPU tensors the plain versions;
    both take the statistics from ``torch.var_mean``."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum: float, eps: float):
        # the plain pair's own call on the same tensor: the same statistics, bit for bit
        var, mean = torch.var_mean(x, dim=0, unbiased=False)
        if x.is_cuda:
            x = _aligned(x)
            y, rstd = _forward_kernel(x, mean, var, weight, bias, running_mean, running_var, momentum, eps)
        else:
            rstd = torch.rsqrt(var + eps)
            y = forward_reference(x, mean, rstd, weight, bias)
            running_mean.mul_(1.0 - momentum).add_(momentum * mean)
            running_var.mul_(1.0 - momentum).add_(momentum * var)
        ctx.save_for_backward(x, mean, rstd, weight, bias)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, mean, rstd, weight, bias = ctx.saved_tensors
        if x.is_cuda:
            dx, grad_w, grad_b = _backward_kernel(x, _aligned(dy), mean, rstd, weight, bias)
        else:
            dx, grad_w, grad_b = backward_reference(x, dy, mean, rstd, weight, bias)
        return dx, grad_w, grad_b, None, None, None, None


@counted("bn_relu")
def bn_relu(x: torch.Tensor, bn) -> torch.Tensor:
    """``torch.relu(bn(x))`` for a train-mode ``BatchNormF32`` ``bn`` over
    the trailing axis of ``x``, as one Function: the batch statistics over
    every other axis, the biased variance, the running statistics and
    ``num_batches_tracked`` updated as ``BatchNormF32`` updates them."""
    shape = x.shape
    y = BatchNormReLU.apply(x.reshape(-1, shape[-1]), bn.weight, bn.bias, bn.running_mean, bn.running_var,
                            bn.momentum, bn.eps)
    with torch.no_grad():
        bn.num_batches_tracked += 1
    if x.is_cuda:
        bn_relu.launches += 1
    return y.reshape(shape)


def _eval_args(bn):
    return bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps


@counted("bn_relu_eval")
def bn_relu_eval(x: torch.Tensor, bn) -> torch.Tensor:
    """``torch.relu(bn(x))`` for an eval-mode ``BatchNormF32`` ``bn`` over
    the trailing axis of float32 ``x``, in one pass: one read of ``x``, one
    write of the output. Gives no gradient."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.is_cuda:
        y = _eval_kernel(_aligned(x2), *_eval_args(bn))
        bn_relu_eval.launches += 1
    else:
        y = eval_reference(x2, *_eval_args(bn))
    return y.reshape(shape)


@counted("bn_relu_eval_pool")
def bn_relu_eval_pool(x: torch.Tensor, bn) -> torch.Tensor:
    """``torch.relu(bn(x)).amax(dim=-2)`` for an eval-mode
    ``BatchNormF32`` ``bn``, in one pass: one read of ``x [..., K, C]``, one
    write of ``[..., C]``. Gives no gradient."""
    shape = x.shape
    x3 = x.reshape(-1, shape[-2], shape[-1])
    if x.is_cuda:
        y = _eval_max_kernel(_aligned(x3), *_eval_args(bn))
        bn_relu_eval_pool.launches += 1
    else:
        y = eval_max_reference(x3, *_eval_args(bn))
    return y.reshape(*shape[:-2], shape[-1])


@counted("bn_relu_eval_gather")
def bn_relu_eval_gather(pf: torch.Tensor, qc: torch.Tensor, idx: torch.Tensor, bias: torch.Tensor,
                        bn) -> torch.Tensor:
    """``torch.relu(bn(pf[b, idx[b, s, k]] - qc[b, s] + bias))`` ``[B, S,
    K, C]`` for an eval-mode ``BatchNormF32`` ``bn``: the first pair of a
    set abstraction whose first Linear was taken per point, ``pf`` ``[B, N,
    C]`` its products of the points, ``qc`` ``[B, S, C]`` those of the
    centroids' coordinates, ``bias`` its bias and ``idx`` ``[B, S, K]``
    int32 the neighbours (slices of wider tensors' columns are read in
    place). One pass on the card; gives no gradient."""
    if pf.is_cuda:
        y = _eval_gather_kernel(pf, qc, idx, bias, *_eval_args(bn))
        bn_relu_eval_gather.launches += 1
        return y
    return eval_gather_reference(pf, qc, idx, bias, *_eval_args(bn))


@counted("bn_relu_plain")
def plain_bn_relu(x: torch.Tensor, bn) -> torch.Tensor:
    """``torch.relu(bn(x))``, the pair as PyTorch runs it, for a train-mode
    pair that ``bn_relu`` did not take; counts the calls."""
    plain_bn_relu.launches += 1
    return torch.relu(bn(x))


@counted("bn_relu_eval_plain")
def plain_bn_relu_eval(x: torch.Tensor, bn) -> torch.Tensor:
    """The same for an eval-mode pair that the eval passes did not take."""
    plain_bn_relu_eval.launches += 1
    return torch.relu(bn(x))
