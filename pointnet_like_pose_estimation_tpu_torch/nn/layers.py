"""Shared layers (counterparts of ``nn/layers.py`` of the JAX package).

The reference's ``Conv1d/Conv2d(k=1) + BatchNorm + ReLU`` stacks are
pointwise linear maps over the trailing channel axis, so channels-last they
are ``nn.Linear`` layers, with BatchNorm over every other axis.

Module names follow the flax parameter tree (``dense_0``, ``bn_0``,
``fc_0``...) so that ``utils.checkpoint.from_flax_variables`` maps a JAX
checkpoint onto the ``state_dict`` key by key.

The compute dtype is flax's ``dtype``: it reaches only the ``Linear``
layers (``set_compute_dtype``). Parameters stay float32, and every
BatchNorm, ReLU, dropout after a BatchNorm and max over a group runs in
float32, as ``batch_norm_f32`` makes the JAX package run them.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pointnet_like_pose_estimation_tpu_torch.kernels.bn_relu import (
    INT32_ELEMENTS,
    bn_relu,
    bn_relu_eval,
    bn_relu_eval_gather,
    bn_relu_eval_pool,
    plain_bn_relu,
    plain_bn_relu_eval,
)
from pointnet_like_pose_estimation_tpu_torch.nn.bn_context import bn_group

# TrainConfig.dtype / PipelineConfig.dtype -> the Linear layers' compute dtype
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s compute dtype. With
    ``compute_dtype`` set, the input, weight and bias are cast to it, and
    the product and the bias add are each rounded to it, as flax rounds its
    ``dot_general`` and then ``y + bias``: the result is in the compute
    dtype and the float32 parameters get float32 gradients through the
    casts. Without it the layer is ``nn.Linear``.

    The two roundings are kept because a bias folded into the product (one
    rounding) is another function of the same inputs: it would part the
    port from JAX by a bfloat16 ulp wherever the two round apart, on top of
    the summation order that parts them already."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def set_compute_dtype(model: nn.Module, dtype: str) -> nn.Module:
    """Set the compute dtype (``"float32"`` or ``"bfloat16"``) of every
    ``Linear`` of ``model``, in place."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute dtype {dtype!r}; one of {sorted(COMPUTE_DTYPES)}")
    for m in model.modules():
        if isinstance(m, Linear):
            m.compute_dtype = COMPUTE_DTYPES[dtype]
    return model


def _synced_var_mean(x: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """Biased variance and mean of ``[rows, C]`` over the rows of every rank
    of ``group``, in two passes, each one differentiable all-reduce."""
    from pointnet_like_pose_estimation_tpu_torch.parallel import collectives

    total = collectives.all_reduce(torch.cat([x.sum(dim=0), x.new_full((1,), x.shape[0])]), group, "batch_norm")
    rows = total[-1]
    mean = total[:-1] / rows
    dev = x - mean
    var = collectives.all_reduce((dev * dev).sum(dim=0), group, "batch_norm") / rows
    return var, mean


class BatchNormF32(nn.BatchNorm1d):
    """BatchNorm over every non-channel axis of ``[..., C]``, in at least
    float32 (a float64 input stays float64), as flax's ``BatchNorm``
    computes it.

    ``momentum=0.1`` is flax's ``momentum=0.9``; eps is 1e-5 in both. In
    eval it uses the running mean and variance. In train mode it normalises
    with the batch mean and the **biased** batch variance over every row,
    and updates the running variance with that same biased variance, as
    flax does (``nn.BatchNorm1d`` would use the unbiased one).

    The variance is formed in two passes (``torch.var_mean``: the mean,
    then the mean squared deviation from it). flax forms ``E[x^2] -
    E[x]^2`` clipped at 0 (``use_fast_variance``); the two are equal but
    for rounding, and the two-pass form keeps its digits where a channel's
    spread is small beside its mean: with the one-pass form, reordering the
    batch of a float32 train step of ``sign_msg`` (batch 24) moved its
    gradients by up to 2.6e-4, with the two-pass form by 6e-6.

    Under ``bn_sync(group)`` (``nn/bn_context.py``) the statistics are
    those of every row of the group's ranks, in the same two passes: one
    all-reduce of the row count and the sum gives the mean, a second of the
    squared deviations from it the biased variance. Both carry gradients.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(-1, shape[-1])
        if not self.training:
            return super().forward(x).reshape(shape)
        group = bn_group()
        if group is None:
            var, mean = torch.var_mean(x, dim=0, unbiased=False)
        else:
            var, mean = _synced_var_mean(x, group)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked += 1
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.reshape(shape)


class Dropout(nn.Module):
    """flax's dropout with its random numbers supplied from outside: in train
    mode a unit is kept where its uniform draw is at least ``rate`` and then
    scaled by ``1 / (1 - rate)``, else zeroed. ``nn.Dropout`` takes no
    generator, so the caller (the train step) draws the ``[B, features]``
    uniforms from its own ``torch.Generator`` and sets ``uniforms`` before a
    forward; a train-mode forward without them raises. To turn dropout off,
    put this module in eval mode.
    """

    def __init__(self, rate: float, features: int):
        super().__init__()
        self.rate = rate
        self.features = features
        self.uniforms: torch.Tensor | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.uniforms is None:
            raise RuntimeError("Dropout in train mode: no uniforms were supplied")
        if self.uniforms.shape != x.shape:
            raise ValueError(f"Dropout: uniforms {tuple(self.uniforms.shape)} for input {tuple(x.shape)}")
        return torch.where(self.uniforms >= self.rate, x / (1.0 - self.rate), torch.zeros_like(x))


def plain_reason(x: torch.Tensor, bn: nn.Module) -> str | None:
    """Why ``relu(bn(x))`` takes the plain path (``torch.relu(bn(x))``),
    or None where it takes the fused kernels (``kernels/bn_relu.py``: in
    train mode the train-mode Function, in eval mode the eval passes):
    ``"module"`` (a BatchNorm of another forward, such as the
    tensor-parallel shard), ``"bn_sync"`` (statistics over a process
    group), ``"dtype"`` (anything but float32: float64, and the bfloat16
    compute path), ``"width"`` (channels no multiple of 4, which the
    kernels' 16-byte loads do not take), ``"eval"`` (an eval-mode pair
    whose output needs a gradient: the eval passes have no backward),
    ``"size"`` (an eval-mode pair of ``INT32_ELEMENTS`` or more, where
    PyTorch's eval BatchNorm rounds otherwise than the eval passes) or
    ``"device"`` (not a CUDA tensor: the CPU, where the port is held
    against the JAX package)."""
    return pair_reason(bn, x.dtype, x.shape[-1], x.numel(), x.requires_grad, x.is_cuda)


def pair_reason(bn: nn.Module, dtype: torch.dtype, width: int, numel: int, requires_grad: bool,
                is_cuda: bool) -> str | None:
    """``plain_reason`` of a pair's input described by its dtype, its
    channels, its elements, whether it requires a gradient and its device,
    for an input not yet formed."""
    if type(bn) is not BatchNormF32:
        return "module"
    if bn_group() is not None:
        return "bn_sync"
    if dtype != torch.float32:
        return "dtype"
    if width % 4:
        return "width"
    if not bn.training:
        if torch.is_grad_enabled() and (requires_grad or bn.weight.requires_grad or bn.bias.requires_grad):
            return "eval"
        if numel >= INT32_ELEMENTS:
            return "size"
    if not is_cuda:
        return "device"
    return None


def bn_relu_pair(x: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """``torch.relu(bn(x))`` over the trailing axis of ``x``, on the path
    ``plain_reason`` picks: fused where it gives None (in train mode the
    train-mode Function, in eval mode one pass), else the plain pair."""
    if plain_reason(x, bn):
        return plain_bn_relu(x, bn) if bn.training else plain_bn_relu_eval(x, bn)
    return bn_relu(x, bn) if bn.training else bn_relu_eval(x, bn)


class PointwiseMLP(nn.Module):
    """Stack of Linear -> BatchNorm -> ReLU over the trailing channel axis.
    Each BatchNorm + ReLU pair is ``bn_relu_pair``. ``forward_max`` adds
    the max over the second-last axis, which an eval-mode last pair takes
    in its own pass. ``forward_max_grouped`` is ``forward_max`` of grouped
    rows whose first Linear was taken per point, its first pair formed from
    the gathered products in one pass. ``bias=False`` builds Linears
    without a bias."""

    def __init__(self, in_features: int, features: Sequence[int], final_activation: bool = True,
                 bias: bool = True):
        super().__init__()
        self.n = len(features)
        self.final_activation = final_activation
        for i, width in enumerate(features):
            self.add_module(f"dense_{i}", Linear(in_features, width, bias=bias))
            if i < self.n - 1 or final_activation:
                self.add_module(f"bn_{i}", BatchNormF32(width))
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._layers(x, pool=False)

    def forward_max(self, x: torch.Tensor) -> torch.Tensor:
        """``self(x).amax(dim=-2)``, the max over each group of ``[..., K,
        C]``: the same values, bit for bit."""
        return self._layers(x, pool=True)

    def forward_max_grouped(self, pf: torch.Tensor, qc: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``forward_max`` of the groups ``idx [B, S, K]`` whose first
        Linear was taken per point (``ops/grouping.py``
        ``per_point_products``): the first layer's output at ``[b, s, k]``
        is ``pf[b, idx[b, s, k]] - qc[b, s] + dense_0.bias``, which
        ``bn_relu_eval_gather`` forms with the first eval-mode pair in one
        pass; the other layers as ``forward_max``. Only for the layers that
        ``nn/set_abstraction.py`` ``per_point_reason`` admits."""
        x = bn_relu_eval_gather(pf, qc, idx, self.dense_0.bias, self.bn_0)
        return self._layers(x, pool=True, start=1)

    def _layers(self, x: torch.Tensor, pool: bool, start: int = 0) -> torch.Tensor:
        for i in range(start, self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1 or self.final_activation:
                bn = getattr(self, f"bn_{i}")
                if pool and i == self.n - 1 and not bn.training and plain_reason(x, bn) is None:
                    return bn_relu_eval_pool(x, bn)
                x = bn_relu_pair(x, bn)
        return x.amax(dim=-2) if pool else x


class DenseHead(nn.Module):
    """Fully-connected head with the reference's three op orders on its
    hidden layers (the last layer is a plain Linear):

    - ``cls_v1``: relu(bn(fc)), then relu(bn(dropout(fc))) on the second;
    - ``cls_v2``: dropout(relu(bn(fc)));
    - ``pose``: relu(dropout(bn(fc))).

    Each dropout site is its own ``Dropout`` (``drop_i`` after ``fc_i``),
    since each draws its own uniforms.
    """

    def __init__(self, in_features: int, features: Sequence[int], style: str = "pose",
                 dropout_rate: float = 0.4):
        super().__init__()
        if style not in ("cls_v1", "cls_v2", "pose"):
            raise ValueError(f"unknown DenseHead style {style!r}")
        self.style = style
        self.n = len(features)
        for i, width in enumerate(features):
            self.add_module(f"fc_{i}", Linear(in_features, width))
            if i < self.n - 1:
                self.add_module(f"bn_{i}", BatchNormF32(width))
                if style != "cls_v1" or i == 1:
                    self.add_module(f"drop_{i}", Dropout(dropout_rate, width))
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"fc_{i}")(x)
            if i == self.n - 1:
                break
            bn = getattr(self, f"bn_{i}")
            if self.style == "cls_v1":
                x = torch.relu(bn(self.drop_1(x) if i == 1 else x))
            elif self.style == "cls_v2":
                x = getattr(self, f"drop_{i}")(torch.relu(bn(x)))
            else:
                x = torch.relu(getattr(self, f"drop_{i}")(bn(x)))
        return x


def pre_bn_biases(model: nn.Module) -> set[str]:
    """Parameter names of the biases of Linear layers whose output goes
    straight into a BatchNorm (``dense_i``/``bn_i``, ``fc_i``/``bn_i``,
    ``fc1``/``bn1``, ``conv3``/``bn3``; not ``cls_v1``'s ``fc_1``, whose
    dropout sits between the two). Train-mode BatchNorm removes any
    per-channel constant, so their true gradient is 0 and a backward gives
    them rounding noise, which Adam turns into steps of up to the learning
    rate with a random sign: two runs that agree elsewhere part there."""
    names = set()
    for prefix, m in model.named_modules():
        for child, sub in m.named_children():
            found = re.fullmatch(r"(dense|fc|conv)(_?\d+)", child)
            if not isinstance(sub, nn.Linear) or sub.bias is None or found is None:
                continue
            if isinstance(m, DenseHead) and m.style == "cls_v1" and child == "fc_1":
                continue
            if isinstance(getattr(m, "bn" + found.group(2), None), BatchNormF32):
                names.add(f"{prefix}.{child}.bias" if prefix else f"{child}.bias")
    return names
