"""Tensor (model) parallelism, Megatron's alternating layers (counterpart
of ``parallel/tensor_parallel.py`` of the JAX package).

The rule is the JAX package's (``_leaf_spec``), read off the port's module
names: in every sequential stack (``dense_i`` / ``fc_i`` with their
``bn_i``), even layers are column-parallel (the output channels shard over
the ``model`` axis, with the bias and the BatchNorm's parameters and
statistics) and odd layers row-parallel (the input channels shard; the
bias stays whole). A layer shards only where its width is at least
``min_width`` and divides by the axis size. A Linear ``weight`` is ``[out,
in]``, so a column layer's spec is ``("model", None)`` where JAX's kernel
``[in, out]`` has ``P(None, "model")``.

The JAX package annotates shardings and lets XLA place the collectives;
eager PyTorch places them by hand (``shard_state_tp`` swaps each sharded
layer for one that holds its block):

- a column layer's input passes forward as it is, and the backward sums
  its gradient over the axis (``collectives.copy_to``);
- a row layer sums its partial product over the axis and then adds its
  bias, and the backward passes the cotangent through
  (``collectives.reduce_from``);
- where a column layer is the last of its stack, its channels are gathered
  after its BatchNorm (or after the layer where it has none), since what
  follows is replicated (``collectives.gather_last``);
- a dropout between a column and a row layer keeps the columns of its
  uniforms that its block owns, so the step's draws are the single
  device's.

The optimizer is built after sharding, so its moments are sharded by
construction.
"""

from __future__ import annotations

import re

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from pointnet_like_pose_estimation_tpu_torch.nn.layers import BatchNormF32, Dropout, Linear
from pointnet_like_pose_estimation_tpu_torch.parallel import collectives
from pointnet_like_pose_estimation_tpu_torch.parallel.mesh import axis_size

_LAYER_RE = re.compile(r"^(dense|fc|bn)_(\d+)$")


def _leaf_spec(names: list[str], shape, *, axis: str, size: int, min_width: int) -> tuple:
    """The spec of one tensor (one entry a dimension, the axis or None)
    from the last two parts of its name and its shape."""
    whole = (None,) * len(shape)
    m = _LAYER_RE.match(names[-2]) if len(names) >= 2 else None
    if m is None or not shape:
        return whole
    column = int(m.group(2)) % 2 == 0
    if names[-1] == "weight" and len(shape) == 2:               # Linear [out, in]
        if column and shape[0] % size == 0 and shape[0] >= min_width:
            return (axis, None)
        if not column and shape[1] % size == 0 and shape[1] >= min_width:
            return (None, axis)
        return whole
    # per-channel vectors (bias, BatchNorm weight, bias and statistics) shard
    # with their column layer
    if len(shape) == 1 and column and shape[0] % size == 0 and shape[0] >= min_width:
        return (axis,)
    return whole


def tensor_parallel_specs(model: nn.Module, mesh: DeviceMesh, *, axis: str = "model",
                          min_width: int = 128) -> dict[str, tuple]:
    """``{state_dict key: spec}`` of an unsharded ``model``: per dimension
    the mesh axis it shards over, or None."""
    size = axis_size(mesh, axis)
    return {k: _leaf_spec(k.split("."), tuple(v.shape), axis=axis, size=size, min_width=min_width)
            for k, v in model.state_dict().items()}


def tensor_parallel_shardings(model: nn.Module, mesh: DeviceMesh, *, axis: str = "model",
                              min_width: int = 128) -> dict[str, tuple[slice, ...]]:
    """``{state_dict key: index}``: the block of each tensor this rank
    holds under the rule (JAX's ``NamedSharding``s)."""
    size, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    out = {}
    for k, spec in tensor_parallel_specs(model, mesh, axis=axis, min_width=min_width).items():
        shape = model.state_dict()[k].shape
        out[k] = tuple(slice(r * n // size, (r + 1) * n // size) if a else slice(None)
                       for a, n in zip(spec, shape))
    return out


def count_sharded(model: nn.Module, mesh: DeviceMesh, *, axis: str = "model",
                  min_width: int = 128) -> tuple[int, int]:
    """``(sharded parameters, all parameters)`` of an unsharded ``model``
    under the rule."""
    specs = tensor_parallel_specs(model, mesh, axis=axis, min_width=min_width)
    params = dict(model.named_parameters())
    sharded = sum(p.numel() for k, p in params.items() if any(specs[k]))
    return sharded, sum(p.numel() for p in params.values())


class ColumnParallelLinear(Linear):
    """The rows ``[block of out, in]`` of a Linear's weight and its bias
    block; with ``gather``, the blocks of the output gathered."""

    def __init__(self, linear: Linear, rows: slice, group, gather: bool):
        super().__init__(linear.in_features, rows.stop - rows.start, device=linear.weight.device,
                         dtype=linear.weight.dtype)
        self.compute_dtype = linear.compute_dtype
        with torch.no_grad():
            self.weight.copy_(linear.weight[rows])
            self.bias.copy_(linear.bias[rows])
        self.group, self.gather = group, gather

    def forward(self, x):
        y = super().forward(collectives.copy_to(x, self.group, "tensor_parallel"))
        return collectives.gather_last(y, self.group, "tensor_parallel") if self.gather else y


class RowParallelLinear(Linear):
    """The columns ``[out, block of in]`` of a Linear's weight; the partial
    products summed over the axis, then the whole bias added."""

    def __init__(self, linear: Linear, cols: slice, group):
        super().__init__(cols.stop - cols.start, linear.out_features, device=linear.weight.device,
                         dtype=linear.weight.dtype)
        self.compute_dtype = linear.compute_dtype
        with torch.no_grad():
            self.weight.copy_(linear.weight[:, cols])
            self.bias.copy_(linear.bias)
        self.group = group

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        y = nn.functional.linear(x.to(dt), self.weight.to(dt))
        return collectives.reduce_from(y, self.group, "tensor_parallel") + self.bias.to(dt)


class ShardedBatchNorm(BatchNormF32):
    """A BatchNorm's block of channels; with ``gather``, the blocks of the
    output gathered."""

    def __init__(self, bn: BatchNormF32, cols: slice, group, gather: bool):
        super().__init__(cols.stop - cols.start)
        self.to(device=bn.weight.device, dtype=bn.weight.dtype)
        with torch.no_grad():
            for name in ("weight", "bias", "running_mean", "running_var"):
                getattr(self, name).copy_(getattr(bn, name)[cols])
            self.num_batches_tracked.copy_(bn.num_batches_tracked)
        self.group, self.gather = group, gather

    def forward(self, x):
        y = super().forward(x)
        return collectives.gather_last(y, self.group, "tensor_parallel") if self.gather else y


class ShardedDropout(Dropout):
    """A dropout on a block of channels: it keeps its block of the
    full-width uniforms the step draws."""

    def __init__(self, dropout: Dropout, cols: slice):
        super().__init__(dropout.rate, dropout.features)
        self.cols = cols

    def forward(self, x):
        if self.training and self.uniforms is not None and self.uniforms.shape[-1] == self.features:
            self.uniforms = self.uniforms[..., self.cols]
        return super().forward(x)


def shard_state_tp(model: nn.Module, mesh: DeviceMesh, *, axis: str = "model", min_width: int = 128) -> nn.Module:
    """Swap, in place, every layer of ``model`` that the rule shards over
    ``mesh[axis]`` for one that holds this rank's block (the model must be
    the same on every rank of the axis); returns the model, marked with
    ``model.tp_axis``. Build its optimizer afterwards."""
    specs = tensor_parallel_specs(model, mesh, axis=axis, min_width=min_width)
    size, r, group = axis_size(mesh, axis), mesh.get_local_rank(axis), mesh.get_group(axis)

    def block(n):
        return slice(r * n // size, (r + 1) * n // size)

    for prefix, parent in list(model.named_modules()):
        names = dict(parent.named_children())

        def spec(child):
            return specs.get(f"{prefix}.{child}.weight" if prefix else f"{child}.weight")

        for child, sub in list(names.items()):
            m = _LAYER_RE.match(child)
            if m is None or m.group(1) == "bn" or not isinstance(sub, Linear):
                continue
            i, kind = int(m.group(2)), m.group(1)
            if spec(child) == (None, axis):
                setattr(parent, child, RowParallelLinear(sub, block(sub.in_features), group))
            elif spec(child) == (axis, None):
                cols = block(sub.out_features)
                paired = spec(f"{kind}_{i + 1}") == (None, axis)            # a row layer follows
                bn = names.get(f"bn_{i}")
                setattr(parent, child, ColumnParallelLinear(sub, cols, group, gather=not paired and bn is None))
                if bn is not None:
                    setattr(parent, f"bn_{i}", ShardedBatchNorm(bn, cols, group, gather=not paired))
                drop = names.get(f"drop_{i}")
                if drop is not None and paired:
                    setattr(parent, f"drop_{i}", ShardedDropout(drop, cols))
    model.tp_axis = axis
    return model

