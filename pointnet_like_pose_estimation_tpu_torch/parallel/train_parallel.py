"""Data-parallel training, and data x tensor parallel (counterpart of
``parallel/train_parallel.py`` of the JAX package).

Each rank runs the single-device step (``train.steps.make_train_step``) on
its block of the batch's rows, with the collectives placed by hand, as the
JAX package's ``shard_map`` step places its ``pmean``s:

- BatchNorm takes its statistics over the whole batch: the forward runs
  under ``bn_sync`` of the ``data`` group (``nn/bn_context.py``);
- the gradients are averaged over ``data`` by an explicit, bucketed
  all-reduce of every ``.grad``, after the step has given each parameter
  that the loss does not reach a zero gradient. Each parameter then has a
  gradient on every rank, so no reduction waits for a hook that never fires
  (what DDP's ``find_unused_parameters`` is for), and the bytes are easy to
  count: one float a parameter, the JAX package's ``pmean(grads)``;
- loss and metric come back as their means over ``data``, JAX's
  ``pmean(metrics)``.

Each rank draws its augmentation and dropout from a generator of its own,
seeded from the state's generator and its data rank (JAX's ``fold_in(key,
axis_index)``): the state's generator moves alike on every rank, and the
ranks' draws differ. ``draws=`` still takes draws made elsewhere.

With ``tp_axis`` the model has been sharded over that mesh axis by
``shard_state_tp`` before its optimizer was built; the step is the same, its
tensor-parallel layers issue their own collectives, and the ``data`` group
is the ranks that hold the same shards.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from pointnet_like_pose_estimation_tpu_torch.models import ModelSpec
from pointnet_like_pose_estimation_tpu_torch.nn.bn_context import bn_sync
from pointnet_like_pose_estimation_tpu_torch.parallel import collectives
from pointnet_like_pose_estimation_tpu_torch.parallel.mesh import axis_size
from pointnet_like_pose_estimation_tpu_torch.train.config import TrainConfig
from pointnet_like_pose_estimation_tpu_torch.train.steps import draw_step, make_train_step

# gradients are all-reduced in buckets of about this many bytes
BUCKET_BYTES = 25 * 2**20


def _average(grads: list[torch.Tensor], group, size: int) -> None:
    """Replace every gradient by its mean over ``group``, in buckets of
    ``BUCKET_BYTES`` of one dtype, one all-reduce a bucket."""
    bucket: list[torch.Tensor] = []

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        collectives.all_reduce_(flat, group, "gradients").div_(size)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))
        bucket.clear()

    nbytes = 0
    for g in grads:
        if bucket and (g.dtype != bucket[0].dtype or nbytes >= BUCKET_BYTES):
            flush()
            nbytes = 0
        bucket.append(g)
        nbytes += g.numel() * g.element_size()
    if bucket:
        flush()


def rank_generator(gen: torch.Generator, rank: int) -> torch.Generator:
    """A generator for one step of the rank ``rank``: seeded from one draw
    of ``gen`` (which every rank makes alike) plus the rank."""
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
    return torch.Generator(device=gen.device).manual_seed(seed + rank)


def make_parallel_train_step(spec: ModelSpec, cfg: TrainConfig, mesh: DeviceMesh, *,
                             tp_axis: str | None = None, model: nn.Module | None = None) -> Callable:
    """``step(model, optimizer, batch, gen=None, *, draws=None) -> {"loss",
    "metric"}``: the data-parallel train step over ``mesh``'s ``data`` axis
    on this rank's rows of the batch (``shard_batch``), the loss and metric
    being the means over the whole batch. With ``tp_axis``, ``model`` is the
    model that ``shard_state_tp`` sharded over that axis."""
    if tp_axis is not None and getattr(model, "tp_axis", None) != tp_axis:
        raise ValueError(f"tp_axis={tp_axis!r} requires the model sharded over it by shard_state_tp")
    group, size, rank = mesh.get_group("data"), axis_size(mesh, "data"), mesh.get_local_rank("data")
    base = make_train_step(spec, cfg, reduce_grads=lambda grads: _average(grads, group, size))

    def step(model: nn.Module, optimizer: torch.optim.Optimizer, batch: dict,
             gen: torch.Generator | None = None, *, draws: dict | None = None) -> dict:
        if draws is None:
            draws = draw_step(cfg, model, batch, rank_generator(gen, rank))
        with bn_sync(group):
            out = base(model, optimizer, batch, draws=draws)
        both = torch.stack([out["loss"], out["metric"].to(out["loss"].dtype)])
        both = collectives.all_reduce_(both, group, "metrics") / size
        return {"loss": both[0], "metric": both[1]}

    return step
