"""Every collective of the parallel layer and of the synced BatchNorm,
counted.

The JAX package reads a step's collective traffic out of the compiled HLO
(``utils/hlo.py``). The port compiles nothing, so it counts what it issues:
each function here runs one ``torch.distributed`` collective and adds it to
``TRAFFIC`` under the site that asked for it (``"gradients"``,
``"batch_norm"``, ``"fps"``...) and under JAX's op name, with JAX's
definition of bytes: the result bytes each participant receives.
``utils.collectives.collective_traffic`` reads the record.

A gather is an all-reduce of a zeroed ``[d, ...]`` slot buffer that each
rank fills at its own slot (``gather_slots``), as the JAX package's owner
gathers are psums: gloo takes only all-reduce and broadcast for CUDA
tensors, so one code path runs on NCCL, on gloo with CUDA tensors and on
gloo on the CPU. A sum of one value and zeros is exact.

The differentiable forms follow Megatron's regions: ``all_reduce`` sums in
both directions (a sum each rank reads, whose cotangents every rank
holds a part of), ``reduce_from`` sums forward and passes the cotangent
through (a partial product whose result every rank then uses alike),
``copy_to`` passes forward and sums the cotangent, ``gather_last`` gathers
the last axis forward and keeps its own block of the cotangent.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# site -> JAX op name -> {"count", "bytes"}
TRAFFIC: dict[str, dict[str, dict[str, int]]] = {}


def _record(site: str, op: str, t: torch.Tensor) -> None:
    rec = TRAFFIC.setdefault(site, {}).setdefault(op, {"count": 0, "bytes": 0})
    rec["count"] += 1
    rec["bytes"] += t.numel() * t.element_size()


def reset_traffic() -> None:
    TRAFFIC.clear()


def all_reduce_(t: torch.Tensor, group, site: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` (no gradient)."""
    dist.all_reduce(t, op=op, group=group)
    _record(site, "all-reduce", t)
    return t


def broadcast_(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """In-place broadcast of ``t`` from the group's first rank (no gradient)."""
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    _record(site, "broadcast", t)
    return t


def gather_slots(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """``[d, *t.shape]``: every rank's ``t`` at its group rank, through one
    all-reduce of a zeroed slot buffer (no gradient)."""
    buf = t.new_zeros((dist.get_world_size(group), *t.shape))
    buf[dist.get_rank(group)] = t.detach()
    return all_reduce_(buf, group, site)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, site):
        ctx.group, ctx.site = group, site
        return all_reduce_(t.clone(), group, site)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group, ctx.site), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, site):
        return all_reduce_(t.clone(), group, site)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, site):
        ctx.group, ctx.site = group, site
        return t

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group, ctx.site), None, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, site):
        ctx.rank, ctx.width = dist.get_rank(group), t.shape[-1]
        slots = gather_slots(t, group, site)                       # [d, ..., w]
        return torch.cat(slots.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None, None


def all_reduce(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """Sum over the group; the backward sums the cotangent over it too."""
    return _AllReduce.apply(t, group, site)


def reduce_from(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """Sum over the group; the backward passes the cotangent through."""
    return _ReduceFrom.apply(t, group, site)


def copy_to(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """``t`` itself; the backward sums the cotangent over the group."""
    return _CopyTo.apply(t, group, site)


def gather_last(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """The ranks' blocks of the last axis side by side, in group-rank order;
    the backward keeps this rank's block of the cotangent."""
    return _GatherLast.apply(t, group, site)
