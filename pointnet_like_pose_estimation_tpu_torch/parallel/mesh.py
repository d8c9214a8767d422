"""Process groups, the device mesh and batch sharding (counterpart of
``parallel/mesh.py`` of the JAX package).

One process a device: a rank runs on ``cuda:{LOCAL_RANK}`` (or the CPU,
when the caller asks for it) and the ranks form a
``torch.distributed.device_mesh.DeviceMesh`` with named axes, ``data`` for
the cloud batch, ``points`` for the point axis of large clouds
(``parallel/sharded_ops.py``) and ``model`` for tensor parallelism
(``parallel/tensor_parallel.py``). The backend follows the device the
caller asks for, NCCL for the card and gloo for the CPU; a caller that
wants gloo with CUDA tensors (two ranks sharing one card) forms its own
process group before ``make_mesh``. Ranks map onto the mesh in row-major
order, as the JAX package lays ``jax.devices()`` onto its mesh.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from pointnet_like_pose_estimation_tpu_torch.parallel import collectives
from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device


def init_process_group(device="cuda", *, multihost: bool = False) -> torch.device:
    """Join (or form) the default process group and return this rank's
    device, the counterpart of ``jax.distributed.initialize``.

    Under ``torchrun`` (``WORLD_SIZE`` in the environment) or with
    ``multihost``, the group comes from the ``env://`` variables, and a
    missing one raises; otherwise this process is a world of one on
    ``device``. A CUDA rank runs on ``cuda:{LOCAL_RANK}`` where the launcher
    sets it, and the group on NCCL; a CPU rank on gloo. A group formed
    before the call is kept."""
    device = torch.device(device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    device = resolve_device(device, "init_process_group")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if multihost or "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return device


def make_mesh(axis_sizes: dict[str, int] | None = None, *, device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the ranks of the default process group; by default all
    of them on one ``data`` axis. A mesh smaller than the world takes the
    first ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call parallel.init_process_group first")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"data": world}
    n = math.prod(axis_sizes.values())
    if n > world:
        raise ValueError(f"mesh needs {n} devices, have {world}")
    return init_device_mesh(device_type, tuple(axis_sizes.values()), mesh_dim_names=tuple(axis_sizes))


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{axis: size}``, JAX's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh_shape(mesh)[axis]


def batch_sharding(mesh: DeviceMesh, batch_size: int) -> slice:
    """This rank's contiguous block of a batch's rows over ``data`` (JAX's
    ``P("data")``; the ranks of other axes hold the same rows)."""
    size = axis_size(mesh, "data")
    if batch_size % size:
        raise ValueError(f"batch of {batch_size} not divisible by the data axis {size}")
    block, r = batch_size // size, mesh.get_local_rank("data")
    return slice(r * block, (r + 1) * block)


def shard_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """This rank's contiguous block of rows of every array of ``batch``."""
    rows = batch_sharding(mesh, len(next(iter(batch.values()))))
    return {k: v[rows] for k, v in batch.items()}


def replicate(obj, mesh: DeviceMesh):
    """Broadcast a module's parameters and buffers, or a list of tensors,
    in place, from the mesh's first rank to all of its ranks (one broadcast
    a tensor along each axis); returns ``obj``."""
    tensors = [*obj.parameters(), *obj.buffers()] if isinstance(obj, torch.nn.Module) else list(obj)
    with torch.no_grad():
        for axis in mesh.mesh_dim_names:
            group = mesh.get_group(axis)
            for t in tensors:
                collectives.broadcast_(t.data, group, "replicate")
    return obj
