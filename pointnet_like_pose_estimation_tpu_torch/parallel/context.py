"""The point-sharding context (counterpart of ``parallel/context.py`` of the
JAX package): with it active, ``ops.sample_and_group`` and the MSG layer's
grouping run the distributed implementations of ``parallel.sharded_ops``
over the mesh's ``axis``, where the axis has more than one rank, the
cloud's N divides by it, and the caller gave no ``fps_idx`` and asked for no
``return_fps``.

PyTorch runs eagerly, so the context is read when an op is CALLED (the JAX
package reads it while tracing): wrap the forward itself.

    with point_sharding(mesh, axis="points") as ctx:
        log_probs = model(points)[0]        # every rank, the same points
    assert ctx.dispatch_count == 2

``dispatch_count`` counts the calls that went through ``sharded_ops``.
"""

from __future__ import annotations

import contextlib
import dataclasses

from torch.distributed.device_mesh import DeviceMesh

# found next to point_sharding, as in the JAX package
from pointnet_like_pose_estimation_tpu_torch.nn.bn_context import bn_group, bn_sync  # noqa: F401


@dataclasses.dataclass
class PointShardingContext:
    mesh: DeviceMesh
    axis: str = "points"
    batch_axis: str | None = None
    dispatch_count: int = 0

    def dispatches(self, num_points: int) -> bool:
        """Whether a grouping of clouds of ``num_points`` points goes to
        ``sharded_ops``: the axis has more than one rank and divides N."""
        size = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))[self.axis]
        return size > 1 and num_points % size == 0


_CURRENT: list[PointShardingContext] = []


@contextlib.contextmanager
def point_sharding(mesh: DeviceMesh, axis: str = "points", batch_axis: str | None = None):
    """Route the groupings called inside the block through ``sharded_ops``."""
    ctx = PointShardingContext(mesh, axis, batch_axis)
    _CURRENT.append(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.remove(ctx)


def current_point_sharding() -> PointShardingContext | None:
    return _CURRENT[-1] if _CURRENT else None
