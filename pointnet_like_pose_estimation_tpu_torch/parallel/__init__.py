"""Scaling over process groups (counterpart of ``parallel/`` of the JAX
package): the device mesh, data-parallel training with synced BatchNorm,
point-sharded FPS and grouping, tensor parallelism and the head fan-out.
Every collective goes through ``parallel/collectives.py``, which counts it
for ``utils.collectives.collective_traffic``."""

from pointnet_like_pose_estimation_tpu_torch.parallel.mesh import (
    axis_size,
    batch_sharding,
    init_process_group,
    make_mesh,
    mesh_shape,
    replicate,
    shard_batch,
)
from pointnet_like_pose_estimation_tpu_torch.parallel.context import (
    bn_sync,
    current_point_sharding,
    point_sharding,
)
from pointnet_like_pose_estimation_tpu_torch.parallel.sharded_ops import (
    sharded_farthest_point_sample,
    sharded_sample_and_group,
    sharded_sample_and_group_multi,
)
from pointnet_like_pose_estimation_tpu_torch.parallel.multihead import MultiHeadParallel
from pointnet_like_pose_estimation_tpu_torch.parallel.tensor_parallel import (
    count_sharded,
    shard_state_tp,
    tensor_parallel_shardings,
    tensor_parallel_specs,
)
from pointnet_like_pose_estimation_tpu_torch.parallel.train_parallel import make_parallel_train_step

__all__ = [
    "MultiHeadParallel",
    "axis_size",
    "batch_sharding",
    "bn_sync",
    "count_sharded",
    "current_point_sharding",
    "init_process_group",
    "make_mesh",
    "mesh_shape",
    "point_sharding",
    "replicate",
    "shard_batch",
    "shard_state_tp",
    "make_parallel_train_step",
    "sharded_farthest_point_sample",
    "sharded_sample_and_group",
    "sharded_sample_and_group_multi",
    "tensor_parallel_shardings",
    "tensor_parallel_specs",
]
