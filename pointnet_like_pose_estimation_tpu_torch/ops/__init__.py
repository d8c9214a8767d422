"""Point-cloud ops of the port (channels-last, as in the JAX package)."""

from pointnet_like_pose_estimation_tpu_torch.ops.geometry import (
    euler_rotation_matrix,
    index_points,
    normalize_cloud,
    rotate_euler,
    square_distance,
)
from pointnet_like_pose_estimation_tpu_torch.ops.sampling import (
    farthest_point_sample,
    random_sample,
)
from pointnet_like_pose_estimation_tpu_torch.ops.grouping import (
    query_ball_point,
    sample_and_group,
    sample_and_group_all,
)

__all__ = [
    "euler_rotation_matrix",
    "index_points",
    "normalize_cloud",
    "rotate_euler",
    "square_distance",
    "farthest_point_sample",
    "random_sample",
    "query_ball_point",
    "sample_and_group",
    "sample_and_group_all",
]
