"""Data helpers of the port."""

from pointnet_like_pose_estimation_tpu_torch.data.dataset import (
    PoseDataset,
    build_dataset,
    iter_batches,
    load_dataset,
    load_reference_layout,
)

__all__ = ["PoseDataset", "build_dataset", "iter_batches", "load_dataset", "load_reference_layout"]
