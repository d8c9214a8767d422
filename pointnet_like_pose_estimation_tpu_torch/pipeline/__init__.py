"""Serving pipeline of the port: depth to cloud, preprocessing, and the
grasp pipeline."""

from pointnet_like_pose_estimation_tpu_torch.pipeline.deproject import CameraIntrinsics, deproject_depth
from pointnet_like_pose_estimation_tpu_torch.pipeline.infer import GraspPipeline, PipelineConfig
from pointnet_like_pose_estimation_tpu_torch.pipeline.preprocess import (
    clean_scene,
    clip_distance,
    cluster_point,
    dbscan,
    ransac_plane,
    remove_plane,
    remove_radius_outlier,
    remove_statistical_outlier,
)

__all__ = [
    "CameraIntrinsics",
    "GraspPipeline",
    "PipelineConfig",
    "clean_scene",
    "clip_distance",
    "cluster_point",
    "dbscan",
    "deproject_depth",
    "ransac_plane",
    "remove_plane",
    "remove_radius_outlier",
    "remove_statistical_outlier",
]
