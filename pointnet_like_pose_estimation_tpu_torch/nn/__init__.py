"""Layers of the port."""

from pointnet_like_pose_estimation_tpu_torch.nn.layers import BatchNormF32, DenseHead, PointwiseMLP
from pointnet_like_pose_estimation_tpu_torch.nn.set_abstraction import SetAbstraction, SetAbstractionMSG

__all__ = ["BatchNormF32", "DenseHead", "PointwiseMLP", "SetAbstraction", "SetAbstractionMSG"]
