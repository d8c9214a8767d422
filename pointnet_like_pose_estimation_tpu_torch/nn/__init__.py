"""Layers of the port."""

from pointnet_like_pose_estimation_tpu_torch.nn.layers import (
    BatchNormF32,
    DenseHead,
    Dropout,
    Linear,
    PointwiseMLP,
    pre_bn_biases,
    set_compute_dtype,
)
from pointnet_like_pose_estimation_tpu_torch.nn.set_abstraction import SetAbstraction, SetAbstractionMSG
from pointnet_like_pose_estimation_tpu_torch.nn.tnet import (
    PointNetEncoder,
    TNet,
    apply_transform,
    orthogonality_regularizer,
)

__all__ = [
    "BatchNormF32",
    "DenseHead",
    "Dropout",
    "Linear",
    "PointwiseMLP",
    "SetAbstraction",
    "SetAbstractionMSG",
    "PointNetEncoder",
    "TNet",
    "apply_transform",
    "orthogonality_regularizer",
    "pre_bn_biases",
    "set_compute_dtype",
]
