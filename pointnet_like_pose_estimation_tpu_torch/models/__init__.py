"""Model registry of the port: the five models the grasp pipeline builds
and the MSG classifier (``models/__init__.py`` of the JAX package holds the
full set)."""

from __future__ import annotations

from torch import nn

from pointnet_like_pose_estimation_tpu_torch.models.classifiers import PointNet2ClsMSG, PointNet2ClsSSG
from pointnet_like_pose_estimation_tpu_torch.models.heads import MeanMLP, VanillaHead

__all__ = ["MODEL_REGISTRY", "build_model", "PointNet2ClsMSG", "PointNet2ClsSSG", "VanillaHead", "MeanMLP"]

# name -> factory(num_classes); pose heads take the spliced 3 + num_classes channels
MODEL_REGISTRY = {
    "pointnet2_cls_ssg": lambda nc: PointNet2ClsSSG(nc),
    "pointnet2_cls_msg": lambda nc: PointNet2ClsMSG(nc),
    "rotation": lambda nc: VanillaHead(3 + nc, out_dim=3),
    "sign": lambda nc: VanillaHead(3 + nc, out_dim=1, sigmoid_sign=True),
    "translation": lambda nc: VanillaHead(3 + nc, out_dim=3, mean_residual=True),
    "width": lambda nc: VanillaHead(3 + nc, out_dim=1),
}


def build_model(name: str, num_classes: int = 7) -> nn.Module:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](num_classes)
