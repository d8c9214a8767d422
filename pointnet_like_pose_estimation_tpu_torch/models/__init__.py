"""Model registry of the port: every name of the JAX package's registry
(``models/__init__.py`` there) resolves to a ``ModelSpec``, and so does
the port's own ``point_transformer_cls``."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.models import losses
from pointnet_like_pose_estimation_tpu_torch.models.classifiers import (
    PointNet2ClsMSG,
    PointNet2ClsSSG,
    PointNetCls,
    PointTransformerCls,
)
from pointnet_like_pose_estimation_tpu_torch.models.heads import (
    GenericPoseHead,
    MeanMLP,
    MSGHead,
    SSGHead,
    VanillaHead,
)
from pointnet_like_pose_estimation_tpu_torch.nn import TNet, set_compute_dtype

__all__ = [
    "ModelSpec",
    "MODEL_REGISTRY",
    "get_model_spec",
    "build_model",
    "init_like_flax",
    "PointNetCls",
    "PointNet2ClsSSG",
    "PointNet2ClsMSG",
    "PointTransformerCls",
    "VanillaHead",
    "SSGHead",
    "MSGHead",
    "GenericPoseHead",
    "MeanMLP",
    "losses",
]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What the evaluation and training loops need to run one model.

    Attributes:
      name: registry key.
      make: ``make(num_classes) -> nn.Module``; the pose heads take the
        spliced ``3 + num_classes`` channels.
      task: 'classify' | 'rotation' | 'sign' | 'translation' | 'width'.
      input_kind: 'xyz' (the cloud), 'spliced' (one-hot channels appended)
        or 'spliced_mean' (spliced cloud and centroid vector).
      loss: ``loss(outputs, target, **cfg) -> scalar``.
      metric: ``metric(outputs, target) -> scalar``, the task's headline.
    """

    name: str
    make: Callable[[int], nn.Module]
    task: str
    input_kind: str
    loss: Callable[..., Any]
    metric: Callable[..., Any]


def _cls_loss(outputs, target, **kw):
    log_probs, aux, _ = outputs
    trans = aux if aux is not None and aux.dim() == 3 else None
    return losses.classification_loss(log_probs, target, trans, **kw)


def _cls_metric(outputs, target):
    return losses.accuracy(outputs[0], target)


def _reg_loss(outputs, target, **kw):
    return losses.regression_loss(outputs, target, **kw)


def _reg_metric(outputs, target):
    return losses.mean_abs_error(outputs, target)


def _tran_metric(outputs, target):
    return losses.mean_abs_error(outputs, target, scale=100.0)  # cm


def _sign_loss(outputs, target, **kw):
    return losses.sign_loss(outputs[0], target, **kw)


def _sign_metric(outputs, target):
    return losses.sign_accuracy(outputs[1], target)


_CLS = ("classify", "xyz", _cls_loss, _cls_metric)
_ROT = ("rotation", "spliced", _reg_loss, _reg_metric)
_SIGN = ("sign", "spliced", _sign_loss, _sign_metric)
_TRAN = ("translation", "spliced_mean", _reg_loss, _tran_metric)

_SPECS = [
    ModelSpec("pointnet_cls", PointNetCls, *_CLS),
    ModelSpec("pointnet2_cls_ssg", PointNet2ClsSSG, *_CLS),
    ModelSpec("pointnet2_cls_msg", PointNet2ClsMSG, *_CLS),
    ModelSpec("rotation", lambda nc: VanillaHead(3 + nc, out_dim=3), *_ROT),
    ModelSpec("rotation_ssg", lambda nc: SSGHead(3 + nc, out_dim=3, levels=3), *_ROT),
    ModelSpec("rotation_msg", lambda nc: MSGHead(3 + nc, out_dim=3, levels=3), *_ROT),
    ModelSpec("sign", lambda nc: VanillaHead(3 + nc, out_dim=1, sigmoid_sign=True), *_SIGN),
    ModelSpec("sign_ssg", lambda nc: SSGHead(3 + nc, out_dim=1, levels=2, sigmoid_sign=True), *_SIGN),
    ModelSpec("sign_msg", lambda nc: MSGHead(3 + nc, out_dim=1, levels=2, sigmoid_sign=True), *_SIGN),
    ModelSpec("translation", lambda nc: VanillaHead(3 + nc, out_dim=3, mean_residual=True), *_TRAN),
    # the ablation arm without the mean-MLP residual
    ModelSpec("translation_no_mlp", lambda nc: VanillaHead(3 + nc, out_dim=3),
              "translation", "spliced", _reg_loss, _tran_metric),
    ModelSpec("translation_ssg",
              lambda nc: SSGHead(3 + nc, out_dim=3, levels=2, mean_residual=True), *_TRAN),
    ModelSpec("translation_msg",
              lambda nc: MSGHead(3 + nc, out_dim=3, levels=2, mean_residual=True), *_TRAN),
    ModelSpec("width", lambda nc: VanillaHead(3 + nc, out_dim=1), "width", "spliced",
              _reg_loss, _reg_metric),
    ModelSpec("pose", lambda nc: GenericPoseHead(3 + nc), *_ROT),
    ModelSpec("pose_transform", lambda nc: GenericPoseHead(3 + nc, use_input_transform=True), *_ROT),
    ModelSpec("pose_feat_trans", lambda nc: GenericPoseHead(3 + nc, use_feature_transform=True), *_ROT),
    ModelSpec("pose_mean", lambda nc: GenericPoseHead(3 + nc, mean_residual=True), *_TRAN),
    # takes the spliced cloud like every configuration of the generic head,
    # so it sees its own label, as in the JAX package
    ModelSpec("pose_classify", lambda nc: GenericPoseHead(3 + nc, out_dim=nc, classify=True),
              "classify", "spliced", _cls_loss, _cls_metric),
    # the port's own beyond the JAX package's registry
    ModelSpec("point_transformer_cls", PointTransformerCls, *_CLS),
]

MODEL_REGISTRY = {spec.name: spec for spec in _SPECS}


def get_model_spec(name: str) -> ModelSpec:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def build_model(name: str, num_classes: int = 7, dtype: str = "float32") -> nn.Module:
    """The registry model ``name``, its Linear layers computing in ``dtype``
    (``"float32"`` or ``"bfloat16"``, the JAX package's ``TrainConfig.dtype``;
    BatchNorm stays float32 either way)."""
    return set_compute_dtype(get_model_spec(name).make(num_classes), dtype)


def init_like_flax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``model`` in place as flax initialises the JAX package's
    models, drawing from ``generator`` (on the CPU): every Linear weight
    ``lecun_normal`` (a normal of variance 1/fan_in truncated at two
    standard deviations, its scale corrected for the truncation), every
    bias 0, BatchNorm scale 1 and bias 0 with running mean 0 and variance
    1, and each T-Net's output layer the identity (zero weight, the
    flattened identity as bias). PyTorch's own Linear init is another
    recipe."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
        for m in model.modules():
            if isinstance(m, TNet):
                m.reset_identity()
    return model
