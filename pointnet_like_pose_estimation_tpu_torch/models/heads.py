"""Pose heads: rotation, sign, translation, width (counterparts of
``models/heads.py`` of the JAX package): the vanilla PointNet template, the
PointNet++ SSG and MSG templates and the configurable ``GenericPoseHead``.

The input is the spliced cloud ``[B, N, 3 + num_classes]``. The SSG and MSG
backbones carry all its channels through the set-abstraction hierarchy as
coordinates, as the JAX package does: FPS and the ball query run over
``3 + num_classes`` channels. The port's layers take their input widths
explicitly, so every head takes ``in_channels``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.nn import (
    BatchNormF32,
    DenseHead,
    Linear,
    PointwiseMLP,
    SetAbstraction,
    SetAbstractionMSG,
    TNet,
    apply_transform,
)


class MeanMLP(nn.Module):
    """3 -> 6 -> 3 residual on the cloud centroid."""

    def __init__(self):
        super().__init__()
        self.fc1 = Linear(3, 6)
        self.bn1 = BatchNormF32(6)
        self.fc2 = Linear(6, 3)

    def forward(self, mean: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.bn1(self.fc1(mean))))


def _sign_out(x: torch.Tensor):
    """Sigmoid probability and hard sign (0 exactly at 0.5, as jnp.sign)."""
    prob = torch.sigmoid(x.float())
    return prob, torch.sign(prob - 0.5)


def _finish(head: nn.Module, out: torch.Tensor, mean: torch.Tensor | None):
    """The mean residual and the sign output that the three head templates share."""
    if head.mean_residual:
        out = out + head.mean_mlp(mean)
    if head.sigmoid_sign:
        return _sign_out(out)
    return out


class VanillaHead(nn.Module):
    """Shared-MLP tower, global max, FC head (the rotation.py template).

    ``sigmoid_sign`` returns (probability, hard sign); ``mean_residual``
    adds ``MeanMLP(mean)`` to the output, and the caller passes ``mean``.
    ``compat_dead_tnet`` holds (and ignores) a TNet after the second layer:
    its parameters exist for parity with the reference and its output is
    never used. In eval the forward skips it; in train mode it runs it,
    without a graph, for the BatchNorm statistics it updates, as the JAX
    head does.
    """

    def __init__(self, in_channels: int, out_dim: int = 3,
                 mlp: Sequence[int] = (64, 64, 64, 128, 1024),
                 fc: Sequence[int] = (512, 256),
                 sigmoid_sign: bool = False, mean_residual: bool = False,
                 compat_dead_tnet: bool = False):
        super().__init__()
        self.sigmoid_sign = sigmoid_sign
        self.mean_residual = mean_residual
        self.mlp_pre = PointwiseMLP(in_channels, mlp[:2])
        if compat_dead_tnet:
            self.dead_tnet = TNet(mlp[1])
        self.mlp_post = PointwiseMLP(mlp[1], mlp[2:])
        self.head = DenseHead(mlp[-1], list(fc) + [out_dim], style="pose")
        if mean_residual:
            self.mean_mlp = MeanMLP()

    def forward(self, points: torch.Tensor, mean: torch.Tensor | None = None):
        x = self.mlp_pre(points)
        if self.training and hasattr(self, "dead_tnet"):
            with torch.no_grad():
                self.dead_tnet(x)
        return _finish(self, self.head(self.mlp_post.forward_max(x)), mean)


class SSGHead(nn.Module):
    """PointNet++ SSG backbone (2 or 3 levels) and an FC head.

    All ``in_channels`` of the spliced cloud are coordinates: level 1 groups
    ``in_channels`` centred channels, level 2 those plus 128 features, the
    global level those plus the features of the level below.
    """

    def __init__(self, in_channels: int, out_dim: int = 3, levels: int = 3,
                 sigmoid_sign: bool = False, mean_residual: bool = False):
        super().__init__()
        if levels not in (2, 3):
            raise ValueError(f"SSGHead: levels must be 2 or 3, got {levels}")
        self.levels = levels
        self.sigmoid_sign = sigmoid_sign
        self.mean_residual = mean_residual
        self.sa1 = SetAbstraction(512, 32, 0.2, in_channels, [64, 64, 128])
        if levels == 3:
            self.sa2 = SetAbstraction(128, 64, 0.4, in_channels + 128, [128, 128, 256])
        self.sa_global = SetAbstraction(None, None, None, in_channels + (256 if levels == 3 else 128),
                                        [256, 512, 1024], group_all=True)
        self.head = DenseHead(1024, [512, 256, out_dim], style="cls_v2")
        if mean_residual:
            self.mean_mlp = MeanMLP()

    def forward(self, points: torch.Tensor, mean: torch.Tensor | None = None):
        p, f = self.sa1(points, None)
        if self.levels == 3:
            p, f = self.sa2(p, f)
        _, f = self.sa_global(p, f)
        return _finish(self, self.head(f.reshape(f.shape[0], -1)), mean)


class MSGHead(nn.Module):
    """PointNet++ MSG backbone (2 or 3 levels) and an FC head. Level 2
    groups [320 features, ``in_channels`` centred channels], in that order;
    the global level is single-scale, coordinates first."""

    def __init__(self, in_channels: int, out_dim: int = 3, levels: int = 3,
                 sigmoid_sign: bool = False, mean_residual: bool = False):
        super().__init__()
        if levels not in (2, 3):
            raise ValueError(f"MSGHead: levels must be 2 or 3, got {levels}")
        self.levels = levels
        self.sigmoid_sign = sigmoid_sign
        self.mean_residual = mean_residual
        self.sa1 = SetAbstractionMSG(512, [16, 32, 128], [0.1, 0.2, 0.4], in_channels,
                                     [[32, 32, 64], [64, 64, 128], [64, 96, 128]])
        if levels == 3:
            self.sa2 = SetAbstractionMSG(128, [32, 64, 128], [0.2, 0.4, 0.8], 320 + in_channels,
                                         [[64, 64, 128], [128, 128, 256], [128, 128, 256]])
        self.sa_global = SetAbstraction(None, None, None, in_channels + (640 if levels == 3 else 320),
                                        [256, 512, 1024], group_all=True)
        self.head = DenseHead(1024, [512, 256, out_dim], style="cls_v2")
        if mean_residual:
            self.mean_mlp = MeanMLP()

    def forward(self, points: torch.Tensor, mean: torch.Tensor | None = None):
        p, f = self.sa1(points, None)
        if self.levels == 3:
            p, f = self.sa2(p, f)
        _, f = self.sa_global(p, f)
        return _finish(self, self.head(f.reshape(f.shape[0], -1)), mean)


class GenericPoseHead(nn.Module):
    """The configurable vanilla head: an optional TNet(3) on the first three
    channels, an optional TNet on the features after the second layer (this
    one is multiplied in), a mean-residual branch, and a classify branch
    that returns ``(log_probs, (-1)**choice, choice)``."""

    def __init__(self, in_channels: int, out_dim: int = 3,
                 mlp: Sequence[int] = (64, 64, 64, 128, 1024),
                 fc: Sequence[int] = (512, 256),
                 use_input_transform: bool = False, use_feature_transform: bool = False,
                 mean_residual: bool = False, classify: bool = False):
        super().__init__()
        self.mean_residual = mean_residual
        self.classify = classify
        if use_input_transform:
            self.tnet_input = TNet(3)
        self.mlp_pre = PointwiseMLP(in_channels, mlp[:2])
        if use_feature_transform:
            self.tnet_feature = TNet(mlp[1])
        self.mlp_post = PointwiseMLP(mlp[1], mlp[2:])
        self.head = DenseHead(mlp[-1], list(fc) + [out_dim], style="pose")
        if mean_residual:
            self.mean_mlp = MeanMLP()

    def forward(self, points: torch.Tensor, mean: torch.Tensor | None = None):
        x = points
        if hasattr(self, "tnet_input"):
            geo = apply_transform(x[..., :3], self.tnet_input(x[..., :3]))
            x = torch.cat([geo, x[..., 3:]], dim=-1) if x.shape[-1] > 3 else geo
        x = self.mlp_pre(x)
        if hasattr(self, "tnet_feature"):
            x = apply_transform(x, self.tnet_feature(x))
        out = self.head(self.mlp_post.forward_max(x))
        if self.mean_residual:
            return out + self.mean_mlp(mean)
        if self.classify:
            log_probs = torch.log_softmax(out.float(), dim=-1)
            choice = torch.argmax(log_probs, dim=-1)
            return log_probs, 1 - 2 * (choice % 2), choice
        return out
