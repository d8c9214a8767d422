"""The grasp request's five models and the classifier's train-mode layers
in plain PyTorch: frozen copies of the port's plain code at commit aa745b2
(``nn/layers.py``, ``nn/set_abstraction.py``, ``models/classifiers.py``,
``models/heads.py``), without its kernels, programs or parallel paths.

PointNet++ SSG (Qi et al. 2017, arXiv:1706.02413; charlesq34/pointnet2
``models/pointnet2_cls_ssg.py``) and the PointNet (arXiv:1612.00593) pose
heads of Regen2001/PointNet-Like-Pose-Estimation, channels-last: a
``Conv1d/Conv2d(k=1)`` stack is a ``Linear`` over the last axis. Module
names are the port's, so one ``state_dict`` loads into both.

``dtype`` is the Linear layers' compute dtype, as the configuration
states it: ``"float32"``, or ``"bfloat16"`` (input, weight and bias cast,
product and bias add each rounded, as the port rounds them).
BatchNorm, ReLU, max and dropout stay float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from reference import geometry as G

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class Linear(nn.Linear):
    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class BatchNormF32(nn.BatchNorm1d):
    """BatchNorm over every axis but the last, float32; in train mode the
    biased batch variance normalises and updates the running variance
    (flax's rule), momentum 0.1, eps 1e-5."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        shape = x.shape
        x = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(-1, shape[-1])
        if not self.training:
            return super().forward(x).reshape(shape)
        var, mean = torch.var_mean(x, dim=0, unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked += 1
        return ((x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias).reshape(shape)


class Dropout(nn.Module):
    """Keep a unit where its supplied uniform is at least ``rate``, scaled
    by ``1 / (1 - rate)``."""

    def __init__(self, rate: float, features: int):
        super().__init__()
        self.rate, self.features = rate, features
        self.uniforms = None

    def forward(self, x):
        if not self.training:
            return x
        return torch.where(self.uniforms >= self.rate, x / (1.0 - self.rate), torch.zeros_like(x))


class PointwiseMLP(nn.Module):
    def __init__(self, in_features: int, features):
        super().__init__()
        self.n = len(features)
        for i, width in enumerate(features):
            self.add_module(f"dense_{i}", Linear(in_features, width))
            self.add_module(f"bn_{i}", BatchNormF32(width))
            in_features = width

    def forward(self, x):
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x)))
        return x


class DenseHead(nn.Module):
    """Hidden layers ``cls_v2``: dropout(relu(bn(fc))); ``pose``:
    relu(dropout(bn(fc))); the last layer a plain Linear."""

    def __init__(self, in_features: int, features, style: str):
        super().__init__()
        self.style, self.n = style, len(features)
        for i, width in enumerate(features):
            self.add_module(f"fc_{i}", Linear(in_features, width))
            if i < self.n - 1:
                self.add_module(f"bn_{i}", BatchNormF32(width))
                self.add_module(f"drop_{i}", Dropout(0.4, width))
            in_features = width

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"fc_{i}")(x)
            if i == self.n - 1:
                break
            bn, drop = getattr(self, f"bn_{i}"), getattr(self, f"drop_{i}")
            x = drop(torch.relu(bn(x))) if self.style == "cls_v2" else torch.relu(drop(bn(x)))
        return x


class SetAbstraction(nn.Module):
    def __init__(self, num_centroids, k, radius, in_channels, mlp, group_all=False):
        super().__init__()
        self.num_centroids, self.k, self.radius, self.group_all = num_centroids, k, radius, group_all
        self.mlp = PointwiseMLP(in_channels, mlp)

    def forward(self, points, features):
        if self.group_all:
            centroids, grouped = G.sample_and_group_all(points, features)
        else:
            centroids, grouped = G.sample_and_group(points, features, self.num_centroids, self.k, self.radius)
        return centroids, self.mlp(grouped).amax(dim=-2)


class PointNet2ClsSSG(nn.Module):
    """SA(512, 0.2, 32; 64-64-128), SA(128, 0.4, 64; 128-128-256), global
    SA(256-512-1024), FC 512-256-C: ``(log_probs, global feature, pred)``."""

    def __init__(self, num_classes: int = 7):
        super().__init__()
        self.sa1 = SetAbstraction(512, 32, 0.2, 3, [64, 64, 128])
        self.sa2 = SetAbstraction(128, 64, 0.4, 128 + 3, [128, 128, 256])
        self.sa3 = SetAbstraction(None, None, None, 256 + 3, [256, 512, 1024], group_all=True)
        self.head = DenseHead(1024, [512, 256, num_classes], style="cls_v2")

    def forward(self, points):
        p, f = self.sa1(points, None)
        p, f = self.sa2(p, f)
        _, f = self.sa3(p, f)
        g = f.reshape(f.shape[0], -1)
        log_probs = torch.log_softmax(self.head(g).float(), dim=-1)
        return log_probs, g, torch.argmax(log_probs, dim=-1)


class MeanMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1, self.bn1, self.fc2 = Linear(3, 6), BatchNormF32(6), Linear(6, 3)

    def forward(self, mean):
        return self.fc2(torch.relu(self.bn1(self.fc1(mean))))


class VanillaHead(nn.Module):
    """Shared MLP 64-64-64-128-1024, global max, FC 512-256-out (the
    ``pose`` order); optional sigmoid sign and centroid residual."""

    def __init__(self, in_channels: int, out_dim: int, sigmoid_sign=False, mean_residual=False):
        super().__init__()
        self.sigmoid_sign, self.mean_residual = sigmoid_sign, mean_residual
        self.mlp_pre = PointwiseMLP(in_channels, (64, 64))
        self.mlp_post = PointwiseMLP(64, (64, 128, 1024))
        self.head = DenseHead(1024, [512, 256, out_dim], style="pose")
        if mean_residual:
            self.mean_mlp = MeanMLP()

    def forward(self, points, mean=None):
        out = self.head(self.mlp_post(self.mlp_pre(points)).amax(dim=-2))
        if self.mean_residual:
            out = out + self.mean_mlp(mean)
        if self.sigmoid_sign:
            prob = torch.sigmoid(out.float())
            return prob, torch.sign(prob - 0.5)
        return out


def build(name: str, num_classes: int = 7, dtype: str = "float32") -> nn.Module:
    """One of the five models of a grasp request by the port's registry name."""
    c = 3 + num_classes
    makers = {
        "pointnet2_cls_ssg": lambda: PointNet2ClsSSG(num_classes),
        "rotation": lambda: VanillaHead(c, 3),
        "sign": lambda: VanillaHead(c, 1, sigmoid_sign=True),
        "translation": lambda: VanillaHead(c, 3, mean_residual=True),
        "width": lambda: VanillaHead(c, 1),
    }
    model = makers[name]()
    for m in model.modules():
        if isinstance(m, Linear):
            m.compute_dtype = DTYPES[dtype]
    return model


def dropouts(model: nn.Module) -> list[tuple[str, Dropout]]:
    """The dropout sites in module order (the order their draws are made)."""
    return [(name, m) for name, m in model.named_modules() if isinstance(m, Dropout)]
