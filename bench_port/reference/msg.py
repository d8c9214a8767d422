"""PointNet++ MSG in plain PyTorch: the multi-scale set abstraction, the
MSG classifier and the MSG pose heads of a grasp request, and a
``GraspReference`` whose five models are those a configuration names.

PointNet++ MSG: Qi et al. 2017, arXiv:1706.02413; charlesq34/pointnet2
``models/pointnet2_cls_msg.py``. The MSG pose heads: Regen2001/PointNet-Like-
Pose-Estimation ``model/rotation_msg.py`` (three levels), ``sign_msg.py`` and
``translation_msg.py`` (two levels, the translation head with the centroid
MLP residual). Channels-last, as ``reference/models.py``; module names are
the port's, so one ``state_dict`` loads into both. Imports nothing of the
port: each scale's neighbours come from ``geometry.ball_query``, one radius
at a time, where the port runs one multi-scale kernel.

Where this departs from the published description, as the JAX package and
the port do:

- the heads treat all ``3 + num_classes`` channels of the spliced cloud as
  coordinates: FPS and the ball query run over them, and each level groups
  them centred on the centroid (the published heads take the one-hot as
  point features);
- a level groups ``[features, centred coordinates]``, in that order, and
  the global level ``[coordinates, features]``;
- eval-mode BatchNorm with running statistics, ``eps`` 1e-5; dropout off.
"""

from __future__ import annotations

import torch
from torch import nn

from reference import geometry as G
from reference import models
from reference import pipeline
from reference.models import DTYPES, DenseHead, Linear, MeanMLP, PointwiseMLP, SetAbstraction

# (centroids, neighbours a scale, radii, widths a scale) of the two MSG levels
SA1 = (512, (16, 32, 128), (0.1, 0.2, 0.4), ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
SA2 = (128, (32, 64, 128), (0.2, 0.4, 0.8), ((64, 64, 128), (128, 128, 256), (128, 128, 256)))
GLOBAL = (256, 512, 1024)
NAMES = ("pointnet2_cls_msg", "rotation_msg", "sign_msg", "translation_msg")


class SetAbstractionMSG(nn.Module):
    """One FPS, then for each scale a ball query, the grouped ``[features,
    centred coordinates]``, a shared MLP and a max over the group; the
    scales' features concatenated."""

    def __init__(self, level, in_channels: int):
        super().__init__()
        self.num_centroids, self.ks, self.radii, mlps = level
        for i, widths in enumerate(mlps):
            self.add_module(f"mlp_{i}", PointwiseMLP(in_channels, widths))

    def forward(self, points, features):
        centroids = G.index_points(points, G.fps(points, self.num_centroids))
        outs = []
        for i, (radius, k) in enumerate(zip(self.radii, self.ks)):
            idx = G.ball_query(points, centroids, radius, k)
            grouped = G.index_points(points, idx) - centroids[:, :, None, :]
            if features is not None:
                grouped = torch.cat([G.index_points(features, idx), grouped], dim=-1)
            outs.append(getattr(self, f"mlp_{i}")(grouped).amax(dim=-2))
        return centroids, torch.cat(outs, dim=-1)


def _widths(level) -> int:
    return sum(w[-1] for w in level[3])


class PointNet2ClsMSG(nn.Module):
    """SA-MSG 1, SA-MSG 2, the global level, FC 512-256-C:
    ``(log_probs, global feature, pred)``."""

    def __init__(self, num_classes: int = 7):
        super().__init__()
        self.sa1 = SetAbstractionMSG(SA1, 3)
        self.sa2 = SetAbstractionMSG(SA2, _widths(SA1) + 3)
        self.sa3 = SetAbstraction(None, None, None, _widths(SA2) + 3, list(GLOBAL), group_all=True)
        self.head = DenseHead(1024, [512, 256, num_classes], style="cls_v2")

    def forward(self, points):
        p, f = self.sa1(points, None)
        p, f = self.sa2(p, f)
        _, f = self.sa3(p, f)
        g = f.reshape(f.shape[0], -1)
        log_probs = torch.log_softmax(self.head(g).float(), dim=-1)
        return log_probs, g, torch.argmax(log_probs, dim=-1)


class MSGHead(nn.Module):
    """SA-MSG 1, SA-MSG 2 where ``levels`` is 3, the global level and FC
    512-256-out on the spliced cloud; optional centroid residual and sigmoid
    sign, as ``reference.models.VanillaHead``."""

    def __init__(self, in_channels: int, out_dim: int, levels: int, sigmoid_sign=False, mean_residual=False):
        super().__init__()
        self.levels, self.sigmoid_sign, self.mean_residual = levels, sigmoid_sign, mean_residual
        self.sa1 = SetAbstractionMSG(SA1, in_channels)
        below = _widths(SA1)
        if levels == 3:
            self.sa2 = SetAbstractionMSG(SA2, below + in_channels)
            below = _widths(SA2)
        self.sa_global = SetAbstraction(None, None, None, below + in_channels, list(GLOBAL), group_all=True)
        self.head = DenseHead(1024, [512, 256, out_dim], style="cls_v2")
        if mean_residual:
            self.mean_mlp = MeanMLP()

    def forward(self, points, mean=None):
        p, f = self.sa1(points, None)
        if self.levels == 3:
            p, f = self.sa2(p, f)
        _, f = self.sa_global(p, f)
        out = self.head(f.reshape(f.shape[0], -1))
        if self.mean_residual:
            out = out + self.mean_mlp(mean)
        if self.sigmoid_sign:
            prob = torch.sigmoid(out.float())
            return prob, torch.sign(prob - 0.5)
        return out


def build(name: str, num_classes: int = 7, dtype: str = "float32") -> nn.Module:
    """A model of a grasp request by the port's registry name: the four MSG
    models here, the others from ``reference.models.build``."""
    if name not in NAMES:
        return models.build(name, num_classes, dtype)
    c = 3 + num_classes
    model = {
        "pointnet2_cls_msg": lambda: PointNet2ClsMSG(num_classes),
        "rotation_msg": lambda: MSGHead(c, 3, levels=3),
        "sign_msg": lambda: MSGHead(c, 1, levels=2, sigmoid_sign=True),
        "translation_msg": lambda: MSGHead(c, 3, levels=2, mean_residual=True),
    }[name]()
    for m in model.modules():
        if isinstance(m, Linear):
            m.compute_dtype = DTYPES[dtype]
    return model


def model_names(config: dict) -> dict:
    """The registry name of each model key of a grasp configuration's
    ``pipeline``, the port's defaults where it names none."""
    p = config["pipeline"]
    return {key: p.get(key, default) for key, default in pipeline.KEYS.items()}


class GraspReference(pipeline.GraspReference):
    """``reference.pipeline.GraspReference`` on the models ``names`` gives
    (a registry name per key of ``pipeline.KEYS``), each Linear layer in
    ``dtype``, every matrix product without TF32."""

    def __init__(self, states: dict, names: dict, num_points: int, num_classes: int, dtype: str, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.num_points, self.num_classes, self.device = num_points, num_classes, torch.device(device)
        self.models = {}
        for key in pipeline.KEYS:
            m = build(names[key], num_classes, dtype)
            m.load_state_dict(states[key], strict=True)
            self.models[key] = m.to(self.device).eval()

