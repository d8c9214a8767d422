"""Point Transformer's classifier in plain PyTorch, and a
``GraspReference`` whose classifier it is.

Point Transformer: Zhao, Jiang, Jia, Torr, Koltun, ICCV 2021,
arXiv:2012.09164; POSTECH-CVLab/point-transformer
``model/pointtransformer/pointtransformer_seg.py`` (``PointTransformerLayer``,
``PointTransformerBlock``, ``TransitionDown``), the encoder of its
``pointtransformer_seg_repro``: planes 32-64-128-256-512, blocks
2-3-4-6-3 (stage s is its TransitionDown and ``blocks[s] - 1`` blocks),
stride 1-4-4-4-4, nsample 8-16-16-16-16, share_planes 8. The paper's
classifier (Fig. 3): that encoder, a global average pool and an MLP.
Channels-last over a batch of clouds ``[B, N, C]``; module names are the
port's (``models/classifiers.py`` ``PointTransformerCls``), so one
``state_dict`` loads into both. Imports nothing of the port: its kNN is a
brute force of its own, every distance formed and then a stable sort on
(distance, index); FPS is ``geometry.fps``.

Where this departs from the published code:

- a cloud of fewer points than nsample groups all of them: ``min(nsample,
  N)`` neighbours (the published CUDA kNN fills the missing slots its own
  way);
- a stage's kNN is queried once and shared by its blocks (the published
  layer queries again in each block, on the same points: the same
  indices);
- the classification MLP is 512-256-128-C with BatchNorm, ReLU and dropout
  0.5 on its hidden layers: the paper gives no widths;
- the input features of the first stage are the normalised coordinates
  (``in_channels`` 3); eval-mode BatchNorm with running statistics, eps
  1e-5; dropout off.

``build`` sets every Linear's compute dtype as ``reference.models`` does;
``GraspReference`` turns TF32 off for every product.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from reference import geometry as G
from reference import msg
from reference import pipeline
from reference.models import DTYPES, BatchNormF32, DenseHead

NAME = "point_transformer_cls"
PLANES = (32, 64, 128, 256, 512)
BLOCKS = (2, 3, 4, 6, 3)
STRIDES = (1, 4, 4, 4, 4)
NSAMPLE = (8, 16, 16, 16, 16)
SHARE_PLANES = 8
FC = (256, 128)


class Linear(nn.Linear):
    """``nn.Linear`` with a compute dtype (input, weight and bias cast,
    product and bias add each rounded), bias or none."""

    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def knn(points: torch.Tensor, queries: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, S, k]``: the k nearest points of each query, by ``(dx*dx +
    dy*dy) + dz*dz`` and a stable sort (ties to the lower index)."""
    points, queries = points.detach(), queries.detach()
    dx = points[:, None, :, 0] - queries[:, :, None, 0]
    dy = points[:, None, :, 1] - queries[:, :, None, 1]
    dz = points[:, None, :, 2] - queries[:, :, None, 2]
    d2 = (dx * dx + dy * dy) + dz * dz
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


class _Pair(nn.Module):
    """``relu(bn_0(dense_0 x))``, dense_0 without bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense_0 = Linear(cin, cout, bias=False)
        self.bn_0 = BatchNormF32(cout)

    def forward(self, x):
        return torch.relu(self.bn_0(self.dense_0(x)))


class _TwoLayers(nn.Module):
    """``dense_1(relu(bn_0(dense_0 x)))``, both Linears with bias."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.dense_0 = Linear(cin, mid)
        self.bn_0 = BatchNormF32(mid)
        self.dense_1 = Linear(mid, cout)

    def forward(self, x):
        return self.dense_1(torch.relu(self.bn_0(self.dense_0(x))))


class PointTransformerLayer(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.c = c
        self.q, self.k, self.v = Linear(c, c), Linear(c, c), Linear(c, c)
        self.pos = _TwoLayers(3, 3, c)
        self.weight_bn = BatchNormF32(c)
        self.weight_mlp = _TwoLayers(c, c // SHARE_PLANES, c // SHARE_PLANES)

    def forward(self, p, x, idx):
        B, N, K = idx.shape
        x_q, x_k, x_v = self.q(x), self.k(x), self.v(x)
        p_r = self.pos(G.index_points(p, idx) - p[:, :, None, :])
        w = G.index_points(x_k, idx) - x_q[:, :, None, :] + p_r
        w = self.weight_mlp(torch.relu(self.weight_bn(w)))
        w = torch.softmax(w.float(), dim=2)
        value = (G.index_points(x_v, idx) + p_r).float()
        out = (value.view(B, N, K, SHARE_PLANES, self.c // SHARE_PLANES) * w.unsqueeze(3)).sum(2)
        return out.view(B, N, self.c)


class PointTransformerBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.mlp1 = _Pair(c, c)
        self.attn = PointTransformerLayer(c)
        self.bn2 = BatchNormF32(c)
        self.linear3 = Linear(c, c, bias=False)
        self.bn3 = BatchNormF32(c)

    def forward(self, p, x, idx):
        identity = x
        x = torch.relu(self.bn2(self.attn(p, self.mlp1(x), idx)))
        return torch.relu(self.bn3(self.linear3(x)) + identity)


class TransitionDown(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, nsample: int):
        super().__init__()
        self.stride, self.nsample = stride, nsample
        self.mlp = _Pair(cin + 3 if stride > 1 else cin, cout)

    def forward(self, p, x):
        if self.stride == 1:
            return p, self.mlp(x)
        N = p.shape[1]
        c = G.index_points(p, G.fps(p, N // self.stride))
        idx = knn(p, c, min(self.nsample, N))
        grouped = torch.cat([G.index_points(p, idx) - c[:, :, None, :], G.index_points(x, idx)], dim=-1)
        return c, self.mlp(grouped).amax(dim=2)


class PointTransformerCls(nn.Module):
    """The encoder, the mean over the last stage's points, FC 256-128-C:
    ``(log_probs, global feature, pred)``."""

    def __init__(self, num_classes: int = 7):
        super().__init__()
        cin = 3
        for s, (c, blocks, stride, k) in enumerate(zip(PLANES, BLOCKS, STRIDES, NSAMPLE)):
            self.add_module(f"down_{s}", TransitionDown(cin, c, stride, k))
            for j in range(blocks - 1):
                self.add_module(f"block_{s}_{j}", PointTransformerBlock(c))
            cin = c
        self.head = DenseHead(cin, [*FC, num_classes], style="cls_v2")

    def forward(self, points):
        p, x = points, points
        for s, (blocks, k) in enumerate(zip(BLOCKS, NSAMPLE)):
            p, x = getattr(self, f"down_{s}")(p, x)
            idx = knn(p, p, min(k, p.shape[1]))
            for j in range(blocks - 1):
                x = getattr(self, f"block_{s}_{j}")(p, x, idx)
        g = x.mean(dim=1)
        log_probs = torch.log_softmax(self.head(g).float(), dim=-1)
        return log_probs, g, torch.argmax(log_probs, dim=-1)


def build(name: str, num_classes: int = 7, dtype: str = "float32") -> nn.Module:
    """A model of a grasp request by the port's registry name: Point
    Transformer here, the others from ``reference.msg.build``."""
    if name != NAME:
        return msg.build(name, num_classes, dtype)
    model = PointTransformerCls(num_classes)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.compute_dtype = DTYPES[dtype]
    return model


class GraspReference(pipeline.GraspReference):
    """``reference.pipeline.GraspReference`` on the models ``names`` gives
    (a registry name per key of ``pipeline.KEYS``), Point Transformer
    built here and every other model by ``reference.msg.build``, each
    Linear layer in ``dtype``, every matrix product without TF32."""

    def __init__(self, states: dict, names: dict, num_points: int, num_classes: int, dtype: str, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.num_points, self.num_classes, self.device = num_points, num_classes, torch.device(device)
        self.models = {}
        for key in pipeline.KEYS:
            m = build(names[key], num_classes, dtype)
            m.load_state_dict(states[key], strict=True)
            self.models[key] = m.to(self.device).eval()
