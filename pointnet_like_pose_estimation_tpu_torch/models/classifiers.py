"""PointNet and PointNet++ SSG and MSG classifiers (counterparts of
``PointNetCls``, ``PointNet2ClsSSG`` and ``PointNet2ClsMSG`` in
``models/classifiers.py`` of the JAX package), and a Point Transformer
classifier, which the JAX package does not have."""

from __future__ import annotations

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.nn import (
    DenseHead,
    PointNetEncoder,
    SetAbstraction,
    SetAbstractionMSG,
)
from pointnet_like_pose_estimation_tpu_torch.nn.point_transformer import PointTransformerBlock, TransitionDown
from pointnet_like_pose_estimation_tpu_torch.ops.grouping import query_knn


class PointNetCls(nn.Module):
    """PointNet encoder and an FC 512-256-C head on ``[B, N, 3]``.

    Returns ``(log_probs [B, C], feature transform [B, 64, 64], pred [B])``.
    """

    def __init__(self, num_classes: int = 7):
        super().__init__()
        self.encoder = PointNetEncoder(3)
        self.head = DenseHead(1024, [512, 256, num_classes], style="cls_v1")

    def forward(self, points: torch.Tensor):
        feat, _, trans_feat = self.encoder(points)
        log_probs = torch.log_softmax(self.head(feat).float(), dim=-1)
        return log_probs, trans_feat, torch.argmax(log_probs, dim=-1)


class PointNet2ClsSSG(nn.Module):
    """3-level single-scale set abstraction classifier on ``[B, N, 3]``.

    Returns ``(log_probs [B, C], global feature [B, 1024], pred [B])``.
    """

    def __init__(self, num_classes: int = 7):
        super().__init__()
        self.sa1 = SetAbstraction(512, 32, 0.2, 3, [64, 64, 128])
        self.sa2 = SetAbstraction(128, 64, 0.4, 128 + 3, [128, 128, 256])
        self.sa3 = SetAbstraction(None, None, None, 256 + 3, [256, 512, 1024], group_all=True)
        self.head = DenseHead(1024, [512, 256, num_classes], style="cls_v2")

    def forward(self, points: torch.Tensor):
        p, f = self.sa1(points, None)
        p, f = self.sa2(p, f)
        _, f = self.sa3(p, f)
        g = f.reshape(f.shape[0], -1)
        log_probs = torch.log_softmax(self.head(g).float(), dim=-1)
        return log_probs, g, torch.argmax(log_probs, dim=-1)


class PointNet2ClsMSG(nn.Module):
    """2 multi-scale + 1 global set abstraction classifier on ``[B, N, 3]``.

    Returns ``(log_probs [B, C], global feature [B, 1024], pred [B])``.
    """

    def __init__(self, num_classes: int = 7):
        super().__init__()
        self.sa1 = SetAbstractionMSG(512, [16, 32, 128], [0.1, 0.2, 0.4], 3,
                                     [[32, 32, 64], [64, 64, 128], [64, 96, 128]])
        self.sa2 = SetAbstractionMSG(128, [32, 64, 128], [0.2, 0.4, 0.8], 320 + 3,
                                     [[64, 64, 128], [128, 128, 256], [128, 128, 256]])
        self.sa3 = SetAbstraction(None, None, None, 640 + 3, [256, 512, 1024], group_all=True)
        self.head = DenseHead(1024, [512, 256, num_classes], style="cls_v2")

    def forward(self, points: torch.Tensor):
        p, f = self.sa1(points, None)
        p, f = self.sa2(p, f)
        _, f = self.sa3(p, f)
        g = f.reshape(f.shape[0], -1)
        log_probs = torch.log_softmax(self.head(g).float(), dim=-1)
        return log_probs, g, torch.argmax(log_probs, dim=-1)


class PointTransformerCls(nn.Module):
    """Point Transformer's encoder (``pointtransformer_seg_repro`` of
    POSTECH-CVLab/point-transformer: planes 32-64-128-256-512, blocks
    2-3-4-6-3, stride 1-4-4-4-4, nsample 8-16-16-16-16, share_planes 8), a
    mean over the last stage's points and an FC 256-128-C head with
    dropout 0.5, on ``[B, N, 3]`` (the coordinates are the first stage's
    features too). Stage s is its TransitionDown (``down_s``) and
    ``blocks[s] - 1`` blocks (``block_s_j``), as the published
    ``_make_enc`` builds it; its kNN is queried once and shared by its
    blocks.

    Returns ``(log_probs [B, C], global feature [B, 512], pred [B])``.
    """

    PLANES = (32, 64, 128, 256, 512)
    BLOCKS = (2, 3, 4, 6, 3)
    STRIDES = (1, 4, 4, 4, 4)
    NSAMPLE = (8, 16, 16, 16, 16)
    SHARE_PLANES = 8

    def __init__(self, num_classes: int = 7):
        super().__init__()
        c_in = 3
        for s, (c, blocks, stride, k) in enumerate(zip(self.PLANES, self.BLOCKS, self.STRIDES, self.NSAMPLE)):
            self.add_module(f"down_{s}", TransitionDown(c_in, c, stride, k))
            for j in range(blocks - 1):
                self.add_module(f"block_{s}_{j}", PointTransformerBlock(c, self.SHARE_PLANES))
            c_in = c
        self.head = DenseHead(c_in, [256, 128, num_classes], style="cls_v2", dropout_rate=0.5)

    def forward(self, points: torch.Tensor):
        p, x = points, points
        for s, (blocks, k) in enumerate(zip(self.BLOCKS, self.NSAMPLE)):
            p, x = getattr(self, f"down_{s}")(p, x)
            idx = query_knn(k, p, p)
            for j in range(blocks - 1):
                x = getattr(self, f"block_{s}_{j}")(p, x, idx)
        g = x.mean(dim=1)
        log_probs = torch.log_softmax(self.head(g).float(), dim=-1)
        return log_probs, g, torch.argmax(log_probs, dim=-1)
