"""T-Nets and the PointNet encoder (counterparts of ``nn/tnet.py`` of the
JAX package), channels-last: a ``[k, k]`` transform ``T`` is applied to a
``[B, N, k]`` cloud as ``x @ T^T``, a plain ``torch.matmul``.
"""

from __future__ import annotations

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.nn.layers import BatchNormF32, Linear, PointwiseMLP


def apply_transform(x: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """``out[b, n, d] = sum_c x[b, n, c] * transform[b, d, c]``, in the
    promoted dtype of the two, as ``jnp.einsum`` promotes: a float32 cloud
    and a bfloat16 transform give a float32 product."""
    dt = torch.promote_types(x.dtype, transform.dtype)
    return torch.matmul(x.to(dt), transform.to(dt).transpose(-1, -2))


class TNet(nn.Module):
    """Predicts a ``[k, k]`` transform from a ``[B, N, k]`` cloud: shared MLP
    64-128-1024, max over the points, FC 512-256, then ``k*k`` outputs.

    The output layer starts as the identity: zero weight and the flattened
    identity as bias (``reset_identity``), as in the JAX package.
    """

    def __init__(self, k: int):
        super().__init__()
        self.k = k
        self.mlp = PointwiseMLP(k, [64, 128, 1024])
        self.fc = PointwiseMLP(1024, [512, 256])
        self.out = Linear(256, k * k)
        self.reset_identity()

    def reset_identity(self) -> None:
        with torch.no_grad():
            self.out.weight.zero_()
            self.out.bias.copy_(torch.eye(self.k).reshape(-1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc(self.mlp.forward_max(x))
        return self.out(h).reshape(x.shape[0], self.k, self.k)


def orthogonality_regularizer(transform: torch.Tensor) -> torch.Tensor:
    """``mean_b ||T T^T - I||_F`` of ``[B, k, k]`` transforms."""
    eye = torch.eye(transform.shape[-1], dtype=transform.dtype, device=transform.device)
    ttt = torch.matmul(transform, transform.transpose(-1, -2)) - eye
    return torch.sqrt((ttt * ttt).sum(dim=(-2, -1)) + 1e-12).mean()


class PointNetEncoder(nn.Module):
    """PointNet global feature encoder with input and feature transforms:
    TNet(3) -> transform -> 64 -> TNet(64) -> transform -> 128 -> 1024 (BN,
    no ReLU) -> max over the points. ``global_feat=False`` concatenates the
    global vector onto the 64-wide point features instead.

    Returns ``(feature, input_transform, feature_transform)``.
    """

    def __init__(self, in_channels: int = 3, global_feat: bool = True):
        super().__init__()
        self.global_feat = global_feat
        self.tnet_input = TNet(3)
        self.conv1 = PointwiseMLP(in_channels, [64])
        self.tnet_feature = TNet(64)
        self.conv2 = PointwiseMLP(64, [128])
        self.conv3 = Linear(128, 1024)
        self.bn3 = BatchNormF32(1024)

    def forward(self, x: torch.Tensor):
        B, N, D = x.shape
        tin = self.tnet_input(x[..., :3])
        geo = apply_transform(x[..., :3], tin)
        x = torch.cat([geo, x[..., 3:]], dim=-1) if D > 3 else geo
        x = self.conv1(x)
        tfeat = self.tnet_feature(x)
        point_feat = x = apply_transform(x, tfeat)
        x = self.bn3(self.conv3(self.conv2(x))).amax(dim=-2)       # [B, 1024]
        if self.global_feat:
            return x, tin, tfeat
        tiled = x[:, None, :].expand(B, N, 1024)
        return torch.cat([tiled, point_feat], dim=-1), tin, tfeat
