"""PointNet++ set abstraction, single- and multi-scale (counterparts of
``SetAbstraction`` and ``SetAbstractionMSG`` in ``nn/set_abstraction.py`` of
the JAX package)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
from pointnet_like_pose_estimation_tpu_torch.nn.layers import PointwiseMLP
from pointnet_like_pose_estimation_tpu_torch.ops import (
    farthest_point_sample,
    index_points,
    sample_and_group,
    sample_and_group_all,
)


class SetAbstraction(nn.Module):
    """FPS -> ball query -> shared MLP -> max over each group.

    ``in_channels`` counts the grouped channels: 3 coordinates plus the
    input features. With ``group_all`` the layer is the global one.
    """

    def __init__(self, num_centroids: int | None, num_neighbors: int | None,
                 radius: float | None, in_channels: int, mlp: Sequence[int],
                 group_all: bool = False):
        super().__init__()
        self.num_centroids = num_centroids
        self.num_neighbors = num_neighbors
        self.radius = radius
        self.group_all = group_all
        self.mlp = PointwiseMLP(in_channels, mlp)

    def forward(self, points: torch.Tensor, features: torch.Tensor | None):
        """points ``[B, N, 3]``, features ``[B, N, D]`` or None ->
        (centroids ``[B, S, 3]``, features ``[B, S, mlp[-1]]``)."""
        if self.group_all:
            centroids, grouped = sample_and_group_all(points, features)
        else:
            centroids, grouped = sample_and_group(
                points, features, self.num_centroids, self.num_neighbors, self.radius
            )
        return centroids, self.mlp(grouped).amax(dim=-2)


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping: one FPS and one multi-scale ball query shared
    by every radius, then a shared MLP and a max per scale, concatenated.

    ``in_channels`` counts the grouped channels: the input features plus 3
    coordinates. The point-sharded branch of the JAX layer is not ported.
    """

    def __init__(self, num_centroids: int, num_neighbors_list: Sequence[int],
                 radius_list: Sequence[float], in_channels: int,
                 mlp_list: Sequence[Sequence[int]]):
        super().__init__()
        self.num_centroids = num_centroids
        self.num_neighbors_list = tuple(int(k) for k in num_neighbors_list)
        self.radius_list = tuple(float(r) for r in radius_list)
        for i, widths in enumerate(mlp_list):
            self.add_module(f"mlp_{i}", PointwiseMLP(in_channels, widths))

    def forward(self, points: torch.Tensor, features: torch.Tensor | None):
        """points ``[B, N, 3]``, features ``[B, N, D]`` or None ->
        (centroids ``[B, S, 3]``, features ``[B, S, sum of last widths]``)."""
        centroids = index_points(points, farthest_point_sample(points, self.num_centroids))
        idx_all = ball_query_multi(points, centroids, self.radius_list, self.num_neighbors_list)
        outs, k_off = [], 0
        for i, K in enumerate(self.num_neighbors_list):
            idx = idx_all[..., k_off:k_off + K]
            k_off += K
            grouped = index_points(points, idx) - centroids[:, :, None, :]
            if features is not None:
                # the reference's order: [features, centered coords]
                grouped = torch.cat([index_points(features, idx), grouped], dim=-1)
            outs.append(getattr(self, f"mlp_{i}")(grouped).amax(dim=-2))
        return centroids, torch.cat(outs, dim=-1)
