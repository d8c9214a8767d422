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
from pointnet_like_pose_estimation_tpu_torch.ops.grouping import count_grouped


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
        return centroids, self.mlp.forward_max(grouped)


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping: one FPS and one multi-scale ball query shared
    by every radius, then a shared MLP and a max per scale, concatenated.

    ``in_channels`` counts the grouped channels: the input features plus 3
    coordinates. Under ``parallel.point_sharding`` the grouping of every
    scale runs over the sharded point axis
    (``parallel.sharded_ops.sharded_sample_and_group_multi``) where the
    context takes N.
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
        from pointnet_like_pose_estimation_tpu_torch.parallel import context, sharded_ops

        ctx = context.current_point_sharding()
        if ctx is not None and ctx.dispatches(points.shape[1]):
            ctx.dispatch_count += 1
            centroids, grouped_list = sharded_ops.sharded_sample_and_group_multi(
                points, features, self.num_centroids, self.radius_list, self.num_neighbors_list,
                ctx.mesh, axis=ctx.axis, batch_axis=ctx.batch_axis)
        else:
            centroids, grouped_list = self._group(points, features)
        outs = [getattr(self, f"mlp_{i}").forward_max(grouped) for i, grouped in enumerate(grouped_list)]
        return centroids, torch.cat(outs, dim=-1)

    def _group(self, points: torch.Tensor, features: torch.Tensor | None):
        """One FPS and one multi-scale ball query: the centroids and each
        scale's grouped ``[features, centered coords]`` (the reference's order)."""
        centroids = index_points(points, farthest_point_sample(points, self.num_centroids))
        idx_all = ball_query_multi(points, centroids, self.radius_list, self.num_neighbors_list)
        grouped_list, k_off = [], 0
        for K in self.num_neighbors_list:
            idx = idx_all[..., k_off:k_off + K]
            k_off += K
            grouped = index_points(points, idx) - centroids[:, :, None, :]
            if features is not None:
                grouped = torch.cat([index_points(features, idx), grouped], dim=-1)
            grouped_list.append(count_grouped(grouped))
        return centroids, grouped_list
