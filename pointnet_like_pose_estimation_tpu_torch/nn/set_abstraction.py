"""PointNet++ set abstraction, single- and multi-scale (counterparts of
``SetAbstraction`` and ``SetAbstractionMSG`` in ``nn/set_abstraction.py`` of
the JAX package).

Where ``per_point_reason`` gives None (an eval-mode float32 ball-query
grouping on the card) a layer builds no grouped tensor: it takes its first
Linear per point (``ops/grouping.py`` ``per_point_products``) and the
first pair gathers the products (``PointwiseMLP.forward_max_grouped``).
Every other grouping gathers, centres and concatenates the grouped rows
and runs the MLP on them."""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
from pointnet_like_pose_estimation_tpu_torch.nn.layers import Linear, PointwiseMLP, pair_reason
from pointnet_like_pose_estimation_tpu_torch.ops import (
    farthest_point_sample,
    index_points,
    sample_and_group,
    sample_and_group_all,
)
from pointnet_like_pose_estimation_tpu_torch.ops.grouping import count_grouped, per_point_products, sample_and_query


def per_point_reason(layer: nn.Module, points: torch.Tensor, features: torch.Tensor | None) -> str | None:
    """Why ``layer`` (a ``SetAbstraction`` or ``SetAbstractionMSG``) groups
    its MLP's input, or None where it takes its first Linear per point:
    ``"group_all"`` (the global level: one group, nothing to gather),
    ``"sharded"`` (the grouping runs over ``parallel.point_sharding``'s
    ranks), then for each scale's MLP ``"depth"`` (one layer: its only pair
    is the pooled last one), ``"module"`` (a first Linear of another
    forward, such as the tensor-parallel shards), ``"train"`` (a train-mode
    BatchNorm: the batch statistics of the grouped rows), and
    ``nn/layers.py`` ``plain_reason``'s reasons for the first pair's
    output ``[B, S, K, C1]``, which must take the eval pass: a gradient
    wanted, bfloat16 or float64, a width no multiple of 4, its size, the
    CPU."""
    if getattr(layer, "group_all", False):
        return "group_all"
    from pointnet_like_pose_estimation_tpu_torch.parallel import context

    ctx = context.current_point_sharding()
    if ctx is not None and ctx.dispatches(points.shape[1]):
        return "sharded"
    inputs = [t for t in (points, features) if t is not None]
    for mlp, K in layer.scales():
        if mlp.n < 2:
            return "depth"
        dense, bn = mlp.dense_0, mlp.bn_0
        if type(dense) is not Linear:
            return "module"
        if bn.training:
            return "train"
        dtype = dense.compute_dtype or functools.reduce(torch.promote_types, (t.dtype for t in inputs),
                                                        dense.weight.dtype)
        grad = any(t.requires_grad for t in (*inputs, dense.weight, dense.bias))
        rows = points.shape[0] * layer.num_centroids * K
        reason = pair_reason(bn, dtype, dense.out_features, rows * dense.out_features, grad, points.is_cuda)
        if reason is not None:
            return reason
    return None


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

    def scales(self) -> list[tuple[PointwiseMLP, int | None]]:
        """Each scale's MLP and neighbours: here one."""
        return [(self.mlp, self.num_neighbors)]

    def forward(self, points: torch.Tensor, features: torch.Tensor | None):
        """points ``[B, N, 3]``, features ``[B, N, D]`` or None ->
        (centroids ``[B, S, 3]``, features ``[B, S, mlp[-1]]``)."""
        if per_point_reason(self, points, features) is None:
            _, centroids, idx = sample_and_query(points, self.num_centroids, self.num_neighbors, self.radius)
            pf, qc = per_point_products(self.mlp.dense_0.weight, points, features, centroids, coords_first=True)
            return centroids, self.mlp.forward_max_grouped(pf, qc, idx)
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

    def scales(self) -> list[tuple[PointwiseMLP, int]]:
        """Each scale's MLP and neighbours."""
        return [(getattr(self, f"mlp_{i}"), K) for i, K in enumerate(self.num_neighbors_list)]

    def forward(self, points: torch.Tensor, features: torch.Tensor | None):
        """points ``[B, N, 3]``, features ``[B, N, D]`` or None ->
        (centroids ``[B, S, 3]``, features ``[B, S, sum of last widths]``)."""
        from pointnet_like_pose_estimation_tpu_torch.parallel import context, sharded_ops

        if per_point_reason(self, points, features) is None:
            return self._per_point(points, features)
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

    def _query(self, points: torch.Tensor):
        """One FPS and one multi-scale ball query: the centroids and every
        scale's neighbours side by side, ``[B, S, sum of K]``."""
        centroids = index_points(points, farthest_point_sample(points, self.num_centroids))
        return centroids, ball_query_multi(points, centroids, self.radius_list, self.num_neighbors_list)

    def _group(self, points: torch.Tensor, features: torch.Tensor | None):
        """The centroids and each scale's grouped ``[features, centered
        coords]`` (the reference's order)."""
        centroids, idx_all = self._query(points)
        grouped_list, k_off = [], 0
        for K in self.num_neighbors_list:
            idx = idx_all[..., k_off:k_off + K]
            k_off += K
            grouped = index_points(points, idx) - centroids[:, :, None, :]
            if features is not None:
                grouped = torch.cat([index_points(features, idx), grouped], dim=-1)
            grouped_list.append(count_grouped(grouped))
        return centroids, grouped_list

    def _per_point(self, points: torch.Tensor, features: torch.Tensor | None):
        """The scales' first Linears as one product per point (their weights
        side by side), each scale's first pair gathering its columns of it
        through its slice of the neighbours."""
        centroids, idx_all = self._query(points)
        scales = self.scales()
        weight = torch.cat([mlp.dense_0.weight for mlp, _ in scales])
        pf, qc = per_point_products(weight, points, features, centroids, coords_first=False)
        outs, c_off, k_off = [], 0, 0
        for mlp, K in scales:
            c1 = mlp.dense_0.out_features
            outs.append(mlp.forward_max_grouped(pf[..., c_off:c_off + c1], qc[..., c_off:c_off + c1],
                                                idx_all[..., k_off:k_off + K]))
            c_off, k_off = c_off + c1, k_off + K
        return centroids, torch.cat(outs, dim=-1)
