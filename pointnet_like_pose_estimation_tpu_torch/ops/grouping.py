"""Ball-query grouping (counterpart of ``ops/grouping.py`` of the JAX
package) and kNN grouping, channels-last: grouped tensors are ``[B, S, K,
C]``.

``count_grouped`` adds the bytes of every grouped tensor that
``sample_and_group``, ``sample_and_group_all``, ``knn_group``,
``SetAbstractionMSG._group`` and Point Transformer's attention
(``nn/point_transformer.py``) build on one device (not the point-sharded
groupings of ``parallel``) to ``count_grouped.bytes``, the counter
``grouped_bytes`` (``utils/counters.py``), which the request and step
programs keep as they keep the kernels' launches. A set abstraction that
applies its first Linear per point (``per_point_products``, chosen by
``nn/set_abstraction.py`` ``per_point_reason``) builds no grouped tensor,
so nothing is counted for it."""

from __future__ import annotations

import torch
from torch.nn import functional as F

# module import: kernels.ball_group itself imports ops.geometry
from pointnet_like_pose_estimation_tpu_torch.kernels import ball_group
from pointnet_like_pose_estimation_tpu_torch.kernels.knn import knn
from pointnet_like_pose_estimation_tpu_torch.ops.geometry import index_points
from pointnet_like_pose_estimation_tpu_torch.ops.sampling import farthest_point_sample
from pointnet_like_pose_estimation_tpu_torch.utils.counters import counted


@counted("grouped_bytes", attr="bytes")
def count_grouped(grouped: torch.Tensor) -> torch.Tensor:
    """``grouped``, its bytes added to ``count_grouped.bytes``."""
    count_grouped.bytes += grouped.numel() * grouped.element_size()
    return grouped


def query_ball_point(
    radius: float, num_neighbors: int, points: torch.Tensor, centroids: torch.Tensor
) -> torch.Tensor:
    """``[B, S, K]`` int32: the K lowest-index points within ``radius`` of
    each centroid, empty slots repeating the first, an empty ball N-1."""
    return ball_group.ball_query(points, centroids, radius, num_neighbors)


def query_knn(num_neighbors: int, points: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """``[B, S, min(num_neighbors, N)]`` int64: the nearest points of each
    query, nearest first, a tie to the lower index (``kernels/knn.py``).
    A cloud of fewer than ``num_neighbors`` points gives every point."""
    return knn(points, queries, min(int(num_neighbors), points.shape[1]))


def knn_group(points: torch.Tensor, features: torch.Tensor | None, queries: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """``[B, S, K, 3 (+D)]``: each neighbour ``idx [B, S, K]`` of each query
    as its coordinates relative to the query, then its features (the
    order of Point Transformer's ``queryandgroup`` with ``use_xyz``),
    counted by ``count_grouped``."""
    grouped = index_points(points, idx) - queries[:, :, None, :]
    if features is not None:
        grouped = torch.cat([grouped, index_points(features, idx)], dim=-1)
    return count_grouped(grouped)


def sample_and_group(
    points: torch.Tensor,
    features: torch.Tensor | None,
    num_centroids: int,
    num_neighbors: int,
    radius: float,
    *,
    fps_idx: torch.Tensor | None = None,
    return_fps: bool = False,
):
    """FPS centroids -> ball query -> gather -> center on the centroid.

    ``points`` is ``[B, N, P]``: all P channels are coordinates (P = 3 for
    the classifiers, 3 + num_classes for the SSG and MSG pose heads).
    ``fps_idx`` takes precomputed ``[B, S]`` centroid indices in place of
    the FPS; ``return_fps`` also returns the indices used.

    Returns ``(centroids [B, S, P], grouped [B, S, K, P (+D)])``, the
    centered coordinates first and the grouped features after them.

    Under ``parallel.point_sharding`` (and without ``fps_idx`` and
    ``return_fps``) the grouping runs over the sharded point axis
    (``parallel.sharded_ops.sharded_sample_and_group``) where the context
    takes N.
    """
    from pointnet_like_pose_estimation_tpu_torch.parallel import context, sharded_ops

    ctx = context.current_point_sharding()
    if ctx is not None and fps_idx is None and not return_fps and ctx.dispatches(points.shape[1]):
        ctx.dispatch_count += 1
        return sharded_ops.sharded_sample_and_group(points, features, num_centroids, num_neighbors, radius,
                                                    ctx.mesh, axis=ctx.axis, batch_axis=ctx.batch_axis)
    fps_idx, centroids, idx = sample_and_query(points, num_centroids, num_neighbors, radius, fps_idx=fps_idx)
    grouped = index_points(points, idx) - centroids[:, :, None, :]
    if features is not None:
        grouped = torch.cat([grouped, index_points(features, idx)], dim=-1)
    count_grouped(grouped)
    if return_fps:
        return centroids, grouped, fps_idx
    return centroids, grouped


def sample_and_query(points: torch.Tensor, num_centroids: int, num_neighbors: int, radius: float, *,
                     fps_idx: torch.Tensor | None = None):
    """``sample_and_group``'s FPS and ball query without the gather:
    ``(fps_idx [B, S], centroids [B, S, P], idx [B, S, K] int32)``."""
    if fps_idx is None:
        fps_idx = farthest_point_sample(points, num_centroids)
    centroids = index_points(points, fps_idx)
    return fps_idx, centroids, query_ball_point(radius, num_neighbors, points, centroids)


def per_point_products(weight: torch.Tensor, points: torch.Tensor, features: torch.Tensor | None,
                       centroids: torch.Tensor, coords_first: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """A grouped set abstraction's first Linear (``weight`` ``[C1, P + D]``,
    no bias) taken before the grouping. Its input row for neighbour j of
    centroid c is ``[x_j - c, f_j]`` (``coords_first``: ``sample_and_group``)
    or ``[f_j, x_j - c]`` (``SetAbstractionMSG``), and the product is linear,
    so ``W [x_j - c, f_j] = W [x_j, f_j] - W_x c``. Returns ``(pf [B, N,
    C1], qc [B, S, C1])``: ``W`` applied to every point's uncentred row and
    its coordinate columns ``W_x`` to every centroid. ``pf[b, idx] - qc[b,
    s]`` is then the grouped product, summed in another order (float32
    sums of N rows where the grouping took S * K)."""
    P = points.shape[-1]
    if features is None:
        return F.linear(points, weight), F.linear(centroids, weight)
    if coords_first:
        rows, w_x = torch.cat([points, features], dim=-1), weight[:, :P]
    else:
        rows, w_x = torch.cat([features, points], dim=-1), weight[:, -P:]
    return F.linear(rows, weight), F.linear(centroids, w_x)


def sample_and_group_all(points: torch.Tensor, features: torch.Tensor | None):
    """One group holding the whole cloud, its centroid at the origin:
    ``(zeros [B, 1, P], grouped [B, 1, N, P (+D)])`` with raw coordinates."""
    B, _, C = points.shape
    centroids = torch.zeros((B, 1, C), dtype=points.dtype, device=points.device)
    grouped = points[:, None]
    if features is not None:
        grouped = torch.cat([grouped, features[:, None]], dim=-1)
    return centroids, count_grouped(grouped)
