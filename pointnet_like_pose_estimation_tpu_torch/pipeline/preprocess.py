"""Point-cloud preprocessing: distance cut, RANSAC plane removal, outlier
rejection, DBSCAN and cluster truncation (counterpart of
``pipeline/preprocess.py`` of the JAX package).

Clouds come in and go out as host numpy arrays ``[N, C >= 3]``; the
distance tests run on ``device`` (the card unless the caller asks for the
CPU) and DBSCAN runs on the host, in the native library
(``native_dbscan``) or, when the caller asks, in numpy.

Two rules make the card and the CPU keep the same points bit for bit:

- every plane distance and squared distance is formed element by element,
  each product and sum rounded on its own in the JAX package's algebraic
  order (``|p.n + d|``; ``|r|^2 - 2 r.x + |x|^2``), never through a matrix
  product, whose summation order and fused multiply-adds differ by device
  (XLA on the CPU contracts the JAX package's own products into FMAs, so
  against JAX only pairs that sit on the radius or the threshold can
  differ);
- the RANSAC triples are drawn on the host from a ``torch.Generator``
  seeded with ``seed`` (``draw_ransac``) and then applied on the device
  (``plane_scores``), so both devices score the same planes. The JAX
  package draws them with ``jax.random.choice`` from a padded cloud; a
  caller can apply those draws instead.

The JAX package pads every cloud to a multiple of 2048 points and maps
fixed-size row blocks so that jit reuses its programs. The port runs
eagerly on the real size; its blocks hold at most ``BLOCK_ELEMS`` pairs,
and no count depends on the block size.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pointnet_like_pose_estimation_tpu_torch.ops import farthest_point_sample, index_points
from pointnet_like_pose_estimation_tpu_torch.pipeline import native_dbscan
from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device
from pointnet_like_pose_estimation_tpu_torch.utils.programs import ProgramCache

# pairs (or point-hypothesis products) held by one block of distance tests
BLOCK_ELEMS = 1 << 24


def _xyz(points: np.ndarray, device: torch.device) -> torch.Tensor:
    """The first three channels as a float32 ``[N, 3]`` tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(points[:, :3], np.float32)).to(device)


def _blocks(n_rows: int, n_cols: int):
    step = max(1, BLOCK_ELEMS // max(n_cols, 1))
    return range(0, n_rows, step), step


def _sq_norms(p: torch.Tensor) -> torch.Tensor:
    return p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]


def _sq_dist_block(rows: torch.Tensor, rows_sq: torch.Tensor, xyz: torch.Tensor,
                   xyz_sq: torch.Tensor) -> torch.Tensor:
    """``[R, N]`` squared distances as ``(|r|^2 - 2 r.x) + |x|^2``."""
    dot = rows[:, None, 0] * xyz[None, :, 0] + rows[:, None, 1] * xyz[None, :, 1]
    dot = dot + rows[:, None, 2] * xyz[None, :, 2]
    return (rows_sq[:, None] - 2.0 * dot) + xyz_sq[None, :]


def _plane_dist(xyz: torch.Tensor, normals: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``|p.n + d|`` for ``[N, 3]`` points and ``[H, 3]`` planes -> ``[N, H]``."""
    t = xyz[:, None, 0] * normals[None, :, 0] + xyz[:, None, 1] * normals[None, :, 1]
    return (t + xyz[:, None, 2] * normals[None, :, 2] + offsets[None, :]).abs()


def clip_distance(points: np.ndarray, dis=(0.0, 2.0), axis: int = 2) -> np.ndarray:
    """Keep the points whose coordinate on ``axis`` lies in ``[dis0, dis1]``."""
    keep = (points[:, axis] >= dis[0]) & (points[:, axis] <= dis[1])
    return points[keep]


# --- RANSAC plane ---------------------------------------------------------------------------


def draw_ransac(num_points: int, num_iterations: int = 1000, seed: int = 0) -> torch.Tensor:
    """``[H, 3]`` int64 point indices of the plane hypotheses, drawn with
    replacement (as ``jax.random.choice`` draws them) on the host from a
    generator seeded with ``seed``. A triple may repeat an index: its
    normal is then 0 and every point scores as its inlier, which the JAX
    package does too (ROADMAP.md Queue 3)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, num_points, (num_iterations, 3), generator=gen)


def plane_scores(xyz: torch.Tensor, triples: torch.Tensor, threshold: float):
    """Score the plane through each triple of ``[N, 3]`` points: ``(normals
    [H, 3], offsets [H], inlier counts [H])``. The normal is the cross
    product over its norm plus 1e-12 (the root taken in float64 and rounded
    once, so it is the same on both devices) and the offset ``-n.p0``."""
    tri = xyz[triples.to(xyz.device)]                          # [H, 3, 3]
    a, b = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    n = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    norm = torch.sqrt(_sq_norms(n).double()).float()
    n = n / (norm[:, None] + 1e-12)
    t0 = tri[:, 0]
    d = -(n[:, 0] * t0[:, 0] + n[:, 1] * t0[:, 1] + n[:, 2] * t0[:, 2])
    thr = np.float32(threshold)
    blocks, step = _blocks(len(n), len(xyz))
    counts = torch.cat([(_plane_dist(xyz, n[lo:lo + step], d[lo:lo + step]) <= thr).sum(0)
                        for lo in blocks])
    return n, d, counts


def best_plane(xyz: torch.Tensor, triples: torch.Tensor, threshold: float):
    """The normal and offset of the hypothesis with the most inliers, the
    first on a tie (``jnp.argmax``'s rule)."""
    n, d, counts = plane_scores(xyz, triples, threshold)
    best = torch.argmax(counts)
    return n[best], d[best]


def _off_plane(xyz, triples, threshold):
    """``|p.n + d| > threshold`` for the best plane, ``[N]`` bool."""
    n, d = best_plane(xyz, triples, threshold)
    return _plane_dist(xyz, n[None], d[None])[:, 0] > np.float32(threshold)


def ransac_plane(points: np.ndarray, distance_threshold: float = 0.006, num_iterations: int = 1000,
                 seed: int = 0, device="cuda"):
    """The dominant plane ``(a, b, c, d)`` and its inlier mask, host arrays."""
    device = resolve_device(device, "ransac_plane")
    xyz = _xyz(points, device)
    n, d = best_plane(xyz, draw_ransac(len(points), num_iterations, seed), distance_threshold)
    inliers = _plane_dist(xyz, n[None], d[None])[:, 0] <= np.float32(distance_threshold)
    return torch.cat([n, d[None]]).cpu().numpy(), inliers.cpu().numpy()


def remove_plane(points: np.ndarray, **kw) -> np.ndarray:
    """Delete the inliers of the dominant plane (the table)."""
    _, inliers = ransac_plane(points, **kw)
    return points[~inliers]


# --- outlier tests --------------------------------------------------------------------------


def range_counts(xyz: torch.Tensor, radius: float) -> torch.Tensor:
    """For each of ``[N, 3]`` points, the points within ``radius`` (``d^2 <=
    radius^2`` in float32), minus one for the point itself. int64 ``[N]``."""
    r2 = np.float32(radius) * np.float32(radius)
    sq = _sq_norms(xyz)
    blocks, step = _blocks(len(xyz), len(xyz))
    out = []
    for lo in blocks:
        within = _sq_dist_block(xyz[lo:lo + step], sq[lo:lo + step], xyz, sq) <= r2
        out.append(within.sum(1) - 1)
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.long, device=xyz.device)


def knn_mean_dist(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """Mean distance to the k nearest other points, float32 ``[N]`` (roots
    and mean in float64, rounded once)."""
    sq = _sq_norms(xyz)
    blocks, step = _blocks(len(xyz), len(xyz))
    out = []
    for lo in blocks:
        d2 = _sq_dist_block(xyz[lo:lo + step], sq[lo:lo + step], xyz, sq)
        d2k = torch.topk(d2, k + 1, dim=1, largest=False).values[:, 1:]     # drop the point itself
        out.append(torch.sqrt(d2k.clamp(min=0.0).double()).mean(1).float())
    return torch.cat(out) if out else xyz.new_zeros(0)


def remove_radius_outlier(points: np.ndarray, nb_points: int = 200, radius: float = 0.05,
                          device="cuda") -> np.ndarray:
    """Drop the points with fewer than ``nb_points`` others within ``radius``."""
    device = resolve_device(device, "remove_radius_outlier")
    counts = range_counts(_xyz(points, device), radius)
    return points[(counts >= nb_points).cpu().numpy()]


def remove_statistical_outlier(points: np.ndarray, nb_neighbors: int = 120, std_ratio: float = 0.1,
                               device="cuda") -> np.ndarray:
    """Drop the points whose mean distance to their ``nb_neighbors`` nearest
    exceeds the mean of those distances plus ``std_ratio`` standard
    deviations (taken on the host in float32, as the JAX package takes them)."""
    if len(points) <= nb_neighbors:
        return points
    device = resolve_device(device, "remove_statistical_outlier")
    md = knn_mean_dist(_xyz(points, device), nb_neighbors).cpu().numpy()
    return points[md <= md.mean() + std_ratio * md.std()]


def clean_scene(points: np.ndarray, plane_threshold: float = 0.006, num_iterations: int = 1000,
                radius_nb_points: int = 200, radius: float = 0.05, seed: int = 0,
                device="cuda") -> np.ndarray:
    """``remove_plane`` then ``remove_radius_outlier``: the points off the
    plane are gathered on the device and the radius test runs among them
    only. The JAX package fuses both tests into one program up to 65,536
    points; on the H100 that fused form, which counts every pair of the
    frame, lost to this one from 4,500 points and gained at most 0.4 ms
    below (PERF.md, Findings, PR 6), so the port keeps this one only."""
    device = resolve_device(device, "clean_scene")
    xyz = _xyz(points, device)
    keep = _off_plane(xyz, draw_ransac(len(points), num_iterations, seed), plane_threshold)
    rows = torch.nonzero(keep)[:, 0]
    counts = range_counts(xyz[rows], radius)
    return points[rows[counts >= radius_nb_points].cpu().numpy()]


# --- DBSCAN and clusters --------------------------------------------------------------------


def _neighbor_lists(xyz: np.ndarray, eps: float) -> list[np.ndarray]:
    """Each point's eps-neighbours (itself included), through a grid of
    cells of side eps, float64."""
    cells = np.floor(xyz / eps).astype(np.int64)
    cell_map: dict[tuple, list[int]] = {}
    for i, c in enumerate(map(tuple, cells)):
        cell_map.setdefault(c, []).append(i)
    cell_map = {c: np.asarray(v) for c, v in cell_map.items()}
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    out = []
    for i, (cx, cy, cz) in enumerate(cells):
        cand = np.concatenate([cell_map[k] for dx, dy, dz in offsets
                               if (k := (cx + dx, cy + dy, cz + dz)) in cell_map])
        d2 = np.sum((xyz[cand] - xyz[i]) ** 2, axis=-1)
        out.append(cand[d2 <= eps * eps])
    return out


def dbscan_reference(xyz: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """Plain numpy DBSCAN, a per-point Python loop: slow beyond a few
    thousand points. Same labels as the native library."""
    xyz = np.asarray(xyz, np.float64)
    neigh = _neighbor_lists(xyz, eps)
    core = np.array([len(v) >= min_points for v in neigh], bool)
    labels = np.full(len(xyz), -1, np.int64)
    cluster = 0
    for i in range(len(xyz)):
        if labels[i] != -1 or not core[i]:
            continue
        labels[i] = cluster
        stack = [i]
        while stack:
            for q in neigh[stack.pop()]:
                if labels[q] == -1:
                    labels[q] = cluster
                    if core[q]:
                        stack.append(q)
        cluster += 1
    return labels


def dbscan(points: np.ndarray, eps: float = 0.03, min_points: int = 500, *,
           use_native: bool = True) -> np.ndarray:
    """int64 DBSCAN labels (-1 noise) with Open3D's semantics: a point is a
    core point when at least ``min_points`` points, itself included, lie
    within ``eps``; clusters grow through core points in index order and a
    border point joins the first cluster that reaches it. ``use_native``
    runs the native library and raises if it cannot be built; False runs
    ``dbscan_reference``."""
    xyz = np.asarray(points[:, :3], np.float64)
    if use_native:
        return native_dbscan.dbscan(xyz, eps, min_points)
    return dbscan_reference(xyz, eps, min_points)


def cluster_groups(labels: np.ndarray) -> list[np.ndarray]:
    """The point indices of each cluster, in label order. A cluster of any
    size is taken: FPS runs on clouds of any number of points."""
    return [np.flatnonzero(labels == c) for c in range(int(labels.max()) + 1)]


def truncate_clusters(xyz: torch.Tensor, groups: list[np.ndarray]):
    """FPS each cluster of the ``[P, 3]`` device cloud down to the smallest
    cluster's size, from its first point: ``(points [K, min_size, 3],
    indices into the cloud [K, min_size])``, both on the device. The
    clusters are padded to the largest with copies of their first point,
    which FPS never picks while real points remain. The staged, unbucketed
    form of the truncation that ``cluster_point`` and the scene program run
    bucketed; the tests hold them against it."""
    min_size, max_size = min(map(len, groups)), max(map(len, groups))
    padded = np.stack([np.concatenate([g, np.full(max_size - len(g), g[0])]) for g in groups])
    idx = torch.from_numpy(padded).to(xyz.device)
    clusters = xyz[idx]                                          # [K, max_size, 3]
    pick = farthest_point_sample(clusters, min_size).long()
    return index_points(clusters, pick), torch.gather(idx, 1, pick)


def _round_up(v: int, q: int) -> int:
    return -(-v // q) * q


def bucketed_groups(groups: list[np.ndarray]) -> tuple[np.ndarray, int]:
    """The JAX package's bucketed index table of the clusters ``groups``:
    int64 ``[k_bucket, n_bucket]``, each cluster padded with its first point
    to ``n_bucket`` (the largest cluster's size rounded up to 256) and K to a
    multiple of 4 with rows of cluster 0's first point; and ``s_bucket``,
    the truncation FPS's sample count: the smallest cluster's size rounded
    up to 256, at most ``n_bucket``."""
    sizes = [len(g) for g in groups]
    n_bucket = _round_up(max(sizes), 256)
    table = np.full((_round_up(len(groups), 4), n_bucket), groups[0][0], np.int64)
    for c, g in enumerate(groups):
        table[c, :len(g)], table[c, len(g):] = g, g[0]
    return table, min(_round_up(min(sizes), 256), n_bucket)


# the truncation programs of each device, kept for the life of the process
# as the JAX package keeps its module-level ``_fps_jit``
_TRUNCATION_PROGRAMS: dict[torch.device, ProgramCache] = {}


def cluster_point(points: np.ndarray, eps: float = 0.03, min_points: int = 500,
                  device="cuda") -> np.ndarray | None:
    """DBSCAN, then every cluster truncated to the smallest cluster's size
    by FPS on ``device``: float32 ``[K, min_size, C]``, or None when DBSCAN
    finds no cluster. The clusters are gathered on the host into their
    bucket (``bucketed_groups``) and the FPS is one program per bucket
    (``utils/programs.py``): FPS is greedy, so its first ``min_size`` picks
    over ``s_bucket`` are its picks over ``min_size``."""
    device = resolve_device(device, "cluster_point")
    labels = dbscan(points, eps, min_points)
    if labels.max() < 0:
        return None
    groups = cluster_groups(labels)
    table, s_bucket = bucketed_groups(groups)
    batch = torch.from_numpy(np.ascontiguousarray(points[:, :3], np.float32)[table])
    if device not in _TRUNCATION_PROGRAMS:
        _TRUNCATION_PROGRAMS[device] = ProgramCache(device)
    pick = _TRUNCATION_PROGRAMS[device](("truncate", *table.shape, s_bucket),
                                        functools.partial(farthest_point_sample, num_samples=s_bucket), (batch,))
    K, min_size = len(groups), min(map(len, groups))
    idx = np.take_along_axis(table[:K], pick[:K, :min_size].cpu().numpy().astype(np.int64), axis=1)
    return np.asarray(points, np.float32)[idx]
