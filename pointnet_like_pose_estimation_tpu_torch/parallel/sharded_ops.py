"""Point-cloud ops over a sharded N axis (counterpart of
``parallel/sharded_ops.py`` of the JAX package).

Every rank of the mesh's ``axis`` is handed the same rows of the clouds,
all N points, and keeps its contiguous block of N/d points; all it reads
afterwards is that block, and what comes out is the same on every rank of
the axis (JAX's outputs replicated over ``points``). On a 2-D mesh the rows
are the rank's own (``shard_batch`` over ``batch_axis``), and the
collectives run over ``axis`` only, within the rank's row group.

FPS needs a global argmax of the running distances each step: each shard
packs its (max, index, coordinates) into one float64 row, and one
all-reduce of a ``[d, B, 2 + C]`` slot buffer hands every rank all of
them; the first maximum wins, so the lowest rank wins across shards and
``torch.argmax``'s first index within one, which is the lowest global
index, as in the JAX package and the kernel. float64 holds the f32 maximum,
an index below 2^31 and the f32 coordinates exactly, where JAX's bitcast of
the index into an f32 payload would be a denormal that a sum may flush.
One collective a step, as in the JAX package.

The ball query forms its distances with ``ops.square_distance`` and FPS
its own as ``kernels.fps.fps_reference`` does, term by term, so the indices
equal the kernels' (a product on the card's tensor cores, JAX's ``einsum``,
would fuse multiply-adds and part from them at radius ties). Each shard
keeps its K lowest in-ball global indices, a slot all-reduce gathers them
and the K lowest of all are the lowest-index-first selection, padded with
the first and an empty ball N-1. Centroids and neighbourhoods are owner
gathers: the owner's values and zeros elsewhere, summed.

These ops serve forwards, as the JAX package uses them: the gathers pass
their cotangent through (``collectives.reduce_from``), so a backward gives
each rank its own block's share.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import _radius_sq
from pointnet_like_pose_estimation_tpu_torch.ops.geometry import index_points, square_distance
from pointnet_like_pose_estimation_tpu_torch.parallel import collectives
from pointnet_like_pose_estimation_tpu_torch.parallel.mesh import axis_size


class _Shard:
    """This rank's block of the point axis."""

    def __init__(self, mesh: DeviceMesh, axis: str, N: int):
        self.d = axis_size(mesh, axis)
        if N % self.d:
            raise ValueError(f"N={N} not divisible by axis size {self.d}")
        self.group = mesh.get_group(axis)
        self.r = mesh.get_local_rank(axis)
        self.N, self.n = N, N // self.d
        self.lo = self.r * self.n

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return t[:, self.lo:self.lo + self.n]

    def owner_gather(self, arr: torch.Tensor, idx: torch.Tensor, site: str) -> torch.Tensor:
        """``arr[b, idx]`` for global ``idx`` (``[B, ...]``) from the block
        ``arr`` (``[B, N/d, C]``): the owner's values, zeros elsewhere, summed."""
        owner = (idx // self.n) == self.r
        g = index_points(arr, (idx - self.lo).clamp(0, self.n - 1))
        return collectives.reduce_from(torch.where(owner[..., None], g, 0.0), self.group, site)


def _fps(shard: _Shard, pts: torch.Tensor, num_samples: int, start_idx) -> torch.Tensor:
    """FPS over the block ``pts`` ``[B, N/d, C]``; ``[B, S]`` int64 global indices."""
    B, _, C = pts.shape
    rows = torch.arange(B, device=pts.device)
    far = torch.as_tensor(start_idx, device=pts.device).long().expand(B).clone()
    if bool(((far < 0) | (far >= shard.N)).any()):
        raise ValueError(f"sharded FPS: start_idx outside [0, {shard.N})")
    with torch.no_grad():
        cent = shard.owner_gather(pts, far[:, None], "fps")[:, 0]           # [B, C]
        dist = torch.full((B, shard.n), 1e10, dtype=torch.float32, device=pts.device)
        out = torch.empty((B, num_samples), dtype=torch.int64, device=pts.device)
        for i in range(num_samples):
            out[:, i] = far
            t = pts[..., 0] - cent[:, None, 0]
            d = t * t
            for c in range(1, C):
                t = pts[..., c] - cent[:, None, c]
                d = d + t * t
            dist = torch.minimum(dist, d)
            loc = torch.argmax(dist, dim=-1)
            packed = torch.cat([dist[rows, loc, None].double(), (loc[:, None] + shard.lo).double(),
                                pts[rows, loc].double()], dim=1)
            every = collectives.gather_slots(packed, shard.group, "fps")             # [d, B, 2 + C]
            sel = every[torch.argmax(every[:, :, 0], dim=0), rows]                   # [B, 2 + C]
            far, cent = sel[:, 1].long(), sel[:, 2:].float()
    return out


def sharded_farthest_point_sample(points: torch.Tensor, num_samples: int, mesh: DeviceMesh, *,
                                  axis: str = "points", batch_axis: str | None = None,
                                  start_idx=0) -> torch.Tensor:
    """FPS of ``[B, N, C]`` clouds with N sharded over ``mesh[axis]``,
    from ``start_idx`` (an int or a ``[B]`` tensor of global indices);
    ``[B, S]`` int32 global indices, the same on every rank of the axis.
    ``batch_axis`` names the mesh axis the rows were sharded over, if any."""
    B, N, C = points.shape
    shard = _Shard(mesh, axis, N)
    pts = shard.local(points.detach().to(torch.float32))
    return _fps(shard, pts, int(num_samples), start_idx).to(torch.int32)


def _ball_keys(shard: _Shard, cent: torch.Tensor, pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Squared distances ``[B, S, N/d]`` from every centroid to the block's
    points, as the plain ball query forms them, and the points' global ids."""
    d2 = square_distance(cent.detach(), pts.detach())
    ids = torch.arange(shard.lo, shard.lo + shard.n, device=pts.device)
    return d2, ids


def _merge(shard: _Shard, d2: torch.Tensor, ids: torch.Tensor, radius: float, K: int) -> torch.Tensor:
    """``[B, S, K]`` global indices: the K lowest in-ball ids of all shards,
    empty slots repeating the first, an empty ball N-1."""
    keys = torch.where(d2 <= _radius_sq(radius), ids, shard.N)
    cand = torch.topk(keys, min(K, shard.n), dim=-1, largest=False, sorted=True).values
    every = collectives.gather_slots(cand, shard.group, "grouping")                # [d, B, S, k]
    every = every.permute(1, 2, 0, 3).reshape(*cand.shape[:2], -1)
    idx = torch.topk(every, K, dim=-1, largest=False, sorted=True).values
    idx = torch.where(idx == shard.N, idx[..., :1], idx)
    return idx.clamp(max=shard.N - 1)


def _centroids(shard: _Shard, pts: torch.Tensor, num_centroids: int) -> tuple[torch.Tensor, torch.Tensor]:
    fps_idx = _fps(shard, pts.detach(), num_centroids, 0)
    return fps_idx, shard.owner_gather(pts, fps_idx, "grouping")                 # [B, S, C]


def sharded_sample_and_group(points: torch.Tensor, features: torch.Tensor | None, num_centroids: int,
                             num_neighbors: int, radius: float, mesh: DeviceMesh, *, axis: str = "points",
                             batch_axis: str | None = None):
    """``ops.sample_and_group`` over clouds with N sharded over
    ``mesh[axis]``: the distributed FPS, the centroids by owner gather, the
    ball query on each block and its global merge, the neighbourhoods by
    owner gather. Returns ``(centroids [B, S, C], grouped [B, S, K, C (+D)])``,
    centred coordinates first, the same on every rank of the axis."""
    B, N, C = points.shape
    shard = _Shard(mesh, axis, N)
    pts = shard.local(points)
    _, cent = _centroids(shard, pts, int(num_centroids))
    idx = _merge(shard, *_ball_keys(shard, cent, pts), radius, int(num_neighbors))
    grouped = shard.owner_gather(pts, idx, "grouping") - cent[:, :, None, :]
    if features is not None:
        grouped = torch.cat([grouped, shard.owner_gather(shard.local(features), idx, "grouping")], dim=-1)
    return cent, grouped


def sharded_sample_and_group_multi(points: torch.Tensor, features: torch.Tensor | None, num_centroids: int,
                                   radius_list, num_neighbors_list, mesh: DeviceMesh, *, axis: str = "points",
                                   batch_axis: str | None = None):
    """Multi-scale grouping over a sharded N axis: one distributed FPS and
    one block of distances serve every radius. Returns ``(centroids [B, S,
    C], [grouped_l [B, S, K_l, D + C]])`` in the MSG channel order,
    [features, centred coordinates]."""
    B, N, C = points.shape
    shard = _Shard(mesh, axis, N)
    pts = shard.local(points)
    feats = None if features is None else shard.local(features)
    _, cent = _centroids(shard, pts, int(num_centroids))
    d2, ids = _ball_keys(shard, cent, pts)
    outs = []
    for radius, K in zip(radius_list, num_neighbors_list):
        idx = _merge(shard, d2, ids, float(radius), int(K))
        grouped = shard.owner_gather(pts, idx, "grouping") - cent[:, :, None, :]
        if feats is not None:
            grouped = torch.cat([shard.owner_gather(feats, idx, "grouping"), grouped], dim=-1)
        outs.append(grouped)
    return cent, outs
