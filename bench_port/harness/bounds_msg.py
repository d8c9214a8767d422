"""The yardstick's arithmetic for requests whose models a configuration
names: the matrix-product operations of each registry model of a grasp
request (the MSG classifier and MSG heads beside ``bounds.py``'s SSG
classifier and PointNet heads), and the least time of the multi-scale
ball query.

The multi-scale call (``kernels/csrc/ball_group.cu``) forms one distance a
(centroid, point) pair, in index order, with one compare a scale, and a
warp leaves the scan once every scale of its centroids holds its K. Its
least time is the larger of its bytes once (points, centroids, indices) at
the HBM peak and its operations at the f32 peak: 2P a point for its norm,
and for each pair the scan visits before every scale of its centroid holds
its K (or all N), P multiplies and P + 1 adds for the distance and one
compare a scale. At one scale that is ``bounds.ball_query_bound_ms``.
"""

from __future__ import annotations

from harness import bounds
from harness.bounds import FC, _chain, forward_flops
from reference.msg import GLOBAL, SA1, SA2


def _msg_level(level, in_channels: int) -> list[tuple[int, int, int]]:
    S, ks, _, mlps = level
    out = []
    for k, widths in zip(ks, mlps):
        out += _chain(S * k, (in_channels, *widths))
    return out


def _out(level) -> int:
    return sum(w[-1] for w in level[3])


def cls_msg_layers(num_classes: int = 7) -> list[tuple[int, int, int]]:
    """PointNet++ MSG's Linear layers of one cloud: SA-MSG 1 and 2 (each
    scale's stack over its S * K rows), the global level over SA-MSG 2's
    128 centroids, the FC head."""
    out = _msg_level(SA1, 3) + _msg_level(SA2, _out(SA1) + 3)
    out += _chain(SA2[0], (_out(SA2) + 3, *GLOBAL))
    return out + _chain(1, (*FC, num_classes))


def msg_head_layers(levels: int, out_dim: int, mean_residual: bool,
                    num_classes: int = 7) -> list[tuple[int, int, int]]:
    """An MSG pose head's Linear layers of one spliced cloud: SA-MSG 1, SA-MSG
    2 where ``levels`` is 3, the global level, the FC head, the centroid MLP."""
    c = 3 + num_classes
    out = _msg_level(SA1, c)
    last, below = SA1, _out(SA1)
    if levels == 3:
        out += _msg_level(SA2, below + c)
        last, below = SA2, _out(SA2)
    out += _chain(last[0], (below + c, *GLOBAL)) + _chain(1, (*FC, out_dim))
    return out + (_chain(1, (3, 6, 3)) if mean_residual else [])


def model_layers(name: str, num_points: int = 1024, num_classes: int = 7) -> list[tuple[int, int, int]]:
    """(rows, in, out) of each Linear layer of the registry model ``name``
    on one cluster of ``num_points`` points."""
    if name == "pointnet2_cls_ssg":
        return bounds.ssg_layers(num_classes)
    if name == "pointnet2_cls_msg":
        return cls_msg_layers(num_classes)
    if name in bounds.POSE_OUT:
        return bounds.pose_layers(name, num_points, num_classes)
    heads = {"rotation_msg": (3, 3, False), "sign_msg": (2, 1, False), "translation_msg": (2, 3, True)}
    if name in heads:
        return msg_head_layers(*heads[name], num_classes=num_classes)
    raise KeyError(f"no FLOP count for model {name!r}")


def request_flops_per_cluster(names: dict, num_points: int = 1024, num_classes: int = 7) -> int:
    """A grasp request's matrix-product operations a cluster, forward, for
    the models ``names`` gives by key."""
    return sum(forward_flops(model_layers(n, num_points, num_classes)) for n in names.values())


def scanned_pairs(points, centroids, radii, ks) -> int:
    """Pairs a multi-scale scan in index order visits on this data: for each
    centroid, up to the point at which its last scale holds its K, or all N."""
    import torch

    from reference.geometry import radius_sq, square_distance

    N = points.shape[1]
    d2 = square_distance(centroids, points)
    need = None
    for radius, k in zip(radii, ks):
        count = torch.cumsum((d2 <= radius_sq(radius)).int(), dim=-1)
        n = torch.clamp((count < k).sum(-1) + 1, max=N)
        need = n if need is None else torch.maximum(need, n)
    return int(need.sum())


def ball_query_multi_bound_ms(points, centroids, radii, ks) -> float:
    """Least ms of one multi-scale ball query (module docstring)."""
    B, N, P = points.shape
    S = centroids.shape[1]
    nbytes = 4 * (B * N * P + B * S * P + B * S * sum(ks))
    ops = scanned_pairs(points, centroids, radii, ks) * (2 * P + 1 + len(ks)) + B * N * 2 * P
    return 1e3 * max(nbytes / bounds.HBM_BYTES_PER_S, ops / bounds.F32_FLOP_PER_S)
