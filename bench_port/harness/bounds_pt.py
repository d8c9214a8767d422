"""The yardstick's arithmetic for a grasp request whose classifier is Point
Transformer (``reference/point_transformer.py``): the classifier's
matrix-product operations from its shapes, the request's beside the heads'
(``bounds_msg.model_layers``), the least time of the kNN query, and the
shapes of the FPS and kNN calls a request makes.

The kNN query (``kernels/csrc/knn.cu``) forms one squared distance a
(query, point) pair and keeps the k smallest: 3 subtractions, 3
multiplies, 2 adds and a compare, 9 operations a pair, every pair
visited. Its least time is the larger of its bytes once (float32 points
and queries, int64 indices) at the HBM peak and its operations at the
float32 peak.
"""

from __future__ import annotations

from harness import bounds, bounds_msg
from harness.bounds import _chain, forward_flops
from reference.point_transformer import BLOCKS, FC, NAME, NSAMPLE, PLANES, SHARE_PLANES, STRIDES


def stages(num_points: int = 1024) -> list[tuple[int, int, int, int, int, int]]:
    """``(points in, points out, channels in, channels, stride, k_eff)`` of
    each stage on one cloud of ``num_points`` points; ``k_eff`` is
    ``min(nsample, points out)``, the neighbours of its blocks (and of its
    TransitionDown, ``min(nsample, points in)``, where it strides)."""
    out, n, cin = [], num_points, 3
    for c, stride, k in zip(PLANES, STRIDES, NSAMPLE):
        m = n // stride
        out.append((n, m, cin, c, stride, min(k, m)))
        n, cin = m, c
    return out


def pt_layers(num_points: int = 1024, num_classes: int = 7) -> list[tuple[int, int, int]]:
    """(rows, in, out) of each Linear of Point Transformer on one cloud:
    each stage's TransitionDown (stride 1 over its points; stride 4 over
    its centroids' ``min(nsample, N)`` neighbours, with 3 coordinates more),
    then per block linear1, q, k, v, the position MLP (3 -> 3 -> C) and the
    weight MLP (C -> C/8 -> C/8) over each point's ``k_eff`` neighbours,
    linear3; the FC head."""
    out = []
    for (n, m, cin, c, stride, k), blocks, nsample in zip(stages(num_points), BLOCKS, NSAMPLE):
        out += [(n, cin, c)] if stride == 1 else [(m * min(nsample, n), cin + 3, c)]
        c8 = c // SHARE_PLANES
        for _ in range(blocks - 1):
            out += [(m, c, c)] * 4 + _chain(m * k, (3, 3, c)) + _chain(m * k, (c, c8, c8)) + [(m, c, c)]
    return out + _chain(1, (PLANES[-1], *FC, num_classes))


def request_flops_per_cluster(names: dict, num_points: int = 1024, num_classes: int = 7) -> int:
    """A grasp request's matrix-product operations a cluster, forward, for
    the models ``names`` gives by key."""
    total = 0
    for name in names.values():
        layers = pt_layers(num_points, num_classes) if name == NAME else \
            bounds_msg.model_layers(name, num_points, num_classes)
        total += forward_flops(layers)
    return total


def knn_bound_ms(B: int, N: int, S: int, k: int) -> float:
    """Least ms of a kNN query of S queries among N points in B clouds
    (module docstring)."""
    nbytes = 4 * (B * N * 3 + B * S * 3) + 8 * B * S * k
    ops = 9 * B * S * N
    return 1e3 * max(nbytes / bounds.HBM_BYTES_PER_S, ops / bounds.F32_FLOP_PER_S)


def knn_calls(num_points: int = 1024) -> list[tuple[int, int, int]]:
    """``(N, S, k)`` of each kNN query of a forward on one cloud: a strided
    stage's TransitionDown (its centroids among the points before), then
    every stage's own points among themselves."""
    out = []
    for (n, m, _, _, stride, k), nsample in zip(stages(num_points), NSAMPLE):
        if stride > 1:
            out.append((n, m, min(nsample, n)))
        out.append((m, m, k))
    return out


def fps_calls(num_points: int = 1024) -> list[tuple[int, int]]:
    """``(N, S)`` of each FPS of a forward on one cloud: the strided
    TransitionDowns."""
    return [(n, m) for n, m, _, _, stride, _ in stages(num_points) if stride > 1]


def request_bounds_s(K: int, M: int, num_points: int = 1024) -> tuple[float, float]:
    """(FPS, kNN) least device seconds of one request of K clusters of M
    points (its bucket's shapes): the resampling FPS where M is larger
    than ``num_points``, the four strided FPS and the nine kNN queries."""
    fps_ms = bounds.fps_bound_ms(K, M, 3, num_points) if M > num_points else 0.0
    fps_ms += sum(bounds.fps_bound_ms(K, n, 3, s) for n, s in fps_calls(num_points))
    knn_ms = sum(knn_bound_ms(K, n, s, k) for n, s, k in knn_calls(num_points))
    return fps_ms / 1e3, knn_ms / 1e3
