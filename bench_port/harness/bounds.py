"""The yardstick's arithmetic: the card's peaks, the least time of the
port's two kernels on given inputs, the matrix-product operations of the
models from their shapes, and the rule that groups device kernels by name.

``fps_bound_ms``, ``scanned_points``, ``ball_query_bound_ms``, the peaks
and the kernel names are frozen copies of ``chip_smoke.py`` at commit
aa745b2; ``group`` is ``scripts/profile_torch_serving.py``'s rule there.
"""

from __future__ import annotations

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM, float32 outside
# the tensor cores, TF32 and bfloat16 on them
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12

# the port's kernels by the name the profiler gives them
FPS_KERNELS = ("fps_register_kernel", "fps_register_spliced_kernel", "fps_dist_kernel", "fps_cluster_kernel")
BALL_QUERY_KERNELS = ("ball_query_kernel",)
MATMUL_MARKS = ("gemm", "Gemm", "sm90_xmma", "cutlass", "addmm")


def group(name: str) -> str:
    """``fps``, ``ball_query``, ``matmul`` or ``other`` for a device kernel."""
    if any(t in name for t in FPS_KERNELS):
        return "fps"
    if any(t in name for t in BALL_QUERY_KERNELS):
        return "ball_query"
    if any(t in name for t in MATMUL_MARKS):
        return "matmul"
    return "other"


def matmul_peak(dtype: str, allow_tf32: bool) -> float:
    """The matrix-product peak of the precision a configuration computes in."""
    if dtype == "bfloat16":
        return BF16_FLOP_PER_S
    return TF32_FLOP_PER_S if allow_tf32 else F32_FLOP_PER_S


def fps_bound_ms(B: int, N: int, C: int, S: int) -> float:
    """Least ms of an FPS of S from N points of C channels in B clouds:
    bytes (the points, the starts and the indices once) or operations
    (sub, mul, add a channel and a min, a sample and a point)."""
    nbytes = 4 * (B * N * C + B + B * S)
    ops = B * S * N * (3 * C + 1)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S)


def scanned_points(points, centroids, radius: float, k: int) -> int:
    """Points a ball scan in index order visits on this data: up to the
    k-th in-ball point, or all N, for each centroid."""
    import torch

    from reference.geometry import radius_sq, square_distance

    N = points.shape[1]
    d2 = square_distance(centroids, points)
    count = torch.cumsum((d2 <= radius_sq(radius)).int(), dim=-1)
    return int(torch.clamp((count < k).sum(-1) + 1, max=N).sum())


def ball_query_bound_ms(points, centroids, radius: float, k: int) -> float:
    """Least ms of a ball query: bytes (points, centroids and indices once)
    or operations (2P a point for its norm; 2P + 2 a scanned pair)."""
    B, N, P = points.shape
    S = centroids.shape[1]
    nbytes = 4 * (B * N * P + B * S * P + B * S * k)
    ops = scanned_points(points, centroids, radius, k) * (2 * P + 2) + B * N * 2 * P
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S)


# --- matrix-product operations, from the models' shapes ----------------------------------

# (centroids, neighbours, radius, input channels, widths) of SSG's two grouping levels
SSG_LEVELS = ((512, 32, 0.2, 3, (64, 64, 128)), (128, 64, 0.4, 128 + 3, (128, 128, 256)))
SSG_GLOBAL = (256 + 3, (256, 512, 1024))
FC = (1024, 512, 256)
POSE_MLP = (64, 64, 64, 128, 1024)
POSE_OUT = {"rotation": 3, "sign": 1, "translation": 3, "width": 1}


def _chain(rows: int, widths) -> list[tuple[int, int, int]]:
    """(rows, in, out) of each Linear of a stack over ``rows`` rows."""
    return [(rows, a, b) for a, b in zip(widths[:-1], widths[1:])]


def ssg_layers(num_classes: int = 7) -> list[tuple[int, int, int]]:
    """PointNet++ SSG's Linear layers of one cloud: SA1, SA2, the global
    level over SA2's 128 centroids, the FC head. N does not enter: each
    level groups a fixed number of points."""
    out = []
    for S, K, _, cin, mlp in SSG_LEVELS:
        out += _chain(S * K, (cin, *mlp))
    out += _chain(SSG_LEVELS[-1][0], (SSG_GLOBAL[0], *SSG_GLOBAL[1]))
    return out + _chain(1, (*FC, num_classes))


def pose_layers(head: str, num_points: int, num_classes: int = 7) -> list[tuple[int, int, int]]:
    """A PointNet pose head's Linear layers of one cloud of ``num_points``
    spliced points; the translation head's centroid MLP too."""
    out = _chain(num_points, (3 + num_classes, *POSE_MLP)) + _chain(1, (*FC, POSE_OUT[head]))
    return out + (_chain(1, (3, 6, 3)) if head == "translation" else [])


def forward_flops(layers) -> int:
    return sum(2 * r * a * b for r, a, b in layers)


def grasp_flops_per_cluster(num_points: int = 1024, num_classes: int = 7) -> int:
    """A grasp request's matrix-product operations a cluster: the classifier
    and the four heads, forward."""
    total = forward_flops(ssg_layers(num_classes))
    return total + sum(forward_flops(pose_layers(h, num_points, num_classes)) for h in POSE_OUT)


def ssg_train_flops_per_cloud(num_classes: int = 7) -> int:
    """Forward and backward of PointNet++ SSG a cloud: each Linear's
    forward, its weight gradient and its input gradient, but for the input
    gradient of SA1's first layer, whose input (the grouped coordinates)
    takes none."""
    layers = ssg_layers(num_classes)
    first = layers[0]
    return 3 * forward_flops(layers) - forward_flops([first])


def mfu(flops: float, seconds: float, peak: float) -> float | None:
    """Percent of ``peak`` that ``flops`` in ``seconds`` reach."""
    if seconds <= 0:
        return None
    return 100.0 * flops / seconds / peak
