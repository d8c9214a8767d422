"""What the port's kernel wrappers decide in Python before a launch, on the
CPU: the fused-SA launch plan (rows per chunk, centroids per block, shared
bytes), the FPS plan (threads, points per thread; register, shared, cluster
or global path) and the FPS calls the registry's models make, the
attention pass's constants and the attention calls of Point Transformer,
and the three-product TF32 arithmetic that the fused-SA kernel runs on the
tensor cores, spelled in plain PyTorch beside the wrapper."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import fps as fps_module
from pointnet_like_pose_estimation_tpu_torch.kernels import fused_sa
from pointnet_like_pose_estimation_tpu_torch.kernels import pt_attention as attention_kernel
from pointnet_like_pose_estimation_tpu_torch.kernels.fps import (
    CLUSTER_BLOCKS,
    CLUSTER_PATH,
    CLUSTER_SMALL_SLICE,
    GLOBAL_PATH,
    MAX_CLUSTER_POINTS,
    MAX_REGISTER_POINTS,
    MAX_SHARED_POINTS,
    MAX_SLICE_POINTS,
    REGISTER_CHANNELS,
    SHARED_PATH,
    SMS,
    fps_plan,
)
from pointnet_like_pose_estimation_tpu_torch.kernels.fused_sa import (
    MAX_SHARED_BYTES,
    launch_plan,
    matmul_3xtf32,
    tf32_split,
)
from pointnet_like_pose_estimation_tpu_torch.models import MODEL_REGISTRY, build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.nn import point_transformer as pt_layers
from pointnet_like_pose_estimation_tpu_torch.train.config import TrainConfig

CSRC = Path(fused_sa.__file__).resolve().parent / "csrc"
SSG_SA1 = (3, (32,), ((64, 64, 128),))
SSG_SA2 = (131, (64,), ((128, 128, 256),))
MSG_SA1 = (3, (16, 32, 128), ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
MSG_SA2 = (323, (32, 64, 128), ((64, 64, 128), (128, 128, 256), (128, 128, 256)))


@pytest.mark.parametrize(
    "P,ks,widths,rows,centroids",
    [
        (*SSG_SA1, 128, 16),     # 4 centroids fill a chunk; 4 chunks a block
        (*SSG_SA2, 128, 8),
        (*MSG_SA1, 128, 8),      # 24 (centroid, scale) pairs already keep 16 warps selecting
        (*MSG_SA2, 64, 8),       # 128 rows of 323 channels do not fit beside the rest
        (7, (20, 50), ((16, 24), (40, 8)), 128, 8),    # K = 20 pads to 32 rows
        (3, (20,), ((8,),), 128, 16),
        (3, (128,), ((64, 64, 128),), 128, 4),         # one centroid fills a chunk
        (3, (200,), ((64, 64, 128),), 128, 4),         # and one overflows it
        (11, (16,), ((16, 16, 32),), 128, 16),
    ],
    ids=["ssg_sa1", "ssg_sa2", "msg_sa1", "msg_sa2", "odd_k", "tiny", "k128", "k200", "cpu_test"],
)
def test_fused_sa_launch_plan(P, ks, widths, rows, centroids):
    got_rows, got_centroids, nbytes = launch_plan(P, ks, widths)
    assert (got_rows, got_centroids) == (rows, centroids)
    assert 0 < nbytes <= MAX_SHARED_BYTES <= 227 * 1024
    # a chunk holds whole 16-row MMA tiles of one centroid each
    assert rows % 16 == 0 and centroids >= 1
    # the buffers alone, at the pitch the kernel uses, are inside the figure
    assert nbytes > 4 * rows * (-(-max(P, 4) // 8) * 8 + 4)


@pytest.mark.parametrize(
    "shape",
    [SSG_SA1, SSG_SA2, MSG_SA1, MSG_SA2, (7, (20, 50), ((16, 24), (40, 8))),
     (3, (128,), ((64, 64, 128),)), (11, (16,), ((16, 16, 32),))],
    ids=["ssg_sa1", "ssg_sa2", "msg_sa1", "msg_sa2", "odd_k", "k128", "cpu_test"],
)
def test_fused_sa_plan_fills_chunks_and_warps(shape):
    """A block's centroids fill whole chunks at the smallest K, and its
    (centroid, scale) pairs keep the 16 warps selecting unless that would
    take more than four chunks of the smallest K."""
    _, ks, _ = shape
    rows, centroids, _ = launch_plan(*shape)
    kp_min = min(-(-k // 16) * 16 for k in ks)
    base = max(1, rows // kp_min)
    assert centroids % base == 0 and centroids // base in (1, 2, 4)
    assert centroids * len(ks) >= fused_sa._WARPS or centroids == 4 * base
    # three threads a centroid load the centroids: the kernel's own limit
    assert 3 * centroids <= 32 * fused_sa._WARPS


def test_fused_sa_plan_is_the_same_for_a_ragged_last_tile():
    """S does not enter the plan: the last block of a cloud repeats the last
    centroid and masks its stores."""
    rows, centroids, _ = launch_plan(*MSG_SA1)
    assert 509 % centroids != 0 and 127 % launch_plan(*SSG_SA2)[1] != 0
    assert -(-509 // centroids) == 64       # blocks a cloud, the last one ragged


@pytest.mark.parametrize(
    "P,ks,widths",
    [(1700, (8,), ((8, 16),)), (323, (32,), ((512, 512, 512),)), (600, (64,), ((128, 128, 256),))],
)
def test_fused_sa_plan_refuses_what_cannot_fit(P, ks, widths):
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(P, ks, widths)


def test_fused_sa_refuses_widths_off_the_mma_tile():
    with pytest.raises(ValueError, match="multiples of 8"):
        launch_plan(3, (4,), ((12,),))


def _cpu_case(P, ks, widths, N=24, S=5, B=2, seed=0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1, 1, (B, N, P)).astype(np.float32))
    weights = []
    for ws in widths:
        cin = P
        for cout in ws:
            weights += [rng.standard_normal((cin, cout)) / np.sqrt(cin), 0.1 * rng.standard_normal(cout)]
            cin = cout
    weights = [torch.from_numpy(w.astype(np.float32)) for w in weights]
    return pts, pts[:, :S, :3].contiguous(), weights, tuple(0.6 + 0.2 * i for i in range(len(ks))), ks, widths


@pytest.mark.parametrize(
    "P,ks,widths,refusal",
    [
        (3, (4,), ((12,),), "multiples of 8"),
        (5, (3, 6), ((5, 7), (9,)), "multiples of 8"),
        (1700, (8,), ((8, 16),), "shared memory"),
        (323, (4,), ((512, 512, 512),), "shared memory"),
    ],
    ids=["width_12", "odd_widths", "wide_rows", "wide_layers"],
)
def test_fused_sa_cpu_tensor_takes_what_only_the_kernel_refuses(P, ks, widths, refusal):
    """The MMA-tile and shared-memory limits are the CUDA kernel's: a CPU
    tensor takes the plain version whatever the widths."""
    with pytest.raises(ValueError, match=refusal):
        launch_plan(P, ks, widths)
    args = _cpu_case(P, ks, widths)
    idx = torch.empty((2, 5, sum(ks)), dtype=torch.int32)
    got = fused_sa.fused_sa_infer(*args, idx_out=idx)
    assert got.shape == (2, 5, sum(ws[-1] for ws in widths))
    assert torch.equal(got, fused_sa.fused_sa_reference(*args))
    assert torch.equal(idx, fused_sa.ball_query_reference(args[0][..., :3], args[1], args[3], ks))


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (-?\d+);", source)
    assert m, name
    return int(m.group(1))


def test_python_mirrors_the_kernel_constants():
    """The plan and the kernel compute shared memory from one formula; the
    constants it uses are spelled in both places."""
    cu = (CSRC / "fused_sa.cu").read_text()
    ring = _constant(cu, "kStages") * _constant(cu, "kSliceRows") * (_constant(cu, "kChunkCols") + 8)
    assert fused_sa._RING_FLOATS == ring
    assert "227 * 1024 - 1024" in cu and MAX_SHARED_BYTES == 227 * 1024 - 1024
    assert fused_sa.MAX_SCALES == _constant(cu, "kMaxScales")
    assert fused_sa.MAX_LAYERS == _constant(cu, "kMaxLayers")
    assert fused_sa._WARPS * 32 == _constant(cu, "kThreads")
    fps_cu = (CSRC / "fps.cu").read_text()
    assert MAX_REGISTER_POINTS == (_constant(fps_cu, "kRegisterThreads")
                                   * _constant(fps_cu, "kMaxPointsPerThread"))
    assert REGISTER_CHANNELS == (_constant(fps_cu, "kCloudChannels"), _constant(fps_cu, "kSplicedChannels"))
    assert SHARED_PATH == _constant(fps_cu, "kSharedPath")
    assert GLOBAL_PATH == _constant(fps_cu, "kGlobalPath")
    assert CLUSTER_PATH == _constant(fps_cu, "kClusterPath")
    assert fps_plan(MAX_CLUSTER_POINTS, C=6)[0] <= _constant(fps_cu, "kAnyChannelThreads")
    # a block's dynamic shared memory, and a cluster block's less its inbox
    assert "constexpr int kMaxSharedBytes = 227 * 1024 - 1024;" in fps_cu
    assert MAX_SHARED_POINTS * 4 == 227 * 1024 - 1024
    inbox = 2 * _constant(fps_cu, "kMaxClusterBlocks") * (2 + _constant(fps_cu, "kMaxChannels")) * 4
    assert "kMaxSliceBytes = kMaxSharedBytes - 2 * kMaxClusterBlocks * (2 + kMaxChannels) * 4;" in fps_cu
    assert MAX_SLICE_POINTS == (227 * 1024 - 1024 - inbox) // 4
    assert 2 <= CLUSTER_BLOCKS <= _constant(fps_cu, "kMaxClusterBlocks")


def test_pt_attention_mirrors_the_kernel_constants():
    """The attention pass's plan and kernel compute the tile and its shared
    memory by one rule; the constants it uses are spelled in both places."""
    cu = (CSRC / "pt_attention.cu").read_text()
    for name, value in [("kThreads", "THREADS"), ("kTileElements", "TILE_ELEMENTS"), ("kMaxC", "MAX_C"),
                        ("kMaxPlanes", "MAX_PLANES"), ("kMaxK", "MAX_K"), ("kPad", "PAD"),
                        ("kPosFloats", "POS_FLOATS")]:
        assert _constant(cu, name) == getattr(attention_kernel, value), name
    assert "constexpr int kMaxSharedBytes = 227 * 1024;" in cu and attention_kernel.MAX_SHARED_BYTES == 227 * 1024


@pytest.mark.parametrize("N", [1024, 2048])
def test_point_transformer_attention_calls_fit_the_plan(N, monkeypatch):
    """A forward of ``point_transformer_cls`` at full width on the CPU, with
    ``attention_reason`` recording each attention call: 13 calls at the
    request's 1024 points, one layer at the first stage, 2, 3, 5 and 2
    after, and the kernel's plan takes every one, at one cloud and at
    32; at 2048 points too."""
    calls = []
    reason = pt_layers.attention_reason

    def recording(attn, x, idx, bn2):
        calls.append((*idx.shape[1:], attn.channels))
        return reason(attn, x, idx, bn2)

    monkeypatch.setattr(pt_layers, "attention_reason", recording)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, N, 3)).astype(np.float32))
    with torch.no_grad():
        build_model("point_transformer_cls").eval()(x)
    stages = [(N, 8, 32)] + [(N // 4**s, min(16, N // 4**s), 32 * 2**s) for s in range(1, 5)]
    assert calls == [shape for shape, n in zip(stages, (1, 2, 3, 5, 2)) for _ in range(n)]
    for n, k, c in calls:
        for B in (1, 32):
            plan = attention_kernel.pt_attention_plan(B, n, k, c, 8)
            assert plan.shared_bytes <= attention_kernel.MAX_SHARED_BYTES and plan.tile * k * c <= 8192


@pytest.mark.parametrize(
    "N,threads,points_per_thread",
    [
        (100, 128, 1),
        (512, 256, 2),
        (1024, 256, 4),
        (2048, 256, 8),
        (3000, 512, 8),
        (4096, 512, 8),
        (4097, 1024, 0),          # above the register path, for many clouds: distances in shared memory
        (MAX_SHARED_POINTS, 1024, 0),
        (MAX_SHARED_POINTS + 1, 512, -2),      # above shared memory: one cloud over a cluster
        (300_000, 1024, -2),      # a near object of a 640x480 frame: 1024 threads for its large slices
        (MAX_CLUSTER_POINTS, 1024, -2),        # the largest cloud the cluster holds
        (MAX_CLUSTER_POINTS + 1, 1024, -1),    # above it: distances in device memory
    ],
)
def test_fps_plan(N, threads, points_per_thread):
    assert fps_plan(N, B=64) == (threads, points_per_thread)
    assert threads % 32 == 0 and threads <= 1024
    if points_per_thread > 0:
        assert points_per_thread in (1, 2, 4, 8) and threads * points_per_thread >= N
        assert threads <= 512             # the register kernel's launch bound
    elif points_per_thread == SHARED_PATH:
        assert 4 * N <= 227 * 1024 - 1024
    elif points_per_thread == CLUSTER_PATH:
        assert 4 * N > 227 * 1024 - 1024 and -(-N // CLUSTER_BLOCKS) <= MAX_SLICE_POINTS
    else:
        assert points_per_thread == GLOBAL_PATH and -(-N // CLUSTER_BLOCKS) > MAX_SLICE_POINTS


@pytest.mark.parametrize("N", [1, 31, 33, 129, 257, 513, 1025, 2049])
def test_fps_register_plan_covers_every_size(N):
    threads, points_per_thread = fps_plan(N)
    assert points_per_thread > 0 and threads * points_per_thread >= N
    assert threads * points_per_thread < max(4 * N, 64)     # no thread block mostly idle


def test_fps_plan_other_channel_counts_take_the_shared_path():
    """Where each channel count goes: 3 and 10 (a pose head's spliced
    cloud) have register-path instances; every other C takes the shared
    path below shared memory, and every C takes the cluster path above it."""
    for C in range(1, 17):
        want = (256, 2) if C in (3, 10) else (1024, SHARED_PATH)
        assert fps_plan(512, C=C, B=32) == want, C
        assert fps_plan(5000, C=C, B=32) == (1024, SHARED_PATH), C
        assert fps_plan(70_000, C=C, B=32) == (512, CLUSTER_PATH), C
        # slices above 8192 points: 1024 threads a block, but 512 for the any-C instance
        assert fps_plan(300_000, C=C) == (1024 if C in (3, 10) else 512, CLUSTER_PATH), C
        assert fps_plan(MAX_CLUSTER_POINTS + 1, C=C) == (1024, GLOBAL_PATH), C


@pytest.mark.parametrize("N,points_per_thread", [(512, 2), (1024, 4), (2048, 8), (4096, 8)])
def test_fps_plan_spliced_channels_take_the_register_path(N, points_per_thread):
    """C = 10, a pose head's SA1 and SA2 (1024 and 512 points): the register
    path, 8 points a thread at most (88 floats of state a thread)."""
    threads, ppt = fps_plan(N, C=10, B=32)
    assert (ppt, threads * ppt >= N, threads <= 512) == (points_per_thread, True, True)


@pytest.mark.parametrize(
    "N,B,plan",
    [
        (4096, 1, (512, 8)),                  # the register path holds it
        (4097, 1, (512, CLUSTER_PATH)),       # one cloud: 16 blocks of 257 points
        (5000, 8, (512, CLUSTER_PATH)),       # 8 clusters of 16 blocks fit on 132 SMs
        (5000, 9, (1024, SHARED_PATH)),       # 9 do not
        (20_000, 2, (512, CLUSTER_PATH)),
        (MAX_SHARED_POINTS, 1, (512, CLUSTER_PATH)),
        (16 * CLUSTER_SMALL_SLICE, 1, (512, CLUSTER_PATH)),
        (16 * CLUSTER_SMALL_SLICE + 1, 1, (1024, CLUSTER_PATH)),    # slices above 8192 points
        (MAX_SHARED_POINTS + 1, 64, (512, CLUSTER_PATH)),            # above shared memory: any B
    ],
)
def test_fps_plan_few_clouds_take_the_cluster_path(N, B, plan):
    """Below shared memory the cluster path serves as few clouds as whole
    clusters fit on the card's SMs at once (measured faster than the shared
    path there, PERF.md)."""
    assert CLUSTER_BLOCKS * 8 <= SMS < CLUSTER_BLOCKS * 9
    assert fps_plan(N, C=3, B=B) == plan
    # C = 6 has no register path, and the cluster path's any-C instance takes 512 threads
    want = (512, CLUSTER_PATH) if plan[1] == CLUSTER_PATH else (1024, SHARED_PATH)
    assert fps_plan(N, C=6, B=B) == want


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_registry_fps_calls_take_a_register_path(name, monkeypatch):
    """A forward of each registry model at full width (the configured 1024
    points, published widths) on the CPU, with ``fps_reference`` recording
    the ``(N, C)`` of each FPS call: the card's plan puts every one on the
    register path, whatever the batch."""
    calls = []
    reference = fps_module.fps_reference

    def recording(points, num_samples, start_idx=0):
        calls.append(tuple(points.shape[1:]))
        return reference(points, num_samples, start_idx)

    monkeypatch.setattr(fps_module, "fps_reference", recording)
    spec = get_model_spec(name)
    N, K = TrainConfig().num_points, 7
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, N, 3)).astype(np.float32))
    if spec.input_kind == "xyz":
        args = (x,)
    else:
        spliced = torch.cat([x, torch.nn.functional.one_hot(torch.tensor([1, 4]), K)[:, None]
                             .expand(2, N, K).float()], -1)
        args = (spliced, torch.zeros(2, 3)) if spec.input_kind == "spliced_mean" else (spliced,)
    model = build_model(name, K).eval()
    with torch.no_grad():
        model(*args)
    # the set abstractions sample by FPS, and so do Point Transformer's strided TransitionDowns
    has_sa = "ssg" in name or "msg" in name or name == "point_transformer_cls"
    assert bool(calls) == has_sa, calls
    for n, c in calls:
        assert c in REGISTER_CHANNELS and n <= MAX_REGISTER_POINTS, (n, c)
        for B in (1, 32, 256):
            assert fps_plan(n, c, B)[1] in (1, 2, 4, 8), (n, c, B)


@pytest.mark.parametrize("N", [0, -1])
def test_fps_plan_refuses_what_no_path_holds(N):
    with pytest.raises(ValueError, match="outside"):
        fps_plan(N)


def test_tf32_split_restores_the_operand():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(1 << 16) * 10.0 ** rng.uniform(-6, 6, 1 << 16))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    # both halves are TF32 values: the low 13 mantissa bits are clear
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.abs().double()).max()) <= 2.0 ** -20


def test_three_product_mlp_stays_near_the_f32_product():
    """MSG SA2's widest scale, 323 -> 128 -> 128 -> 256 over 128 rows: the
    compensated product stays within 1e-5 of the float32 one, where a single
    TF32 product does not."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.abs(rng.standard_normal((128, 323))).astype(np.float32))
    want, got, single = x, x, x
    for cin, cout in ((323, 128), (128, 128), (128, 256)):
        w = torch.from_numpy((rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32))
        b = torch.from_numpy((0.1 * rng.standard_normal(cout)).astype(np.float32))
        want = torch.relu(want @ w + b)
        got = torch.relu(matmul_3xtf32(got, w) + b)
        single = torch.relu(tf32_split(single)[0] @ tf32_split(w)[0] + b)
    assert float((got - want).abs().max()) <= 1e-5
    assert float((single - want).abs().max()) > 1e-4
