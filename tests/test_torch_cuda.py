"""The port's CUDA kernels on the card against their plain versions, and
the serving path, the fused-SA executors and the train step on the card
against the same code on the CPU, and a data-parallel step at world size 1
against the single step. Skipped
where there is no card. The machine with the card has no JAX, which
tests/conftest.py imports, so run them there with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``."""

import os

import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import (
    ball_query_multi,
    ball_query_reference,
)
from pointnet_like_pose_estimation_tpu_torch.kernels.bn_relu import (
    bn_relu,
    bn_relu_eval,
    bn_relu_eval_gather,
    bn_relu_eval_pool,
    bn_relu_pool_plan,
    eval_gather_reference,
    plain_bn_relu,
    plain_bn_relu_eval,
)
from pointnet_like_pose_estimation_tpu_torch.kernels.fps import (
    CLUSTER_BLOCKS,
    CLUSTER_PATH,
    MAX_CLUSTER_POINTS,
    fps,
    fps_plan,
    fps_reference,
)
from pointnet_like_pose_estimation_tpu_torch.kernels.fused_sa import (
    fused_sa_infer,
    fused_sa_reference,
    matmul_3xtf32,
    mma_tile_selftest,
)

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _clouds(B, N, seed):
    x = np.random.default_rng(seed).standard_normal((B, N, 3)).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    return torch.from_numpy(x / np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None])


@pytest.mark.parametrize(
    "B,N,C,S",
    [
        (3, 100, 3, 200),      # 1 point a thread, S > N
        (2, 200, 3, 64),       # 2 points a thread, 128 threads
        (4, 512, 3, 128),      # 2 points a thread, 256 threads
        (2, 1000, 3, 512),     # 4 points a thread, N no multiple of 32
        (4, 1024, 3, 512),
        (2, 2048, 3, 1024),    # 8 points a thread, 256 threads
        (2, 3000, 3, 1024),    # 8 points a thread, 512 threads, ragged
        (2, 5000, 3, 256),     # above the register path: distances in shared memory
        (2, 777, 6, 128),      # C other than 3 and 10 takes the shared path
        (3, 1024, 10, 512),    # a pose head's SA1: the spliced cloud's 10 channels, register path
        (3, 512, 10, 128),     # a pose head's SA2
        (2, 2048, 10, 1024),   # C = 10, 8 points a thread
        (2, 4096, 10, 256),    # C = 10, 512 threads of 8 points, the register path's largest cloud
        (2, 57_857, 3, 128),   # above shared memory: one cloud over a thread-block cluster
        (1, 70_000, 10, 64),   # the cluster path at the spliced cloud's 10 channels
        (2, 100_003, 3, 128),  # ragged: N no multiple of the cluster's blocks or threads
        (1, 200_001, 6, 64),   # the cluster path's any-C instance (512 threads a block)
        (1, 300_000, 3, 512),  # a near object of a 640x480 frame
        (1, MAX_CLUSTER_POINTS + 1, 3, 16),  # above the cluster: distances in device memory
    ],
)
def test_fps_kernel_matches_plain_version(card, B, N, C, S):
    rng = np.random.default_rng(0)
    pts = torch.cat([_clouds(B, N, 0), torch.from_numpy(
        rng.standard_normal((B, N, C - 3)).astype(np.float32))], dim=-1).to(card)
    start = torch.arange(B, dtype=torch.int32, device=card) * 7 % N
    got = fps(pts, S, start)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_reference(pts, S, start))


def test_fps_cluster_ties_across_slices(card):
    """A tiled cloud above shared memory: each point's duplicates lie in
    other blocks' slices, so the maxima tie across the cluster and the
    lowest index must win; past the 700 distinct points every distance is 0
    and index 0 wins each step."""
    N = 60_000 * 3 + 7
    assert fps_plan(N) == (1024, CLUSTER_PATH) and -(-N // CLUSTER_BLOCKS) < 60_000
    pts = _clouds(2, 700, 6).repeat(1, -(-N // 700), 1)[:, :N].contiguous().to(card)
    got = fps(pts, 800, 3)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_reference(pts, 800, 3))
    assert int(got[:, :700].max()) < 700 and int(got[:, 700:].max()) == 0


def test_fps_cluster_start_in_the_last_slice(card):
    """Per-cloud starts in the last block's slice: its last point and its
    first, on a ragged cloud."""
    N = MAX_CLUSTER_POINTS - 12_345
    pts = _clouds(2, N, 7).to(card)
    first_of_last = (CLUSTER_BLOCKS - 1) * -(-N // CLUSTER_BLOCKS)
    start = torch.tensor([N - 1, first_of_last], dtype=torch.int32, device=card)
    got = fps(pts, 96, start)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_reference(pts, 96, start))
    assert torch.equal(got[:, 0], start)


@pytest.mark.parametrize("M,reps", [(40, 4), (300, 4), (700, 8)])
def test_fps_kernel_ties_take_the_lowest_index(card, M, reps):
    """A tiled cloud holds exact duplicates, so the argmax ties across
    threads and warps; the first index must win, on both paths."""
    pts = _clouds(2, M, 5).repeat(1, reps, 1).to(card)
    got = fps(pts, M + 8, 3)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_reference(pts, M + 8, 3))
    assert int(got[:, :M].max()) < M


@pytest.mark.parametrize(
    "radii,ks", [((0.2,), (32,)), ((0.1, 0.2, 0.4), (16, 32, 128)), ((0.05,), (64,))]
)
def test_ball_query_kernel_matches_plain_version(card, radii, ks):
    pts = _clouds(2, 1024, 1).to(card)
    cent = torch.cat([pts[:, ::4], torch.full((2, 8, 3), 9.0, device=card)], dim=1)
    got = ball_query_multi(pts, cent, radii, ks)
    torch.cuda.synchronize()
    assert torch.equal(got, ball_query_reference(pts, cent, radii, ks))


def test_normalize_cloud_is_the_same_on_the_card_and_the_cpu(card):
    """FPS and ball-query selections turn on the last bit of the normalised
    cloud, so the card's must equal the CPU's exactly."""
    from pointnet_like_pose_estimation_tpu_torch.ops import normalize_cloud

    x = _clouds(8, 1024, 9) * 0.07 + torch.tensor([0.3, -0.2, 0.5])
    assert torch.equal(normalize_cloud(x.to(card)).cpu(), normalize_cloud(x))


def _spliced(B, N, P, seed):
    """Unit clouds with a one-hot class, one per cloud, on the channels
    after the coordinates (the pose heads' input)."""
    x = _clouds(B, N, seed)
    if P == 3:
        return x
    onehot = torch.zeros(B, N, P - 3)
    onehot[torch.arange(B), :, torch.arange(B) % (P - 3)] = 1.0
    return torch.cat([x, onehot], dim=-1)


_MSG1 = ((0.1, 0.2, 0.4), (16, 32, 128))
_MSG2 = ((0.2, 0.4, 0.8), (32, 64, 128))


@pytest.mark.parametrize(
    "B,N,P,S,radii,ks,offset",
    [
        (3, 1024, 10, 512, (0.2,), (32,), 0.0),            # a head's SA1, SSG
        (3, 1024, 10, 512, *_MSG1, 0.0),                   # a head's SA1, MSG
        (3, 512, 10, 128, (0.4,), (64,), 0.0),             # a head's SA2, SSG
        (3, 512, 10, 128, *_MSG2, 0.0),                    # a head's SA2, MSG
        (3, 512, 3, 128, *_MSG2, 0.0),                     # the classifier's SA2, MSG
        (2, 1000, 3, 512, *_MSG1, 0.0),                    # N no multiple of the step
        (2, 1024, 3, 100, (0.2,), (32,), 0.0),             # ragged centroid tile
        (1, 40000, 3, 64, (0.05, 0.1), (16, 32), 0.0),     # cloud above shared memory: global path
        (2, 1024, 3, 512, *_MSG1, 4.0),                    # empty balls at three scales
        (2, 300, 7, 77, (0.3, 0.6), (8, 24), 0.0),         # the any-P instance
        (2, 512, 3, 64, (0.1, 0.2, 0.3, 0.4, 0.5), (4, 8, 16, 32, 64), 0.0),   # five scales
        (2, 4096, 3, 40, (0.3,), (600,), 0.0),             # the tile shrinks to 64 centroids
    ],
    ids=["p10_ssg", "p10_msg_sa1", "p10_ssg_sa2", "p10_msg_sa2", "msg_sa2", "n1000", "ragged_s", "global_path",
         "empty_three_scales", "any_p", "five_scales", "tile64"],
)
def test_ball_query_kernel_matches_plain_version_at_new_shapes(card, B, N, P, S, radii, ks, offset):
    pts = _spliced(B, N, P, 11).to(card)
    cent = (pts[:, torch.randperm(N, generator=torch.Generator().manual_seed(1))[:S]] + offset).contiguous()
    got = ball_query_multi(pts, cent, radii, ks)
    torch.cuda.synchronize()
    assert torch.equal(got, ball_query_reference(pts, cent, radii, ks))
    if offset:
        assert bool((got == N - 1).all())


@pytest.mark.parametrize("name", ["rotation_ssg", "sign_msg", "translation_msg", "pointnet_cls",
                                  "pose_feat_trans", "pose_classify"])
def test_head_forward_on_card_matches_cpu(card, name):
    """One forward per family on seeded weights: the card (FPS and ball
    query kernels over 10 channels) against the same model on the CPU."""
    import copy

    from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec

    torch.manual_seed(2)
    model = build_model(name).eval()
    spec = get_model_spec(name)
    x = _spliced(3, 1024, 3 if spec.input_kind == "xyz" else 10, 12)
    inputs = (x, torch.randn(3, 3)) if spec.input_kind == "spliced_mean" else (x,)
    with torch.inference_mode():
        want = model(*inputs)
        got = copy.deepcopy(model).to(card)(*(t.to(card) for t in inputs))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        if g.dtype.is_floating_point and spec.task != "sign":
            torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-3)
    if spec.task == "classify":
        assert torch.equal(got[2].cpu(), want[2])
    if spec.task == "sign":
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-3, atol=1e-3)
        sure = (want[0] - 0.5).abs() > 1e-4
        assert torch.equal(got[1].cpu()[sure], want[1][sure])


def test_pipeline_on_card_matches_cpu(card):
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline

    clusters = np.random.default_rng(2).standard_normal((3, 1300, 3)).astype(np.float32) * 0.05
    gpu = GraspPipeline.from_random(seed=1, device="cuda").infer_clusters(clusters)
    cpu = GraspPipeline.from_random(seed=1, device="cpu").infer_clusters(clusters)
    np.testing.assert_array_equal(gpu["pred_class"], cpu["pred_class"])
    for k in ("log_probs", "rotation_deg", "sign_prob", "translation", "width"):
        np.testing.assert_allclose(gpu[k], cpu[k], rtol=1e-3, atol=1e-3, err_msg=k)


def _folded_weights(rng, P, layer_widths):
    out = []
    for widths in layer_widths:
        cin = P
        for cout in widths:
            out += [(rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32),
                    (0.1 * rng.standard_normal(cout)).astype(np.float32)]
            cin = cout
    return [torch.from_numpy(w) for w in out]


_MSG_SA1 = ((0.1, 0.2, 0.4), (16, 32, 128), ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
_MSG_SA2 = ((0.2, 0.4, 0.8), (32, 64, 128), ((64, 64, 128), (128, 128, 256), (128, 128, 256)))


@pytest.mark.parametrize(
    "B,N,D,S,radii,ks,widths,offset",
    [
        (2, 1024, 0, 512, (0.2,), (32,), ((64, 64, 128),), 0.0),
        (2, 512, 128, 128, (0.4,), (64,), ((128, 128, 256),), 0.0),
        (2, 1024, 0, 512, *_MSG_SA1, 0.0),
        (2, 512, 320, 128, *_MSG_SA2, 0.0),
        (2, 1024, 0, 512, (0.2,), (32,), ((64, 64, 128),), 4.0),
        (2, 1024, 0, 509, *_MSG_SA1, 0.0),                         # S no multiple of 8
        (3, 512, 128, 127, (0.4,), (64,), ((128, 128, 256),), 0.0),
        (40, 512, 128, 127, (0.4,), (64,), ((128, 128, 256),), 0.0),       # more clouds
        (2, 512, 4, 64, (0.3, 0.5), (20, 50), ((16, 24), (40, 8)), 0.0),   # K no multiple of 8, P = 7
        (1, 256, 0, 3, (0.3,), (20,), ((8,),), 0.0),               # one block, one FMA layer
    ],
    ids=["ssg_sa1", "ssg_sa2", "msg_sa1", "msg_sa2", "empty_balls", "ragged_msg_sa1",
         "ragged_ssg_sa2", "ragged_ssg_sa2_wide_tile", "odd_k", "tiny"],
)
def test_fused_sa_kernel_matches_plain_version(card, B, N, D, S, radii, ks, widths, offset):
    """Selected indices exact; features to 1e-4 (the kernel's products are
    error-compensated TF32 on the tensor cores, summed in another order)."""
    rng = np.random.default_rng(3)
    xyz = _clouds(B, N, 3)
    pts = torch.cat([xyz, torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32))], -1)
    cent = xyz[:, rng.permutation(N)[:S]] + offset
    weights = [w.to(card) for w in _folded_weights(rng, 3 + D, widths)]
    pts, cent = pts.to(card).contiguous(), cent.to(card).contiguous()
    idx = torch.empty((B, S, sum(ks)), dtype=torch.int32, device=card)
    got = fused_sa_infer(pts, cent, weights, radii, ks, widths, idx_out=idx)
    torch.cuda.synchronize()
    assert torch.equal(idx, ball_query_reference(pts[..., :3], cent, radii, ks))
    if offset:
        assert bool((idx == N - 1).all())
    want = fused_sa_reference(pts, cent, weights, radii, ks, widths)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_mma_tile_matches_scalar_product(card):
    """The kernel's fragment layout and three-product TF32 on one 16x8x8
    tile against the float64 product and the same arithmetic in PyTorch."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)).to(card)
    got = mma_tile_selftest(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, (a.double() @ b.double()).float(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, matmul_3xtf32(a, b), rtol=1e-6, atol=1e-6)


def _bn_relu_pair(card, R, C, seed):
    """Seeded rows as a Linear layer gives them (each channel its own offset
    and spread), an output gradient, and a train-mode BatchNormF32 with
    nontrivial parameters and statistics, on the card."""
    from pointnet_like_pose_estimation_tpu_torch.nn import BatchNormF32

    g = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn(R, C, generator=g, device=card) * (torch.rand(C, generator=g, device=card) * 2 + 0.1)
         + 3 * torch.randn(C, generator=g, device=card))
    dy = torch.randn(R, C, generator=g, device=card)
    bn = BatchNormF32(C).to(card).train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=g, device=card) + 0.5)
        bn.bias.copy_(torch.rand(C, generator=g, device=card) - 0.5)
        bn.running_mean.copy_(torch.randn(C, generator=g, device=card))
        bn.running_var.copy_(torch.rand(C, generator=g, device=card) + 0.5)
    return x, dy, bn


def _fused_run(x, dy, bn):
    """One fused forward and backward on a copy of ``bn``: y, dx, the
    parameters' gradients and the running statistics after it."""
    import copy

    bn = copy.deepcopy(bn)
    x = x.clone().requires_grad_()
    y = bn_relu(x, bn)
    dx, gw, gb = torch.autograd.grad(y, [x, bn.weight, bn.bias], dy)
    return {"y": y.detach(), "dx": dx, "grad_weight": gw, "grad_bias": gb,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


@pytest.mark.parametrize("R,C", [
    (393_216, 64), (393_216, 128), (196_608, 128), (196_608, 256), (3_072, 1_024),    # SSG at B = 24
    (100_003, 64), (777, 12), (5, 2_048), (3, 1_028), (1, 4),      # rows off a block, columns off a row
])
def test_bn_relu_kernel_matches_the_plain_path(card, R, C):
    """The fused kernels against ``torch.relu(BatchNormF32(x))`` through
    autograd on the card: the output and the updated running statistics
    equal bit for bit (the same statistics, each later step rounded as
    PyTorch rounds it), dx and the parameters' gradients within 1e-4 of
    their norm; a second call gives the same bits; one launch a forward."""
    x, dy, bn = _bn_relu_pair(card, R, C, seed=R + C)
    f0, p0 = bn_relu.launches, plain_bn_relu.launches
    got = _fused_run(x, dy, bn)
    again = _fused_run(x, dy, bn)
    torch.cuda.synchronize()
    assert (bn_relu.launches - f0, plain_bn_relu.launches - p0) == (2, 0)
    for k in got:
        assert torch.equal(got[k], again[k]), f"{k}: two calls on the same inputs differ"
    xp = x.clone().requires_grad_()
    y = torch.relu(bn(xp))
    dx, gw, gb = torch.autograd.grad(y, [xp, bn.weight, bn.bias], dy)
    for k, w in (("y", y.detach()), ("running_mean", bn.running_mean), ("running_var", bn.running_var)):
        assert torch.equal(got[k], w), f"{k}: not the plain pair's bits (max gap {float((got[k] - w).abs().max())})"
    gaps = {}
    for k, w in (("dx", dx), ("grad_weight", gw), ("grad_bias", gb)):
        if R == 1 and k != "grad_bias":      # one row: its normalised value is 0, and so are both
            gaps[k] = float((got[k] - w).abs().max())
        else:
            gaps[k] = float((got[k] - w).double().norm() / w.double().norm())
        assert gaps[k] <= 1e-4, (k, gaps[k])
    print(f"bn_relu [{R}, {C}]: forward equal to the plain pair; gradients, relative to the norm: {gaps}")


def test_fused_bn_relu_takes_every_pair_of_the_ssg_train_step(card):
    """pointnet2_cls_ssg's programmed train step at batch 24: every one of
    its nine shared-MLP BatchNorm + ReLU pairs runs fused in the first call
    (the step, then the capture) and in the replay, none plain: the engaged
    share is 1.0, and the program records nine fused forwards a run."""
    from pointnet_like_pose_estimation_tpu_torch.models import get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import make_train_step

    cfg, runs, data = _copies(card, "pointnet2_cls_ssg", 1, experiment="classification/r3_pointnet2_cls_ssg")
    model, opt, _, gen = runs[0]
    step = make_train_step(get_model_spec("pointnet2_cls_ssg"), cfg)
    f0, p0 = bn_relu.launches, plain_bn_relu.launches
    for i in range(2):
        step(model, opt, {k: v[24 * i:24 * (i + 1)] for k, v in data.items()}, gen)
    torch.cuda.synchronize()
    fused, plain = bn_relu.launches - f0, plain_bn_relu.launches - p0
    assert (fused, plain) == (18, 0) and fused / (fused + plain) == 1.0
    programs = step.cache(card)
    assert programs.counts(programs.keys()[0])["bn_relu"] == 9


def _eval_pair(card, R, C, seed):
    """Seeded rows as a Linear layer gives them and an eval-mode
    BatchNormF32 with nontrivial parameters and running statistics, on the
    card."""
    x, _, bn = _bn_relu_pair(card, R, C, seed)
    return x, bn.eval()


# [R, C] of the inner eval pairs of both serving cells' requests at 32
# clusters (SSG SA1, SA2, global; the PointNet heads; MSG SA1 at K = 16, 32,
# 128, SA2 at K = 32, 64, 128, the two-level heads' global layer), then
# rows off a block and columns off a row
EVAL_SHAPES = [(16384 * 32, 64), (4096 * 64, 128), (32 * 128, 256), (32 * 128, 512), (32 * 1024, 64),
               (32 * 1024, 128), (16384 * 16, 32), (16384 * 128, 64), (16384 * 128, 96), (4096 * 32, 64),
               (4096 * 128, 128), (32 * 512, 512), (100_003, 64), (777, 12), (5, 2_048), (1, 4)]
# [G, K, C] of their last pairs, each followed by a max over K, then groups
# off a lane, a block and a piece (the K = 4 request bucket's heads too)
POOL_SHAPES = [(16384, 32, 128), (4096, 64, 256), (32, 128, 1024), (32, 1024, 1024), (16384, 16, 64),
               (16384, 128, 128), (4096, 32, 128), (4096, 128, 256), (32, 512, 1024), (4, 1024, 1024), (5, 3, 12),
               (33, 1000, 1024), (7, 9, 2048), (1, 1, 4)]


@pytest.mark.parametrize("R,C", EVAL_SHAPES)
def test_bn_relu_eval_kernel_equals_the_plain_pair(card, R, C):
    """The eval pass against ``torch.relu(BatchNormF32(x))`` in eval mode on
    the card: equal bit for bit (PyTorch's invstd and rounding), a second
    call the same bits, one launch a call, the BatchNorm's state untouched."""
    x, bn = _eval_pair(card, R, C, seed=R + C)
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    with torch.inference_mode():
        e0 = bn_relu_eval.launches
        got, again = bn_relu_eval(x, bn), bn_relu_eval(x, bn)
        want = torch.relu(bn(x))
    torch.cuda.synchronize()
    assert bn_relu_eval.launches - e0 == 2
    assert torch.equal(got, again)
    assert torch.equal(got, want), f"max gap {float((got - want).abs().max())}, {int((got != want).sum())} differ"
    for k, v in bn.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("G,K,C", POOL_SHAPES)
def test_bn_relu_eval_pooled_kernel_equals_the_plain_pair_and_amax(card, G, K, C):
    """The pooled eval pass against ``torch.relu(BatchNormF32(x))
    .amax(dim=-2)`` on the card: equal bit for bit whether a group is one
    piece or several merged by atomicMax, a second call the same bits, one
    launch a call."""
    x, bn = _eval_pair(card, G * K, C, seed=G + K + C)
    x = x.reshape(G, K, C)
    with torch.inference_mode():
        p0 = bn_relu_eval_pool.launches
        got, again = bn_relu_eval_pool(x, bn), bn_relu_eval_pool(x, bn)
        want = torch.relu(bn(x)).amax(dim=-2)
    torch.cuda.synchronize()
    assert bn_relu_eval_pool.launches - p0 == 2 and got.shape == (G, C)
    assert torch.equal(got, again)
    assert torch.equal(got, want), (f"plan {bn_relu_pool_plan(G, K, C)}: max gap "
                                    f"{float((got - want).abs().max())}, {int((got != want).sum())} differ")


@pytest.mark.parametrize("G,K", [(64, 40), (2, 1280), (16384, 16)])
def test_bn_relu_eval_kernels_carry_nan_as_the_plain_pair(card, G, K):
    """NaNs in the input: the eval pass puts them where the plain pair does
    and equals it elsewhere; the pooled pass gives NaN in exactly the
    groups and channels where ``amax`` does (one piece a group, or several
    merged by atomicMax) and equals it elsewhere."""
    C = 64
    x, bn = _eval_pair(card, G * K, C, seed=G)
    x[5, 3] = x[G * K // 2, 10] = x[G * K - 40:, 60] = float("nan")
    with torch.inference_mode():
        got, want = bn_relu_eval(x, bn), torch.relu(bn(x))
        pooled, want_pooled = bn_relu_eval_pool(x.reshape(G, K, C), bn), want.reshape(G, K, C).amax(dim=-2)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(), want.nan_to_num())
    assert int(want_pooled.isnan().sum()) >= 3
    assert torch.equal(pooled.isnan(), want_pooled.isnan())
    assert torch.equal(pooled.nan_to_num(), want_pooled.nan_to_num())


# the grouped set abstractions of both serving cells' requests at 32 clusters
# (B, N, P, D, S, radii, ks, first widths): SSG SA1 and SA2 (D + P = 131),
# MSG SA1 at P = 3 and 10 (K = 16, 32, 128), SA2 at D + P = 323 and 330;
# then ragged: K off the four loads in flight, C above a warp's 128
# channels, S off a block's eight groups
GATHER_SHAPES = {
    "ssg_sa1": (32, 1024, 3, 0, 512, (0.2,), (32,), (64,)),
    "ssg_sa2": (32, 512, 3, 128, 128, (0.4,), (64,), (128,)),
    "msg_sa1": (32, 1024, 3, 0, 512, *_MSG1, (32, 64, 64)),
    "msg_head_sa1": (32, 1024, 10, 0, 512, *_MSG1, (32, 64, 64)),
    "msg_sa2": (32, 512, 3, 320, 128, *_MSG2, (64, 128, 128)),
    "msg_head_sa2": (32, 512, 10, 320, 128, *_MSG2, (64, 128, 128)),
    "ragged": (3, 200, 3, 4, 37, (0.3, 0.6), (5, 50), (4, 136)),
}


@pytest.mark.parametrize("name", list(GATHER_SHAPES))
def test_bn_relu_eval_gather_kernel_equals_its_plain_version(card, name):
    """The gathered eval pass against ``eval_gather_reference`` on the
    card, at each grouped set abstraction's shapes: the scales' first
    Linears as one product per point (``per_point_products``, MSG's
    feature-first layout), each scale's columns and neighbours read in
    place (slices), equal bit for bit, a second call the same bits, one
    launch a call."""
    from pointnet_like_pose_estimation_tpu_torch.ops import farthest_point_sample, index_points
    from pointnet_like_pose_estimation_tpu_torch.ops.grouping import per_point_products

    B, N, P, D, S, radii, ks, widths = GATHER_SHAPES[name]
    points = _spliced(B, N, P, seed=N + P).to(card)
    g = torch.Generator().manual_seed(D + S)
    features = torch.randn(B, N, D, generator=g).abs().to(card) if D else None
    weight = (torch.randn(sum(widths), P + D, generator=g) / (P + D) ** 0.5).to(card)
    with torch.inference_mode():
        centroids = index_points(points, farthest_point_sample(points, S))
        idx_all = ball_query_multi(points, centroids, radii, ks)
        pf, qc = per_point_products(weight, points, features, centroids, coords_first=False)
        c_off = k_off = 0
        for C, K in zip(widths, ks):
            _, bn = _eval_pair(card, 1, C, seed=C + K)
            bias = torch.randn(C, generator=g).to(card)
            args = pf[..., c_off:c_off + C], qc[..., c_off:c_off + C], idx_all[..., k_off:k_off + K]
            g0 = bn_relu_eval_gather.launches
            got, again = bn_relu_eval_gather(*args, bias, bn), bn_relu_eval_gather(*args, bias, bn)
            want = eval_gather_reference(*args, bias, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
            torch.cuda.synchronize()
            assert bn_relu_eval_gather.launches - g0 == 2 and got.shape == (B, S, K, C)
            assert torch.equal(got, again)
            assert torch.equal(got, want), (f"K={K} C={C}: max gap {float((got - want).abs().max())}, "
                                            f"{int((got != want).sum())} differ")
            c_off, k_off = c_off + C, k_off + K


def _msg_config():
    from pointnet_like_pose_estimation_tpu_torch.pipeline import PipelineConfig

    return PipelineConfig(classifier="pointnet2_cls_msg", rotation="rotation_msg", sign="sign_msg",
                          translation="translation_msg")


def _request_gaps(got: dict, want: dict) -> dict:
    """``class_err`` and ``head_err`` as the benchmark's check forms them
    (the widest log-probability gap; each head output's widest gap over its
    largest value), the rotation compared where the served sign agrees."""
    assert torch.equal(got["pred_class"], want["pred_class"])
    same = (got["sign_prob"] > 0.5) == (want["sign_prob"] > 0.5)
    head = 0.0
    for k in ("rotation_deg", "rotation_matrix", "sign_prob", "translation", "width"):
        a, b = (got[k][same], want[k][same]) if k.startswith("rotation") else (got[k], want[k])
        head = max(head, float((a - b).abs().max() / b.abs().max().clamp(min=1e-6)))
    return {"class_err": float((got["log_probs"] - want["log_probs"]).abs().max()), "head_err": head,
            "signs_agree": int(same.sum())}


@pytest.mark.parametrize("models", ["ssg", "msg"])
def test_per_point_request_matches_the_grouped_route(card, monkeypatch, models):
    """A request of 32 clusters of 2048 points (the two serving cells'
    shape) on the per-point route against the grouped route (the reason
    function forced to refuse it): the classes equal, ``class_err`` within
    1e-4 and ``head_err`` within 5e-5, a tenth of the benchmark's limits
    (the first layers' sums reassociated in float32; expected ~1e-6). Its
    replay equals its eager call bit for bit, and the grouped route runs
    no gathered pass."""
    from pointnet_like_pose_estimation_tpu_torch.nn import set_abstraction
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    cfg = PipelineConfig() if models == "ssg" else _msg_config()
    pipe = GraspPipeline.from_random(cfg, seed=6, device="cuda")
    rng = np.random.default_rng(9)
    clusters = (rng.uniform(-0.5, 0.5, (32, 1, 3)) + 0.05 * rng.standard_normal((32, 2048, 3))).astype(np.float32)
    key, fn, inputs, _ = pipe._request_call(clusters)
    replay = {k: v.clone() for k, v in pipe.programs(key, fn, inputs).items()}
    with torch.inference_mode():
        eager = fn(*(x.to(card) for x in inputs))
        g0 = bn_relu_eval_gather.launches
        monkeypatch.setattr(set_abstraction, "per_point_reason", lambda *a: "grouped")
        grouped = fn(*(x.to(card) for x in inputs))
    torch.cuda.synchronize()
    assert bn_relu_eval_gather.launches == g0
    assert _gap(replay, eager) == 0.0
    gaps = _request_gaps(eager, grouped)
    assert gaps["class_err"] <= 1e-4 and gaps["head_err"] <= 5e-5, gaps


def test_request_programs_take_the_eval_passes(card):
    """One replay of each serving request program (the default SSG models,
    the MSG ones) runs every eval-mode BatchNorm + ReLU pair of its shared
    MLPs through the eval passes and none plain: SSG 20 passes, 7 pooled
    (3 of the classifier's set abstractions, one a PointNet head) and 2
    gathered (the first pairs of SSG SA1 and SA2), MSG 30, 23 and 18 (the
    classifier's and the rotation head's seven MLPs, the sign and
    translation heads' four, the width head's one; a gathered first pair
    in each scale of their grouped set abstractions: the classifier's two
    levels, the rotation head's two, the sign and translation heads' one,
    three scales each)."""
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    rng = np.random.default_rng(8)
    clusters = (rng.uniform(-0.5, 0.5, (4, 1, 3)) + 0.05 * rng.standard_normal((4, 1300, 3))).astype(np.float32)
    for cfg, passes, pooled, gathered in ((PipelineConfig(), 20, 7, 2), (_msg_config(), 30, 23, 18)):
        pipe = GraspPipeline.from_random(cfg, seed=4, device="cuda")
        key, fn, inputs, _ = pipe._request_call(clusters)
        pipe.programs(key, fn, inputs)                       # warm-up and capture
        counters = (bn_relu_eval, bn_relu_eval_pool, bn_relu_eval_gather, plain_bn_relu_eval)
        counts = tuple(c.launches for c in counters)
        pipe.programs(key, fn, inputs)                       # one replay
        torch.cuda.synchronize()
        after = tuple(c.launches for c in counters)
        assert tuple(b - a for a, b in zip(counts, after)) == (passes, pooled, gathered, 0)
        recorded = pipe.programs.counts(key)
        names = ("bn_relu_eval", "bn_relu_eval_pool", "bn_relu_eval_gather", "bn_relu_eval_plain")
        assert tuple(recorded.get(n, 0) for n in names) == (passes, pooled, gathered, 0)


@pytest.mark.parametrize("name", ["pointnet2_cls_ssg", "pointnet2_cls_msg"])
def test_fast_infer_on_card_matches_cpu(card, name):
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.models.fast_infer import (
        build_pn2_msg_infer,
        build_pn2_ssg_infer,
    )

    build = build_pn2_ssg_infer if name == "pointnet2_cls_ssg" else build_pn2_msg_infer
    torch.manual_seed(0)
    model = build_model(name).eval()
    x = _clouds(4, 1024, 4)
    lp_gpu, pred_gpu = build(model)(x.to(card))
    lp_cpu, pred_cpu = build(model, device="cpu")(x)
    assert torch.equal(pred_gpu.cpu(), pred_cpu)
    torch.testing.assert_close(lp_gpu.cpu(), lp_cpu, rtol=1e-3, atol=1e-3)


def _seeded(name, seed):
    """A registry model with seeded weights and nontrivial BatchNorm
    statistics and affine parameters; a T-Net's output layer is the
    identity plus small noise (as chip_smoke.py's seeded_model)."""
    import math

    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.nn import TNet

    gen = torch.Generator().manual_seed(seed)
    model = build_model(name)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(m, torch.nn.BatchNorm1d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
        for m in model.modules():
            if isinstance(m, TNet):
                m.reset_identity()
                m.out.weight.normal_(0.0, 0.02, generator=gen)
    return model


# as chip_smoke.py's TIED_GRADIENTS: gradient tensors held by their relative
# L2 error (twice the largest gap measured on the H100), because a max over a
# group routes them to another member where its two largest values lie
# within the two devices' rounding of each other. Every other gradient
# element within 1e-4 relative and 1e-4 of the model's largest gradient
# element absolute (at least 1e-4): an element sums terms of that size over
# the batch, so its rounding is set by them where they cancel
TIED_GRADIENTS = {
    "pointnet_cls": (("encoder.tnet_input.", "encoder.conv1.", "encoder.tnet_feature.", "encoder.conv2.",
                      "encoder.conv3."), 1.5e-2),
    "rotation_ssg": (("sa1.", "sa2.", "sa_global.mlp.dense_0.", "sa_global.mlp.bn_0.", "sa_global.mlp.dense_1.",
                      "sa_global.mlp.bn_1."), 1.5e-2),
}


@pytest.mark.parametrize("name,launches", [("pointnet2_cls_ssg", 2), ("pointnet_cls", 0), ("rotation_ssg", 2)])
def test_train_step_on_card_matches_cpu(card, name, launches):
    """One train step at batch 24 of a seeded dataset built on the card,
    with the augmentation and dropout draws made once on the CPU:
    pointnet2_cls_ssg from the committed r3 checkpoint, pointnet_cls (its
    T-Nets and the orthogonality penalty) and rotation_ssg (the SSG head on
    10 channels) from seeded weights. The card's loss, gradients (but those
    of TIED_GRADIENTS, absolute 1e-4 scaled by the model's largest gradient)
    and BatchNorm statistics within 1e-4 of the CPU's, and
    FPS and the ball query launched ``launches`` times each."""
    import copy

    from pointnet_like_pose_estimation_tpu_torch.nn import pre_bn_biases

    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import (
        TrainConfig,
        draw_step,
        load_checkpoint,
        make_optimizer,
        make_train_step,
    )
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _device_data

    ds = load_dataset(build_dataset(5, seed=3), "train")                 # 28 clouds, all classes
    cpu_batch = {k: v[:24] for k, v in _device_data(ds, torch.device("cpu")).items()}
    card_batch = {k: v.to(card) for k, v in cpu_batch.items()}
    spec, cfg = get_model_spec(name), TrainConfig.for_model(name)
    if name == "pointnet2_cls_ssg":
        cpu_model, _ = load_checkpoint(
            os.path.join(ROOT, "log/classification/r3_pointnet2_cls_ssg/checkpoints/best.msgpack"),
            build_model(name))
    else:
        cpu_model = _seeded(name, 40)
    card_model = copy.deepcopy(cpu_model).to(card)
    draws = draw_step(cfg, cpu_model, cpu_batch, torch.Generator().manual_seed(5))
    card_draws = {part: {k: v.to(card) for k, v in d.items()} for part, d in draws.items()}
    step = make_train_step(spec, cfg)
    f0, b0 = fps.launches, ball_query_multi.launches
    got = step(card_model, make_optimizer(cfg, card_model.parameters())[0], card_batch, draws=card_draws)
    torch.cuda.synchronize()
    assert (fps.launches - f0, ball_query_multi.launches - b0) == (launches, launches)
    want = step(cpu_model, make_optimizer(cfg, cpu_model.parameters())[0], cpu_batch, draws=draws)
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got["loss"].cpu(), want["loss"], **tol)
    card_params = dict(card_model.named_parameters())
    tied, tied_bound = TIED_GRADIENTS.get(name, ((), 0.0))
    noisy = pre_bn_biases(cpu_model)
    scale = max(1.0, max(float(p.grad.abs().max()) for p in cpu_model.parameters()))
    missed = {}
    for k, p in cpu_model.named_parameters():
        g = card_params[k].grad.cpu()
        if torch.allclose(g, p.grad, rtol=1e-4, atol=1e-4 * scale):
            continue
        rel = float((g - p.grad).norm() / p.grad.norm())
        if not (k.startswith(tied) and k not in noisy and rel <= tied_bound):
            missed[k] = (float((g - p.grad).abs().max()), rel)
    assert not missed, f"gradients (max abs, relative L2) beyond 1e-4: {missed}"
    card_state = card_model.state_dict()
    for k, v in cpu_model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(card_state[k].cpu(), v, **tol, msg=k)


def test_dp_step_at_world_size_one_matches_the_single_step(card):
    """A world of one on NCCL (``parallel.init_process_group`` outside
    ``torchrun``): one data-parallel train step of pointnet2_cls_ssg from the
    committed r3 checkpoint at batch 24 against the single-process step on
    the card, on the same draws: loss, gradients (absolute 1e-4 scaled by
    the largest gradient) and BatchNorm statistics within 1e-4, FPS and the
    ball query launched twice, and the gradients all-reduced once, 4 bytes a
    parameter."""
    import copy

    import torch.distributed as dist

    from pointnet_like_pose_estimation_tpu_torch import parallel as P
    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import (
        TrainConfig,
        draw_step,
        load_checkpoint,
        make_optimizer,
        make_train_step,
    )
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _device_data
    from pointnet_like_pose_estimation_tpu_torch.utils.collectives import (
        collective_traffic,
        reset_collective_traffic,
    )

    name = "pointnet2_cls_ssg"
    ds = load_dataset(build_dataset(5, seed=3), "train")
    batch = {k: v[:24].to(card) for k, v in _device_data(ds, torch.device("cpu")).items()}
    spec, cfg = get_model_spec(name), TrainConfig.for_model(name)
    model, _ = load_checkpoint(
        os.path.join(ROOT, "log/classification/r3_pointnet2_cls_ssg/checkpoints/best.msgpack"), build_model(name))
    draws = draw_step(cfg, model, {k: v.cpu() for k, v in batch.items()}, torch.Generator().manual_seed(5))
    draws = {part: {k: v.to(card) for k, v in d.items()} for part, d in draws.items()}
    single = copy.deepcopy(model).to(card)
    want = make_train_step(spec, cfg)(single, make_optimizer(cfg, single.parameters())[0], batch, draws=draws)
    P.init_process_group("cuda")
    try:
        mesh = P.make_mesh()
        dp = P.replicate(copy.deepcopy(model).to(card), mesh)
        step = P.make_parallel_train_step(spec, cfg, mesh)
        reset_collective_traffic()
        f0, b0 = fps.launches, ball_query_multi.launches
        got = step(dp, make_optimizer(cfg, dp.parameters())[0], batch, draws=draws)
        torch.cuda.synchronize()
        assert (fps.launches - f0, ball_query_multi.launches - b0) == (2, 2)
        traffic = collective_traffic()
    finally:
        dist.destroy_process_group()
    assert traffic["by_site"]["gradients"]["all-reduce"] == {
        "count": 1, "bytes": 4 * sum(p.numel() for p in model.parameters())}
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got["loss"], want["loss"], **tol)
    want_params = dict(single.named_parameters())
    scale = max(1.0, max(float(p.grad.abs().max()) for p in want_params.values()))
    for k, p in dp.named_parameters():
        torch.testing.assert_close(p.grad, want_params[k].grad, rtol=1e-4, atol=1e-4 * scale, msg=k)
    want_state = single.state_dict()
    for k, v in dp.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, want_state[k], **tol, msg=k)


def test_frame_on_card_matches_cpu(card):
    """The raw-frame path on the replay scene: the cleaned points equal the
    CPU's bit for bit (every distance rounded term by term), and the grasps
    of ``__call__`` equal the CPU's to 1e-3, classes exactly."""
    from pointnet_like_pose_estimation_tpu_torch.data.io_utils import load_ply
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
    from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess as pp

    scene = load_ply(os.path.join(ROOT, "tests", "fixtures", "scene_table2obj.ply")).astype(np.float32)
    pts = pp.clip_distance(scene, (-1.0, 0.0), 2)
    kw = dict(radius_nb_points=60, radius=0.03)
    np.testing.assert_array_equal(pp.clean_scene(pts, **kw, device="cuda"),
                                  pp.clean_scene(pts, **kw, device="cpu"))
    cfg = PipelineConfig(clip_range=(-1.0, 0.0), min_points=200, radius_nb_points=60, radius=0.03, eps=0.04)
    gpu = GraspPipeline.from_random(cfg, seed=1, device="cuda")(scene)
    cpu = GraspPipeline.from_random(cfg, seed=1, device="cpu")(scene)
    np.testing.assert_array_equal(gpu["pred_class"], cpu["pred_class"])
    np.testing.assert_array_equal(gpu["clusters"], cpu["clusters"])
    for k in ("log_probs", "rotation_deg", "sign_prob", "translation", "width"):
        np.testing.assert_allclose(gpu[k], cpu[k], rtol=1e-3, atol=1e-3, err_msg=k)


# --- compiled programs: CUDA graphs captured per bucket and replayed -------------------------


def _gap(got, want) -> float:
    """Largest float gap of two grasp dicts (or tuples) of tensors; integer
    outputs must be equal."""
    if isinstance(got, dict):
        got, want = list(got.values()), list(want.values())
    worst = 0.0
    for a, b in zip(got, want):
        if a.dtype.is_floating_point:
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        else:
            assert torch.equal(a, b)
    return worst


def test_request_replay_equals_eager_and_takes_new_inputs(card):
    """The request program's replay against its function called eagerly on
    the card on the same bucketed inputs (classes exact, floats within 1e-5;
    expected bit for bit), twice in one bucket with other clusters, and the
    launches a replay adds are those its capture recorded."""
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline

    pipe = GraspPipeline.from_random(seed=1, device="cuda")
    rng = np.random.default_rng(3)
    first = None
    for K, M in [(3, 1300), (4, 1400), (2, 700)]:
        clusters = (rng.uniform(-0.5, 0.5, (K, 1, 3)) + 0.05 * rng.standard_normal((K, M, 3))).astype(np.float32)
        key, fn, inputs, _ = pipe._request_call(clusters)
        f0, c0 = fps.launches, pipe.programs.captures
        replay = pipe.programs(key, fn, inputs)
        torch.cuda.synchronize()
        runs = 1 + pipe.programs.captures - c0                   # a capture's warm-up ran too
        assert fps.launches - f0 == runs * pipe.programs.counts(key)["fps"]
        with torch.inference_mode():
            eager = fn(*(x.to(card) for x in inputs))
        assert _gap(replay, eager) <= 1e-5
        if first is None:
            first = {k: v.clone() for k, v in replay.items()}   # the next replay of its key overwrites it
        elif key == ("request", 4, 1536):
            assert not torch.equal(first["log_probs"], replay["log_probs"])
    assert pipe.programs.captures == 2 and pipe.programs.replays == 3
    # the counters a replay moves, the others stay at 0: 4 clusters of 132,608 grouped bytes (the
    # global level's; SA1 and SA2 take their first Linears per point and build none)
    assert pipe.programs.counts(("request", 4, 1536)) == {"fps": 3, "ball_query": 2, "bn_relu_eval": 20,
                                                         "bn_relu_eval_pool": 7, "bn_relu_eval_gather": 2,
                                                         "grouped_bytes": 4 * 132_608}


def test_msg_request_replay_equals_eager_and_counts_its_grouped_bytes(card):
    """The request program on the MSG classifier and MSG heads: its replay
    against its function called eagerly on the card (classes exact, floats
    within 1e-5; expected bit for bit), the launches its capture recorded
    (the resampling FPS, two levels of the classifier and of the rotation
    head, one of the sign and translation heads), and the grouped bytes it
    recorded, which the warm-up and the replay each add: at K = 4, an eighth
    of a 32-cluster request's 64,438,272 (the global levels'; the grouped
    set abstractions take their first Linears per point and build none)."""
    from pointnet_like_pose_estimation_tpu_torch.ops.grouping import count_grouped
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    cfg = PipelineConfig(classifier="pointnet2_cls_msg", rotation="rotation_msg", sign="sign_msg",
                         translation="translation_msg")
    pipe = GraspPipeline.from_random(cfg, seed=2, device="cuda")
    rng = np.random.default_rng(4)
    clusters = (rng.uniform(-0.5, 0.5, (4, 1, 3)) + 0.05 * rng.standard_normal((4, 1300, 3))).astype(np.float32)
    key, fn, inputs, _ = pipe._request_call(clusters)
    g0 = count_grouped.bytes
    replay = pipe.programs(key, fn, inputs)
    torch.cuda.synchronize()
    assert pipe.programs.counts(key) == {"fps": 7, "ball_query": 6, "bn_relu_eval": 30, "bn_relu_eval_pool": 23,
                                         "bn_relu_eval_gather": 18, "grouped_bytes": 64_438_272 // 8}
    assert count_grouped.bytes - g0 == 2 * pipe.programs.counts(key)["grouped_bytes"]
    with torch.inference_mode():
        eager = fn(*(x.to(card) for x in inputs))
    assert _gap(replay, eager) <= 1e-5


@pytest.mark.parametrize("sizes", [[1300, 1700, 2100], [1024, 1500], [600, 900, 400]])
def test_scene_replay_equals_eager(card, sizes):
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline

    pipe = GraspPipeline.from_random(seed=2, device="cuda")
    rng = np.random.default_rng(len(sizes))
    for _ in range(2):                                       # the same bucket, other points
        parts = [rng.uniform(-0.5, 0.5, (1, 3)) + 0.05 * rng.standard_normal((n, 3)) for n in sizes]
        pts = np.concatenate(parts).astype(np.float32)
        labels = np.concatenate([np.full(n, c) for c, n in enumerate(sizes)])
        key, fn, inputs, K, _ = pipe._scene_call(pts, labels)
        out, cglobal = pipe.programs(key, fn, inputs)
        with torch.inference_mode():
            want, want_cglobal = fn(*(x.to(card) for x in inputs))
        assert torch.equal(cglobal, want_cglobal) and _gap(out, want) <= 1e-5
        cpu = GraspPipeline.from_random(seed=2, device="cpu")._infer_scene(pts, labels)
        got = pipe._infer_scene(pts, labels)
        np.testing.assert_array_equal(got["clusters"], cpu["clusters"])
        np.testing.assert_array_equal(got["pred_class"], cpu["pred_class"])
    assert pipe.programs.captures == 1 and pipe.programs.replays == 4


@pytest.mark.parametrize("name", ["pointnet2_cls_ssg", "pointnet2_cls_msg"])
def test_executor_replay_equals_eager(card, name):
    from pointnet_like_pose_estimation_tpu_torch.kernels.fused_sa import fused_sa_infer as fused
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.models.fast_infer import (
        build_pn2_msg_infer,
        build_pn2_ssg_infer,
    )

    build = build_pn2_ssg_infer if name == "pointnet2_cls_ssg" else build_pn2_msg_infer
    torch.manual_seed(0)
    fwd = build(build_model(name).eval())
    outs = []
    for seed in (4, 5):
        x = _clouds(4, 1024, seed).to(card)
        s0 = fused.launches
        got = fwd(x)
        torch.cuda.synchronize()
        assert fused.launches - s0 == (4 if seed == 4 else 2)         # warm-up and replay, then a replay
        with torch.inference_mode():
            assert _gap(got, fwd.body(x)) <= 1e-5
        outs.append(got[0])
    assert not torch.equal(outs[0], outs[1])
    assert (fwd.programs.captures, fwd.programs.replays) == (1, 2)
    assert fwd.programs.counts(("executor", 4, 1024, 3)) == {"fps": 2, "fused_sa": 2}


def test_captures_equal_the_distinct_buckets(card):
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline

    pipe = GraspPipeline.from_random(seed=3, device="cuda")
    rng = np.random.default_rng(0)
    shapes = [(3, 1100), (4, 1200), (1, 1100), (5, 1100), (8, 1280), (2, 700), (2, 700), (4, 2048)]
    for K, M in shapes:
        pipe.infer_clusters(rng.standard_normal((K, M, 3)).astype(np.float32) * 0.05)
    assert pipe.programs.captures == len(pipe.programs) == 4
    assert pipe.programs.replays == len(shapes)


def test_a_failed_capture_raises_and_runs_nothing_eagerly(card):
    """A program that reads the device back to the host (FPS from a start
    tensor checks its range on the host) cannot be captured: the call
    raises, and hands back no eager result. In a fresh interpreter, so that
    the failed capture leaves this process's stream alone."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps\n"
        "from pointnet_like_pose_estimation_tpu_torch.utils.programs import ProgramCache\n"
        "cache = ProgramCache('cuda')\n"
        "x = torch.rand(2, 256, 3, device='cuda')\n"
        "start = torch.zeros(2, dtype=torch.int32, device='cuda')\n"
        "try:\n"
        "    out = cache(('fps',), lambda p: fps(p, 16, start), (x,))\n"
        "except RuntimeError as e:\n"
        "    print('raised', cache.captures, cache.replays, len(cache))\n"
        "else:\n"
        "    print('returned', out.shape)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.stdout.strip().splitlines()[-1] == "raised 0 0 0", res.stdout + res.stderr


def test_cluster_point_truncation_is_a_replay(card, monkeypatch):
    """The staged path's truncation FPS: one program per bucket, equal to
    the CPU's, a second scene of the bucket a replay."""
    from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess as pp

    rng = np.random.default_rng(8)
    sizes = [1500, 700, 1100]
    labels = np.concatenate([np.full(n, c) for c, n in enumerate(sizes)])
    monkeypatch.setattr(pp, "dbscan", lambda *args, **kw: labels)
    programs = pp._TRUNCATION_PROGRAMS.setdefault(card, pp.ProgramCache(card))
    c0, r0 = programs.captures, programs.replays
    for _ in range(2):
        pts = np.concatenate([rng.uniform(-0.5, 0.5, (1, 3)) + 0.05 * rng.standard_normal((n, 3))
                              for n in sizes]).astype(np.float32)
        np.testing.assert_array_equal(pp.cluster_point(pts, device="cuda"), pp.cluster_point(pts, device="cpu"))
    assert (programs.captures - c0, programs.replays - r0) == (1, 2)


# --- the training programs (train/steps.py, train/loop.py) ---------------------------------------

# The programmed step against the eager step on the card. Both run the same
# kernels on the same inputs, but the backward of torch.gather (index_points)
# is an atomic scatter-add whose sums come in another order each run, so two
# eager runs already part: a gradient by rounding, and with Adam a parameter
# whose gradient is noise by a learning rate a step (Adam's step is the rate
# times the sign), which of them changing from run to run. So no element is
# held: a loss or metric within TRAIN_TOL (for Adam's epochs, within twice
# the gap between two eager runs A and B plus TRAIN_TOL), and after the steps
# the parameters and the BatchNorm statistics as vectors, their L2 distance
# from the eager run's within MOVED of how far the eager run's moved from the
# start (a step that read a stale rate or stale state parts them by a tenth
# of that or more). The distances are printed.
TRAIN_TOL = 1e-4
MOVED = 1e-2


def _copies(card, name, n, B=24, experiment=None, **overrides):
    """``n`` copies of a model on the card with its optimizer and scheduler
    (``make_optimizer``) and a generator, all in one state; the train split
    of a seeded dataset on the card (77 clouds); the cfg."""
    import copy

    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, load_checkpoint, make_optimizer
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _device_data

    cfg = TrainConfig.for_model(name, batch_size=B, **overrides)
    if experiment is None:
        model = _seeded(name, 40)
    else:
        model, _ = load_checkpoint(os.path.join(ROOT, "log", experiment, "checkpoints", "best.msgpack"),
                                   build_model(name))
    model = model.to(card)
    first = (model, *make_optimizer(cfg, model.parameters()))
    copies = [first] + [copy.deepcopy(first) for _ in range(n - 1)]
    gens = []
    for _ in range(n):
        gens.append(torch.Generator(device=card))
        gens[-1].set_state(torch.Generator(device=card).manual_seed(17).get_state())
    data = _device_data(load_dataset(build_dataset(15, seed=3), "train"), card)
    return cfg, [(*c, g) for c, g in zip(copies, gens)], data


def _within_spread(what, got, a, b, tol) -> tuple[float, float]:
    """A loss or metric ``got`` against ``a``: within twice ``b``'s distance
    from ``a`` plus ``tol``; returns both distances."""
    mine, theirs = float((got - a).abs()), float((b - a).abs())
    assert mine <= 2 * theirs + tol, f"{what}: {mine} from the eager run, which is {theirs} from another"
    return mine, theirs


def _held_by_movement(model, eager, start, what) -> dict:
    """The parameters and statistics of ``model`` against the eager run's
    (see MOVED); ``start`` is the state both began from. Returns, by kind,
    the distance over the eager run's movement."""
    def vec(state, keys):
        return torch.cat([state[k].detach().double().reshape(-1) for k in keys])

    got, want = model.state_dict(), eager.state_dict()
    kinds = {"parameter": [k for k, _ in eager.named_parameters()],
             "statistic": [k for k in want if k.endswith(("running_mean", "running_var"))]}
    ratios = {}
    for kind, keys in kinds.items():
        gap = float((vec(got, keys) - vec(want, keys)).norm())
        moved = float((vec(want, keys) - vec(start, keys)).norm())
        ratios[kind] = gap / moved
        assert gap <= MOVED * moved, f"{what}: {kind}s {gap} from the eager run's, which moved {moved}"
    return ratios


@pytest.mark.parametrize("name,experiment,launches,optimizer", [
    ("pointnet2_cls_ssg", "classification/r3_pointnet2_cls_ssg", 2, "sgd"),
    ("sign_msg", "pose/r5_sign_msg", 1, "adam"),
    ("pointnet_cls", None, 0, "adam"),
])
def test_programmed_train_step_equals_the_eager_step(card, name, experiment, launches, optimizer):
    """Three steps at batch 24 with augmentation and dropout drawn from the
    generator: the programmed step (captured at its first call, replayed
    at the next two) against the eager step on deep copies of the model,
    optimizer and generator: each step's loss and metric within TRAIN_TOL,
    the parameters and statistics after the three within MOVED of their
    movement; the generators consume the same draws; FPS and the ball query
    launch ``launches`` times a call, each call one run of the step.
    ``pointnet2_cls_ssg`` trains with SGD, whose step is linear in the
    gradient, so that the gather's rounding does not grow into Adam's
    flipped signs over the steps (the epochs below hold Adam)."""
    from pointnet_like_pose_estimation_tpu_torch.models import get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import make_train_step

    cfg, runs, data = _copies(card, name, 2, experiment=experiment, optimizer=optimizer)
    (model, opt, _, gen), (a, a_opt, _, a_gen) = runs
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(get_model_spec(name), cfg)
    for i in range(3):
        batch = {k: v[24 * i:24 * (i + 1)] for k, v in data.items()}
        f0, b0 = fps.launches, ball_query_multi.launches
        got = step(model, opt, batch, gen)
        torch.cuda.synchronize()
        assert (fps.launches - f0, ball_query_multi.launches - b0) == (launches, launches)
        got = {k: v.clone() for k, v in got.items()}
        want = step.eager(a, a_opt, batch, a_gen)
        for k in ("loss", "metric"):
            torch.testing.assert_close(got[k], want[k], rtol=TRAIN_TOL, atol=TRAIN_TOL, msg=f"step {i} {k}")
        assert torch.equal(gen.get_state(), a_gen.get_state())
    programs = step.cache(card)
    assert (programs.captures, programs.replays, programs.remade) == (1, 2, 0)
    print(f"{name} ({optimizer}): 3 steps, programmed against eager over the movement "
          f"{_held_by_movement(model, a, start, name)}")


def test_programmed_epochs_cross_a_steplr_boundary_as_the_eager_ones(card):
    """pointnet2_cls_ssg from the committed r3 checkpoint on the resident
    split (77 clouds, 3 steps of 24 an epoch), StepLR every epoch: two
    programmed epochs (one program, captured at the first step and replayed
    at the other 5) against two eager runs of the two epochs: the epochs'
    sums (see TRAIN_TOL), the learning rate tensor (filled in place: 1e-3,
    then 7e-4, then 4.9e-4), each epoch's movement of the parameters within
    MOVED of the eager run's (so the second epoch read the second rate), and
    the state after both (MOVED)."""
    from pointnet_like_pose_estimation_tpu_torch.models import get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import make_epoch_runner

    cfg, runs, data = _copies(card, "pointnet2_cls_ssg", 3, experiment="classification/r3_pointnet2_cls_ssg",
                              lr_step_epochs=1)
    (model, opt, sched, gen), (a, a_opt, a_sched, a_gen), (b, b_opt, b_sched, b_gen) = runs
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rate = opt.param_groups[0]["lr"]
    runner = make_epoch_runner(get_model_spec(cfg.model), cfg, 3)

    def params(m):
        return torch.cat([p.detach().double().reshape(-1) for p in m.parameters()])

    for epoch in range(2):
        before, a_before = params(model), params(a)
        f0 = fps.launches
        sums, done = runner(model, opt, data, gen)
        torch.cuda.synchronize()
        assert done == 3 and fps.launches - f0 == 2 * 3
        want, want_done = runner.eager(a, a_opt, data, a_gen)
        other, _ = runner.eager(b, b_opt, data, b_gen)
        _within_spread(f"epoch {epoch} loss sum", sums[0], want[0], other[0], TRAIN_TOL)
        _within_spread(f"epoch {epoch} metric sum", sums[1], want[1], other[1], TRAIN_TOL)
        moved, a_moved = float((params(model) - before).norm()), float((params(a) - a_before).norm())
        assert abs(moved - a_moved) <= MOVED * a_moved, f"epoch {epoch}: moved {moved}, the eager run {a_moved}"
        for s in (sched, a_sched, b_sched):
            s.step()
        assert opt.param_groups[0]["lr"] is rate
        assert float(rate) == float(a_opt.param_groups[0]["lr"]) == pytest.approx(1e-3 * 0.7 ** (epoch + 1))
    programs = runner.step.cache(card)
    assert (programs.captures, programs.replays, programs.remade) == (1, 5, 0)
    print(f"epochs: over the movement {_held_by_movement(model, a, start, 'epochs')}, eager against eager "
          f"{_held_by_movement(b, a, start, 'epochs')}")


def test_a_restore_replays_on_the_restored_tensors(card, tmp_path):
    """An epoch captured, ``latest`` saved, another epoch, then the state
    restored from ``latest.pt`` in place: the same epoch again is a replay
    of the program captured before (no capture, nothing made anew), and its
    sums and the BatchNorm statistics after it equal those of the epoch
    run after the save, whose generator state it restored (TRAIN_TOL)."""
    from pointnet_like_pose_estimation_tpu_torch.models import get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import TrainState, make_epoch_runner
    from pointnet_like_pose_estimation_tpu_torch.train.loop import restore_checkpoint, save_checkpoint

    cfg, runs, data = _copies(card, "pointnet2_cls_ssg", 1, experiment="classification/r3_pointnet2_cls_ssg")
    (model, opt, sched, gen), = runs
    state = TrainState(model, opt, sched, gen)
    runner = make_epoch_runner(get_model_spec(cfg.model), cfg, 3)
    runner(model, opt, data, gen)
    path = str(tmp_path / "latest.pt")
    save_checkpoint(path, state, 0, 0.0)
    first, _ = runner(model, opt, data, gen)
    first = first.clone()
    after = {k: v.clone() for k, v in model.state_dict().items()}
    restore_checkpoint(path, state)
    again, _ = runner(model, opt, data, gen)
    programs = runner.step.cache(card)
    assert (programs.captures, programs.replays, programs.remade) == (1, 8, 0)
    torch.testing.assert_close(again, first, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, after[k], rtol=TRAIN_TOL, atol=TRAIN_TOL, msg=k)


def test_eval_program_equals_the_eager_eval(card):
    """``evaluate``'s program over a padded split (140 test clouds at batch
    24: 6 batches, 4 pad rows) against the same batches' sums run eagerly
    on the card: counts equal, floats within 1e-5; a second pass replays; a
    replaced parameter makes the program anew."""
    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, load_checkpoint
    from pointnet_like_pose_estimation_tpu_torch.train.loop import (
        _batch_sums,
        _device_eval_batches,
        _eval_sums,
        _host_sums,
        eval_programs,
    )

    name = "pointnet2_cls_ssg"
    model, _ = load_checkpoint(
        os.path.join(ROOT, "log/classification/r3_pointnet2_cls_ssg/checkpoints/best.msgpack"), build_model(name))
    model = model.to(card).eval()
    spec, cfg = get_model_spec(name), TrainConfig.for_model(name, batch_size=24)
    test = load_dataset(build_dataset(80, seed=0), "test")
    batches = _device_eval_batches(test, 24, card)
    assert len(batches) == 6 and float(batches[-1]["valid"].sum()) == len(test) - 5 * 24
    with torch.no_grad():
        want = _host_sums(spec, cfg, sum(_batch_sums(spec, cfg, model, b) for b in batches))
    f0 = fps.launches
    got = _eval_sums(spec, cfg, model, batches, card)
    assert fps.launches - f0 == 2 * len(batches)
    for k in ("n", "per_class_count", "per_class_correct"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    programs = eval_programs(model, card)
    assert (programs.captures, programs.replays) == (1, len(batches) - 1)
    again = _eval_sums(spec, cfg, model, batches, card)
    assert all(np.array_equal(again[k], got[k]) for k in got)
    with torch.no_grad():
        model.head.fc_2.bias = torch.nn.Parameter(model.head.fc_2.bias.clone())
    _eval_sums(spec, cfg, model, batches, card)
    assert (programs.captures, programs.remade) == (2, 1)


def test_a_failed_training_capture_raises_and_runs_the_step_once(card):
    """A train step whose forward reads the device back to the host cannot
    be captured: the first call runs the step (its own run), the capture
    raises, no program is kept, and nothing runs eagerly after it (the
    optimizer stepped once). In a fresh interpreter, as the serving test."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec\n"
        "from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, make_optimizer, make_train_step\n"
        "cfg = TrainConfig.for_model('rotation', batch_size=4, augment=False)\n"
        "model = build_model('rotation').cuda()\n"
        "forward = model.forward\n"
        "model.forward = lambda x: forward(x) + 0 * float(x.sum())\n"
        "opt, _ = make_optimizer(cfg, model.parameters())\n"
        "batch = {'points': torch.rand(4, 256, 3, device='cuda'),\n"
        "         'labels': torch.zeros(4, dtype=torch.long, device='cuda'),\n"
        "         'rot': torch.rand(4, 3, device='cuda')}\n"
        "step = make_train_step(get_model_spec('rotation'), cfg)\n"
        "try:\n"
        "    step(model, opt, batch, draws={'augment': None, 'dropout': None})\n"
        "except RuntimeError:\n"
        "    c = step.cache('cuda')\n"
        "    steps = sorted({int(s['step']) for s in opt.state.values()})\n"
        "    print('raised', c.captures, c.replays, len(c), steps)\n"
        "else:\n"
        "    print('returned')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.stdout.strip().splitlines()[-1] == "raised 0 0 0 [1]", res.stdout + res.stderr


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizers_take_a_device_learning_rate_under_capture(card, optimizer):
    """``make_optimizer`` on the card (Adam capturable, SGD fused, the rate
    a float32 tensor on the card): a step captured by StepProgramCache and
    replayed across a StepLR boundary (in place) and a ``restore_optimizer``
    (the saved rate a float, as in older checkpoints) equals the same
    steps run eagerly on a copy."""
    import copy

    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, make_optimizer
    from pointnet_like_pose_estimation_tpu_torch.train.state import restore_optimizer
    from pointnet_like_pose_estimation_tpu_torch.utils.programs import StepProgramCache

    torch.manual_seed(0)
    cfg = TrainConfig(optimizer=optimizer, learning_rate=1e-2, lr_step_epochs=1, lr_gamma=0.5)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 1)).to(card)
    opt, sched = make_optimizer(cfg, model.parameters())
    twin, twin_opt, twin_sched = copy.deepcopy((model, opt, sched))
    rate = opt.param_groups[0]["lr"]
    assert rate.device.type == card.type
    x = torch.randn(32, 8, device=card)

    def body(m, o, inp):
        o.zero_grad(set_to_none=False)
        loss = m(inp).square().mean()
        loss.backward()
        o.step()
        return loss.detach()

    programs = StepProgramCache(card)
    for i in range(4):
        got = programs(("step",), lambda inp: body(model, opt, inp), (x,),
                       lambda: [*model.parameters(), *(p.grad for p in model.parameters()), rate])
        want = body(twin, twin_opt, x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        sched.step()
        twin_sched.step()
        assert opt.param_groups[0]["lr"] is rate
        if i == 1:
            saved = copy.deepcopy(opt.state_dict())
            saved["param_groups"][0]["lr"] = float(saved["param_groups"][0]["lr"])
            restore_optimizer(opt, saved)
            assert opt.param_groups[0]["lr"] is rate
    assert (programs.captures, programs.replays, programs.remade) == (1, 3, 0)
    for p, q in zip(model.parameters(), twin.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6)


def test_per_step_path_trains_through_the_program(card, tmp_path):
    """``train`` with the split on the host (``device_data`` off): every
    step a call of the programmed step with its batch copied in, every
    batch of the per-epoch eval a call of the eval program, each call one
    run: FPS twice a step and twice an eval batch, over two epochs."""
    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, train

    fields = build_dataset(10, seed=3)
    train_ds, test_ds = load_dataset(fields, "train"), load_dataset(fields, "test")
    cfg = TrainConfig.for_model("pointnet2_cls_ssg", batch_size=24, epochs=2, device_data=False,
                                log_dir=str(tmp_path))
    f0 = fps.launches
    _, history = train(cfg, train_ds, test_ds, resume=False)
    torch.cuda.synchronize()
    steps, batches = len(train_ds) // 24, -(-len(test_ds) // 24)
    assert fps.launches - f0 == 2 * 2 * (steps + batches)
    assert [r["epoch"] for r in history] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["test_loss"]) for r in history)


def test_spans_and_device_records_share_a_clock(card):
    """A traced request: the replay's kernels start after its
    ``program.replay`` opens, the copies back lie inside
    ``serve.copy_back``, and no span is drawn on the device's timeline,
    where a reader of the timeline would count it as work."""
    from torch.profiler import ProfilerActivity, profile

    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline
    from pointnet_like_pose_estimation_tpu_torch.utils.profiling import SPANS, idle_by_span

    pipe = GraspPipeline.from_random(seed=1, device=card)
    x = (0.05 * np.random.default_rng(0).standard_normal((8, 2048, 3))).astype(np.float32)
    pipe.infer_clusters(x)                  # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.infer_clusters(x)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    dev = [e for e in events if e.device_type == cuda]
    assert not [e.name for e in dev if e.name in SPANS]
    host = {e.name: e.time_range for e in events if e.device_type != cuda and e.name in SPANS}
    kernels = [e.time_range for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    back = [e.time_range for e in dev if "DtoH" in e.name]
    assert kernels and back, sorted({e.name for e in dev})
    replay, copy_back = host["program.replay"], host["serve.copy_back"]
    assert all(k.start >= replay.start for k in kernels)
    assert all(copy_back.start <= c.start and c.end <= copy_back.end for c in back)
    split = idle_by_span(events)
    assert {k for k in split if k} == {"serve.upload", "program.replay", "serve.copy_back"}
    assert 0 < sum(v["idle_s"] for v in split.values()) < (copy_back.end - host["serve.upload"].start) / 1e6


# --- Point Transformer: the kNN kernel, the classifier and its request program -------------------

# (N, S, k) of the nine kNN queries of a 1024-point forward: each stage's points among themselves,
# each strided TransitionDown's centroids among the points before (harness/bounds_pt.py knn_calls)
PT_KNN_CALLS = [(1024, 1024, 8), (1024, 256, 16), (256, 256, 16), (256, 64, 16), (64, 64, 16), (64, 16, 16),
                (16, 16, 16), (16, 4, 16), (4, 4, 4)]


@pytest.mark.parametrize("N,S,k", PT_KNN_CALLS + [(5000, 300, 7), (16384, 65, 16)])
def test_knn_kernel_matches_plain_version(card, N, S, k):
    """Every shape of a 32-cluster request, a cloud above 48 KB of shared
    memory and the largest the kernel takes: the indices equal the plain
    version's on the card. A quarter of the points repeat others, so runs
    of distances tie and go to the lower index; the queries are points of
    the cloud, as in the model, and others."""
    from pointnet_like_pose_estimation_tpu_torch.kernels.knn import knn, knn_reference

    B = 32 if N <= 1024 else 2
    pts = _clouds(B, N, N + S)
    pts[:, N - N // 4:] = pts[:, :N // 4]
    pts = pts.to(card)
    queries = torch.cat([pts[:, :S - S // 4], torch.rand(B, S // 4, 3, device=card) - 0.5], dim=1)
    got = knn(pts, queries, k)
    torch.cuda.synchronize()
    assert torch.equal(got, knn_reference(pts, queries, k))


# (N, K, C) of the attention's layers in a 1024-point forward, one shape a stage
PT_ATTENTION_SHAPES = [(1024, 8, 32), (256, 16, 64), (64, 16, 128), (16, 16, 256), (4, 4, 512)]


@pytest.mark.parametrize("N,K,C", PT_ATTENTION_SHAPES + [(301, 5, 64), (7, 7, 64)])
@pytest.mark.parametrize("scale", [3.0, 300.0])
def test_pt_attention_kernel_matches_plain_version(card, N, K, C, scale):
    """The one-pass attention at each stage's shape of a 32-cluster request,
    a ragged last tile of queries (301 points, 12 tiles of 25 and one;
    share planes 4) and a cloud of one tile, on the benchmark's weights, with
    features of a few units and of hundreds (the request's grow to
    thousands): on the card its route (``attention_reason`` None), and its
    distance from the plain version run in float64 no more than 10 times
    the plain float32 version's (both sum in float32, in other orders; the
    softmax turns a logit's last bits into the output's, in both alike)
    and 1e-6 of the output's scale."""
    import copy

    from pointnet_like_pose_estimation_tpu_torch.kernels.pt_attention import pt_attention, pt_attention_reference
    from pointnet_like_pose_estimation_tpu_torch.nn.point_transformer import (
        PointTransformerBlock,
        attention_reason,
    )
    from pointnet_like_pose_estimation_tpu_torch.ops.grouping import query_knn

    clusters_pt, _ = _pt_bench()
    share = 4 if N == 301 else 8
    block = PointTransformerBlock(C, share).eval()
    block.load_state_dict(clusters_pt.model_state(PointTransformerBlock(C, share), 2**31 + N + C, "cpu"))
    block = block.to(card)
    attn, bn2 = block.attn, block.bn2
    B = 32
    p = _clouds(B, N, N + K).to(card)
    x = torch.relu(scale * torch.randn(B, N, C, generator=torch.Generator().manual_seed(C))).to(card)
    with torch.inference_mode():
        idx = query_knn(K, p, p)
        assert attention_reason(attn, x, idx, bn2) is None
        q, k, v = attn.q(x), attn.k(x), attn.v(x)
        got = pt_attention(p, q, k, v, idx, attn, bn2)
        want = pt_attention_reference(p, q, k, v, idx, attn, bn2)
        exact = pt_attention_reference(p.double(), q.double(), k.double(), v.double(), idx,
                                       copy.deepcopy(attn).double(), copy.deepcopy(bn2).double())
    torch.cuda.synchronize()
    out_scale = float(exact.abs().max())
    err, plain = float((got.double() - exact).abs().max()), float((want.double() - exact).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= 10 * plain + 1e-6 * out_scale, (err, plain, out_scale)


def test_the_block_takes_the_one_pass_attention_on_the_card(card):
    """An eval-mode block on the card under ``inference_mode`` launches the
    pass once and forms no neighbourhood tensor; with a gradient wanted it
    takes the composed route, and both give the same output within float32
    reordering."""
    from pointnet_like_pose_estimation_tpu_torch.kernels.pt_attention import pt_attention
    from pointnet_like_pose_estimation_tpu_torch.nn.point_transformer import PointTransformerBlock
    from pointnet_like_pose_estimation_tpu_torch.ops.grouping import count_grouped, query_knn

    clusters_pt, _ = _pt_bench()
    block = PointTransformerBlock(64).eval()
    block.load_state_dict(clusters_pt.model_state(PointTransformerBlock(64), 11, "cpu"))
    block = block.to(card)
    p = _clouds(4, 256, 3).to(card)
    x = torch.rand(4, 256, 64, device=card)
    idx = query_knn(16, p, p)
    launches, grouped = pt_attention.launches, count_grouped.bytes
    with torch.inference_mode():
        fused = block(p, x, idx)
    assert (pt_attention.launches - launches, count_grouped.bytes - grouped) == (1, 0)
    composed = block(p, x, idx).detach()
    assert pt_attention.launches - launches == 1 and count_grouped.bytes > grouped
    assert float((fused - composed).abs().max()) <= 1e-5 * float(composed.abs().max())


def _pt_bench():
    import sys

    bench = os.path.join(ROOT, "bench_port")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from kinds import clusters_pt
    from reference import point_transformer as PT

    return clusters_pt, PT


def test_point_transformer_on_card_matches_the_cpu_reference(card):
    """``point_transformer_cls`` at the published widths on 8 clouds of 1024
    points on the card against the benchmark's plain reference on the CPU,
    on the benchmark's weights: the kNN indices are equal on both, so only
    the products' summation order parts them; the random weights grow the
    features to logits of thousands, and the gap is held to 1e-5 of
    each output's largest value, the classes equal where the best two
    log-probabilities are further apart than that."""
    from pointnet_like_pose_estimation_tpu_torch.models import build_model

    clusters_pt, PT = _pt_bench()
    state = clusters_pt.model_state(PT.build(PT.NAME), 2**31 + 9, "cpu")
    ref = PT.build(PT.NAME).eval()
    ref.load_state_dict(state, strict=True)
    port = build_model("point_transformer_cls").eval()
    port.load_state_dict(state, strict=True)
    x = _clouds(8, 1024, 5)
    with torch.inference_mode():
        want = ref(x)
        got = port.to(card)(x.to(card))
    torch.cuda.synchronize()
    for g, w in zip(got[:2], want[:2]):
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())
    top2 = want[0].topk(2, dim=-1).values
    sure = top2[:, 0] - top2[:, 1] > 1e-5 * float(want[0].abs().max())
    assert torch.equal(got[2].cpu()[sure], want[2][sure])


def test_pt_request_replay_equals_eager_and_counts_its_work(card):
    """The request program with ``classifier="point_transformer_cls"``: its
    replay against its function called eagerly on the card (classes exact,
    floats within 1e-5 of their scale; expected bit for bit), and the
    counters its capture recorded at K = 4: the resampling FPS and four
    strided ones, nine kNN queries, 13 one-pass attentions (each with its
    block's bn2 pair and its own pairs), the eval pairs (14 of the
    classifier's, 16 of the PointNet heads'; the pooled last pairs of its 4
    TransitionDowns and the 4 heads) and the strided TransitionDowns'
    grouped inputs, 1,048,320 bytes a cluster: the attention forms no
    neighbourhood tensor."""
    from pointnet_like_pose_estimation_tpu_torch.ops.grouping import count_grouped
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    pipe = GraspPipeline.from_random(PipelineConfig(classifier="point_transformer_cls"), seed=3, device="cuda")
    rng = np.random.default_rng(5)
    clusters = (rng.uniform(-0.5, 0.5, (4, 1, 3)) + 0.05 * rng.standard_normal((4, 1300, 3))).astype(np.float32)
    key, fn, inputs, _ = pipe._request_call(clusters)
    g0 = count_grouped.bytes
    replay = pipe.programs(key, fn, inputs)
    torch.cuda.synchronize()
    assert pipe.programs.counts(key) == {"fps": 5, "knn": 9, "pt_attention": 13, "bn_relu_eval": 30,
                                         "bn_relu_eval_pool": 8, "grouped_bytes": 4 * 1_048_320}
    assert count_grouped.bytes - g0 == 2 * pipe.programs.counts(key)["grouped_bytes"]
    with torch.inference_mode():
        eager = fn(*(x.to(card) for x in inputs))
    scale = float(eager["log_probs"].abs().max())
    assert torch.equal(replay["pred_class"], eager["pred_class"])
    assert float((replay["log_probs"] - eager["log_probs"]).abs().max()) <= 1e-5 * scale
    assert _gap({k: v for k, v in replay.items() if k != "log_probs"},
                {k: v for k, v in eager.items() if k != "log_probs"}) <= 1e-5
