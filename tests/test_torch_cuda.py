"""The port's CUDA kernels on the card against their plain versions, and
the serving path and the fused-SA executors on the card against the same
code on the CPU. Skipped
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
from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps, fps_reference
from pointnet_like_pose_estimation_tpu_torch.kernels.fused_sa import (
    fused_sa_infer,
    fused_sa_reference,
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


@pytest.mark.parametrize("B,N,S", [(4, 1024, 512), (2, 3000, 1024), (3, 100, 200)])
def test_fps_kernel_matches_plain_version(card, B, N, S):
    pts = _clouds(B, N, 0).to(card)
    start = torch.arange(B, dtype=torch.int32, device=card) * 7 % N
    got = fps(pts, S, start)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_reference(pts, S, start))


@pytest.mark.parametrize(
    "radii,ks", [((0.2,), (32,)), ((0.1, 0.2, 0.4), (16, 32, 128)), ((0.05,), (64,))]
)
def test_ball_query_kernel_matches_plain_version(card, radii, ks):
    pts = _clouds(2, 1024, 1).to(card)
    cent = torch.cat([pts[:, ::4], torch.full((2, 8, 3), 9.0, device=card)], dim=1)
    got = ball_query_multi(pts, cent, radii, ks)
    torch.cuda.synchronize()
    assert torch.equal(got, ball_query_reference(pts, cent, radii, ks))


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


@pytest.mark.parametrize(
    "N,D,S,radii,ks,widths,offset",
    [
        (1024, 0, 512, (0.2,), (32,), ((64, 64, 128),), 0.0),
        (512, 320, 128, (0.2, 0.4, 0.8), (32, 64, 128),
         ((64, 64, 128), (128, 128, 256), (128, 128, 256)), 0.0),
        (1024, 0, 512, (0.2,), (32,), ((64, 64, 128),), 4.0),
    ],
    ids=["ssg_sa1", "msg_sa2", "empty_balls"],
)
def test_fused_sa_kernel_matches_plain_version(card, N, D, S, radii, ks, widths, offset):
    """Selected indices exact; features to 1e-4 (f32 sums in another order)."""
    rng = np.random.default_rng(3)
    B = 2
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
