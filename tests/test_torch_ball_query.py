"""The ball query's launch plan on the CPU, and its plain version at the
shapes of the pose heads (10 spliced channels, three scales) against the JAX
package's Pallas kernel in interpret mode. Indices must be equal exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointnet_like_pose_estimation_tpu.kernels.ball_group import ball_query_multi_pallas
from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import (
    MAX_SHARED_BYTES,
    STEP,
    BallQueryPlan,
    ball_query_multi,
    ball_query_plan,
)

SSG_SA1, SSG_SA2 = (32,), (64,)
MSG_SA1, MSG_SA2 = (16, 32, 128), (32, 64, 128)


def _spliced(rng, B, N, num_classes):
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    onehot = np.zeros((B, N, num_classes), np.float32)
    onehot[np.arange(B), :, rng.integers(0, num_classes, B)] = 1.0
    return np.concatenate([x, onehot], axis=-1)


@pytest.mark.parametrize(
    "radii,ks",
    [((0.3,), (8,)), ((0.1, 0.2, 0.4), (4, 8, 16)), ((0.2, 0.4, 0.8), (8, 16, 32))],
    ids=["single", "msg_sa1_radii", "msg_sa2_radii"],
)
def test_ten_channel_ball_query_matches_pallas(radii, ks):
    """The pose heads' shape: P = 10, the one-hot channels equal within a
    cloud; centroids taken from the cloud and, for the last eight, far off
    (empty balls at every scale)."""
    rng = np.random.default_rng(7)
    B, N = 2, 128
    pts = _spliced(rng, B, N, 7)
    cent = np.concatenate([pts[:, ::4][:, :24], pts[:, :8] + 5.0], axis=1).astype(np.float32)
    got = ball_query_multi(torch.from_numpy(pts), torch.from_numpy(cent), radii, ks).numpy()
    want = ball_query_multi_pallas(jnp.asarray(pts), jnp.asarray(cent), radii, ks, 32, True)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (B, 32, sum(ks)) and got.dtype == np.int32
    assert (got[:, 24:] == N - 1).all()


@pytest.mark.parametrize(
    "N,P,ks",
    [(1024, 3, SSG_SA1), (512, 3, SSG_SA2), (1024, 3, MSG_SA1), (512, 3, MSG_SA2),
     (1024, 10, SSG_SA1), (512, 10, SSG_SA2), (1024, 10, MSG_SA1), (512, 10, MSG_SA2),
     (128, 10, MSG_SA1), (1000, 3, MSG_SA1), (300, 7, (8, 24)), (40000, 3, (16, 32))],
)
def test_every_path_shape_gets_a_plan(N, P, ks):
    plan = ball_query_plan(N, P, ks)
    assert isinstance(plan, BallQueryPlan)
    assert (plan.tile, plan.split) in ((64, 4), (128, 2), (64, 2), (128, 1), (64, 1), (32, 1))
    assert STEP > 0 and plan.held >= len(ks) and plan.held in (1, 3, 8)
    # one formula: the cloud, then per thread one segment of sum(ks) indices and `held` counts
    threads = plan.tile * plan.split
    assert plan.shared_bytes == plan.cloud_bytes + 4 * threads * (sum(ks) + plan.held)
    assert plan.shared_bytes <= MAX_SHARED_BYTES
    # |p|^2 and P channels in whole 16-byte vectors, N in whole steps
    staged = 16 * -(-(P + 1) // 4) * (-(-N // STEP) * STEP)
    assert plan.cloud_bytes in (staged, 0)
    assert (plan.cloud_bytes == 0) == (staged + 4 * 32 * (sum(ks) + plan.held) > MAX_SHARED_BYTES)


def test_plan_splits_centroids_while_the_segments_fit():
    """Four threads a centroid up to 64 indices, two above; the split and
    then the tile give way before the cloud leaves shared memory."""
    assert ball_query_plan(1024, 3, SSG_SA1)[:2] == (64, 4)
    assert ball_query_plan(512, 3, SSG_SA2)[:2] == (64, 4)
    assert ball_query_plan(1024, 3, (65,))[:2] == (128, 2)
    assert ball_query_plan(1024, 3, MSG_SA1)[:2] == (128, 2)
    assert ball_query_plan(1024, 10, MSG_SA1)[:2] == (128, 2)
    assert ball_query_plan(512, 3, MSG_SA2)[:2] == (64, 2)        # 224 indices: 256 threads do not fit
    assert ball_query_plan(4096, 3, (600,))[:2] == (64, 1)


def test_plan_keeps_the_cloud_and_shrinks_the_block_first():
    """One point more than fits beside the smallest block (32 centroids, one
    thread each) takes the global path, with the first block again."""
    ks = MSG_SA1                                   # 176 indices a centroid, 3 counts
    step = STEP
    fits = lambda n, threads: 16 * n + 4 * threads * (sum(ks) + 3) <= MAX_SHARED_BYTES   # noqa: E731
    n256 = max(n for n in range(step, 20000, step) if fits(n, 256))
    assert ball_query_plan(n256, 3, ks)[:2] == (128, 2)
    assert ball_query_plan(n256 + step, 3, ks)[:2] == (64, 2)
    assert ball_query_plan(n256 + step, 3, ks).cloud_bytes == 16 * (n256 + step)
    n32 = max(n for n in range(step, 20000, step) if fits(n, 32))
    assert ball_query_plan(n32, 3, ks)[:2] == (32, 1)
    over = ball_query_plan(n32 + 1, 3, ks)
    assert over.cloud_bytes == 0 and over[:2] == (128, 2)
    assert over.shared_bytes == 4 * 256 * (sum(ks) + 3)


def test_plan_depends_on_the_shape_alone_and_refuses_what_cannot_fit():
    assert ball_query_plan(1024, 3, [32]) == ball_query_plan(1024, 3, (32,))
    assert ball_query_plan(1000, 3, (32,)).cloud_bytes == 16 * 1008      # N in whole steps of 16
    with pytest.raises(ValueError, match="no plan"):
        ball_query_plan(0, 3, (32,))
    with pytest.raises(ValueError, match="no plan"):
        ball_query_plan(1024, 33, (32,))
    with pytest.raises(ValueError, match="no plan"):
        ball_query_plan(1024, 3, (32, 0))
    with pytest.raises(ValueError, match="shared memory"):
        ball_query_plan(1024, 3, (2000,))
