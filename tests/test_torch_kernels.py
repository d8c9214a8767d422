"""The port's kernel modules on the CPU: the plain versions of FPS and ball
query against the JAX package's Pallas kernels (interpret mode) and XLA
ops. Indices must be equal exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointnet_like_pose_estimation_tpu.kernels.ball_group import ball_query_multi_pallas
from pointnet_like_pose_estimation_tpu.kernels.fps import fps_pallas
from pointnet_like_pose_estimation_tpu.ops import farthest_point_sample as jax_fps
from pointnet_like_pose_estimation_tpu.ops import query_ball_point as jax_query_ball_point
from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import (
    ball_query,
    ball_query_multi,
    ball_query_reference,
)
from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps, fps_reference


def _unit_clouds(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    return x / np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]


@pytest.mark.parametrize("with_start", [False, True])
def test_fps_reference_matches_pallas_and_xla(with_start):
    rng = np.random.default_rng(0)
    B, N, S = 2, 128, 32
    pts = _unit_clouds(rng, (B, N, 3))
    start = np.array([5, 127], np.int32) if with_start else np.zeros(B, np.int32)
    got = fps_reference(torch.from_numpy(pts), S, torch.from_numpy(start)).numpy()
    pallas = fps_pallas(jnp.asarray(pts), S, start_idx=jnp.asarray(start), interpret=True)
    xla = jax_fps(jnp.asarray(pts), S, start_idx=jnp.asarray(start))
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got, np.asarray(xla))
    assert got.dtype == np.int32


@pytest.mark.parametrize("kind", ["spliced", "random"])
def test_fps_reference_at_ten_channels_matches_pallas_and_xla(kind):
    """C = 10, the channel count of a pose head's FPS calls (the kernel's
    second register-path instance): a unit cloud spliced with a 7-class
    one-hot (a different class per cloud), and 10 random channels."""
    rng = np.random.default_rng(2)
    B, N, S = 3, 128, 48
    if kind == "spliced":
        onehot = np.zeros((B, N, 7), np.float32)
        onehot[np.arange(B), :, rng.integers(0, 7, B)] = 1.0
        pts = np.concatenate([_unit_clouds(rng, (B, N, 3)), onehot], -1)
    else:
        pts = rng.standard_normal((B, N, 10)).astype(np.float32)
    start = np.array([0, 77, 127], np.int32)
    got = fps_reference(torch.from_numpy(pts), S, torch.from_numpy(start)).numpy()
    pallas = fps_pallas(jnp.asarray(pts), S, start_idx=jnp.asarray(start), interpret=True)
    xla = jax_fps(jnp.asarray(pts), S, start_idx=jnp.asarray(start))
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got, np.asarray(xla))


def test_fps_reference_above_the_shared_limit_matches_xla():
    """60,000 points, above the 57,856 that the kernel's shared path holds:
    the plain version (the global path's reference on the card) picks the
    JAX package's indices."""
    pts = _unit_clouds(np.random.default_rng(4), (1, 60_000, 3))
    got = fps_reference(torch.from_numpy(pts), 64).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_fps(jnp.asarray(pts), 64)))


def test_fps_ties_take_the_lowest_index():
    """A tiled cloud (the resample path for M < num_points) holds exact
    duplicates, so the argmax ties; the first index must win."""
    rng = np.random.default_rng(1)
    pts = np.tile(_unit_clouds(rng, (2, 40, 3)), (1, 4, 1))   # [2, 160, 3]
    got = fps(torch.from_numpy(pts), 64).numpy()
    want = np.asarray(jax_fps(jnp.asarray(pts), 64))
    np.testing.assert_array_equal(got, want)
    assert got.max() < 40


@pytest.mark.parametrize(
    "radii,ks",
    [((0.3,), (8,)), ((0.1, 0.2, 0.4), (4, 8, 16))],
    ids=["single", "three_scales"],
)
def test_ball_query_reference_matches_pallas(radii, ks):
    rng = np.random.default_rng(2)
    B, N, S = 2, 128, 32
    pts = _unit_clouds(rng, (B, N, 3))
    cent = pts[:, ::4]
    got = ball_query_multi(torch.from_numpy(pts), torch.from_numpy(cent), radii, ks).numpy()
    want = ball_query_multi_pallas(jnp.asarray(pts), jnp.asarray(cent), radii, ks, 32, True)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (B, S, sum(ks)) and got.dtype == np.int32


def test_ball_query_spliced_channels_match_xla():
    """Distances use all P channels (coordinates plus a spliced one-hot)."""
    rng = np.random.default_rng(3)
    B, N = 2, 128
    xyz = _unit_clouds(rng, (B, N, 3))
    onehot = np.zeros((B, N, 4), np.float32)
    onehot[:, : N // 2, 1] = 1.0
    onehot[:, N // 2 :, 2] = 1.0
    pts = np.concatenate([xyz, onehot], -1)
    cent = pts[:, ::4]
    got = ball_query(torch.from_numpy(pts), torch.from_numpy(cent), 0.9, 16).numpy()
    want = jax_query_ball_point(0.9, 16, jnp.asarray(pts), jnp.asarray(cent))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_ball_query_empty_and_short_balls():
    """Fewer than K in the ball: pad with the first in-ball index. No point
    in the ball: every slot is N-1."""
    rng = np.random.default_rng(4)
    B, N, K = 2, 128, 16
    pts = _unit_clouds(rng, (B, N, 3))
    cent = np.concatenate([pts[:, :8], np.full((B, 8, 3), 5.0, np.float32)], axis=1)
    got = ball_query_reference(torch.from_numpy(pts), torch.from_numpy(cent), (0.15,), (K,)).numpy()
    want = ball_query_multi_pallas(jnp.asarray(pts), jnp.asarray(cent), (0.15,), (K,), 16, True)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[:, 8:] == N - 1).all()
    short = got[:, :8]
    assert (short[..., -1] == short[..., 0]).any()   # some ball holds fewer than K


def test_wrappers_refuse_devices_without_a_kernel():
    pts = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fps(pts, 4)
    with pytest.raises(ValueError, match="no kernel"):
        ball_query(pts, pts, 0.1, 4)


def test_wrappers_validate_arguments():
    pts = torch.zeros((2, 8, 3))
    with pytest.raises(ValueError, match="start_idx"):
        fps(pts, 4, start_idx=8)
    with pytest.raises(ValueError, match="bad scales"):
        ball_query_multi(pts, pts, (0.1, 0.2), (4,))
