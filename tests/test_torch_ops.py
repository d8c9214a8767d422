"""The port's ops on the CPU against the JAX package's ops, on the same
seeded numpy inputs. Float tolerances: 1e-5 absolute on unit-scale clouds
(float32 sums taken in another order); gathers and indices exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointnet_like_pose_estimation_tpu import ops as jops
from pointnet_like_pose_estimation_tpu.data.augment import splice_onehot as jax_splice_onehot
from pointnet_like_pose_estimation_tpu_torch import ops as tops
from pointnet_like_pose_estimation_tpu_torch.data.augment import splice_onehot

RNG = np.random.default_rng(7)
CLOUD = RNG.standard_normal((2, 128, 3)).astype(np.float32) * 0.3
FEAT = RNG.standard_normal((2, 128, 5)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_square_distance():
    got = tops.square_distance(_t(CLOUD[:, :32]), _t(CLOUD)).numpy()
    want = np.asarray(jops.square_distance(jnp.asarray(CLOUD[:, :32]), jnp.asarray(CLOUD)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("idx_shape", [(2, 16), (2, 16, 4)])
def test_index_points(idx_shape):
    idx = RNG.integers(0, 128, idx_shape).astype(np.int32)
    got = tops.index_points(_t(FEAT), _t(idx)).numpy()
    want = np.asarray(jops.index_points(jnp.asarray(FEAT), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)


def test_normalize_cloud():
    x = CLOUD * 4.0 + 1.5
    got = tops.normalize_cloud(_t(x)).numpy()
    want = np.asarray(jops.normalize_cloud(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_euler_rotation_matrix():
    ang = RNG.uniform(-np.pi, np.pi, (6, 3)).astype(np.float32)
    got = tops.euler_rotation_matrix(_t(ang)).numpy()
    want = np.asarray(jops.euler_rotation_matrix(jnp.asarray(ang)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_features", [False, True])
def test_sample_and_group(with_features):
    feat = FEAT if with_features else None
    cent, grouped = tops.sample_and_group(
        _t(CLOUD), None if feat is None else _t(feat), 32, 8, 0.3
    )
    jcent, jgrouped = jops.sample_and_group(
        jnp.asarray(CLOUD), None if feat is None else jnp.asarray(feat), 32, 8, 0.3
    )
    np.testing.assert_array_equal(cent.numpy(), np.asarray(jcent))
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(jgrouped))
    assert grouped.shape == (2, 32, 8, 3 + (5 if with_features else 0))


@pytest.mark.parametrize("with_features", [False, True])
def test_sample_and_group_all(with_features):
    feat = FEAT if with_features else None
    cent, grouped = tops.sample_and_group_all(_t(CLOUD), None if feat is None else _t(feat))
    jcent, jgrouped = jops.sample_and_group_all(
        jnp.asarray(CLOUD), None if feat is None else jnp.asarray(feat)
    )
    np.testing.assert_array_equal(cent.numpy(), np.asarray(jcent))
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(jgrouped))


def test_splice_onehot():
    labels = np.array([3, 0], np.int32)
    got = splice_onehot(_t(CLOUD), _t(labels), 7).numpy()
    want = np.asarray(jax_splice_onehot(jnp.asarray(CLOUD), jnp.asarray(labels), 7))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batched", [False, True], ids=["one_cloud", "batched"])
def test_rotate_euler(batched):
    """``points @ R^T`` over the leading dims, within 1e-6 of the JAX
    package's einsum (unit-scale clouds, float32 sums of three terms)."""
    pts = CLOUD if batched else CLOUD[0]
    ang = RNG.uniform(-np.pi, np.pi, (2, 3) if batched else (3,)).astype(np.float32)
    got = tops.rotate_euler(_t(pts), _t(ang)).numpy()
    want = np.asarray(jops.rotate_euler(jnp.asarray(pts), jnp.asarray(ang)))
    assert got.shape == want.shape == pts.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_random_sample_on_the_jax_package_s_draws():
    """Fed the scores that JAX's ``random_sample`` draws from its key, the
    port picks the same points in the same order; its own generator path
    gives distinct points, the same ones from the same seed."""
    import jax

    from pointnet_like_pose_estimation_tpu_torch.ops.sampling import draw_scores, sample_by_scores

    key = jax.random.PRNGKey(3)
    scores = np.array(jax.random.uniform(key, (2, 128)))
    got = sample_by_scores(_t(FEAT), _t(scores), 40).numpy()
    want = np.asarray(jops.random_sample(key, jnp.asarray(FEAT), 40))
    np.testing.assert_array_equal(got, want)
    pts = _t(np.arange(2 * 128 * 3, dtype=np.float32).reshape(2, 128, 3))
    a = tops.random_sample(pts, 100, torch.Generator().manual_seed(0))
    b = tops.random_sample(pts, 100, torch.Generator().manual_seed(0))
    assert a.shape == (2, 100, 3) and torch.equal(a, b)
    assert all(len(np.unique(c[:, 0].numpy())) == 100 for c in a)
    assert draw_scores(2, 128, torch.Generator()).dtype == torch.float32


def test_farthest_point_sample_key_on_the_jax_package_s_draws():
    """JAX's ``key`` draws the start indices uniformly; fed those indices,
    the port's FPS picks JAX's points. A generator draws the port's own
    start indices, in [0, N), the same ones from the same seed."""
    import jax

    from pointnet_like_pose_estimation_tpu_torch.ops.sampling import draw_start

    key = jax.random.PRNGKey(11)
    start = np.array(jax.random.randint(key, (2,), 0, 128, dtype=jnp.int32))
    got = tops.farthest_point_sample(_t(CLOUD), 32, start_idx=_t(start)).numpy()
    want = np.asarray(jops.farthest_point_sample(jnp.asarray(CLOUD), 32, key=key))
    np.testing.assert_array_equal(got, want)
    starts = draw_start(1000, 128, torch.Generator().manual_seed(1))
    assert starts.dtype == torch.int32 and 0 <= int(starts.min()) and int(starts.max()) < 128
    idx = tops.farthest_point_sample(_t(CLOUD), 8, generator=torch.Generator().manual_seed(1))
    assert torch.equal(idx[:, 0], draw_start(2, 128, torch.Generator().manual_seed(1)))
