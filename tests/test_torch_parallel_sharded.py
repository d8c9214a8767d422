"""The port's point-sharded ops on the CPU (gloo, 4 ranks spawned by
``torch_parallel_workers.spawn``) against the JAX package's
``parallel/sharded_ops.py`` on the same meshes of conftest's virtual
devices, and against the port's unsharded ops:

- sharded FPS on ``{"points": 4}`` and ``{"data": 2, "points": 2}`` (each
  rank its rows), and from a ``start_idx``; ``sharded_sample_and_group``
  with and without features, and ``_multi``: indices exactly, floats at
  JAX's ``rtol=1e-4, atol=1e-5`` against JAX and exactly against the
  port's unsharded ops (the same arithmetic, term by term);
- point-sharded forwards of ``pointnet2_cls_ssg`` and
  ``pointnet2_cls_msg`` (``dispatch_count == 2``) against JAX's, as in
  ``test_point_sharding_context_routes_*``, and against the port's
  unsharded forward;
- an N that does not divide raises JAX's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu.parallel import (
    make_mesh as jax_make_mesh,
    point_sharding as jax_point_sharding,
    sharded_farthest_point_sample as jax_sharded_fps,
    sharded_sample_and_group as jax_sharded_group,
    sharded_sample_and_group_multi as jax_sharded_multi,
)
from pointnet_like_pose_estimation_tpu.train import TrainConfig as JaxTrainConfig
from pointnet_like_pose_estimation_tpu.train.loop import build_state as jax_build_state
from pointnet_like_pose_estimation_tpu_torch.models import build_model
from pointnet_like_pose_estimation_tpu_torch.nn import SetAbstractionMSG
from pointnet_like_pose_estimation_tpu_torch.ops import farthest_point_sample, sample_and_group
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import from_flax_variables
from torch_parallel_workers import sharded_worker, spawn

WORLD = 4
MESHES = {"points": {"points": WORLD}, "data_points": {"data": 2, "points": WORLD // 2}}
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


def _cloud(seed, B, N, C=3):
    return np.random.default_rng(seed).standard_normal((B, N, C)).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    forward = {}
    for name in ("pointnet2_cls_ssg", "pointnet2_cls_msg"):
        _, model, state = jax_build_state(JaxTrainConfig.for_model(name, num_points=256))
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        forward[name] = (variables, model, _cloud(9, 2, 256) * 0.5)
    return {
        "fps": (_cloud(0, 4, 512), 128),
        "start": (_cloud(1, 2, 256), np.array([17, 201], np.int32), 64),
        "group": (_cloud(3, 2, 1024), _cloud(4, 2, 1024, 5), 64, 16, 0.35),
        "group_plain": (_cloud(5, 2, 1024), 32, 8, 0.5),
        "multi": (_cloud(7, 2, 1024), _cloud(8, 2, 1024, 5), 64, (0.2, 0.4), (8, 16)),
        "forward": forward,
    }


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    port_case = dict(case)
    port_case["forward"] = {name: (from_flax_variables(jax.tree.map(np.asarray, v)), pts)
                            for name, (v, _, pts) in case["forward"].items()}
    return spawn(sharded_worker, WORLD, tmp_path_factory.mktemp("sharded"), port_case)


def _rank_rows(key, rank, B):
    """The rows a rank of MESHES[key] holds (``shard_batch`` over data)."""
    if key == "points":
        return slice(None)
    block = B // 2
    return slice(rank // 2 * block, (rank // 2 + 1) * block)


def _jax_mesh(key):
    return jax_make_mesh(MESHES[key], devices=jax.devices()[:WORLD])


@pytest.mark.parametrize("key", list(MESHES))
def test_sharded_fps_matches_jax_and_the_unsharded_op(case, ranks, key):
    pts, S = case["fps"]
    batch_axis = "data" if key == "data_points" else None
    want = np.asarray(jax.jit(lambda p: jax_sharded_fps(p, S, _jax_mesh(key), batch_axis=batch_axis))(pts))
    plain = farthest_point_sample(torch.from_numpy(pts), S).numpy()
    np.testing.assert_array_equal(want, plain)
    for rank, r in enumerate(ranks):
        got = r[f"fps/{key}"]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, plain[_rank_rows(key, rank, len(pts))])


def test_sharded_fps_respects_start_idx(case, ranks):
    pts, start, S = case["start"]
    want = np.asarray(jax.jit(lambda p, s: jax_sharded_fps(p, S, _jax_mesh("points"), start_idx=s))(pts, start))
    plain = farthest_point_sample(torch.from_numpy(pts), S, torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(want, plain)
    for r in ranks:
        np.testing.assert_array_equal(r["start"], plain)


def _check_group(got, want, plain, rows):
    np.testing.assert_allclose(got[0], np.asarray(want[0])[rows], **JAX_TOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1])[rows], **JAX_TOL)
    np.testing.assert_array_equal(got[0], plain[0].numpy()[rows])
    np.testing.assert_array_equal(got[1], plain[1].numpy()[rows])


@pytest.mark.parametrize("key", list(MESHES))
def test_sharded_sample_and_group_with_features(case, ranks, key):
    pts, feats, S, K, r = case["group"]
    batch_axis = "data" if key == "data_points" else None
    want = jax.jit(lambda p, f: jax_sharded_group(p, f, S, K, r, _jax_mesh(key), batch_axis=batch_axis))(pts, feats)
    plain = sample_and_group(torch.from_numpy(pts), torch.from_numpy(feats), S, K, r)
    for rank, got in enumerate(ranks):
        _check_group(got[f"group/{key}"], want, plain, _rank_rows(key, rank, len(pts)))


def test_sharded_sample_and_group_without_features(case, ranks):
    pts, S, K, r = case["group_plain"]
    want = jax.jit(lambda p: jax_sharded_group(p, None, S, K, r, _jax_mesh("points")))(pts)
    plain = sample_and_group(torch.from_numpy(pts), None, S, K, r)
    for got in ranks:
        _check_group(got["group_plain"], want, plain, slice(None))


@pytest.mark.parametrize("key", list(MESHES))
def test_sharded_sample_and_group_multi(case, ranks, key):
    pts, feats, S, radii, ks = case["multi"]
    batch_axis = "data" if key == "data_points" else None
    want_c, want = jax.jit(lambda p, f: jax_sharded_multi(p, f, S, radii, ks, _jax_mesh(key),
                                                          batch_axis=batch_axis))(pts, feats)
    layer = SetAbstractionMSG(S, ks, radii, 5 + 3, [[8]] * len(ks))
    plain_c, plain = layer._group(torch.from_numpy(pts), torch.from_numpy(feats))
    for rank, got in enumerate(ranks):
        rows = _rank_rows(key, rank, len(pts))
        cent, grouped = got[f"multi/{key}"]
        assert len(grouped) == len(ks)
        _check_group((cent, grouped[0]), (want_c, want[0]), (plain_c, plain[0]), rows)
        for g, w, p in zip(grouped[1:], want[1:], plain[1:]):
            np.testing.assert_allclose(g, np.asarray(w)[rows], **JAX_TOL)
            np.testing.assert_array_equal(g, p.numpy()[rows])


@pytest.mark.parametrize("name", ["pointnet2_cls_ssg", "pointnet2_cls_msg"])
def test_point_sharded_forward_routes_and_matches_jax(case, ranks, name):
    variables, jmodel, pts = case["forward"][name]
    with jax_point_sharding(jax_make_mesh({"points": WORLD}, devices=jax.devices()[:WORLD])) as ctx:
        # traced inside the context, as parallel/context.py of the JAX package says
        want = np.asarray(jax.jit(lambda p: jmodel.apply(variables, p, train=False)[0])(pts))
    assert ctx.dispatch_count == 2
    model = build_model(name, 7)
    model.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, variables)))
    with torch.no_grad():
        plain = model.eval()(torch.from_numpy(pts))[0].numpy()
    for r in ranks:
        got, count = r[f"forward/{name}"]
        assert count == 2                   # SA1 (N=256) and SA2 (N=512 centroids); SA3 groups all
        np.testing.assert_allclose(got, want, **JAX_TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)


def test_indivisible_point_count_raises_jax_message(ranks):
    with pytest.raises(ValueError) as err:
        jax_sharded_fps(jnp.zeros((1, 4 * WORLD + 1, 3)), 2, _jax_mesh("points"))
    assert ranks[0]["indivisible"] == str(err.value)
