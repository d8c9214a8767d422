"""The port's compiled programs on the CPU (``utils/programs.py``, the
request and scene programs of ``GraspPipeline`` and the executors of
``models/fast_infer.py``) against the JAX package's jitted ones.

- The buckets: the port's request, scene and truncation buckets and the
  padded inputs it builds equal those the JAX package builds (its
  ``_fps_jit``, ``_infer`` and ``_scene_jit`` replaced by recorders), over
  a sweep of cluster counts and sizes.
- The request program: ``infer_clusters`` on the five committed
  checkpoints against JAX's ``infer_clusters`` for K no multiple of 4 and
  M no multiple of 256.
- The scene program: the port's ``_scene`` against JAX's
  ``_scene_infer_fn`` on the same bucketed inputs, in its three branches,
  on clusters drawn off any lattice: the truncation indices exact, the
  classes exact, floats to rtol = atol = 1e-4 (as tests/test_torch_pipeline.py:
  float32 products and reductions summed in another order).
- The cache: keys, eviction, counters and the refusal of an input of
  another shape, on the CPU, where a program is its function; the cache
  and the counter registry import none of the layers above them.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu.pipeline import GraspPipeline as JaxPipeline
from pointnet_like_pose_estimation_tpu.pipeline import PipelineConfig as JaxConfig
from pointnet_like_pose_estimation_tpu.pipeline import preprocess as jpp
from pointnet_like_pose_estimation_tpu_torch.models import build_model
from pointnet_like_pose_estimation_tpu_torch.models.fast_infer import build_pn2_ssg_infer
from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess as pp
from pointnet_like_pose_estimation_tpu_torch.pipeline.infer import request_bucket
from pointnet_like_pose_estimation_tpu_torch.utils import programs
from pointnet_like_pose_estimation_tpu_torch.utils.programs import ProgramCache
from test_torch_pipeline import FLOAT_KEYS, PATHS, _assert_same, _clusters

TOL = 1e-4


@pytest.fixture(scope="module")
def port():
    return GraspPipeline.from_checkpoints(PipelineConfig(), PATHS, device="cpu")


@pytest.fixture(scope="module")
def jax_pipe():
    return JaxPipeline.from_checkpoints(JaxConfig(), PATHS)


def _scene(rng, sizes, noise=40):
    """Gaussian blobs of ``sizes`` points (labels 0, 1, ...) shuffled among
    ``noise`` far points (label -1): float32 points off any lattice."""
    parts = [rng.uniform(-0.5, 0.5, (1, 3)) + 0.05 * rng.standard_normal((n, 3)) for n in sizes]
    pts = np.concatenate(parts + [rng.uniform(-1, 1, (noise, 3)) + [0, 0, -3]]).astype(np.float32)
    labels = np.concatenate([np.full(n, c) for c, n in enumerate(sizes)] + [np.full(noise, -1)])
    order = rng.permutation(len(pts))
    return pts[order], labels[order]


# --- the buckets ----------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 3, 4, 5, 8, 13, 32])
def test_request_bucket_matches_jax(monkeypatch, K):
    """JAX's ``infer_clusters`` pads K for its ``_infer`` program and, above
    num_points, M for its FPS program: the port's bucket and padded clusters
    are the ones those programs receive."""
    rng = np.random.default_rng(K)
    port = GraspPipeline.__new__(GraspPipeline)
    port.cfg = PipelineConfig()
    for M in (100, 700, 1023, 1024, 1025, 1280, 1500, 2048, 2049):
        seen = {}

        def fps_jit(x, n):
            seen["fps"] = np.asarray(x)
            return jnp.zeros((x.shape[0], n), jnp.int32)

        monkeypatch.setattr(jpp, "_fps_jit", fps_jit)
        jp = JaxPipeline(JaxConfig(), models={})
        jp._infer = lambda x: seen.update(infer=x.shape) or {"pred_class": jnp.zeros(x.shape[0], jnp.int32)}
        clusters = rng.standard_normal((K, M, 4)).astype(np.float32)
        assert jp.infer_clusters(clusters)["pred_class"].shape == (K,)
        kb, mb = request_bucket(K, M, 1024)
        assert kb == seen["infer"][0]
        key, _, (xyz,), k = port._request_call(clusters)
        assert key == ("request", kb, mb) and k == K and xyz.shape == (kb, mb, 3)
        if M > 1024:
            assert mb == seen["fps"].shape[1]
            np.testing.assert_array_equal(xyz.numpy(), seen["fps"])
        else:
            assert mb == M and "fps" not in seen
            np.testing.assert_array_equal(xyz.numpy()[:K], clusters[..., :3])
            np.testing.assert_array_equal(xyz.numpy()[K:], np.broadcast_to(clusters[:1, :, :3], (kb - K, M, 3)))


SIZES = [[300], [600, 900], [1024, 1400], [1024, 1024, 1024, 1024, 1024], [1300, 1700, 2049],
         [5000, 1100, 1025, 4097, 700], [256, 257, 513], [2048, 6000, 3000]]


@pytest.mark.parametrize("sizes", SIZES)
def test_scene_bucket_matches_jax(sizes):
    """JAX's ``_infer_scene`` buckets the scene for its ``_scene_jit``
    program: the port's key (k_bucket, n_bucket, s_bucket, scene bucket,
    branch), cleaned points, index table and smallest size are the inputs
    that program receives."""
    rng = np.random.default_rng(len(sizes))
    pts, labels = _scene(rng, sizes)
    seen = {}
    jp = JaxPipeline(JaxConfig(), models={})
    jp._scene_jit = lambda xyz, idx, ms, **static: seen.update(xyz=np.asarray(xyz), idx=np.asarray(idx),
                                                               ms=int(ms), **static) or ({}, idx)
    jp._infer_scene(pts, labels, sync=False)
    port = GraspPipeline.__new__(GraspPipeline)
    port.cfg, port.scene_points = PipelineConfig(), 0
    key, fn, (xyz, idx, min_size), K, ms = port._scene_call(pts, labels)
    assert key == ("scene", *seen["idx"].shape, seen["s_bucket"], len(seen["xyz"]), seen["branch"])
    assert fn.keywords == {"s_bucket": seen["s_bucket"], "branch": seen["branch"]}
    assert K == len(sizes) and ms == int(min_size) == seen["ms"] == min(sizes)
    np.testing.assert_array_equal(xyz.numpy(), seen["xyz"])
    np.testing.assert_array_equal(idx.numpy(), seen["idx"])


def test_scene_buffer_grows_and_never_shrinks():
    """A fresh pipeline's first scene takes JAX's scene bucket; a scene of
    fewer points then reuses the buffer (and so the key) with zeros past its
    points, and only a larger scene grows it, to its own bucket."""
    port = GraspPipeline.__new__(GraspPipeline)
    port.cfg, port.scene_points = PipelineConfig(), 0
    rng = np.random.default_rng(11)
    keys = []
    for sizes in ([2000, 1500], [1900, 1500], [2000, 1600, 3000]):
        pts, labels = _scene(rng, sizes)
        key, _, (xyz, idx, _), _, _ = port._scene_call(pts, labels)
        np.testing.assert_array_equal(xyz.numpy()[:len(pts)], pts)
        assert not xyz.numpy()[len(pts):].any() and int(idx.max()) < len(pts)
        keys.append(key)
    assert [k[4] for k in keys] == [4096, 4096, 8192] and port.scene_points == 8192
    assert keys[0] == keys[1]


@pytest.mark.parametrize("sizes", SIZES)
def test_truncation_bucket_matches_jax(monkeypatch, sizes):
    """JAX's ``cluster_point`` gathers the clusters into the same bucket
    for its ``_fps_jit``: the port's table gathers the same batch, with the
    same sample count."""
    pts, labels = _scene(np.random.default_rng(len(sizes)), sizes)
    seen = {}

    def fps_jit(batch, s):
        seen.update(batch=np.asarray(batch), s=s)
        return jnp.zeros((batch.shape[0], s), jnp.int32)

    monkeypatch.setattr(jpp, "_fps_jit", fps_jit)
    monkeypatch.setattr(jpp, "dbscan", lambda *args, **kw: labels)
    jpp.cluster_point(pts, 0.03, 500)
    table, s_bucket = pp.bucketed_groups(pp.cluster_groups(labels))
    assert s_bucket == seen["s"]
    np.testing.assert_array_equal(pts[table], seen["batch"])


# --- the request program ----------------------------------------------------------------------


@pytest.mark.parametrize("K,M", [(5, 1300), (6, 1100), (3, 700)])
def test_request_program_matches_jax_infer_clusters(port, jax_pipe, K, M):
    """K no multiple of 4, M (above num_points) no multiple of 256, and M
    below it: the bucketed request equals JAX's and the same function on the
    unpadded clusters."""
    clusters = _clusters(np.random.default_rng(K * M), K, M)
    got = port.infer_clusters(clusters)
    _assert_same(got, jax_pipe.infer_clusters(clusters), tol=TOL)
    with torch.inference_mode():
        unpadded = port._request(torch.from_numpy(clusters))
    _assert_same(got, {k: v.numpy() for k, v in unpadded.items()}, tol=TOL)


# --- the scene program ----------------------------------------------------------------------


@pytest.mark.parametrize("sizes,branch", [([1300, 1700, 2100], "fps"), ([1024, 1500], "exact"),
                                          ([600, 900, 400, 800, 500], "tile")])
def test_scene_program_matches_jax_scene_infer_fn(port, jax_pipe, sizes, branch):
    """The port's scene program against JAX's ``_scene_infer_fn``, jitted
    as ``_infer_scene`` jits it, on the inputs JAX builds for the scene:
    the global indices of the truncated clusters exact, grasps within TOL;
    and ``_infer_scene``'s results, the truncated clusters equal."""
    pts, labels = _scene(np.random.default_rng(len(sizes)), sizes)
    real = jax.jit(jax_pipe._scene_infer_fn, static_argnames=("s_bucket", "branch"))
    seen = {}

    def recorder(xyz, idx, min_size, **static):
        seen.update(static, out=real(xyz, idx, min_size, **static))
        return seen["out"]

    jax_pipe._scene_jit = recorder
    try:
        want = jax_pipe._infer_scene(pts, labels)
    finally:
        del jax_pipe._scene_jit
    key, fn, inputs, K, min_size = port._scene_call(pts, labels)
    assert key[-1] == seen["branch"] == branch and key[3] == seen["s_bucket"]
    out, cglobal = port.programs(key, fn, inputs)
    want_out, want_cglobal = (jax.tree.map(np.asarray, x) for x in seen["out"])
    np.testing.assert_array_equal(cglobal.numpy(), want_cglobal)
    # the real clusters only: a pad row is one point repeated, which the port
    # normalizes to zeros (its mean in float64 is the point) and JAX to its
    # float32 mean's rounding noise, scaled up to the unit sphere
    _assert_same({k: v[:K].numpy() for k, v in out.items()}, {k: v[:K] for k, v in want_out.items()}, tol=TOL)
    got = port._infer_scene(pts, labels)
    assert set(got) == set(want) and got["clusters"].shape == (K, min_size, 3)
    np.testing.assert_array_equal(got["clusters"], want["clusters"])
    _assert_same(got, want, tol=TOL)


def test_scene_program_equals_the_staged_path(port):
    """Everything after DBSCAN in one program gives the staged path's
    result: the clusters truncated by FPS to the smallest size, then
    ``infer_clusters`` (its own bucket)."""
    pts, labels = _scene(np.random.default_rng(7), [1500, 1200, 2000])
    got = port._infer_scene(pts, labels)
    _, idx = pp.truncate_clusters(torch.from_numpy(pts), pp.cluster_groups(labels))
    clusters = pts[idx.numpy()]
    np.testing.assert_array_equal(got["clusters"], clusters)
    _assert_same(got, port.infer_clusters(clusters), tol=TOL)


# --- the cache ------------------------------------------------------------------------------


def test_program_cache_keys_evicts_and_counts_on_the_cpu(monkeypatch):
    calls = []

    def double(x):
        calls.append(x.shape)
        return {"y": 2 * x}

    monkeypatch.setattr(programs, "MAX_PROGRAMS", 2)
    cache = ProgramCache("cpu")
    a, b, c = torch.ones(3), torch.ones(4), torch.ones(5)
    assert torch.equal(cache(("f", 3), double, (a,))["y"], 2 * a)
    assert torch.equal(cache(("f", 3), double, (3 * a,))["y"], 6 * a)     # new inputs, new outputs
    assert (cache.captures, cache.replays, len(cache)) == (1, 2, 1)
    cache(("f", 4), double, (b,))
    cache(("f", 3), double, (a,))                                          # ("f", 3) most recent
    cache(("f", 5), double, (c,))                                          # evicts ("f", 4)
    assert cache.keys() == [("f", 3), ("f", 5)] and cache.evictions == 1
    cache(("f", 4), double, (b,))                                          # captured again
    assert cache.keys() == [("f", 5), ("f", 4)]
    assert (cache.captures, cache.replays, cache.evictions) == (4, 6, 2)
    assert cache.counts(("f", 4)) == {} and len(calls) == 6
    assert cache.capture_seconds >= 0.0
    with pytest.raises(ValueError, match="the program takes"):
        cache(("f", 4), double, (c,))


@pytest.mark.parametrize("module, below", [("programs.py", {"kernels", "ops"}),
                                           ("counters.py", {"kernels", "ops", "nn"})])
def test_the_program_layer_imports_no_kernel_and_no_op(module, below):
    """The program cache and the counter registry sit below the kernels and
    the ops: their sources import no module of those layers, so a counted
    kernel is added in its own module alone."""
    import ast

    tree = ast.parse((Path(programs.__file__).parent / module).read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {f"{n.module or ''}.{a.name}" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
              for a in n.names}
    assert not {name for name in names if below & set(name.split("."))}, names


def test_program_inputs_are_the_cache_s_own_copies():
    """A caller that changes its tensor after a call changes no program."""
    cache = ProgramCache("cpu")
    x = torch.arange(4.0)
    cache(("id",), lambda t: (t + 0,), (x,))
    x += 10
    key_inputs = cache._programs[("id",)].inputs[0]
    assert torch.equal(key_inputs, torch.arange(4.0))


def test_pipeline_buckets_share_programs(port):
    """K = 3 and 4 share a bucket, as do M = 1100 and 1200; K = 5 does not."""
    port.programs = ProgramCache("cpu")
    rng = np.random.default_rng(3)
    for K, M in [(3, 1100), (4, 1200), (5, 1100), (3, 1100)]:
        out = port.infer_clusters(_clusters(rng, K, M))
        assert out["pred_class"].shape == (K,) and all(np.isfinite(out[k]).all() for k in FLOAT_KEYS)
    assert port.programs.keys() == [("request", 8, 1280), ("request", 4, 1280)]
    assert (port.programs.captures, port.programs.replays) == (2, 4)


def test_executor_program_is_its_body():
    torch.manual_seed(0)
    fwd = build_pn2_ssg_infer(build_model("pointnet2_cls_ssg").eval(), device="cpu")
    x = torch.from_numpy(_clusters(np.random.default_rng(5), 3, 1024))
    lp, pred = fwd(x)
    fwd(x.numpy())
    with torch.inference_mode():
        want_lp, want_pred = fwd.body(x)
    assert torch.equal(lp, want_lp) and torch.equal(pred, want_pred)
    assert fwd.programs.keys() == [("executor", 3, 1024, 3)]
    assert (fwd.programs.captures, fwd.programs.replays) == (1, 2)
