"""The port's raw-frame path on the CPU against the JAX package's:
deprojection, PLY files and the replay camera, RANSAC on JAX's own draws,
the radius and kNN outlier tests, DBSCAN, ``cluster_point``,
``GraspPipeline.__call__`` and ``stream``, ``cli infer``, the camera's
error path and the FPS size limit.

Where the two packages may part, and how the tests hold them:

- **Distances on a threshold.** XLA on the CPU forms the JAX package's
  plane distances and ``|r|^2 - 2 r.x + |x|^2`` with products that it
  contracts into FMAs; the port rounds every term on its own. So a count
  may differ only through a pair whose float64 squared distance lies
  within the float32 rounding of that form (4 ulps of ``|r|^2 + |x|^2``)
  of ``radius^2``: those boundary pairs are found in float64 and each point
  may differ by at most its own number of them. Measured: every third
  point of the clipped replay scene (6,006 points, a lattice) has 155
  boundary pairs at r = 0.03 and 6 points whose count differs by one; 4,000
  random points have 3 and 2.
- **FPS on a lattice.** The same contraction breaks FPS ties apart
  differently (ROADMAP.md Queue 3): on the replay scene the
  truncation FPS orders each 3,000-point cluster otherwise from step 149
  (first cluster) and 687 (second), at a tie, and the resampled 1,024
  points differ, so the grasps part by up to 0.07 in a log-probability and
  0.3 degrees. There the stages are held one by one: the cleaned points,
  the labels and each cluster's point set equal, the first parting of the
  orders a tie, the classes equal, and the port's grasps of JAX's clusters
  within 1e-3 of JAX's. On a scene sampled off any lattice the whole
  ``__call__`` agrees: classes equal, floats to 1e-3.
- **RANSAC draws.** The port draws its triples from a ``torch.Generator``;
  the tests replace ``preprocess.draw_ransac`` with ``jax_draws``, the JAX
  package's own ``jax.random.choice`` over its padded cloud.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu import cli as jax_cli
from pointnet_like_pose_estimation_tpu.data import io_utils as jax_io
from pointnet_like_pose_estimation_tpu.pipeline import GraspPipeline as JaxPipeline
from pointnet_like_pose_estimation_tpu.pipeline import PipelineConfig as JaxConfig
from pointnet_like_pose_estimation_tpu.pipeline import deproject as jax_deproject
from pointnet_like_pose_estimation_tpu.pipeline import preprocess as jpp
from pointnet_like_pose_estimation_tpu_torch import cli
from pointnet_like_pose_estimation_tpu_torch.data import io_utils
from pointnet_like_pose_estimation_tpu_torch.kernels.fps import MAX_SHARED_POINTS, fps_reference
from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess as pp
from pointnet_like_pose_estimation_tpu_torch.pipeline.camera import RealSenseCamera
from pointnet_like_pose_estimation_tpu_torch.pipeline.deproject import CameraIntrinsics, deproject_depth
from test_torch_pipeline import PATHS
from test_torch_train import one_torch_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SCENE = os.path.join(FIX, "scene_table2obj.ply")
# the replay scene's thresholds (tests/test_e2e_replay.py)
FIXTURE_CFG = dict(clip_range=(-1.0, 0.0), min_points=200, radius_nb_points=60, radius=0.03, eps=0.04)
FLOAT_KEYS = ("log_probs", "rotation_deg", "rotation_matrix", "sign_prob", "translation", "width")
F32_EPS = float(np.finfo(np.float32).eps)


def jax_draws(num_points, num_iterations=1000, seed=0):
    """The JAX package's RANSAC triples: ``jax.random.choice`` over the cloud
    padded to a multiple of 2048, weighted by the valid mask, as
    ``preprocess._best_plane`` draws them under jit."""
    n_pad = -(-max(num_points, 1) // 2048) * 2048

    @jax.jit
    def draw(key, valid):
        p = valid.astype(jnp.float32)
        return jax.random.choice(key, n_pad, shape=(num_iterations, 3), p=p / jnp.sum(p))

    idx = draw(jax.random.PRNGKey(seed), jnp.arange(n_pad) < num_points)
    return torch.from_numpy(np.array(idx)).long()


@pytest.fixture
def with_jax_draws(monkeypatch):
    monkeypatch.setattr(pp, "draw_ransac", jax_draws)


@pytest.fixture(scope="module")
def scene():
    return jax_io.load_ply(SCENE).astype(np.float32)


def synthetic_scene(seed=0):
    """A table (8,000 points at z = -0.7, sd 1.5 mm), a box and a cylinder
    standing on it (about 2,000 points each, drawn uniformly on their upper
    surfaces, off any lattice) and 40 far outliers; the camera's frame."""
    rng = np.random.default_rng(seed)
    table = np.column_stack([rng.uniform(-0.4, 0.4, 8000), rng.uniform(-0.4, 0.4, 8000),
                             -0.7 + rng.normal(0, 0.0015, 8000)])
    u = rng.uniform(0, 1, (2000, 2))
    face = rng.integers(0, 5, 2000)          # top, then four sides of an 0.08 x 0.10 x 0.06 box
    size = np.array([0.08, 0.10, 0.06])
    box = np.where(face[:, None] == 0, np.column_stack([u * size[:2], np.full(2000, size[2])]),
                   np.where((face[:, None] % 2) == 1,
                            np.column_stack([np.where(face == 1, 0.0, size[0]), u[:, 0] * size[1],
                                             u[:, 1] * size[2]]),
                            np.column_stack([u[:, 0] * size[0], np.where(face == 2, 0.0, size[1]),
                                             u[:, 1] * size[2]])))
    box = box - [size[0] / 2, size[1] / 2, 0.0] + [-0.15, 0.1, -0.69]
    theta, h = rng.uniform(0, 2 * np.pi, 2200), rng.uniform(0, 1, 2200)
    top = rng.uniform(0, 1, 2200) < 0.3
    rad = np.where(top, 0.04 * np.sqrt(rng.uniform(0, 1, 2200)), 0.04)
    cyl = np.column_stack([rad * np.cos(theta), rad * np.sin(theta), np.where(top, 0.09, 0.09 * h)])
    cyl = cyl + [0.2, -0.05, -0.69]
    far = rng.uniform(-1, 1, (40, 3)) + [0, 0, -1.5]
    return np.concatenate([table, box, cyl, far]).astype(np.float32)


# --- files, camera, deprojection ------------------------------------------------------------


def test_deproject_depth_matches_jax_bit_for_bit():
    intr = CameraIntrinsics.from_json(os.path.join(FIX, "camera.json"))
    jintr = jax_deproject.CameraIntrinsics.from_json(os.path.join(FIX, "camera.json"))
    assert intr == CameraIntrinsics(**jintr.__dict__)
    depth = np.load(os.path.join(FIX, "depth_scene.npz"))["depth"]
    color = np.random.default_rng(0).uniform(0, 1, (*depth.shape, 3)).astype(np.float32)
    for c in (None, color):
        got = deproject_depth(depth, intr, c, device="cpu")
        want = np.asarray(jax_deproject.deproject_depth(depth, jintr, c))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_ply_round_trip_and_replay_camera(tmp_path, scene):
    cam = io_utils.ReplayCamera([SCENE])
    clouds = list(cam)
    assert len(clouds) == 1 and clouds[0].shape == (18060, 3)
    assert cam.get_cloud() is None
    np.testing.assert_array_equal(clouds[0], jax_io.load_ply(SCENE))
    rng = np.random.default_rng(1)
    cloud = np.column_stack([rng.uniform(-1, 1, (50, 3)), rng.uniform(0, 1, (50, 3))])
    io_utils.save_ply(str(tmp_path / "c.ply"), cloud)
    jax_io.save_ply(str(tmp_path / "j.ply"), cloud)
    assert (tmp_path / "c.ply").read_text() == (tmp_path / "j.ply").read_text()
    back = io_utils.load_ply(str(tmp_path / "c.ply"))
    np.testing.assert_allclose(back[:, :3], cloud[:, :3], atol=5e-7)
    np.testing.assert_allclose(back[:, 3:], np.floor(cloud[:, 3:] * 255) / 255, atol=1e-12)
    np.savetxt(tmp_path / "c.txt", cloud[:, :3], delimiter=",")
    np.testing.assert_array_equal(io_utils.ReplayCamera([str(tmp_path / "c.txt")]).get_cloud(),
                                  jax_io.ReplayCamera([str(tmp_path / "c.txt")]).get_cloud())


def test_realsense_camera_without_pyrealsense2_raises():
    with pytest.raises(RuntimeError, match="pyrealsense2 is not installed"):
        RealSenseCamera(os.path.join(FIX, "camera.json"))


# --- RANSAC ---------------------------------------------------------------------------------


def test_ransac_apply_on_jax_draws_matches_jax(scene):
    """The clipped replay scene (18,060 points): the port's scores of JAX's
    triples pick the plane JAX picks (normal and offset to 1e-6), and the
    inlier mask is JAX's but for points whose float64 distance lies within
    the float32 rounding of the threshold (none here)."""
    pts = pp.clip_distance(scene, (-1.0, 0.0), 2)
    xyz = torch.from_numpy(pts[:, :3].copy())
    triples = jax_draws(len(pts))
    n, d, counts = pp.plane_scores(xyz, triples, 0.006)
    best = int(torch.argmax(counts))
    jn, jd = jpp._ransac_score(*map(jnp.asarray, jpp._pad_bucket(pts[:, :3])), jax.random.PRNGKey(0), 0.006,
                               num_iterations=1000)
    np.testing.assert_allclose(n[best].numpy(), np.asarray(jn), atol=1e-6)
    np.testing.assert_allclose(float(d[best]), float(jd), atol=1e-6)
    assert int(counts[best]) > 0.6 * len(pts)            # the table
    want_plane, want_in = jpp.ransac_plane(pts)
    jd64 = np.abs(pts[:, :3].astype(np.float64) @ want_plane[:3].astype(np.float64) + want_plane[3])
    scale = np.abs(pts[:, :3] * want_plane[:3]).sum(-1) + abs(want_plane[3])
    band = np.abs(jd64 - 0.006) <= 4 * F32_EPS * scale
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pp, "draw_ransac", jax_draws)
        plane, inliers = pp.ransac_plane(pts, device="cpu")
    np.testing.assert_allclose(plane, want_plane, atol=1e-6)
    np.testing.assert_array_equal(inliers[~band], want_in[~band])


def test_draws_are_seeded_and_the_same_for_both_devices():
    a, b = pp.draw_ransac(5000, 1000, 3), pp.draw_ransac(5000, 1000, 3)
    assert torch.equal(a, b) and a.shape == (1000, 3) and a.device.type == "cpu"
    assert int(a.min()) >= 0 and int(a.max()) < 5000
    assert not torch.equal(a, pp.draw_ransac(5000, 1000, 4))


def test_degenerate_triple_wins_in_both_packages():
    """A triple that repeats an index has a zero normal and offset, every
    point is its inlier, and it wins the argmax over any real plane that
    leaves a point out: the clean then keeps nothing. JAX's draws
    with ``PRNGKey(1)`` over a 2,048-point scene (a table and an object
    above it) hold such a triple; both packages pick it."""
    rng = np.random.default_rng(0)
    table = np.column_stack([rng.uniform(-0.5, 0.5, 1600), rng.uniform(-0.5, 0.5, 1600),
                             -0.7 + rng.normal(0, 0.0015, 1600)])
    table = np.concatenate([table, rng.uniform(-0.05, 0.05, (448, 3)) + [0, 0, -0.6]]).astype(np.float32)
    jn, jd = jpp._ransac_score(*map(jnp.asarray, jpp._pad_bucket(table)), jax.random.PRNGKey(1), 0.006,
                               num_iterations=1000)
    assert not np.asarray(jn).any() and float(jd) == 0.0
    triples = jax_draws(2048, seed=1)
    degenerate = (triples[:, 0] == triples[:, 1]) | (triples[:, 1] == triples[:, 2]) | (
        triples[:, 0] == triples[:, 2])
    assert bool(degenerate.any())
    n, d = pp.best_plane(torch.from_numpy(table), triples, 0.006)
    assert not n.any() and float(d) == 0.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pp, "draw_ransac", lambda n, h=1000, seed=0: jax_draws(n, h, seed=1))
        assert len(pp.clean_scene(table, device="cpu")) == 0
    want = np.asarray(jpp._clean_masks(*map(jnp.asarray, jpp._pad_bucket(table)), jax.random.PRNGKey(1),
                                       0.006, 0.05, 200))
    assert not want.any()


# --- outlier tests --------------------------------------------------------------------------


def _boundary_pairs(cloud, radius):
    """Per point, its pairs whose float64 squared distance lies within 4
    float32 ulps of ``|r|^2 + |x|^2`` of ``radius^2``."""
    c = cloud[:, :3].astype(np.float64)
    d2 = ((c[:, None] - c[None]) ** 2).sum(-1)
    sq = (c ** 2).sum(-1)
    band = np.abs(d2 - radius * radius) <= 4 * F32_EPS * (sq[:, None] + sq[None, :])
    np.fill_diagonal(band, False)
    return band.sum(1)


@pytest.mark.parametrize("what", ["replay lattice", "random"])
def test_radius_and_knn_counts_match_jax_off_the_boundary(scene, what):
    cloud = (pp.clip_distance(scene, (-1.0, 0.0), 2)[::3] if what == "replay lattice"
             else np.random.default_rng(0).uniform(-0.2, 0.2, (4000, 3)).astype(np.float32))
    xp, valid = jpp._pad_bucket(cloud[:, :3])
    want = np.asarray(jpp._range_count(jnp.asarray(xp), jnp.asarray(valid), 0.03))[:len(cloud)]
    got = pp.range_counts(torch.from_numpy(cloud[:, :3].copy()), 0.03).numpy()
    boundary = _boundary_pairs(cloud, 0.03)
    assert (np.abs(got - want) <= boundary).all()
    assert (got != want).sum() <= (6 if what == "replay lattice" else 2)
    md_want = np.asarray(jpp._knn_mean_dist(jnp.asarray(xp), jnp.asarray(valid), 30))[:len(cloud)]
    md_got = pp.knn_mean_dist(torch.from_numpy(cloud[:, :3].copy()), 30).numpy()
    # each squared distance carries the float32 rounding of the JAX form
    # (about 4e-7 absolute here, against 2.5e-5 for a lattice step of 5 mm);
    # measured: the mean distances part by at most 4.7e-6 on the lattice
    np.testing.assert_allclose(md_got, md_want, rtol=1e-4, atol=2e-5)


def test_outlier_removals_match_jax():
    rng = np.random.default_rng(3)
    cloud = np.concatenate([rng.normal(0, 0.05, (1500, 3)), rng.uniform(-0.5, 0.5, (100, 3))]).astype(np.float32)
    np.testing.assert_array_equal(pp.remove_radius_outlier(cloud, 30, 0.03, device="cpu"),
                                  jpp.remove_radius_outlier(cloud, 30, 0.03))
    np.testing.assert_array_equal(pp.remove_statistical_outlier(cloud, 20, 0.1, device="cpu"),
                                  jpp.remove_statistical_outlier(cloud, 20, 0.1))


def test_clean_scene_is_remove_plane_then_remove_radius_outlier():
    cloud = pp.clip_distance(synthetic_scene(1), (-1.0, 0.0), 2)
    cleaned = pp.clean_scene(cloud, radius_nb_points=60, radius=0.03, device="cpu")
    off_plane = pp.remove_plane(cloud, device="cpu")
    np.testing.assert_array_equal(cleaned, pp.remove_radius_outlier(off_plane, 60, 0.03, device="cpu"))
    assert 3000 < len(cleaned) < len(off_plane) < len(cloud) - 7000


# --- DBSCAN and clusters --------------------------------------------------------------------


def test_dbscan_native_numpy_and_jax_agree():
    rng = np.random.default_rng(4)
    blobs = [c + 0.02 * rng.standard_normal((n, 3)) for c, n in
             (((0, 0, 0), 700), ((0.2, 0, 0), 500), ((0, 0.25, 0.1), 300))]
    cloud = np.concatenate([*blobs, rng.uniform(-0.3, 0.5, (200, 3))]).astype(np.float32)
    native = pp.dbscan(cloud, 0.03, 30)
    assert native.dtype == np.int64 and native.max() == 2
    np.testing.assert_array_equal(pp.dbscan(cloud, 0.03, 30, use_native=False), native)
    np.testing.assert_array_equal(jpp.dbscan(cloud, 0.03, 30), native)
    np.testing.assert_array_equal(jpp.dbscan(cloud, 0.03, 30, use_native=False), native)


def test_cluster_point_matches_jax_off_lattice():
    cloud = pp.clip_distance(synthetic_scene(2), (-1.0, 0.0), 2)
    cleaned = jpp.clean_scene(cloud, radius_nb_points=60, radius=0.03)
    got = pp.cluster_point(cleaned, 0.04, 200, device="cpu")
    want = jpp.cluster_point(cleaned, 0.04, 200)
    assert got.shape == want.shape and got.shape[0] == 2
    np.testing.assert_array_equal(got, want)


def test_a_cluster_above_the_old_fps_limit_is_kept(monkeypatch):
    """A cluster above what the FPS kernel's shared path holds is kept, and
    a 60,000-point cluster beside a small one (random points, so no ties)
    is truncated to the JAX package's points, through ``truncate_clusters``
    and ``cluster_point`` (both packages' DBSCAN given the labels)."""
    labels = np.zeros(MAX_SHARED_POINTS + 11, np.int64)
    labels[:10] = 1
    assert [len(g) for g in pp.cluster_groups(labels)] == [MAX_SHARED_POINTS + 1, 10]
    rng = np.random.default_rng(12)
    points = rng.uniform(-0.2, 0.2, (60_300, 3)).astype(np.float32)
    labels = np.zeros(len(points), np.int64)
    labels[rng.choice(len(points), 300, replace=False)] = 1
    monkeypatch.setattr(jpp, "dbscan", lambda *args, **kw: labels)
    monkeypatch.setattr(pp, "dbscan", lambda *args, **kw: labels)
    want = jpp.cluster_point(points, 0.03, 500)
    assert want.shape == (2, 300, 3)
    got, idx = pp.truncate_clusters(torch.from_numpy(points), pp.cluster_groups(labels))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(points[idx.numpy()], want)
    np.testing.assert_array_equal(pp.cluster_point(points, 0.03, 500, device="cpu"), want)


# --- the pipeline ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    """(port, JAX) pipelines on the committed r3 checkpoints, fixture thresholds."""
    return (GraspPipeline.from_checkpoints(PipelineConfig(**FIXTURE_CFG), PATHS, device="cpu"),
            JaxPipeline.from_checkpoints(JaxConfig(**FIXTURE_CFG), PATHS))


def _both(pipes, frame):
    port, jax_pipe = pipes
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pp, "draw_ransac", jax_draws)
        return port(frame), jax_pipe(frame)


@pytest.fixture(scope="module")
def replay(pipes, scene):
    """(port, JAX) ``__call__`` of the replay scene, the port on JAX's draws."""
    return _both(pipes, scene)


@pytest.fixture(scope="module")
def synthetic(pipes):
    """(port, JAX) ``__call__`` of ``synthetic_scene(0)``, the port on JAX's draws."""
    return _both(pipes, synthetic_scene(0))


def _assert_same(got, want, tol=1e-3):
    np.testing.assert_array_equal(got["pred_class"], np.asarray(want["pred_class"]))
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=tol, atol=tol, err_msg=k)


def test_call_matches_jax_on_a_scene_off_lattice(synthetic):
    got, want = synthetic
    assert set(got) == set(want)
    assert got["clusters"].shape == want["clusters"].shape and got["clusters"].shape[0] == 2
    np.testing.assert_array_equal(got["clusters"], np.asarray(want["clusters"]))
    _assert_same(got, want)


def _fps_tie_at_first_parting(cluster, a_order, b_order):
    """The first step at which two FPS orders of ``cluster`` part, and
    whether it is a tie up to rounding: in the port's rounding both picks
    lie within 4 float32 ulps of the same distance from the points chosen
    before them (measured: an exact tie at step 149 of the first replay
    cluster, one ulp at step 687 of the second)."""
    step = int(np.argmax(a_order != b_order))
    x = torch.from_numpy(cluster[:, :3].copy())
    chosen = x[torch.from_numpy(a_order[:step])]
    t = [x[:, None, c] - chosen[None, :, c] for c in range(3)]
    dist = (t[0] * t[0] + t[1] * t[1] + t[2] * t[2]).amin(1)
    da, db = float(dist[a_order[step]]), float(dist[b_order[step]])
    return step, abs(da - db) <= 4 * F32_EPS * da


def test_call_on_the_replay_scene_holds_each_stage(pipes, replay, scene, with_jax_draws):
    port, _ = pipes
    got, want = replay
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["pred_class"], np.asarray(want["pred_class"]))
    cfg = port.cfg
    pts = pp.clip_distance(scene, cfg.clip_range, cfg.clip_axis)
    cleaned = pp.clean_scene(pts, cfg.plane_threshold, cfg.plane_iterations, cfg.radius_nb_points,
                             cfg.radius, device="cpu")
    np.testing.assert_array_equal(cleaned, jpp.clean_scene(
        pts, plane_threshold=cfg.plane_threshold, num_iterations=cfg.plane_iterations,
        radius_nb_points=cfg.radius_nb_points, radius=cfg.radius))
    labels = pp.dbscan(cleaned, cfg.eps, cfg.min_points)
    np.testing.assert_array_equal(labels, jpp.dbscan(cleaned, cfg.eps, cfg.min_points))
    jclusters = np.asarray(want["clusters"])
    min_size = min(int((labels == c).sum()) for c in range(2))
    for c in range(2):
        group = cleaned[labels == c]
        a = fps_reference(torch.from_numpy(group[None, :, :3].copy()), min_size)[0].numpy()
        b = np.asarray(jpp._fps_jit(jnp.asarray(group[None, :, :3]), min_size))[0]
        np.testing.assert_array_equal(got["clusters"][c], group[a])
        np.testing.assert_array_equal(jclusters[c], group[b])
        if not np.array_equal(a, b):
            step, tie = _fps_tie_at_first_parting(group, a, b)
            assert tie, f"cluster {c}: the FPS orders part at step {step} without a tie"
    _assert_same(port.infer_clusters(jclusters), want)


def test_stream_equals_call(pipes, synthetic, with_jax_draws):
    """Three frames, the middle one too small to serve: ``stream`` yields
    ``__call__``'s results bit for bit, None for the middle one."""
    port, _ = pipes
    frame = synthetic_scene(0)
    streamed = list(port.stream(iter([frame, frame[:150], frame])))
    assert len(streamed) == 3 and streamed[1] is None and port(frame[:150]) is None
    for out in (streamed[0], streamed[2]):
        assert set(out) == set(synthetic[0])
        for k, v in synthetic[0].items():
            np.testing.assert_array_equal(out[k], v, err_msg=k)
    assert list(port.stream(iter([]))) == []


def test_infer_command_prints_the_jax_commands_fields(pipes, replay, capsys, monkeypatch, with_jax_draws):
    """``cli infer --device cpu`` on the replay scene prints the JAX command's
    fields, with its classes, and the port's own ``__call__`` results. The
    JAX command is served by the module's JAX pipeline (the same
    configuration and checkpoints) so that it is not compiled again."""
    args = ["infer", "--input", SCENE, "--config", json.dumps(FIXTURE_CFG), "--checkpoints", json.dumps(PATHS)]
    cli.main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(JaxPipeline, "from_checkpoints", classmethod(lambda cls, cfg, paths: pipes[1]))
    jax_cli.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) and got["input"] == want["input"] == SCENE
    assert got["clusters"] == want["clusters"] == 2 and got["pred_class"] == want["pred_class"]
    for k in ("rotation_deg", "translation", "width"):
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), replay[0][k], err_msg=k)
