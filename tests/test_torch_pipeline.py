"""The port's serving path on the CPU: GraspPipeline on the five committed
checkpoints against the JAX GraspPipeline, the replay clusters against the
JAX outputs recorded in tests/fixtures/torch_port_clusters.npz, the flax
checkpoint reader, the entry points' device rule and import hygiene.

Float outputs agree to rtol = atol = 1e-4 (float32 matmuls and reductions
summed in another order); predicted classes are equal."""

import os
import subprocess
import sys

import numpy as np
import pytest

from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import load_flax_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = {
    "classifier": "log/classification/r3_pointnet2_cls_ssg/checkpoints/best.msgpack",
    "rotation": "log/pose/r3_rotation/checkpoints/best.msgpack",
    "sign": "log/pose/r3_sign/checkpoints/best.msgpack",
    "translation": "log/pose/r3_translation_ref/checkpoints/best.msgpack",
    "width": "log/pose/r3_width_ref/checkpoints/best.msgpack",
}
PATHS = {k: os.path.join(ROOT, v) for k, v in CHECKPOINTS.items()}
FLOAT_KEYS = ("log_probs", "rotation_deg", "rotation_matrix", "sign_prob", "translation", "width")


@pytest.fixture(scope="module")
def port():
    return GraspPipeline.from_checkpoints(PipelineConfig(), PATHS, device="cpu")


def _assert_same(got, want, keys=FLOAT_KEYS, tol=1e-4):
    np.testing.assert_array_equal(got["pred_class"], np.asarray(want["pred_class"]))
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=tol, atol=tol, err_msg=k)


def _clusters(rng, K, M):
    centers = rng.uniform(-0.5, 0.5, (K, 1, 3))
    return (centers + 0.05 * rng.standard_normal((K, M, 3))).astype(np.float32)


def test_matches_jax_pipeline(port):
    """M > 1024 (FPS), M < 1024 (tiling), M == 1024 (as is); K = 3 is not a
    multiple of 4 and M = 1500 not of 256, so both packages pad the request
    to its bucket."""
    from pointnet_like_pose_estimation_tpu.pipeline import GraspPipeline as JaxPipeline
    from pointnet_like_pose_estimation_tpu.pipeline import PipelineConfig as JaxConfig

    jax_pipe = JaxPipeline.from_checkpoints(JaxConfig(), PATHS)
    rng = np.random.default_rng(0)
    for K, M in [(3, 1500), (2, 700), (2, 1024)]:
        clusters = _clusters(rng, K, M)
        got = port.infer_clusters(clusters)
        want = jax_pipe.infer_clusters(clusters)
        assert set(got) == set(want)
        _assert_same(got, want)


def test_replay_clusters_match_recorded_jax_outputs(port):
    """The replay scene is sampled on a lattice, so FPS meets distances
    that tie to the last bit. XLA on the CPU contracts the JAX distance sum
    into fused multiply-adds and the port does not, so a few of those ties
    resolve to other, equally far points: the tolerance is 1e-3 here."""
    fix = np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_clusters.npz"))
    got = port.infer_clusters(fix["clusters"])
    _assert_same(got, fix, keys=("rotation_deg", "sign_prob", "translation", "width"), tol=1e-3)


@pytest.mark.parametrize("key", ["classifier", "translation"])
def test_flax_checkpoint_reader_matches_flax(key):
    from flax.serialization import msgpack_restore
    import jax

    with open(PATHS[key], "rb") as f:
        want = msgpack_restore(f.read())
    got = load_flax_checkpoint(PATHS[key])
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_from_random_serves_on_cpu():
    pipe = GraspPipeline.from_random(seed=3, device="cpu")
    out = pipe.infer_clusters(_clusters(np.random.default_rng(1), 2, 1100))
    assert out["rotation_matrix"].shape == (2, 3, 3)
    assert all(np.isfinite(v).all() for v in out.values())


def test_entry_points_default_to_the_card(tmp_path):
    """No card and no device='cpu': the pipeline, the raw-frame stages and
    the infer command raise, they never carry on on the CPU."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch import cli
    from pointnet_like_pose_estimation_tpu_torch.pipeline import (
        CameraIntrinsics,
        clean_scene,
        cluster_point,
        deproject_depth,
        remove_plane,
    )

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cloud = np.random.default_rng(0).uniform(-1, 0, (600, 3)).astype(np.float32)
    for call in (lambda: GraspPipeline.from_random(seed=0),
                 lambda: deproject_depth(np.ones((4, 4)), CameraIntrinsics()),
                 lambda: clean_scene(cloud), lambda: remove_plane(cloud),
                 lambda: cluster_point(cloud, 0.1, 10),
                 lambda: cli.main(["infer", "--input", os.path.join(ROOT, "tests", "fixtures",
                                                                    "scene_table2obj.ply")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX, flax or the
    JAX package: the package is walked and ``cli infer`` runs in a fresh
    interpreter, and chip_smoke.py's imports are read from its source."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & {"jax", "flax", "jaxlib", "pointnet_like_pose_estimation_tpu"}, roots
    code = (
        "import sys, pkgutil, importlib\n"
        "import pointnet_like_pose_estimation_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from pointnet_like_pose_estimation_tpu_torch import cli\n"
        "cli.main(['infer', '--input', 'tests/fixtures/scene_table2obj.ply', '--device', 'cpu',\n"
        "          '--config', '{\"clip_range\": [-1, 0], \"min_points\": 200, \"radius_nb_points\": 60,'\n"
        "          ' \"radius\": 0.03, \"eps\": 0.04, \"num_points\": 128}'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'jaxlib',\n"
        "       'pointnet_like_pose_estimation_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout and '"clusters": 2' in res.stdout, res.stderr
