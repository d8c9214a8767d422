"""The port's reference-layout IO, STL meshes and ModelNet loader on the CPU
against the JAX package's, on the same seeded numpy inputs. Everything here
is numpy on the host but the FPS of ModelNet's ``uniform`` mode (the plain
version on the CPU, exact on random clouds), so arrays are compared exactly
unless a tolerance is stated."""

import numpy as np
import pytest

from pointnet_like_pose_estimation_tpu.data import dataset as jax_dataset
from pointnet_like_pose_estimation_tpu.data import io_utils as jax_io
from pointnet_like_pose_estimation_tpu.data import modelnet as jax_modelnet
from pointnet_like_pose_estimation_tpu.data import stl as jax_stl
from pointnet_like_pose_estimation_tpu.pipeline import native_dbscan as jax_native
from pointnet_like_pose_estimation_tpu_torch.data import dataset, io_utils, load_reference_layout, modelnet, stl
from pointnet_like_pose_estimation_tpu_torch.pipeline import native_dbscan

FIELDS = ("points", "labels", "rot", "tran", "sign", "width")


def _write_tree(root, rng, categories=("cube", "cylinder"), count=8, rows=128):
    for cat in categories:
        for i in range(1, count + 1):
            io_utils.save_reference_layout(
                str(root), cat, i, rng.standard_normal((rows, 3)),
                rot=[10.0, -5.0, -30.0 if i % 2 else 20.0], tran=[0.1, 0.2, 0.3])


# --- the reference's txt layout -------------------------------------------------------------


def test_reference_layout_files_equal_the_jax_package(tmp_path):
    rng = np.random.default_rng(2)
    pts, rot, tran = rng.standard_normal((50, 3)), [1.5, -2.0, 30.0], [0.1, 0.2, -0.3]
    io_utils.save_reference_layout(str(tmp_path / "port"), "cube", 7, pts, rot, tran)
    jax_io.save_reference_layout(str(tmp_path / "jax"), "cube", 7, pts, rot, tran)
    for suffix in ("", "_rot", "_tran"):
        name = f"cube/cube_0007{suffix}.txt"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got = io_utils.load_reference_sample(str(tmp_path / "port"), "cube", 7)
    want = jax_io.load_reference_sample(str(tmp_path / "jax"), "cube", 7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], pts, atol=1e-6)     # %6f keeps six decimals


def test_load_csv_files_matches_numpy(tmp_path):
    """The native reader parses the txt layout as np.loadtxt does (float32
    against float32, 1e-6), as the JAX package's binding does, and marks a
    file it cannot read with -1 rows."""
    _write_tree(tmp_path, np.random.default_rng(3), ("cube",), 5, 64)
    paths = [str(tmp_path / "cube" / f"cube_{i:04d}.txt") for i in range(1, 6)]
    vals, rows = native_dbscan.load_csv_files(paths, 64, 3)
    assert vals.dtype == np.float32 and rows.dtype == np.int32 and (rows == 64).all()
    ref = np.stack([np.loadtxt(p, delimiter=",", dtype=np.float32) for p in paths])
    np.testing.assert_allclose(vals, ref, atol=1e-6)
    jvals, jrows = jax_native.load_csv_files(paths, 64, 3)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(rows, jrows)
    vals2, rows2 = native_dbscan.load_csv_files(paths + [str(tmp_path / "nope.txt")], 80, 3)
    assert rows2.tolist() == [64] * 5 + [-1]
    np.testing.assert_array_equal(vals2[:5, :64], vals)
    assert not vals2[:5, 64:].any()                        # rows past a file's end are zero


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_reference_layout_equals_the_jax_package(tmp_path, split):
    """Same tree, same ``default_rng`` seed: the same split (6001/8000 of 8
    files a class is 6 train, 2 test), the same sampled points (120 rows a
    file sampled to 100 without replacement, 80 with replacement) and the
    same sign convention."""
    rng = np.random.default_rng(4)
    _write_tree(tmp_path, rng, rows=120)
    for cat, i in (("cube", 3), ("cylinder", 8)):    # two short clouds take the other branch
        io_utils.save_reference_layout(str(tmp_path), cat, i, rng.standard_normal((80, 3)),
                                       rot=[1.0, 2.0, -3.0], tran=[0.0, 0.1, 0.2])
    kw = dict(num_points=100, categories=["cube", "cylinder"])
    got = load_reference_layout(str(tmp_path), split, rng=np.random.default_rng(9), **kw)
    want = jax_dataset.load_reference_layout(str(tmp_path), split, rng=np.random.default_rng(9), **kw)
    assert isinstance(got, dataset.PoseDataset)
    assert len(got) == (12 if split == "train" else 4)
    for key in FIELDS:
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert (got.rot[:, 2] >= 0).all() and set(np.unique(got.sign)) <= {-1.0, 1.0}


def test_load_reference_layout_refuses_a_missing_tree_and_unreadable_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="no reference-layout samples"):
        load_reference_layout(str(tmp_path), categories=["cube"])
    _write_tree(tmp_path, np.random.default_rng(5), ("cube",), 4, 16)
    (tmp_path / "cube" / "cube_0002_rot.txt").unlink()
    with pytest.raises(FileNotFoundError, match="unreadable sample files"):
        load_reference_layout(str(tmp_path), "train", num_points=8, categories=["cube"])


# --- STL -------------------------------------------------------------------------------------


def _mesh(rng, T=40):
    return rng.standard_normal((T, 3, 3))


def test_stl_binary_round_trip_equals_the_jax_package(tmp_path):
    tris = _mesh(np.random.default_rng(6))
    stl.save_stl(str(tmp_path / "port.stl"), tris)
    jax_stl.save_stl(str(tmp_path / "jax.stl"), tris)
    assert (tmp_path / "port.stl").read_bytes() == (tmp_path / "jax.stl").read_bytes()
    got = stl.load_stl(str(tmp_path / "port.stl"))
    np.testing.assert_array_equal(got, jax_stl.load_stl(str(tmp_path / "port.stl")))
    np.testing.assert_array_equal(got, tris.astype(np.float32))      # float32 on disk


def test_stl_ascii_and_a_binary_file_named_solid(tmp_path):
    (tmp_path / "tri.stl").write_text(
        "solid test\nfacet normal 0 0 1\n outer loop\n  vertex 0 0 0\n  vertex 1 0 0\n"
        "  vertex 0 1 0\n endloop\nendfacet\nendsolid test\n")
    tris = stl.load_stl(str(tmp_path / "tri.stl"))
    np.testing.assert_array_equal(tris, [[[0, 0, 0], [1, 0, 0], [0, 1, 0]]])
    np.testing.assert_array_equal(tris, jax_stl.load_stl(str(tmp_path / "tri.stl")))
    # a binary file whose header starts with "solid" is read as binary
    mesh = _mesh(np.random.default_rng(7), 3)
    stl.save_stl(str(tmp_path / "bin.stl"), mesh)
    data = bytearray((tmp_path / "bin.stl").read_bytes())
    data[:5] = b"solid"
    (tmp_path / "bin.stl").write_bytes(bytes(data))
    np.testing.assert_array_equal(stl.load_stl(str(tmp_path / "bin.stl")), mesh.astype(np.float32))


def test_sample_mesh_surface_equals_the_jax_package():
    tris = _mesh(np.random.default_rng(8))
    got = stl.sample_mesh_surface(tris, 500, np.random.default_rng(1))
    want = jax_stl.sample_mesh_surface(tris, 500, np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="degenerate"):
        stl.sample_mesh_surface(np.zeros((2, 3, 3)), 5)


# --- ModelNet --------------------------------------------------------------------------------


def _modelnet_tree(root, rows=200):
    """The JAX package's test tree: two shapes, three random clouds each
    (x, y, z, nx, ny, nz), the first two of each in the train split."""
    rng = np.random.default_rng(0)
    shapes = ["bed", "night_stand"]
    (root / "modelnet10_shape_names.txt").write_text("\n".join(shapes) + "\n")
    train_ids, test_ids = [], []
    for shape in shapes:
        (root / shape).mkdir()
        for i in range(1, 4):
            sid = f"{shape}_{i:04d}"
            np.savetxt(root / shape / f"{sid}.txt", rng.standard_normal((rows, 6)).astype(np.float32),
                       delimiter=",")
            (train_ids if i < 3 else test_ids).append(sid)
    (root / "modelnet10_train.txt").write_text("\n".join(train_ids) + "\n")
    (root / "modelnet10_test.txt").write_text("\n".join(test_ids) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def modelnet_roots(tmp_path_factory):
    """One tree for each package, so neither reads the other's cache."""
    return (_modelnet_tree(tmp_path_factory.mktemp("port")),
            _modelnet_tree(tmp_path_factory.mktemp("jax")))


def test_pc_normalize_equals_the_jax_package():
    pc = np.random.default_rng(1).standard_normal((50, 3)) * 5 + 3
    np.testing.assert_array_equal(modelnet.pc_normalize(pc), jax_modelnet.pc_normalize(pc))


@pytest.mark.parametrize("uniform", [False, True], ids=["head", "uniform"])
@pytest.mark.parametrize("use_normals", [False, True], ids=["xyz", "normals"])
def test_modelnet_equals_the_jax_package(modelnet_roots, uniform, use_normals):
    """Head mode cuts each cloud to its first rows; uniform mode resamples
    it by FPS (the port's plain version here) and finds the normals of the
    sampled rows: the same points, bit for bit."""
    port_root, jax_root = modelnet_roots
    kw = dict(npoints=32, uniform=uniform, use_normals=use_normals, cache=False)
    for split, m in (("train", 4), ("test", 2)):
        got = modelnet.ModelNetDataset(port_root, 10, split, device="cpu", **kw)
        want = jax_modelnet.ModelNetDataset(jax_root, 10, split, **kw)
        assert got.points.shape == (m, 32, 6 if use_normals else 3)
        assert got.points.dtype == want.points.dtype == np.float32
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.classes == want.classes and got.datapath[0][0] == "bed"
        np.testing.assert_allclose(np.sqrt((got.points[..., :3] ** 2).sum(-1)).max(-1), 1.0, rtol=1e-5)


def test_modelnet_cache_is_the_jax_package_s_and_as_pose_dataset(modelnet_roots):
    """The port writes its cache under the JAX package's name and layout:
    the JAX loader reads it back as its own, and a second port load reads
    it too. ``as_pose_dataset`` has zero pose targets."""
    port_root, _ = modelnet_roots
    ds = modelnet.ModelNetDataset(port_root, 10, "train", npoints=64, device="cpu")
    cache = f"{port_root}/modelnet10_train_64pts_head.npz"
    with np.load(cache) as data:
        np.testing.assert_array_equal(data["points"], ds.points)
    again = jax_modelnet.ModelNetDataset(port_root, 10, "train", npoints=64)
    np.testing.assert_array_equal(again.points, ds.points)
    np.testing.assert_array_equal(
        modelnet.ModelNetDataset(port_root, 10, "train", npoints=64, device="cpu").points, ds.points)
    got, want = ds.as_pose_dataset(), again.as_pose_dataset()
    assert isinstance(got, dataset.PoseDataset) and len(got) == 4
    for key in FIELDS:
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)


def test_modelnet_and_the_sweep_command_default_to_the_card(modelnet_roots, tmp_path):
    """No card and no device='cpu': ModelNet's loader and ``cli sweep``
    raise, they never carry on on the CPU."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        modelnet.ModelNetDataset(modelnet_roots[0], 10, "train", npoints=16, cache=False)
    data = dataset.build_dataset(1, n_points=8, categories=["cube"], device="cpu", path=str(tmp_path / "d.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["sweep", "--data", data, "--epochs", "1", "--log-dir", str(tmp_path / "log")])
