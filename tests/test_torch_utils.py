"""The port's utilities on the CPU: the timers of ``utils/profiling.py``
(the port of the JAX package's ``tests/test_train.py``
``test_sustained_time_converges``), ``trace``, the headless visualisers of
``utils/viz.py`` and ``utils/viz_interactive.py`` (the six cases of the JAX
package's ``tests/test_viz.py`` on the port's modules), and that the port's
``utils``, ``data`` and ``cli`` import where matplotlib and cv2 are not
installed, as on the machine with the card."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu_torch.utils import (
    sustained_step_time,
    sustained_time,
    trace,
)
from pointnet_like_pose_estimation_tpu_torch.utils import viz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- profiling -------------------------------------------------------------------------------


def test_sustained_time_converges():
    """The count of calls grows until the span is real wall clock; on the
    CPU a small product takes a sane, positive time."""
    x = torch.ones((64, 64))
    t = sustained_time(lambda a: (a @ a).sum(), x, min_seconds=0.05, max_iters=1 << 16)
    assert 0 < t < 0.05


def test_sustained_time_warns_when_max_iters_cuts_the_span():
    with pytest.warns(UserWarning, match="max_iters=8"):
        t = sustained_time(lambda: torch.zeros(1), min_seconds=10.0, max_iters=8)
    assert t > 0


def test_sustained_step_time_runs_the_port_s_train_step():
    """The step of ``make_train_step`` updates the model and optimizer in
    place; the timer returns seconds per step and leaves them stepped."""
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, build_state, make_train_step

    cfg = TrainConfig.for_model("rotation", batch_size=4, augment=False)
    spec, state = build_state(cfg, device="cpu")
    step = make_train_step(spec, cfg)
    rng = np.random.default_rng(0)
    batch = {"points": torch.from_numpy(rng.standard_normal((4, 64, 3)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 7, 4)),
             "rot": torch.from_numpy(rng.uniform(0, 30, (4, 3)).astype(np.float32)),
             "tran": torch.zeros((4, 3)), "sign": torch.ones(4), "width": torch.zeros((4, 1))}
    before = [p.detach().clone() for p in state.model.parameters()]
    t0 = time.perf_counter()
    t = sustained_step_time(step, state.model, state.optimizer, batch, state.generator,
                            min_seconds=0.05, max_iters=64)
    assert 0 < t < time.perf_counter() - t0           # a step takes part of the whole call
    assert any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters()))


def test_trace_writes_a_timeline(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


# --- visualisation ---------------------------------------------------------------------------


def test_plot_cloud_xyz_and_xyzrgb(tmp_path):
    pts = np.random.default_rng(0).normal(size=(128, 3)).astype(np.float32)
    viz.plot_cloud(pts, path=str(tmp_path / "xyz.png"))
    rgb = np.concatenate([pts, np.random.default_rng(1).uniform(size=(128, 3))], axis=1)
    viz.plot_cloud(rgb, path=str(tmp_path / "xyzrgb.png"))
    assert (tmp_path / "xyz.png").stat().st_size > 0
    assert (tmp_path / "xyzrgb.png").stat().st_size > 0


def test_plot_clusters_3d_array_and_list(tmp_path):
    rng = np.random.default_rng(0)
    viz.plot_clusters(rng.normal(size=(3, 64, 6)).astype(np.float32), path=str(tmp_path / "clusters.png"))
    viz.plot_clusters([rng.normal(size=(40, 3)), rng.normal(size=(80, 3))], path=str(tmp_path / "ragged.png"))
    assert (tmp_path / "clusters.png").stat().st_size > 0
    assert (tmp_path / "ragged.png").stat().st_size > 0


def test_plot_rgbd_background_removal(tmp_path):
    rng = np.random.default_rng(0)
    color = rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8)
    depth = rng.integers(0, 3000, size=(48, 64), dtype=np.uint16)
    viz.plot_rgbd(color, depth, depth_clip_m=1.5, path=str(tmp_path / "rgbd.png"))
    assert (tmp_path / "rgbd.png").stat().st_size > 0


def test_plot_history(tmp_path):
    history = [
        {"epoch": 0, "train_loss": 1.0, "test_loss": 1.1, "test_instance_acc": 0.3},
        {"epoch": 1, "train_loss": 0.5, "test_loss": 0.6, "test_instance_acc": 0.6},
    ]
    viz.plot_history(history, path=str(tmp_path / "hist.png"))
    assert (tmp_path / "hist.png").stat().st_size > 0


def test_rgbd_stream_headless_fallback(tmp_path, monkeypatch):
    """Without a display the RGBD viewer writes a PNG frame sequence: the
    colour image with its background greyed, beside the depth."""
    from PIL import Image

    from pointnet_like_pose_estimation_tpu_torch.utils.viz_interactive import RGBDStream

    monkeypatch.delenv("DISPLAY", raising=False)
    stream = RGBDStream(out_dir=str(tmp_path), max_frames=2, depth_clip_m=1.0)
    assert not stream.interactive
    color = np.full((8, 12, 3), 200, np.uint8)
    depth = np.full((8, 12), 500, np.uint16)  # 0.5 m
    depth[:4] = 5000  # 5 m: background, greyed out
    assert stream.show(color, depth) is True      # frame 1 < max_frames
    assert stream.show(color, depth) is False     # frame 2 reaches max_frames
    stream.close()
    frames = sorted(tmp_path.iterdir())
    assert [f.name for f in frames] == ["frame_00001.png", "frame_00002.png"]
    arr = np.asarray(Image.open(frames[0]))
    assert arr.shape == (8, 24, 3)                # side by side
    assert (arr[:4, :12] == 153).all()            # background greyed


def test_show_cloud_and_clusters_headless(tmp_path, monkeypatch):
    from pointnet_like_pose_estimation_tpu_torch.utils.viz_interactive import show_cloud, show_clusters

    monkeypatch.delenv("DISPLAY", raising=False)
    pts = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    p1 = show_cloud(pts, title="t", path=str(tmp_path / "c.png"))
    assert p1 and (tmp_path / "c.png").exists()
    p2 = show_clusters([pts, pts + 2.0], path=str(tmp_path / "cl.png"))
    assert p2 and (tmp_path / "cl.png").exists()


# --- imports ---------------------------------------------------------------------------------


def test_utils_data_and_cli_import_without_matplotlib_and_cv2():
    """The machine with the card has neither: a ``None`` in ``sys.modules``
    makes any import of them raise, and the port's modules still import."""
    code = ("import sys; sys.modules['matplotlib'] = None; sys.modules['cv2'] = None\n"
            "import pointnet_like_pose_estimation_tpu_torch.utils as u\n"
            "import pointnet_like_pose_estimation_tpu_torch.utils.viz\n"
            "import pointnet_like_pose_estimation_tpu_torch.utils.viz_interactive\n"
            "import pointnet_like_pose_estimation_tpu_torch.data\n"
            "import pointnet_like_pose_estimation_tpu_torch.data.modelnet\n"
            "import pointnet_like_pose_estimation_tpu_torch.data.stl\n"
            "import pointnet_like_pose_estimation_tpu_torch.cli\n"
            "try:\n    import matplotlib\nexcept ImportError:\n    print('blocked')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "blocked"
