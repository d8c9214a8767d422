"""The port's ``sweep`` command on the CPU against the JAX package's: the
same 14 jobs in the same order with the same training configurations, the
resume keyed by job name under the same ``_settings`` stamp, both
refusals, and one real sweep of one epoch a job over a tiny split."""

import argparse
import json
import os

import numpy as np
import pytest

import pointnet_like_pose_estimation_tpu.train as jax_train_pkg
from pointnet_like_pose_estimation_tpu import cli as jax_cli
from pointnet_like_pose_estimation_tpu_torch import cli
import pointnet_like_pose_estimation_tpu_torch.train as train_pkg
from test_torch_train import one_torch_thread  # noqa: F401

JOBS = 14


@pytest.fixture(scope="module")
def tiny_split(tmp_path_factory):
    """Five clouds a class of 64 random points (four train, one test), so a
    batch of 24 takes one step of the 28 train clouds."""
    rng = np.random.default_rng(0)
    n = 5 * 7
    path = str(tmp_path_factory.mktemp("sweep_data") / "tiny.npz")
    np.savez(path, points=rng.standard_normal((n, 64, 3)).astype(np.float32) * 0.1,
             labels=np.repeat(np.arange(7, dtype=np.int32), 5),
             rot=rng.uniform(-40, 40, (n, 3)).astype(np.float32),
             tran=rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32),
             width=rng.uniform(0.02, 0.08, n).astype(np.float32), num_per_class=np.asarray(5))
    return path


def _recording_train(calls):
    def fake_train(cfg, train_ds, test_ds=None, **kw):
        calls.append(cfg)
        return None, [{"epoch": cfg.epochs - 1, "train_loss": 1.0}]
    return fake_train


def _args(data, log_dir, epochs=1, **extra):
    os.makedirs(log_dir, exist_ok=True)         # train, recorded here, would make it
    return argparse.Namespace(data=data, epochs=epochs, log_dir=str(log_dir), **extra)


def test_sweep_trains_the_jax_package_s_jobs(tiny_split, tmp_path, monkeypatch):
    got, want = [], []
    monkeypatch.setattr(train_pkg, "train", _recording_train(got))
    monkeypatch.setattr(jax_train_pkg, "train", _recording_train(want))
    cli.cmd_sweep(_args(tiny_split, tmp_path / "port", 3, dtype="float32", device="cpu"))
    jax_cli.cmd_sweep(_args(tiny_split, tmp_path / "jax", 3))
    assert len(got) == len(want) == JOBS
    fields = ("model", "experiment", "loss_kind", "loss_reduction", "learning_rate", "epochs", "dtype")
    assert [tuple(getattr(c, f) for f in fields) for c in got] == \
        [tuple(getattr(c, f) for f in fields) for c in want]
    assert [c.log_dir for c in got] == [str(tmp_path / "port")] * JOBS
    with open(tmp_path / "port" / "sweep_results.json") as f:
        port_rows = json.load(f)
    with open(tmp_path / "jax" / "sweep_results.json") as f:
        jax_rows = json.load(f)
    assert list(port_rows) == list(jax_rows) and port_rows["_settings"] == jax_rows["_settings"]


def test_sweep_resumes_where_it_stopped(tiny_split, tmp_path, monkeypatch):
    """A sweep cut after three jobs (its file rewritten after each) runs
    only the other eleven on the second call, and nothing on a third."""
    calls = []
    monkeypatch.setattr(train_pkg, "train", _recording_train(calls))
    args = _args(tiny_split, tmp_path, dtype="float32", device="cpu")
    cli.cmd_sweep(args)
    with open(tmp_path / "sweep_results.json") as f:
        rows = json.load(f)
    keep = list(rows)[:4]                                  # _settings and three jobs
    with open(tmp_path / "sweep_results.json", "w") as f:
        json.dump({k: rows[k] for k in keep}, f)
    calls.clear()
    cli.cmd_sweep(args)
    assert [c.experiment for c in calls] == list(rows)[4:]
    calls.clear()
    cli.cmd_sweep(args)
    assert calls == []


@pytest.mark.parametrize("stale", ["other_settings", "no_stamp"])
def test_sweep_refuses_results_of_another_budget(tiny_split, tmp_path, monkeypatch, stale):
    """Rows of another budget, or of an unknown one, would pass for this
    call's: both packages refuse them."""
    monkeypatch.setattr(train_pkg, "train", _recording_train([]))
    monkeypatch.setattr(jax_train_pkg, "train", _recording_train([]))
    rows = {"rotation_L2_loss_mean": {"epoch": 0}}
    if stale == "other_settings":
        rows["_settings"] = {"epochs": 5, "data": tiny_split}
    match = "was produced with settings" if stale == "other_settings" else "no _settings stamp"
    for pkg, extra in ((cli, dict(dtype="float32", device="cpu")), (jax_cli, {})):
        log_dir = tmp_path / pkg.__name__
        log_dir.mkdir()
        with open(log_dir / "sweep_results.json", "w") as f:
            json.dump(rows, f)
        with pytest.raises(SystemExit, match=match):
            pkg.cmd_sweep(_args(tiny_split, log_dir, 1, **extra))


def test_sweep_command_trains_one_epoch_a_job_on_the_cpu(tiny_split, tmp_path, one_torch_thread, capsys):  # noqa: F811
    """The real command: 14 jobs of one epoch on the CPU, each row finite,
    one checkpoint directory each; a second call trains nothing; another
    ``--epochs`` is refused."""
    args = ["sweep", "--data", tiny_split, "--epochs", "1", "--log-dir", str(tmp_path), "--device", "cpu"]
    cli.main(args)
    with open(tmp_path / "sweep_results.json") as f:
        rows = json.load(f)
    assert rows.pop("_settings") == {"epochs": 1, "data": tiny_split}
    assert len(rows) == JOBS
    for name, row in rows.items():
        assert row["epoch"] == 0, name
        assert all(np.isfinite(np.asarray(v, dtype=np.float64)).all() for v in row.values()), (name, row)
        task = "classification" if name.startswith("pointnet_cls") else "pose"
        assert os.path.exists(tmp_path / task / name / "checkpoints" / "latest.pt"), name
    assert len(capsys.readouterr().out.strip().splitlines()) == JOBS
    mtime = os.path.getmtime(tmp_path / "sweep_results.json")
    cli.main(args)
    assert capsys.readouterr().out.strip() == ""
    assert os.path.getmtime(tmp_path / "sweep_results.json") == mtime
    with pytest.raises(SystemExit, match="was produced with settings"):
        cli.main(args[:4] + ["2"] + args[5:])
