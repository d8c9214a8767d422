"""The port's training loop on the CPU (``train.loop.train`` and ``cli
train``), on a tiny dataset built by the port (the 7 classes, 10 clouds
each, 64 points): loss drops, resume, atomic checkpoints, preemption, the merged
``history.json``, ``best.pt`` read by ``cli eval``, ``compat_dead_tnet`` in
train mode, and the device rule. Also two of the four train steps held
against JAX ``make_train_step`` (``test_torch_train.py`` has the other two
and says how), so that xdist's ``--dist loadfile`` runs the JAX steps on
two workers.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu_torch import cli
from pointnet_like_pose_estimation_tpu_torch.data import build_dataset, load_dataset
from pointnet_like_pose_estimation_tpu_torch.models import VanillaHead, get_model_spec, init_like_flax
from pointnet_like_pose_estimation_tpu_torch.nn import BatchNormF32
from pointnet_like_pose_estimation_tpu_torch.train import (
    TrainConfig,
    build_state,
    evaluate,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    save_checkpoint,
    train,
)
from pointnet_like_pose_estimation_tpu_torch.train import loop as loop_mod
from test_torch_train import check_train_step_against_jax, no_jax_dropout, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny_fields():
    return build_dataset(10, seed=0, n_points=64, device="cpu")


@pytest.fixture(scope="module")
def tiny_ds(tiny_fields):
    return load_dataset(tiny_fields, "train"), load_dataset(tiny_fields, "test")


def _cfg(model, **kw):
    defaults = dict(model=model, num_classes=7, num_points=64, batch_size=8, epochs=2, augment=False)
    defaults.update(kw)
    return TrainConfig.for_model(**defaults)


def _exp_dir(tmp_path, cfg):
    return os.path.dirname(loop_mod._ckpt_dir(cfg))


def test_classification_loss_drops_with_augmentation(tiny_ds, tmp_path):
    train_ds, test_ds = tiny_ds
    cfg = _cfg("pointnet_cls", epochs=8, log_dir=str(tmp_path), augment=True)
    _, history = train(cfg, train_ds, test_ds, resume=False, device="cpu")
    assert [h["epoch"] for h in history] == list(range(8))
    assert min(h["train_loss"] for h in history[1:]) < history[0]["train_loss"]
    assert 0.0 <= history[-1]["test_instance_acc"] <= 1.0
    exp = _exp_dir(tmp_path, cfg)
    assert os.path.exists(os.path.join(exp, "logs", "pointnet_cls.log"))
    with open(os.path.join(exp, "config.json")) as f:
        assert json.load(f)["model"] == "pointnet_cls"


# the loop does not depend on the model; a set-abstraction model trains
# through it in chip_smoke.py, and its step is held to JAX in test_torch_train.py
@pytest.mark.parametrize("name,key", [("rotation", "test_axis_err"), ("sign", "test_metric"),
                                      ("translation", "test_mean_err")])
def test_each_task_trains(tiny_ds, tmp_path, name, key):
    train_ds, test_ds = tiny_ds
    cfg = _cfg(name, epochs=2, log_dir=str(tmp_path), learning_rate=1e-3)
    state, history = train(cfg, train_ds, test_ds, resume=False, device="cpu")
    assert len(history) == 2 and all(np.isfinite(h["train_loss"]) for h in history)
    assert key in history[-1]
    assert state.scheduler.last_epoch == 2


def test_resume_continues_from_latest_and_merges_history(tiny_ds, tmp_path):
    """Two epochs, then a call to three resumes at epoch 2: the optimizer,
    the scheduler and the generator come back with the model, so the
    resumed epoch equals the third epoch of an unbroken run; history.json
    holds epochs 0, 1, 2."""
    train_ds, test_ds = tiny_ds
    cfg = _cfg("pointnet_cls", epochs=2, log_dir=str(tmp_path), experiment="resume", augment=True)
    train(cfg, train_ds, test_ds, resume=False, device="cpu")
    _, history = train(_cfg("pointnet_cls", epochs=3, log_dir=str(tmp_path), experiment="resume",
                            augment=True), train_ds, test_ds, device="cpu")
    assert [h["epoch"] for h in history] == [2]
    with open(os.path.join(_exp_dir(tmp_path, cfg), "history.json")) as f:
        rows = json.load(f)
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    _, whole = train(_cfg("pointnet_cls", epochs=3, log_dir=str(tmp_path), experiment="whole",
                          augment=True), train_ds, test_ds, resume=False, device="cpu")
    np.testing.assert_allclose(history[0]["train_loss"], whole[2]["train_loss"], rtol=1e-5)


def test_checkpoint_roundtrip_and_eval_command(tiny_ds, tiny_fields, tmp_path, capsys):
    """``latest.pt`` restores the model ``evaluate`` scored; ``cli eval``
    takes ``best.pt`` and prints what ``evaluate`` gives for it."""
    train_ds, test_ds = tiny_ds
    cfg = _cfg("rotation", epochs=2, log_dir=str(tmp_path), experiment="rt")
    state, _ = train(cfg, train_ds, test_ds, resume=False, device="cpu")
    ckpt = loop_mod._ckpt_dir(cfg)
    assert sorted(os.listdir(ckpt)) == ["best.pt", "best.pt.json", "latest.pt", "latest.pt.json"]
    model, meta = load_checkpoint(os.path.join(ckpt, "latest.pt"), get_model_spec("rotation").make(7))
    assert meta["epoch"] == 1
    a = evaluate(cfg, state.model, test_ds, device="cpu")
    b = evaluate(cfg, model, test_ds, device="cpu")
    assert a == b
    data = tmp_path / "ds.npz"
    np.savez(data, **tiny_fields)
    best, best_meta = load_checkpoint(os.path.join(ckpt, "best.pt"), get_model_spec("rotation").make(7))
    want = evaluate(_cfg("rotation"), best, load_dataset(str(data), "test"), device="cpu")
    cli.main(["eval", "--model", "rotation", "--data", str(data), "--batch-size", "8",
              "--log-dir", str(tmp_path), "--experiment", "rt", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("checkpoint_epoch") == best_meta["epoch"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_checkpoint_write_is_atomic(tmp_path):
    """Payload and meta appear together and no .tmp is left; the state
    comes back whole."""
    cfg = _cfg("pointnet_cls")
    _, state = build_state(cfg, "cpu")
    path = str(tmp_path / "ck" / "latest.pt")
    save_checkpoint(path, state, 3, 0.5)
    assert sorted(os.listdir(tmp_path / "ck")) == ["latest.pt", "latest.pt.json"]
    _, fresh = build_state(_cfg("pointnet_cls", seed=9), "cpu")
    meta = loop_mod.restore_checkpoint(path, fresh)
    assert meta == {"epoch": 3, "metric": 0.5}
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(state.generator.get_state(), fresh.generator.get_state())


def test_preemption_saves_latest_and_resumes(tiny_ds, tmp_path, monkeypatch):
    """SIGTERM before the first step: ``latest`` saved under epoch -1, no
    finished epoch, the previous handler back; a fresh call runs all four."""
    train_ds, test_ds = tiny_ds
    cfg = _cfg("pointnet_cls", epochs=4, log_dir=str(tmp_path), experiment="preempt")
    orig = loop_mod.PreemptionGuard.__enter__

    def enter_and_fire(self):
        out = orig(self)
        signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(loop_mod.PreemptionGuard, "__enter__", enter_and_fire)
    _, history = train(cfg, train_ds, test_ds, resume=False, device="cpu")
    monkeypatch.undo()
    assert history == []
    ckpt = loop_mod._ckpt_dir(cfg)
    with open(os.path.join(ckpt, "latest.pt.json")) as f:
        assert json.load(f)["epoch"] == -1
    assert not getattr(signal.getsignal(signal.SIGTERM), "__qualname__", "").startswith("PreemptionGuard")
    _, history = train(cfg, train_ds, test_ds, device="cpu")
    assert [h["epoch"] for h in history] == [0, 1, 2, 3]


@pytest.mark.parametrize("case", ["per-step", "split below a batch"])
def test_host_batches_path(tiny_ds, tmp_path, case):
    """``device_data=False`` takes batches from ``iter_batches``; a split
    smaller than a batch runs no step and still evaluates."""
    train_ds, test_ds = tiny_ds
    kw = dict(device_data=False) if case == "per-step" else dict(batch_size=64)
    cfg = _cfg("pointnet_cls", log_dir=str(tmp_path), experiment=case.replace(" ", "_"), **kw)
    _, history = train(cfg, train_ds, test_ds, resume=False, device="cpu")
    assert len(history) == 2 and "test_instance_acc" in history[-1]
    if case == "per-step":
        assert np.isfinite(history[-1]["train_loss"]) and history[-1]["train_loss"] > 0
    else:
        assert history[-1]["train_loss"] == 0.0


def test_train_command_on_the_cpu(tiny_fields, tmp_path, capsys):
    data = tmp_path / "ds.npz"
    np.savez(data, **tiny_fields)
    cli.main(["train", "--model", "sign", "--data", str(data), "--epochs", "1", "--batch-size", "8",
              "--log-dir", str(tmp_path), "--experiment", "cli", "--device", "cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["epoch"] == 0 and "test_metric" in row
    ckpt = tmp_path / "pose" / "cli" / "checkpoints"
    assert (ckpt / "best.pt").exists() and (ckpt / "latest.pt").exists()
    with open(tmp_path / "pose" / "cli" / "config.json") as f:
        cfg = json.load(f)
    assert (cfg["model"], cfg["learning_rate"], cfg["augment"]) == ("sign", 1e-4, True)


def test_dead_tnet_updates_its_statistics_and_decays_in_train_mode():
    """``compat_dead_tnet``: a train step runs the dead T-Net for its
    BatchNorm statistics (eval skips it), and L2 decay moves its
    parameters, which the loss never reaches, by Adam's first step on the
    gradient ``wd * p``."""
    cfg = TrainConfig.for_model("rotation", augment=False)
    head = init_like_flax(VanillaHead(10, out_dim=3, compat_dead_tnet=True), torch.Generator().manual_seed(0))
    dead_bns = [m for m in head.dead_tnet.modules() if isinstance(m, BatchNormF32)]
    stats = [m.running_mean.clone() for m in dead_bns]
    params = {k: p.detach().clone() for k, p in head.dead_tnet.named_parameters()}
    rng = np.random.default_rng(0)
    batch = {"points": torch.from_numpy(rng.standard_normal((4, 32, 3)).astype(np.float32)),
             "labels": torch.tensor([0, 1, 2, 1]), "rot": torch.rand(4, 3)}
    with torch.no_grad():
        head.eval()(torch.randn(4, 32, 10))
    assert all(torch.equal(m.running_mean, s) for m, s in zip(dead_bns, stats))
    opt, _ = make_optimizer(cfg, head.parameters())
    make_train_step(get_model_spec("rotation"), cfg)(head, opt, batch, draws={"augment": None, "dropout": None})
    assert all(not torch.equal(m.running_mean, s) for m, s in zip(dead_bns, stats))
    lr, wd = cfg.learning_rate, cfg.weight_decay
    for k, p in head.dead_tnet.named_parameters():
        assert not p.grad.any(), k
        g = wd * params[k]
        torch.testing.assert_close(p.detach(), params[k] - lr * g / (g.abs() + 1e-8), rtol=1e-6, atol=1e-9)


def test_what_is_not_ported_raises_and_the_device_rule(tiny_ds, tiny_fields, tmp_path):
    train_ds, test_ds = tiny_ds
    # a run that cannot form its process group (no torchrun environment) raises
    for kw in (dict(multihost=True), dict(data_parallel=True, multihost=True)):
        with pytest.raises(ValueError, match="expected, but not set"):
            train(_cfg("pointnet_cls", log_dir=str(tmp_path), **kw), train_ds, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    for kw in ({}, dict(data_parallel=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(_cfg("pointnet_cls", log_dir=str(tmp_path), **kw), train_ds, test_ds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data = tmp_path / "ds.npz"
        np.savez(data, **tiny_fields)
        cli.main(["train", "--model", "rotation", "--data", str(data), "--log-dir", str(tmp_path)])


@pytest.mark.parametrize("name", ["sign_msg", "pointnet_cls"])
def test_train_step_matches_jax_make_train_step(name, no_jax_dropout):  # noqa: F811
    check_train_step_against_jax(name)
