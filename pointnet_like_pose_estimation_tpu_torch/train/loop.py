"""Training loop, evaluation and checkpoints (counterpart of
``train/loop.py`` of the JAX package).

``train`` runs the reference's recipe on one device: the train split
uploaded once, an epoch of train steps on it (``steps.make_epoch_runner``,
on the card one replay of a captured training program a step), one small
copy to the host per epoch, an
``evaluate`` of the test split after each epoch, the best checkpoint by the
task's direction and the latest every ``cfg.ckpt_every`` epochs, a merged
``history.json`` written atomically after every epoch, and SIGTERM/SIGINT
answered by saving ``latest`` and leaving. A run resumes from ``latest.pt``.

Checkpoints are the port's own full state (model, optimizer, scheduler,
step generator, epoch) in ``best.pt`` and ``latest.pt`` beside the JAX
package's ``best.msgpack`` in the same directory, which they never
overwrite; ``load_checkpoint`` reads either.

``evaluate`` keeps the reference's metric conventions: instance and
mean-per-class accuracy for classification and sign, per-axis and
per-class absolute errors for the regressions, centimetres for
translation. The split is padded to whole batches and uploaded once, as
the JAX package's ``make_device_eval_runner`` takes it, so that one
program serves every batch (on the card a CUDA graph, captured at the
first batch and replayed at the others; ``_eval_sums``); the raw sums,
masked to the real rows, are accumulated on the device, and one small copy
brings them to the host at the end.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.data.dataset import PoseDataset, iter_batches
from pointnet_like_pose_estimation_tpu_torch.models import ModelSpec, build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.nn import set_compute_dtype
from pointnet_like_pose_estimation_tpu_torch.train.config import TrainConfig
from pointnet_like_pose_estimation_tpu_torch.train.state import TrainState, create_train_state
from pointnet_like_pose_estimation_tpu_torch.train.steps import (
    _TARGET_KEY,
    _prepare_inputs,
    make_epoch_runner,
    make_train_step,
)
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import (
    from_flax_variables,
    load_flax_checkpoint,
)
from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device
from pointnet_like_pose_estimation_tpu_torch.utils.programs import StepProgramCache, program_device

log = logging.getLogger("plpe_torch.train")

_HIGHER_IS_BETTER = {"classify": True, "sign": True, "rotation": False,
                     "translation": False, "width": False}


def _ckpt_dir(cfg: TrainConfig) -> str:
    task = "classification" if "cls" in cfg.model else "pose"
    return os.path.join(cfg.log_dir, task, cfg.experiment, "checkpoints")


def save_checkpoint(path: str, state: TrainState, epoch: int, metric: float) -> None:
    """Write the full train state to ``path`` (``*.pt``) and ``{"epoch",
    "metric"}`` to ``path + ".json"``, atomically: each through a ``.tmp``
    and ``os.replace``, the payload first, so that a reader who finds the
    ``.json`` can trust the payload."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({**state.state_dict(), "epoch": epoch}, tmp)
    with open(tmp + ".json", "w") as f:
        json.dump({"epoch": epoch, "metric": float(metric)}, f)
    os.replace(tmp, path)
    os.replace(tmp + ".json", path + ".json")


def _read_payload(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> dict:
    """Load a ``save_checkpoint`` file into ``state``; returns its meta."""
    state.load_state_dict(_read_payload(path))
    with open(path + ".json") as f:
        return json.load(f)


def load_checkpoint(path: str, model: nn.Module):
    """Load the parameters and BatchNorm statistics of a checkpoint into
    ``model``, every key matched (``strict=True``): the port's own ``*.pt``
    (``save_checkpoint``) or the JAX package's full-state ``best.msgpack``,
    whose parameters are stored as float32 whatever the run's compute
    dtype. Returns ``(model, meta)`` with the ``{"epoch", "metric"}`` of the
    file beside it."""
    if path.endswith(".pt"):
        weights = _read_payload(path)["model"]
    else:
        weights = from_flax_variables(load_flax_checkpoint(path))
    model.load_state_dict(weights, strict=True)
    with open(path + ".json") as f:
        meta = json.load(f)
    return model, meta


def best_checkpoint(cfg: TrainConfig) -> str:
    """The experiment's best checkpoint: the port's ``best.pt`` where it
    has one, else the JAX package's ``best.msgpack``."""
    ckpt = _ckpt_dir(cfg)
    path = os.path.join(ckpt, "best.pt")
    return path if os.path.exists(path) else os.path.join(ckpt, "best.msgpack")


def _host_arrays(ds: PoseDataset) -> dict:
    """The split's arrays as the device takes them (labels as int64,
    ``width`` as ``[M, 1]``)."""
    return {
        "points": np.ascontiguousarray(ds.points, np.float32),
        "labels": np.ascontiguousarray(ds.labels, np.int64),
        "rot": np.ascontiguousarray(ds.rot, np.float32),
        "tran": np.ascontiguousarray(ds.tran, np.float32),
        "sign": np.ascontiguousarray(ds.sign, np.float32),
        "width": np.ascontiguousarray(ds.width, np.float32).reshape(-1, 1),
    }


def _device_data(ds: PoseDataset, device: torch.device) -> dict:
    """The split's arrays as tensors on ``device``, uploaded once."""
    return {k: torch.from_numpy(v).to(device) for k, v in _host_arrays(ds).items()}


def _device_eval_batches(ds: PoseDataset, batch_size: int, device: torch.device) -> list[dict]:
    """The split padded to whole batches (row 0 repeated, as the JAX
    package's ``_device_eval_batches`` pads it), uploaded once and cut into
    batches of ``batch_size`` (views of the uploaded tensors), each with
    its ``[B]`` float mask ``valid``, 0 on the pad rows."""
    m = len(ds)
    nb = -(-m // batch_size)
    rows = np.concatenate([np.arange(m), np.zeros(nb * batch_size - m, np.int64)])
    data = {k: v[rows] for k, v in _host_arrays(ds).items()}
    data["valid"] = (np.arange(nb * batch_size) < m).astype(np.float32)
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    return [{k: v[i * batch_size:(i + 1) * batch_size] for k, v in data.items()} for i in range(nb)]


def _sum_shapes(spec: ModelSpec, cfg: TrainConfig) -> dict:
    """The raw sums of an eval pass and their shapes, in their order in the
    flat vector of ``_batch_sums``."""
    C, D = cfg.num_classes, 1 if spec.task == "width" else 3
    shapes = {"n": (), "loss": (), "metric": (), "per_class_count": (C,)}
    shapes.update({"per_class_correct": (C,)} if spec.task in ("classify", "sign")
                  else {"per_class_abs_err": (C, D)})
    return shapes


def _batch_sums(spec: ModelSpec, cfg: TrainConfig, model: nn.Module, batch: dict) -> torch.Tensor:
    """One padded batch's raw sums over its valid rows, as one flat float32
    vector in ``_sum_shapes``' order: the body of the JAX package's
    ``make_device_eval_runner`` scan (every term weighted by ``valid``)."""
    v = batch["valid"]
    labels = batch["labels"]
    inputs, target = _prepare_inputs(spec, cfg, batch, train=False)
    outputs = model(*inputs)
    onehot = nn.functional.one_hot(labels, cfg.num_classes).float() * v[:, None]      # [B, C], masked
    sums = {"n": v.sum(), "per_class_count": onehot.sum(dim=0)}
    if spec.task == "classify":
        log_probs, _, pred = outputs
        sums["loss"] = -(log_probs.gather(1, target[:, None].long())[:, 0] * v).sum()
        correct = (pred == target).float() * v
    elif spec.task == "sign":
        prob, hard = outputs
        t = torch.where(target.reshape(prob.shape) > 0, 1.0, 0.0)
        p = prob.clamp(1e-7, 1 - 1e-7)
        sums["loss"] = (-(t * torch.log(p) + (1 - t) * torch.log(1 - p))[:, 0] * v).sum()
        correct = (hard == torch.where(target.reshape(hard.shape) > 0, 1.0, -1.0))[:, 0].float() * v
    else:  # rotation / translation / width regression
        err = outputs - target.reshape(outputs.shape)
        per = err * err if cfg.loss_kind == "L2_loss" else err.abs()
        sums["loss"] = (per.mean(dim=-1) * v).sum()
        sums["metric"] = (err.abs().mean(dim=-1) * v).sum()
        sums["per_class_abs_err"] = onehot.t() @ (err.abs() * v[:, None])
    if spec.task in ("classify", "sign"):
        sums["metric"] = correct.sum()
        sums["per_class_correct"] = onehot.t() @ correct
    return torch.cat([sums[k].reshape(-1).float() for k in _sum_shapes(spec, cfg)])


def _host_sums(spec: ModelSpec, cfg: TrainConfig, flat: torch.Tensor) -> dict:
    """``_batch_sums``' flat vector (summed over a pass) as host numpy
    arrays by name: the pass's one copy to the host."""
    flat = flat.cpu().numpy()
    host, lo = {}, 0
    for k, shape in _sum_shapes(spec, cfg).items():
        size = int(np.prod(shape, dtype=np.int64))
        host[k] = flat[lo:lo + size].reshape(shape)
        lo += size
    return host


def _finalize_eval(spec: ModelSpec, cfg: TrainConfig, sums: dict) -> dict:
    """Turn the raw sums (host numpy arrays) into the reference's metrics."""
    n = max(float(sums["n"]), 1.0)
    scale = 100.0 if spec.task == "translation" else 1.0
    result = {"loss": float(sums["loss"]) / n, "metric": float(sums["metric"]) * scale / n}
    cnt = sums["per_class_count"]
    seen = cnt > 0
    if spec.task in ("classify", "sign"):
        pcc = sums["per_class_correct"]
        acc = pcc[seen] / cnt[seen]
        result["instance_acc"] = float(pcc.sum() / max(cnt.sum(), 1.0))
        result["class_acc"] = float(acc.mean())
        result["per_class_acc"] = acc.tolist()
    else:
        pce = sums["per_class_abs_err"]                       # [C, D]
        axis_err = pce.sum(0) / n * scale
        result["axis_err"] = axis_err.tolist()
        result["mean_err"] = float(axis_err.mean())
        pc = pce / np.maximum(cnt[:, None], 1) * scale
        result["per_class_axis_err"] = pc[seen].tolist()
    return result


def eval_programs(model: nn.Module, device) -> StepProgramCache:
    """The eval programs of ``model`` on ``device``, which the model owns
    (a copy of the model starts with none): each is bound to this model's
    tensors, and is made anew if one of them was replaced."""
    device = program_device(device)
    caches = model.__dict__.setdefault("_eval_programs", {})
    if device not in caches:
        caches[device] = StepProgramCache(device)
    return caches[device]


def _eval_sums(spec: ModelSpec, cfg: TrainConfig, model: nn.Module, batches: list[dict],
               device: torch.device) -> dict:
    """The raw sums of ``evaluate`` over padded batches already on
    ``device``, on the host. A batch is one eval program (eval mode,
    ``eval_programs``) per compute dtype, task and batch shapes: the batch
    entries it reads are copied into its static inputs, the first batch runs
    and captures it, every later batch replays it; the sums stay on the
    device and come to the host in one copy."""
    model.eval()
    fields = tuple(sorted({"points", "labels", "valid", _TARGET_KEY[spec.task]}))

    def fn(*static):
        model.eval()
        with torch.no_grad():
            return _batch_sums(spec, cfg, model, dict(zip(fields, static)))

    def bound():
        return [*model.parameters(), *model.buffers()]

    programs = eval_programs(model, device)
    total = torch.zeros(sum(int(np.prod(s, dtype=np.int64)) for s in _sum_shapes(spec, cfg).values()),
                        dtype=torch.float32, device=device)
    for batch in batches:
        inputs = [batch[k] for k in fields]
        key = ("eval", spec.task, cfg.dtype, cfg.num_classes, cfg.loss_kind, cfg.compat_first3_mean,
               tuple((tuple(x.shape), x.dtype) for x in inputs))
        total += programs(key, fn, inputs, bound)
    return _host_sums(spec, cfg, total)


def _evaluate_batches(spec: ModelSpec, cfg: TrainConfig, model: nn.Module, batches: list[dict],
                      device: torch.device) -> dict:
    """``evaluate`` over padded batches already on ``device``."""
    return _finalize_eval(spec, cfg, _eval_sums(spec, cfg, model, batches, device))


def evaluate(cfg: TrainConfig, model: nn.Module, ds: PoseDataset, device="cuda") -> dict:
    """Full-split evaluation of ``model`` (moved to ``device``, eval mode,
    its Linear layers set to compute in ``cfg.dtype``, as the JAX package
    evaluates the model it built in that dtype) at ``cfg.batch_size``, with
    the reference's metric conventions."""
    device = resolve_device(device, "evaluate")
    spec = get_model_spec(cfg.model)
    model = set_compute_dtype(model, cfg.dtype).to(device)
    return _evaluate_batches(spec, cfg, model, _device_eval_batches(ds, cfg.batch_size, device), device)


def build_state(cfg: TrainConfig, device="cuda") -> tuple[ModelSpec, TrainState]:
    """The model spec and a fresh train state (``create_train_state``) for
    ``cfg`` on ``device``."""
    device = resolve_device(device, "build_state")
    spec = get_model_spec(cfg.model)
    return spec, create_train_state(cfg, build_model(cfg.model, cfg.num_classes, cfg.dtype), device)


class PreemptionGuard:
    """SIGTERM and SIGINT set ``preempted``, which the loop reads before
    every step and at every epoch's end: it then saves ``latest`` and
    leaves. The previous handlers come back on exit; a second signal goes
    to them (or to the default handler), so a hard kill still works."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous = {}
        self.preempted = False

    def _handle(self, signum, frame):
        if self.preempted:  # second signal: defer to the original handler
            handler = self._previous.get(signum)
            if callable(handler):
                handler(signum, frame)
            else:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self.preempted = True
        log.warning("preemption signal %s: will checkpoint and exit", signum)

    def __enter__(self):
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handle)
            except ValueError:  # not the main thread: run unguarded
                pass
        return self

    def __exit__(self, *exc):
        for s, h in self._previous.items():
            signal.signal(s, h)
        return False


def _persist_history(hist_path: str, history: list[dict]) -> None:
    """Merge this run's rows into ``history.json`` by epoch (this run wins),
    written through a ``.tmp`` and ``os.replace``."""
    if not history:
        return
    rows: dict[int, dict] = {}
    if os.path.exists(hist_path):
        try:
            with open(hist_path) as f:
                rows = {r["epoch"]: r for r in json.load(f)}
        except (ValueError, KeyError, TypeError):
            rows = {}
    rows.update({r["epoch"]: r for r in history})
    tmp = hist_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump([rows[e] for e in sorted(rows)], f, indent=2)
    os.replace(tmp, hist_path)


def train(cfg: TrainConfig, train_ds: PoseDataset, test_ds: PoseDataset | None = None, *,
          resume: bool = True, device="cuda") -> tuple[TrainState, list[dict]]:
    """Run the training recipe of ``cfg`` on ``device`` (the card unless
    ``device="cpu"``); returns ``(state, history)``, one row per epoch that
    this call ran.

    The train split lives on the device and each epoch draws a permutation
    there (``steps.make_epoch_runner``); with ``cfg.device_data`` off, or a
    split smaller than a batch, batches come from ``iter_batches`` on the
    host, shuffled by a numpy generator seeded with ``cfg.seed``, as the
    JAX package's per-step path. Either way a step leaves its loss and
    metric on the device and the host reads them once per epoch. On the
    card every step and every batch of the per-epoch eval is a replay of a
    captured program (``steps.TrainStep``, ``_eval_sums``), captured at its
    first call, which comes after a resume has restored the state.

    ``cfg.multihost`` joins the process group of the ``torchrun``
    environment (``env://``), the counterpart of
    ``jax.distributed.initialize``; ``cfg.data_parallel`` trains with
    ``parallel.make_parallel_train_step`` over all of its ranks (a world of
    one outside ``torchrun``), each rank on ``cuda:{LOCAL_RANK}``, its rows
    of batches that every rank draws alike on the host (the per-step path,
    as in the JAX package). Rank 0 alone writes ``config.json``, the log,
    the history and the checkpoints, and the other ranks wait for it at a
    barrier; every rank reads ``latest.pt`` to resume and evaluates the
    test split. A preemption signal is honoured at an epoch's end there,
    when the ranks agree on it, so that all of them stop after the same
    step. The data-parallel step runs op by op (its NCCL all-reduces are
    not captured).
    """
    # parallel/ imports train/, so it is imported here, when train() runs
    from pointnet_like_pose_estimation_tpu_torch.parallel import (
        axis_size,
        collectives,
        init_process_group,
        make_mesh,
        make_parallel_train_step,
        replicate,
        shard_batch,
    )

    mesh = None
    if cfg.multihost or cfg.data_parallel:
        device = init_process_group(device, multihost=cfg.multihost)
    device = resolve_device(device, "train")
    rank = dist.get_rank() if dist.is_initialized() else 0
    spec, state = build_state(cfg, device)
    steps_per_epoch = len(train_ds) // cfg.batch_size
    use_device_data = cfg.device_data and steps_per_epoch > 0 and not cfg.data_parallel
    if cfg.data_parallel:
        mesh = make_mesh(device_type=device.type)
        if cfg.batch_size % axis_size(mesh, "data"):
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by data axis {axis_size(mesh, 'data')}")
        replicate(state.model, mesh)
        train_step = make_parallel_train_step(spec, cfg, mesh)
    elif use_device_data:
        run_epoch = make_epoch_runner(spec, cfg, steps_per_epoch)
        dev_train = _device_data(train_ds, device)
    else:
        train_step = make_train_step(spec, cfg)
    eval_batches = (_device_eval_batches(test_ds, cfg.batch_size, device)
                    if test_ds is not None and len(test_ds) else None)

    ckpt = _ckpt_dir(cfg)
    exp_dir = os.path.dirname(ckpt)
    logs_dir = os.path.join(exp_dir, "logs")
    fh = None
    if rank == 0:
        os.makedirs(logs_dir, exist_ok=True)
        with open(os.path.join(exp_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
        fh = logging.FileHandler(os.path.join(logs_dir, f"{cfg.model}.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        log.addHandler(fh)
    _barrier()

    start_epoch, best_metric = 0, None
    latest, best = os.path.join(ckpt, "latest.pt"), os.path.join(ckpt, "best.pt")
    if resume and os.path.exists(latest):
        start_epoch = restore_checkpoint(latest, state)["epoch"] + 1
        if os.path.exists(best + ".json"):
            with open(best + ".json") as f:
                best_metric = json.load(f)["metric"]
        log.info("resumed from epoch %d", start_epoch)

    higher = _HIGHER_IS_BETTER[spec.task]
    hist_path = os.path.join(exp_dir, "history.json")
    history = []
    rng = np.random.default_rng(cfg.seed)
    guard = PreemptionGuard()
    stop = (lambda: False) if mesh is not None else (lambda: guard.preempted)  # noqa: E731
    guard.__enter__()
    try:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            if use_device_data:
                sums, n = run_epoch(state.model, state.optimizer, dev_train, state.generator, stop)
            else:
                sums, n = torch.zeros(2, device=device), 0
                for raw in iter_batches(train_ds, cfg.batch_size, rng=rng):
                    if stop():
                        break
                    if mesh is not None:
                        raw = shard_batch(raw, mesh)
                    batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in raw.items()}
                    batch["labels"] = batch["labels"].long()
                    out = train_step(state.model, state.optimizer, batch, state.generator)
                    sums += torch.stack([out["loss"], out["metric"]])
                    n += 1
            if mesh is not None:            # the ranks agree on a signal any of them had
                flag = torch.tensor([float(guard.preempted)], device=device)
                guard.preempted = bool(collectives.all_reduce_(flag, mesh.get_group("data"), "stop",
                                                               dist.ReduceOp.MAX).item())
            if guard.preempted and n < steps_per_epoch:
                # a partial epoch: saved under the previous epoch, so that a
                # resumed run repeats this one whole
                if rank == 0:
                    save_checkpoint(latest, state, epoch - 1, 0.0)
                _barrier()
                log.warning("preempted during epoch %d; latest saved, exiting", epoch)
                break
            loss_sum, metric_sum = sums.cpu().tolist()               # the one copy of the epoch
            if n:       # StepLR counts epochs of steps, as optax counts steps
                state.scheduler.step()
            row = {"epoch": epoch, "train_loss": loss_sum / max(n, 1),
                   "train_metric": metric_sum / max(n, 1), "seconds": time.time() - t0}
            if eval_batches is not None:
                ev = _evaluate_batches(spec, cfg, state.model, eval_batches, device)
                row.update({f"test_{k}": v for k, v in ev.items()})
                key = "test_instance_acc" if spec.task == "classify" else (
                    "test_metric" if spec.task == "sign" else "test_mean_err")
                cur = row[key]
                if best_metric is None or (cur > best_metric if higher else cur < best_metric):
                    best_metric = cur
                    if rank == 0:
                        save_checkpoint(best, state, epoch, cur)
            # a preempted run always saves the epoch it finished
            if rank == 0 and ((epoch + 1) % cfg.ckpt_every == 0 or epoch == cfg.epochs - 1 or guard.preempted):
                save_checkpoint(latest, state, epoch, row["train_loss"])
            history.append(row)
            if rank == 0:
                _persist_history(hist_path, history)
            _barrier()
            log.info("%s", row)
            if guard.preempted:
                log.warning("preempted after epoch %d; exiting cleanly", epoch)
                break
    finally:
        guard.__exit__()
        if fh is not None:
            log.removeHandler(fh)
            fh.close()
    return state, history


def _barrier() -> None:
    """Wait for every rank of the default process group, if there is one."""
    if dist.is_initialized():
        dist.barrier()
