"""Evaluation and checkpoint loading (counterpart of ``_ckpt_dir``,
``load_checkpoint``, ``_device_eval_batches``, ``_finalize_eval`` and
``evaluate`` in ``train/loop.py`` of the JAX package). The training loop
is not ported yet.

``evaluate`` keeps the reference's metric conventions: instance and
mean-per-class accuracy for classification and sign, per-axis and
per-class absolute errors for the regressions, centimetres for
translation. The split is uploaded once, the raw sums are accumulated on
the device, and one small copy brings them to the host at the end. The JAX
package pads the split to whole batches and masks the pad, so that one
compiled program serves every batch; the port runs eagerly and lets the
last batch be short, which changes no sum (eval-mode BatchNorm treats every
cloud on its own).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.data.dataset import PoseDataset
from pointnet_like_pose_estimation_tpu_torch.models import ModelSpec, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.train.config import TrainConfig
from pointnet_like_pose_estimation_tpu_torch.train.steps import _prepare_inputs
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import (
    from_flax_variables,
    load_flax_checkpoint,
)
from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device


def _ckpt_dir(cfg: TrainConfig) -> str:
    task = "classification" if "cls" in cfg.model else "pose"
    return os.path.join(cfg.log_dir, task, cfg.experiment, "checkpoints")


def load_checkpoint(path: str, model: nn.Module):
    """Load the parameters and BatchNorm statistics of a full-state
    checkpoint written by the JAX package (``best.msgpack``) into ``model``,
    every key matched (``strict=True``). Parameters are stored as float32
    whatever the run's compute dtype. Returns ``(model, meta)`` with the
    ``{"epoch", "metric"}`` of the file beside it."""
    model.load_state_dict(from_flax_variables(load_flax_checkpoint(path)), strict=True)
    with open(path + ".json") as f:
        meta = json.load(f)
    return model, meta


def _device_eval_batches(ds: PoseDataset, batch_size: int, device: torch.device) -> list[dict]:
    """Upload the split once and cut it into batches of ``batch_size``
    (views of the uploaded tensors; the last may be short)."""
    data = {
        "points": torch.from_numpy(np.ascontiguousarray(ds.points, np.float32)),
        "labels": torch.from_numpy(np.ascontiguousarray(ds.labels, np.int64)),
        "rot": torch.from_numpy(np.ascontiguousarray(ds.rot, np.float32)),
        "tran": torch.from_numpy(np.ascontiguousarray(ds.tran, np.float32)),
        "sign": torch.from_numpy(np.ascontiguousarray(ds.sign, np.float32)),
        "width": torch.from_numpy(np.ascontiguousarray(ds.width, np.float32)[:, None]),
    }
    data = {k: v.to(device) for k, v in data.items()}
    return [{k: v[lo:lo + batch_size] for k, v in data.items()}
            for lo in range(0, len(ds), batch_size)]


def _accumulate(spec: ModelSpec, cfg: TrainConfig, sums: dict, outputs, target, labels) -> None:
    """Add one batch's raw sums, in place, on the device."""
    onehot = nn.functional.one_hot(labels, cfg.num_classes).float()         # [B, C]
    sums["n"] += labels.shape[0]
    sums["per_class_count"] += onehot.sum(dim=0)
    if spec.task == "classify":
        log_probs, _, pred = outputs
        sums["loss"] -= log_probs.gather(1, target[:, None].long()).sum()
        correct = (pred == target).float()
    elif spec.task == "sign":
        prob, hard = outputs
        t = torch.where(target.reshape(prob.shape) > 0, 1.0, 0.0)
        p = prob.clamp(1e-7, 1 - 1e-7)
        sums["loss"] -= (t * torch.log(p) + (1 - t) * torch.log(1 - p)).sum()
        correct = (hard == torch.where(target.reshape(hard.shape) > 0, 1.0, -1.0))[:, 0].float()
    else:  # rotation / translation / width regression
        err = outputs - target.reshape(outputs.shape)
        per = err * err if cfg.loss_kind == "L2_loss" else err.abs()
        sums["loss"] += per.mean(dim=-1).sum()
        sums["metric"] += err.abs().mean(dim=-1).sum()
        sums["per_class_abs_err"] += onehot.t() @ err.abs()
        return
    sums["metric"] += correct.sum()
    sums["per_class_correct"] += onehot.t() @ correct


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


def evaluate(cfg: TrainConfig, model: nn.Module, ds: PoseDataset, device="cuda") -> dict:
    """Full-split evaluation of ``model`` (moved to ``device``, eval mode)
    at ``cfg.batch_size``, with the reference's metric conventions."""
    device = resolve_device(device, "evaluate")
    if cfg.dtype != "float32":
        raise ValueError(f"evaluate: the port computes in float32 only, not {cfg.dtype}")
    spec = get_model_spec(cfg.model)
    model = model.to(device).eval()
    C, D = cfg.num_classes, 1 if spec.task == "width" else 3
    shapes = {"n": (), "loss": (), "metric": (), "per_class_count": (C,)}
    shapes.update({"per_class_correct": (C,)} if spec.task in ("classify", "sign")
                  else {"per_class_abs_err": (C, D)})
    sums = {k: torch.zeros(shape, dtype=torch.float32, device=device) for k, shape in shapes.items()}
    with torch.inference_mode():
        for batch in _device_eval_batches(ds, cfg.batch_size, device):
            inputs, target = _prepare_inputs(spec, cfg, batch, train=False)
            _accumulate(spec, cfg, sums, model(*inputs), target, batch["labels"])
        flat = torch.cat([v.reshape(-1) for v in sums.values()]).cpu().numpy()   # the one copy
    host, lo = {}, 0
    for k, shape in shapes.items():
        size = int(np.prod(shape, dtype=np.int64))
        host[k] = flat[lo:lo + size].reshape(shape)
        lo += size
    return _finalize_eval(spec, cfg, host)
