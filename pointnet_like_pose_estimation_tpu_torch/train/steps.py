"""The evaluation step (counterpart of ``_prepare_inputs`` and
``make_eval_step`` in ``train/steps.py`` of the JAX package). The training
step is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.data import augment as aug
from pointnet_like_pose_estimation_tpu_torch.models import ModelSpec
from pointnet_like_pose_estimation_tpu_torch.train.config import TrainConfig

_TARGET_KEY = {"classify": "labels", "rotation": "rot", "translation": "tran",
               "sign": "sign", "width": "width"}


def _prepare_inputs(spec: ModelSpec, cfg: TrainConfig, batch: dict, train: bool):
    """Normalize and splice a raw batch of tensors into the model's inputs
    and its target. The centroid is taken BEFORE the normalisation."""
    if train:
        raise NotImplementedError("the port's training step (augmentation) is not ported yet")
    points = batch["points"]
    mean = aug.cloud_mean(points, compat_first3=cfg.compat_first3_mean)
    points = aug.eval_preprocess(points)
    if spec.input_kind == "xyz":
        inputs = (points,)
    else:
        spliced = aug.splice_onehot(points, batch["labels"], cfg.num_classes)
        inputs = (spliced, mean) if spec.input_kind == "spliced_mean" else (spliced,)
    return inputs, batch[_TARGET_KEY[spec.task]]


def make_eval_step(spec: ModelSpec, cfg: TrainConfig) -> Callable:
    """``eval_step(model, batch) -> dict`` with the batch's loss and metric
    and its predictions. A batch may carry a ``valid`` [B] mask; loss and
    metric are means over the valid samples."""

    def eval_step(model: nn.Module, batch: dict) -> dict:
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones_like(batch["labels"], dtype=torch.float32)
        inputs, target = _prepare_inputs(spec, cfg, batch, train=False)
        with torch.inference_mode():
            outputs = model(*inputs)
            w = valid / valid.sum().clamp(min=1.0)
            if spec.task == "classify":
                log_probs, _, pred = outputs
                picked = log_probs.gather(1, target[:, None].long())[:, 0]
                return {"loss": -(picked * w).sum(),
                        "metric": ((pred == target).float() * w).sum(), "pred": pred}
            if spec.task == "sign":
                prob, hard = outputs
                t = torch.where(target.reshape(prob.shape) > 0, 1.0, 0.0)
                p = prob.clamp(1e-7, 1 - 1e-7)
                loss = -((t * torch.log(p) + (1 - t) * torch.log(1 - p))[:, 0] * w).sum()
                th = torch.where(target.reshape(hard.shape) > 0, 1.0, -1.0)
                return {"loss": loss, "metric": ((hard == th)[:, 0].float() * w).sum(),
                        "pred": hard[:, 0], "prob": prob[:, 0]}
            err = outputs - target
            per = err * err if cfg.loss_kind == "L2_loss" else err.abs()
            scale = 100.0 if spec.task == "translation" else 1.0
            return {"loss": (per.mean(dim=-1) * w).sum(),
                    "metric": (err.abs().mean(dim=-1) * w).sum() * scale,
                    "pred": outputs, "abs_err": (err.abs() * w[:, None]).sum(dim=0)}

    return eval_step
