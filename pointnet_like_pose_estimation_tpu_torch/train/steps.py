"""The train and eval steps (counterpart of ``_prepare_inputs``,
``_loss_kwargs``, ``make_train_step``, ``make_device_epoch_runner`` and
``make_eval_step`` in ``train/steps.py`` of the JAX package).

A train step is augment -> forward -> loss -> backward -> optimizer step,
eagerly, with its loss and metric left on the device: nothing in a step
waits for the card. Its random numbers (the augmentation's and each
dropout site's) are drawn first, by ``draw_step`` from the state's
generator, and then applied; a caller may draw them once and apply the
same numbers on two devices.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.data import augment as aug
from pointnet_like_pose_estimation_tpu_torch.models import ModelSpec
from pointnet_like_pose_estimation_tpu_torch.nn.layers import Dropout
from pointnet_like_pose_estimation_tpu_torch.train.config import TrainConfig

_TARGET_KEY = {"classify": "labels", "rotation": "rot", "translation": "tran",
               "sign": "sign", "width": "width"}


def _prepare_inputs(spec: ModelSpec, cfg: TrainConfig, batch: dict, train: bool,
                    draws: dict | None = None):
    """Augment, normalise and splice a raw batch of tensors into the
    model's inputs and its target. With ``train`` and ``cfg.augment`` the
    augmentation of ``draws`` (``aug.draw_augment``) is applied: point
    dropout, then scale and shift; with ``cfg.augment_consistent_labels``
    the same scale and shift also transform ``tran`` and ``width``. The
    centroid is taken BEFORE the normalisation."""
    points = batch["points"]
    if train and cfg.augment:
        if draws is None:
            raise ValueError("_prepare_inputs: an augmented train batch needs its draws")
        points = aug.point_dropout(points, draws["ratio"], draws["drop"])
        if cfg.augment_consistent_labels:
            s = aug.scale_factor(draws["scale"])                # [B, 1, 1]
            u = aug.shift_offset(draws["shift"])                # [B, 1, C]
            points = points * s + u
            batch = dict(batch)
            batch["tran"] = batch["tran"] * s[:, 0] + u[:, 0]
            batch["width"] = batch["width"] * s[:, 0]
        else:
            points = aug.shift(aug.scale(points, draws["scale"]), draws["shift"])
    mean = aug.cloud_mean(points, compat_first3=cfg.compat_first3_mean)
    points = aug.eval_preprocess(points)
    if spec.input_kind == "xyz":
        inputs = (points,)
    else:
        spliced = aug.splice_onehot(points, batch["labels"], cfg.num_classes)
        inputs = (spliced, mean) if spec.input_kind == "spliced_mean" else (spliced,)
    return inputs, batch[_TARGET_KEY[spec.task]]


def _loss_kwargs(spec: ModelSpec, cfg: TrainConfig) -> dict:
    if spec.task in ("rotation", "translation", "width"):
        return {"kind": cfg.loss_kind, "reduction": cfg.loss_reduction}
    if spec.task == "sign":
        return {"compat_pm1": cfg.compat_pm1_bce}
    return {}


def _dropouts(model: nn.Module) -> list[tuple[str, Dropout]]:
    return [(name, m) for name, m in model.named_modules() if isinstance(m, Dropout) and m.rate > 0]


def draw_step(cfg: TrainConfig, model: nn.Module, batch: dict, gen: torch.Generator) -> dict:
    """The random numbers of one train step, from ``gen`` in a fixed order:
    ``augment``, the augmentation's (``aug.draw_augment``; None without
    ``cfg.augment``), then ``dropout``, each dropout site's ``[B, features]``
    unit uniforms in the model's module order. A caller that sets
    ``dropout`` to None turns dropout off."""
    B = batch["points"].shape[0]
    return {
        "augment": aug.draw_augment(gen, batch["points"]) if cfg.augment else None,
        "dropout": {name: aug.uniform(gen, (B, m.features)) for name, m in _dropouts(model)},
    }


def make_train_step(spec: ModelSpec, cfg: TrainConfig, *,
                    reduce_grads: Callable[[list[torch.Tensor]], None] | None = None) -> Callable:
    """``train_step(model, optimizer, batch, gen=None, *, draws=None) ->
    {"loss", "metric"}``, both 0-d tensors on the device.

    The step draws its random numbers from ``gen`` (``draw_step``) unless
    ``draws`` are given, puts the model in train mode (the dropout sites in
    eval mode where ``draws["dropout"]`` is None), runs the forward, the
    loss and the backward, gives every parameter the loss does not reach a
    zero gradient (so that L2 decay moves it, as in optax), hands the
    gradients to ``reduce_grads`` (the data-parallel step's all-reduce) and
    steps the optimizer. The gradients stay in ``.grad`` after the step.
    """
    loss_kw = _loss_kwargs(spec, cfg)

    def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, batch: dict,
                   gen: torch.Generator | None = None, *, draws: dict | None = None) -> dict:
        if draws is None:
            draws = draw_step(cfg, model, batch, gen)
        model.train()
        sites = _dropouts(model)
        for name, m in sites:
            if draws["dropout"] is None:
                m.eval()
            else:
                m.uniforms = draws["dropout"][name]
        try:
            inputs, target = _prepare_inputs(spec, cfg, batch, train=True, draws=draws["augment"])
            outputs = model(*inputs)
        finally:
            for _, m in sites:
                m.uniforms = None
        loss = spec.loss(outputs, target, **loss_kw)
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        params = [p for group in optimizer.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if reduce_grads is not None:
            reduce_grads([p.grad for p in params])
        optimizer.step()
        with torch.no_grad():
            metric = spec.metric(outputs, target)
        return {"loss": loss.detach(), "metric": metric}

    return train_step


def make_epoch_runner(spec: ModelSpec, cfg: TrainConfig, num_steps: int) -> Callable:
    """``run_epoch(model, optimizer, data, gen, stop=None) -> (sums, steps)``
    over a split already on the device (``data``: a dict of ``[M, ...]``
    tensors): one permutation drawn from ``gen`` on the device, the last
    partial batch dropped (``num_steps = M // batch_size``), each batch
    gathered by index on the device, and the loss and metric summed there.
    ``sums`` is a ``[2]`` tensor on the device, the one thing the caller
    copies to the host per epoch; ``stop()`` is asked before each step
    (preemption) and ``steps`` counts those that ran.

    The JAX package runs the epoch as scans of ``cfg.epoch_chunk`` steps to
    bound the time of one TPU dispatch; the port launches eagerly and has
    no such bound.
    """
    step = make_train_step(spec, cfg)
    B = cfg.batch_size

    def run_epoch(model, optimizer, data: dict, gen: torch.Generator, stop=None):
        n = data["labels"].shape[0]
        perm = torch.randperm(n, generator=gen, device=gen.device)[: num_steps * B]
        perm = perm.to(data["labels"].device).reshape(num_steps, B)
        sums = torch.zeros(2, dtype=torch.float32, device=data["labels"].device)
        done = 0
        for i in range(num_steps):
            if stop is not None and stop():
                break
            batch = {k: v[perm[i]] for k, v in data.items()}
            out = step(model, optimizer, batch, gen)
            sums += torch.stack([out["loss"], out["metric"]])
            done += 1
        return sums, done

    return run_epoch


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
