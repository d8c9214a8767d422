"""The train and eval steps (counterpart of ``_prepare_inputs``,
``_loss_kwargs``, ``make_train_step``, ``make_device_epoch_runner`` and
``make_eval_step`` in ``train/steps.py`` of the JAX package).

A train step is augment -> forward -> loss -> backward -> optimizer step,
with its loss and metric left on the device: nothing in a step waits for
the card. Its random numbers (the augmentation's and each dropout site's)
are drawn first, by ``draw_step`` from the state's generator, and then
applied; a caller may draw them once and apply the same numbers on two
devices. As the JAX package jits its step, a step is one training program
(``utils/programs.py`` ``StepProgramCache``): a CUDA graph captured at its
first call and replayed at every later one; the draws stay outside the
graph, made by the host in the eager step's order, so that both consume
the same numbers from the same generator state.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.data import augment as aug
from pointnet_like_pose_estimation_tpu_torch.models import ModelSpec
from pointnet_like_pose_estimation_tpu_torch.nn.layers import Dropout
from pointnet_like_pose_estimation_tpu_torch.train.config import TrainConfig
from pointnet_like_pose_estimation_tpu_torch.utils.profiling import span
from pointnet_like_pose_estimation_tpu_torch.utils.programs import StepProgramCache, program_device

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


def _batch_fields(spec: ModelSpec, cfg: TrainConfig) -> tuple[str, ...]:
    """The entries of a raw batch that a train step reads."""
    fields = {"points", _TARGET_KEY[spec.task]}
    if spec.input_kind != "xyz":
        fields.add("labels")
    if cfg.augment and cfg.augment_consistent_labels:
        fields.update(("tran", "width"))
    return tuple(sorted(fields))


def _draw_into(draws: dict, gen: torch.Generator) -> None:
    """Refill the tensors of ``draws`` (a ``draw_step`` result) from
    ``gen`` in ``draw_step``'s order: the numbers ``draw_step`` would give
    from the same state, drawn into tensors a captured step reads."""
    for part in draws.values():
        for t in (part or {}).values():
            t.uniform_(generator=gen)


def _draw_perm(gen: torch.Generator, n: int, count: int) -> torch.Tensor:
    """An epoch's permutation of ``n`` rows from ``gen``, its first ``count``."""
    return torch.randperm(n, generator=gen, device=gen.device)[:count]


def _bound_tensors(model: nn.Module, optimizer: torch.optim.Optimizer) -> list:
    """The tensors a train step reads or writes besides its inputs:
    parameters, buffers, gradients (None where there is none yet), the
    optimizer's state and its learning rates. A graph bakes a float rate
    in, so a rate must be a tensor on the card (``make_optimizer``)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    out = [*model.parameters(), *model.buffers(), *(p.grad for p in params)]
    for p in params:
        out.extend(v for v in optimizer.state.get(p, {}).values() if isinstance(v, torch.Tensor))
    for group in optimizer.param_groups:
        if not isinstance(group["lr"], torch.Tensor) and params[0].is_cuda:
            raise ValueError("a train step on the card reads the learning rate from a tensor: build the "
                             "optimizer with make_optimizer")
        out.append(group["lr"])
    return out


class TrainStep:
    """``step(model, optimizer, batch, gen=None, *, draws=None) -> {"loss",
    "metric"}``, both 0-d tensors on the device; ``make_train_step``.

    The step draws its random numbers from ``gen`` (``draw_step``) unless
    ``draws`` are given, puts the model in train mode (the dropout sites in
    eval mode where ``draws["dropout"]`` is None), runs the forward, the
    loss and the backward, gives every parameter the loss does not reach a
    zero gradient (so that L2 decay moves it, as in optax), hands the
    gradients to ``reduce_grads`` (the data-parallel step's all-reduce) and
    steps the optimizer. The gradients stay in ``.grad`` after the step,
    each at one address (``zero_grad(set_to_none=False)``).

    A call is one training program (``utils.programs.StepProgramCache``,
    the counterpart of the JAX package's jitted, donated step) per model,
    optimizer, compute dtype and shapes of the batch and the draws: the
    batch entries the step reads and the draws are copied into its static
    inputs, the first call runs the step and captures it, every later call
    replays the graph on the card (on the CPU the program is the step
    itself). A replay's loss and metric are the program's own tensors,
    which its next call overwrites. The data-parallel step (``reduce_grads``)
    runs ``eager``, op by op. ``eager`` is the same step without a program;
    ``programs`` holds them, one cache a device.
    """

    def __init__(self, spec: ModelSpec, cfg: TrainConfig,
                 reduce_grads: Callable[[list[torch.Tensor]], None] | None = None):
        self.spec, self.cfg, self.reduce_grads = spec, cfg, reduce_grads
        self.fields = _batch_fields(spec, cfg)
        self.loss_kw = _loss_kwargs(spec, cfg)
        self.programs: dict[torch.device, StepProgramCache] = {}

    def run(self, model: nn.Module, optimizer: torch.optim.Optimizer, batch: dict, draws: dict) -> dict:
        """The step's body on its draws (what a program captures)."""
        model.train()
        sites = _dropouts(model)
        for name, m in sites:
            if draws["dropout"] is None:
                m.eval()
            else:
                m.uniforms = draws["dropout"][name]
        try:
            inputs, target = _prepare_inputs(self.spec, self.cfg, batch, train=True, draws=draws["augment"])
            outputs = model(*inputs)
        finally:
            for _, m in sites:
                m.uniforms = None
        loss = self.spec.loss(outputs, target, **self.loss_kw)
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        params = [p for group in optimizer.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.reduce_grads is not None:
            self.reduce_grads([p.grad for p in params])
        optimizer.step()
        with torch.no_grad():
            metric = self.spec.metric(outputs, target)
        return {"loss": loss.detach(), "metric": metric}

    def eager(self, model: nn.Module, optimizer: torch.optim.Optimizer, batch: dict,
              gen: torch.Generator | None = None, *, draws: dict | None = None) -> dict:
        if draws is None:
            draws = draw_step(self.cfg, model, batch, gen)
        return self.run(model, optimizer, batch, draws)

    def cache(self, device) -> StepProgramCache:
        """The programs of this step on ``device``."""
        device = program_device(device)
        if device not in self.programs:
            self.programs[device] = StepProgramCache(device)
        return self.programs[device]

    def __call__(self, model: nn.Module, optimizer: torch.optim.Optimizer, batch: dict,
                 gen: torch.Generator | None = None, *, draws: dict | None = None) -> dict:
        if self.reduce_grads is not None:
            return self.eager(model, optimizer, batch, gen, draws=draws)
        if draws is None:
            draws = draw_step(self.cfg, model, batch, gen)
        parts = {part: None if d is None else tuple(d) for part, d in draws.items()}
        inputs = [batch[k] for k in self.fields]
        inputs += [draws[part][k] for part, names in parts.items() for k in names or ()]

        def fn(*static):
            it = iter(static)
            b = {k: next(it) for k in self.fields}
            d = {part: None if names is None else {k: next(it) for k in names} for part, names in parts.items()}
            return self.run(model, optimizer, b, d)

        key = (id(model), id(optimizer), self.cfg.dtype, tuple(parts.items()),
               tuple((tuple(x.shape), x.dtype) for x in inputs))
        return self.cache(batch["points"].device)(key, fn, inputs, lambda: _bound_tensors(model, optimizer))


def make_train_step(spec: ModelSpec, cfg: TrainConfig, *,
                    reduce_grads: Callable[[list[torch.Tensor]], None] | None = None) -> TrainStep:
    """The train step of ``spec`` under ``cfg`` (``TrainStep``)."""
    return TrainStep(spec, cfg, reduce_grads)


class EpochRunner:
    """``run_epoch(model, optimizer, data, gen, stop=None) -> (sums, steps)``
    over a split already on the device (``data``: a dict of ``[M, ...]``
    tensors), the counterpart of ``make_device_epoch_runner``: one
    permutation drawn from ``gen`` on the device, the last partial batch
    dropped (``num_steps = M // batch_size``), each batch gathered by index
    on the device, and the loss and metric summed there. ``sums`` is a
    ``[2]`` tensor on the device, the one thing the caller copies to the
    host per epoch; ``stop()`` is asked before each step (preemption) and
    ``steps`` counts those that ran.

    Each step is one replay of one training program (``TrainStep``'s
    cache), captured at the epoch's first step: it reads its batch from the
    split through the epoch's permutation and a step counter on the device,
    its draws from tensors that the host refills from ``gen`` before each
    replay in ``draw_step``'s order, and adds its loss and metric to the
    sums, so that a step costs the host its draws (one launch a draw) and
    one replay. The JAX package runs the epoch as scans of
    ``cfg.epoch_chunk`` steps to bound one TPU dispatch; the port replays
    one graph a step. ``eager`` is the same epoch without a program.

    A profiler that records sees a ``train.step`` a step, which holds
    ``train.draws`` and the program's ``program.replay``
    (``utils/profiling.py`` ``span``); ``stop()`` runs outside it.
    """

    def __init__(self, spec: ModelSpec, cfg: TrainConfig, num_steps: int):
        self.step = TrainStep(spec, cfg)
        self.cfg, self.num_steps = cfg, num_steps
        self._static: dict = {}

    def _permutation(self, data: dict, gen: torch.Generator) -> torch.Tensor:
        B = self.cfg.batch_size
        perm = _draw_perm(gen, data["labels"].shape[0], self.num_steps * B)
        return perm.to(data["labels"].device).reshape(self.num_steps, B)

    def eager(self, model, optimizer, data: dict, gen: torch.Generator, stop=None):
        perm = self._permutation(data, gen)
        sums = torch.zeros(2, dtype=torch.float32, device=data["labels"].device)
        done = 0
        for i in range(self.num_steps):
            if stop is not None and stop():
                break
            out = self.step.eager(model, optimizer, {k: v[perm[i]] for k, v in data.items()}, gen)
            sums += torch.stack([out["loss"], out["metric"]])
            done += 1
        return sums, done

    def _buffers(self, key, model, data: dict) -> dict:
        """The static tensors of a program: the epoch's permutation, the
        step counter, the sums and the draws."""
        if key not in self._static:
            device = data["labels"].device
            first = {k: data[k][: self.cfg.batch_size] for k in self.step.fields}
            self._static[key] = {
                "perm": torch.zeros(self.num_steps, self.cfg.batch_size, dtype=torch.long, device=device),
                "at": torch.zeros(1, dtype=torch.long, device=device),
                "sums": torch.zeros(2, dtype=torch.float32, device=device),
                "draws": draw_step(self.cfg, model, first, torch.Generator(device=device)),
            }
        return self._static[key]

    def __call__(self, model, optimizer, data: dict, gen: torch.Generator, stop=None):
        fields, step = self.step.fields, self.step
        key = (id(model), id(optimizer), "epoch", self.cfg.dtype,
               tuple((k, tuple(data[k].shape), data[k].dtype) for k in fields))
        static = self._buffers(key, model, data)
        static["perm"].copy_(self._permutation(data, gen))
        static["at"].zero_()
        static["sums"].zero_()

        def fn():
            idx = static["perm"].index_select(0, static["at"])[0]
            out = step.run(model, optimizer, {k: data[k].index_select(0, idx) for k in fields}, static["draws"])
            static["sums"] += torch.stack([out["loss"], out["metric"]])
            static["at"] += 1

        def bound():
            return [*_bound_tensors(model, optimizer), *(data[k] for k in fields)]

        programs = step.cache(data["labels"].device)
        done = 0
        for _ in range(self.num_steps):
            if stop is not None and stop():
                break
            with span("train.step"):
                with span("train.draws"):
                    _draw_into(static["draws"], gen)
                programs(key, fn, (), bound)
            done += 1
        return static["sums"].clone(), done


def make_epoch_runner(spec: ModelSpec, cfg: TrainConfig, num_steps: int) -> EpochRunner:
    """The device-resident epoch of ``spec`` under ``cfg`` (``EpochRunner``)."""
    return EpochRunner(spec, cfg, num_steps)


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
