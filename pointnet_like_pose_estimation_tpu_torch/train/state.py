"""Train state: the model, its optimizer and learning-rate schedule, and the
generator of the train step's random numbers (counterpart of
``train/state.py`` of the JAX package, where they are one pytree).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.models import init_like_flax
from pointnet_like_pose_estimation_tpu_torch.train.config import TrainConfig


def make_optimizer(cfg: TrainConfig, params):
    """``(optimizer, scheduler)``: Adam or SGD with momentum 0.9, both with
    ``weight_decay * p`` added to the gradient before the moments (L2, not
    AdamW), and a StepLR that the loop steps once per epoch. This is the
    JAX package's optax chain ``add_decayed_weights`` -> ``scale_by_adam``
    (eps 1e-8) or ``trace(0.9)`` -> a learning rate of ``lr *
    gamma ** (epoch // lr_step_epochs)``.

    ``torch.optim`` skips a parameter whose ``.grad`` is None, where optax
    decays every parameter; the train step therefore gives every parameter
    a gradient, zero where the loss does not reach it.

    The learning rate is a float32 tensor on the parameters' device, which
    StepLR updates in place, so that a captured train step
    (``train/steps.py``) reads the rate of the epoch it runs in. On the card
    the optimizer is safe to capture: Adam with ``capturable=True`` (its
    step count and bias corrections on the device), SGD fused (one kernel
    that reads the rate from the device, where the foreach SGD reads it
    back to the host). On the CPU, where ``capturable`` and ``fused`` do
    not apply, both are PyTorch's plain optimizers.
    """
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=device)
    on_card = device.type == "cuda"
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=cfg.weight_decay, capturable=on_card)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=cfg.weight_decay,
                              fused=True if on_card else None)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=cfg.lr_step_epochs, gamma=cfg.lr_gamma)
    return opt, sched


def restore_optimizer(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """``optimizer.load_state_dict(saved)`` into the tensors the optimizer
    already holds: its learning-rate tensors, and every state tensor it has
    (a captured train step reads and writes those). The saved rate may be a
    float (checkpoints written before the rate became a tensor) or a
    tensor; state the optimizer does not have yet is taken as loaded."""
    rates = [group["lr"] for group in optimizer.param_groups]
    held = {p: dict(state) for p, state in optimizer.state.items()}
    optimizer.load_state_dict(saved)
    for p, state in optimizer.state.items():
        for k, v in state.items():
            was = held.get(p, {}).get(k)
            if isinstance(was, torch.Tensor) and isinstance(v, torch.Tensor) and was.shape == v.shape:
                was.copy_(v)
                state[k] = was
    for group, rate in zip(optimizer.param_groups, rates):
        if isinstance(rate, torch.Tensor) and group["lr"] is not rate:
            rate.fill_(float(group["lr"]))
            group["lr"] = rate


@dataclasses.dataclass
class TrainState:
    """Everything a resumed run needs: ``model`` (train mode is set by the
    step), ``optimizer``, ``scheduler`` (stepped once per epoch) and
    ``generator``, on the model's device, from which every step draws its
    augmentation and dropout and every epoch its permutation."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s output into the tensors the state
        holds (parameters, buffers, optimizer state, learning rates), so
        that a train step captured before a restore replays on the
        restored values."""
        self.model.load_state_dict(state["model"], strict=True)
        restore_optimizer(self.optimizer, state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"])


def create_train_state(cfg: TrainConfig, model: nn.Module, device: torch.device) -> TrainState:
    """Initialise ``model`` as flax does from a CPU generator seeded with
    ``cfg.seed`` (so the weights do not depend on the device), move it to
    ``device`` and bundle the optimizer. The step generator lives on
    ``device`` and is seeded from the init generator, as the JAX package
    splits its key into an init key and a step key."""
    init_gen = torch.Generator().manual_seed(cfg.seed)
    init_like_flax(model, init_gen)
    step_seed = int(torch.randint(0, 2**62, (1,), generator=init_gen))
    model = model.to(device)
    opt, sched = make_optimizer(cfg, model.parameters())
    gen = torch.Generator(device=device).manual_seed(step_seed)
    return TrainState(model, opt, sched, gen)
