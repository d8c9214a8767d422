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
    """
    params = list(params)
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.learning_rate, momentum=0.9,
                              weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=cfg.lr_step_epochs, gamma=cfg.lr_gamma)
    return opt, sched


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
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
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
