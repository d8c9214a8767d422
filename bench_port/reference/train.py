"""A PointNet++ SSG train step in plain PyTorch, with the draws of the
port's device-resident epoch worked out again from its generator: a frozen
copy of the rule of the port's ``train/steps.py`` ``EpochRunner``,
``data/augment.py`` and ``train/state.py`` at commit aa745b2.

The rule, from a generator on the card: each call of the epoch runner
draws one permutation of the split's rows (``randperm``) and takes its
batches in order; each step then refills, in this order, the point
dropout's ratio ``[B, 1]`` and draws ``[B, N]``, the scale ``[B, 1, 1]``,
the shift ``[B, 1, C]`` and every dropout site's ``[B, features]`` with
unit uniforms. The augmentation replaces the points whose draw is at most
``0.875 * ratio`` by the cloud's first point, scales by U[0.8, 1.25),
shifts by U[-0.1, 0.1) and normalises. The loss is the mean negative
log-likelihood; the update is Adam (betas 0.9, 0.999, eps 1e-8) with
``weight_decay * p`` added to the gradient before the moments.
"""

from __future__ import annotations

import torch

from reference import geometry as G
from reference.models import build, dropouts

MAX_DROPOUT_RATIO = 0.875


def _in_range(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    lo32 = torch.full((), lo, dtype=torch.float32, device=u.device)
    hi32 = torch.full((), hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo32, u * (hi32 - lo32) + lo32)


def step_draws(gen: torch.Generator, B: int, N: int, C: int, sites: list[tuple[str, int]]) -> dict:
    """One step's draws from ``gen``, in the runner's order."""
    def u(*shape):
        return torch.empty(shape, device=gen.device).uniform_(generator=gen)

    d = {"ratio": u(B, 1), "drop": u(B, N), "scale": u(B, 1, 1), "shift": u(B, 1, C)}
    d["sites"] = {name: u(B, f) for name, f in sites}
    return d


def augment(points: torch.Tensor, d: dict) -> torch.Tensor:
    """Point dropout, scale, shift, then the normalisation into the unit sphere."""
    drop = d["drop"] <= d["ratio"] * MAX_DROPOUT_RATIO
    p = torch.where(drop[..., None], points[:, :1, :], points)
    p = p * _in_range(d["scale"], 0.8, 1.25)
    p = p + _in_range(d["shift"], -0.1, 0.1)
    return G.normalize_cloud(p)


def epoch_batches(gen: torch.Generator, data: dict, B: int, steps: int, count: int):
    """The first ``count`` steps of one runner call: ``(rows, draws)``
    each, drawn from ``gen`` as the runner draws them."""
    M, N, C = data["points"].shape
    perm = torch.randperm(M, generator=gen, device=gen.device)[:steps * B].reshape(steps, B)
    sites = [(name, m.features) for name, m in dropouts(build("pointnet2_cls_ssg"))]
    for i in range(count):
        yield perm[i].to(data["points"].device), step_draws(gen, B, N, C, sites)


class Trainer:
    """The model from ``state`` in train mode, computing in ``dtype``, and
    Adam's state, at learning rate ``lr`` and weight decay ``wd``."""

    def __init__(self, state: dict, num_classes: int, dtype: str, lr: float, wd: float, device):
        self.model = build("pointnet2_cls_ssg", num_classes, dtype).to(device)
        self.model.load_state_dict(state, strict=True)
        self.model.train()
        self.lr, self.wd, self.t = lr, wd, 0
        self.params = dict(self.model.named_parameters())
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def step(self, points: torch.Tensor, labels: torch.Tensor, d: dict) -> tuple[float, dict]:
        """One step: ``(loss, the raw gradient of each parameter)``."""
        for name, m in dropouts(self.model):
            m.uniforms = d["sites"][name]
        log_probs, _, _ = self.model(augment(points, d))
        loss = -log_probs.gather(1, labels[:, None].long()).mean()
        for p in self.params.values():
            p.grad = None
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
                 for k, p in self.params.items()}
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k] + self.wd * p
                self.m[k] = b1 * self.m[k] + (1 - b1) * g
                self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
                mhat = self.m[k] / (1 - b1 ** self.t)
                vhat = self.v[k] / (1 - b2 ** self.t)
                p -= self.lr * mhat / (vhat.sqrt() + eps)
        return float(loss.detach()), grads

    def leaves(self) -> dict:
        """Parameters and BatchNorm running statistics, by name."""
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()
                if not k.endswith("num_batches_tracked")}
