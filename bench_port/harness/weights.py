"""Weights from the seed, made on the device in a few large draws.

Every Linear weight is He-normal (std sqrt(2 / fan_in)), so that a
signal keeps its scale through the ReLU stacks and the classes and poses
of random models are far apart; biases are N(0, 0.05^2). BatchNorm scales
are U[0.8, 1.2), shifts N(0, 0.05^2), running means N(0, 0.05^2) and
running variances U[0.5, 1.5), so that eval-mode BatchNorm is no identity.
One generator on the device draws one tensor per kind for the whole model;
the leaves are views of it, copied into a ``state_dict`` in float32, the
type the models are served and trained in.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def make_state(model: nn.Module, seed: int, device) -> dict:
    """A ``state_dict`` for ``model`` (a reference model, whose module
    names and shapes are the port's) drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    linears = [m for m in model.modules() if isinstance(m, nn.Linear)]
    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm1d)]
    n_w = sum(m.weight.numel() for m in linears)
    n_b = sum(m.bias.numel() for m in linears)
    n_c = sum(m.num_features for m in norms)
    w = torch.randn(n_w, generator=gen, device=device)
    b = torch.randn(n_b, generator=gen, device=device) * 0.05
    bn = torch.rand((2, n_c), generator=gen, device=device)
    bn_n = torch.randn((2, n_c), generator=gen, device=device) * 0.05
    values = {}
    at_w = at_b = 0
    for m in linears:
        k = m.weight.numel()
        values[id(m.weight)] = w[at_w:at_w + k].view_as(m.weight) * math.sqrt(2.0 / m.in_features)
        values[id(m.bias)] = b[at_b:at_b + m.bias.numel()]
        at_w += k
        at_b += m.bias.numel()
    at = 0
    for m in norms:
        c = m.num_features
        values[id(m.weight)] = 0.8 + 0.4 * bn[0, at:at + c]
        values[id(m.bias)] = bn_n[0, at:at + c]
        values[id(m.running_mean)] = bn_n[1, at:at + c]
        values[id(m.running_var)] = 0.5 + bn[1, at:at + c]
        at += c
    state = {}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        v = values.get(id(t))
        state[name] = t.detach().to(device).clone() if v is None else v.reshape(t.shape).float().clone()
    return state
