"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device, owner: str) -> torch.device:
    """``device`` for the entry point ``owner``: ``cuda`` (or ``cuda:i``)
    raises where there is no such card, and any device but ``cuda`` and
    ``cpu`` raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{owner}: no CUDA device; pass device='cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{owner}: no device {dev}; {torch.cuda.device_count()} visible")
        # float32 means float32: TF32 would round the MLPs' inputs to 10 bits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # bfloat16 products accumulate in float32, as XLA's do
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"{owner}: unsupported device {dev}")
    return dev
