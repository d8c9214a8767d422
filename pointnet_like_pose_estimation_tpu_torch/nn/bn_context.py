"""The BatchNorm sync context (counterpart of ``nn/bn_context.py`` of the
JAX package; ``parallel.context`` re-exports it beside ``point_sharding``).

While ``bn_sync(group)`` is active, every train-mode ``BatchNormF32``
computes its batch statistics over all the rows of the process group's
ranks (``nn/layers.py``), as flax's ``axis_name`` makes the JAX package's
BatchNorm ``pmean`` them over a mesh axis: the data-parallel step then
normalises as one process would over the global batch.

PyTorch runs eagerly, so the context is read when a BatchNorm is CALLED,
not when a model is traced: wrap the forward (and so the step), not the
model's construction.
"""

from __future__ import annotations

import contextlib

_GROUPS: list = []


@contextlib.contextmanager
def bn_sync(group):
    """Sync train-mode BatchNorm statistics over ``group`` (a
    ``torch.distributed`` process group) inside the block."""
    _GROUPS.append(group)
    try:
        yield
    finally:
        _GROUPS.pop()


def bn_group():
    """The process group of the innermost ``bn_sync``, or None."""
    return _GROUPS[-1] if _GROUPS else None
