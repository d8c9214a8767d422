"""Timing and tracing (counterpart of ``utils/profiling.py`` of the JAX
package).

PyTorch returns from a call on the card before the card has done the work,
so a host clock around calls measures their enqueue unless it ends at a
barrier. The barrier here is ``torch.cuda.synchronize`` where the work is on
a card; on the CPU the work is done when the call returns, and there is
none. ``trace`` records a block with ``torch.profiler``. The JAX package's
``enable_compile_cache`` and ``respect_platform_env`` configure JAX's
compilation cache and platform and have no counterpart: the port compiles
nothing at run time but its CUDA kernels, which ``kernels/_build.py`` caches
by content.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import torch


def _barrier(out) -> None:
    """Wait for the card where ``out`` holds a tensor on one."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block with ``torch.profiler`` (the CPU, and the card where
    there is one) and write its timeline to ``<log_dir>/trace.json`` (open
    it in Perfetto or chrome://tracing). Yields the profiler, whose
    ``key_averages()`` give the time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sustained_time(fn, *args, min_seconds: float = 2.0, max_iters: int = 1 << 20) -> float:
    """Seconds per call of ``fn(*args)`` under sustained load: the count of
    calls grows until one timed span, ended by the barrier on the last
    call's output, covers ``min_seconds`` of wall clock. Calls queued on
    the card are then a small share of the span, whatever its queue depth."""
    out = fn(*args)
    _barrier(out)
    iters = 4
    while True:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _barrier(out)
        t = time.perf_counter() - t0
        if t >= min_seconds or iters >= max_iters:
            if t < min_seconds:
                warnings.warn(
                    f"sustained_time hit max_iters={max_iters} with only {t:.3f}s of span "
                    f"(< min_seconds={min_seconds}); the result may still be dispatch-bound",
                    stacklevel=2)
            return t / iters
        # scale straight to the target span (at least doubling)
        iters = min(max_iters, max(iters * 2, int(iters * min_seconds / max(t, 1e-9)) + 1))


def sustained_step_time(step, model, optimizer, batch, gen: torch.Generator | None = None, *,
                        min_seconds: float = 2.0, max_iters: int = 1 << 20) -> float:
    """``sustained_time`` for a train step of ``train.steps.make_train_step``,
    ``step(model, optimizer, batch, gen) -> {"loss", "metric"}``, with the
    same protocol: the barrier is the last step's loss read to the host.

    Unlike the JAX package's, which threads a donated state through the
    loop and returns ``(seconds, state)``, the port's step updates
    ``model`` and ``optimizer`` in place, so this returns the seconds per
    step alone, and leaves the model and optimizer after every step it ran.
    """
    step(model, optimizer, batch, gen)["loss"].item()
    iters = 8
    while True:
        t0 = time.perf_counter()
        for _ in range(iters):
            m = step(model, optimizer, batch, gen)
        m["loss"].item()
        t = time.perf_counter() - t0
        if t >= min_seconds or iters >= max_iters:
            if t < min_seconds:
                warnings.warn(
                    f"sustained_step_time hit max_iters={max_iters} with only {t:.3f}s of span "
                    f"(< min_seconds={min_seconds})", stacklevel=2)
            return t / iters
        iters = min(max_iters, max(iters * 2, int(iters * min_seconds / max(t, 1e-9)) + 1))


class StepTimer:
    """Wall-clock times of steps: ``start()``, then ``stop(block)``, where
    ``block`` is an output of the step to wait for (timing without the wait
    measures the enqueue, not the work)."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, block=None):
        if block is not None:
            _barrier(block)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.times else 0.0
