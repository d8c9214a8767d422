"""Timing and tracing (counterpart of ``utils/profiling.py`` of the JAX
package).

PyTorch returns from a call on the card before the card has done the work,
so a host clock around calls measures their enqueue unless it ends at a
barrier. The barrier here is ``torch.cuda.synchronize`` where the work is on
a card; on the CPU the work is done when the call returns, and there is
none. ``trace`` records a block with ``torch.profiler``; ``span`` marks a
stage of the port's request and train-step paths in what a profiler
records, and ``idle_by_span`` splits a profile's device idle by them. The
JAX package's ``enable_compile_cache`` and ``respect_platform_env``
configure JAX's compilation cache and platform and have no counterpart:
the port compiles nothing at run time but its CUDA kernels, which
``kernels/_build.py`` caches by content.
"""

from __future__ import annotations

import collections
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
    it in Perfetto or chrome://tracing), the port's spans (``SPANS``)
    among its ranges. Yields the profiler, whose ``key_averages()`` give the
    time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# every span the port records: a request's (``pipeline/infer.py`` ``infer_clusters``:
# the padding into its bucket and the copy into the program's input, then the
# copy of the outputs back), a program's replay (``utils/programs.py``, under a
# request or a train step) and a train step's (``train/steps.py`` ``EpochRunner``:
# the step, and its draws before the replay)
SPANS = ("serve.upload", "program.replay", "serve.copy_back", "train.step", "train.draws")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the stage ``name`` (one of ``SPANS``)
    in what a ``torch.profiler`` records, on the profiler's host clock, the
    clock its kernel and copy records are put on. While no profiler
    records, a span is one shared context manager that does nothing: it
    costs a check of a flag.

    A span is a host range of the kind torch's own operators record
    (``_RecordFunctionFast``), not a ``record_function`` annotation: it
    costs about a tenth as much, and leaves no annotation on the device's
    timeline, where a reader of the timeline would count it as work. Spans
    open at the boundaries of the request and step paths and never inside a
    function a program captures, which a replay would not run."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def idle_by_span(events, window=None) -> dict:
    """The card's idle time in a profile, split by the port's spans.

    ``events`` are a profile's ``events()``; ``window`` is ``(start, end)``
    in their microseconds, by default the first port span's start to the
    last one's end. Returns, by span name: ``count`` (the spans that start
    in the window), ``host_s`` (their host seconds, clipped to it),
    ``least_s`` (the shortest) and ``idle_s``, the seconds in which the card
    ran nothing while that span was the innermost port span open on the
    host; under None, the idle while no port span was open. The ``idle_s``
    sum to the window's idle. The card's work is every device record but
    the device-side annotations of the profile's ``record_function``
    ranges, which cover the kernels a range launched and are no work of
    their own."""
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    ranges = {e.name for e in host if e.is_user_annotation}
    marks = sorted((e.time_range.start, e.time_range.end, e.name) for e in host if e.name in SPANS)
    if window is None and not marks:
        return {}
    lo, hi = window or (marks[0][0], max(m[1] for m in marks))
    out = collections.defaultdict(lambda: {"count": 0, "host_s": 0.0, "least_s": float("inf"), "idle_s": 0.0})
    for s, t, name in marks:
        if lo <= s < hi:
            out[name]["count"] += 1
            out[name]["host_s"] += (min(t, hi) - s) / 1e6
            out[name]["least_s"] = min(out[name]["least_s"], (t - s) / 1e6)
    busy = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in events
                  if e.device_type == cuda and e.name not in ranges)
    idle, at = [], lo
    for s, t in busy:
        if t > s:
            if s > at:
                idle.append((at, s))
            at = max(at, t)
    if at < hi:
        idle.append((at, hi))
    # pieces of the window in which the same spans are open, each given to the
    # innermost: the latest started, the shortest of those
    cuts = sorted({lo, hi, *(x for m in marks for x in m[:2] if lo < x < hi)})
    i = j = 0
    open_ = []
    for a, b in zip(cuts, cuts[1:]):
        while j < len(marks) and marks[j][0] <= a:
            open_.append(marks[j])
            j += 1
        open_ = [m for m in open_ if m[1] > a]      # every span's end is a cut: these cover [a, b]
        inner = max(open_, key=lambda m: (m[0], -m[1]), default=None)
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        k = i
        while k < len(idle) and idle[k][0] < b:
            out[inner and inner[2]]["idle_s"] += (min(b, idle[k][1]) - max(a, idle[k][0])) / 1e6
            k += 1
    return dict(out)


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
