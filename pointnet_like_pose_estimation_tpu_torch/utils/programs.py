"""Compiled programs of fixed shapes: the port's counterpart of ``jax.jit``
in the JAX package's serving path (``pipeline/infer.py`` ``_infer_fn`` and
``_scene_infer_fn``, ``models/fast_infer.py``'s executors; ``ProgramCache``)
and its training path (``train/steps.py`` ``make_train_step`` and
``make_device_epoch_runner``, ``make_device_eval_runner``;
``StepProgramCache``, whose every call runs its function once, below).

JAX traces a function once per shape bucket and dispatches the compiled
program on every later call. Here a function of tensors is captured once
per bucket as a ``torch.cuda.CUDAGraph`` and replayed:

    programs = ProgramCache(device)
    out = programs(key, fn, inputs)       # fn(*inputs) -> tensors (a dict or tuple of them)

``key`` names the function and the bucket; it must fix every input's
shape and dtype and every argument bound into ``fn``. The first call of a
key copies the inputs into static tensors the cache owns, runs ``fn`` once
on a side stream (which builds the kernels' libraries with nvcc and sets
their attributes, neither of which may happen during a capture), captures
``fn`` on those static tensors into a graph on the cache's memory pool
(``pool``, a ``torch.cuda.graph_pool_handle()`` shared by all of its
graphs), and replays it. Every later call of that key copies its inputs
into the static tensors, replays, and hands back the static outputs
themselves: the next call of the key overwrites them, so a caller reads
them (to the host) before that or clones them. At most ``MAX_PROGRAMS``
graphs are kept; the least recently used one goes first. The graphs share
one pool, so they must never run at once: the cache serves one caller on
one stream.

A failed capture or replay raises: there is no eager fallback. On the CPU
a program is ``fn`` itself, called on the static inputs at every replay;
the keys, the eviction and the counters work as on the card.

The kernels and the groupings count what they do (``utils/counters.py``:
kernel launches under the kernels' names, the grouped tensors' bytes under
``grouped_bytes``). A capture runs nothing, so the cache takes back what
every registered counter counted during it, records the counters that
moved with the graph (``counts(key)``) and adds them again at every
replay: the counts stay what ran on the card. The warm-up ran, and stays
counted.

``ProgramCache.load`` and ``replay`` are a call in two parts, for a caller
that marks the copy in as a stage of its own; a replay is the span
``program.replay`` (``utils/profiling.py`` ``span``).
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import Any, Callable

import torch

from pointnet_like_pose_estimation_tpu_torch.utils import counters
from pointnet_like_pose_estimation_tpu_torch.utils.profiling import span

# the programs a cache keeps before it evicts the least recently used
MAX_PROGRAMS = 32


@dataclasses.dataclass
class _Program:
    """One function at one bucket: its static inputs and, on a card, its
    graph, its static outputs and what its capture counted. A step
    program also keeps the tensors it is bound to (``held``) and their
    addresses."""

    fn: Callable
    inputs: tuple[torch.Tensor, ...]
    graph: Any = None
    outputs: Any = None
    counts: dict[str, int] = dataclasses.field(default_factory=dict)
    held: list = dataclasses.field(default_factory=list)
    addresses: tuple = ()


def program_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card, so that a
    cache kept by device is found under ``cuda`` and ``cuda:0`` alike."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _addresses(tensors) -> tuple:
    return tuple(0 if t is None else t.data_ptr() for t in tensors)


class _Cache:
    """What both caches share: the programs by key (least recently used
    first), the pool, the counters, the input copies and the capture."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._programs: collections.OrderedDict[Any, _Program] = collections.OrderedDict()
        self.pool = None                # the graphs' memory pool, made at the first capture
        self.captures = 0
        self.replays = 0
        self.evictions = 0
        self.capture_seconds = 0.0

    def __len__(self) -> int:
        return len(self._programs)

    def __reduce__(self):
        # a copy of a cache (``copy.deepcopy`` of a model that owns one) is
        # an empty cache: graphs are bound to the original's tensors
        return type(self), (self.device,)

    def keys(self) -> list:
        """The keys held, least recently used first."""
        return list(self._programs)

    def counts(self, key) -> dict[str, int]:
        """What one replay of ``key`` counts, by counter name: the counters
        its capture moved, the others staying put ({} on the CPU, where
        every call runs the function, which counts as it runs)."""
        return dict(self._programs[key].counts)

    def _store(self, key, prog: _Program) -> None:
        self._programs[key] = prog
        if len(self._programs) > MAX_PROGRAMS:
            self._programs.popitem(last=False)
            self.evictions += 1

    def _load(self, key, prog: _Program, inputs: tuple) -> None:
        what = f"{type(self).__name__} {key}"
        if len(inputs) != len(prog.inputs):
            raise ValueError(f"{what}: {len(inputs)} inputs, the program takes {len(prog.inputs)}")
        for static, new in zip(prog.inputs, inputs):
            if new.shape != static.shape or new.dtype != static.dtype:
                raise ValueError(f"{what}: input {new.dtype} {tuple(new.shape)}, the program "
                                 f"takes {static.dtype} {tuple(static.shape)}")
            static.copy_(new)

    def _static(self, fn: Callable, inputs: tuple) -> _Program:
        # the cache's own copies: a caller's tensor on the device is not aliased
        return _Program(fn, tuple(x.to(self.device, copy=True) for x in inputs))

    def _warm_up(self, prog: _Program):
        """``fn`` once on a side stream, which builds the kernels' libraries
        and sets their attributes (neither may happen during a capture)."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = prog.fn(*prog.inputs)
        current.wait_stream(side)
        return out

    def _capture(self, prog: _Program) -> None:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = counters.read()
        graph = torch.cuda.CUDAGraph()
        # no collection while capturing: a graph the collector frees then (one
        # held in a reference cycle, as a program's function and its owner
        # make) resets itself, which a capture refuses, and the capture ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                prog.outputs = prog.fn(*prog.inputs)
        finally:
            if collecting:
                gc.enable()
            prog.counts = counters.take_back(before)
        prog.graph = graph

    def _replay(self, prog: _Program):
        self.replays += 1
        with span("program.replay"):
            if prog.graph is None:
                return prog.fn(*prog.inputs)
            prog.graph.replay()
        counters.add(prog.counts)
        return prog.outputs


class ProgramCache(_Cache):
    """Programs of one device, keyed by bucket; see the module docstring.

    Counters: ``captures`` (programs made, each a capture on a card),
    ``replays`` (calls served), ``evictions``, ``capture_seconds`` (host
    time of the warm-ups and captures) and, per key, ``counts(key)``."""

    def __call__(self, key, fn: Callable, inputs):
        return self.replay(self.load(key, fn, inputs))

    def load(self, key, fn: Callable, inputs) -> _Program:
        """The program of ``key`` with ``inputs`` copied into its static
        tensors, made (warm-up and capture) at the key's first call."""
        inputs = tuple(inputs)
        with torch.inference_mode():
            prog = self._programs.get(key)
            if prog is None:
                prog = self._make(fn, inputs)
                self._store(key, prog)
            else:
                self._programs.move_to_end(key)
                self._load(key, prog, inputs)
            return prog

    def replay(self, prog: _Program):
        """Run a program that ``load`` handed back: its outputs."""
        with torch.inference_mode():
            return self._replay(prog)

    def _make(self, fn: Callable, inputs: tuple) -> _Program:
        t0 = time.perf_counter()
        prog = self._static(fn, inputs)
        if self.device.type == "cuda":
            self._warm_up(prog)
            self._capture(prog)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return prog


class StepProgramCache(_Cache):
    """Programs whose every call runs their function exactly once: a train
    step, which a second run would apply twice, and one batch of an eval
    pass, whose sums a second run would count twice.

        programs = StepProgramCache(device)
        out = programs(key, fn, inputs, bound)

    ``fn(*inputs)`` runs with autograd as the caller has it, so a train
    step's backward and optimizer step are captured with its forward.
    ``bound()`` lists the tensors ``fn`` reads or writes besides its inputs
    (parameters, gradients, buffers, optimizer state, a resident split; None
    for a gradient not yet made): the graph is bound to them.

    The first call of a key copies the inputs into static tensors and runs
    ``fn`` on them once on a side stream: that run is the call's own, and
    its outputs are handed back as they are. ``fn`` is then captured on the
    static tensors into a graph on the cache's pool, and every later call
    copies its inputs in and replays it, handing back the static outputs,
    which the next call of the key overwrites. A later call whose
    ``bound()`` tensors are no longer the ones the graph was captured on (a
    parameter replaced, a gradient set to None, optimizer state loaded
    anew) makes its program anew, as a first call: no graph runs over
    tensors that were replaced. A program keeps a reference to every bound
    tensor, so that their memory goes to no other tensor while its graph
    may write there.

    A failed capture raises; there is no eager fallback. On the CPU a
    program is ``fn``, called on the static inputs at every call. What a
    first call counted ran and stays counted; a capture's counts are taken
    back and added at each replay, as in ``ProgramCache``. Counters as
    there, and ``remade``: programs made anew over replaced tensors."""

    def __init__(self, device):
        super().__init__(device)
        self.remade = 0

    def __call__(self, key, fn: Callable, inputs, bound: Callable[[], Any] = tuple):
        inputs = tuple(inputs)
        prog = self._programs.get(key)
        if prog is not None:
            if _addresses(bound()) == prog.addresses:
                self._programs.move_to_end(key)
                self._load(key, prog, inputs)
                return self._replay(prog)
            del self._programs[key]
            self.remade += 1
        t0 = time.perf_counter()
        prog = self._static(fn, inputs)
        if self.device.type == "cuda":
            out = self._warm_up(prog)
            prog.held = list(bound())
            self._capture(prog)
        else:
            out = fn(*prog.inputs)
            prog.held = list(bound())
        prog.addresses = _addresses(prog.held)
        self._store(key, prog)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return out
