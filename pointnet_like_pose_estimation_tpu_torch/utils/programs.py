"""Compiled programs of fixed shapes: the port's counterpart of ``jax.jit``
in the JAX package's serving path (``pipeline/infer.py`` ``_infer_fn`` and
``_scene_infer_fn``, ``models/fast_infer.py``'s executors).

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

The kernel wrappers count launches where they launch (``fps.launches``,
``ball_query_multi.launches``, ``fused_sa_infer.launches``). A capture
launches nothing, so the cache takes back what the capture added, records
it with the graph (``launches(key)``) and adds it again at every replay:
the counts stay launches that ran on the card. The warm-up's launches ran,
and stay counted.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import torch

from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
from pointnet_like_pose_estimation_tpu_torch.kernels.fused_sa import fused_sa_infer

# the launch counters of the kernel wrappers, by kernel name
COUNTED = {"fps": fps, "ball_query": ball_query_multi, "fused_sa": fused_sa_infer}
# the programs a cache keeps before it evicts the least recently used
MAX_PROGRAMS = 32


def _launch_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}


@dataclasses.dataclass
class _Program:
    """One function at one bucket: its static inputs and, on a card, its
    graph, its static outputs and the launches its capture recorded."""

    fn: Callable
    inputs: tuple[torch.Tensor, ...]
    graph: Any = None
    outputs: Any = None
    launches: dict[str, int] = dataclasses.field(default_factory=dict)


class ProgramCache:
    """Programs of one device, keyed by bucket; see the module docstring.

    Counters: ``captures`` (programs made, each a capture on a card),
    ``replays`` (calls served), ``evictions``, ``capture_seconds`` (host
    time of the warm-ups and captures) and, per key, ``launches(key)``."""

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

    def keys(self) -> list:
        """The keys held, least recently used first."""
        return list(self._programs)

    def launches(self, key) -> dict[str, int]:
        """Kernel launches, by kernel name, that one replay of ``key`` makes."""
        return dict(self._programs[key].launches)

    def __call__(self, key, fn: Callable, inputs):
        inputs = tuple(inputs)
        with torch.inference_mode():
            prog = self._programs.get(key)
            if prog is None:
                prog = self._capture(fn, inputs)
                self._programs[key] = prog
                if len(self._programs) > MAX_PROGRAMS:
                    self._programs.popitem(last=False)
                    self.evictions += 1
            else:
                self._programs.move_to_end(key)
                self._load(key, prog, inputs)
            return self._replay(prog)

    @staticmethod
    def _load(key, prog: _Program, inputs: tuple) -> None:
        if len(inputs) != len(prog.inputs):
            raise ValueError(f"ProgramCache {key}: {len(inputs)} inputs, the program takes {len(prog.inputs)}")
        for static, new in zip(prog.inputs, inputs):
            if new.shape != static.shape or new.dtype != static.dtype:
                raise ValueError(f"ProgramCache {key}: input {new.dtype} {tuple(new.shape)}, the program "
                                 f"takes {static.dtype} {tuple(static.shape)}")
            static.copy_(new)

    def _capture(self, fn: Callable, inputs: tuple) -> _Program:
        t0 = time.perf_counter()
        # the cache's own copies: a caller's tensor on the device is not aliased
        static = tuple(x.to(self.device, copy=True) for x in inputs)
        prog = _Program(fn, static)
        if self.device.type == "cuda":
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                fn(*static)
            current.wait_stream(side)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            before = _launch_counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    prog.outputs = fn(*static)
            finally:
                for name, count in _launch_counts().items():
                    prog.launches[name] = count - before[name]
                    COUNTED[name].launches = before[name]
            prog.graph = graph
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return prog

    def _replay(self, prog: _Program):
        self.replays += 1
        if prog.graph is None:
            return prog.fn(*prog.inputs)
        prog.graph.replay()
        for name, count in prog.launches.items():
            COUNTED[name].launches += count
        return prog.outputs
