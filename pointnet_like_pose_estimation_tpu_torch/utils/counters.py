"""The port's counters: what its kernels and groupings did, each counted
where it is done.

A counter is an int attribute of the function that counts, registered under
a name once, beside that function:

    @counted("fps")
    def fps(points, num_samples, start_idx=0):
        ...
        fps.launches += 1

    @counted("grouped_bytes", attr="bytes")
    def count_grouped(grouped): ...

``read()`` gives every registered count by name. ``utils/programs.py``
keeps its programs' counts through this module alone: a capture runs
nothing on the card, so the cache takes back what it counted
(``take_back``), records it with the graph and adds it again at every
replay (``add``). A counted kernel therefore needs nothing but its own
module. This module imports nothing of the port: the kernels, the ops and
the programs all sit above it.
"""

from __future__ import annotations

from typing import Callable

# name -> (the function that counts, its attribute)
_REGISTRY: dict[str, tuple[Callable, str]] = {}


def counted(name: str, attr: str = "launches") -> Callable[[Callable], Callable]:
    """Register ``<fn>.<attr>``, set to 0, as the counter ``name``; returns
    ``fn`` itself."""

    def register(fn: Callable) -> Callable:
        setattr(fn, attr, 0)
        _REGISTRY[name] = (fn, attr)
        return fn

    return register


def read() -> dict[str, int]:
    """Every registered count, by name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _REGISTRY.items()}


def add(counts: dict[str, int]) -> None:
    """Add ``counts`` (by name) to the registered counters."""
    for name, n in counts.items():
        fn, attr = _REGISTRY[name]
        setattr(fn, attr, getattr(fn, attr) + n)


def take_back(before: dict[str, int]) -> dict[str, int]:
    """Set every counter back to ``before`` (a ``read()``; 0 for a counter
    registered since) and return what the counters that moved counted in
    between, by name."""
    moved = {name: n - before.get(name, 0) for name, n in read().items() if n != before.get(name, 0)}
    add({name: -n for name, n in moved.items()})
    return moved
