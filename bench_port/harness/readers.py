"""What the per-layer readers share. ``readings`` is the dict a driver
hands back: counts and seconds from the window before the profiled span,
the span's profile (``trace.Span.summary``), the kernels' least times on
the span's inputs, and the benchmark's own stage spans. A reader that
finds nothing returns None, and the metric is left out of the line."""

from __future__ import annotations


def idle_share(readings: dict):
    p = readings.get("profile")
    return None if p is None else p["idle_share"]


def roofline(readings: dict, group: str):
    """Percent of a kernel group's device time in the span that its least
    time (``<group>_bound_s``) is; None where the group did not run."""
    p, bound = readings.get("profile"), readings.get(f"{group}_bound_s")
    if p is None or bound is None or not p["groups"].get(group):
        return None
    return 100.0 * bound / p["groups"][group]


def group_ms_per_step(readings: dict, group: str):
    """Device ms a step of the span spent in a kernel group."""
    p, steps = readings.get("profile"), readings.get("steps_in_span")
    if p is None or not steps:
        return None
    return 1e3 * p["groups"].get(group, 0.0) / steps


def mean_ms(readings: dict, stage: str):
    """Mean host ms a frame of one of the benchmark's stage spans."""
    spans = readings.get("stage_ms", {}).get(stage)
    return sum(spans) / len(spans) if spans else None
