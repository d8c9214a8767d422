"""The traced run's profiled span: ``torch.profiler`` over the end of the
window, reduced to device busy time, kernel time by group, the busiest
device operations and the idle gaps by what the host was doing.

The span is wrapped in a ``record_function`` of its own, whose host
interval is the span's window in the profiler's clock; device intervals
(kernels, copies, sets) are clipped to it and merged, so overlapping work
counts once.
"""

from __future__ import annotations

import bisect
import collections

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from harness.bounds import group

SPAN = "bench:profiled_span"


class Span:
    """``start()`` and ``stop()`` around the profiled part of a window."""

    def __init__(self, device):
        """Made in set-up: the profiler's first start in a process takes
        seconds, which a first profile of one small operation pays here
        rather than in the window."""
        self.device = torch.device(device)
        self.start()
        torch.ones(1, device=self.device).add_(1)
        self.stop()
        self.prof = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self.prof = profile(activities=activities)
        self.prof.start()
        self._rf = record_function(SPAN)
        self._rf.__enter__()

    def stop(self) -> None:
        self._sync()
        self._rf.__exit__(None, None, None)
        self.prof.stop()

    def summary(self) -> dict:
        """``window_s``, ``busy_s``, ``idle_share`` (%), ``groups`` (device
        seconds by kernel group), ``kernels`` (device seconds and launches
        by name), ``device_ops`` and ``idle_gaps`` (the ten largest, in
        seconds)."""
        events = self.prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        win = [e for e in events if e.name == SPAN and e.device_type != cuda]
        lo, hi = win[0].time_range.start, win[0].time_range.end
        dev, host = [], []
        for e in events:
            if e.name.startswith("bench:") and e.device_type == cuda:
                continue                # a span's annotation on the device timeline, no work
            if e.device_type == cuda:
                s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
                if t > s:
                    dev.append((s, t, e.name))
            elif e.name != SPAN:
                host.append((e.time_range.start, e.time_range.end, e.name))
        dev.sort()
        merged = []
        for s, t, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy_us = sum(t - s for s, t in merged)
        kernels = collections.defaultdict(lambda: [0.0, 0])
        for s, t, name in dev:
            kernels[name][0] += (t - s) / 1e6
            kernels[name][1] += 1
        groups = collections.defaultdict(float)
        for name, (sec, _) in kernels.items():
            groups[group(name)] += sec
        gaps = []
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for s, t in zip(edges[0::2], edges[1::2]):
            if t > s:
                gaps.append((s, t))
        idle = collections.defaultdict(float)
        host.sort()
        starts = [h[0] for h in host]
        for s, t in gaps:
            # the innermost host op at the gap's middle: the latest started that spans it
            mid = 0.5 * (s + t)
            label = "host: no recorded op"
            last = bisect.bisect_right(starts, mid) - 1
            for j in range(last, max(-1, last - 4096), -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            idle[label] += (t - s) / 1e6
        window_s = (hi - lo) / 1e6
        return {
            "window_s": window_s,
            "busy_s": busy_us / 1e6,
            "idle_share": 100.0 * (1.0 - busy_us / (hi - lo)),
            "groups": dict(groups),
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "device_ops": [[k[:160], v[0]] for k, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]],
            "idle_gaps": [[k[:160], v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        }
