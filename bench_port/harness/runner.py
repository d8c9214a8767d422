"""One run of one cell: find the cell's files by name, run its kind's
driver, check the answers, read the per-layer metrics, and print the
result.

Everything a cell is made of is found by the names in ``BENCHMARK.json``:

- ``workloads/<cell>.json``: its configuration, traffic, chips, why and
  the limits of its comparison with the reference;
- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the mix, whose ``kind`` names the driver,
  ``kinds/<kind>.py``;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(readings)``,
  which returns None where it finds nothing to read; a metric named
  ``<base>.<group>`` with no file of its own takes ``metrics/<base>.py``.

A later cell, mix, configuration or metric is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "pointnet_like_pose_estimation_tpu")


def process_age() -> float:
    """Seconds since this process started (``/proc``, clock-tick resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN})


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: requests attempted and failed, end-to-end
    values by metric name, the readings the per-layer readers take, the
    numbers compared (name, value, limit), the peak and the profile."""

    attempted: int
    failed: int
    e2e: dict
    readings: dict
    checks: list
    memory_peak_bytes: int
    profile: dict | None = None


@dataclasses.dataclass
class Run:
    """A cell's files and the run's arguments. ``overrides`` replaces
    entries of the mix (tests run a cell at a size a CPU holds).
    ``program_dtype``, where set, runs the program in that precision
    while the reference keeps the configuration's: the control."""

    name: str
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    overrides: dict = dataclasses.field(default_factory=dict)
    program_dtype: str | None = None

    def __post_init__(self):
        self.bench = _json(BENCH.parent / "BENCHMARK.json")
        self.cell = _json(BENCH / "workloads" / f"{self.name}.json")
        # a cell defined in files and not yet entered in BENCHMARK.json runs
        # all the same (it then reports setup_s alone); an entered one agrees
        for entry in (w for w in self.bench["workloads"] if w["name"] == self.name):
            for key in ("config", "traffic", "chips"):
                if self.cell[key] != entry[key]:
                    raise ValueError(f"workloads/{self.name}.json: {key} {self.cell[key]!r}, "
                                     f"BENCHMARK.json {entry[key]!r}")
        self.config = _json(BENCH / "configs" / f"{self.cell['config']}.json")
        self.mix = {**_json(BENCH / "traffic" / f"{self.cell['traffic']}.json"), **self.overrides}
        self.limits = self.cell["limits"]
        self.setup_s = None

    def setup_done(self) -> None:
        """Mark the end of set-up: the first timed operation comes next."""
        self.setup_s = process_age()

    def metrics(self, section: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[section] if self.name in m.get("workloads", [self.name])]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi not available"


def read_metric(name: str, readings: dict):
    """The reader ``metrics/<name>.py``, or ``metrics/<base>.py`` for a
    name ``<base>.<group>`` that has no file of its own, applied to
    ``readings``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(readings)


def execute(run: Run) -> Outcome:
    """The cell's driver on ``run``."""
    kind = importlib.import_module(f"kinds.{run.mix['kind']}")
    return kind.run(run)


def result_line(run: Run, out: Outcome, kind_name: str, count: int, card: str) -> dict:
    """The result's JSON object, the numbers compared last (the module
    check is the caller's: a run that fails it prints no result)."""
    correct = out.failed == 0 and all(v <= lim for _, v, lim in out.checks)
    metrics = {}
    if run.trace:
        for m in run.metrics("per_layer"):
            value = read_metric(m["name"], out.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out.e2e, "setup_s": run.setup_s}
        for m in run.metrics("end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind_name, "count": count, "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": device}
    if run.trace and out.profile is not None:
        device["busy_s"] = out.profile["busy_s"]
        device["window_s"] = out.profile["window_s"]
        line["breakdown"] = {"device_ops": out.profile["device_ops"], "idle_gaps": out.profile["idle_gaps"]}
    line["card"] = card
    line["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in out.checks}
    return line


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    run = Run(args.workload, args.seed, args.seconds, bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < run.cell["chips"]:
        print(f"bench_port: needs {run.cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    card = card_line()
    out = execute(run)
    found = forbidden_modules()
    if found:
        print(f"bench_port: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    line = result_line(run, out, torch.cuda.get_device_name(0), run.cell["chips"], card)
    print(f"bench_port: {run.name} seed {run.seed} on {card}; setup_s {run.setup_s}", file=sys.stderr)
    for n, v, lim in out.checks:
        print(f"compared {n} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=True), flush=True)
    return 0


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank (a failure counts as infinite)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)] if v else math.inf


def clock() -> float:
    return time.perf_counter()


def host_cpu() -> dict:
    """What the host gives this process: the cores it sees and may run on,
    and the cgroup's CPU quota and throttling counters where it has them."""
    out = {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0))}
    for path in ("/sys/fs/cgroup/cpu.max", "/sys/fs/cgroup/cpu/cpu.cfs_quota_us"):
        if os.path.exists(path):
            out["quota"] = Path(path).read_text().strip()
            break
    for path in ("/sys/fs/cgroup/cpu.stat", "/sys/fs/cgroup/cpu/cpu.stat"):
        if os.path.exists(path):
            for line in Path(path).read_text().splitlines():
                key, _, value = line.partition(" ")
                if key in ("nr_periods", "nr_throttled", "throttled_usec", "throttled_time"):
                    out[key] = int(value)
            break
    return out


class Stalls:
    """The window's garbage collections, timed (``gc.callbacks``), and the
    host's throttling over it: printed beside the slowest answers."""

    def __init__(self):
        self.collections, self._t = [], None

    def _callback(self, phase, info):
        if phase == "start":
            self._t = clock()
        elif self._t is not None:
            self.collections.append((info["generation"], 1e3 * (clock() - self._t)))

    def __enter__(self):
        import gc

        self.cpu0 = host_cpu()
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._callback)
        self.cpu1 = host_cpu()

    def report(self, what: str, lat: list[float], detail=lambda i: "") -> str:
        """The ten slowest of ``lat`` (ms) with ``detail(i)``, the
        collections by generation, and the throttling counters' growth."""
        slow = sorted(range(len(lat)), key=lambda i: -lat[i])[:10]
        gens = {}
        for g, ms in self.collections:
            n, total, top = gens.get(g, (0, 0.0, 0.0))
            gens[g] = (n + 1, total + ms, max(top, ms))
        grown = {k: self.cpu1[k] - self.cpu0[k] for k in self.cpu1
                 if k in self.cpu0 and isinstance(self.cpu1[k], int) and k not in ("cpu_count", "affinity")}
        return (f"{what}: slowest " + ", ".join(f"#{i} {lat[i]:.1f} ms{detail(i)}" for i in slow)
                + "; gc " + (", ".join(f"gen{g} {n}x {t:.1f} ms (max {m:.1f})" for g, (n, t, m) in sorted(gens.items()))
                             or "none")
                + f"; host {self.cpu0.get('cpu_count')} cores, {self.cpu0.get('affinity')} usable, quota "
                + f"{self.cpu0.get('quota', 'none')}, over the window {grown or 'no cgroup counters'}")
