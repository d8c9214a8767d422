"""Raw frames of one camera through ``GraspPipeline.__call__``, served one
after another as ``stream`` serves them, arriving on the camera's own
clock: an open loop at ``mix["rate"]`` frames/s.

A frame's latency runs from its due time on the camera's schedule until
``__call__`` returns, so a frame that waits behind a slow one counts its
wait. Set-up serves frames of the same scenes drawn apart from the
window's (``traffic.camera``): first the whole frame of each scene, which
grows the scene program's cloud buffer (``GraspPipeline.scene_points``,
part of every scene bucket's key) to the size the window needs, then
frames that lose shares of points spread over the mix's range. A frame's
bucket turns on its cluster sizes, which only DBSCAN finds, so these
capture most buckets the window uses; what the window captures all the
same, as a camera would meet it, ``captures.frames`` counts. The
traced run wraps the preprocessing functions that
``__call__`` calls (``preprocess.clip_distance``, ``clean_scene``,
``dbscan``) in spans of the benchmark's own, synchronizing after the
device's clean; untraced runs leave them alone. After the window, a sample
of the window's frames drawn from the seed is held against the reference.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from harness import bounds, grasp, traffic
from harness.runner import Outcome, Stalls, clock, p95
from harness.trace import Span
from reference.pipeline import frame_clusters

STAGES = {"clip_distance": ("clean", False), "clean_scene": ("clean", True), "dbscan": ("dbscan", False)}


class StageSpans:
    """The benchmark's spans around the preprocessing functions that
    ``__call__`` calls, installed on the module for the window and taken
    off after: host ms a frame by stage."""

    def __init__(self, device):
        from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess

        self.module, self.device = preprocess, device
        self.saved = {name: getattr(preprocess, name) for name in STAGES}
        self.frame = {"clean": 0.0, "dbscan": 0.0}
        self.ms = {"clean": [], "dbscan": []}

    def _wrap(self, name):
        fn, (stage, sync) = self.saved[name], STAGES[name]

        def timed(*args, **kwargs):
            t = clock()
            with record_function(f"bench:{name}"):
                out = fn(*args, **kwargs)
                if sync and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self.frame[stage] += 1e3 * (clock() - t)
            return out

        return timed

    def __enter__(self):
        for name in STAGES:
            setattr(self.module, name, self._wrap(name))
        return self

    def end_frame(self) -> None:
        for stage, ms in self.frame.items():
            self.ms[stage].append(ms)
            self.frame[stage] = 0.0

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def _captures(pipe) -> int:
    from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess

    held = getattr(preprocess, "_TRUNCATION_PROGRAMS", {})
    return pipe.programs.captures + sum(c.captures for c in held.values())


def _wait_until(t: float) -> None:
    ahead = t - clock()
    if ahead > 2e-3:
        time.sleep(ahead - 1e-3)
    while clock() < t:
        pass


def judge(cfg: dict, weights: dict, frames: list, outs: list, sample, device) -> dict:
    """The reference's clusters and grasps of the sampled frames against
    the served ones: ``frame_mismatch`` counts the frames whose clusters
    (found or not, their count, every point) differ; the gaps are
    ``grasp.gaps`` over the clusters of the others."""
    ref = grasp.reference(cfg, weights, device)
    mismatch, rows = 0, []
    for j in sample:
        want = frame_clusters(frames[j], cfg["pipeline"], device)
        got = outs[j]
        if (want is None) != (got is None):
            mismatch += 1
            continue
        if want is None:
            continue
        clusters, xyz = want
        if got["clusters"].shape != clusters.shape or not np.array_equal(got["clusters"], clusters):
            mismatch += 1
            continue
        rows.append(grasp.gaps(ref, xyz, got))
    return {"frame_mismatch": mismatch, **grasp.worst(rows)}


def run(run) -> Outcome:
    cfg, mix, device = run.config, run.mix, torch.device(run.device)
    if cfg["pipeline"]["outlier_method"] != "radius":
        raise ValueError("the camera cell's reference cleans by the radius test only")
    weights = grasp.states(cfg, run.seed, device)
    pipe = grasp.port_pipeline(cfg, weights, device, run.program_dtype)
    rate = mix["rate"]
    frames, scene_of, warm = traffic.camera(mix, run.seed, run.seconds, rate)
    for frame in warm:
        pipe(frame)
    print(f"camera: set-up served {len(warm)} frames and captured {_captures(pipe)} programs", file=sys.stderr)
    del warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    span = Span(device) if run.trace else None
    run.setup_done()

    stages = StageSpans(device) if run.trace else None
    lat, outs, late, service, failed = [], [], [], [], 0
    captures0 = _captures(pipe)
    captured_at = []
    pre = None
    stalls = Stalls().__enter__()
    t0 = clock()
    span_at = run.seconds - mix["profile_seconds"]
    if stages is not None:
        stages.__enter__()
    try:
        for i, frame in enumerate(frames):
            due = t0 + i / rate
            if span is not None and pre is None and i / rate >= span_at:
                _wait_until(due)
                pre = {"seconds": clock() - t0, "frames": i, "captures": _captures(pipe) - captures0,
                       "clusters": sum(len(o["pred_class"]) for o in outs if o is not None)}
                span.start()
            _wait_until(due)
            start = clock()
            late.append(1e3 * (start - due))
            made = _captures(pipe)
            try:
                out = pipe(frame)
            except Exception as exc:  # a failed frame counts as missing; the run goes on
                print(f"frame {i} failed: {exc!r}", file=sys.stderr, flush=True)
                failed += 1
                out = None
                lat.append(math.inf)
            else:
                lat.append(1e3 * (clock() - due))
            service.append(1e3 * (clock() - start))
            if _captures(pipe) > made:
                captured_at.append(i)
            outs.append(out)
            if stages is not None:
                stages.end_frame()
    finally:
        if stages is not None:
            stages.__exit__(None, None, None)
        stalls.__exit__(None, None, None)
    profile = None
    if pre is not None:
        span.stop()
        profile = span.summary()
    print(f"camera: {len(frames)} frames at {rate}/s; handed late by median {np.median(late):.3f} ms, "
          f"p95 {np.percentile(late, 95):.3f} ms, max {max(late):.3f} ms; the last quarter's median "
          f"{np.median(late[3 * len(late) // 4:]):.3f} ms", file=sys.stderr)
    print(f"camera: the window captured {len(captured_at)} programs, at frames {captured_at}; service median "
          f"{np.median(service):.2f} ms", file=sys.stderr)
    clusters = [0 if o is None else len(o["pred_class"]) for o in outs]
    print(stalls.report("camera", lat, lambda i: f" (scene {scene_of[i]}, {clusters[i]} clusters, "
                        f"served in {service[i]:.1f})"), file=sys.stderr)
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    served = sum(o is not None for o in outs)
    del pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = {"kind": "frames", "late_ms": late}
    if pre is not None:
        flops = pre["clusters"] * bounds.grasp_flops_per_cluster(cfg["pipeline"]["num_points"])
        peak_flops = bounds.matmul_peak(cfg["pipeline"]["dtype"], torch.backends.cuda.matmul.allow_tf32)
        readings.update(captures=pre["captures"], mfu=bounds.mfu(flops, pre["seconds"], peak_flops),
                        profile=profile, stage_ms=stages.ms)
    rng = np.random.default_rng([run.seed % 2**63, 7])
    sample = rng.choice(len(frames), min(mix["check"], len(frames)), replace=False)
    gaps = judge(cfg, weights, frames, outs, sample, device)
    checks = [(g, gaps[g], run.limits[g]) for g in ("frame_mismatch", *grasp.GAPS)]
    print(f"camera: {served} of {len(frames)} frames served with clusters", file=sys.stderr)
    return Outcome(attempted=len(frames), failed=failed, e2e={"frame_p95_ms": p95(lat)}, readings=readings,
                   checks=checks, memory_peak_bytes=int(peak), profile=profile)

