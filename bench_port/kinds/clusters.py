"""Grasp requests from a closed loop: one client sends a request of K
clusters of M points to ``GraspPipeline.infer_clusters`` as soon as the
previous one returned, cycling through a pool of requests made at set-up.

A request's latency runs from handing the host clusters over until the
grasps are host arrays. Set-up warms the pool's one program bucket. After
the window, a sample of the window's answers drawn from the seed is held
against the reference, with the program freed.
"""

from __future__ import annotations

import gc
import math
import sys

import numpy as np
import torch

from harness import bounds, grasp, traffic
from harness.runner import Outcome, Stalls, clock, p95
from harness.trace import Span
from reference import geometry as G


def _kernel_bounds(pool: np.ndarray, served: list[int], cfg: dict, device) -> dict:
    """Least device seconds of the FPS and ball-query calls that the
    requests ``served`` (pool indices) need: the resampling FPS and SSG's
    two levels, each on the reference's own points and centroids."""
    n = cfg["pipeline"]["num_points"]
    fps_s = bq_s = 0.0
    per_request = {}
    for r in sorted(set(served)):
        xyz = torch.from_numpy(pool[r]).to(device)
        K, M, _ = xyz.shape
        f = bounds.fps_bound_ms(K, M, 3, n) if M > n else 0.0
        x = G.normalize_cloud(G.index_points(xyz, G.fps(xyz, n)) if M > n else xyz)
        b = 0.0
        for S, k, radius, _, _ in bounds.SSG_LEVELS:
            c = G.index_points(x, G.fps(x, S))
            f += bounds.fps_bound_ms(K, x.shape[1], 3, S)
            b += bounds.ball_query_bound_ms(x, c, radius, k)
            x = c
        per_request[r] = (f / 1e3, b / 1e3)
    for r in served:
        fps_s += per_request[r][0]
        bq_s += per_request[r][1]
    return {"fps_bound_s": fps_s, "ball_query_bound_s": bq_s}


def run(run) -> Outcome:
    cfg, mix, device = run.config, run.mix, torch.device(run.device)
    weights = grasp.states(cfg, run.seed, device)
    pipe = grasp.port_pipeline(cfg, weights, device, run.program_dtype)
    pool = traffic.cluster_pool(mix, run.seed)
    R = len(pool)
    for i in range(mix["warmup"]):
        pipe.infer_clusters(pool[i % R])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    span = Span(device) if run.trace else None
    run.setup_done()

    lat, outs, failed = [], [], 0
    captures0 = pipe.programs.captures
    t0 = clock()
    deadline = t0 + run.seconds
    span_at = deadline - mix["profile_seconds"]
    pre = None
    i = 0
    stalls = Stalls().__enter__()
    while True:
        now = clock()
        if now >= deadline:
            break
        if span is not None and pre is None and now >= span_at:
            pre = {"seconds": now - t0, "requests": i, "captures": pipe.programs.captures - captures0}
            span.start()
        x = pool[i % R]
        t1 = clock()
        try:
            out = pipe.infer_clusters(x)
        except Exception as exc:  # a failed request counts as missing; the run goes on
            print(f"request {i} failed: {exc!r}", file=sys.stderr, flush=True)
            failed += 1
            lat.append(math.inf)
            outs.append(None)
        else:
            lat.append(1e3 * (clock() - t1))
            outs.append(out)
        i += 1
    stalls.__exit__(None, None, None)
    print(stalls.report("clusters", lat), file=sys.stderr)
    profile = None
    if pre is not None:
        span.stop()
        profile = span.summary()
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    requests_in_span = range(pre["requests"], i) if pre else range(0)
    del pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = {"kind": "serve"}
    if pre is not None:
        K = mix["clusters"]
        flops = pre["requests"] * K * bounds.grasp_flops_per_cluster(cfg["pipeline"]["num_points"])
        peak_flops = bounds.matmul_peak(cfg["pipeline"]["dtype"], torch.backends.cuda.matmul.allow_tf32)
        readings.update(captures=pre["captures"], mfu=bounds.mfu(flops, pre["seconds"], peak_flops),
                        profile=profile, **_kernel_bounds(pool, [r % R for r in requests_in_span], cfg, device))

    ref = grasp.reference(cfg, weights, device)
    rng = np.random.default_rng([run.seed % 2**63, 7])
    sample = rng.choice(len(outs), min(mix["check"], len(outs)), replace=False) if outs else []
    rows = [grasp.gaps(ref, torch.from_numpy(pool[j % R]).to(device), outs[j]) for j in sample if outs[j]]
    worst = grasp.worst(rows)
    checks = [(g, worst[g], run.limits[g]) for g in grasp.GAPS]
    return Outcome(attempted=i, failed=failed, e2e={"request_p95_ms": p95(lat)}, readings=readings,
                   checks=checks, memory_peak_bytes=int(peak), profile=profile)

