"""Grasp requests from a closed loop, as ``kinds/clusters.py`` sends them,
on the five models the configuration's ``pipeline`` names (``classifier``,
``rotation``, ``sign``, ``translation``, ``width``; the port's
``PipelineConfig`` defaults where it names none).

The weights come from the seed, one stream a model key as
``harness/grasp.py`` draws them; the reference is ``reference/msg.py``'s
on the same names and weights, and the comparison ``harness/grasp.py``'s.
Beside ``kinds/clusters.py``'s readings this driver reads the bytes of
the grouped tensors a request builds (``ops/grouping.py`` ``count_grouped``
of the port, where the port has it).
"""

from __future__ import annotations

import gc
import math
import sys

import numpy as np
import torch

from harness import bounds, bounds_msg, grasp, traffic
from harness.runner import Outcome, Stalls, clock, p95
from harness.trace import Span
from harness.weights import make_state
from reference import geometry as G
from reference import msg

# (centroids, neighbours a scale, radii) of each grouping level the FPS and
# ball-query calls of a model run, by registry name (the PointNet heads group nothing)
_SSG = tuple((S, (k,), (r,)) for S, k, r, _, _ in bounds.SSG_LEVELS)
_MSG = tuple((S, ks, radii) for S, ks, radii, _ in (msg.SA1, msg.SA2))
LEVELS = {"pointnet2_cls_ssg": _SSG, "pointnet2_cls_msg": _MSG, "rotation_msg": _MSG, "sign_msg": _MSG[:1],
          "translation_msg": _MSG[:1], **{name: () for name in bounds.POSE_OUT}}


def states(config: dict, seed: int, device) -> dict:
    """A ``state_dict`` per model key, each drawn from its own stream of
    ``seed`` (``harness/grasp.py``'s streams)."""
    nc = config["pipeline"]["num_classes"]
    names = msg.model_names(config)
    return {key: make_state(msg.build(names[key], nc), (int(seed) * 8 + i) % 2**63, device)
            for i, key in enumerate(names)}


def port_pipeline(config: dict, weights: dict, device, dtype: str | None = None):
    """The port's ``GraspPipeline`` on the configuration's models and
    ``weights``, in ``dtype`` where it is given (the control)."""
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    cfg = PipelineConfig(**{**config["pipeline"], **({"dtype": dtype} if dtype else {})})
    models = {}
    for key, name in msg.model_names(config).items():
        m = build_model(name, cfg.num_classes)
        m.load_state_dict(weights[key], strict=True)
        models[key] = m
    return GraspPipeline(cfg, models, device)


def grouped_bytes() -> int | None:
    """The port's count of grouped bytes, or None where it keeps none."""
    try:
        from pointnet_like_pose_estimation_tpu_torch.ops.grouping import count_grouped
    except ImportError:
        return None
    return count_grouped.bytes


def _level_bounds(x: torch.Tensor, levels) -> list[tuple[float, float]]:
    """(FPS ms, ball-query ms) least times of each level of a chain on ``x``."""
    out = []
    for S, ks, radii in levels:
        c = G.index_points(x, G.fps(x, S))
        out.append((bounds.fps_bound_ms(x.shape[0], x.shape[1], x.shape[2], S),
                    bounds_msg.ball_query_multi_bound_ms(x, c, radii, ks)))
        x = c
    return out


def _kernel_bounds(pool: np.ndarray, served: list[int], cfg: dict, device) -> dict:
    """Least device seconds of the FPS and ball-query calls that the
    requests ``served`` (pool indices) need: the resampling FPS, the
    classifier's levels on the normalised cloud and each head's on the
    spliced cloud, each on the reference's own points and centroids. The
    heads' cloud carries class 0's one-hot: the place of the one changes no
    distance, whose sums add exact zeros around it."""
    p = cfg["pipeline"]
    n, nc = p["num_points"], p["num_classes"]
    names = msg.model_names(cfg)
    heads = [LEVELS[names[key]] for key in names if key != "classifier"]
    per_request = {}
    for r in sorted(set(served)):
        xyz = torch.from_numpy(pool[r]).to(device)
        K, M, _ = xyz.shape
        f = bounds.fps_bound_ms(K, M, 3, n) if M > n else 0.0
        x = G.normalize_cloud(G.index_points(xyz, G.fps(xyz, n)) if M > n else xyz)
        calls = _level_bounds(x, LEVELS[names["classifier"]])
        deepest = max(heads, key=len)      # the heads of LEVELS: each one's levels a prefix of it
        if deepest:
            onehot = torch.zeros((K, x.shape[1], nc), dtype=x.dtype, device=x.device)
            onehot[..., 0] = 1.0
            chain = _level_bounds(torch.cat([x, onehot], dim=-1), deepest)
            calls += [b for h in heads for b in chain[:len(h)]]
        per_request[r] = ((f + sum(c[0] for c in calls)) / 1e3, sum(c[1] for c in calls) / 1e3)
    return {"fps_bound_s": sum(per_request[r][0] for r in served),
            "ball_query_bound_s": sum(per_request[r][1] for r in served)}


def run(run) -> Outcome:
    cfg, mix, device = run.config, run.mix, torch.device(run.device)
    p, names = cfg["pipeline"], msg.model_names(cfg)
    weights = states(cfg, run.seed, device)
    pipe = port_pipeline(cfg, weights, device, run.program_dtype)
    pool = traffic.cluster_pool(mix, run.seed)
    R = len(pool)
    for i in range(mix["warmup"]):
        pipe.infer_clusters(pool[i % R])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    span = Span(device) if run.trace else None
    run.setup_done()

    lat, outs, failed = [], [], 0
    captures0, grouped0 = pipe.programs.captures, grouped_bytes()
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
            grouped = grouped_bytes()
            pre = {"seconds": now - t0, "requests": i, "captures": pipe.programs.captures - captures0,
                   "grouped_bytes": None if grouped is None else grouped - grouped0}
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
        flops = pre["requests"] * mix["clusters"] * bounds_msg.request_flops_per_cluster(
            names, p["num_points"], p["num_classes"])
        peak_flops = bounds.matmul_peak(p["dtype"], torch.backends.cuda.matmul.allow_tf32)
        readings.update(captures=pre["captures"], mfu=bounds.mfu(flops, pre["seconds"], peak_flops),
                        requests=pre["requests"], grouped_bytes=pre["grouped_bytes"], profile=profile,
                        **_kernel_bounds(pool, [r % R for r in requests_in_span], cfg, device))

    ref = msg.GraspReference(weights, names, p["num_points"], p["num_classes"], p["dtype"], device)
    rng = np.random.default_rng([run.seed % 2**63, 7])
    sample = rng.choice(len(outs), min(mix["check"], len(outs)), replace=False) if outs else []
    rows = [grasp.gaps(ref, torch.from_numpy(pool[j % R]).to(device), outs[j]) for j in sample if outs[j]]
    worst = grasp.worst(rows)
    checks = [(g, worst[g], run.limits[g]) for g in grasp.GAPS]
    return Outcome(attempted=i, failed=failed, e2e={"request_p95_ms": p95(lat)}, readings=readings,
                   checks=checks, memory_peak_bytes=int(peak), profile=profile)
