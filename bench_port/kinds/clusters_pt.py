"""Grasp requests from a closed loop, as ``kinds/clusters_models.py`` sends
them, on a configuration whose classifier is Point Transformer
(``point_transformer_cls``) and whose heads are those the configuration
names.

The weights come from the seed as ``kinds/clusters_models.py`` draws them,
the reference is ``reference/point_transformer.py``'s ``GraspReference``
on the same names and weights, and the comparison ``harness/grasp.py``'s.
Beside the readings of ``kinds/clusters_models.py`` (the captures, the
grouped bytes, the FPS calls' least time, ``mfu`` from
``harness/bounds_pt.py``) this module reads the port's count of kNN
launches (``knn``, where the port has it) over the window's requests, the
kNN queries' least time, and the kNN kernels' device seconds as a group
``knn`` of the profile of their own, taken out of ``other``
(``harness/bounds.py`` ``group`` knows no ``knn``).
"""

from __future__ import annotations

import gc
import math
import sys

import numpy as np
import torch
from torch import nn

from harness import bounds, bounds_pt, grasp, traffic
from harness.runner import Outcome, Stalls, clock, p95
from harness.trace import Span
from harness.weights import make_state
from kinds.clusters_models import grouped_bytes, port_pipeline
from reference import msg
from reference import point_transformer as PT

KNN_KERNEL = "knn_kernel"


def model_state(model: nn.Module, seed: int, device) -> dict:
    """``harness/weights.py`` ``make_state`` for a model whose Linears may
    have no bias: each such Linear is given a zero bias for the draw, and
    its drawn bias is left out of the state."""
    added = []
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear) and m.bias is None:
            m.bias = nn.Parameter(torch.zeros(m.out_features))
            added.append(f"{name}.bias")
    state = make_state(model, seed, device)
    for name in added:
        del state[name]
    return state


def states(config: dict, seed: int, device) -> dict:
    """A ``state_dict`` per model key, each drawn from its own stream of
    ``seed`` (``harness/grasp.py``'s streams)."""
    nc = config["pipeline"]["num_classes"]
    names = msg.model_names(config)
    return {key: model_state(PT.build(names[key], nc), (int(seed) * 8 + i) % 2**63, device)
            for i, key in enumerate(names)}


def knn_launches() -> int | None:
    """The port's count of kNN launches, or None where it keeps none."""
    try:
        from pointnet_like_pose_estimation_tpu_torch.utils import counters
    except ImportError:
        return None
    return counters.read().get("knn")


def split_knn(profile: dict) -> None:
    """Move the kNN kernels' device seconds out of the profile's ``other``
    group into a ``knn`` group of their own, where any ran."""
    knn_s = sum(sec for name, (sec, _) in profile["kernels"].items() if KNN_KERNEL in name)
    if knn_s:
        profile["groups"]["knn"] = knn_s
        profile["groups"]["other"] = profile["groups"].get("other", 0.0) - knn_s


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
    captures0, grouped0, knn0 = pipe.programs.captures, grouped_bytes(), knn_launches()
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
            grouped, launched = grouped_bytes(), knn_launches()
            pre = {"seconds": now - t0, "requests": i, "captures": pipe.programs.captures - captures0,
                   "grouped_bytes": None if grouped is None else grouped - grouped0,
                   "knn_launches": None if launched is None else launched - knn0}
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
        split_knn(profile)
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    in_span = i - pre["requests"] if pre else 0
    del pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = {"kind": "serve"}
    if pre is not None:
        n = p["num_points"]
        flops = pre["requests"] * mix["clusters"] * bounds_pt.request_flops_per_cluster(names, n, p["num_classes"])
        peak_flops = bounds.matmul_peak(p["dtype"], torch.backends.cuda.matmul.allow_tf32)
        K, M = pool.shape[1:3]                      # the bucket: K to a multiple of 4, M above n to 256
        fps_s, knn_s = bounds_pt.request_bounds_s(-(-K // 4) * 4, -(-M // 256) * 256 if M > n else M, n)
        readings.update(captures=pre["captures"], mfu=bounds.mfu(flops, pre["seconds"], peak_flops),
                        requests=pre["requests"], grouped_bytes=pre["grouped_bytes"],
                        knn_launches=pre["knn_launches"], profile=profile,
                        fps_bound_s=in_span * fps_s, knn_bound_s=in_span * knn_s)

    ref = PT.GraspReference(weights, names, p["num_points"], p["num_classes"], p["dtype"], device)
    rng = np.random.default_rng([run.seed % 2**63, 7])
    sample = rng.choice(len(outs), min(mix["check"], len(outs)), replace=False) if outs else []
    rows = [grasp.gaps(ref, torch.from_numpy(pool[j % R]).to(device), outs[j]) for j in sample if outs[j]]
    worst = grasp.worst(rows)
    checks = [(g, worst[g], run.limits[g]) for g in grasp.GAPS]
    return Outcome(attempted=i, failed=failed, e2e={"request_p95_ms": p95(lat)}, readings=readings,
                   checks=checks, memory_peak_bytes=int(peak), profile=profile)
