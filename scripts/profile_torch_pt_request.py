#!/usr/bin/env python3
"""The classifier's share of a Point Transformer grasp request's device time,
for the PyTorch port.

    python3 scripts/profile_torch_pt_request.py [--clusters 32] [--seed 0] [--requests 20]

Needs one NVIDIA GPU and nvcc. Builds ``GraspPipeline`` with
``PipelineConfig(classifier="point_transformer_cls")`` (the PointNet heads
by default) on seeded random weights and profiles, with the benchmark's own
span (``bench_port/harness/trace.py`` ``Span``, the kNN kernels split out
of ``other`` by ``kinds/clusters_pt.py`` ``split_knn``): a window of
requests of K clusters of 2048 points through ``infer_clusters``, then a
window of replays of a CUDA graph of the classifier alone on a request's
own classifier input. One JSON line: the device busy ms a request and a
classifier forward, the kernel groups of each, the classifier's share and
the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "bench_port")]


def _profiled(span, fn, reps: int) -> dict:
    """``fn()`` ``reps`` times in ``span``: device busy ms and the kernel
    groups' ms, a call."""
    from kinds.clusters_pt import split_knn

    span.start()
    for _ in range(reps):
        fn()
    span.stop()
    summary = span.summary()
    split_knn(summary)
    return {"busy_ms": 1e3 * summary["busy_s"] / reps,
            "groups_ms": {g: 1e3 * sec / reps for g, sec in sorted(summary["groups"].items(), key=lambda kv: -kv[1])}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_pt_request: no CUDA device", file=sys.stderr)
        return 1
    from harness.trace import Span

    from pointnet_like_pose_estimation_tpu_torch.ops import farthest_point_sample, index_points, normalize_cloud
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    K, device = args.clusters, torch.device("cuda")
    cfg = PipelineConfig(classifier="point_transformer_cls")
    pipe = GraspPipeline.from_random(cfg, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    clusters = (rng.uniform(-0.5, 0.5, (K, 1, 3)) + 0.05 * rng.standard_normal((K, 2048, 3))).astype(np.float32)
    for _ in range(3):
        pipe.infer_clusters(clusters)
    span = Span(device)
    out = {"clusters": K, "request": _profiled(span, lambda: pipe.infer_clusters(clusters), args.requests)}

    classifier = pipe.models["classifier"]
    with torch.inference_mode():
        xyz = torch.from_numpy(clusters).to(device)
        normed = normalize_cloud(index_points(xyz, farthest_point_sample(xyz, cfg.num_points)))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            classifier(normed)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            classifier(normed)
        graph.replay()
        out["classifier"] = _profiled(span, graph.replay, args.requests)
    out["classifier_share"] = out["classifier"]["busy_ms"] / out["request"]["busy_ms"]
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
