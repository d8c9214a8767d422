"""Where a grasp request's time goes on the GPU, for the PyTorch port.

Serves requests of 4 and 32 clusters of 2048 points through
GraspPipeline.from_checkpoints (the five committed checkpoints) under
torch.profiler, and prints for each size: the host-clock time per request,
the device busy share (summed kernel time over wall time: one stream, so
kernels do not overlap), and the device time by kernel, grouped into the
port's two CUDA kernels, matrix products, and everything else.

Run on a machine with a card: python3 scripts/profile_torch_serving.py
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

CHECKPOINTS = {
    "classifier": "log/classification/r3_pointnet2_cls_ssg/checkpoints/best.msgpack",
    "rotation": "log/pose/r3_rotation/checkpoints/best.msgpack",
    "sign": "log/pose/r3_sign/checkpoints/best.msgpack",
    "translation": "log/pose/r3_translation_ref/checkpoints/best.msgpack",
    "width": "log/pose/r3_width_ref/checkpoints/best.msgpack",
}
REQUESTS = 5


def group(name: str) -> str:
    if "fps_register_kernel" in name or "fps_shared_kernel" in name:
        return "fps (CUDA kernel)"
    if "ball_query_kernel" in name:
        return "ball_query (CUDA kernel)"
    if any(t in name for t in ("gemm", "Gemm", "sm90_xmma", "cutlass", "addmm")):
        return "matrix products"
    return "other"


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_serving: no CUDA device")
    paths = {k: os.path.join(ROOT, v) for k, v in CHECKPOINTS.items()}
    pipe = GraspPipeline.from_checkpoints(PipelineConfig(), paths)
    rng = np.random.default_rng(0)
    report = {}
    for K in (4, 32):
        clusters = (rng.uniform(-0.5, 0.5, (K, 1, 3))
                    + 0.05 * rng.standard_normal((K, 2048, 3))).astype(np.float32)
        for _ in range(3):
            pipe.infer_clusters(clusters)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REQUESTS):
                pipe.infer_clusters(clusters)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", 0) or 0
            if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                kernels[ev.key] = (dev_us / 1e3 / REQUESTS, ev.count // REQUESTS)
        device_ms = sum(t for t, _ in kernels.values())
        groups = {}
        for name, (t, n) in kernels.items():
            g = groups.setdefault(group(name), [0.0, 0])
            g[0] += t
            g[1] += n
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
        report[f"K={K} M=2048"] = {
            "request_ms": wall_ms / REQUESTS,
            "device_ms_per_request": device_ms if kernels else "not measured",
            "device_busy_share": device_ms / (wall_ms / REQUESTS) if kernels else "not measured",
            "groups_ms_and_launches": groups,
            "top_kernels_ms_and_launches": {k[:90]: v for k, v in top},
        }
        print(json.dumps({f"K={K} M=2048": report[f"K={K} M=2048"]}, indent=1), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"card": card, "profile": report}))


if __name__ == "__main__":
    main()
