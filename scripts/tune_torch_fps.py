"""Pick the FPS kernel's launch plan by measurement, for the PyTorch port.

For clouds of N = 512, 1024 and 2048 points (the three FPS calls of one
serving request of 32 clusters: SA2, SA1 and the resample) this times
csrc/fps.cu under every (threads, points per thread) that covers N on the
register path, and under the shared and the global path, with CUDA events, and prints
microseconds per step beside the plan ``kernels/fps.py`` ``fps_plan``
picks. Every variant's indices must equal the plain version's.

Run on a machine with a card: python3 scripts/tune_torch_fps.py
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build
from pointnet_like_pose_estimation_tpu_torch.kernels.fps import GLOBAL_PATH, fps_plan, fps_reference

CALLS = [(2048, 1024), (1024, 512), (512, 128)]   # (N, S) of resample, SA1, SA2
CLOUDS = 32
REPS = 20


def launch(lib, pts, start, out, threads, ppt):
    B, N, C = pts.shape
    scratch = torch.empty((B, N), dtype=torch.float32, device="cuda") if ppt == GLOBAL_PATH else None
    code = lib.plpe_fps(pts.data_ptr(), start.data_ptr(), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), B, N, C, out.shape[1],
                        threads, ppt, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fps")


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_torch_fps: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lib = _build.library("fps")
    lib.plpe_fps.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rng = np.random.default_rng(0)
    rows = []
    for N, S in CALLS:
        pts = torch.from_numpy(rng.standard_normal((CLOUDS, N, 3)).astype(np.float32)).cuda()
        start = torch.zeros(CLOUDS, dtype=torch.int32, device="cuda")
        want = fps_reference(pts, S)
        plans = [(t, p) for p in (1, 2, 4, 8) for t in (128, 256, 512, 1024) if N <= t * p < 4 * N]
        plans += [(t, p) for p in (0, GLOBAL_PATH) for t in (256, 512, 1024)]
        for threads, ppt in plans:
            out = torch.empty((CLOUDS, S), dtype=torch.int32, device="cuda")
            launch(lib, pts, start, out, threads, ppt)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"N={N} threads={threads} ppt={ppt}: indices differ", file=sys.stderr)
                return 1
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(REPS):
                launch(lib, pts, start, out, threads, ppt)
            t1.record()
            t1.synchronize()
            ms = t0.elapsed_time(t1) / REPS
            rows.append({"N": N, "S": S, "threads": threads, "points_per_thread": ppt,
                         "ms": ms, "us_per_step": 1e3 * ms / S,
                         "picked": (threads, ppt) == fps_plan(N)})
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"card": card, "clouds": CLOUDS, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
