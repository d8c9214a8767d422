"""Pick the FPS kernel's launch plan by measurement, for the PyTorch port.

    python3 scripts/tune_torch_fps.py                       # every plan of every path
    python3 scripts/tune_torch_fps.py --other build/parent  # against another checkout

Needs one NVIDIA GPU and nvcc. Prints what ptxas reports for every kernel of
csrc/fps.cu (registers, shared memory, spills), then times the kernel with
CUDA events under every plan that fits each of these calls, in microseconds
per step beside whether ``kernels/fps.py`` ``fps_plan`` picks it:

- the register path's calls, 32 clouds of N = 2048, 1024 and 512 points (the
  three FPS calls of a serving request: resample, SA1, SA2) at C = 3, and
  N = 2048, 1024 and 512 at C = 10 (a pose head's cloud spliced with a
  7-class one-hot: SA1 and SA2 of the SSG and MSG heads), under every
  (threads, points per thread) of the register path and the shared path;
- the clouds above what one block's shared memory holds (chip_smoke.py's
  FPS_GLOBAL_SHAPES, and the largest clouds the cluster path holds) under
  the global path and the cluster path at 4, 8 and 16 blocks of 256, 512
  and 1024 threads; and shared-path shapes of few clouds (N > 4096) under the shared
  and the cluster paths, whether the plan should send them to clusters.

Every variant's indices must equal the plain version's. The last line is
one JSON object with the card's name and power limit.

``--other DIR`` times ``fps`` as the package under ``DIR`` (another checkout
of the repository, say the parent commit unpacked by ``git archive``) and
this one plan it, in turns, other, this, this, other, each in a process of
its own, at the register path's six calls and at FPS_GLOBAL_SHAPES, by CUDA
graph replay, within one run on one card.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

# (C, N, S): the register path's calls, 32 clouds each
CALLS = [(3, 2048, 1024), (3, 1024, 512), (3, 512, 128), (10, 2048, 1024), (10, 1024, 512),
         (10, 512, 128)]
CLOUDS = 32
# (B, N, C, S): chip_smoke.py FPS_GLOBAL_SHAPES, the cluster path's largest
# clouds at 8 and 16 blocks, and shared-path shapes of few clouds
LARGE = [(2, 57_857, 3, 256), (1, 300_000, 3, 512), (2, 70_000, 10, 128), (1, 458_240, 3, 64),
         (1, 916_480, 3, 64)]
FEW = [(1, 4097, 3, 512), (8, 4097, 6, 512), (1, 8192, 3, 512), (1, 20_000, 3, 512),
       (2, 50_000, 3, 256), (4, 8192, 10, 256), (1, 57_856, 3, 256), (8, 8192, 3, 256),
       (9, 8192, 3, 256), (16, 20_000, 3, 256), (32, 8192, 10, 256)]
REPS = 20


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def clouds(rng, B, N, C):
    return torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).cuda()


def tune() -> int:
    sys.path.insert(0, ROOT)
    from pointnet_like_pose_estimation_tpu_torch.kernels import _build
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import (
        CLUSTER_BLOCKS,
        CLUSTER_PATH,
        GLOBAL_PATH,
        MAX_SHARED_POINTS,
        MAX_SLICE_POINTS,
        REGISTER_CHANNELS,
        SHARED_PATH,
        fps_plan,
        fps_reference,
    )

    built = _build.build(("fps",))["fps"]
    print(f"build {built.seconds:.1f} s")
    print("\n".join(line for line in built.log.splitlines() if "ptxas" in line or "spill" in line))

    def launch(pts, start, out, threads, ppt, cluster):
        B, N, C = pts.shape
        scratch = torch.empty((B, N), dtype=torch.float32, device="cuda") if ppt == GLOBAL_PATH else None
        _build.call("plpe_fps", pts, start, out, scratch, B, N, C, out.shape[1], threads, ppt, cluster)

    def run(pts, S, plans, reps):
        B, N, C = pts.shape
        start = torch.from_numpy(np.arange(B, dtype=np.int32) * 7919 % N).cuda()
        want = fps_reference(pts, S, start)
        for threads, ppt, cluster in plans:
            out = torch.empty((B, S), dtype=torch.int32, device="cuda")
            launch(pts, start, out, threads, ppt, cluster)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"B={B} N={N} C={C} threads={threads} ppt={ppt} cluster={cluster}: indices differ",
                      file=sys.stderr)
                return False
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                launch(pts, start, out, threads, ppt, cluster)
            t1.record()
            t1.synchronize()
            ms = t0.elapsed_time(t1) / reps
            picked = (threads, ppt) == fps_plan(N, C, B) and (ppt != CLUSTER_PATH or cluster == CLUSTER_BLOCKS)
            row = {"B": B, "N": N, "C": C, "S": S, "threads": threads, "points_per_thread": ppt,
                   "cluster": cluster if ppt == CLUSTER_PATH else None, "ms": ms,
                   "us_per_step": 1e3 * ms / S, "picked": picked}
            print(json.dumps(row), flush=True)
        return True

    rng = np.random.default_rng(0)
    ok = True
    for C, N, S in CALLS:
        pts = clouds(rng, CLOUDS, N, C)
        plans = [(t, p, 0) for p in (1, 2, 4, 8) for t in (128, 256, 512) if N <= t * p < 4 * N]
        plans = plans if C in REGISTER_CHANNELS else []
        plans += [(t, SHARED_PATH, 0) for t in (256, 512, 1024)]
        ok &= run(pts, S, plans, REPS)
    for B, N, C, S in LARGE + FEW:
        pts = clouds(rng, B, N, C)
        plans = [(t, CLUSTER_PATH, cl) for cl in (4, 8, 16) for t in (256, 512, 1024)
                 if -(-N // cl) <= MAX_SLICE_POINTS]
        plans += [(1024, SHARED_PATH, 0)] if N <= MAX_SHARED_POINTS else [(1024, GLOBAL_PATH, 0)]
        ok &= run(pts, S, plans, 3 if N > 100_000 else 10)
        del pts
    print(json.dumps({"card": card_name(), "clouds": CLOUDS, "ok": bool(ok)}))
    return 0 if ok else 1


def time_root(root: str) -> int:
    """Time ``fps`` as the package under ``root`` plans it, by CUDA graph
    replay, at the register path's calls and FPS_GLOBAL_SHAPES."""
    sys.path.insert(0, os.path.abspath(root))
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps, fps_plan, fps_reference

    rng = np.random.default_rng(0)
    shapes = [(CLOUDS, N, C, S) for C, N, S in CALLS] + LARGE[:3]
    rows = []
    for B, N, C, S in shapes:
        pts = clouds(rng, B, N, C)
        got = fps(pts, S)
        if not torch.equal(got, fps_reference(pts, S)):
            print(f"{root}: B={B} N={N} C={C}: indices differ", file=sys.stderr)
            return 1
        reps = 3 if N > 100_000 else 10
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fps(pts, S)
        graph.replay()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        ms = t0.elapsed_time(t1) / reps
        rows.append({"root": root, "B": B, "N": N, "C": C, "S": S, "plan": list(fps_plan(N, C)), "ms": ms,
                     "us_per_step": 1e3 * ms / S})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"root": root, "card": card_name(), "total_ms": sum(r["ms"] for r in rows)}))
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("tune_torch_fps: no CUDA device", file=sys.stderr)
        return 1
    me = [sys.executable, os.path.abspath(__file__)]
    if len(argv) == 2 and argv[0] == "--root":
        return time_root(argv[1])
    if len(argv) == 2 and argv[0] == "--other":
        rc = 0
        for root in (argv[1], ROOT, ROOT, argv[1]):
            rc |= subprocess.run([*me, "--root", root]).returncode
        return rc
    return tune()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
