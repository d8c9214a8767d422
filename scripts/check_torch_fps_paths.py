"""Build the FPS kernel and check each of its paths once, for the PyTorch port.

Builds kernels/csrc/fps.cu with nvcc, prints ptxas's registers and shared
memory for every kernel in it, then runs FPS on seeded clouds at shapes on
each side of every path's limit: the register path at C = 3 and 10 up to
4096 points, the shared path up to 57,856, the cluster path above it up to
its limit (MAX_CLUSTER_POINTS), and the global path above that; with a
start index in the last block's slice and a tiled cloud whose duplicates
straddle the slices. The indices must equal the plain version's, and the
time of one launch (CUDA events, not captured in a graph, after a first
launch) is printed beside the path fps_plan picks. A first check of a new
path; the timed figures are chip_smoke.py's.

Run on a machine with a card: python3 scripts/check_torch_fps_paths.py
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build
from pointnet_like_pose_estimation_tpu_torch.kernels.fps import (
    MAX_CLUSTER_POINTS,
    fps,
    fps_plan,
    fps_reference,
)

# (B, N, C, S, start, tiles): the cluster path at chip_smoke.py's FPS_GLOBAL_SHAPES, at its limit
# and, with a start in the last slice and with duplicates across the slices, ragged; the global
# path above it; the cluster path below shared memory for few clouds, the shared path for more
# and at C = 6, the cluster path's any-C instance; the register path at C = 10 and 3
SHAPES = [(2, 57_857, 3, 256, 0, 1), (1, 300_000, 3, 512, 0, 1), (2, 70_000, 10, 128, 0, 1),
          (1, MAX_CLUSTER_POINTS, 3, 64, 0, 1), (2, 100_003, 3, 128, 100_002, 1),
          (2, 60_000 * 3 + 7, 3, 300, 5, 3), (1, MAX_CLUSTER_POINTS + 1, 3, 32, 0, 1),
          (2, 57_856, 3, 64, 0, 1), (1, 5000, 3, 64, 0, 1), (12, 57_856, 3, 32, 0, 1),
          (12, 5000, 3, 64, 0, 1), (4, 777, 6, 64, 0, 1), (1, 300_000, 6, 64, 0, 1),
          (4, 4096, 10, 512, 0, 1),
          (4, 2048, 10, 1024, 0, 1), (8, 1024, 10, 512, 0, 1), (8, 512, 10, 128, 0, 1),
          (8, 1024, 3, 512, 0, 1)]


def main() -> int:
    if not torch.cuda.is_available():
        print("check_torch_fps_paths: no CUDA device", file=sys.stderr)
        return 1
    built = _build.build(("fps",))["fps"]
    print(f"build {built.seconds:.1f} s")
    print("\n".join(line for line in built.log.splitlines() if "ptxas" in line or "spill" in line))
    rng = np.random.default_rng(0)
    ok = True
    for B, N, C, S, first, tiles in SHAPES:
        base = rng.standard_normal((B, -(-N // tiles), C)).astype(np.float32)
        pts = torch.from_numpy(np.tile(base, (1, tiles, 1))[:, :N]).cuda()
        got = fps(pts, S, first)
        torch.cuda.synchronize()
        equal = torch.equal(got, fps_reference(pts, S, first))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fps(pts, S, first)
        end.record()
        end.synchronize()
        print(f"B={B} N={N} C={C} S={S} start={first} tiles={tiles} plan={fps_plan(N, C, B)} equal={equal} "
              f"ms={start.elapsed_time(end):.4f}", flush=True)
        ok &= equal
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
