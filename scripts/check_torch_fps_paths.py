"""Build the FPS kernel and check each of its paths once, for the PyTorch port.

Builds kernels/csrc/fps.cu with nvcc, prints ptxas's registers and shared
memory for every kernel in it, then runs FPS on seeded clouds at shapes on
each side of the shared path's limit (57,856 points) and up to 300,000
points: the indices must equal the plain version's, and the time of one
launch (CUDA events, not captured in a graph, after a first launch) is
printed beside the path fps_plan picks. A first check of a new path; the
timed figures are chip_smoke.py's.

Run on a machine with a card: python3 scripts/check_torch_fps_paths.py
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build
from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps, fps_plan, fps_reference

# (B, N, C, S): the global path at chip_smoke.py's shapes, then the shared path at its limit and below
SHAPES = [(2, 57_857, 3, 256), (1, 300_000, 3, 512), (2, 70_000, 10, 128), (2, 57_856, 3, 64),
          (1, 5000, 3, 64)]


def main() -> int:
    if not torch.cuda.is_available():
        print("check_torch_fps_paths: no CUDA device", file=sys.stderr)
        return 1
    built = _build.build(("fps",))["fps"]
    print(f"build {built.seconds:.1f} s")
    print("\n".join(line for line in built.log.splitlines() if "ptxas" in line or "registers" in line))
    rng = np.random.default_rng(0)
    ok = True
    for B, N, C, S in SHAPES:
        pts = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).cuda()
        got = fps(pts, S)
        torch.cuda.synchronize()
        equal = torch.equal(got, fps_reference(pts, S))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fps(pts, S)
        end.record()
        end.synchronize()
        print(f"B={B} N={N} C={C} S={S} plan={fps_plan(N, C)} equal={equal} ms={start.elapsed_time(end):.4f}",
              flush=True)
        ok &= equal
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
