#!/usr/bin/env python3
"""Time the ball-query kernel of the PyTorch/CUDA port per launch plan.

    python3 scripts/tune_torch_ball_query.py                # the committed plan
    python3 scripts/tune_torch_ball_query.py 8 16 32        # points a step
    python3 scripts/tune_torch_ball_query.py --other build/parent  # against another checkout

Needs one NVIDIA GPU and nvcc. Each configuration runs in a process of its
own: it builds ``csrc/ball_group.cu`` with the step given (the points whose
loads and distances a thread forms together, ``-DPLPE_BQ_STEP``), sets the
same ``STEP`` beside ``ball_query_plan``, prints
what ptxas reports for the kernel, and runs the kernel phase of
``chip_smoke.py``: every exactness case against ``ball_query_reference``,
then the time of one call at each of the eight shapes of 32 clouds beside its
bound. The last line of a configuration is one JSON object.

``--other DIR`` times the ball query of the package under ``DIR`` (another
checkout of the repository, say the parent commit unpacked by ``git
archive``) and this one in turns, other, this, this, other, at the same eight
calls by the same method (CUDA graph replay), within one run on one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(step: int | None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_torch_ball_query: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from pointnet_like_pose_estimation_tpu_torch.kernels import _build, ball_group

    if step is not None:
        _build.NVCC_FLAGS += (f"-DPLPE_BQ_STEP={step}",)
        ball_group.STEP = step
    torch.backends.cuda.matmul.allow_tf32 = False
    built = _build.build(("fps", "ball_group"))
    for line in built["ball_group"].log.splitlines():
        if "ptxas" in line and ("registers" in line or "spill" in line):
            print(f"  {line.strip()}")
    kernels = chip_smoke.kernel_phase(torch.device("cuda"))
    entry = next(k for k in kernels if k["name"] == "ball_query")
    print(json.dumps({
        "card": chip_smoke.card_line(),
        "step": ball_group.STEP,
        "ms": {s["call"]: s["ms"] for s in entry["shapes"]},
        "bound_ms": {s["call"]: s["bound_ms"] for s in entry["shapes"]},
    }), flush=True)
    return 0


def time_root(root: str) -> int:
    """Time the eight ball-query calls with the package found under ``root``."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tune_torch_ball_query: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(root))
    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi

    _, calls = chip_smoke.path_calls(np.random.default_rng(0), torch.device("cuda"))
    ms = {what: chip_smoke.cuda_graph_ms(lambda: ball_query_multi(pts, cent, radii, ks), 20)
          for what, pts, cent, radii, ks in calls}
    print(json.dumps({"card": chip_smoke.card_line(), "root": root, "ms": ms}), flush=True)
    return 0


def main(argv: list[str]) -> int:
    me = [sys.executable, os.path.abspath(__file__)]
    if len(argv) == 2 and argv[0] == "--root":
        return time_root(argv[1])
    if len(argv) == 2 and argv[0] == "--other":
        rc = 0
        for root in (argv[1], ROOT, ROOT, argv[1]):
            rc |= subprocess.run([*me, "--root", root]).returncode
        return rc
    if len(argv) == 2 and argv[0] == "--one":
        return run_one(None if argv[1] == "committed" else int(argv[1]))
    rc = 0
    for config in argv or ["committed"]:
        print(f"== step {config}", flush=True)
        rc |= subprocess.run([*me, "--one", config]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
