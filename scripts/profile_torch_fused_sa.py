"""Where the fused set-abstraction kernel's time goes, for the PyTorch port.

The card's machine runs no kernel profiler, so csrc/fused_sa.cu carries its
own: built with -DPLPE_PROFILE, thread 0 of every block adds the cycles it
spends in each phase (set-up, selection, gather, layer-0 FMAs, waiting for
the weight ring, the MMA loops, epilogues, the final store) to a counter.
This script builds that variant, runs the kernel at the shapes of the four
SA calls of the two executors (32 clouds of 1024 points, seeded weights),
and prints cycles per block and phase beside the call's time (CUDA events).
Thread 0's warp is one of sixteen, so a phase's cycles are that warp's
latency through it, not a sum over warps.

Two more builds cut work out of the MMA loops, with wrong results, to show
what that work costs: "no_split" passes the operands unsplit (no split
arithmetic), "one_product" runs one MMA in place of three. They are built
from edited copies of the source that this script writes under the build
directory; the kernel itself carries neither. From the three builds the
script solves, for SSG SA2's loops, the cycles that the fragment loads, the
split arithmetic and one MMA cost a scheduler of four warps.

Run on a machine with a card: python3 scripts/profile_torch_fused_sa.py
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build
from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
from pointnet_like_pose_estimation_tpu_torch.kernels.fused_sa import fused_sa_infer, launch_plan
from pointnet_like_pose_estimation_tpu_torch.ops import index_points

PHASES = ("set_up", "select", "gather", "layer0_fma", "ring_wait", "products", "epilogue", "store")
CLOUDS = 32
# call -> (N, feature channels, S, radii, ks, widths)
CALLS = {
    "SSG SA1": (1024, 0, 512, (0.2,), (32,), ((64, 64, 128),)),
    "SSG SA2": (512, 128, 128, (0.4,), (64,), ((128, 128, 256),)),
    "MSG SA1": (1024, 0, 512, (0.1, 0.2, 0.4), (16, 32, 128),
                ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
    "MSG SA2": (512, 320, 128, (0.2, 0.4, 0.8), (32, 64, 128),
                ((64, 64, 128), (128, 128, 256), (128, 128, 256))),
}
# build -> edits (old text, new text) of csrc/fused_sa.cu, each of which must hit once
BUILDS = {
    "full": (),
    "no_split": ((
        "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
        "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;\n",
        "  hi = __float_as_uint(x);\n  lo = 0u;\n"),),
    "one_product": (("for (int term = 0; term < 3; ++term) {",
                     "for (int term = 2; term < 3; ++term) {"),),
}
CSRC = _build.CSRC


def inputs(rng, N, D, S, widths):
    xyz = rng.standard_normal((CLOUDS, N, 3)).astype(np.float32)
    xyz -= xyz.mean(axis=1, keepdims=True)
    xyz = torch.from_numpy(xyz / np.linalg.norm(xyz, axis=-1).max(axis=1)[:, None, None]).cuda()
    feats = torch.from_numpy(np.abs(rng.standard_normal((CLOUDS, N, D))).astype(np.float32)).cuda()
    weights = []
    for ws in widths:
        cin = 3 + D
        for cout in ws:
            weights += [rng.standard_normal((cin, cout)) / np.sqrt(cin), 0.1 * rng.standard_normal(cout)]
            cin = cout
    weights = [torch.from_numpy(w.astype(np.float32)).cuda() for w in weights]
    cent = index_points(xyz, fps(xyz, S)).contiguous()
    return torch.cat([xyz, feats], dim=-1).contiguous(), cent, weights


def load_build(build, edits):
    """The fused-SA library compiled with the phase clock from a copy of the
    sources with ``edits`` applied, in place of the one the wrapper would
    load."""
    src = _build.BUILD_DIR / "profile_src" / build
    src.mkdir(parents=True, exist_ok=True)
    for source in CSRC.iterdir():
        shutil.copy(source, src / source.name)
    text = (CSRC / "fused_sa.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{build}: {old!r} is in fused_sa.cu {text.count(old)} times, want 1")
        text = text.replace(old, new)
    (src / "fused_sa.cu").write_text(text)
    _build.CSRC = src
    if "-DPLPE_PROFILE" not in _build.NVCC_FLAGS:
        _build.NVCC_FLAGS += ("-DPLPE_PROFILE",)
    _build._LIBS.pop("fused_sa", None)
    _build._BUILT.pop("fused_sa", None)
    lib = _build.library("fused_sa")
    lib.plpe_fused_sa_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.plpe_fused_sa_phase_cycles.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_fused_sa: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    products = {}
    for build, edits in BUILDS.items():
        lib = load_build(build, edits)
        rng = np.random.default_rng(0)
        for call, (N, D, S, radii, ks, widths) in CALLS.items():
            pts, cent, weights = inputs(rng, N, D, S, widths)

            def run():
                return fused_sa_infer(pts, cent, weights, radii, ks, widths)

            run()
            torch.cuda.synchronize()
            _build.check(lib, lib.plpe_fused_sa_phase_cycles(None, 1), "reset")
            run()
            torch.cuda.synchronize()
            cycles = (ctypes.c_ulonglong * len(PHASES))()
            _build.check(lib, lib.plpe_fused_sa_phase_cycles(ctypes.addressof(cycles), 0), "read")
            rows, tile, _ = launch_plan(3 + D, ks, widths)
            blocks = CLOUDS * -(-S // tile)
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(10):
                run()
            t1.record()
            t1.synchronize()
            per_block = {p: round(c / blocks) for p, c in zip(PHASES, cycles)}
            chunks = sum(-(-tile * -(-k // 16) * 16 // rows) for k in ks)
            products[build, call] = per_block["products"] / chunks
            print(json.dumps({"build": build, "call": call, "rows": rows, "centroids_per_block": tile,
                              "blocks": blocks, "ms": t0.elapsed_time(t1) / 10,
                              "cycles_per_block": per_block}), flush=True)

    # SSG SA2, one chunk: 128 rows through 131 -> 128 -> 128 -> 256. A
    # scheduler's four warps each run 17 + 16 + 2 * 16 k-steps of 24 MMAs, 16
    # fragment loads and 16 split operands of 4 operations.
    steps = 17 + 16 + 2 * 16
    full, no_split, one = (products[b, "SSG SA2"] / steps for b in BUILDS)
    print(json.dumps({
        "card": card,
        "ssg_sa2_cycles_per_k_step_of_4_warps": {"full": full, "no_split": no_split,
                                                 "one_product": one},
        "cycles_per_mma": (full - one) / 64,
        "cycles_per_split_operation": (full - no_split) / 256,
        "cycles_per_fragment_load": (full - (full - one) * 96 / 64 - (full - no_split)) / 64,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
