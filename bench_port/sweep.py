"""The highest frame rate a camera cell's program sustains: the cell run
once at each rate, in one process, on one seed.

    python3 bench_port/sweep.py --workload frames_300k --seed 1 --seconds 10 --rates 20 24 28 32

A rate is sustained where the frames' lateness (how late each was handed
to the program after its due time) does not grow over the window: the
last quarter's median lateness stays within one frame period of the
first quarter's. One JSON line a rate on standard output. The cell's rate
is then set, once, to four fifths of the highest rate sustained, rounded
down to a whole frame rate (``traffic/<mix>.json``, ``rate``).
"""

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402

from harness.runner import Run, execute  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    for rate in args.rates:
        run = Run(args.workload, args.seed, args.seconds, False, overrides={"rate": rate, "check": 0})
        out = execute(run)
        late = np.asarray(out.readings["late_ms"])
        q = len(late) // 4
        first, last = float(np.median(late[:q])), float(np.median(late[-q:]))
        print(json.dumps({"rate": rate, "frames": out.attempted, "failed": out.failed,
                          "frame_p95_ms": out.e2e["frame_p95_ms"], "late_first_quarter_ms": first,
                          "late_last_quarter_ms": last, "sustained": last - first <= 1e3 / rate}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
