"""The port's benchmark: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result's JSON object; the
numbers compared with the reference, each beside its limit, are the last
lines of standard error. See ``harness/runner.py``.
"""

import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache the run's libraries keep, at fixed paths inside the checkout
CACHE = ROOT / "build" / "bench_port_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(ROOT)]

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
