"""The benchmark on the card: each cell's run prints one correct result
line that names the card, and the lower-precision control, run through
the cell's own driver and judge, comes out not correct on three seeds.

Run on a machine with a card, from the checkout's root:
``python -m pytest -p no:cacheprovider bench_port/tests/test_bench_port_cuda.py``.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_a_correct_line(card, cell, trace):
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", cell, "--seed", str(2**31 + 5),
                          "--seconds", "4", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "compared"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench[section] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= names
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for name, m in line["metrics"].items():
            if m["unit"] == "%":
                assert 0 <= m["value"] <= 100, name
    else:
        assert set(line["metrics"]) == names


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    out = subprocess.run([sys.executable, "bench_port/control.py", "--workload", cell, "--seeds", "1", "2", "3",
                          "--seconds", "3", "--plant", "control"], cwd=ROOT, capture_output=True, text=True,
                         timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(s) for s in out.stdout.strip().splitlines()]
    assert len(rows) == 3 and all(row.get("correct") is False for row in rows), rows
