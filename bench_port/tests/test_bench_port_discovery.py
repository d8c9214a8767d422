"""A later cell, mix and per-layer metric are new files and new entries
of ``BENCHMARK.json``: a temporary copy of the benchmark with one of each
added runs them without a code edit."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

SCRIPT = """
import json, sys
import torch
torch.set_num_threads(2)
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from harness.runner import Run, execute, result_line
run = Run("clusters_tiny", 3, 6.0, True, device="cpu")
print(json.dumps(result_line(run, execute(run), "cpu", 1, "none")))
"""


def test_a_new_cell_mix_and_metric_are_found(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "bench_port", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "clusters_tiny", "config": "grasp_ssg_f32", "traffic": "clusters_tiny",
                               "chips": 1, "why": "a cell added as files"})
    bench["end_to_end"][0]["workloads"].append("clusters_tiny")
    bench["per_layer"].append({"name": "requests_in_window.tiny", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "Entry", "moves": "request_p95_ms",
                               "workloads": ["clusters_tiny"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    (copy / "bench_port" / "traffic" / "clusters_tiny.json").write_text(json.dumps(
        {"kind": "clusters", "requests": 1, "clusters": 2, "points": 1100, "warmup": 1, "check": 1,
         "profile_seconds": 3.0}))
    cell = json.loads((BENCH / "workloads" / "clusters_k32.json").read_text())
    cell.update(traffic="clusters_tiny", why="a cell added as files")
    (copy / "bench_port" / "workloads" / "clusters_tiny.json").write_text(json.dumps(cell))
    (copy / "bench_port" / "metrics" / "requests_in_window.tiny.py").write_text(
        "def read(readings):\n    return 41 + 1 if readings.get('profile') else None\n")
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(copy / "bench_port"), str(ROOT)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"].get("requests_in_window.tiny", {}).get("value") == 42, (line, out.stderr[-2000:])
    assert set(line["compared"]) == {"class_err", "head_err"}


def test_a_bare_copy_of_the_benchmark_fails_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "clusters_k32", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_every_per_layer_metric_finds_its_reader():
    """A metric ``<base>.<group>`` with no file of its own reads ``metrics/<base>.py``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        own = BENCH / "metrics" / f"{m['name']}.py"
        base = BENCH / "metrics" / f"{m['name'].split('.', 1)[0]}.py"
        assert own.exists() or base.exists(), m["name"]
