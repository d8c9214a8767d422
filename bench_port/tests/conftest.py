"""The benchmark's tests: the harness and reference import from
``bench_port/``, the port from the checkout's root. Tests that need the
card carry the ``cuda`` marker and skip inside a fixture where there is
none. Run here with ``python -m pytest bench_port/tests``."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the benchmark on the card")
    return torch.device("cuda")
