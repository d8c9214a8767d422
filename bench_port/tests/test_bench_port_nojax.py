"""No JAX in a run: the module check compares whole top-level names, and
the reference imports nothing of the port (nor JAX)."""

import ast
import sys
import types
from pathlib import Path

import pytest

from harness.runner import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "flax.linen", "pointnet_like_pose_estimation_tpu",
                                  "pointnet_like_pose_estimation_tpu.ops"])
def test_a_forbidden_module_is_found(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert name in forbidden_modules()


@pytest.mark.parametrize("name", ["pointnet_like_pose_estimation_tpu_torch", "jaxtyping", "flaxen.x"])
def test_a_module_that_only_begins_alike_is_not(name, monkeypatch):
    for loaded in [n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, loaded)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == []


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert _imports(path) <= {"__future__", "numpy", "torch", "reference"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_of_the_benchmark_imports_jax(path):
    assert not _imports(path) & set(FORBIDDEN)
