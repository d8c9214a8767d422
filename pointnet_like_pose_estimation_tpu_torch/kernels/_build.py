"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/torch_kernels/<name>-<hash>.so`` beside the package, the
hash covering the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited source is never served from a stale library. Nothing is built at import: the first launch
of a kernel builds its library, and ``build()`` builds several at once,
one nvcc process each, all started together. A failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("fps", "ball_group", "fused_sa", "bn_relu")

# -fmad=false: a contracted multiply-add rounds once where the PyTorch
# version rounds twice, which moves points across the ball radius and
# changes FPS ties. Explicit __fmaf_rn calls (the fused-SA MLP) are kept.
# -Xptxas -v reports registers and shared memory.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Built:
    """One compiled kernel library."""

    name: str
    path: Path
    seconds: float      # nvcc wall time; 0.0 when the library was already built
    log: str            # nvcc's stderr (the -Xptxas -v lines)


_LIBS: dict[str, ctypes.CDLL] = {}
_BUILT: dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, Built]:
    """Compile the named kernels (in parallel) unless already built."""
    todo = [n for n in names if n not in _BUILT]
    if not todo:
        return {n: _BUILT[n] for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        target = _target(name)
        if target.exists():
            _BUILT[name] = Built(name, target, 0.0, "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, target)
    failures = []
    for name, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, target)      # atomic: a reader never sees half a library
        _BUILT[name] = Built(name, target, time.perf_counter() - t0, out + err)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return {n: _BUILT[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build((name,))[name].path))
        lib.plpe_error_string.argtypes = [ctypes.c_int]
        lib.plpe_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib.plpe_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
