"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/torch_kernels/<name>-<hash>.so`` beside the package, the
hash covering the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited source is never served from a stale library. Nothing is built at import: the first launch
of a kernel builds its library, and ``build()`` builds several at once,
one nvcc process each, all started together. A failed build raises.

Every C entry is declared once, in ``ENTRIES``; its types are set when its
library is loaded, and the wrappers launch it through ``call``, which passes
the caller's current CUDA stream last and raises on a CUDA error.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# every C entry of the kernel libraries: its library and the types of its
# arguments but the last, the CUDA stream, which every entry takes. Each
# returns the cudaError_t of its launch (0 on success).
_PTR, _INT, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
ENTRIES = {
    "plpe_fps": ("fps", [_PTR] * 4 + [_INT] * 7),
    "plpe_ball_query": ("ball_group", [_PTR] * 3 + [_INT] * 4 + [_PTR] * 2 + [_INT] * 6),
    "plpe_fused_sa": ("fused_sa", [_PTR] * 4 + [_INT] * 5 + [_PTR] * 5 + [_INT] * 3),
    "plpe_fused_sa_mma_selftest": ("fused_sa", [_PTR] * 3),
    "plpe_bn_relu_forward": ("bn_relu", [_PTR] * 10 + [_I64, _INT, _INT] + [_F32] * 3),
    "plpe_bn_relu_backward": ("bn_relu", [_PTR] * 11 + [_I64, _INT, _INT]),
    "plpe_bn_relu_eval": ("bn_relu", [_PTR] * 6 + [_I64, _INT, _INT, _F32]),
    "plpe_bn_relu_eval_max": ("bn_relu", [_PTR] * 6 + [_I64] + [_INT] * 3 + [_F32]),
    "plpe_bn_relu_eval_gather": ("bn_relu", [_PTR] * 9 + [_INT] * 8 + [_F32]),
    "plpe_knn": ("knn", [_PTR] * 3 + [_INT] * 7),
    "plpe_pt_attention": ("pt_attention", [_PTR] * 30 + [_INT] * 8 + [_F32] * 4),
}
KERNELS = tuple(dict.fromkeys(lib for lib, _ in ENTRIES.values()))

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
    """The loaded library of one kernel, built on first use, its entries'
    types set."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build((name,))[name].path))
        lib.plpe_error_string.argtypes = [ctypes.c_int]
        lib.plpe_error_string.restype = ctypes.c_char_p
        for entry, (owner, argtypes) in ENTRIES.items():
            if owner == name:
                getattr(lib, entry).argtypes = [*argtypes, ctypes.c_void_p]
                getattr(lib, entry).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def call(entry: str, *args) -> None:
    """Launch the C entry ``entry`` (of ``ENTRIES``) on ``args``, a tensor
    passed as its address, then the current CUDA stream of the first
    tensor's device; raises if it returns a CUDA error."""
    lib = library(ENTRIES[entry][0])
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    code = getattr(lib, entry)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                               torch.cuda.current_stream(device).cuda_stream)
    check(lib, code, entry)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib.plpe_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
