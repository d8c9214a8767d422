"""ctypes binding of the port's native library (``_native/pcnative.cpp``, a
copy of the JAX package's source): DBSCAN and the threaded CSV reader of the
reference's txt layout. Its radius counts are not bound: the radius test
runs on the device.

The library is built with g++ at first use into ``build/torch_native/`` at
the root of the checkout, never into the package, under a name that hashes
the source and the flags, through a temporary file and an atomic rename so
that concurrent first uses do not collide. A failed build raises: the
serving path has no quiet fallback (``preprocess.dbscan(use_native=False)``
is the caller's explicit choice of the numpy version).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "_native" / "pcnative.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
# -ffp-contract=off: the squared distances round as the numpy version's do
FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-pthread")

_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"libpcnative-{digest}.so"
    if not target.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("native DBSCAN: g++ not found, the library cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SRC)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native DBSCAN: g++ failed:\n{res.stderr}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    lib.pc_dbscan.restype = ctypes.c_int32
    lib.pc_dbscan.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_double,
                              ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
    lib.pc_load_csv_files.restype = ctypes.c_int32
    lib.pc_load_csv_files.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                      ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int32]
    _lib = lib
    return lib


def dbscan(xyz: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """int64 ``[N]`` DBSCAN labels (-1 noise) of float64 ``[N, 3]`` points,
    the neighbourhood counting the point itself."""
    pts = np.ascontiguousarray(xyz, dtype=np.float64)
    labels = np.empty(len(pts), dtype=np.int64)
    library().pc_dbscan(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(pts), float(eps),
                        int(min_points), labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return labels


def load_csv_files(paths: list[str], max_rows: int, cols: int,
                   n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Parse comma-separated float files on a pool of ``n_threads`` host
    threads (0: one per core, at most 16): ``(values [n, max_rows, cols]
    float32, rows [n] int32)``, each file's rows zero-padded past its
    ``rows[i]``, rows beyond ``max_rows`` skipped, and ``rows[i] == -1`` for
    a file that cannot be read."""
    n = len(paths)
    blob = b"\0".join(os.fsencode(p) for p in paths) + b"\0"
    values = np.empty((n, max_rows, cols), dtype=np.float32)
    rows = np.empty((n,), dtype=np.int32)
    library().pc_load_csv_files(blob, n, int(max_rows), int(cols),
                                values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                int(n_threads or min(os.cpu_count() or 1, 16)))
    return values, rows
