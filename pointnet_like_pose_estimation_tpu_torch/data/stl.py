"""STL meshes: a reader (binary and ASCII), an area-weighted surface
sampler and a binary writer (counterpart of ``data/stl.py`` of the JAX
package, which this module copies), so that CAD models can feed the same
dataset and FPS path as the analytic shapes.
"""

from __future__ import annotations

import struct

import numpy as np


def load_stl(path: str) -> np.ndarray:
    """Read an STL file -> triangles ``[T, 3, 3]`` float64. A file that
    starts with ``solid`` is read as ASCII, and as binary where that fails
    (a binary file may carry ``solid`` in its header too)."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            try:
                return _load_ascii(path)
            except ValueError:      # not text, or no whole triangles: binary
                pass
        return _load_binary(f.read())


def _load_binary(data: bytes) -> np.ndarray:
    n = struct.unpack("<I", data[80:84])[0]
    tris = np.empty((n, 3, 3))
    rec = np.frombuffer(data[84:84 + n * 50], dtype=np.uint8).reshape(n, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n, 4, 3)
    tris[:] = floats[:, 1:4, :]  # skip the normal
    return tris


def _load_ascii(path: str) -> np.ndarray:
    verts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "vertex":
                verts.append([float(x) for x in parts[1:4]])
    arr = np.asarray(verts)
    if len(arr) == 0 or len(arr) % 3:
        raise ValueError("not a valid ascii STL")
    return arr.reshape(-1, 3, 3)


def sample_mesh_surface(
    triangles: np.ndarray, num_points: int, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Uniform area-weighted surface sampling -> ``[num_points, 3]``:
    triangles chosen in proportion to their area, points placed by the
    square-root barycentric rule."""
    rng = rng or np.random.default_rng(0)
    a, b, c = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh")
    tri_idx = rng.choice(len(triangles), size=num_points, p=areas / total)
    r1 = np.sqrt(rng.uniform(size=(num_points, 1)))
    r2 = rng.uniform(size=(num_points, 1))
    return (1 - r1) * a[tri_idx] + r1 * (1 - r2) * b[tri_idx] + r1 * r2 * c[tri_idx]


def save_stl(path: str, triangles: np.ndarray) -> None:
    """Write triangles ``[T, 3, 3]`` as binary STL (normals recomputed)."""
    tris = np.asarray(triangles, np.float64)
    n = len(tris)
    normals = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = np.where(norm > 0, normals / np.maximum(norm, 1e-30), 0.0)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", n))
        floats = np.concatenate([normals[:, None, :], tris], axis=1).astype("<f4")
        rec = np.zeros((n, 50), np.uint8)
        rec[:, :48] = np.frombuffer(floats.tobytes(), np.uint8).reshape(n, 48)
        f.write(rec.tobytes())
