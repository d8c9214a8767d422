"""Cloud files: the reference's txt-per-cloud layout, PLY read and write,
and a replay camera that serves saved frames (counterparts of
``data/io_utils.py`` of the JAX package, which this module copies).

The reference stores a sample as CSV text files ``<cat>/<cat>_NNNN.txt``
(points), ``_rot.txt`` and ``_tran.txt``, and captures as PLY.
"""

from __future__ import annotations

import os

import numpy as np


def save_reference_layout(root: str, category: str, index: int, points, rot, tran) -> None:
    """Write one sample in the reference's txt layout under ``root``."""
    d = os.path.join(root, category)
    os.makedirs(d, exist_ok=True)
    stem = os.path.join(d, f"{category}_{index:04d}")
    np.savetxt(stem + ".txt", np.asarray(points), fmt="%6f", delimiter=",")
    np.savetxt(stem + "_tran.txt", np.asarray(tran).reshape(1, 3), fmt="%6f", delimiter=",")
    np.savetxt(stem + "_rot.txt", np.asarray(rot).reshape(1, 3), fmt="%6f", delimiter=",")


def load_reference_sample(root: str, category: str, index: int):
    """One sample ``(points, rot, tran)`` of the reference's txt layout, as
    written, without the loader's sign convention."""
    stem = os.path.join(root, category, f"{category}_{index:04d}")
    points = np.loadtxt(stem + ".txt", delimiter=",")
    rot = np.loadtxt(stem + "_rot.txt", delimiter=",")
    tran = np.loadtxt(stem + "_tran.txt", delimiter=",")
    return points, rot, tran


def save_ply(path: str, points: np.ndarray) -> None:
    """ASCII PLY: xyz, and rgb when the cloud has 6 channels (colours in [0, 1])."""
    pts = np.asarray(points)
    has_color = pts.shape[1] >= 6
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p in pts:
            row = f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
            if has_color:
                rgb = (np.clip(p[3:6], 0, 1) * 255).astype(int)
                row += f" {rgb[0]} {rgb[1]} {rgb[2]}"
            f.write(row + "\n")


def load_ply(path: str) -> np.ndarray:
    """ASCII or binary little-endian PLY vertex cloud -> float64 ``[N, 3]``,
    or ``[N, 6]`` with rgb scaled into [0, 1]."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n, fmt, props, in_vertex = 0, "ascii", [], False
        for line in header:
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                in_vertex = line.startswith("element vertex")
                if in_vertex:
                    n = int(line.split()[-1])
            elif line.startswith("property") and in_vertex:
                props.append(tuple(line.split()[1:]))
        names = [p[-1] for p in props]
        if fmt == "ascii":
            data = np.loadtxt([f.readline().decode("ascii") for _ in range(n)],
                              dtype=np.float64).reshape(n, len(props))
        else:
            np_types = {"float": "<f4", "double": "<f8", "uchar": "u1", "int": "<i4"}
            dt = np.dtype([(p[-1], np_types[p[0]]) for p in props])
            raw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt)
            data = np.column_stack([raw[name].astype(np.float64) for name in names])
    out = data[:, [names.index(c) for c in ("x", "y", "z")]]
    if {"red", "green", "blue"} <= set(names):
        rgb = data[:, [names.index(c) for c in ("red", "green", "blue")]] / 255.0
        out = np.column_stack([out, rgb])
    return out


def load_cloud(path: str) -> np.ndarray:
    """A saved frame: ``.ply`` through ``load_ply``, else a text file of one
    point a row, comma- or space-separated."""
    if path.endswith(".ply"):
        return load_ply(path)
    with open(path) as f:
        comma = "," in f.readline()
    return np.loadtxt(path, delimiter="," if comma else None)


class ReplayCamera:
    """Serves saved frames (``.ply`` or text) in order where no RealSense
    exists; ``get_cloud`` returns None after the last."""

    def __init__(self, paths: list[str]):
        self.paths = list(paths)
        self._i = 0

    def get_cloud(self) -> np.ndarray | None:
        if self._i >= len(self.paths):
            return None
        self._i += 1
        return load_cloud(self.paths[self._i - 1])

    def __iter__(self):
        while (cloud := self.get_cloud()) is not None:
            yield cloud
