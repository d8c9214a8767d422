"""Dataset build, pack, load and batch iteration (counterpart of
``data/dataset.py`` of the JAX package).

- generation: the dense surface lattices of ``generators`` are padded,
  stacked and sampled down to ``n_points`` by FPS in batch on the device
  (``kernels.fps``); rotation and translation are applied after sampling.
- split: the reference's 6001/8000 train/test ratio per class, for any
  per-class count.
- loading: ``load_dataset`` applies the loader's sign convention,
  ``sign = sign(rot_z)`` and ``rot_z = |rot_z|``; ``load_reference_layout``
  reads the reference's txt-per-cloud tree with the same split and
  convention.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Iterator

import numpy as np
import torch

from pointnet_like_pose_estimation_tpu_torch.data import generators
from pointnet_like_pose_estimation_tpu_torch.data.generators import CATEGORIES
from pointnet_like_pose_estimation_tpu_torch.ops import farthest_point_sample, index_points
from pointnet_like_pose_estimation_tpu_torch.pipeline import native_dbscan
from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PoseDataset:
    """In-memory dataset: the loader 5-tuple, and the width, as arrays.

    points: [M, N, 3] float32 (axis-aligned FPS'd, then rotated+translated)
    labels: [M] int32 category ids (CATEGORIES order)
    rot:    [M, 3] float32 Euler degrees, z-component absolute
    tran:   [M, 3] float32 meters
    sign:   [M] float32 sign of the original z Euler angle (+-1 or 0)
    width:  [M] float32 grasp width in meters, the smallest horizontal
            extent of the axis-aligned surface
    """

    points: np.ndarray
    labels: np.ndarray
    rot: np.ndarray
    tran: np.ndarray
    sign: np.ndarray
    width: np.ndarray | None = None

    def __post_init__(self):
        if self.width is None:
            self.width = np.zeros((len(self.labels),), np.float32)

    def __len__(self) -> int:
        return len(self.labels)


_FPS_CHUNK = 64


def _batched_fps(dense: list[np.ndarray], n_points: int, device="cuda") -> np.ndarray:
    """FPS a ragged list of dense clouds to ``n_points`` each, on ``device``.

    Clouds are padded to a multiple of 1024 points by repeating their first
    point: a duplicate at distance zero is never selected before every real
    point, so the padding is invisible to FPS. A cloud of any size is taken.
    """
    device = resolve_device(device, "_batched_fps")
    out = np.empty((len(dense), n_points, 3), dtype=np.float32)
    for lo in range(0, len(dense), _FPS_CHUNK):
        chunk = dense[lo:lo + _FPS_CHUNK]
        pad_len = -(-max(len(c) for c in chunk) // 1024) * 1024
        batch = np.stack(
            [np.concatenate([c, np.tile(c[:1], (pad_len - len(c), 1))]) for c in chunk]
        ).astype(np.float32)
        pts = torch.from_numpy(batch).to(device)
        sampled = index_points(pts, farthest_point_sample(pts, n_points))
        out[lo:lo + len(chunk)] = sampled.cpu().numpy()
    return out


def build_dataset(
    num_per_class: int,
    *,
    seed: int = 0,
    n_points: int = 1024,
    categories=CATEGORIES,
    path: str | None = None,
    device="cuda",
) -> str | dict:
    """Generate the synthetic 7-class pose dataset: the lattices one by one
    on the host, FPS in batch on ``device``.

    Returns the npz path if ``path`` is given, else the dict of fields.
    """
    rng = np.random.default_rng(seed)
    all_pts, labels, rots, trans, widths = [], [], [], [], []
    for label, cat in enumerate(categories):
        dense, params = [], []
        for _ in range(num_per_class):
            p = generators.sample_category_params(cat, rng)
            dense.append(generators.dense_surface(p))
            params.append(p)
            # grasp width: smallest horizontal extent of the axis-aligned
            # surface (cube -> side, cylinder -> diameter)
            widths.append(float(np.ptp(dense[-1][:, :2], axis=0).min()))
        sampled = _batched_fps(dense, n_points, device)       # [n, N, 3] axis-aligned
        for i, p in enumerate(params):
            ang = np.radians([p["phi"], p["theta"], p["psi"]])
            c, s = np.cos(ang), np.sin(ang)
            Rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
            Ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
            Rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
            R = Rx @ Ry @ Rz
            t = np.array([p["px"], p["py"], p["pz"]])
            all_pts.append((sampled[i] @ R.T + t).astype(np.float32))
            rots.append([p["phi"], p["theta"], p["psi"]])
            trans.append(t)
            labels.append(label)
    fields = {
        "points": np.stack(all_pts),
        "labels": np.asarray(labels, np.int32),
        "rot": np.asarray(rots, np.float32),
        "tran": np.asarray(trans, np.float32),
        "width": np.asarray(widths, np.float32),
        "num_per_class": np.asarray(num_per_class),
    }
    if path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **fields)
        return path
    return fields


def _split_count(n: int) -> int:
    """Per-class train count that keeps the reference's 6001/8000 ratio."""
    return max(1, min(n - 1, round(n * 6001 / 8000))) if n > 1 else n


def load_dataset(src: str | dict, split: str = "train") -> PoseDataset:
    """Load a packed dataset and apply the loader-side sign convention."""
    data = dict(np.load(src)) if isinstance(src, str) else src
    n = int(data["num_per_class"])
    per_class_idx = np.arange(n) < _split_count(n)
    keep = np.tile(per_class_idx if split == "train" else ~per_class_idx, len(data["labels"]) // n)
    rot = data["rot"][keep].copy()
    sign = np.sign(rot[:, 2]).astype(np.float32)
    rot[:, 2] = np.abs(rot[:, 2])
    width = data["width"][keep] if "width" in data else np.zeros((int(keep.sum()),), np.float32)
    return PoseDataset(
        points=data["points"][keep],
        labels=data["labels"][keep],
        rot=rot,
        tran=data["tran"][keep],
        sign=sign,
        width=width,
    )


def _read_csv(paths: list[str], max_rows: int, cols: int) -> tuple[np.ndarray, np.ndarray]:
    """``native_dbscan.load_csv_files``, raising for a file it cannot read."""
    values, rows = native_dbscan.load_csv_files(paths, max_rows, cols)
    if (rows < 0).any():
        bad = [p for p, r in zip(paths, rows) if r < 0]
        raise FileNotFoundError(f"unreadable sample files: {bad[:3]}...")
    return values, rows


def load_reference_layout(
    root: str,
    split: str = "train",
    *,
    num_points: int = 1024,
    categories: list[str] | None = None,
    rng: np.random.Generator | None = None,
    max_file_points: int = 2048,
) -> PoseDataset:
    """A dataset stored in the reference's txt-per-cloud tree
    (``<root>/<cat>/<cat>_NNNN.txt`` with ``_rot.txt`` and ``_tran.txt``)
    as a ``PoseDataset``: per class, the first 6001/8000 of the sorted
    samples are the train split. The files are parsed on the native thread
    pool (``native_dbscan.load_csv_files``), at most ``max_file_points``
    rows a cloud. Each cloud is sampled to ``num_points`` from ``rng``,
    without replacement where it holds enough points (with replacement
    otherwise), and the loader's sign convention is applied."""
    categories = categories or CATEGORIES
    rng = rng or np.random.default_rng(0)
    pt_paths, rot_paths, tran_paths, labels = [], [], [], []
    for ci, cat in enumerate(categories):
        stems = sorted(
            p[: -len(".txt")]
            for p in glob.glob(os.path.join(root, cat, f"{cat}_*.txt"))
            if not p.endswith(("_rot.txt", "_tran.txt"))
        )
        n_train = _split_count(len(stems))
        keep = stems[:n_train] if split == "train" else stems[n_train:]
        pt_paths += [s + ".txt" for s in keep]
        rot_paths += [s + "_rot.txt" for s in keep]
        tran_paths += [s + "_tran.txt" for s in keep]
        labels += [ci] * len(keep)
    if not pt_paths:
        raise FileNotFoundError(f"no reference-layout samples under {root}")
    raw, counts = _read_csv(pt_paths, max_file_points, 3)
    rot = _read_csv(rot_paths, 1, 3)[0][:, 0]
    tran = _read_csv(tran_paths, 1, 3)[0][:, 0]
    points = np.empty((len(raw), num_points, 3), np.float32)
    for i in range(len(raw)):
        n = int(counts[i])
        sel = (rng.choice(n, num_points, replace=False) if n >= num_points
               else rng.choice(max(n, 1), num_points, replace=True))
        points[i] = raw[i, sel]
    sign = np.sign(rot[:, 2]).astype(np.float32)
    rot = rot.copy()
    rot[:, 2] = np.abs(rot[:, 2])
    return PoseDataset(points=points, labels=np.asarray(labels, np.int32), rot=rot, tran=tran,
                       sign=sign)


def iter_batches(
    ds: PoseDataset,
    batch_size: int,
    *,
    rng: np.random.Generator | None = None,
    drop_last: bool = True,
) -> Iterator[dict]:
    """Yield dict batches of host arrays, shuffled when ``rng`` is given."""
    order = np.arange(len(ds))
    if rng is not None:
        rng.shuffle(order)
    stop = len(order) - (len(order) % batch_size if drop_last else 0)
    for lo in range(0, stop, batch_size):
        sel = order[lo:lo + batch_size]
        yield {
            "points": ds.points[sel],
            "labels": ds.labels[sel],
            "rot": ds.rot[sel],
            "tran": ds.tran[sel],
            "sign": ds.sign[sel],
            "width": ds.width[sel][:, None],
        }
