"""The ModelNet10/40 loader (counterpart of ``data/modelnet.py`` of the JAX
package).

The tree is the reference's: ``modelnet{10,40}_shape_names.txt``, the split
lists ``modelnet{10,40}_{split}.txt`` and ``<shape>/<shape>_NNNN.txt``, CSV
rows of x, y, z, nx, ny, nz. Each cloud is either cut to its first
``npoints`` rows or, with ``uniform``, resampled by FPS over its xyz in
batch on the device (``dataset._batched_fps``, the FPS kernel on a card);
the sampled rows are matched back to their source rows for the normals.
The xyz of each cloud is then centred and scaled into the unit sphere. The
result is cached beside the tree as ``.npz``, under the JAX package's name
and layout.
"""

from __future__ import annotations

import os

import numpy as np

from pointnet_like_pose_estimation_tpu_torch.data.dataset import PoseDataset, _batched_fps
from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Subtract the cloud's centroid and scale it into the unit sphere."""
    centroid = np.mean(pc, axis=0)
    pc = pc - centroid
    m = np.max(np.sqrt(np.sum(pc**2, axis=1)))
    return pc / m


class ModelNetDataset:
    """Array-backed ModelNet split: after loading, ``points`` ``[M, npoints,
    3 or 6]`` float32 (normalised xyz, then the normals with
    ``use_normals``) and ``labels`` ``[M]`` int32. The FPS of ``uniform``
    runs on ``device``: the card unless the caller asks for the CPU."""

    def __init__(
        self,
        root: str,
        num_category: int = 40,
        split: str = "train",
        npoints: int = 1024,
        uniform: bool = False,
        use_normals: bool = False,
        cache: bool = True,
        device="cuda",
    ):
        device = resolve_device(device, "ModelNetDataset")
        self.root = root
        self.npoints = npoints
        self.uniform = uniform
        self.use_normals = use_normals
        with open(os.path.join(root, f"modelnet{num_category}_shape_names.txt")) as f:
            self.cat = [line.rstrip() for line in f]
        self.classes = dict(zip(self.cat, range(len(self.cat))))
        with open(os.path.join(root, f"modelnet{num_category}_{split}.txt")) as f:
            ids = [line.rstrip() for line in f]
        names = ["_".join(x.split("_")[:-1]) for x in ids]
        self.datapath = [(names[i], os.path.join(root, names[i], ids[i]) + ".txt")
                         for i in range(len(ids))]

        tag = "fps" if uniform else "head"
        cache_path = os.path.join(root, f"modelnet{num_category}_{split}_{npoints}pts_{tag}.npz")
        if cache and os.path.exists(cache_path):
            data = np.load(cache_path)
            self.points, self.labels = data["points"], data["labels"]
            return

        raw, labels = [], []
        for name, path in self.datapath:
            raw.append(np.loadtxt(path, delimiter=",").astype(np.float32))
            labels.append(self.classes[name])
        if uniform:
            sampled = _batched_fps([p[:, :3] for p in raw], npoints, device)
            # the sampled xyz rows are copies of source rows: find them for the normals
            raw = [p[_match_rows(p[:, :3], s)] if p.shape[1] > 3 else s
                   for p, s in zip(raw, sampled)]
        else:
            raw = [p[:npoints] for p in raw]
        pts = np.stack(raw).astype(np.float32)
        pts[..., :3] = np.stack([pc_normalize(p[:, :3]) for p in pts])
        if not use_normals:
            pts = pts[..., :3]
        self.points, self.labels = pts, np.asarray(labels, np.int32)
        if cache:
            np.savez_compressed(cache_path, points=self.points, labels=self.labels)

    def __len__(self):
        return len(self.labels)

    def as_pose_dataset(self) -> PoseDataset:
        """The split as the training loop's dataset, with zero pose targets."""
        m = len(self.labels)
        return PoseDataset(
            points=self.points[..., :3],
            labels=self.labels,
            rot=np.zeros((m, 3), np.float32),
            tran=np.zeros((m, 3), np.float32),
            sign=np.ones(m, np.float32),
        )


def _match_rows(source: np.ndarray, sampled: np.ndarray) -> np.ndarray:
    """Indices of the ``sampled`` xyz rows within ``source`` (exact match)."""
    lookup = {tuple(row): i for i, row in enumerate(np.asarray(source))}
    return np.asarray([lookup[tuple(row)] for row in np.asarray(sampled)], np.int64)
