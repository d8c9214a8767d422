"""The grasp pipeline in plain PyTorch and NumPy: a request's resampling
and five models, and a raw frame's clip, RANSAC plane, radius test, DBSCAN
and truncation. Frozen from the port's plain code at commit aa745b2
(``pipeline/infer.py``, ``pipeline/preprocess.py``), with DBSCAN written
anew: the port's runs on the host in its native library, this one forms
the same float64 neighbourhoods on the device and labels clusters by
connected components, which gives Open3D's labels (clusters numbered by
their first core point, a border point in the lowest-numbered cluster that
reaches it). Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import geometry as G
from reference.models import build

KEYS = {"classifier": "pointnet2_cls_ssg", "rotation": "rotation", "sign": "sign",
        "translation": "translation", "width": "width"}
# pairs held by one block of distance tests
BLOCK_ELEMS = 1 << 24


class GraspReference:
    """The five models of a grasp request from ``states`` (a ``state_dict``
    per key of ``KEYS``), computing their Linear layers in ``dtype``."""

    def __init__(self, states: dict, num_points: int, num_classes: int, dtype: str, device):
        self.num_points, self.num_classes, self.device = num_points, num_classes, torch.device(device)
        self.models = {}
        for key, name in KEYS.items():
            m = build(name, num_classes, dtype)
            m.load_state_dict(states[key], strict=True)
            self.models[key] = m.to(self.device).eval()

    def resample(self, xyz: torch.Tensor) -> torch.Tensor:
        """``[K, M, 3]`` -> ``[K, num_points, 3]``: FPS from the first point
        when M is larger, the cloud repeated when smaller."""
        n, M = self.num_points, xyz.shape[1]
        if M == n:
            return xyz
        if M > n:
            return G.index_points(xyz, G.fps(xyz, n))
        return xyz[:, torch.arange(n, device=xyz.device) % M]

    @torch.no_grad()
    def infer(self, xyz: torch.Tensor, served_class=None, served_sign=None) -> dict:
        """Grasps of ``[K, num_points, 3]`` clouds. ``served_class`` and
        ``served_sign`` replace the reference's own class and hard sign
        where the heads and the signed rotation use them, so that a served
        answer is judged on the decisions it made."""
        m = self.models
        mean = xyz.mean(dim=1)
        normed = G.normalize_cloud(xyz)
        log_probs, _, pred = m["classifier"](normed)
        cls = pred if served_class is None else served_class.to(xyz.device)
        onehot = torch.nn.functional.one_hot(cls.long(), self.num_classes).to(normed.dtype)
        spliced = torch.cat([normed, onehot[:, None, :].expand(-1, normed.shape[1], -1)], dim=-1)
        rot = m["rotation"](spliced).float()
        prob, hard = m["sign"](spliced)
        tran = m["translation"](spliced, mean).float()
        width = m["width"](spliced).float()
        sign = hard[:, 0] if served_sign is None else served_sign.to(xyz.device)
        signed = torch.cat([rot[:, :2], rot[:, 2:] * sign[:, None]], dim=1)
        return {"log_probs": log_probs, "pred_class": pred, "rotation_deg": signed,
                "rotation_matrix": G.euler_rotation_matrix(torch.deg2rad(signed)),
                "sign_prob": prob[:, 0], "hard_sign": hard[:, 0], "translation": tran, "width": width[:, 0]}


# --- raw frames ---------------------------------------------------------------------------


def _sq_norms(p):
    return p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]


def _plane_dist(xyz, normals, offsets):
    t = xyz[:, None, 0] * normals[None, :, 0] + xyz[:, None, 1] * normals[None, :, 1]
    return (t + xyz[:, None, 2] * normals[None, :, 2] + offsets[None, :]).abs()


def _blocks(n_rows: int, n_cols: int):
    step = max(1, BLOCK_ELEMS // max(n_cols, 1))
    return range(0, n_rows, step), step


def clean(points: np.ndarray, cfg: dict, device) -> np.ndarray | None:
    """Clip on ``clip_axis``, then the RANSAC plane's outliers (1,000 triples
    drawn with replacement from ``torch.Generator().manual_seed(0)``, the
    first best count winning) and among them the points with at least
    ``radius_nb_points`` others within ``radius``. None where fewer than
    ``min_points`` remain after either step."""
    lo, hi = cfg["clip_range"]
    ax = cfg["clip_axis"]
    pts = points[(points[:, ax] >= lo) & (points[:, ax] <= hi)]
    if len(pts) < cfg["min_points"]:
        return None
    xyz = torch.from_numpy(np.ascontiguousarray(pts[:, :3], np.float32)).to(device)
    gen = torch.Generator().manual_seed(0)
    triples = torch.randint(0, len(pts), (cfg["plane_iterations"], 3), generator=gen).to(device)
    tri = xyz[triples]
    a, b = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    n = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1], a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    n = n / (torch.sqrt(_sq_norms(n).double()).float()[:, None] + 1e-12)
    t0 = tri[:, 0]
    d = -(n[:, 0] * t0[:, 0] + n[:, 1] * t0[:, 1] + n[:, 2] * t0[:, 2])
    thr = np.float32(cfg["plane_threshold"])
    blocks, step = _blocks(len(n), len(xyz))
    counts = torch.cat([(_plane_dist(xyz, n[i:i + step], d[i:i + step]) <= thr).sum(0) for i in blocks])
    best = torch.argmax(counts)
    rows = torch.nonzero(_plane_dist(xyz, n[best][None], d[best][None])[:, 0] > thr)[:, 0]
    sub = xyz[rows]
    sq = _sq_norms(sub)
    r2 = np.float32(cfg["radius"]) * np.float32(cfg["radius"])
    blocks, step = _blocks(len(sub), len(sub))
    within = []
    for i in blocks:
        r = sub[i:i + step]
        dot = r[:, None, 0] * sub[None, :, 0] + r[:, None, 1] * sub[None, :, 1]
        dot = dot + r[:, None, 2] * sub[None, :, 2]
        within.append((((sq[i:i + step, None] - 2.0 * dot) + sq[None, :]) <= r2).sum(1) - 1)
    counts = torch.cat(within) if within else torch.zeros(0, dtype=torch.long, device=device)
    out = pts[rows[counts >= cfg["radius_nb_points"]].cpu().numpy()]
    return None if len(out) < cfg["min_points"] else out


def dbscan(points: np.ndarray, eps: float, min_points: int, device) -> np.ndarray:
    """int64 labels (-1 noise). A point is core when at least
    ``min_points`` points, itself included, lie within ``eps`` (float64,
    ``dx*dx + dy*dy + dz*dz <= eps*eps``); clusters are the connected
    components of core points, numbered by their lowest index; a border
    point takes the lowest cluster number among its core neighbours."""
    x = torch.from_numpy(np.asarray(points[:, :3], np.float64)).to(device)
    N = len(x)
    eps2 = float(eps) * float(eps)
    blocks, step = _blocks(N, N)
    counts = torch.empty(N, dtype=torch.long, device=device)
    rows, cols = [], []
    for lo in blocks:
        b = x[lo:lo + step]
        t = x[None, :, 0] - b[:, None, 0]
        d2 = t * t
        t = x[None, :, 1] - b[:, None, 1]
        d2 = d2 + t * t
        t = x[None, :, 2] - b[:, None, 2]
        d2 = d2 + t * t
        adj = d2 <= eps2
        counts[lo:lo + step] = adj.sum(1)
        r, c = adj.nonzero(as_tuple=True)
        rows.append(r + lo)
        cols.append(c)
    r, c = torch.cat(rows), torch.cat(cols)
    core = counts >= min_points
    big = torch.iinfo(torch.long).max
    ids = torch.arange(N, device=device)
    root = torch.where(core, ids, big)
    cc = core[r] & core[c]
    rc, cc_ = r[cc], c[cc]
    while True:
        new = root.scatter_reduce(0, rc, root[cc_], reduce="amin")
        new = torch.where(core, new[torch.where(core, new, 0)], big)   # pointer jump
        if torch.equal(new, root):
            break
        root = new
    labels = torch.full((N,), -1, dtype=torch.long, device=device)
    if bool(core.any()):
        roots = torch.unique(root[core])                              # sorted: numbered by first core point
        labels[core] = torch.searchsorted(roots, root[core])
        border = ~core[r] & core[c]
        rb, cb = r[border], c[border]
        reach = torch.full((N,), big, dtype=torch.long, device=device)
        reach = reach.scatter_reduce(0, rb, labels[cb], reduce="amin")
        labels = torch.where(~core & (reach != big), reach, labels)
    return labels.cpu().numpy()


def frame_clusters(points: np.ndarray, cfg: dict, device):
    """A raw frame -> ``(truncated clusters [K, min_size, C] float32, the
    first three channels resampled to ``num_points``, a device tensor)``,
    or None where no cluster is found. Each cluster is cut by FPS from its
    first point to the smallest cluster's size."""
    pts = clean(points, cfg, device)
    if pts is None:
        return None
    labels = dbscan(pts, cfg["eps"], cfg["min_points"], device)
    if labels.max() < 0:
        return None
    groups = [np.flatnonzero(labels == c) for c in range(int(labels.max()) + 1)]
    min_size = min(map(len, groups))
    xyz = torch.from_numpy(np.ascontiguousarray(pts[:, :3], np.float32)).to(device)
    picks = [torch.from_numpy(g).to(device)[G.fps(xyz[torch.from_numpy(g).to(device)][None], min_size)[0]]
             for g in groups]
    idx = torch.stack(picks).cpu().numpy()
    clusters = np.asarray(pts, np.float32)[idx]
    return clusters, torch.from_numpy(clusters[..., :3].copy()).to(device)
