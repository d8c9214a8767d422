"""The one traffic generator. A mix is a data file under ``traffic/`` that
names its ``kind`` and its parameters; these functions turn it and a seed
into the inputs of a run. The same seed gives the same inputs, and every
seed gives the same amount of work: the sizes and counts come from the
mix, the seed draws only shapes, poses, noise and order.

- ``cluster_pool``: requests of K clusters of M points, each cluster the
  camera-facing half of one surface of a category drawn from the 7, with
  the generator's own size and pose draws.
- ``camera``: raw frames of a camera on a schedule: a scene (a table, far
  outliers and objects standing on it) changes every ``scene_seconds``;
  each frame of a scene has its own depth noise and loses its own share of
  points. ``synthetic_frame`` and ``camera_frames`` of ``chip_smoke.py``
  at commit aa745b2, with a scene's objects drawn from the 7 categories.
- ``training_split``: the resident split, ``per_class`` clouds of each
  category, as ``cli generate`` builds it (whole surfaces posed by the
  generator's draws), each sampled to ``num_points`` points at random.
"""

from __future__ import annotations

import numpy as np

from harness import surfaces

CATEGORIES = surfaces.CATEGORIES


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *salt])


def _rotations(deg: np.ndarray) -> np.ndarray:
    """``[n, 3, 3]``: ``Rx @ Ry @ Rz`` of ``[n, 3]`` (phi, theta, psi) degrees,
    the dataset builder's pose."""
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones(len(a)), np.zeros(len(a))
    rx = np.stack([o, z, z, z, c[:, 0], -s[:, 0], z, s[:, 0], c[:, 0]], -1).reshape(-1, 3, 3)
    ry = np.stack([c[:, 1], z, s[:, 1], z, o, z, -s[:, 1], z, c[:, 1]], -1).reshape(-1, 3, 3)
    rz = np.stack([c[:, 2], -s[:, 2], z, s[:, 2], c[:, 2], z, z, z, o], -1).reshape(-1, 3, 3)
    return rx @ ry @ rz


def _sample(points: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` of ``points`` at random, with replacement only where there are fewer."""
    return points[rng.choice(len(points), n, replace=len(points) < n)]


def _posed(clouds: list[np.ndarray], params: list[dict]) -> np.ndarray:
    deg = np.array([[p["phi"], p["theta"], p["psi"]] for p in params])
    t = np.array([[p["px"], p["py"], p["pz"]] for p in params])
    return (np.einsum("bnj,bij->bni", np.stack(clouds), _rotations(deg)) + t[:, None]).astype(np.float32)


def _categories(count: int, rng: np.random.Generator) -> np.ndarray:
    """``count`` category ids, each category as often as the others within
    one, in an order drawn from ``rng``."""
    return rng.permutation(np.arange(count) % len(CATEGORIES))


def cluster_pool(mix: dict, seed: int) -> np.ndarray:
    """``[requests, K, M, 3]`` float32: ``mix["requests"]`` requests of
    ``mix["clusters"]`` clusters of ``mix["points"]`` points."""
    R, K, M = mix["requests"], mix["clusters"], mix["points"]
    rng = _rng(seed, 1)
    clouds, params = [], []
    for cat in _categories(R * K, rng):
        p = surfaces.sample_category_params(CATEGORIES[cat], rng)
        clouds.append(_sample(surfaces.clip_half(surfaces.dense_surface(p)), M, rng))
        params.append(p)
    return _posed(clouds, params).reshape(R, K, M, 3)


def training_split(mix: dict, seed: int) -> dict[str, np.ndarray]:
    """``{"points": [7 * per_class, num_points, 3] float32, "labels": int64}``."""
    n, per = mix["num_points"], mix["per_class"]
    rng = _rng(seed, 2)
    clouds, params, labels = [], [], []
    for label, cat in enumerate(CATEGORIES):
        for _ in range(per):
            p = surfaces.sample_category_params(cat, rng)
            clouds.append(_sample(surfaces.dense_surface(p), n, rng))
            params.append(p)
            labels.append(label)
    return {"points": _posed(clouds, params), "labels": np.asarray(labels, np.int64)}


# --- a camera -----------------------------------------------------------------------------


def scene(mix: dict, categories, rng: np.random.Generator) -> np.ndarray:
    """A raw frame: a table of ``table_points`` 0.7 m from the camera (sd
    1.5 mm) over 1 m x 1 m, one object of each of ``categories`` (the
    camera-facing half of its surface, at most ``object_points`` of its
    points, drawn without replacement as ``synthetic_frame`` draws them)
    standing in front of it in distinct slots of a grid, and
    ``far_outliers`` points far behind. Made in ``synthetic_frame``'s
    convention (z negative), then mirrored to the positive depth that
    ``PipelineConfig``'s default distance cut keeps."""
    nt = mix["table_points"]
    table = np.column_stack([rng.uniform(-0.5, 0.5, nt), rng.uniform(-0.5, 0.5, nt),
                             -0.7 + rng.normal(0, 0.0015, nt)])
    slots = np.array(mix["slots"], float)[rng.choice(len(mix["slots"]), len(categories), replace=False)]
    objects = []
    for cat, (x, y) in zip(categories, slots):
        dense = surfaces.clip_half(surfaces.dense_surface(surfaces.sample_category_params(CATEGORIES[cat], rng)))
        dense = dense[rng.choice(len(dense), min(mix["object_points"], len(dense)), replace=False)]
        objects.append(dense + np.array([x, y, -0.66]))
    far = rng.uniform(-1, 1, (mix["far_outliers"], 3)) + [0, 0, -1.5]
    frame = np.concatenate([table, *objects, far]).astype(np.float32)
    frame[:, 2] *= -1
    return frame


def camera(mix: dict, seed: int, seconds: float,
           rate: float) -> tuple[list[np.ndarray], list[int], list[np.ndarray]]:
    """The frames due in ``[0, seconds)`` of a camera at ``rate`` frames/s,
    one every ``1 / rate`` s, the scene of each, and the frames that set-up
    serves first. The scenes hold the object counts of ``mix["objects"]``
    in turn and the 7 categories in turn, each in an order drawn from the
    seed; frame ``i`` of a scene keeps each point with probability ``1 -
    u``, ``u`` drawn from ``[0, max_dropout)``, and moves its depth by
    N(0, ``depth_sd``).

    The set-up frames are drawn apart from the window's, so that the
    window serves no frame twice: ``mix.get("warm_frames", 0)`` of each
    scene, with depth noise of their own and shares lost spread evenly over
    ``[0, max_dropout]``; the whole frame of every scene comes first, in
    the schedule's order (it grows the scene program's cloud buffer to the
    size the window needs), then the others scene by scene."""
    count = int(np.ceil(seconds * rate))
    per_scene = max(1, int(round(mix["scene_seconds"] * rate)))
    n_scenes = -(-count // per_scene)
    rng = _rng(seed, 3)
    counts = [mix["objects"][j % len(mix["objects"])] for j in range(n_scenes)]
    counts = [counts[i] for i in rng.permutation(n_scenes)]
    cats = _categories(sum(counts), rng)
    ends = np.cumsum(counts)
    bases = [scene(mix, cats[e - n:e], _rng(seed, 4, j)) for j, (n, e) in enumerate(zip(counts, ends))]

    def frame(base, r, u=None):
        keep = r.random(len(base))
        f = base[keep >= (r.uniform(0, mix["max_dropout"]) if u is None else u)]
        f[:, 2] += r.normal(0, mix["depth_sd"], len(f)).astype(np.float32)
        return f

    frames, scene_of = [], []
    for i in range(count):
        frames.append(frame(bases[i // per_scene], _rng(seed, 5, i)))
        scene_of.append(i // per_scene)
    W = mix.get("warm_frames", 0)
    shares = np.linspace(0, mix["max_dropout"], W) if W > 1 else np.zeros(W)
    warm = [[frame(base, _rng(seed, 6, j, k), u) for k, u in enumerate(shares)] for j, base in enumerate(bases)]
    warm = [w[0] for w in warm if w] + [f for w in warm for f in w[1:]]
    return frames, scene_of, warm
