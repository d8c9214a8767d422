"""Grasp serving: a raw cloud or its clusters -> classify -> four pose
heads -> grasp (counterpart of ``pipeline/infer.py`` of the JAX package).

``__call__`` and ``stream`` take a raw cloud through the distance cut, the
plane and radius-outlier clean (``preprocess.clean_scene``), DBSCAN on the
host and the scene inference; ``infer_clusters`` serves clusters cut
elsewhere. A request resamples its clusters to ``num_points`` (FPS when
larger, tiling when smaller), normalizes them, classifies them with
``PipelineConfig.classifier`` (PointNet++ SSG by default), splices the
predicted class as a one-hot onto every point, and runs the rotation, sign,
translation and width heads that ``PipelineConfig`` names (the PointNet
heads by default), in ``PipelineConfig.dtype``; every float output is
float32.

Each request is one compiled program, as in the JAX package: on a card a
CUDA graph captured once per shape bucket and replayed
(``utils/programs.py``), on the CPU the same function called directly. The
buckets are the JAX package's. ``infer_clusters`` pads the cluster count K
to a multiple of 4 with copies of cluster 0 and, when the clusters are
larger than ``num_points``, their size M to a multiple of 256 with each
cluster's first point, and runs the resampling and the five models as one
program per (K, M) bucket. ``__call__`` and ``stream`` run everything after
DBSCAN as one program (``_scene``: the gather of the clusters, their
truncation by FPS, the resampling and the five models), with K to a
multiple of 4 and the cluster size to 256, as in the JAX package. The
cloud goes into a buffer that grows in steps of 2048 points and never
shrinks (``scene_points``), where the JAX package rounds each scene up to
2048 points: a frame whose point count falls in a smaller step than the
last one's reuses its program. The smallest cluster's size is a device
scalar, so it never forces another capture either. The pads change no real cluster's result: FPS from a cluster's
first point never picks a copy of it while real points remain, and
eval-mode BatchNorm treats every cluster on its own.

A profiler that records sees a request's stages as spans
(``utils/profiling.py`` ``span``): ``serve.upload`` (the padding into the
bucket and the copy into the program's input), ``program.replay`` and
``serve.copy_back``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.data.augment import splice_onehot
from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.models import init_like_flax as _lecun_normal_
from pointnet_like_pose_estimation_tpu_torch.nn import set_compute_dtype
from pointnet_like_pose_estimation_tpu_torch.ops import (
    euler_rotation_matrix,
    farthest_point_sample,
    index_points,
    normalize_cloud,
)
from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess as pp
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import (
    from_flax_variables,
    load_flax_checkpoint,
)
from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device
from pointnet_like_pose_estimation_tpu_torch.utils.profiling import span
from pointnet_like_pose_estimation_tpu_torch.utils.programs import ProgramCache

MODEL_KEYS = ("classifier", "rotation", "sign", "translation", "width")
# the registry task and the inputs (``ModelSpec.input_kind``) of each model key:
# the classifier takes the raw cloud, the heads the spliced cloud, and the
# translation head the cloud's centroid beside it where it has a use for it
MODEL_KINDS = {"classifier": ("classify", ("xyz",)), "rotation": ("rotation", ("spliced",)),
              "sign": ("sign", ("spliced",)), "translation": ("translation", ("spliced", "spliced_mean")),
              "width": ("width", ("spliced",))}


@dataclasses.dataclass
class PipelineConfig:
    """The JAX package's PipelineConfig: the reference's capture thresholds
    (distance cut, plane, outlier test, DBSCAN), the request size and the
    models. ``classifier`` is a registry name of task 'classify' on the raw
    cloud: ``pointnet2_cls_ssg``, ``pointnet2_cls_msg``, ``pointnet_cls`` or
    ``point_transformer_cls`` (Point Transformer, the port's own).
    ``rotation``, ``sign``, ``translation`` and ``width`` are registry
    names of the four heads (``MODEL_KINDS`` gives the task and inputs each
    key takes), the vanilla PointNet heads by default; for example
    ``rotation_msg``, ``sign_msg`` and ``translation_msg`` for the
    reference's MSG heads. ``dtype`` is the models' compute dtype,
    ``"float32"`` or ``"bfloat16"`` (BatchNorm in float32 either way)."""

    clip_range: tuple = (0.0, 2.0)
    clip_axis: int = 2
    plane_threshold: float = 0.006
    plane_iterations: int = 1000
    outlier_method: str = "radius"          # 'radius' | 'statistical' | 'none'
    radius_nb_points: int = 200
    radius: float = 0.05
    stat_nb_neighbors: int = 120
    stat_std_ratio: float = 0.1
    eps: float = 0.03
    min_points: int = 500
    num_points: int = 1024
    num_classes: int = 7
    classifier: str = "pointnet2_cls_ssg"
    rotation: str = "rotation"
    sign: str = "sign"
    translation: str = "translation"
    width: str = "width"
    dtype: str = "float32"


def request_bucket(K: int, M: int, num_points: int) -> tuple[int, int]:
    """The JAX package's bucket of a request of K clusters of M points:
    K to a multiple of 4, and M, when above ``num_points`` (the FPS
    resampling), to a multiple of 256."""
    return pp._round_up(K, 4), pp._round_up(M, 256) if M > num_points else M


def _load_weights(path: str) -> dict:
    """A ``state_dict`` from the port's ``*.pt`` or the JAX package's flax
    ``*.msgpack``."""
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)["model"]
    return from_flax_variables(load_flax_checkpoint(path))


class GraspPipeline:
    """The five models of a grasp request, on one device, computing in
    ``cfg.dtype`` (set on their Linear layers), and the request and scene
    programs that run them (``programs``)."""

    def __init__(self, cfg: PipelineConfig, models: dict[str, nn.Module], device="cuda"):
        self.device = resolve_device(device, "GraspPipeline")
        missing = set(MODEL_KEYS) - set(models)
        if missing:
            raise KeyError(f"GraspPipeline: missing models {sorted(missing)}")
        self.cfg = cfg
        self.models = {k: set_compute_dtype(models[k], cfg.dtype).to(self.device).eval() for k in MODEL_KEYS}
        # the request and scene programs, one per bucket, on one memory pool
        self.programs = ProgramCache(self.device)
        # the scene program's cloud buffer, in points: the largest scene so far rounded up to 2048
        self.scene_points = 0

    @staticmethod
    def _make(cfg: PipelineConfig, key: str) -> nn.Module:
        """The model that ``cfg`` names for ``key``; ``ValueError`` where its
        task or inputs are not those of the key (``MODEL_KINDS``)."""
        name = getattr(cfg, key)
        spec = get_model_spec(name)
        task, inputs = MODEL_KINDS[key]
        if spec.task != task or spec.input_kind not in inputs:
            if key == "classifier":
                raise ValueError(f"PipelineConfig.classifier: {name!r} does not classify raw clouds")
            raise ValueError(f"PipelineConfig.{key}: {name!r} is a {spec.task} model on {spec.input_kind} "
                             f"input; the {key} key takes a {task} model on {' or '.join(inputs)} input")
        return build_model(name, cfg.num_classes)

    @classmethod
    def from_random(cls, cfg: PipelineConfig | None = None, seed: int = 0, device="cuda"):
        """Randomly initialized models, drawn from ``torch.Generator(seed)``."""
        cfg = cfg or PipelineConfig()
        gen = torch.Generator().manual_seed(seed)
        models = {}
        for key in MODEL_KEYS:
            models[key] = cls._make(cfg, key)
            _lecun_normal_(models[key], gen)
        return cls(cfg, models, device)

    @classmethod
    def from_checkpoints(cls, cfg: PipelineConfig, checkpoint_paths: dict[str, str], device="cuda"):
        """Load trained checkpoints: the JAX package's ``best.msgpack`` or the
        port's ``best.pt``, one per key of ``MODEL_KEYS``."""
        models = {}
        for key in MODEL_KEYS:
            models[key] = cls._make(cfg, key)
            models[key].load_state_dict(_load_weights(checkpoint_paths[key]), strict=True)
        return cls(cfg, models, device)

    # --- raw frames -------------------------------------------------------------------------

    def preprocess(self, points: np.ndarray) -> np.ndarray | None:
        """Raw cloud ``[N, C >= 3]`` -> clusters ``[K, min_size, C]``, or None
        when too few points survive or DBSCAN finds no cluster."""
        cfg, dev = self.cfg, self.device
        pts = pp.clip_distance(points, cfg.clip_range, cfg.clip_axis)
        if len(pts) < cfg.min_points:
            return None
        if cfg.outlier_method == "radius":
            pts = pp.clean_scene(pts, cfg.plane_threshold, cfg.plane_iterations, cfg.radius_nb_points,
                                 cfg.radius, device=dev)
        else:
            pts = pp.remove_plane(pts, distance_threshold=cfg.plane_threshold,
                                  num_iterations=cfg.plane_iterations, device=dev)
            if cfg.outlier_method == "statistical":
                pts = pp.remove_statistical_outlier(pts, cfg.stat_nb_neighbors, cfg.stat_std_ratio,
                                                    device=dev)
        if len(pts) < cfg.min_points:
            return None
        return pp.cluster_point(pts, cfg.eps, cfg.min_points, device=dev)

    def _scene(self, xyz: torch.Tensor, idx_batch: torch.Tensor, min_size: torch.Tensor, *,
               s_bucket: int, branch: str):
        """The scene program (JAX ``_scene_infer_fn``): ``[p_bucket, 3]``
        cleaned points, ``[k_bucket, n_bucket]`` cluster gather indices and
        the smallest cluster's size (a device scalar) -> (grasp dict, global
        indices of the truncated clusters ``[k_bucket, s_bucket]``). FPS
        truncates every cluster to ``s_bucket`` points; the positions from
        ``min_size`` on are replaced by the cluster's start point, which
        holds distance 0 and loses every first-index tie, so the resampling
        FPS selects as if the clusters were cut to ``min_size``."""
        clusters = xyz[idx_batch]                                # [K_b, n_bucket, 3]
        cidx = farthest_point_sample(clusters, s_bucket).long()  # [K_b, s_bucket]
        trunc = index_points(clusters, cidx)
        keep = torch.arange(s_bucket, device=xyz.device) < min_size
        masked = torch.where(keep[None, :, None], trunc, trunc[:, :1])
        n = self.cfg.num_points
        if branch == "fps":                                      # min_size > n
            xin = index_points(masked, farthest_point_sample(masked, n))
        elif branch == "exact":                                  # min_size == n
            xin = trunc[:, :n]
        else:                                                    # min_size < n: tile
            xin = torch.index_select(masked, 1, torch.arange(n, device=xyz.device) % min_size)
        return self._infer(xin), torch.gather(idx_batch, 1, cidx)

    def _scene_call(self, pts: np.ndarray, labels: np.ndarray):
        """The scene program's ``(key, fn, inputs)`` for a cleaned cloud and
        its DBSCAN labels (at least one cluster), with the cluster count and
        the smallest cluster's size: the JAX package's buckets, the index
        table built on the host (``preprocess.bucketed_groups``), the cloud
        padded with zeros to ``scene_points``, grown first to this cloud's
        size rounded up to 2048 where it is smaller; ``branch`` resamples
        the truncated clusters by FPS above ``num_points``, takes them as
        they are at it and tiles them below."""
        groups = pp.cluster_groups(labels)
        idx, sb = pp.bucketed_groups(groups)
        min_size, n = min(map(len, groups)), self.cfg.num_points
        branch = "fps" if min_size > n else ("exact" if min_size == n else "tile")
        self.scene_points = max(self.scene_points, pp._round_up(len(pts), 2048))
        xyz = np.zeros((self.scene_points, 3), np.float32)
        xyz[:len(pts)] = pts[:, :3]
        fn = functools.partial(self._scene, s_bucket=sb, branch=branch)
        inputs = (torch.from_numpy(xyz), torch.from_numpy(idx), torch.tensor(min_size))
        return ("scene", *idx.shape, sb, len(xyz), branch), fn, inputs, len(groups), min_size

    def _infer_scene(self, pts: np.ndarray, labels: np.ndarray) -> dict[str, np.ndarray] | None:
        """A cleaned cloud and its DBSCAN labels -> the scene's grasps, with
        ``clusters`` (the truncated clusters, all channels), through the
        scene program. None when DBSCAN found no cluster."""
        if labels.max() < 0:
            return None
        key, fn, inputs, K, min_size = self._scene_call(pts, labels)
        out, cglobal = self.programs(key, fn, inputs)
        res = {k: v[:K].cpu().numpy() for k, v in out.items()}
        res["clusters"] = pts[cglobal[:K, :min_size].cpu().numpy()]
        return res

    def __call__(self, points: np.ndarray) -> dict[str, np.ndarray] | None:
        """Raw cloud -> grasps of every cluster, with ``clusters`` (the
        truncated clusters, all channels), or None when no cluster is found."""
        with torch.inference_mode():
            cfg = self.cfg
            if cfg.outlier_method != "radius":
                clusters = self.preprocess(points)
                if clusters is None:
                    return None
                return {**self.infer_clusters(clusters), "clusters": clusters}
            pts = pp.clip_distance(points, cfg.clip_range, cfg.clip_axis)
            if len(pts) < cfg.min_points:
                return None
            pts = pp.clean_scene(pts, cfg.plane_threshold, cfg.plane_iterations, cfg.radius_nb_points,
                                 cfg.radius, device=self.device)
            if len(pts) < cfg.min_points:
                return None
            return self._infer_scene(pts, pp.dbscan(pts, cfg.eps, cfg.min_points))

    def stream(self, scenes):
        """Serve raw clouds in order, one ``__call__`` result (or None) each.
        The JAX package keeps one frame of look-behind here, so that one
        frame's DBSCAN runs on the host while the device works on the
        next; on the H100 the port's form of it was slower than this loop
        (PERF.md, Findings, PR 6), so frames are served one after another."""
        for points in scenes:
            yield self(points)

    # --- clusters ---------------------------------------------------------------------------

    def _resample_tensor(self, xyz: torch.Tensor) -> torch.Tensor:
        """``[K, M, 3]`` device clusters -> ``[K, num_points, 3]``: FPS from
        the first point when M is larger, tiling when smaller."""
        K, M, _ = xyz.shape
        n = self.cfg.num_points
        if M == n:
            return xyz
        if M > n:
            return index_points(xyz, farthest_point_sample(xyz, n))
        return xyz.repeat(1, -(-n // M), 1)[:, :n]

    def _request(self, xyz: torch.Tensor) -> dict[str, torch.Tensor]:
        """The request program (JAX ``_resample`` and ``_infer_fn``):
        bucketed ``[K_b, M_b, 3]`` clusters -> the grasp dict."""
        return self._infer(self._resample_tensor(xyz))

    def _request_call(self, clusters: np.ndarray):
        """The request program's ``(key, fn, inputs)`` for host clusters
        ``[K, M, C]``, with K: the clusters padded on the host to their
        bucket (``request_bucket``), M with each cluster's first point and K
        with copies of cluster 0."""
        K, M, _ = clusters.shape
        kb, mb = request_bucket(K, M, self.cfg.num_points)
        xyz = np.empty((kb, mb, 3), np.float32)
        xyz[:K, :M] = clusters[..., :3]
        xyz[:K, M:] = clusters[:, :1, :3]
        xyz[K:] = xyz[:1]
        return ("request", kb, mb), self._request, (torch.from_numpy(xyz),), K

    def _infer(self, xyz: torch.Tensor) -> dict[str, torch.Tensor]:
        m = self.models
        mean = xyz.mean(dim=1)                                # translation residual input
        normed = normalize_cloud(xyz)
        log_probs, _, pred_class = m["classifier"](normed)
        spliced = splice_onehot(normed, pred_class, self.cfg.num_classes)
        rot = m["rotation"](spliced).float()                  # [K, 3] euler deg, |z|
        sign_prob, hard_sign = m["sign"](spliced)             # [K, 1] each, float32
        tran = m["translation"](spliced, mean).float()        # [K, 3]
        width = m["width"](spliced).float()                   # [K, 1]
        # recompose the signed z angle, then the grasp rotation matrix
        signed_rot = torch.cat([rot[:, :2], rot[:, 2:] * hard_sign], dim=1)
        return {
            "log_probs": log_probs,
            "pred_class": pred_class.to(torch.int32),
            "rotation_deg": signed_rot,
            "rotation_matrix": euler_rotation_matrix(torch.deg2rad(signed_rot)),
            "sign_prob": sign_prob[:, 0],
            "translation": tran,
            "width": width[:, 0],
        }

    def infer_clusters(self, clusters: np.ndarray) -> dict[str, np.ndarray]:
        """Clusters ``[K, M, C]`` -> grasp estimates as host numpy arrays,
        under the keys of the JAX package's ``infer_clusters``, through the
        request program of their bucket."""
        with span("serve.upload"):
            key, fn, inputs, K = self._request_call(clusters)
            prog = self.programs.load(key, fn, inputs)
        out = self.programs.replay(prog)
        with span("serve.copy_back"):
            return {k: v[:K].cpu().numpy() for k, v in out.items()}
