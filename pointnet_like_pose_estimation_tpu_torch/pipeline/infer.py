"""Grasp serving: clusters -> classify -> four pose heads -> grasp.

Counterpart of ``GraspPipeline.infer_clusters`` in ``pipeline/infer.py`` of
the JAX package. Each request resamples its clusters to ``num_points``
(FPS when larger, tiling when smaller), normalizes them, classifies them
with ``PipelineConfig.classifier`` (PointNet++ SSG by default), splices the
predicted class as a one-hot onto every point, and runs the rotation, sign,
translation and width heads.

The JAX package pads the cluster count to a multiple of 4 and the cluster
size to a multiple of 256 so that jit reuses its compiled programs. PyTorch
runs eagerly, so the port drops both pads: they duplicate point 0, which
FPS from start 0 never picks while real points remain, and eval-mode
BatchNorm treats every cluster on its own, so results are unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.data.augment import splice_onehot
from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.models import init_like_flax as _lecun_normal_
from pointnet_like_pose_estimation_tpu_torch.ops import (
    euler_rotation_matrix,
    farthest_point_sample,
    index_points,
    normalize_cloud,
)
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import (
    from_flax_variables,
    load_flax_checkpoint,
)
from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device

MODEL_KEYS = ("classifier", "rotation", "sign", "translation", "width")


@dataclasses.dataclass
class PipelineConfig:
    """The serving fields of the JAX package's PipelineConfig (float32).
    ``classifier`` is a registry name of task 'classify' on the raw cloud:
    ``pointnet2_cls_ssg``, ``pointnet2_cls_msg`` or ``pointnet_cls``."""

    num_points: int = 1024
    num_classes: int = 7
    classifier: str = "pointnet2_cls_ssg"


class GraspPipeline:
    """The five models of a grasp request, on one device."""

    def __init__(self, cfg: PipelineConfig, models: dict[str, nn.Module], device="cuda"):
        self.device = resolve_device(device, "GraspPipeline")
        missing = set(MODEL_KEYS) - set(models)
        if missing:
            raise KeyError(f"GraspPipeline: missing models {sorted(missing)}")
        self.cfg = cfg
        self.models = {k: models[k].to(self.device).eval() for k in MODEL_KEYS}

    @staticmethod
    def _make(cfg: PipelineConfig, key: str) -> nn.Module:
        if key != "classifier":
            return build_model(key, cfg.num_classes)
        spec = get_model_spec(cfg.classifier)
        if (spec.task, spec.input_kind) != ("classify", "xyz"):
            raise ValueError(f"PipelineConfig.classifier: {cfg.classifier!r} does not classify raw clouds")
        return spec.make(cfg.num_classes)

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
        """Load the JAX package's trained ``best.msgpack`` checkpoints."""
        models = {}
        for key in MODEL_KEYS:
            tree = load_flax_checkpoint(checkpoint_paths[key])
            models[key] = cls._make(cfg, key)
            models[key].load_state_dict(from_flax_variables(tree), strict=True)
        return cls(cfg, models, device)

    def _resample(self, clusters: np.ndarray) -> torch.Tensor:
        """``[K, M, C]`` host clusters -> ``[K, num_points, 3]`` on the device."""
        K, M, _ = clusters.shape
        xyz = torch.as_tensor(np.ascontiguousarray(clusters[..., :3], np.float32)).to(self.device)
        n = self.cfg.num_points
        if M == n:
            return xyz
        if M > n:
            return index_points(xyz, farthest_point_sample(xyz, n))
        return xyz.repeat(1, -(-n // M), 1)[:, :n]

    def _infer(self, xyz: torch.Tensor) -> dict[str, torch.Tensor]:
        m = self.models
        mean = xyz.mean(dim=1)                                # translation residual input
        normed = normalize_cloud(xyz)
        log_probs, _, pred_class = m["classifier"](normed)
        spliced = splice_onehot(normed, pred_class, self.cfg.num_classes)
        rot = m["rotation"](spliced)                          # [K, 3] euler deg, |z|
        sign_prob, hard_sign = m["sign"](spliced)             # [K, 1] each
        tran = m["translation"](spliced, mean)                # [K, 3]
        width = m["width"](spliced)                           # [K, 1]
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
        under the keys of the JAX package's ``infer_clusters``."""
        with torch.inference_mode():
            out = self._infer(self._resample(clusters))
            return {k: v.cpu().numpy() for k, v in out.items()}
