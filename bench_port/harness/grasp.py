"""What the two grasp cells share: the five models' weights from the seed,
the port's pipeline built on them, the reference built on the same, and
the comparison of a served answer with the reference.

The comparison takes the served class and the served hard sign as a
served model's tokens are taken: the reference runs the heads on the
class the program served and signs the rotation by the sign it served
(worked out from the served sign probability, as the program works it
out). Two numbers judge an answer: ``class_err``, the widest gap of the
served log-probabilities from the reference's, or of the reference's best
log-probability above that of the served class, whichever is larger; and
``head_err``, the widest gap of every head output (the signed rotation
in degrees and as a matrix, the sign probability, the translation, the
width), relative to the largest value of that output in the batch. A
wrongly served sign shows in the rotation; a wrongly served class in
``class_err`` and in every head.
"""

from __future__ import annotations

import numpy as np
import torch

from harness.weights import make_state
from reference.models import build
from reference.pipeline import KEYS, GraspReference

GAPS = ("class_err", "head_err")
HEAD_KEYS = ("rotation_deg", "rotation_matrix", "sign_prob", "translation", "width")


def states(config: dict, seed: int, device) -> dict:
    """A ``state_dict`` per model key, each drawn from its own stream of ``seed``."""
    nc = config["pipeline"]["num_classes"]
    return {key: make_state(build(name, nc), (int(seed) * 8 + i) % 2**63, device)
            for i, (key, name) in enumerate(KEYS.items())}


def port_pipeline(config: dict, weights: dict, device, dtype: str | None = None):
    """The port's ``GraspPipeline`` on the configuration and ``weights``,
    computing in ``dtype`` where it is given (the control) and in the
    configuration's precision where not."""
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    cfg = PipelineConfig(**{**config["pipeline"], **({"dtype": dtype} if dtype else {})})
    models = {}
    for key, name in KEYS.items():
        m = build_model(cfg.classifier if key == "classifier" else name, cfg.num_classes)
        m.load_state_dict(weights[key], strict=True)
        models[key] = m
    return GraspPipeline(cfg, models, device)


def reference(config: dict, weights: dict, device) -> GraspReference:
    p = config["pipeline"]
    return GraspReference(weights, p["num_points"], p["num_classes"], p["dtype"], device)


def gaps(ref: GraspReference, xyz: torch.Tensor, served: dict) -> dict:
    """The comparison of one served answer for ``[K, M, 3]`` clusters
    ``xyz`` (on the reference's device) with the reference."""
    dev = ref.device
    cls = torch.from_numpy(np.asarray(served["pred_class"])).long().to(dev)
    sign = torch.sign(torch.from_numpy(np.asarray(served["sign_prob"], np.float32)).to(dev) - 0.5)
    out = ref.infer(ref.resample(xyz), served_class=cls, served_sign=sign)
    lp = out["log_probs"]
    head = 0.0
    for k in HEAD_KEYS:
        want = out[k].double()
        got = torch.from_numpy(np.asarray(served[k])).to(dev).double()
        head = max(head, float((got - want).abs().max() / want.abs().max().clamp(min=1e-6)))
    served_lp = torch.from_numpy(np.asarray(served["log_probs"])).to(dev)
    below_best = lp.max(1).values - lp.gather(1, cls[:, None])[:, 0]
    return {"class_err": max(float((served_lp - lp).abs().max()), float(below_best.max())), "head_err": head}


def worst(rows: list[dict]) -> dict:
    """The widest of each gap over several answers."""
    return {g: max((r[g] for r in rows), default=0.0) for g in GAPS}
