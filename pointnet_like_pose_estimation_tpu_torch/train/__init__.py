"""Evaluation of the port (training is not ported yet)."""

from pointnet_like_pose_estimation_tpu_torch.train.config import TrainConfig
from pointnet_like_pose_estimation_tpu_torch.train.loop import evaluate, load_checkpoint
from pointnet_like_pose_estimation_tpu_torch.train.steps import make_eval_step

__all__ = ["TrainConfig", "evaluate", "load_checkpoint", "make_eval_step"]
