"""Training and evaluation of the port."""

from pointnet_like_pose_estimation_tpu_torch.train.config import TrainConfig
from pointnet_like_pose_estimation_tpu_torch.train.loop import (
    build_state,
    evaluate,
    load_checkpoint,
    save_checkpoint,
    train,
)
from pointnet_like_pose_estimation_tpu_torch.train.state import TrainState, make_optimizer
from pointnet_like_pose_estimation_tpu_torch.train.steps import (
    draw_step,
    make_epoch_runner,
    make_eval_step,
    make_train_step,
)

__all__ = ["TrainConfig", "TrainState", "build_state", "draw_step", "evaluate", "load_checkpoint",
           "make_epoch_runner", "make_eval_step", "make_optimizer", "make_train_step",
           "save_checkpoint", "train"]
