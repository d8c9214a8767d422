"""Utilities of the port: timing and tracing (``profiling``), the counters
of what the kernels do (``counters``), headless and interactive
visualisation (``viz``, ``viz_interactive``), checkpoints and the device
rule."""

from pointnet_like_pose_estimation_tpu_torch.utils.profiling import (
    SPANS,
    idle_by_span,
    span,
    sustained_step_time,
    sustained_time,
    trace,
)

__all__ = ["SPANS", "idle_by_span", "span", "sustained_step_time", "sustained_time", "trace"]
