"""Device ms a train step of the profiled span spent in kernels other than
FPS, the ball query and matrix products: the unfused elementwise passes
and the reductions."""

from harness.readers import group_ms_per_step


def read(readings):
    return group_ms_per_step(readings, "other")
