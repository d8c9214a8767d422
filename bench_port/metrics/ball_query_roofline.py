"""The ball_query calls' least device time on the profiled span's inputs, as a
percent of the device time of the ball_query kernels in the span."""

from harness.readers import roofline


def read(readings):
    return roofline(readings, "ball_query")
