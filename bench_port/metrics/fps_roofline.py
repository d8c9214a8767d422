"""The fps calls' least device time on the profiled span's inputs, as a
percent of the device time of the fps kernels in the span."""

from harness.readers import roofline


def read(readings):
    return roofline(readings, "fps")
