"""The knn calls' least device time on the profiled span's inputs, as a
percent of the device time of the knn kernels in the span (the group
``knn`` that ``kinds/clusters_pt.py`` splits out of ``other``)."""

from harness.readers import roofline


def read(readings):
    return roofline(readings, "knn")
