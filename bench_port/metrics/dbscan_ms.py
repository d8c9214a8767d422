"""Mean host ms a frame in ``preprocess.dbscan``."""

from harness.readers import mean_ms


def read(readings):
    return mean_ms(readings, "dbscan")
