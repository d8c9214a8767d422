"""Mean host ms a frame in ``preprocess.clip_distance`` and
``preprocess.clean_scene``, the clean ended by a synchronize."""

from harness.readers import mean_ms


def read(readings):
    return mean_ms(readings, "clean")
