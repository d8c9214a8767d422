"""GB of the grouped ``[B, S, K, C]`` tensors that a request builds, from
the port's count of them (``ops/grouping.py`` ``count_grouped``) over the
requests of the window before the profiled span."""


def read(readings):
    nbytes, requests = readings.get("grouped_bytes"), readings.get("requests")
    if nbytes is None or not requests:
        return None
    return nbytes / requests / 1e9
