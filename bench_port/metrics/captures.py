"""Programs captured in the window before the profiled span."""


def read(readings):
    return readings.get("captures")
