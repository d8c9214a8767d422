"""Matrix-product operations of the models, from their shapes, over the wall
seconds of the window before the profiled span, as a percent of the
peak of the precision the configuration computes in."""


def read(readings):
    return readings.get("mfu")
