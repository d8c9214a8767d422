"""Percent of the profiled span in which no kernel or copy ran on the card."""

from harness.readers import idle_share


def read(readings):
    return idle_share(readings)
