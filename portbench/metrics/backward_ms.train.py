"""Median ms of a step's backward (K2, K3, K4), synchronized after it."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "backward")
