"""Median ms of the correspondence head and the weighted Kabsch solve,
synchronized after them."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "head_pose")
