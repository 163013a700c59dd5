"""Median ms of the KPConv backbone, feature projection and position
embedding, synchronized after them."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "backbone")
