"""Median ms of GeoTransformer's coarse_matching stage: the point-to-node partition and the superpoint matching,
synchronized after it."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "coarse_matching")
