"""Median ms of GeoTransformer's embedding stage: the geometric structure embedding at the coarse level's valid extent,
synchronized after it."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "embedding")
