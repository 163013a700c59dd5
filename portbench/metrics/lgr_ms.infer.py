"""Median ms of GeoTransformer's registration stage: the local-to-global registration (hypotheses, verification, refinement),
synchronized after it."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "registration")
