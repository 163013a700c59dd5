"""Median ms of GeoTransformer's optimal_transport stage: the patch scores and the 100 log-domain Sinkhorn iterations,
synchronized after it."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "optimal_transport")
