"""Median ms of the forward's pyramid stage (spatial sort, subsampling, the
ten K6 searches), synchronized after it."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "pyramid")
