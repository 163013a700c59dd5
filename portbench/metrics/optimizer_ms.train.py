"""Median ms of a step's clipped AdamW update, synchronized after it."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "optimizer")
