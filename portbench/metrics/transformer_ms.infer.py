"""Median ms of the six cross-encoder layers (K1), synchronized after them."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "transformer")
