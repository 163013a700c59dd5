"""Median ms of a step's forward and losses, synchronized after them."""
from portbench import readings


def read(trace):
    return readings.stage_ms(trace, "forward_loss")
