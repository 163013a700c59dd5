"""The forward's operations over the profiled stretch at the dtype's peak,
in percent."""
from portbench import readings


def read(trace):
    return readings.mfu(trace, "forward")
