"""The step's operations (forward, losses, backward at twice the forward)
over the profiled stretch at the dtype's peak, in percent."""
from portbench import readings


def read(trace):
    return readings.mfu(trace, "train")
