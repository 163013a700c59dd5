"""Share of the profiled stretch of the training window in which no
operation ran on the device, in percent."""
from portbench import readings


def read(trace):
    return readings.idle(trace)
