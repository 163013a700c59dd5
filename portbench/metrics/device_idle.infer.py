"""Share of the profiled stretch of the inference window in which no
operation ran on the device, in percent."""
from portbench import readings


def read(trace):
    return readings.idle(trace)
