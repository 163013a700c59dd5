"""K6 (the radius searches: pre-pass and scan) against its least time on
these inputs, in percent."""
from portbench import readings


def read(trace):
    return readings.roofline(trace, "k6", readings.K6)
