"""K1 (the attention forward) against its least time on these inputs, in
percent."""
from portbench import readings


def read(trace):
    return readings.roofline(trace, "k1", readings.K1)
