"""K2 and K3 (the attention backward) against their least time on these
inputs, in percent."""
from portbench import readings


def read(trace):
    return readings.roofline(trace, "k23", readings.K23)
