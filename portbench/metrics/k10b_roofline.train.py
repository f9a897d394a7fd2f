"""K10b's least time over its device time, in % (portbench/counts.py)."""
from portbench.readers import pair_roofline


def read(reading):
    return pair_roofline(reading, backward=True)
