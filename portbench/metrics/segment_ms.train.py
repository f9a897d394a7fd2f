"""Device ms a micro-step of the segment sums (K2)."""
from portbench.readers import layer_ms


def read(reading):
    return layer_ms(reading, "segment")
