"""A request's latency less the device's busy time inside it, in ms."""
from portbench.readers import host_gap_ms


def read(reading):
    return host_gap_ms(reading)
