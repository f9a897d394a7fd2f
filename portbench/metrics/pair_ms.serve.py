"""Device ms a request of the fused pair pipeline's forward (K10f)."""
from portbench.readers import layer_ms


def read(reading):
    return layer_ms(reading, "pair_fwd")
