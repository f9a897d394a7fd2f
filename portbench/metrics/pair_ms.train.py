"""Device ms a micro-step of the fused pair pipeline (K10f and K10b)."""
from portbench.readers import layer_ms


def read(reading):
    parts = [layer_ms(reading, "pair_fwd"), layer_ms(reading, "pair_bwd")]
    return None if parts == [None, None] else sum(p or 0.0 for p in parts)
