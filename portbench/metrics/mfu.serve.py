"""The served forward's operations over the requests' spans, as a share of
the card's float32 peak, in %."""
from portbench.readers import mfu


def read(reading):
    return mfu(reading, training=False)
