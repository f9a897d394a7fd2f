"""The train step's share of the card's float32 peak, in %."""
from portbench.readers import mfu


def read(reading):
    return mfu(reading, training=True)
