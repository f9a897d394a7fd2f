"""Share of the traced window with no device activity, in %."""
from portbench.readers import idle_share


def read(reading):
    return idle_share(reading, training=True)
