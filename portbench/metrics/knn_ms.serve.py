"""Device ms a request of the kNN selection kernels (K1 / K3)."""
from portbench.readers import layer_ms


def read(reading):
    return layer_ms(reading, "knn")
