"""Device ms a micro-step of kernels that are not the port's own (cuBLAS,
PyTorch's elementwise, LayerNorm, index and optimizer kernels)."""
from portbench.readers import layer_ms


def read(reading):
    return layer_ms(reading, "torch")
