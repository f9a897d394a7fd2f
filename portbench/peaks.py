"""Peak rates of the card, from NVIDIA's H100 SXM data sheet (dense rates,
no sparsity), which assume the card's full 700 W power limit. A card set to a
lower limit runs slower under load: every result names the card's
``power.limit`` beside these."""
from __future__ import annotations

H100_SXM = {
    "source": "NVIDIA H100 SXM data sheet, 700 W",
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops": 67e12,           # float32 outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
}


def least_seconds(ops: float, nbytes: float, peaks: dict = H100_SXM) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the float32 peak."""
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["f32_flops"])
