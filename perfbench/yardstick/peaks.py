"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
full 700 W power limit). A card set below 700 W reaches less; every run
puts each card's power limit in its result (``device.power_limit_w``)."""

PEAK_FLOPS = {
    "bfloat16": 989e12,   # tensor cores
    "float32": 67e12,     # FP32 outside the tensor cores
}
PEAK_HBM_BYTES_S = 3.35e12


def peak_flops(dtype: str) -> float:
    """The compute peak of the dtype a kernel or a step computes in."""
    return PEAK_FLOPS[dtype]
