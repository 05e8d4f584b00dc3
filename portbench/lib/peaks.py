"""The card's published peaks: NVIDIA H100 SXM data sheet, at 700 W, dense
rates. A roofline share is stated against these, with the card's power
limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12      # f32 outside the tensor cores; an FMA counts 2


def least_s(nbytes: float, ops: float) -> float:
    """The least time the card could take for this traffic and work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
