"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
full 700 W power limit), against which every share of a peak is taken."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
