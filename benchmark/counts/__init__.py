"""Frozen operation and byte counts of the benchmark: the composite kernels'
walks (a copy of the count that `chip_smoke.py` made, run on the
benchmark's own projection and binning) and a step's or a view's other work
from its shapes, against the card's published peaks."""

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the float32 peak and the bytes over the memory rate."""
    return max(flops / H100_F32_FLOPS, n_bytes / H100_BYTES_PER_S)
