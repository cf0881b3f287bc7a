"""The card's published peaks, against which every roofline and mfu share
is stated: one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense rates,
without sparsity, at its full 700 W limit; a run writes the card's power
limit beside its numbers)."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "bf16": 989e12,  # tensor cores
    "int8": 1979e12,  # tensor cores
    "tf32": 495e12,  # tensor cores
    "fp32": 67e12,  # outside the tensor cores
}


def least_seconds(ops: float, precision: str, n_bytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over their peak and the bytes over the memory bandwidth."""
    return max(ops / OPS_PER_S[precision], n_bytes / HBM_BYTES_PER_S)
