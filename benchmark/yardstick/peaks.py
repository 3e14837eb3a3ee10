"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at its
700 W limit), as the program's `utils/timing.py` states them, frozen here
as the yardstick's."""

PEAK_BF16_FLOPS = 989e12  # dense tensor-core bf16
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def bound_s(flops, nbytes, peak) -> float:
    """The least time for the work: the larger of the operations at their
    peak rate and the bytes at the memory rate."""
    return max(float(flops) / peak, float(nbytes) / PEAK_BYTES)
