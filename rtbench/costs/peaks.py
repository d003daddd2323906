"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

BF16_FLOPS = 989e12  # tensor-core bf16 / fp16 operations per second
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_S = 3.35e12  # HBM3 bandwidth


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time a launch could take: the larger of its operations at
    the bf16 peak and its bytes at the HBM peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_S)
