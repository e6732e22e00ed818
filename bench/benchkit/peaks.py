"""The chip's published peaks (NVIDIA H100 SXM data sheet, dense rates, at
the 700 W limit), the denominators of every roofline and ``mfu`` share."""
BF16_FLOPS = 989e12           # tensor cores, bf16/fp16, dense
HBM_BYTES_PER_S = 3.35e12     # HBM3


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
