"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the yardstick of every roofline share and MFU here."""
BYTES_PER_S = 3.35e12        # HBM3
FP32_FLOPS = 67e12           # float32 outside the tensor cores
TF32_FLOPS = 495e12          # tensor cores, TF32
BF16_FLOPS = 989e12          # tensor cores, bf16


def bound_s(*, nbytes: float = 0.0, fp32: float = 0.0,
            bf16: float = 0.0) -> float:
    """The least time a kernel could take: the largest of its bytes over
    HBM's rate and its operations over their unit's peak."""
    return max(nbytes / BYTES_PER_S, fp32 / FP32_FLOPS, bf16 / BF16_FLOPS)
