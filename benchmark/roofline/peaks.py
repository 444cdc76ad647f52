"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full 700 W power limit). The port turns TF32 off for cuBLAS and cuDNN,
so its float32 work is held against the float32 rate outside the tensor
cores."""

FP32_FLOPS = 67e12          # float32, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the chip could take: the larger of bytes over the
    memory rate and operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS)
