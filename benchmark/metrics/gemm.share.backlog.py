"""Share of the device time of the traced slice spent in matrix-product
kernels (names holding gemm, gemv, cutlass, cublas or nvjet)."""

from benchmark.metrics._common import gemm_percent as read  # noqa: F401
