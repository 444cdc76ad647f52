"""Kernel A (``block_attention``): the least time its calls in the traced
slice could take at the H100's published peaks (operations and bytes from
each call's windows, ``benchmark.roofline.kernels``) over their device
time."""

from benchmark.metrics._common import attention_roofline
from benchmark.roofline import kernels


def read(rec):
    return attention_roofline(rec, "block_attention_kernel",
                              kernels.block_attention)
