"""Share of the device time of the traced slice spent in the conformer
convolution module's depthwise convolution: the calls of the kernels that
PyTorch's ``F.conv1d`` over (N, d, W) float32 windows with d groups
launches on the card, over all device time in the slice. At 15 taps that
is ATen's ``conv_depthwise2d_forward_kernel_generic`` (the name the
H100's trace shows); the kernel ATen specialises for some tap counts,
``conv_depthwise2d_forward_kernel``, is counted too. Names are compared as
whole identifiers of the profiler's kernel name."""

from benchmark.metrics._common import kernel_seconds

KERNELS = ("conv_depthwise2d_forward_kernel_generic",
           "conv_depthwise2d_forward_kernel")


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    total = sum(s for _, s in t["kernels"].values())
    spent = sum(kernel_seconds(rec, k) for k in KERNELS)
    return 100.0 * spent / total if total > 0 and spent > 0 else None
