"""Kernel B (``ctc_forward_recursion_streams``, one launch a beam step over
all S streams): the least time its calls in the traced slice could take at
the H100's published peaks over their device time. The frames each call
recursed, [max(olen, 1), end) a stream, come from the beam loop's step log
(``benchmark.harness.spans.StepLog``), the steps whose replay the host
issued inside the traced slice; the operations and bytes from
``benchmark.roofline.kernels.ctc_recursion``."""

from benchmark.metrics._common import kernel_seconds
from benchmark.roofline import kernels, peaks


def read(rec):
    t = rec.get("trace")
    if not t or any("step_t" not in b for b in rec["blocks"]):
        return None
    bound = 0.0
    for b in rec["blocks"]:
        for ts, olen, end in zip(b["step_t"], b["olen"], b["end"]):
            if t["t0"] <= ts < t["t1"]:
                bound += peaks.bound_s(*kernels.ctc_recursion(
                    b["beam"], b["t_cap"], olen, end))
    spent = kernel_seconds(rec, "ctc_forward_recursion_kernel")
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
