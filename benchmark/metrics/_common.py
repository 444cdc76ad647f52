"""Shared arithmetic of the per-layer metric readers. A reader takes the
run's record (``benchmark.harness.serve.run_cell``) and returns a number,
or None where it finds nothing to read."""

from __future__ import annotations

import re
from typing import Dict, List, Optional

GEMM_NAMES = ("gemm", "gemv", "cutlass", "cublas", "nvjet")


def idle_percent(rec: Dict) -> Optional[float]:
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def gemm_percent(rec: Dict) -> Optional[float]:
    t = rec.get("trace")
    if not t:
        return None
    total = sum(s for _, s in t["kernels"].values())
    gemm = sum(s for n, (_, s) in t["kernels"].items()
               if any(g in n.lower() for g in GEMM_NAMES))
    return 100.0 * gemm / total if total > 0 else None


def kernel_seconds(rec: Dict, kernel: str) -> float:
    """Device seconds of the traced slice's calls of the kernel function
    named `kernel` (an identifier of the profiler's name, compared whole:
    ``block_attention_kernel`` is not ``rel_block_attention_kernel``)."""
    t = rec["trace"]
    return sum(s for n, (_, s) in t["kernels"].items()
               if kernel in re.findall(r"[A-Za-z_]\w*", n))


def attention_roofline(rec: Dict, kernel: str, count) -> Optional[float]:
    """An attention kernel's bound time over its device time, from the
    grids of its calls: grid = (windows × heads, query tiles); `count` is
    its ``benchmark.roofline.kernels`` function."""
    from benchmark.roofline import peaks

    t = rec.get("trace")
    if not t:
        return None
    m = rec["config"]
    h = m["encoder_heads"]
    w = m["block_size"] + 2
    dk = m["encoder_dim"] // h
    bound = 0.0
    for name, calls in t["grids"].items():
        if kernel not in re.findall(r"[A-Za-z_]\w*", name):
            continue
        for grid, _seconds in calls:
            bound += peaks.bound_s(*count(grid[0] // h, h, w, dk))
    spent = kernel_seconds(rec, kernel)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None


def serve_mfu(rec: Dict) -> Optional[float]:
    """Model FLOPs of the window's decoded audio and beam steps over the
    window's seconds, as a share of the float32 peak. Decoder rows are
    counted per stream from the step log: each step in which a stream
    steps, its ``beam`` hypotheses over the frames visible to it."""
    from benchmark.roofline import model_flops, peaks

    m = rec["config"]
    if not rec["window_s"] or rec["window_s"] != rec["window_s"]:
        return None
    if any("stepping" not in b for b in rec["blocks"]):
        return None
    frames = model_flops.frames_of_samples(m, rec["audio_samples"])
    flops = frames * model_flops.frame_flops(m)
    for b in rec["blocks"]:
        for steps, vis in zip(stream_steps(b), b["new_vis"]):
            if steps:
                flops += steps * b["beam"] * \
                    model_flops.decoder_row_flops(m, vis)
    if flops <= 0:
        return None
    return 100.0 * flops / rec["window_s"] / peaks.FP32_FLOPS


def stream_steps(block: Dict) -> List[int]:
    """Beam steps each stream of a logged block stepped in."""
    return [sum(col) for col in zip(*block["stepping"])]
