"""``mfu.cbc`` (ESPnet's conformer: the window's audio and the decoder rows
of the streams that stepped) plus the fused language model's rows: for
every beam step of the step log, each stepping stream's ``beam``
hypotheses through the LM at their position (``benchmark.roofline.
lm_flops``), over the window's seconds, as a share of the H100's float32
peak. Nothing to read without an LM or without the step log."""

from benchmark.harness.cell import reader
from benchmark.roofline import lm_flops, peaks


def read(rec):
    m = rec["config"]
    if not m.get("lm_layers"):
        return None
    acoustic = reader("mfu.cbc")(rec)
    if acoustic is None:
        return None
    flops = 0.0
    for b in rec["blocks"]:
        for stepping, olen in zip(b["stepping"], b["olen"]):
            flops += sum(b["beam"] * lm_flops.lm_row_flops(m, pos)
                         for on, pos in zip(stepping, olen) if on)
    return acoustic + 100.0 * flops / rec["window_s"] / peaks.FP32_FLOPS
