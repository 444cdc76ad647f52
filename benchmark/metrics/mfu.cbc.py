"""Model FLOPs that the window's decoded audio needs with ESPnet's
contextual-block conformer (``benchmark.roofline.cb_conformer_flops``:
subsampling, the encoder's blocks, the CTC head and the cross-attention K/V
a frame; the beam steps of the streams that stepped, as the beam loops
counted them, ``model_flops.decoder_row_flops``), over the window's
seconds, as a share of the H100's float32 peak."""

from benchmark.metrics._common import stream_steps
from benchmark.roofline import cb_conformer_flops, model_flops, peaks


def read(rec):
    m = rec["config"]
    if m.get("encoder_type") != "contextual_block_conformer":
        return None
    if not rec["window_s"] or rec["window_s"] != rec["window_s"]:
        return None
    if any("stepping" not in b for b in rec["blocks"]):
        return None
    frames = model_flops.frames_of_samples(m, rec["audio_samples"])
    flops = frames * cb_conformer_flops.frame_flops(m)
    for b in rec["blocks"]:
        for steps, vis in zip(stream_steps(b), b["new_vis"]):
            if steps:
                flops += steps * b["beam"] * \
                    model_flops.decoder_row_flops(m, vis)
    if flops <= 0:
        return None
    return 100.0 * flops / rec["window_s"] / peaks.FP32_FLOPS
