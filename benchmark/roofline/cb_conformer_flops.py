"""Model FLOPs behind ``mfu.cbc``: what decoding the audio needs with
ESPnet's contextual-block conformer, counted from the configuration's
widths (a multiply-add is two operations). ``model_flops`` counts the
transformer and the port's relative-attention conformer; what the two
models share (the subsampling, the decoder's rows, frames of samples) is
taken from it.

- Encoder: the blocks the audio's frames need, one block every
  ``hop_size`` subsampled frames, each of W = ``block_size + 2`` rows
  through every layer: the four attention projections (4·2·W·d²), the
  scores and the weighted values inside the window (2·2·W²·d), the
  feed-forward (2·2·W·d·ffn) twice with ``macaron_style`` and once
  without, and the convolution module: the first pointwise convolution
  to 2d channels (2·W·d·2d), the depthwise convolution of k taps
  (2·W·d·k) and the second pointwise convolution (2·W·d²).
- CTC head: each frame once over the whole vocabulary (2·d·V).
- Cross-attention K/V: each frame projected once per decoder layer.
- Decoder: ``model_flops.decoder_row_flops``, whose output layer spans the
  whole vocabulary.
"""

from __future__ import annotations

from typing import Dict

from benchmark.roofline import model_flops


def layer_flops(m: Dict) -> float:
    """One layer over one window."""
    d, ffn, k = (m["encoder_dim"], m["encoder_linear_units"],
                 m["conformer_kernel_size"])
    w = m["block_size"] + 2
    proj = 4 * 2 * w * d * d
    attn = 2 * (2 * w * w * d)
    ff = 2 * (2 * w * d * ffn) * (2 if m["macaron_style"] else 1)
    conv = 2 * w * d * 2 * d + 2 * w * d * k + 2 * w * d * d
    return float(proj + attn + ff + conv)


def frame_flops(m: Dict) -> float:
    """Per subsampled frame: subsampling, its share of the encoder's
    blocks, the CTC head and the cross-attention K/V of every decoder
    layer."""
    d = m["encoder_dim"]
    enc = m["encoder_layers"] * layer_flops(m) / m["hop_size"]
    ctc = 2 * d * m["vocab_size"]
    cross_kv = m["decoder_layers"] * 2 * (2 * d * d)
    return model_flops.subsample_flops_per_frame(m) + enc + ctc + cross_kv
