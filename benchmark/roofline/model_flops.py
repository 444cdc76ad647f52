"""Model FLOPs behind ``mfu.serve``: what decoding the audio needs, counted
from the configuration's widths (a multiply-add is two operations).

- Subsampling: each subsampled frame once through the two 3×3 stride-2
  convolutions and the output linear.
- Encoder: the blocks the audio's frames need, one block every ``hop_size``
  subsampled frames, each of ``block_size + 2`` rows through every layer
  (projections, attention inside the window, feed-forward; the conformer's
  macaron feed-forward, position projection and scores, and convolution
  module besides).
- CTC head: each frame once.
- Cross-attention K/V: each frame projected once per decoder layer (the
  frames visible to the decoder; a frame's K and V never change).
- Decoder: each beam step of each hypothesis of each stream that steps:
  the projections and feed-forward of every layer, the attention over the
  visible frames, the output layer.
"""

from __future__ import annotations

from typing import Dict


def subsample_flops_per_frame(m: Dict) -> float:
    d, mels = m["encoder_dim"], m["n_mels"]
    f1 = (mels - 3) // 2 + 1
    f2 = (f1 - 3) // 2 + 1
    conv1 = 2 * 9 * d * f1 * 2      # two first-stage rows per output frame
    conv2 = 2 * 9 * d * d * f2
    out = 2 * d * f2 * d
    return float(conv1 + conv2 + out)


def encoder_block_flops(m: Dict) -> float:
    d, ffn, layers = m["encoder_dim"], m["encoder_linear_units"], \
        m["encoder_layers"]
    w = m["block_size"] + 2
    proj = 4 * 2 * w * d * d
    attn = 2 * (2 * w * w * d)
    ff = 2 * (2 * w * d * ffn)
    per_layer = proj + attn + ff
    if m["encoder_type"] == "conformer":
        k = m["conformer_kernel_size"]
        per_layer += ff                          # macaron feed-forward
        per_layer += 2 * w * d * d + 2 * w * w * d   # position proj + scores
        per_layer += 2 * w * d * 2 * d + 2 * w * d * k + 2 * w * d * d
    return float(layers * per_layer)


def frame_flops(m: Dict) -> float:
    """Per subsampled frame: subsampling, its share of the encoder's blocks,
    the CTC head and the cross-attention K/V of every decoder layer."""
    d = m["encoder_dim"]
    enc = encoder_block_flops(m) / m["hop_size"]
    ctc = 2 * d * m["vocab_size"]
    cross_kv = m["decoder_layers"] * 2 * (2 * d * d)
    return subsample_flops_per_frame(m) + enc + ctc + cross_kv


def decoder_row_flops(m: Dict, visible: float) -> float:
    """One beam step of one hypothesis over `visible` encoder frames."""
    d, ffn = m["decoder_dim"], m["decoder_linear_units"]
    per_layer = (4 * 2 * d * d          # self q, out; source q, out
                 + 2 * (2 * d * ffn)
                 + 2 * (2 * visible * d))
    return float(m["decoder_layers"] * per_layer + 2 * d * m["vocab_size"])


def frames_of_samples(m: Dict, samples: float) -> float:
    return samples / (m["hop_length"] * 4)
