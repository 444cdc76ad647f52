"""Model FLOPs of the fused language model behind ``mfu.cbl``: one beam
step of one hypothesis through ESPnet's ``TransformerLM`` (``pos_enc:
null``), as its incremental ``batch_score`` computes the new position,
counted from the configuration's widths (a multiply-add is two
operations):

- the input layer: the token's embedding (``lm_embed_dim``) through the
  linear to ``lm_dim`` (2·e·d);
- each layer: the four attention projections of the new row (4·2·d²), its
  scores against the prefix's ``pos + 1`` rows and their weighted sum
  (2·2·(pos + 1)·d), the feed-forward (2·2·d·units);
- the output layer over the whole vocabulary (2·d·V).

Norms, the ReLUs and the softmaxes are left out, as ``model_flops`` leaves
them out of the decoder's rows.
"""

from __future__ import annotations

from typing import Dict


def lm_row_flops(m: Dict, pos: float) -> float:
    """One hypothesis' LM step at position `pos` (its history is the `pos`
    rows before it)."""
    d, units = m["lm_dim"], m["lm_linear_units"]
    per_layer = (4 * 2 * d * d
                 + 2 * (2 * (pos + 1) * d)
                 + 2 * (2 * d * units))
    return float(2 * m["lm_embed_dim"] * d + m["lm_layers"] * per_layer
                 + 2 * d * m["vocab_size"])
