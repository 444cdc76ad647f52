"""Plain reference of ESPnet's contextual-block conformer
(``espnet2/asr/encoder/contextual_block_conformer_encoder.py``, layers from
``espnet/nets/pytorch_backend/conformer/contextual_block_encoder_layer.py``),
for the check that decides ``correct`` in the cells of a configuration that
names ``"reference": "cb_conformer"``.

Everything but the encoder layer is ``asr.py``'s, imported from it: the
streaming frontend, the conv2d subsampling, the block assembly with its
context vectors and the per-layer context carry (``asr.StreamingEncoder``),
the CTC head, the decoder's rescoring, the CTC prefix scorer and the control
``in_tf32`` (every product's operands rounded to TF32, which the products
here share through ``asr``'s helpers). This module overrides the encoder
layer, in a subclass of ``asr.StreamingEncoder``, and ``weight_specs``.

The layer, over a window ``x`` of ``block_size + 2`` rows (the context slot,
the block's frames, its own add-in vector), every sub-block pre-norm with
LayerNorm eps 1e-12; ``s = 1/2`` with ``macaron_style``, else 1::

    x = x + s · FFN_mac(LN_ff_mac(x))          # only with macaron_style
    x = x + MHA(LN_mha(x))                     # q = k = v, the block mask
    x = x + Conv(LN_conv(x))
    x = x + s · FFN(LN_ff(x))
    x = LN_final(x)
    FFN(x)  = W2 · swish(W1 x + b1) + b2
    Conv(x) = PW2(swish(BN(DWConv_k(GLU(PW1 x)))))

``PW1`` maps d to 2d, the GLU halves it again over the channels, the
depthwise convolution has ``conformer_kernel_size`` taps with 'same' zero
padding inside the window, BatchNorm1d (eps 1e-5) and ``PW2`` maps d to d.
The attention is plain multi-head attention with no position argument:
the positions are ``StreamPositionalEncoding``'s, ``x·√d + pe[offset…]``
added to the block's frames and its add-in vectors, as in the transformer.
The short-segment final runs the whole segment through the layers with no
mask.

Departures from ESPnet's module, each what the served model computes too:
no dropout (inference); identity global MVN (the benchmark's configurations
carry no feature statistics); BatchNorm from its running statistics.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import asr
from benchmark.reference.asr import in_tf32  # noqa: F401  (the control)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def weight_specs(m: Dict) -> Dict:
    """The layout of the weight tree this reference reads (leaves as in
    ``asr.weight_specs``): ESPnet's layer as the program loads it, stacked
    on the layer axis; the four attention projections and no position
    projection or biases; a macaron feed-forward and its LayerNorm only with
    ``macaron_style``; the convolution module in Conv1d layouts, the
    depthwise weights (d, 1, k). The distributions are the program's
    random initialisation's: uniform ±1/sqrt(fan_in) weights, zero biases,
    unit LayerNorms, identity BatchNorm statistics. The subsampling, the
    decoder and the CTC head are ``asr.weight_specs``'s."""
    spec = asr.weight_specs(dict(m, encoder_type="transformer"))
    d, hidden, k = (m["encoder_dim"], m["encoder_linear_units"],
                    m["conformer_kernel_size"])
    el = (m["encoder_layers"],)

    def lin(d_in, d_out, tail=()):
        return {"weight": ("u", el + (d_out, d_in) + tail,
                           1.0 / math.sqrt(d_in * max(1, math.prod(tail)))),
                "bias": ("0", el + (d_out,))}

    def norm():
        return {"weight": ("1", el + (d,)), "bias": ("0", el + (d,))}

    def ffn():
        return {"w_1": lin(d, hidden), "w_2": lin(hidden, d)}

    layers = {
        "self_attn": {n: lin(d, d) for n in ("linear_q", "linear_k",
                                             "linear_v", "linear_out")},
        "feed_forward": ffn(),
        "conv_module": {
            "pointwise_conv1": lin(d, 2 * d, (1,)),
            "depthwise_conv": lin(1, d, (k,)),
            "batch_norm": {"weight": ("1", el + (d,)),
                           "bias": ("0", el + (d,)),
                           "running_mean": ("0", el + (d,)),
                           "running_var": ("1", el + (d,))},
            "pointwise_conv2": lin(d, d, (1,)),
        },
        **{n: norm() for n in ("norm_ff", "norm_mha", "norm_conv",
                               "norm_final")},
    }
    if m["macaron_style"]:
        layers["feed_forward_macaron"] = ffn()
        layers["norm_ff_macaron"] = norm()
    spec["encoder"]["layers"] = layers
    return spec


# ---------------------------------------------------------------------------
# Encoder layer
# ---------------------------------------------------------------------------

def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _ffn(p, i, x):
    return asr._lin(p["w_2"], i, _swish(asr._lin(p["w_1"], i, x)))


def encoder_layer(g: asr.Geometry, macaron: bool, p, i, x, keep):
    """Layer i of the stack over windows x (n, w, d); `keep` is the block
    mask (None for the short segment)."""
    s = 0.5 if macaron else 1.0
    if macaron:
        x = x + s * _ffn(p["feed_forward_macaron"], i,
                         asr._ln(p["norm_ff_macaron"], i, x))
    h = asr._ln(p["norm_mha"], i, x)
    x = x + asr._mha(p["self_attn"], i, h, h, keep, g.heads)
    x = x + asr._conv_module(p["conv_module"], i,
                             asr._ln(p["norm_conv"], i, x))
    x = x + s * _ffn(p["feed_forward"], i, asr._ln(p["norm_ff"], i, x))
    return asr._ln(p["norm_final"], i, x)


class StreamingEncoder(asr.StreamingEncoder):
    """``asr.StreamingEncoder`` with ESPnet's conformer layer."""

    def __init__(self, g: asr.Geometry, p, device, macaron: bool):
        super().__init__(g, p, device)
        self.macaron = macaron

    def _layers(self, x, keep, pos_emb, ctx_fn):
        for i in range(self.g.layers):
            x = encoder_layer(self.g, self.macaron, self.p["layers"], i, x,
                              keep)
            ctx_fn(i, x)
        return x


class Reference(asr.Reference):
    """``asr.Reference`` over ESPnet's contextual-block conformer."""

    def __init__(self, model_cfg: Dict, tree, device):
        super().__init__(model_cfg, tree, device)
        self.encoder = StreamingEncoder(self.g, tree["encoder"], device,
                                        bool(model_cfg["macaron_style"]))
