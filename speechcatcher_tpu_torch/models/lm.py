"""The fused language model's incremental step: ESPnet's ``TransformerLM``
(``espnet2/lm/transformer_lm.py``, ``pos_enc: null``) as its
``batch_score`` runs it through ``Encoder.forward_one_step``, one new
position a hypothesis.

For N hypotheses whose last tokens sit at positions ``pos``:

    x  = ReLU(LayerNorm_1e-5(W_in · embed[token] + b_in))   # no positions
    for each of lm_layers layers (pre-norm, LayerNorm eps 1e-12):
        x = x + SelfAttn(norm1(x), over the cached rows t < pos and x)
        x = x + W_2 · ReLU(W_1 · norm2(x))
    logp = log_softmax(W_out · after_norm(x) + b_out)

ESPnet's layer caches its output, the next layer's input, and reads every
cached row through norm1 again; the port caches the normalised rows
themselves, (lm_layers, N, Lmax, lm_dim) in ``cache_dtype``, which is the
same number. Each layer's two sublayers are the decoder's
(``models.decoder.self_attention_sublayer`` and ``feed_forward_sublayer``):
kernel F for each norm with its residual, its bias and the cache-row write
at ``pos`` (where ``write``), kernel G for the attention over the rows below
``pos`` through the beam's lane map. The rows are written at the parent's
lane, as the decoder's are, so the LM reads the same lane map: the cache is
append-only, never selected or snapshotted, and a rewind leaves it alone
(rows past ``pos`` are never read).

The input layer's LayerNorm is torch's own at its default eps (ESPnet's
``linear`` input layer is a ``torch.nn.LayerNorm``), the others ESPnet's
eps 1e-12. The step is float32 only and outside a tp group: the precision
modes and tensor parallelism do not cover the LM, and a session or engine
refuses them for a model that has one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from speechcatcher_tpu_torch.config import ModelConfig
from speechcatcher_tpu_torch.models.decoder import (
    feed_forward_sublayer,
    self_attention_sublayer,
)
from speechcatcher_tpu_torch.ops.kernels.add_layer_norm import add_layer_norm
from speechcatcher_tpu_torch.ops.layers import Params, linear
from speechcatcher_tpu_torch.parallel.tp import tp_size
from speechcatcher_tpu_torch.utils.metrics import TRACER

# torch.nn.LayerNorm's default eps: ESPnet's linear input layer.
INPUT_NORM_EPS = 1e-5


class LMCache(NamedTuple):
    """Per-hypothesis cache of the LM's normalised layer inputs."""

    h: torch.Tensor  # (lm_layers, N, Lmax, lm_dim)


def init_lm_cache(cfg: ModelConfig, n_hyps: int,
                  device: torch.device) -> LMCache:
    shape = (cfg.lm_layers, n_hyps, cfg.max_tokens, cfg.lm_dim)
    return LMCache(h=torch.zeros(shape, dtype=cfg.cache_torch_dtype,
                                 device=device))


def check_lm_supported(cfg: ModelConfig) -> None:
    """Refuse what the port does not compute for a model with an LM: a
    cache below float32 (every precision mode stores the caches in
    bfloat16 and casts the weights) and tensor parallelism."""
    if not cfg.lm_layers:
        return
    if cfg.cache_dtype != "float32":
        raise ValueError(f"cache_dtype {cfg.cache_dtype!r}: the fused LM "
                         f"runs in float32 alone")
    if tp_size() > 1:
        raise ValueError("the fused LM does not run under a tp group")


def lm_step(params: Params, cache: LMCache, tokens: torch.Tensor,
            pos: torch.Tensor, lane: torch.Tensor, write: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Log-probabilities (N, vocab) of the token after each of the N = S·B
    hypotheses' last tokens (``tokens`` (N,), at ``pos`` (N,)), with this
    step's rows written into ``cache.h`` in place where ``write`` (N,);
    ``lane`` (S, B, Lmax) is the beam's lane map."""
    with TRACER.annotate("lm.step"):
        pos = pos.long()
        p_in = params["input_layer"]
        x = linear(p_in["out"], params["embed"]["weight"][tokens.long()])
        x = torch.relu(F.layer_norm(x, (x.shape[-1],), p_in["norm"]["weight"],
                                    p_in["norm"]["bias"], INPUT_NORM_EPS))
        h, y, b = x, None, None
        for l, p_layer in enumerate(params["layers"]):
            h, y, b = self_attention_sublayer(
                p_layer["norm1"], p_layer["self_attn"], h, y, b, cache.h[l],
                pos, write, lane, cfg.lm_heads)
            h, y, b = feed_forward_sublayer(p_layer["norm2"],
                                            p_layer["feed_forward"], h, y, b)
        _, h = add_layer_norm(params["after_norm"], h, y, b)
        return torch.log_softmax(linear(params["output_layer"], h), dim=-1)
