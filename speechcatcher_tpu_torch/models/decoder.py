"""Transformer decoder: full forward (training) and incremental beam step.

Port of ``speechcatcher_tpu/models/decoder.py``: ``decoder_forward_train``
(teacher forcing over whole token sequences, causal and padding masks, no
kernel) and ``decoder_step`` on its default cross-attention path. Each layer caches its post-norm1 ACTIVATIONS in one
fixed-capacity (L, N, Lmax, d) buffer; the K/V projections commute to the
query/output side (``_attend_cached_lane``). The cache is lazily reordered:
beam pruning permutes a small per-position lane map, never the buffer, so
rows are append-only.

In place: ``decoder_step`` writes this step's rows into ``cache.h`` in place
(only where ``write`` is set), at fixed shapes and without a host sync, so a
beam step can be captured in a CUDA graph. No beam snapshot holds the cache, and a
rolled-back step's rows are never read again (they sit at positions the
history mask hides, and the next step overwrites them).

Kernel F (``ops.kernels.add_layer_norm``): each of a step's 3L + 1 norms is
one launch that also adds the residual and the preceding linear's bias
(``row_parallel_product`` leaves the bias apart) and, for norm1, writes the
cache row; on the CPU its twin is the composition it replaces, bit for bit.
``decoder_forward_train`` keeps ``layer_norm`` (training needs a backward).

Kernel G (``ops.kernels.lane_attention``): each layer's self-attention,
from the query with the K projection folded in to the weighted sum, is one
launch that reads a hypothesis's history rows in place through the lane map,
only below its position; on the CPU its twin is the composition it replaces
(a gather of the whole cache, two contractions, the masked softmax), bit for
bit.

Kernel H (``ops.kernels.cross_attention``): each layer's cross-attention,
from the queries to the weighted sum of V, is one launch that reads each
stream's K/V rows in place, only below its encoder length, for all B
hypotheses of the stream at once; on the CPU its twin is the composition it
replaces (both products over the ring's T rows, the rest masked), bit for
bit.

A beam step's self-attention sublayer (norm1 through F with the cache write,
the query, G, the output projection) and its feed-forward sublayer are
``self_attention_sublayer`` and ``feed_forward_sublayer``; the fused
language model's layers (``models.lm``) run the same two.

Cross-attention K/V are linear in the encoder frames, which do not change
within a decoded block, so ``project_cross_kv`` computes them once per block
and every beam step of the block reuses them; the numbers are those of
projecting at every step. They are stored head-major, (S, h, T, dk) a layer:
kernel H takes a block a (stream, head), whose rows then lie together, and
in the (S, T, d) rows of the projection they do not. Laid out once a block,
a step copies no K or V.

Precision: the cache and the projected K/V are stored in ``cfg.cache_dtype``.
The self-attention contracts in float32 over widened operands (the JAX
package's non-TPU branch); the cross-attention rounds the query to the K/V
dtype and the attention weights to the V dtype and accumulates both
contractions in float32. int8 K/V weights are dequantised by
``dense_weight``.

Tensor parallelism (``parallel.tp``): the attentions run on the rank's
heads (the activation cache keeps whole rows, d wide), the vocab-sharded
token embedding is looked up with masked local ids and summed over the tp
group, and ``output_layer``'s logits are gathered before the softmax.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from speechcatcher_tpu_torch.config import ModelConfig
from speechcatcher_tpu_torch.ops.kernels.add_layer_norm import add_layer_norm
from speechcatcher_tpu_torch.ops.kernels.cross_attention import cross_attention
from speechcatcher_tpu_torch.ops.kernels.lane_attention import lane_attention
from speechcatcher_tpu_torch.ops.layers import (
    Params,
    dense_weight,
    feed_forward,
    layer_norm,
    linear,
    multi_head_attention,
    row_parallel_product,
    sinusoidal_pe_table,
)
from speechcatcher_tpu_torch.parallel.tp import (
    copy_to_tp,
    gather_from_tp,
    local_heads,
    vocab_lookup,
)


class DecoderCache(NamedTuple):
    """Per-hypothesis self-attention activation cache (capacity Lmax)."""

    h: torch.Tensor  # (L, N, Lmax, d)


def init_decoder_cache(cfg: ModelConfig, n_hyps: int,
                       device: torch.device) -> DecoderCache:
    shape = (cfg.decoder_layers, n_hyps, cfg.max_tokens, cfg.decoder_dim)
    return DecoderCache(h=torch.zeros(shape, dtype=cfg.cache_torch_dtype,
                                      device=device))


def decoder_pe_table(cfg: ModelConfig):
    return sinusoidal_pe_table(cfg.decoder_dim, cfg.pos_enc_max_len)


def decoder_forward_train(params: Params, memory: torch.Tensor,
                          memory_lens: torch.Tensor, ys_in: torch.Tensor,
                          ys_in_lens: torch.Tensor, cfg: ModelConfig
                          ) -> torch.Tensor:
    """(B, L, vocab) logits of ys_in (B, L) over memory (B, Tm, d). Both
    masks are 3-D, (B, L, L) causal & padding and (B, 1, Tm), so the
    attention is the plain one."""
    pe = _pe_table(cfg, memory.device)
    b, l = ys_in.shape
    d = cfg.decoder_dim
    dev = memory.device
    x = (vocab_lookup(params["embed"]["weight"], ys_in.long()) * math.sqrt(d)
         + pe[None, :l])
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dev))
    pad = torch.arange(l, device=dev)[None, :] < ys_in_lens[:, None]
    tgt_mask = (pad[:, None, :] & causal[None, :, :]).float()
    mem_mask = (torch.arange(memory.shape[1], device=dev)[None, :]
                < memory_lens[:, None]).float()[:, None, :]
    for p_layer in params["layers"]:
        hn = layer_norm(p_layer["norm1"], x)
        x = x + multi_head_attention(p_layer["self_attn"], hn, hn, hn,
                                     tgt_mask, cfg.decoder_heads)
        hn = layer_norm(p_layer["norm2"], x)
        x = x + multi_head_attention(p_layer["src_attn"], hn, memory, memory,
                                     mem_mask, cfg.decoder_heads)
        hn = layer_norm(p_layer["norm3"], x)
        x = x + feed_forward(p_layer["feed_forward"], hn)
    if cfg.normalize_before:
        x = layer_norm(params["after_norm"], x)
    return output_logits(params, x)


def output_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``output_layer``'s logits over the whole vocabulary (gathered over
    the tp group, whose ranks hold its rows in blocks)."""
    return gather_from_tp(linear(params["output_layer"], copy_to_tp(x)))


@functools.lru_cache(maxsize=8)
def _pe_table(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(decoder_pe_table(cfg)).to(device)


def _attend_cached_lane(
    q: torch.Tensor,           # (N, d) one query per hypothesis, (S, B) order
    hh: torch.Tensor,          # (N, T, d) append-only cached hn rows
    hn_self: torch.Tensor,     # (N, d) this step's post-norm1 hidden
    p_attn: Params,            # this layer's self_attn params
    lane: torch.Tensor,        # (S, B, T) lane map
    pos: torch.Tensor,         # (N,) int64: rows t < pos are the history
    n_head: int,
) -> torch.Tensor:
    """Self-attention over the lazily reordered activation cache, on the
    rank's heads of `n_head` (its rows of the K and V weights).

    Row t of hypothesis b's history lives at lane ``lane[s, b, t]`` of its
    stream; kernel G (``lane_attention``) reads those rows in place.
    Scores use the K projection folded into the query, ``(W_k[h]ᵀ q_h) ·
    hn_t`` (the K bias cancels in the softmax), and the V projection is
    applied once to the weighted sum (the V bias adds once, as the weights
    sum to 1)."""
    n, _, d = hh.shape
    h = local_heads(n_head)
    dk = d // n_head
    wk = dense_weight(p_attn["linear_k"]).reshape(h, dk, d)
    wv = dense_weight(p_attn["linear_v"]).reshape(h, dk, d)
    qk = torch.einsum("nhk,hkd->nhd", q.reshape(n, h, dk), wk)
    u = lane_attention(qk, hh, hn_self, lane, pos, dk)
    out = torch.einsum("nhd,hkd->nhk", u, wv)
    bias = p_attn["linear_v"].get("bias")
    if bias is not None:
        out = out + bias.reshape(h, dk)
    return out.reshape(n, h * dk)


def self_attention_sublayer(p_norm: Params, p_attn: Params, h: torch.Tensor,
                            y: Optional[torch.Tensor],
                            b: Optional[torch.Tensor], cache_l: torch.Tensor,
                            pos: torch.Tensor, write: torch.Tensor,
                            lane: torch.Tensor, n_head: int):
    """One pre-norm self-attention sublayer of a beam step over a layer's
    lane-mapped cache ``cache_l`` (N, Lmax, d): the norm (kernel F) adds the
    pending sublayer output ``y`` and its bias ``b`` to the residual ``h``
    and writes this step's normalised row into the cache at ``pos`` where
    ``write``; the query, the attention over the rows below ``pos`` through
    the lane map (kernel G) and the output projection follow. Returns the
    new (h, y, b), the projection's bias left pending. The decoder's layers
    and the fused LM's (``models.lm``) both run it."""
    h, hn = add_layer_norm(p_norm, h, y, b, cache_l, pos, write)
    q = linear(p_attn["linear_q"], hn)
    att = _attend_cached_lane(q, cache_l, hn, p_attn, lane, pos, n_head)
    y, b = row_parallel_product(p_attn["linear_out"], att)
    return h, y, b


def feed_forward_sublayer(p_norm: Params, p_ff: Params, h: torch.Tensor,
                          y: torch.Tensor, b: Optional[torch.Tensor]):
    """One pre-norm ReLU feed-forward sublayer of a beam step: the norm
    (kernel F) adds the pending ``y`` and ``b`` to ``h``; returns the new
    (h, y, b), ``w_2``'s bias left pending."""
    h, hn = add_layer_norm(p_norm, h, y, b)
    y, b = row_parallel_product(
        p_ff["w_2"], torch.relu(linear(p_ff["w_1"], copy_to_tp(hn))))
    return h, y, b


def head_major(x: torch.Tensor, n_head: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(S, T, h·dk) projected rows as a contiguous (S, h, T, dk) tensor of
    `dtype`, h the rank's share of `n_head`: one pass that casts and
    transposes."""
    s, t, width = x.shape
    h = local_heads(n_head)
    out = torch.empty((s, h, t, width // h), dtype=dtype, device=x.device)
    out.copy_(x.reshape(s, t, h, width // h).transpose(1, 2))
    return out


def project_cross_kv(params: Params, memory: torch.Tensor, n_head: int,
                     cache_dtype: torch.dtype
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer (K, V) of the raw encoder frames (S, Tmax, d), head-major:
    (S, h, Tmax, dk) in `cache_dtype` (``head_major``), the layout in
    which kernel H reads them in place; laid out here, once a block,
    instead of in each beam step. The frames are made finite first: the
    CPU twin's masked value contraction would pass stale or NaN rows past
    enc_len on as 0·NaN."""
    mem_s = torch.where(torch.isfinite(memory), memory, 0.0).to(cache_dtype)
    return [
        (head_major(linear(p["src_attn"]["linear_k"], mem_s), n_head,
                    cache_dtype),
         head_major(linear(p["src_attn"]["linear_v"], mem_s), n_head,
                    cache_dtype))
        for p in params["layers"]
    ]


def decoder_step(
    params: Params,
    pe: torch.Tensor,
    cache: DecoderCache,
    memory: Optional[torch.Tensor],  # (S, Tmax, d) raw encoder frames
    tokens: torch.Tensor,            # (N,) last token; (S, B) order
    pos: torch.Tensor,               # (N,) position of that token
    enc_len: torch.Tensor,           # (S,) valid encoder frames
    lane: torch.Tensor,              # (S, B, Lmax) lane map
    write: torch.Tensor,             # (N,) bool, write this step's rows
    cfg: ModelConfig,
    beam: int,
    cross_kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, DecoderCache]:
    """Score the next token for N = S·B hypotheses.

    Returns (log-probs (N, vocab), cache with this step's rows written in
    place). ``cross_kv`` is ``project_cross_kv(params, memory, ...)``, made
    once per block by the caller; without it the step projects ``memory``
    itself."""
    d = cfg.decoder_dim
    cache_dt = cache.h.dtype
    if cross_kv is None:
        cross_kv = project_cross_kv(params, memory, cfg.decoder_heads,
                                    cache_dt)
    pos = pos.long()
    x = (vocab_lookup(params["embed"]["weight"], tokens.long()) * math.sqrt(d)
         + pe[pos])

    # The residual stream is h plus a pending sublayer output y and its
    # bias b, which the next norm's kernel adds (h + (y + b), the order of
    # h + linear(...)). Each norm1 also appends this step's rows to the
    # cache in place, with a fixed-shape write and no host sync: rows that
    # must not write keep the old value, rows past the capacity are
    # dropped, as JAX's mode="drop" scatter drops them.
    h, y, b = x, None, None
    for l, p_layer in enumerate(params["layers"]):
        h, y, b = self_attention_sublayer(
            p_layer["norm1"], p_layer["self_attn"], h, y, b, cache.h[l], pos,
            write, lane, cfg.decoder_heads)
        h, hn = add_layer_norm(p_layer["norm2"], h, y, b)
        q = linear(p_layer["src_attn"]["linear_q"], hn)
        mk_l, mv_l = cross_kv[l]
        att = cross_attention(q, mk_l, mv_l, enc_len)
        y, b = row_parallel_product(p_layer["src_attn"]["linear_out"], att)
        h, y, b = feed_forward_sublayer(p_layer["norm3"],
                                        p_layer["feed_forward"], h, y, b)
    if cfg.normalize_before:
        _, h = add_layer_norm(params["after_norm"], h, y, b)
    else:
        h = h + (y if b is None else y + b)
    logits = output_logits(params, h)
    return torch.log_softmax(logits, dim=-1), cache
