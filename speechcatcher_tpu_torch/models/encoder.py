"""Contextual block transformer/conformer encoder: streaming inference and
whole-utterance (training-mode) forward.

Port of ``speechcatcher_tpu/models/encoder.py``: conv2d subsampling, block
assembly with context ("addin") vectors, the layer stack with the per-layer
context carry, emit-window extraction, and the chunk buffering of
``StreamingEncoder.step`` (its lengths from ``geometry.plan_chunk``). The
same device work over a carry at fixed addresses (``EncoderCarry``), with the
stream's offsets as device integers, is what ``decode.graphs.ChunkStep``
captures per static signature (``StreamingEncoder.subsample_program``,
``blocks_program``). Transformer layers attend inside the
(block_size+2)-wide windows through the ``block_attention`` kernel
(``ops.layers.multi_head_attention``); the port's conformer layers through
the ``rel_block_attention`` kernel (``ops.conformer.rel_position_attention``),
with the raw sinusoid table of the window as position embedding; ESPnet's
contextual-block conformer layers (``contextual_block_conformer``) through
``block_attention`` again, their positions being the absolute ones added
to the block's frames, as in the transformer.

``encoder_forward_train`` runs whole utterances as the reference's training
forward does: every block of every utterance at once, N = B·block_num
windows per layer through the same attention kernels (through their
``autograd.Function``s where a loss needs gradients), or, for an utterance
no longer than one block, the plain layer stack under a padding mask.

Parameters: the encoder subtree of the port's model parameters, whose
``layers`` entry is a list of per-layer dicts (see ``params.unstack_layers``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from speechcatcher_tpu_torch.config import CB_CONFORMER, ModelConfig
from speechcatcher_tpu_torch.ops.conformer import (
    conv_module,
    rel_position_attention,
)
from speechcatcher_tpu_torch.ops.kernels.ring_append import ring_append_rows
from speechcatcher_tpu_torch.ops.layers import (
    Params,
    add_positional_encoding,
    feed_forward,
    layer_norm,
    linear,
    multi_head_attention,
    sinusoidal_pe_table,
    swish,
)
from speechcatcher_tpu_torch.geometry import (
    CONV_SPECS,
    ChunkPlan,
    carry_capacity,
    plan_chunk,
    subsampled_len,
)


def encoder_pe_table(cfg: ModelConfig) -> np.ndarray:
    """PE table long enough that no streaming offset reaches its end."""
    n = max(cfg.pos_enc_max_len, cfg.max_enc_frames + cfg.block_size + 2)
    return sinusoidal_pe_table(cfg.encoder_dim, n)


def conv2d_subsample(p: Params, x: torch.Tensor, input_layer: str
                     ) -> torch.Tensor:
    """(B, T, feat) → (B, T', d), float32. 'linear' is Linear →
    LayerNorm(eps 1e-5) → ReLU per frame, without time reduction. A bfloat16
    conv kernel rounds its input to bfloat16; the convolution runs on both
    widened to float32, so it accumulates in and returns float32."""
    if input_layer == "linear":
        return torch.relu(layer_norm(p["norm"], linear(p["out"], x), eps=1e-5))
    _, strides = CONV_SPECS[input_layer]
    h = x[:, None, :, :]  # NCHW: (B, 1, T, feat)
    for conv, s in zip(p["convs"], strides):
        w = conv["weight"]
        if w.dtype == torch.bfloat16:
            h, w = h.bfloat16().float(), w.float()
        h = F.conv2d(h, w, stride=s)
        h = torch.relu(h + conv["bias"][None, :, None, None])
    b, c, t, f = h.shape
    h = h.transpose(1, 2).reshape(b, t, c * f)
    return linear(p["out"], h)


def _attn_ffn(p_layer: Params, h: torch.Tensor, mask: Optional[torch.Tensor],
              n_head: int, pos_emb: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Pre-norm self-attention + FFN block (pos_emb unused)."""
    hn = layer_norm(p_layer["norm1"], h)
    h = h + multi_head_attention(p_layer["self_attn"], hn, hn, hn, mask, n_head)
    hn = layer_norm(p_layer["norm2"], h)
    return h + feed_forward(p_layer["feed_forward"], hn)


def _conformer_block(p_layer: Params, h: torch.Tensor,
                     mask: Optional[torch.Tensor], n_head: int,
                     pos_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Macaron conformer layer: ½FFN → rel-pos MHSA → conv module → ½FFN →
    final LayerNorm, each sub-block pre-norm with a residual."""
    hn = layer_norm(p_layer["norm_ff_macaron"], h)
    h = h + 0.5 * feed_forward(p_layer["feed_forward_macaron"], hn)
    hn = layer_norm(p_layer["norm_mha"], h)
    h = h + rel_position_attention(p_layer["self_attn"], hn, hn, hn, pos_emb,
                                   mask, n_head)
    hn = layer_norm(p_layer["norm_conv"], h)
    h = h + conv_module(p_layer["conv_module"], hn)
    hn = layer_norm(p_layer["norm_ff"], h)
    h = h + 0.5 * feed_forward(p_layer["feed_forward"], hn)
    return layer_norm(p_layer["norm_final"], h)


def _cb_conformer_block(p_layer: Params, h: torch.Tensor,
                        mask: Optional[torch.Tensor], n_head: int,
                        pos_emb: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """ESPnet's contextual-block conformer layer
    (``contextual_block_encoder_layer.py``): with ``macaron_style`` (the
    layer has ``feed_forward_macaron``) ½ swish FFN first; then MHSA with
    absolute positions (pos_emb unused; a 2-D block mask goes to kernel A),
    the conv module, the swish FFN (½ with macaron, else whole) and the
    final LayerNorm, each sub-block pre-norm with a residual."""
    scale = 1.0
    if "feed_forward_macaron" in p_layer:
        scale = 0.5
        hn = layer_norm(p_layer["norm_ff_macaron"], h)
        h = h + scale * feed_forward(p_layer["feed_forward_macaron"], hn,
                                     swish)
    hn = layer_norm(p_layer["norm_mha"], h)
    h = h + multi_head_attention(p_layer["self_attn"], hn, hn, hn, mask,
                                 n_head)
    hn = layer_norm(p_layer["norm_conv"], h)
    h = h + conv_module(p_layer["conv_module"], hn)
    hn = layer_norm(p_layer["norm_ff"], h)
    h = h + scale * feed_forward(p_layer["feed_forward"], hn, swish)
    return layer_norm(p_layer["norm_final"], h)


_LAYERS = {"transformer": _attn_ffn, "conformer": _conformer_block,
           CB_CONFORMER: _cb_conformer_block}


def _layer_fn(layer_kind: str):
    return _LAYERS[layer_kind]


def apply_layers_infer(
    layers: List[Params],
    xs_chunk: torch.Tensor,      # (B, bn, bs+2, d)
    mask: torch.Tensor,          # (bs+2, bs+2) shared block mask
    past_ctx: torch.Tensor,      # (B, L, d)
    has_past_ctx: torch.Tensor,  # (B,) bool
    n_head: int,
    last_block: Optional[torch.Tensor] = None,  # (B,) last VALID block
    layer_kind: str = "transformer",
    pos_emb: Optional[torch.Tensor] = None,     # (1, bs+2, d) for conformer
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming layer stack with context propagation.

    Returns (ys_chunk (B, bn, bs+2, d), next_ctx (B, L, d)). After each
    layer, position 0 of block 0 takes the carried context (or the block's
    own last frame on the first chunk) and position 0 of block i takes block
    i-1's last frame. The carried context is the last frame of block
    ``last_block[b]`` (default: the last block); the batched engine passes
    each stream's bn-1 when its trailing blocks are padding."""
    b, bn, w, d = xs_chunk.shape
    x = xs_chunk
    rows = None if last_block is None else (
        torch.arange(b, device=x.device), last_block.long())
    layer_fn = _layer_fn(layer_kind)
    next_ctx = []
    for l, p_layer in enumerate(layers):
        h = layer_fn(p_layer, x.reshape(b * bn, w, d), mask, n_head, pos_emb)
        x = h.reshape(b, bn, w, d)
        first_ctx = torch.where(has_past_ctx[:, None], past_ctx[:, l],
                                x[:, 0, -1, :])
        shifted = torch.cat([first_ctx[:, None, :], x[:, :-1, -1, :]], dim=1)
        x[:, :, 0, :] = shifted  # x is this layer's fresh output
        next_ctx.append(x[:, -1, -1, :] if rows is None
                        else x[rows[0], rows[1], -1, :])
    return x, torch.stack(next_ctx, dim=1)


def apply_layers_plain(layers: List[Params], x: torch.Tensor,
                       mask: Optional[torch.Tensor], n_head: int,
                       layer_kind: str = "transformer",
                       pos_emb: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Layer stack without blocking or context (short-utterance path)."""
    layer_fn = _layer_fn(layer_kind)
    for p_layer in layers:
        x = layer_fn(p_layer, x, mask, n_head, pos_emb)
    return x


def apply_layers_train(
    layers: List[Params],
    xs_chunk: torch.Tensor,  # (B, bn, bs+2, d)
    mask: torch.Tensor,      # (bs+2, bs+2)
    n_head: int,
    layer_kind: str = "transformer",
    pos_emb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Training-mode layer stack. Layer 0 keeps the addin context vectors
    that ``encoder_forward_train`` placed at position 0 of each block;
    before every later layer, position 0 of block 0 takes that block's own
    last frame and position 0 of block i the last frame of block i-1, both
    from the layer before."""
    b, bn, w, d = xs_chunk.shape
    layer_fn = _layer_fn(layer_kind)
    x = xs_chunk
    for l, p_layer in enumerate(layers):
        if l:
            ctx = torch.cat([x[:, 0:1, -1, :], x[:, :-1, -1, :]], dim=1)
            x = torch.cat([ctx[:, :, None, :], x[:, :, 1:, :]], dim=2)
        h = layer_fn(p_layer, x.reshape(b * bn, w, d), mask, n_head, pos_emb)
        x = h.reshape(b, bn, w, d)
    return x


def block_attention_mask(block_size: int) -> np.ndarray:
    """(bs+2, bs+2) mask: rows 1..bs+1 attend cols 0..bs."""
    m = np.zeros((block_size + 2, block_size + 2), dtype=np.float32)
    m[1 : block_size + 2, 0 : block_size + 1] = 1.0
    return m


def _build_blocks(xs: torch.Tensor, pe: torch.Tensor, prev_addin: torch.Tensor,
                  has_prev: torch.Tensor, npb: Union[int, torch.Tensor],
                  total_frame_num: int, block_num: int, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assemble (B, block_num, bs+2, d) chunks; returns (xs_chunk,
    new_prev_addin). `npb`, the blocks processed before, is a host int or a
    0-d device integer (the stream offset of the positional encodings)."""
    bs, hop = cfg.block_size, cfg.hop_size
    chunks: List[torch.Tensor] = []
    addins: List[torch.Tensor] = []
    for i in range(block_num):
        cur_hop = i * hop
        cl = min(bs, total_frame_num - cur_hop)
        chunk_data = xs[:, cur_hop : cur_hop + cl, :]
        if cfg.init_average:
            addin = chunk_data.mean(dim=1, keepdim=True)
        else:
            addin = chunk_data.amax(dim=1, keepdim=True)
        if cfg.ctx_pos_enc:
            addin = add_positional_encoding(addin, pe, npb + i)
        addins.append(addin)
        chunk = add_positional_encoding(chunk_data, pe, cur_hop + hop * npb)
        if cl < bs:
            chunk = F.pad(chunk, (0, 0, 0, bs - cl))
        chunks.append(chunk)
    first_prev = torch.where(has_prev[:, None, None], prev_addin, addins[0])
    prev_list = [first_prev] + addins[:-1]
    xs_chunk = torch.stack(
        [torch.cat([prev_list[i], chunks[i], addins[i]], dim=1)
         for i in range(block_num)],
        dim=1,
    )
    return xs_chunk, addins[-1]


def _extract_infer(ys_chunk: torch.Tensor, cfg: ModelConfig,
                   first_chunk: bool, is_final: bool, y_length: int
                   ) -> torch.Tensor:
    """Emit-window extraction from (B, bn, bs, d) block outputs."""
    bs, hop, la = cfg.block_size, cfg.hop_size, cfg.look_ahead
    offset = bs - la - hop
    bn = ys_chunk.shape[1]
    pieces: List[torch.Tensor] = []
    emitted = 0
    if first_chunk:
        pieces.append(ys_chunk[:, 0, 0:offset, :])
        emitted = offset
    for i in range(bn):
        if i == bn - 1 and is_final:
            cl = min(bs - offset, y_length - emitted)
        else:
            cl = hop
        cl = max(cl, 0)
        if cl:
            pieces.append(ys_chunk[:, i, offset : offset + cl, :])
            emitted += cl
    ys = torch.cat(pieces, dim=1)
    if ys.shape[1] != y_length:
        raise RuntimeError(f"extracted {ys.shape[1]} frames, expected "
                           f"{y_length}")
    return ys


def _infer_core(params: Params, pe: torch.Tensor, mask: torch.Tensor,
                xs: torch.Tensor, prev_addin: torch.Tensor,
                has_prev: torch.Tensor, past_ctx: torch.Tensor,
                has_past_ctx: torch.Tensor, npb: Union[int, torch.Tensor],
                cfg: ModelConfig,
                total_frame_num: int, block_num: int, first_chunk: bool,
                is_final: bool, y_length: int):
    """One streaming encoder step over assembled blocks."""
    xs_chunk, new_prev_addin = _build_blocks(
        xs, pe, prev_addin, has_prev, npb, total_frame_num, block_num, cfg
    )
    ys_chunk, next_ctx = apply_layers_infer(
        params["layers"], xs_chunk, mask, past_ctx, has_past_ctx,
        cfg.encoder_heads, layer_kind=cfg.encoder_type,
        pos_emb=pe[None, :cfg.block_size + 2],
    )
    ys_chunk = ys_chunk[:, :, 1 : cfg.block_size + 1, :]
    ys = _extract_infer(ys_chunk, cfg, first_chunk, is_final, y_length)
    if cfg.normalize_before:
        ys = layer_norm(params["after_norm"], ys)
    return ys, new_prev_addin, next_ctx


def _infer_short(params: Params, pe: torch.Tensor, xs: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Short-segment path: whole segment, no blocking, no mask."""
    x = add_positional_encoding(xs, pe, 0)
    x = apply_layers_plain(params["layers"], x, None, cfg.encoder_heads,
                           layer_kind=cfg.encoder_type,
                           pos_emb=pe[None, :xs.shape[1]])
    if cfg.normalize_before:
        x = layer_norm(params["after_norm"], x)
    return x


@dataclasses.dataclass
class EncoderState:
    """Streaming carry between chunks."""

    prev_addin: Optional[torch.Tensor] = None   # (B, 1, d)
    buf_before: Optional[torch.Tensor] = None   # (B, t0, n_mels)
    buf_after: Optional[torch.Tensor] = None    # (B, t1, d)
    n_processed_blocks: int = 0
    past_ctx: Optional[torch.Tensor] = None     # (B, L, d)


class EncoderCarry(NamedTuple):
    """The streaming carry of one stream at fixed addresses, for the chunk
    programs (``StreamingEncoder.subsample_program`` and
    ``blocks_program``): the lengths are the host's (``ChunkPlan``), the
    buffers the card's. ``raw`` holds the carried feature frames at the
    front and the chunk's after them, ``post`` the carried subsampled
    frames and then the new ones."""

    raw: torch.Tensor         # (1, RCAP, n_mels)
    post: torch.Tensor        # (1, PCAP, d)
    prev_addin: torch.Tensor  # (1, 1, d)
    past_ctx: torch.Tensor    # (1, L, d)


def init_carry(cfg: ModelConfig, device: torch.device) -> EncoderCarry:
    rcap, pcap = carry_capacity(cfg)
    d = cfg.encoder_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return EncoderCarry(zeros(1, rcap, cfg.n_mels), zeros(1, pcap, d),
                        zeros(1, 1, d), zeros(1, cfg.encoder_layers, d))


# The chunk programs' device integers, one int32 upload a chunk.
CHUNK_INTS = ("n_before", "n_after", "npb", "has_prev", "has_past",
              "enc_len", "n_samples")


def append_rows(buf: torch.Tensor, new: torch.Tensor,
                start: torch.Tensor) -> None:
    """buf[0, start : start + n] = new[0] for a (1, CAP, w) buffer, new
    (1, n, w) and a device start (1,) int32: kernel D at one slot and one
    layer."""
    n_new = torch.full((1,), new.shape[1], dtype=torch.int32,
                       device=buf.device)
    ring_append_rows(buf[None], new[None], start, n_new)


class StreamingEncoder:
    """Runs the encoder chunk by chunk (host arithmetic, device math).

    ``step`` is the eager form over an ``EncoderState``, the counterpart of
    the JAX package's ``StreamingEncoder.step``. ``subsample_program`` and
    ``blocks_program`` do the same device work over an ``EncoderCarry`` at
    fixed addresses, reading the stream's offsets from device integers
    (``CHUNK_INTS``) and appending the emitted frames to a ring with kernel
    D: the programs ``decode.graphs.ChunkStep`` captures, one per static
    signature, as the JAX package jit-compiles ``_subsample_jit`` and
    ``_infer_core`` / ``_infer_short``."""

    def __init__(self, params: Params, cfg: ModelConfig,
                 pe_table: Optional[torch.Tensor] = None):
        self.params = params
        self.cfg = cfg
        self.device = params["after_norm"]["weight"].device
        self.pe = (pe_table if pe_table is not None else
                   torch.from_numpy(encoder_pe_table(cfg)).to(self.device))
        self.mask = torch.from_numpy(
            block_attention_mask(cfg.block_size)).to(self.device)

    def init_state(self) -> EncoderState:
        return EncoderState()

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def step(self, feats: torch.Tensor, state: EncoderState, is_final: bool
             ) -> Tuple[torch.Tensor, Optional[EncoderState]]:
        """One chunk (B, T, n_mels) → (encoder_out (B, T', d), next_state).

        The output is empty while buffering; next_state is None after the
        final chunk."""
        cfg = self.cfg
        b = feats.shape[0]
        d = cfg.encoder_dim
        plan = plan_chunk(
            cfg, 0 if state.buf_before is None else state.buf_before.shape[1],
            feats.shape[1],
            0 if state.buf_after is None else state.buf_after.shape[1],
            state.n_processed_blocks, is_final)

        xs = feats
        if state.buf_before is not None:
            xs = torch.cat([state.buf_before, xs], dim=1)
        if plan.kind == "buffer":
            return self._zeros(b, 0, d), dataclasses.replace(
                state, buf_before=xs)
        buf_before = None if is_final else xs[:, plan.n_in - plan.n_before:]

        if plan.n_sub > 0:
            xs = conv2d_subsample(self.params["embed"],
                                  xs[:, :plan.n_conv_in], cfg.input_layer)
        else:
            # Final flush with a tail shorter than the conv kernel.
            xs = self._zeros(b, 0, d)
        if state.buf_after is not None:
            xs = torch.cat([state.buf_after, xs], dim=1)

        if plan.kind == "empty":
            return self._zeros(b, 0, d), None
        if plan.kind == "hold":
            return self._zeros(b, 0, d), dataclasses.replace(
                state, buf_before=buf_before, buf_after=xs)
        buf_after = None if is_final else xs[:, plan.total - plan.n_after:]
        xs = xs[:, :plan.n_blocks_in]
        if plan.kind == "short":
            return _infer_short(self.params, self.pe, xs, cfg), None

        npb = state.n_processed_blocks
        prev_addin = (state.prev_addin if state.prev_addin is not None
                      else self._zeros(b, 1, d))
        has_prev = torch.full((b,), state.prev_addin is not None,
                              dtype=torch.bool, device=self.device)
        past_ctx = (state.past_ctx if state.past_ctx is not None
                    else self._zeros(b, cfg.encoder_layers, d))
        has_past = torch.full((b,), state.past_ctx is not None,
                              dtype=torch.bool, device=self.device)

        ys, new_prev_addin, next_ctx = _infer_core(
            self.params, self.pe, self.mask, xs, prev_addin, has_prev,
            past_ctx, has_past, npb, cfg, plan.total, plan.block_num,
            plan.first_chunk, is_final, plan.y_length,
        )
        if is_final:
            return ys, None
        return ys, EncoderState(
            prev_addin=new_prev_addin,
            buf_before=buf_before,
            buf_after=buf_after,
            n_processed_blocks=plan.npb,
            past_ctx=next_ctx,
        )

    # -- the chunk programs over a carry at fixed addresses ------------------
    def subsample_program(self, plan: ChunkPlan, carry: EncoderCarry,
                          ints: torch.Tensor) -> None:
        """The conv subsampling of the chunk's feature frames (in
        ``carry.raw[:, :n_in]``), appended to ``carry.post`` after the
        carried frames; the residue moves to the front of ``raw``."""
        raw = carry.raw
        sub = conv2d_subsample(self.params["embed"], raw[:, :plan.n_conv_in],
                               self.cfg.input_layer)
        if not plan.is_final:
            raw[:, :plan.n_before] = raw[
                :, plan.n_in - plan.n_before:plan.n_in].clone()
        append_rows(carry.post, sub, ints[1:2])

    def blocks_program(self, plan: ChunkPlan, carry: EncoderCarry,
                       ints: torch.Tensor, ring: torch.Tensor) -> None:
        """The blocks of ``carry.post[:, :total]`` (``_infer_core``, or
        ``_infer_short`` for a short first final): the emitted frames are
        appended to `ring` (1, Tcap, d) at the stream's fill, the carries
        written in place."""
        xs = carry.post[:, :plan.n_blocks_in]
        if plan.kind == "short":
            ys = _infer_short(self.params, self.pe, xs, self.cfg)
        else:
            ys, new_prev_addin, next_ctx = _infer_core(
                self.params, self.pe, self.mask, xs, carry.prev_addin,
                ints[3:4].bool(), carry.past_ctx, ints[4:5].bool(), ints[2],
                self.cfg, plan.total, plan.block_num, plan.first_chunk,
                plan.is_final, plan.y_length)
            if not plan.is_final:
                carry.prev_addin.copy_(new_prev_addin)
                carry.past_ctx.copy_(next_ctx)
                post = carry.post
                post[:, :plan.n_after] = post[
                    :, plan.total - plan.n_after:plan.total].clone()
        append_rows(ring, ys, ints[5:6])


@functools.lru_cache(maxsize=8)
def _constants(cfg: ModelConfig, device: torch.device):
    """(PE table, block mask) of a config on a device, made once."""
    return (torch.from_numpy(encoder_pe_table(cfg)).to(device),
            torch.from_numpy(block_attention_mask(cfg.block_size)).to(device))


def encoder_forward_train(params: Params, feats: torch.Tensor,
                          ilens: torch.Tensor, cfg: ModelConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-utterance block-simulated forward: feats (B, T, n_mels), ilens
    (B,) → (ys (B, T', d), olens (B,))."""
    pe, mask = _constants(cfg, feats.device)
    layers = params["layers"]
    xs = conv2d_subsample(params["embed"], feats, cfg.input_layer)
    olens = subsampled_len(ilens, cfg.input_layer)

    total = xs.shape[1]
    bs, hop, la = cfg.block_size, cfg.hop_size, cfg.look_ahead
    past_size = bs - hop - la

    if total <= bs:
        x = add_positional_encoding(xs, pe, 0)
        pad_mask = (torch.arange(total, device=xs.device)[None, :]
                    < olens[:, None]).float()[:, None, :]
        x = apply_layers_plain(layers, x, pad_mask, cfg.encoder_heads,
                               layer_kind=cfg.encoder_type,
                               pos_emb=pe[None, :total])
        if cfg.normalize_before:
            x = layer_norm(params["after_norm"], x)
        return x, olens

    block_num = math.ceil(float(total - past_size - la) / float(hop))

    # Context vectors per block: the mean (or max) of its frames.
    addins = []
    for i in range(block_num):
        chunk = xs[:, i * hop: i * hop + min(bs, total - i * hop), :]
        addins.append(chunk.mean(dim=1) if cfg.init_average
                      else chunk.amax(dim=1))
    addin = torch.stack(addins, dim=1)  # (B, bn, d)
    if cfg.ctx_pos_enc:
        addin = add_positional_encoding(addin, pe, 0)
    xs_pe = add_positional_encoding(xs, pe, 0)

    # Chunks: [previous block's addin, bs frames (zero-padded), own addin].
    prev = torch.cat([addin[:, 0:1], addin[:, :block_num - 1]], dim=1)
    chunks = []
    for i in range(block_num):
        c = xs_pe[:, i * hop: i * hop + min(bs, total - i * hop), :]
        if c.shape[1] < bs:
            c = F.pad(c, (0, 0, 0, bs - c.shape[1]))
        chunks.append(torch.cat([prev[:, i:i + 1], c, addin[:, i:i + 1]],
                                dim=1))
    xs_chunk = torch.stack(chunks, dim=1)

    ys_chunk = apply_layers_train(
        layers, xs_chunk, mask, cfg.encoder_heads,
        layer_kind=cfg.encoder_type, pos_emb=pe[None, :bs + 2])
    ys_chunk = ys_chunk[:, :, 1:, :]  # drop the previous-context slot

    # Extraction on the frame indices after that slot.
    offset = bs - la - hop
    pieces = [ys_chunk[:, 0, 0:bs - la, :]]
    emitted = bs - la
    for i in range(1, block_num - 1):
        pieces.append(ys_chunk[:, i, offset:offset + hop, :])
        emitted += hop
    if block_num > 1:
        pieces.append(ys_chunk[:, block_num - 1,
                               offset:offset + total - emitted, :])
    ys = torch.cat(pieces, dim=1)
    if cfg.normalize_before:
        ys = layer_norm(params["after_norm"], ys)
    return ys, olens
