"""Batched multi-stream streaming engine: S concurrent sessions, one card.

Port of ``speechcatcher_tpu/serve/engine.py``. S streams share one copy of
the weights and advance in lockstep ticks. Every device computation is
batched over the stream axis with fixed capacity shapes and per-stream
length masks.

- All length bookkeeping (buffer fills, block counts, beam-round schedule)
  is host-side numpy (``geometry``, shared with the session): lengths are
  data-independent functions of the per-stream chunk counts. The encode
  and each beam round upload their per-stream integers in one packed
  (K, S) int32 transfer each.
- Device state is capacity-padded: waveform carry, pre/post-subsample
  feature carries, the emitted-encoder-frame ring ``enc_out``, the CTC
  log-prob ring and forward variables, beam arrays, the decoder cache and,
  with a fused LM, the LM's cache.
- A tick encodes every consuming stream, then runs beam rounds over the
  host-known schedule (``_round_schedule``): each round makes one block
  visible to the ready streams (``ctc_log_softmax`` → ``ctc_extend``) and
  runs their block beam loop; the other streams' state passes through
  unchanged (masked lockstep).
- On the card the encode is one CUDA graph per block count and wire format,
  and each round is the block loop's graphs (``decode.graphs.BlockLoop``):
  a tick uploads its integers and audio, replays the encode, replays each
  round's graphs (one host sync per ``STEPS_PER_REPLAY`` beam steps) and
  reads the partials back once, a tick later. The JAX engine runs the same
  tick as one program (``_fused_tick``). Under a tp group the same
  functions run eagerly: gloo collectives cannot be captured.
- Finals go through ``finalize_batch`` (a compact copy of the finishing
  slots: batched final encode, drain and final rounds) or ``finalize`` (the
  slot's state injected into the single-stream beam search).

Every per-stream ring append (the ``raw`` and ``post`` feature carries and
``enc_out``) is the ``ring_append_rows`` kernel, in place. Appends never
reach past a ring's capacity: the capacities are sized for it and the host
asserts it from its counters before each append, since the kernel drops
rows past the end where the JAX one-hot scatter clipped them to the last.

In place, and why it is safe: every tensor of the engine's state stays at
the address it was allocated at, which the graphs read. The rings (``raw``,
``post``, ``enc_out``, the CTC log-prob ring, the decoder cache and the
LM's) are appended in place and no snapshot holds them; every other field
is computed anew and copied back over the old one (``graphs.write_tree``).
``finalize`` copies the slot's state into the single-stream finalizer's, so
nothing lands in the engine's rings through a view.

The host's parts of a tick and of the finals (readback, plan, encode,
extract, drain, reset, ...) are spans of the port's tracer
(``utils.metrics.TRACER``), which records nothing unless started; its
counter ``encoder.windows`` adds the windows (streams × blocks a stream,
padding included) that each tick encode and each final encode send through
the layer stack, from the host's plan.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from speechcatcher_tpu_torch import geometry
from speechcatcher_tpu_torch.config import ModelConfig
from speechcatcher_tpu_torch.decode.beam_search import (
    BeamArrays,
    BlockDecodeState,
    BlockwiseSynchronousBeamSearch,
    LoopSettings,
    _sel0,
    fresh_block_state,
    init_beam_arrays,
    select_arrays,
)
from speechcatcher_tpu_torch.decode.ctc_prefix import CTCScorerState
from speechcatcher_tpu_torch.decode.graphs import (
    BlockLoop,
    ChunkInput,
    Upload,
    capture_graphs,
    clone_tree,
    tree_leaves,
    write_tree,
)
from speechcatcher_tpu_torch.device import resolve_device
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.models.decoder import DecoderCache
from speechcatcher_tpu_torch.models.lm import LMCache
from speechcatcher_tpu_torch.models.encoder import (
    EncoderState,
    apply_layers_infer,
    block_attention_mask,
    conv2d_subsample,
)
from speechcatcher_tpu_torch.ops.frontend import (
    logmel_frontend,
    logmel_of_frames,
)
from speechcatcher_tpu_torch.ops.kernels.ring_append import ring_append_rows
from speechcatcher_tpu_torch.ops.layers import layer_norm
from speechcatcher_tpu_torch.parallel.tp import tp_group
from speechcatcher_tpu_torch.serve.wire import mulaw_decode as _mulaw_decode
from speechcatcher_tpu_torch.utils.metrics import TRACER

logger = logging.getLogger(__name__)

# uint8 wire expansion table: one row per mu-law code, computed by the same
# host function clients use, so the uint8 ingest equals host decoding
# bit for bit.
_MULAW_TABLE = _mulaw_decode(np.arange(256, dtype=np.uint8))


class EngineBuffers(NamedTuple):
    """Device-resident per-stream buffers (fixed capacities)."""

    wave: torch.Tensor        # (S, WCAP) waveform carry, right-aligned
    raw: torch.Tensor         # (S, RCAP, n_mels) pre-subsample feature carry
    post: torch.Tensor        # (S, PCAP, d) post-subsample frame carry
    prev_addin: torch.Tensor  # (S, 1, d)
    past_ctx: torch.Tensor    # (S, L, d)
    enc_out: torch.Tensor     # (S, ECAP_PAD, d) emitted encoder frames


def _roll_left(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-stream circular left roll along axis 1; shift (S,) integer."""
    n = x.shape[1]
    idx = (torch.arange(n, device=x.device)[None, :]
           + shift.long()[:, None]) % n
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return x.gather(1, idx)


def _scatter_append(buf: torch.Tensor, new: torch.Tensor,
                    offset: torch.Tensor, n_valid: torch.Tensor
                    ) -> torch.Tensor:
    """buf[s, offset[s] + i] = new[s, i] for i < n_valid[s], in place
    (``ring_append_rows`` with L = 1). offset, n_valid: (S,) int32. new is
    passed as its producer left it (a strided view, float32 into a
    bfloat16 ring): the kernel reads and casts it."""
    ring_append_rows(buf[None], new[None], offset, n_valid)
    return buf


def _assert_fits(name: str, fill: np.ndarray, add: np.ndarray,
                 cap: int) -> None:
    """Host check that an append stays inside its ring."""
    over = np.asarray(fill) + np.asarray(add) > cap
    if over.any():
        raise AssertionError(
            f"{name} append past capacity {cap}: fill {np.asarray(fill)[over]}"
            f" + {np.asarray(add)[over]}")


# ---------------------------------------------------------------------------
# Tick computations
# ---------------------------------------------------------------------------

def _tick_frontend(wave, audio, wave_len, trim_start, keep_from, keep_len,
                   window, mel_fb, mean, inv_std, n_fft: int, hop: int):
    """Waveform-carry concat + log-mel + per-stream trim alignment.

    Returns (feats (S, FCAP, n_mels) valid from index 0, new wave (S, WCAP)
    holding the carry right-aligned)."""
    wcap = wave.shape[1]
    combined = torch.cat([wave, audio], dim=1)                  # (S, WCAP+A)
    combined = _roll_left(combined, wcap - wave_len)            # data at 0
    feats = logmel_frontend(combined, window, mel_fb, mean, inv_std,
                            n_fft=n_fft, hop=hop)
    feats = _roll_left(feats, trim_start)                       # valid at 0
    # Right-aligned, so next tick's (wcap - wave_len) roll lands the data at
    # position 0 of the combined window.
    new_wave = _roll_left(combined, keep_from + keep_len - wcap)[:, :wcap]
    return feats, new_wave.contiguous()


def _tick_subsample(p_embed, raw, feats, raw_len, n_feats, consumed,
                    cfg: ModelConfig):
    """Append feats to the raw carry (in place), run the conv subsampling
    over the whole capacity. The conv is translation-invariant with VALID
    padding, so the frames it gives over the padded buffer are exactly those
    of slicing first. Returns (sub (S, SUBCAP, d), new raw)."""
    _scatter_append(raw, feats, raw_len, n_feats)
    sub = conv2d_subsample(p_embed, raw, cfg.input_layer)
    return sub, _roll_left(raw, consumed)


def _block_inputs(pe, post, npb, has_prev, prev_addin, cfg: ModelConfig,
                  maxb: int, post_total=None):
    """Assemble (S, maxb, bs+2, d) block inputs from the post carry.

    Blocks i = 0..maxb-1 start at i*hop. With post_total (final blocks),
    frames past each stream's end are masked: the add-in averages only the
    valid frames and padding stays exactly zero after the PE. Returns
    (xs_chunk, addins (S, maxb, 1, d))."""
    d = cfg.encoder_dim
    bs, hop = cfg.block_size, cfg.hop_size
    sqrt_d = math.sqrt(d)
    pcap = post.shape[1]
    npb = npb.long()
    chunks, addins = [], []
    for i in range(maxb):
        st = min(i * hop, pcap - bs)   # the JAX slice clamps the same way
        blk = post[:, st:st + bs]
        if post_total is None:
            fmask = None
            addin = (blk.mean(dim=1, keepdim=True) if cfg.init_average
                     else blk.amax(dim=1, keepdim=True))
        else:
            cl = (post_total.long() - i * hop).clamp(1, bs)
            fmask = (torch.arange(bs, device=post.device)[None, :]
                     < cl[:, None])[:, :, None]
            blk = torch.where(fmask, blk, 0.0)
            if cfg.init_average:
                addin = blk.sum(dim=1, keepdim=True) / cl[:, None, None]
            else:
                addin = torch.where(fmask, blk, -math.inf).amax(
                    dim=1, keepdim=True)
        if cfg.ctx_pos_enc:
            pe_a = pe[(npb + i).clamp(0, pe.shape[0] - 1)]
            addin = addin * sqrt_d + pe_a[:, None, :]
        addins.append(addin)
        start = (i * hop + hop * npb).clamp(0, pe.shape[0] - bs)
        pe_c = pe[start[:, None] + torch.arange(bs, device=pe.device)]
        chunk = blk * sqrt_d + pe_c
        if fmask is not None:
            chunk = torch.where(fmask, chunk, 0.0)
        chunks.append(chunk)
    first_prev = torch.where(has_prev[:, None, None], prev_addin, addins[0])
    prev_list = [first_prev] + addins[:-1]
    xs_chunk = torch.stack(
        [torch.cat([prev_list[i], chunks[i], addins[i]], dim=1)
         for i in range(maxb)], dim=1)
    return xs_chunk, torch.stack(addins, dim=1)


def _tick_blocks(p_enc, pe, mask, post, bn, npb, has_prev, has_past,
                 prev_addin, past_ctx, enc_out, buf_len, emitted,
                 cfg: ModelConfig, maxb: int):
    """Run up to ``maxb`` FULL blocks per stream (streaming path) and append
    the emitted frames to enc_out in place. Returns (new post, new
    prev_addin, new past_ctx)."""
    s = post.shape[0]
    d = cfg.encoder_dim
    bs, hop, la = cfg.block_size, cfg.hop_size, cfg.look_ahead
    offset = bs - la - hop
    xs_chunk, addins = _block_inputs(pe, post, npb, has_prev, prev_addin, cfg,
                                     maxb)
    any_blocks = bn > 0
    last_idx = (bn.long() - 1).clamp(0, maxb - 1)
    ys_chunk, next_ctx = apply_layers_infer(
        p_enc["layers"], xs_chunk, mask, past_ctx, has_past,
        cfg.encoder_heads, last_block=last_idx, layer_kind=cfg.encoder_type,
        pos_emb=pe[None, :bs + 2])
    ys_chunk = ys_chunk[:, :, 1:bs + 1, :]                      # (S,maxb,bs,d)

    # Context and add-in carry come from each stream's LAST VALID block;
    # streams with bn == 0 keep their state.
    rows = torch.arange(s, device=post.device)
    new_prev_addin = torch.where(any_blocks[:, None, None],
                                 addins[rows, last_idx], prev_addin)
    new_past_ctx = torch.where(any_blocks[:, None, None], next_ctx, past_ctx)

    # Emission staging: a stream's first chunk also emits the leading
    # `offset` frames of block 0.
    lead = ys_chunk[:, 0, 0:offset, :]
    body = torch.cat([ys_chunk[:, i, offset:offset + hop, :]
                      for i in range(maxb)], dim=1)
    first = npb == 0
    stage_first = torch.cat([lead, body], dim=1)
    stage_later = torch.cat(
        [body, torch.zeros((s, offset, d), dtype=post.dtype,
                           device=post.device)], dim=1)
    staging = torch.where(first[:, None, None], stage_first, stage_later)
    if cfg.normalize_before:
        staging = layer_norm(p_enc["after_norm"], staging)
    _scatter_append(enc_out, staging, buf_len, emitted)
    return _roll_left(post, bn * hop), new_prev_addin, new_past_ctx


def _final_frontend(wave, audio, wave_len, total_p, trim_start, window,
                    mel_fb, mean, inv_std, n_fft: int, hop: int, fcap: int):
    """Exact-length final frontend, batched over the capacity buffers.

    The final chunk runs the exact-length STFT of the reference
    (``apply_frontend`` final): centre reflect padding at the TRUE end of
    each stream's audio, zero padding to win_length for short tails, no
    trailing trim. The right reflection is the reversed pre-end tail written
    at each stream's end; the left one is static (data starts at 0)."""
    s, wcap = wave.shape
    dev = wave.device
    combined = torch.cat([wave, audio], dim=1)
    combined = _roll_left(combined, wcap - wave_len)            # data at 0
    n = combined.shape[1]
    total_p = total_p.long()
    combined = torch.where(
        torch.arange(n, device=dev)[None, :] < total_p[:, None], combined, 0.0)
    pad = n_fft // 2
    combined = torch.cat(
        [combined, torch.zeros((s, pad), dtype=combined.dtype, device=dev)],
        dim=1)                                                  # (S, n+pad)
    j = torch.arange(pad, device=dev)[None, :]
    # x[tp-2], x[tp-3], ... (total_p ≥ win_length > pad: checked at init).
    tail = combined.gather(1, (total_p - 1 - pad).clamp(min=0)[:, None]
                           + (pad - 1 - j))
    combined = combined.scatter(1, total_p[:, None] + j, tail)
    left = combined[:, 1:pad + 1].flip(1)                       # x[-i] = x[i]
    padded = torch.cat([left, combined], dim=1)                 # (S, n+2pad)
    feats = logmel_of_frames(padded.unfold(1, n_fft, hop)[:, :fcap], window,
                             mel_fb, mean, inv_std, n_fft)
    return _roll_left(feats, trim_start)                        # valid at 0


def _final_blocks(p_enc, pe, mask, post, bn, npb, has_prev, has_past,
                  prev_addin, past_ctx, enc_out, buf_len, post_total, first,
                  y_emit, cfg: ModelConfig, maxb: int):
    """Final-block encoder step, batched: the single-stream is_final
    semantics (short last block masked in the add-in average and zero after
    the PE; each block emits hop frames, the last one the remainder).
    Appends the emitted frames to enc_out in place."""
    s = post.shape[0]
    d = cfg.encoder_dim
    bs, hop, la = cfg.block_size, cfg.hop_size, cfg.look_ahead
    offset = bs - la - hop
    dev = post.device
    xs_chunk, _ = _block_inputs(pe, post, npb, has_prev, prev_addin, cfg,
                                maxb, post_total=post_total)
    last_idx = (bn.long() - 1).clamp(0, maxb - 1)
    ys_chunk, _ = apply_layers_infer(
        p_enc["layers"], xs_chunk, mask, past_ctx, has_past,
        cfg.encoder_heads, last_block=last_idx, layer_kind=cfg.encoder_type,
        pos_emb=pe[None, :bs + 2])
    ys_chunk = ys_chunk[:, :, 1:bs + 1, :]                      # (S,maxb,bs,d)

    # Emission gather: emitted position p maps back to (block, index in
    # block); the lead `offset` frames of block 0 come first for first-chunk
    # streams, and the last block emits up to hop + la frames.
    stcap = offset + (maxb - 1) * hop + hop + la
    p = torch.arange(stcap, device=dev)[None, :]
    lead_n = torch.where(first, offset, 0)[:, None]
    q = p - lead_n
    blk = torch.minimum(torch.div(q, hop, rounding_mode="floor").clamp(min=0),
                        last_idx[:, None])
    idx_in = torch.where(q < 0, p, offset + q - blk * hop)
    flat = (blk * bs + idx_in).clamp(0, maxb * bs - 1)          # (S, stcap)
    ys_flat = ys_chunk.reshape(s, maxb * bs, d)
    staging = ys_flat.gather(1, flat[:, :, None].expand(-1, -1, d))
    if cfg.normalize_before:
        staging = layer_norm(p_enc["after_norm"], staging)
    _scatter_append(enc_out, staging, buf_len, y_emit)


def _gather_new_frames(enc_out: torch.Tensor, vis_len: torch.Tensor,
                       extcap: int) -> torch.Tensor:
    """enc_out[s, vis[s] : vis[s] + extcap] per stream (garbage past the
    valid range). enc_out carries extcap rows of tail padding, so the start
    never clips: a clipped start would hand ctc_extend the wrong frames
    near a full ring."""
    start = vis_len.long().clamp(0, enc_out.shape[1] - extcap)
    dev = enc_out.device
    idx = start[:, None] + torch.arange(extcap, device=dev)[None]
    return enc_out[torch.arange(enc_out.shape[0], device=dev)[:, None], idx]


def _ring_frames(enc_out: torch.Tensor, extcap: int,
                 ints: torch.Tensor) -> torch.Tensor:
    """A round's new frames from the ring, at the uploaded vis (row 0). A
    bfloat16 ring's frames widen exactly to float32, as JAX's mixed-type
    einsum promotes them."""
    return _gather_new_frames(enc_out, ints[0], extcap).float()


def _reset_program(mask: torch.Tensor, arrays: BeamArrays,
                   prev_arrays: BeamArrays, buffers: EngineBuffers,
                   prev_valid: torch.Tensor, process_idx: torch.Tensor,
                   output_index: torch.Tensor, cfg: ModelConfig, beam: int):
    """Fresh-session state for the masked slots, as new tensors.

    Large per-stream buffers are left as they are: the decoder cache and
    the LM's (a fresh session writes each position's rows before any step
    reads them), the enc_out ring and the CTC log-prob ring (every read is
    bounded by buf_len / ctc.enc_len, both reset, and a fresh session's
    appends overwrite the rows before they are read)."""
    fresh = init_beam_arrays(cfg, mask.shape[0], beam, mask.device,
                             snapshot=True)
    sel = select_arrays(mask, fresh, arrays)
    arrays = sel._replace(ctc=sel.ctc._replace(logp=arrays.ctc.logp))
    buffers = buffers._replace(**{
        f: _sel0(mask, 0.0, getattr(buffers, f))
        for f in buffers._fields if f != "enc_out"})
    return (
        arrays,
        select_arrays(mask, fresh, prev_arrays),
        buffers,
        torch.where(mask, False, prev_valid),
        torch.where(mask, 0, process_idx),
        torch.where(mask, 0, output_index),
    )


def _rows_arrays(a: BeamArrays, rows: torch.Tensor) -> BeamArrays:
    """The given streams' rows of every BeamArrays field (copies for an
    index tensor, views for a slice)."""
    return BeamArrays(
        yseq=a.yseq[rows], xpos=a.xpos[rows], lane=a.lane[rows],
        ylen=a.ylen[rows], score=a.score[rows], score_dec=a.score_dec[rows],
        score_ctc=a.score_ctc[rows],
        ctc=CTCScorerState(logp=a.ctc.logp[rows], enc_len=a.ctc.enc_len[rows],
                           r=a.ctc.r[rows], s=a.ctc.s[rows]),
        score_lm=None if a.score_lm is None else a.score_lm[rows],
    )


def _cache_rows(h: torch.Tensor, rows: torch.Tensor,
                beam: int) -> torch.Tensor:
    """The given streams' hypothesis rows of a (L, S·B, Lmax, d) cache, as
    an (L, F·B, Lmax, d) copy."""
    l_dim, s_b, lmax, d = h.shape
    h = h.reshape(l_dim, s_b // beam, beam, lmax, d)[:, rows]
    return h.reshape(l_dim, rows.shape[0] * beam, lmax, d)


def _extract_rows(buffers: EngineBuffers, arrays: BeamArrays,
                  prev_arrays: BeamArrays, dec_cache: DecoderCache,
                  lm_cache: Optional[LMCache], prev_valid, process_idx,
                  output_index, rows: torch.Tensor, beam: int):
    """Copy the state of F slots into a compact F-wide working set, so the
    final encode, drain and final rounds run at width F, not S."""
    return (
        EngineBuffers(*[x[rows] for x in buffers]),
        _rows_arrays(arrays, rows),
        _rows_arrays(prev_arrays, rows),
        DecoderCache(h=_cache_rows(dec_cache.h, rows, beam)),
        None if lm_cache is None else LMCache(
            h=_cache_rows(lm_cache.h, rows, beam)),
        prev_valid[rows],
        process_idx[rows],
        output_index[rows],
    )


def _gather_final_rows(arrays: BeamArrays) -> np.ndarray:
    """Best hypothesis of every row, packed [ylen | yseq | xpos | score] in
    float64 (token ids and positions are exact there) for one readback."""
    return torch.cat([
        arrays.ylen[:, None].double(),
        arrays.yseq[:, 0].double(),
        arrays.xpos[:, 0].double(),
        arrays.score[:, 0, None].double(),
    ], dim=1).cpu().numpy()


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SlotCounters:
    """Host-side per-slot bookkeeping (numpy, one entry per stream slot)."""

    active: np.ndarray
    first_wave: np.ndarray
    wave_len: np.ndarray
    raw_len: np.ndarray
    post_len: np.ndarray
    npb: np.ndarray
    has_prev: np.ndarray
    has_past: np.ndarray
    buf_len: np.ndarray
    vis_len: np.ndarray
    processed_block: np.ndarray

    @classmethod
    def zeros(cls, s: int) -> "SlotCounters":
        return cls(
            active=np.zeros(s, bool),
            first_wave=np.ones(s, bool),
            wave_len=np.zeros(s, np.int64),
            raw_len=np.zeros(s, np.int64),
            post_len=np.zeros(s, np.int64),
            npb=np.zeros(s, np.int64),
            has_prev=np.zeros(s, bool),
            has_past=np.zeros(s, bool),
            buf_len=np.zeros(s, np.int64),
            vis_len=np.zeros(s, np.int64),
            processed_block=np.zeros(s, np.int64),
        )

    def reset_slot(self, s: int):
        self.active[s] = False
        self.first_wave[s] = True
        for a in (self.wave_len, self.raw_len, self.post_len, self.npb,
                  self.buf_len, self.vis_len, self.processed_block):
            a[s] = 0
        self.has_prev[s] = self.has_past[s] = False


class StreamingEngine:
    """S-slot batched streaming decoder (one model copy, one card)."""

    def __init__(
        self,
        model: ASRModel,
        n_slots: int = 8,
        beam_size: int = 5,
        ctc_weight: float = 0.3,
        use_bbd: bool = True,
        chunk_samples: int = 8192,
        pre_beam_size: Optional[int] = None,
        penalty: float = 0.0,
        max_length: Optional[int] = None,
        eos_commit: str = "native",
        device: Union[str, torch.device] = "cuda",
        lm_weight: Optional[float] = None,
    ):
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model lies on {model.device}, engine asked "
                             f"for {dev}")
        self.model = model
        self.device = model.device
        cfg = model.cfg
        self.cfg = cfg
        self.S = n_slots
        self.beam = beam_size
        self.ctc_weight = ctc_weight
        # The fused LM's weight: the model configuration's unless given.
        self.lm_weight = cfg.lm_weight if lm_weight is None else lm_weight
        self.use_bbd = use_bbd
        self.pre_beam = min(pre_beam_size or cfg.pre_beam_size, cfg.vocab_size)
        self.penalty = penalty
        self.eos_commit = eos_commit
        self.A = chunk_samples
        # Per-utterance beam-step budget (each step pays an O(visible
        # frames) CTC recursion).
        self.max_length = min(max_length or cfg.max_tokens - 1,
                              cfg.max_tokens - 1)

        # Capacities. _final_frontend's right reflection needs its start
        # total_p-1-pad ≥ 0, i.e. win_length > n_fft//2.
        if cfg.win_length <= cfg.n_fft // 2:
            raise ValueError(
                "win_length must exceed n_fft//2 for the final-frontend "
                f"reflection (got win_length={cfg.win_length}, "
                f"n_fft={cfg.n_fft})")
        (self.WCAP, self.FCAP, self.RCAP, self.SUBCAP, self.MAXB, self.PCAP,
         self.ECAP, self.EXTCAP, self.ECAP_PAD) = geometry.engine_capacities(
             cfg, self.A)

        self.buffers = self._new_buffers(self.S)
        # The block loop's state: the beam; a snapshot with an EMPTY CTC
        # log-prob ring (append-only, always read from the live arrays);
        # one lane-resident decoder cache for all hypotheses (rows are
        # append-only; rollback restores the lane map instead); the
        # per-stream counters. Like the buffers, it stays where it is
        # allocated: every tick, reset and final writes it in place.
        self.block = fresh_block_state(cfg, self.S, beam_size, dev)
        self.c = SlotCounters.zeros(self.S)
        # Slots finalize_batch quarantined (their finalize raised).
        self.quarantined = 0
        self._slot_clean = np.ones(self.S, bool)  # fresh-state slots

        self._mask = torch.from_numpy(
            block_attention_mask(cfg.block_size)).to(dev)
        self._mulaw = torch.from_numpy(_MULAW_TABLE).to(dev)
        # Host upper bound on any stream's prefix length (from the per-tick
        # readback).
        self.ylen_upper = 1
        self._last_packed: Optional[np.ndarray] = None
        # Largest new-frames gather start of the last compact drain (-1
        # until finalize_batch ran the compact path).
        self._last_drain_max_start = -1
        # Partials lag one tick: the last round's [ylen | best yseq] stays
        # on the device until the next tick reads it. A slot reset between
        # the two must not resurface the previous utterance's tokens for
        # the session that reuses the slot: _reset_slots patches
        # _last_packed, flags the slot stale and marks its pending row not
        # fresh; tick() re-applies the stale mask after every read until a
        # row computed after the reset arrives.
        self._pending_packed: Optional[torch.Tensor] = None
        self._pending_fresh: Optional[np.ndarray] = None
        self._stale_partial = np.zeros(self.S, bool)

        # Single-stream finalizer (shares the weights; its frame ring has
        # the dtype of enc_out, which it takes over).
        self._finalizer = BlockwiseSynchronousBeamSearch(
            model, beam_size=beam_size, ctc_weight=ctc_weight,
            use_bbd=use_bbd, penalty=penalty, max_length=self.max_length,
            eos_commit=eos_commit, memory_dtype=cfg.enc_ring_torch_dtype,
            lm_weight=self.lm_weight,
        )
        # Its chunk step runs eagerly: a final's signature follows the
        # slot's carried fills and the tail's length, more than
        # capture_graphs can enumerate, and after capture_graphs serving
        # captures nothing.
        self._finalizer.chunk.graphed = False

        # On the card the encode and each round's block loop run as CUDA
        # graphs over the state above, in one memory pool (decode.graphs);
        # eagerly on the CPU and under a tp group, whose collectives cannot
        # be captured.
        self.graphed = dev.type == "cuda" and tp_group() is None
        self._graph_pool = (torch.cuda.graph_pool_handle() if self.graphed
                            else None)
        self._settings = LoopSettings(beam_size, self.pre_beam, ctc_weight,
                                      use_bbd, self.max_length, penalty,
                                      eos_commit, self.lm_weight)
        self._loop = self._block_loop(self.block, self.buffers.enc_out)
        self._enc_ints = Upload((15, self.S), torch.int32, dev)
        self._audio_in: Dict[np.dtype, Upload] = {}
        self._encode_graphs: dict = {}
        # finalize_batch's compact working sets, by width (_compact_width).
        self._compact: Dict[int, Tuple[EngineBuffers, BlockLoop]] = {}

    @property
    def arrays(self) -> BeamArrays:
        return self.block.arrays

    @property
    def prev_arrays(self) -> BeamArrays:
        return self.block.prev_arrays

    @property
    def dec_cache(self) -> DecoderCache:
        return self.block.dec_cache

    @property
    def lm_cache(self) -> Optional[LMCache]:
        return self.block.lm_cache

    @property
    def prev_valid_dev(self) -> torch.Tensor:
        return self.block.prev_valid

    @property
    def process_idx_dev(self) -> torch.Tensor:
        return self.block.process_idx

    @property
    def output_index_dev(self) -> torch.Tensor:
        return self.block.output_index

    def _new_buffers(self, n: int) -> EngineBuffers:
        cfg = self.cfg
        d = cfg.encoder_dim
        f32 = dict(dtype=torch.float32, device=self.device)
        return EngineBuffers(
            wave=torch.zeros((n, self.WCAP), **f32),
            raw=torch.zeros((n, self.RCAP, cfg.n_mels), **f32),
            post=torch.zeros((n, self.PCAP, d), **f32),
            prev_addin=torch.zeros((n, 1, d), **f32),
            past_ctx=torch.zeros((n, cfg.encoder_layers, d), **f32),
            enc_out=torch.zeros((n, self.ECAP_PAD, d),
                                dtype=cfg.enc_ring_torch_dtype,
                                device=self.device),
        )

    def _block_loop(self, block: BlockDecodeState,
                    enc_out: torch.Tensor) -> BlockLoop:
        """The block loop over `block`, reading new frames and the
        cross-attention memory from the ring `enc_out`."""
        return BlockLoop(self.model, block, enc_out, self._settings,
                         frames=functools.partial(_ring_frames, enc_out,
                                                  self.EXTCAP),
                         extcap=self.EXTCAP, pool=self._graph_pool)

    def capture_graphs(self) -> None:
        """Capture the engine's graphs now rather than at first use: the
        block loop, the encode for every block count and wire format,
        finalize_batch's block loop at every compact width and finalize's
        (whose chunk step runs eagerly). ``parallel.serve_sharding``
        captures its replicas one after the other this way. A no-op where
        the engine runs eagerly."""
        if not self.graphed:
            return
        self._loop.capture()
        fin = self._finalizer
        fin.loop.settings = fin._settings()
        fin.loop.capture()
        for wire in (np.float32, np.int16, np.uint8):
            audio = self._audio_upload(np.dtype(wire)).dev
            for maxb in range(self.MAXB + 1):
                self._encode_graph(maxb, audio)
        for width in self._compact_widths():
            self._compact_set(width)[1].capture()

    def _ints(self, rows) -> torch.Tensor:
        """One packed (K, n) int32 upload of per-stream host integers."""
        return torch.from_numpy(
            np.stack([np.asarray(r) for r in rows]).astype(np.int32)
        ).to(self.device)

    # ------------------------------------------------------------------
    # Memory accounting
    # ------------------------------------------------------------------
    def hbm_bytes_per_stream(self) -> Dict[str, int]:
        """Bytes of device state per stream slot, by component (weights
        excluded: one copy, shared by all slots)."""
        def tree_bytes(t) -> int:
            return sum(x.numel() * x.element_size() for x in tree_leaves(t))

        per = {
            "frontend_buffers": tree_bytes(self.buffers),
            "beam_arrays": tree_bytes(self.arrays),
            "rewind_snapshot": tree_bytes(self.prev_arrays),
            "decoder_cache": tree_bytes(self.dec_cache),
        }
        if self.lm_cache is not None:
            per["lm_cache"] = tree_bytes(self.lm_cache)
        return {k: v // self.S for k, v in per.items()} | {
            "total": sum(per.values()) // self.S
        }

    def graph_bytes_per_stream(self) -> Dict[str, int]:
        """Device bytes per stream slot that the port's block loops hold
        besides ``hbm_bytes_per_stream`` (which counts what the JAX engine
        holds): the cross-attention K/V of the ring that the graphed
        prologue keeps for the steps, and finalize_batch's compact sets at
        every width ``_compact_widths`` allows (each row the state of a
        slot and its cross K/V)."""
        cfg = self.cfg
        itemsize = self.dec_cache.h.element_size()
        cross_kv = (cfg.decoder_layers * 2 * self.ECAP_PAD
                    * cfg.decoder_dim * itemsize)
        state = self.hbm_bytes_per_stream()["total"]
        rows = sum(self._compact_widths())
        per = {"cross_kv": cross_kv,
               "compact_finals": rows * (state + cross_kv) // self.S}
        return per | {"total": sum(per.values())}

    # ------------------------------------------------------------------
    # Slot management
    # ------------------------------------------------------------------
    def acquire_slot(self) -> Optional[int]:
        free = np.flatnonzero(~self.c.active)
        if len(free) == 0:
            return None
        # Prefer slots already reset (finalize_batch leaves them clean).
        clean = free[self._slot_clean[free]]
        s = int(clean[0]) if len(clean) else int(free[0])
        if not self._slot_clean[s]:
            self._reset_slot(s)
        self.c.reset_slot(s)
        self._slot_clean[s] = False
        self.c.active[s] = True
        return s

    def release_slot(self, s: int):
        self._reset_slot(s)

    def slot_would_stall(self, s: int) -> bool:
        """True when one more chunk could overflow the encoder ring: the
        guard tick() applies before consuming a slot's audio (tick() skips
        a stalled slot, so a chunk passed anyway is dropped)."""
        return bool(geometry.would_stall(self.cfg, self.MAXB, self.ECAP,
                                         self.c.buf_len[s]))

    def _reset_slot(self, s: int):
        self._reset_slots([s])

    def _reset_slots(self, slots: List[int]):
        """Reset several slots at once."""
        mask = np.zeros(self.S, bool)
        for s in slots:
            self.c.reset_slot(s)
            mask[s] = True
        write_tree(
            (self.arrays, self.prev_arrays, self.buffers, self.prev_valid_dev,
             self.process_idx_dev, self.output_index_dev),
            _reset_program(
                torch.from_numpy(mask).to(self.device), self.arrays,
                self.prev_arrays, self.buffers, self.prev_valid_dev,
                self.process_idx_dev, self.output_index_dev, self.cfg,
                self.beam))
        self._slot_clean[slots] = True
        if self._last_packed is not None:
            for s in slots:
                self._last_packed[s, 0] = 1  # stale partials cleared
        self._stale_partial[slots] = True
        if self._pending_fresh is not None:
            self._pending_fresh[slots] = False

    # ------------------------------------------------------------------
    # Tick
    # ------------------------------------------------------------------
    def tick(self, audio: Dict[int, np.ndarray]) -> Dict[int, List[int]]:
        """Advance all streams by one chunk.

        audio: slot → exactly `chunk_samples` samples: float32 in [-1, 1],
        int16 PCM (normalised by /32767 on the device) or uint8 mu-law.
        Returns slot → committed token ids of the best hypothesis (partial
        output, one tick behind).
        """
        with TRACER.span("engine.tick"):
            return self._tick(audio)

    def _tick(self, audio: Dict[int, np.ndarray]) -> Dict[int, List[int]]:
        c = self.c
        cfg = self.cfg
        slots = sorted(k for k in audio if c.active[k])
        if not slots:
            return {}
        do = np.zeros(self.S, bool)
        dtypes = {np.asarray(audio[s]).dtype for s in slots}
        if dtypes == {np.dtype(np.uint8)}:
            # Fill 128 is the mu-law zero code.
            wire_dtype: np.dtype = np.dtype(np.uint8)
            audio_batch = np.full((self.S, self.A), 128, np.uint8)
        else:
            wire_dtype = (
                np.dtype(np.int16)
                if dtypes == {np.dtype(np.int16)}
                else np.dtype(np.float32)
            )
            audio_batch = np.zeros((self.S, self.A), wire_dtype)
        stalled = geometry.would_stall(cfg, self.MAXB, self.ECAP, c.buf_len)
        for s in slots:
            chunk = audio[s]
            if len(chunk) != self.A:
                raise ValueError(f"tick requires chunks of {self.A} samples, "
                                 f"slot {s} got {len(chunk)}")
            # Capacity stall: a stream whose encoder ring could overflow
            # stops consuming audio (slot_would_stall is this predicate).
            if stalled[s]:
                continue
            chunk = np.asarray(chunk)
            if chunk.dtype != wire_dtype:
                # Mixed-format tick: normalise stragglers to the batch
                # dtype on the host.
                if chunk.dtype == np.uint8:
                    chunk = _mulaw_decode(chunk)
                elif chunk.dtype == np.int16:
                    chunk = chunk.astype(np.float32) / 32767.0
                chunk = chunk.astype(wire_dtype)
            audio_batch[s] = chunk
            do[s] = True
        if not do.any():
            return {s: self.partial_tokens(s) for s in slots}

        # Read the PREVIOUS tick's [ylen | best yseq]: partials lag one tick.
        if self._pending_packed is not None:
            with TRACER.span("engine.tick.readback"):
                self._last_packed = self._pending_packed.cpu().numpy()
            self._pending_packed = None
            if self._pending_fresh is not None:
                # Rows computed after the slot's reset clear its staleness;
                # rows computed before it stay masked.
                self._stale_partial &= ~self._pending_fresh
                self._pending_fresh = None
            self._last_packed[self._stale_partial, 0] = 1

        packed_dev = self._tick_device(audio_batch, do)
        if packed_dev is not None:
            self._pending_packed = packed_dev
            # Every row reflects post-(any prior)reset state; _reset_slots
            # un-marks rows if a reset lands before the read.
            self._pending_fresh = np.ones(self.S, bool)

        out: Dict[int, List[int]] = {}
        drop = {self.cfg.blank_id, self.cfg.eos_id}
        if self._last_packed is None:
            return {s: [] for s in slots}
        ylen = self._last_packed[:, 0]
        self.ylen_upper = max(int(ylen.max()), 1)
        best = self._last_packed[:, 1:]
        for s in slots:
            n = int(ylen[s])
            out[s] = (
                [int(t) for t in best[s, 1 : n - 1] if int(t) not in drop]
                if n > 2
                else []
            )
        return out

    def _tick_device(self, audio: np.ndarray, do: np.ndarray
                     ) -> Optional[torch.Tensor]:
        """Device portion of one tick: the encode, then every beam round of
        the host-known schedule. Returns the last round's packed
        [ylen | best yseq] (None if no round ran)."""
        with TRACER.span("engine.tick.plan"):
            bk = self._encode_bookkeeping(do)
            rounds, vis_f, pb_f = self._round_schedule(do, bk["buf_new"])
        with TRACER.span("engine.tick.encode"):
            self._encode(audio, bk)
        TRACER.count("encoder.windows", self.S * bk["maxb"])
        self._apply_encode_counters(bk)
        if not rounds:
            return None
        for vis, new_vis, ready in rounds:
            self._round(self._loop, vis, new_vis, ready,
                        np.zeros(self.S, bool))
        self.c.vis_len = vis_f
        self.c.processed_block = pb_f
        a = self.arrays
        return torch.cat([a.ylen[:, None], a.yseq[:, 0, :]], dim=1)

    # -- frontend + encoder -------------------------------------------------
    def _encode_bookkeeping(self, do: np.ndarray) -> dict:
        """All host-side length arithmetic of one tick's encode
        (``geometry.plan_streams``; pure: no counter changes)."""
        c = self.c
        fe, sp, bp = geometry.plan_streams(
            self.cfg, c.wave_len, np.where(do, self.A, 0), c.first_wave,
            c.raw_len, c.post_len, c.npb, False, self.MAXB)
        _assert_fits("raw", c.raw_len, fe.n_frames, self.RCAP)
        _assert_fits("post", c.post_len, sp.n_sub, self.PCAP)
        _assert_fits("enc_out", c.buf_len, bp.y_length, self.ECAP)
        ints = [c.wave_len, fe.lo, fe.keep_from, fe.n_keep, c.raw_len,
                fe.n_frames, sp.n_in - sp.n_keep, c.post_len, sp.n_sub,
                bp.block_num, c.has_prev, c.has_past, c.buf_len, c.npb,
                bp.y_length]
        return {
            "ints": ints, "maxb": int(bp.block_num.max()),
            "can": fe.n_process > 0, "keep_len": fe.n_keep,
            "n_res_raw": sp.n_keep, "post_total": bp.total,
            "bn": bp.block_num, "emitted": bp.y_length,
            "buf_new": c.buf_len + bp.y_length,
        }

    def _encode(self, audio: np.ndarray, bk: dict):
        """Frontend → subsample → post append → blocks → enc_out append
        for every stream, with this tick's bookkeeping: the integers and
        the audio uploaded, then the encode graph of this block count and
        wire format replayed (run eagerly off the card)."""
        ints = self._enc_ints.put(np.stack(bk["ints"]).astype(np.int32))
        audio_dev = self._audio_upload(audio.dtype).put(audio)
        if self.graphed:
            self._encode_graph(bk["maxb"], audio_dev).replay()
        else:
            self._encode_into(self.buffers, audio_dev, ints, bk["maxb"])

    def _audio_upload(self, wire: np.dtype) -> Upload:
        if wire not in self._audio_in:
            dtype = torch.from_numpy(np.zeros(0, wire)).dtype
            self._audio_in[wire] = Upload((self.S, self.A), dtype,
                                          self.device)
        return self._audio_in[wire]

    def _encode_graph(self, maxb: int, audio: torch.Tensor):
        """The encode's graph for `maxb` blocks a stream over the static
        audio tensor `audio` (one per wire format), captured at first
        use."""
        key = (maxb, audio.dtype)
        if key not in self._encode_graphs:
            ints = self._enc_ints.dev

            def program():
                self._encode_into(self.buffers, audio, ints, maxb)

            def warmup():
                self._encode_into(clone_tree(self.buffers), audio, ints,
                                  maxb)

            (self._encode_graphs[key],) = capture_graphs(
                [(f"encode(S={self.S}, maxb={maxb}, {audio.dtype})",
                  program)], warmup, self._graph_pool)
        return self._encode_graphs[key]

    def _encode_into(self, buf: EngineBuffers, audio: torch.Tensor,
                     ints: torch.Tensor, maxb: int) -> None:
        """The encode over the buffers `buf`, which it writes in place
        (enc_out by kernel D, the carries by copying the results back)."""
        cfg = self.cfg
        model = self.model
        p_enc = model.params["encoder"]
        fe = model.frontend
        (wave_len, trim_start, keep_from, keep_len, raw_len, valid_feats,
         consumed, post_len, n_sub_out, bn, has_prev, has_past, buf_len, npb,
         emitted) = ints.unbind(0)
        if audio.dtype == torch.int16:
            audio = audio.float() / 32767.0
        elif audio.dtype == torch.uint8:
            audio = self._mulaw[audio.long()]
        feats, new_wave = _tick_frontend(
            buf.wave, audio, wave_len.long(), trim_start.long(),
            keep_from.long(), keep_len.long(), fe.window, fe.mel_fb, fe.mean,
            fe.inv_std, cfg.n_fft, cfg.hop_length)
        sub_frames, new_raw = _tick_subsample(
            p_enc["embed"], buf.raw, feats, raw_len, valid_feats, consumed,
            cfg)
        _scatter_append(buf.post, sub_frames[:, :self.SUBCAP], post_len,
                        n_sub_out)
        new = buf._replace(wave=new_wave, raw=new_raw)
        if maxb > 0:
            new_post, new_prev, new_past = _tick_blocks(
                p_enc, model.enc_pe, self._mask, buf.post, bn, npb,
                has_prev.bool(), has_past.bool(), buf.prev_addin,
                buf.past_ctx, buf.enc_out, buf_len, emitted, cfg, maxb)
            new = new._replace(post=new_post, prev_addin=new_prev,
                               past_ctx=new_past)
        write_tree(buf, new)

    def _apply_encode_counters(self, bk: dict):
        """Host counter updates for an encode (exactly once per encode)."""
        c = self.c
        cfg = self.cfg
        c.wave_len = bk["keep_len"]
        c.first_wave = np.where(bk["can"], False, c.first_wave)
        c.raw_len = bk["n_res_raw"]
        if bk["maxb"] == 0:
            c.post_len = bk["post_total"]
            return
        bn = bk["bn"]
        c.buf_len = c.buf_len + bk["emitted"]
        c.post_len = bk["post_total"] - bn * cfg.hop_size
        c.has_prev = c.has_prev | (bn > 0)
        c.has_past = c.has_past | (bn > 0)
        c.npb = c.npb + bn

    # -- beam rounds ---------------------------------------------------------
    def _round_schedule(self, do: np.ndarray, buf_new: np.ndarray):
        """The tick's beam rounds, from host counters alone: a list of
        (vis, new_vis, ready) per round, and the final vis_len and
        processed_block. A round makes the next block visible to every
        stream whose block boundary lies inside its emitted frames."""
        c = self.c
        vis = c.vis_len.copy()
        pb = c.processed_block.copy()
        rounds = []
        while True:
            cur_end = geometry.block_end(self.cfg, pb)
            ready = do & c.active & (cur_end < buf_new)
            if not ready.any():
                break
            new_vis = np.where(ready, cur_end, vis)
            assert (new_vis - vis <= self.EXTCAP).all(), \
                (new_vis - vis, self.EXTCAP)
            rounds.append((vis, new_vis, ready))
            vis = new_vis
            pb = np.where(ready, pb + 1, pb)
        return rounds, vis, pb

    def _round(self, loop: BlockLoop, vis: np.ndarray, new_vis: np.ndarray,
               stepping: np.ndarray, block_final: np.ndarray) -> None:
        """One beam round: make frames [vis, new_vis) visible to the CTC
        scorer and run the block beam loop for the stepping streams, on the
        loop's state in place. The cross-attention memory is the enc_out
        ring itself, masked by new_vis."""
        n_ext = np.clip(new_vis - vis, 0, self.EXTCAP)
        loop.run(vis, n_ext, new_vis, stepping, block_final)

    # ------------------------------------------------------------------
    # Output + finalize
    # ------------------------------------------------------------------
    def partial_tokens(self, s: int) -> List[int]:
        """Committed tokens of the best hypothesis (yseq[1:-1], non-blank)."""
        ylen = int(self.arrays.ylen[s])
        if ylen <= 2:
            return []
        yseq = self.arrays.yseq[s, 0, :ylen].cpu().numpy()
        drop = {self.cfg.blank_id, self.cfg.eos_id}
        return [int(t) for t in yseq[1:-1] if int(t) not in drop]

    def partial_result(self, s: int):
        ylen = int(self.arrays.ylen[s])
        # Copies: the state is rewritten in place by the next tick.
        yseq = self.arrays.yseq[s, 0, :ylen].cpu().numpy().copy()
        xpos = self.arrays.xpos[s, 0, :ylen].cpu().numpy().copy()
        return yseq, xpos

    @staticmethod
    def _float_audio(a: Optional[np.ndarray]) -> np.ndarray:
        """A final tail as float32 (int16 /32767, uint8 mu-law decoded)."""
        if a is None:
            return np.zeros(0, np.float32)
        a = np.asarray(a).reshape(-1)
        if a.dtype == np.int16:
            return a.astype(np.float32) / 32767.0
        if a.dtype == np.uint8:
            return _mulaw_decode(a)
        return a.astype(np.float32)

    def finalize(self, s: int, last_audio: Optional[np.ndarray] = None):
        """Final chunk for slot s: inject the slot's state into the
        single-stream beam search, decode to completion, reset the slot.

        Returns (yseq, xpos, score) of the best final hypothesis.
        """
        TRACER.count("engine.final.fallbacks")
        with TRACER.span("engine.final.fallback"):
            return self._finalize(s, last_audio)

    def _finalize(self, s: int, last_audio: Optional[np.ndarray]):
        last_audio = None if last_audio is None else self._float_audio(
            last_audio)
        c = self.c
        cfg = self.cfg
        buf = self.buffers
        fin = self._finalizer
        fin.reset()
        st = fin.state

        # Encoder state: exact-length views of the capacity buffers, and
        # the frames emitted so far, copied into the finalizer's chunk step
        # (float32, as JAX's concatenation with the final frames makes
        # them).
        raw = (buf.raw[s:s + 1, :int(c.raw_len[s])]
               if c.raw_len[s] > 0 else None)
        post = (buf.post[s:s + 1, :int(c.post_len[s])]
                if c.post_len[s] > 0 else None)
        fin.chunk.load(
            EncoderState(
                prev_addin=(buf.prev_addin[s:s + 1] if c.has_prev[s]
                            else None),
                buf_before=raw,
                buf_after=post,
                n_processed_blocks=int(c.npb[s]),
                past_ctx=buf.past_ctx[s:s + 1] if c.has_past[s] else None),
            buf.enc_out[s:s + 1, :int(c.buf_len[s])])
        st.vis_len = int(c.vis_len[s])
        st.processed_block = int(c.processed_block[s])

        # The slot's device state into the finalizer's, in place: copies,
        # since the finalizer appends into its CTC ring, decoder cache and
        # frame ring. The snapshot is copied valid or not; its flag comes
        # along.
        b = self.beam
        one = slice(s, s + 1)
        hyps = slice(s * b, (s + 1) * b)
        write_tree(
            (st.block.arrays, st.block.prev_arrays, st.block.dec_cache,
             st.block.lm_cache, st.block.prev_valid, st.block.process_idx,
             st.block.output_index),
            (_rows_arrays(self.arrays, one),
             _rows_arrays(self.prev_arrays, one),
             DecoderCache(h=self.dec_cache.h[:, hyps]),
             None if self.lm_cache is None else LMCache(
                 h=self.lm_cache.h[:, hyps]),
             self.prev_valid_dev[one], self.process_idx_dev[one],
             self.output_index_dev[one]))
        st.memory.copy_(buf.enc_out[one, :cfg.max_enc_frames])

        # The right-aligned wave carry and the last audio, as the session's
        # final chunk.
        wl = int(c.wave_len[s])
        wave = buf.wave[s, self.WCAP - wl:].cpu().numpy()
        tail = np.zeros(0, np.float32) if last_audio is None else last_audio
        fe = geometry.plan_frontend(cfg, wl, len(tail), c.first_wave[s], True)
        audio = np.concatenate([wave, tail, np.zeros(int(fe.pad), np.float32)])
        fin.process_input(ChunkInput("wave", audio, lo=int(fe.lo)),
                          is_final=True)
        yseq, xpos, score = fin.best_hypothesis()
        self._reset_slot(s)
        self.c.active[s] = False
        return yseq, xpos, score

    def finalize_batch(
        self, finals: Dict[int, Optional[np.ndarray]]
    ) -> Dict[int, Tuple[np.ndarray, np.ndarray, float]]:
        """Finalize several slots together.

        All finishing streams share one batched final encode, one drain of
        their remaining and final blocks, one readback and one reset, on a
        compact copy of their state (``_finalize_compact``). Slots that need
        the short-segment encoder path (npb == 0 and at most one block of
        frames), have an oversize (more than one chunk) tail or degenerate
        geometry go through ``finalize`` instead; a slot at ring capacity is
        clamped to a decode-only drain. A fallback slot whose finalize
        raises is quarantined (reset, absent from the result).

        Returns slot → (yseq, xpos, score), token-exact against ``finalize``
        (except the capacity clamp, where ``finalize`` raises).
        """
        with TRACER.span("engine.finalize_batch"):
            with TRACER.span("engine.final.plan"):
                items, batch, fallback, meta = self._final_plan(finals)
            out: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
            if batch:
                out.update(self._finalize_compact(batch, items, meta))
            for s in fallback:
                # A failing fallback slot must not discard the results the
                # compact batch already produced (and reset): quarantine
                # it.
                try:
                    out[s] = self.finalize(s, items[s])
                except Exception:
                    self.quarantined += 1
                    logger.exception("finalize failed for slot %d; "
                                     "quarantining", s)
                    try:
                        self._reset_slot(s)
                    finally:
                        self.c.active[s] = False
            return out

    def _final_plan(self, finals: Dict[int, Optional[np.ndarray]]):
        """finalize_batch's routing: the tails as float32 by slot, the
        slots of the compact batch, those of the ``finalize`` fallback, and
        each batched slot's final geometry (``geometry.plan_streams``)."""
        c = self.c
        cfg = self.cfg

        items: Dict[int, np.ndarray] = {}
        fallback: List[int] = []
        for s, a in finals.items():
            if not c.active[s]:
                continue
            a = self._float_audio(a)
            if len(a) > self.A:
                fallback.append(s)  # oversize tail
            items[s] = a
        slots = [s for s in items if s not in fallback]
        if not slots:
            return items, [], fallback, {}
        # Consume-all on final: even a 1-2 frame tail flows through, and a
        # dropped tiny tail still flushes the carried frames.
        fe, sp, bp = geometry.plan_streams(
            cfg, c.wave_len[slots], np.array([len(items[s]) for s in slots]),
            c.first_wave[slots], c.raw_len[slots], c.post_len[slots],
            c.npb[slots], True)

        batch: List[int] = []
        meta: Dict[int, Tuple[int, ...]] = {}
        for i, s in enumerate(slots):
            post_total, bn, y_emit = (int(bp.total[i]), int(bp.block_num[i]),
                                      int(bp.y_length[i]))
            if fe.n_process[i] <= cfg.n_fft // 2 + 1:
                fallback.append(s)  # the reflection needs total_p > pad
                continue
            if c.npb[s] == 0 and 0 < post_total <= cfg.block_size:
                fallback.append(s)  # short-segment path
                continue
            if y_emit < 0:
                fallback.append(s)  # degenerate geometry: exact slow path
                continue
            if int(c.buf_len[s]) + y_emit > self.ECAP:
                # Ring full: decode-only drain of the ringed frames; the
                # carried sub-block tail is dropped rather than failing the
                # whole utterance (finalize would raise here).
                logger.warning(
                    "slot %d finalized at ring capacity: dropping %d "
                    "carried frames (decode-only drain)", s, y_emit,
                )
                bn, y_emit = 0, 0
            meta[s] = (int(fe.n_process[i]), int(fe.lo[i]),
                       int(fe.n_frames[i]), int(sp.n_sub[i]), post_total,
                       bn, y_emit)
            batch.append(s)

        return items, batch, fallback, meta

    def _finalize_compact(
        self,
        batch: List[int],
        items: Dict[int, np.ndarray],
        meta: Dict[int, Tuple[int, ...]],
    ) -> Dict[int, Tuple[np.ndarray, np.ndarray, float]]:
        """Batched finalization at the compact width F of len(batch) slots
        (``_compact_width``, under 2·len(batch)): extract the slots' state,
        final-encode, drain the remaining full blocks and run each stream's
        final block, read the best hypotheses back, reset the slots. The
        final block may burst to max_length beam steps, so its per-step
        cost should scale with F, not S."""
        c = self.c
        n_fin = len(batch)
        f = self._compact_width(n_fin)
        TRACER.count("engine.final.slots", n_fin)
        TRACER.count("engine.final.rows", f)
        # Padding rows repeat the first slot; they are encoded with it and
        # never decoded.
        padded = batch + [batch[0]] * (f - n_fin)
        with TRACER.span("engine.final.extract"):
            rows = torch.tensor(padded, dtype=torch.long,
                                device=self.device)
            cb, loop = self._compact_set(f)
            cst = loop.state
            write_tree(
                (cb, cst.arrays, cst.prev_arrays, cst.dec_cache,
                 cst.lm_cache, cst.prev_valid, cst.process_idx,
                 cst.output_index),
                _extract_rows(self.buffers, self.arrays, self.prev_arrays,
                              self.dec_cache, self.lm_cache,
                              self.prev_valid_dev, self.process_idx_dev,
                              self.output_index_dev, rows, self.beam))

        do_f = np.arange(f) < n_fin
        buf_f = c.buf_len[padded].astype(np.int64)
        vis_f = c.vis_len[padded].astype(np.int64)
        pb_f = c.processed_block[padded].astype(np.int64)

        maxb = max(meta[s][5] for s in batch)
        if maxb > 0:
            audio = np.zeros((f, self.A), np.float32)
            cols = []
            for i, s in enumerate(padded):
                (total_p, trim_start, valid_feats, n_sub, post_total,
                 bn, y_emit) = meta[s]
                audio[i, :len(items[s])] = items[s]
                cols.append((c.wave_len[s], total_p, trim_start, c.raw_len[s],
                             valid_feats, c.post_len[s], n_sub, bn, c.npb[s],
                             post_total, y_emit, c.has_prev[s], c.has_past[s],
                             c.npb[s] == 0, buf_f[i]))
            cols = np.array(cols, np.int64).T
            _assert_fits("raw", cols[3], cols[4], self.RCAP)
            _assert_fits("post", cols[5], cols[6], self.PCAP)
            _assert_fits("enc_out", cols[14], cols[10], self.ECAP)
            with TRACER.span("engine.final.encode"):
                self._final_encode(
                    cb, torch.from_numpy(audio).to(self.device),
                    self._ints(cols), maxb)
            TRACER.count("encoder.windows", f * maxb)
            buf_f = buf_f + np.array([meta[s][6] for s in padded], np.int64)

        # Drain: each stream runs its remaining full blocks, then its final
        # block (block_final set, visibility extends to every emitted
        # frame). Rounds are lockstep across streams; each stream's own
        # sequence is that of the single-stream loop.
        with TRACER.span("engine.final.drain"):
            vis, pb = vis_f.copy(), pb_f.copy()
            fdone = np.zeros(f, bool)
            max_start = -1
            while True:
                cur_end = geometry.block_end(self.cfg, pb)
                ready = do_f & (cur_end < buf_f)
                final = do_f & ~ready & ~fdone & (buf_f > 0)
                step = ready | final
                if not step.any():
                    break
                new_vis = np.where(ready, np.minimum(cur_end, buf_f),
                                   np.where(final, buf_f, vis))
                ext = new_vis - vis
                assert ext.max() <= self.EXTCAP, (ext.max(), self.EXTCAP)
                max_start = max(max_start, int(vis[step].max()))
                self._round(loop, vis, new_vis, step, final)
                vis = new_vis
                pb = np.where(ready, pb + 1, pb)
                fdone = fdone | final
        self._last_drain_max_start = max_start

        with TRACER.span("engine.final.readback"):
            packed = _gather_final_rows(cst.arrays)
        lcap = cst.arrays.yseq.shape[2]
        out = {}
        for i, s in enumerate(batch):
            n = int(packed[i, 0])
            out[s] = (packed[i, 1:1 + n].astype(np.int64),
                      packed[i, 1 + lcap:1 + lcap + n].astype(np.int64),
                      float(np.float32(packed[i, -1])))
        with TRACER.span("engine.final.reset"):
            self._reset_slots(batch)
        for s in batch:
            c.active[s] = False
        return out

    def _compact_width(self, n: int) -> int:
        """The compact width that finalizes n slots: n rounded up to a power
        of two, at most S. An engine so holds at most log2(S) + 2 compact
        sets, fewer than 3S rows, whatever widths its finals take."""
        return min(1 << (n - 1).bit_length(), self.S)

    def _compact_widths(self) -> List[int]:
        return sorted({self._compact_width(n) for n in range(1, self.S + 1)})

    def _compact_set(self, f: int) -> Tuple[EngineBuffers, BlockLoop]:
        """The buffers and block loop of a compact width f, at fixed
        addresses (made at the first finalize_batch of that width or by
        ``capture_graphs``)."""
        if f not in self._compact:
            buffers = self._new_buffers(f)
            block = fresh_block_state(self.cfg, f, self.beam, self.device)
            self._compact[f] = (buffers,
                                self._block_loop(block, buffers.enc_out))
        return self._compact[f]

    def _final_encode(self, cb: EngineBuffers, audio: torch.Tensor,
                      ints: torch.Tensor, maxb: int):
        """Batched final encode of the compact slots: exact-length
        frontend tail → consume-all subsample → final blocks → append to
        the compact enc_out (in place; the other compact carries are dead
        after)."""
        cfg = self.cfg
        model = self.model
        p_enc = model.params["encoder"]
        fe = model.frontend
        (wave_len, total_p, trim_start, raw_len, valid_feats, post_len,
         n_sub_out, bn, npb, post_total, y_emit, has_prev, has_past, first,
         buf_len) = ints.unbind(0)
        feats = _final_frontend(
            cb.wave, audio, wave_len.long(), total_p, trim_start.long(),
            fe.window, fe.mel_fb, fe.mean, fe.inv_std, cfg.n_fft,
            cfg.hop_length, self.FCAP)
        _scatter_append(cb.raw, feats, raw_len, valid_feats)
        sub = conv2d_subsample(p_enc["embed"], cb.raw, cfg.input_layer)
        _scatter_append(cb.post, sub[:, :self.SUBCAP], post_len, n_sub_out)
        _final_blocks(
            p_enc, model.enc_pe, self._mask, cb.post, bn, npb,
            has_prev.bool(), has_past.bool(), cb.prev_addin, cb.past_ctx,
            cb.enc_out, buf_len, post_total, first.bool(), y_emit, cfg, maxb)
