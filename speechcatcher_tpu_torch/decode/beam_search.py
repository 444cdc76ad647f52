"""Blockwise Synchronous Beam Search (port of
``speechcatcher_tpu/decode/beam_search.py``).

Hypotheses are structure-of-arrays tensors (yseq/xpos/lane (S, B, Lmax),
scores (S, B)). One beam step runs the decoder (and, where the model has
one, the fused language model, ``models.lm``) over the full vocabulary,
keeps the top ``pre_beam`` candidates, scores them with the CTC prefix
scorer, expands each hypothesis by its top B and prunes the B·B expansions
to the global top B.

A block's beam loop is three sync-free pieces: ``block_extend`` makes the
block's new frames visible to the CTC scorer, ``block_step`` is one step of
the loop (per-stream EOS stop, BBD one-step rollback, the rewind snapshot)
and ``block_rewind`` the block-end rewind. None reads a device value on the
host, so ``decode.graphs`` captures them as CUDA graphs; on the CPU they
run eagerly. ``block_step`` is a bit-exact identity once no stream steps,
so a loop of it may run past the stop. ``decode_block_device`` is the same
loop as one function over a state (one host sync per step), the form the
JAX package's parity tests hold it in.

Snapshots: JAX arrays are immutable, so a snapshot is a reference. Here the
same holds because nothing a snapshot holds is ever written in place: every
step makes new yseq/xpos/lane/score*/ctc.r/ctc.s tensors. Only the CTC
log-prob ring (ctc_prefix.ctc_extend) and the decoder's and the LM's
activation caches (models/decoder.decoder_step, models/lm.lm_step) are
written in place, and no snapshot holds them: a snapshot's ring is empty,
and the caches are carried beside the beam state. The session's state
lives at fixed addresses: each block's results are written back into the
tensors it read (``graphs.write_tree``).

Ties: every top-k is a stable descending sort, so equal scores keep the
lower index first, as JAX's exact top-k does.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from speechcatcher_tpu_torch import geometry
from speechcatcher_tpu_torch.config import ModelConfig
from speechcatcher_tpu_torch.decode import graphs
from speechcatcher_tpu_torch.decode.ctc_prefix import (
    CTCScorerState,
    _fill_blank,
    ctc_advance_state,
    ctc_extend,
    ctc_score_candidates,
    init_ctc_state,
)
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.models.ctc import ctc_log_softmax
from speechcatcher_tpu_torch.models.decoder import (
    DecoderCache,
    decoder_step,
    init_decoder_cache,
    project_cross_kv,
)
from speechcatcher_tpu_torch.models.lm import (
    LMCache,
    check_lm_supported,
    init_lm_cache,
    lm_step,
)

NEG_INF = -1.0e30


class BeamArrays(NamedTuple):
    """Structure-of-arrays beam state for S streams × B hypotheses."""

    yseq: torch.Tensor       # (S, B, Lmax) int32, [0] = SOS
    xpos: torch.Tensor       # (S, B, Lmax) int32 encoder position per token
    lane: torch.Tensor       # (S, B, Lmax) int32 cache lane of position p
    ylen: torch.Tensor       # (S,) int32 prefix length incl. SOS
    score: torch.Tensor      # (S, B) total score
    score_dec: torch.Tensor  # (S, B) accumulated decoder score
    score_ctc: torch.Tensor  # (S, B) accumulated CTC score
    ctc: CTCScorerState
    # (S, B) accumulated LM score; None without an LM, so that a model
    # without one carries, selects and copies nothing more.
    score_lm: Optional[torch.Tensor] = None


class StepFlags(NamedTuple):
    eos_in_beam: torch.Tensor  # (S,) some hypothesis just ended with EOS
    best_is_eos: torch.Tensor  # (S,) the best hypothesis ends with EOS
    all_eos: torch.Tensor      # (S,)
    repetition: torch.Tensor   # (S,) BBD repetition detected


def init_beam_arrays(cfg: ModelConfig, n_streams: int, beam: int,
                     device: torch.device,
                     snapshot: bool = False) -> BeamArrays:
    """Fresh beam state. snapshot=True gives the rewind-snapshot variant
    with an EMPTY (S, 0, 0) log-prob ring: the ring is append-only and
    always read from the live arrays."""
    lmax = cfg.max_tokens
    i32 = dict(dtype=torch.int32, device=device)
    yseq = torch.zeros((n_streams, beam, lmax), **i32)
    yseq[:, :, 0] = cfg.sos_id
    score = torch.full((n_streams, beam), NEG_INF, dtype=torch.float32,
                       device=device)
    score[:, 0] = 0.0
    ctc = init_ctc_state(n_streams, beam, cfg.max_enc_frames, cfg.vocab_size,
                         device, ring_dtype=cfg.ctc_ring_torch_dtype,
                         empty_ring=snapshot)
    zeros = torch.zeros((n_streams, beam), dtype=torch.float32, device=device)
    return BeamArrays(
        yseq=yseq,
        xpos=torch.zeros((n_streams, beam, lmax), **i32),
        lane=torch.zeros((n_streams, beam, lmax), **i32),
        ylen=torch.ones((n_streams,), **i32),
        score=score,
        score_dec=zeros,
        score_ctc=zeros.clone(),
        ctc=ctc,
        score_lm=zeros.clone() if cfg.lm_layers else None,
    )


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_step_core(
    params,
    dec_pe: torch.Tensor,
    cross_kv,                  # project_cross_kv of the block's memory
    dec_cache: DecoderCache,
    arrays: BeamArrays,
    vis_len: torch.Tensor,     # (S,) visible encoder frames
    stepping: torch.Tensor,    # (S,) bool, streams advancing this step
    cfg: ModelConfig,
    beam: int,
    pre_beam: int,
    ctc_weight: float,
    use_bbd: bool,
    penalty: float = 0.0,
    lm_cache: Optional[LMCache] = None,
    lm_weight: float = 0.0,
) -> Tuple[BeamArrays, DecoderCache, StepFlags]:
    """One synchronous beam step for all streams. With an LM (``lm_cache``)
    it is a third full scorer beside the decoder, by shallow fusion as
    ESPnet's ``BatchBeamSearchOnline`` weighs it: the joint score is
    ``(1 - w)·dec + w·ctc + lm_weight·lm + penalty`` and the pre-beam the
    top K of the full scorers' ``(1 - w)·dec + lm_weight·lm``
    (``pre_beam_score_key="full"``). Without one the pre-beam is the top K
    of ``dec`` itself, the same order, and the step launches what it did
    before the LM existed."""
    s_dim, _, lmax = arrays.yseq.shape
    n = s_dim * beam
    vocab = cfg.vocab_size
    dev = arrays.yseq.device
    ylen = arrays.ylen.long()

    last_tok = arrays.yseq.gather(
        2, (ylen - 1)[:, None, None].expand(-1, beam, 1))[:, :, 0]  # (S, B)
    tokens = last_tok.reshape(n)
    pos = (ylen - 1).repeat_interleave(beam)
    write = stepping.repeat_interleave(beam)

    # Pass 1: decoder (and LM) scores over the full vocabulary.
    dec_logp, new_cache = decoder_step(
        params["decoder"], dec_pe, dec_cache, None, tokens, pos, vis_len,
        arrays.lane, write, cfg, beam, cross_kv=cross_kv,
    )
    dec_logp = dec_logp.reshape(s_dim, beam, vocab)
    lm_logp = full = None
    if lm_cache is not None:
        # Its rows go at the parent's lane, as the decoder's do.
        lm_logp = lm_step(params["lm"], lm_cache, tokens, pos, arrays.lane,
                          write, cfg).reshape(s_dim, beam, vocab)
        full = (1.0 - ctc_weight) * dec_logp + lm_weight * lm_logp

    # Pre-beam: top-K by the full scorers' weighted sum.
    _, cand_ids = _topk_stable(dec_logp if full is None else full,
                               min(pre_beam, vocab))

    # Pass 2: CTC prefix scores of the K candidates.
    olen = ylen - 1
    ctc_scores, log_psi = ctc_score_candidates(
        arrays.ctc, last_tok, olen, cand_ids, blank=cfg.blank_id,
        eos=cfg.eos_id,
    )
    if full is None:
        combined = ((1.0 - ctc_weight) * dec_logp + ctc_weight * ctc_scores
                    + penalty)
    else:
        combined = full + ctc_weight * ctc_scores + penalty

    # Expand: per-hypothesis top B, then the global top B of the B·B.
    top_scores, top_tokens = _topk_stable(combined, beam)       # (S, B, B)
    total = arrays.score[:, :, None] + top_scores
    best_total, best_flat = _topk_stable(total.reshape(s_dim, beam * beam),
                                         beam)                  # (S, B)
    src = best_flat // beam
    chosen = top_tokens.reshape(s_dim, beam * beam).gather(1, best_flat)

    def lineage(a):  # a[s, src[s, b], ...]
        idx = src.reshape(src.shape + (1,) * (a.dim() - 2))
        return a.gather(1, idx.expand((-1, -1) + a.shape[2:]))

    def gather_tok(a):  # a[s, src[s, b], chosen[s, b]]
        return lineage(a).gather(2, chosen[:, :, None])[:, :, 0]

    l_idx = torch.arange(lmax, device=dev)[None, None, :]
    at_ylen = l_idx == ylen[:, None, None]
    new_yseq = torch.where(at_ylen, chosen[:, :, None].to(torch.int32),
                           lineage(arrays.yseq))
    cur_pos = (vis_len.long() - 1).clamp(min=0)
    new_xpos = torch.where(at_ylen, cur_pos[:, None, None].to(torch.int32),
                           lineage(arrays.xpos))
    # This step's cache rows were written at the PARENT's lane.
    new_lane = torch.where(l_idx == (ylen - 1)[:, None, None],
                           src[:, :, None].to(torch.int32),
                           lineage(arrays.lane))

    new_ctc = ctc_advance_state(arrays.ctc, log_psi, src, chosen, cand_ids,
                                last_tok, olen)
    new_arrays = BeamArrays(
        yseq=new_yseq,
        xpos=new_xpos,
        lane=new_lane,
        ylen=arrays.ylen + 1,
        score=best_total,
        score_dec=lineage(arrays.score_dec) + gather_tok(dec_logp),
        score_ctc=lineage(arrays.score_ctc) + gather_tok(ctc_scores),
        ctc=new_ctc,
        score_lm=(None if lm_logp is None else
                  lineage(arrays.score_lm) + gather_tok(lm_logp)),
    )

    eos = cfg.eos_id
    last_is_eos = chosen == eos
    if use_bbd:
        # Repetition: the new token already occurs in yseq[1:ylen].
        middle = (l_idx >= 1) & (l_idx < ylen[:, None, None])
        rep = (middle & (new_yseq == chosen[:, :, None])).any(dim=2)
        not_special = (chosen != cfg.sos_id) & (chosen != eos)
        repetition = (rep & not_special).any(dim=1)
    else:
        repetition = torch.zeros((s_dim,), dtype=torch.bool, device=dev)
    return new_arrays, new_cache, StepFlags(
        eos_in_beam=last_is_eos.any(dim=1),
        best_is_eos=last_is_eos[:, 0],
        all_eos=last_is_eos.all(dim=1),
        repetition=repetition,
    )


def _sel0(m: torch.Tensor, x, y: Optional[torch.Tensor]
          ) -> Optional[torch.Tensor]:
    """where over the leading stream axis (x may be a scalar); None for a
    field that is None (the LM's, without an LM)."""
    if y is None:
        return None
    return torch.where(m.reshape((m.shape[0],) + (1,) * (y.dim() - 1)), x, y)


def select_arrays(mask: torch.Tensor, a: BeamArrays, b: BeamArrays
                  ) -> BeamArrays:
    """Per-stream select over every field. Between a live and an empty
    (snapshot) ring the empty one is kept: every consumer of such a result
    rebuilds its CTC state around the live ring."""
    if a.ctc.logp is b.ctc.logp:
        logp = a.ctc.logp
    elif a.ctc.logp.shape == b.ctc.logp.shape:
        logp = _sel0(mask, a.ctc.logp, b.ctc.logp)
    else:
        logp = a.ctc.logp if a.ctc.logp.numel() == 0 else b.ctc.logp
    return BeamArrays(
        yseq=_sel0(mask, a.yseq, b.yseq),
        xpos=_sel0(mask, a.xpos, b.xpos),
        lane=_sel0(mask, a.lane, b.lane),
        ylen=_sel0(mask, a.ylen, b.ylen),
        score=_sel0(mask, a.score, b.score),
        score_dec=_sel0(mask, a.score_dec, b.score_dec),
        score_ctc=_sel0(mask, a.score_ctc, b.score_ctc),
        ctc=CTCScorerState(
            logp=logp,
            enc_len=_sel0(mask, a.ctc.enc_len, b.ctc.enc_len),
            r=_sel0(mask, a.ctc.r, b.ctc.r),
            s=_sel0(mask, a.ctc.s, b.ctc.s),
        ),
        score_lm=_sel0(mask, a.score_lm, b.score_lm),
    )


class BlockDecodeState(NamedTuple):
    """Carry of the block-decode loop. The decoder cache, and the LM's
    beside it, ride along (their rows are append-only) and are never
    selected or snapshotted."""

    arrays: BeamArrays
    prev_arrays: BeamArrays
    dec_cache: DecoderCache
    prev_valid: torch.Tensor   # (S,) bool, a rewind snapshot exists
    process_idx: torch.Tensor  # (S,) int32
    output_index: torch.Tensor  # (S,) int32
    stepping: torch.Tensor     # (S,) bool
    lm_cache: Optional[LMCache] = None  # None without an LM


class LoopSettings(NamedTuple):
    """The static arguments of a block loop."""

    beam: int
    pre_beam: int
    ctc_weight: float
    use_bbd: bool
    max_length: int
    penalty: float = 0.0
    eos_commit: str = "native"
    lm_weight: float = 0.0


def block_extend(params, state: BlockDecodeState, frames: torch.Tensor,
                 n_new: torch.Tensor, stepping: torch.Tensor
                 ) -> BlockDecodeState:
    """Make the first n_new[s] of the new frames (S, Tnew, d) float32
    visible to the CTC scorer (ctc_log_softmax → ctc_extend, the ring
    appended in place) and set the streams that step in this block."""
    new_logp = ctc_log_softmax(params["ctc"], frames)
    ctc = ctc_extend(state.arrays.ctc, new_logp, n_new)
    return state._replace(arrays=state.arrays._replace(ctc=ctc),
                          stepping=stepping)


def block_step(params, dec_pe: torch.Tensor, cross_kv,
               st: BlockDecodeState, vis_len: torch.Tensor,
               block_final: torch.Tensor, cfg: ModelConfig,
               loop: LoopSettings) -> BlockDecodeState:
    """One step of the block loop for the streams still stepping. With no
    stream stepping it returns every leaf bit-equal to its input: the
    selects keep ``old``, the counters move only under ``stepping`` or
    ``cont`` and the decoder cache writes only where ``write``."""
    lmax = st.arrays.yseq.shape[2]
    max_length = loop.max_length
    stepping = (st.stepping & (st.process_idx < max_length)
                & (st.arrays.ylen + 1 < lmax))
    old = st.arrays
    new, dec_cache, flags = _beam_step_core(
        params, dec_pe, cross_kv, st.dec_cache, old, vis_len, stepping,
        cfg, loop.beam, loop.pre_beam, loop.ctc_weight, loop.use_bbd,
        loop.penalty, st.lm_cache, loop.lm_weight,
    )
    output_index = torch.where(stepping, st.output_index + 1,
                               st.output_index)
    bbd = (stepping & loop.use_bbd & ~block_final & flags.repetition
           & ~flags.eos_in_beam)
    stop_eos = stepping & flags.eos_in_beam & ~block_final
    discard = (bbd | stop_eos) if loop.eos_commit == "espnet" else bbd
    advanced = stepping & ~discard
    arrays = select_arrays(advanced, new, old)
    output_index = torch.where(discard, output_index - 1, output_index)

    stop_eos_final = stepping & block_final & flags.best_is_eos
    cont = advanced & ~stop_eos & ~stop_eos_final
    if loop.eos_commit == "espnet":
        prev_src = select_arrays(block_final, arrays, old)
    else:
        prev_src = arrays
    prev_arrays = select_arrays(cont, prev_src, st.prev_arrays)
    process_idx = torch.where(cont, st.process_idx + 1, st.process_idx)
    # The ring never changes inside a block: keep each role's own.
    arrays = arrays._replace(ctc=arrays.ctc._replace(logp=old.ctc.logp))
    prev_arrays = prev_arrays._replace(
        ctc=prev_arrays.ctc._replace(logp=st.prev_arrays.ctc.logp))
    return BlockDecodeState(
        arrays=arrays,
        prev_arrays=prev_arrays,
        dec_cache=dec_cache,
        prev_valid=st.prev_valid | cont,
        process_idx=process_idx,
        output_index=output_index,
        stepping=(cont & (process_idx < max_length)
                  & (arrays.ylen + 1 < lmax)),
        lm_cache=st.lm_cache,
    )


def block_rewind(st: BlockDecodeState, stepping0: torch.Tensor
                 ) -> BlockDecodeState:
    """Block-end rewind of the streams that stepped in the block
    (`stepping0`): restore the snapshot; the ring is append-only and the
    forward variables are re-extended over frames added since."""
    rewind = stepping0 & (st.process_idx > 1) & st.prev_valid
    restored = select_arrays(rewind, st.prev_arrays, st.arrays)
    from_len = torch.where(rewind, st.prev_arrays.ctc.enc_len,
                           st.arrays.ctc.enc_len)
    r = _fill_blank(st.arrays.ctc.logp, restored.ctc.r, from_len,
                    st.arrays.ctc.enc_len)
    ctc = CTCScorerState(logp=st.arrays.ctc.logp, enc_len=st.arrays.ctc.enc_len,
                         r=r, s=restored.ctc.s)
    return BlockDecodeState(
        arrays=restored._replace(ctc=ctc),
        prev_arrays=st.prev_arrays,
        dec_cache=st.dec_cache,
        prev_valid=torch.where(rewind, False, st.prev_valid),
        process_idx=torch.where(rewind, st.process_idx - 1, st.process_idx),
        output_index=st.output_index,
        stepping=torch.zeros_like(st.stepping),
        lm_cache=st.lm_cache,
    )


def check_eos_commit(eos_commit: str) -> None:
    if eos_commit not in ("native", "espnet"):
        raise ValueError(f"eos_commit must be native or espnet, got "
                         f"{eos_commit!r}")


def decode_block_device(
    params,
    dec_pe: torch.Tensor,
    memory: torch.Tensor,       # (S, Tcap, d) raw encoder frames (padded)
    state: BlockDecodeState,
    vis_len: torch.Tensor,      # (S,)
    block_final: torch.Tensor,  # (S,) bool
    cfg: ModelConfig,
    beam: int,
    pre_beam: int,
    ctc_weight: float,
    use_bbd: bool,
    max_length: int,
    penalty: float = 0.0,
    eos_commit: str = "native",
    lm_weight: float = 0.0,
) -> BlockDecodeState:
    """The beam loop of one block, eagerly: steps until no stream is
    stepping, reading ``any(stepping)`` on the host before each step.

    eos_commit="native" commits the step that puts EOS in the beam;
    "espnet" discards it and keeps the snapshot one step behind on
    non-final blocks."""
    check_eos_commit(eos_commit)
    loop = LoopSettings(beam, pre_beam, ctc_weight, use_bbd, max_length,
                        penalty, eos_commit, lm_weight)
    cross_kv = project_cross_kv(params["decoder"], memory, cfg.decoder_heads,
                                state.dec_cache.h.dtype)
    st = state
    while bool(st.stepping.any()):
        st = block_step(params, dec_pe, cross_kv, st, vis_len, block_final,
                        cfg, loop)
    return block_rewind(st, state.stepping)


def fresh_block_state(cfg: ModelConfig, n_streams: int, beam: int,
                      device: torch.device) -> BlockDecodeState:
    """The block-loop state of fresh sessions: a live beam, an empty-ring
    snapshot that is not valid, zero decoder and LM caches and zero
    counters."""
    flags = dict(device=device)
    return BlockDecodeState(
        arrays=init_beam_arrays(cfg, n_streams, beam, device),
        prev_arrays=init_beam_arrays(cfg, n_streams, beam, device,
                                     snapshot=True),
        dec_cache=init_decoder_cache(cfg, n_streams * beam, device),
        prev_valid=torch.zeros((n_streams,), dtype=torch.bool, **flags),
        process_idx=torch.zeros((n_streams,), dtype=torch.int32, **flags),
        output_index=torch.zeros((n_streams,), dtype=torch.int32, **flags),
        stepping=torch.zeros((n_streams,), dtype=torch.bool, **flags),
        lm_cache=(init_lm_cache(cfg, n_streams * beam, device)
                  if cfg.lm_layers else None),
    )


@dataclasses.dataclass
class BSBSState:
    """One decoding session (one stream, S=1): host-side counters and the
    device state of the block loop at fixed addresses (``block`` and the
    raw frame ring ``memory``), written in place. The encoder's carry and
    its emitted frames live in the session's ``graphs.ChunkStep``."""

    vis_len: int                         # frames visible to the scorers
    processed_block: int
    block: BlockDecodeState              # beam, snapshot, cache, counters
    memory: torch.Tensor                 # (1, Tcap, d) raw encoder ring

    @property
    def arrays(self) -> BeamArrays:
        return self.block.arrays

    @property
    def dec_cache(self) -> DecoderCache:
        return self.block.dec_cache


class BlockwiseSynchronousBeamSearch:
    """Streaming BSBS over one session's chunks. On the card each chunk's
    encoder step (``graphs.ChunkStep``) and each block's loop
    (``graphs.BlockLoop``) run as CUDA graphs in one memory pool, eagerly
    on the CPU and under a tp group (whose collectives cannot be
    captured). ``lm_weight`` is the model configuration's unless given; it
    weighs the fused LM where the model has one."""

    def __init__(
        self,
        model: ASRModel,
        beam_size: int = 5,
        ctc_weight: float = 0.3,
        use_bbd: bool = True,
        pre_beam_size: Optional[int] = None,
        max_length: Optional[int] = None,
        penalty: float = 0.0,
        coverage_weight: float = 0.0,
        eos_commit: str = "native",
        memory_dtype: torch.dtype = torch.float32,
        lm_weight: Optional[float] = None,
    ):
        check_eos_commit(eos_commit)
        check_lm_supported(model.cfg)
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.beam_size = beam_size
        self.ctc_weight = ctc_weight
        self.lm_weight = (self.cfg.lm_weight if lm_weight is None
                          else lm_weight)
        self.use_bbd = use_bbd
        self.eos_commit = eos_commit
        self.penalty = penalty
        self.coverage_weight = coverage_weight
        self.pre_beam = pre_beam_size or self.cfg.pre_beam_size
        self.max_length = max_length or self.cfg.max_tokens - 1
        d = self.cfg.encoder_dim
        self.chunk = graphs.ChunkStep(model)
        self.state = BSBSState(
            vis_len=0, processed_block=0,
            block=fresh_block_state(self.cfg, 1, beam_size, self.device),
            memory=torch.zeros((1, self.cfg.max_enc_frames, d),
                               dtype=memory_dtype, device=self.device))
        # A block's new frames, float32 (the CTC head reads them unrounded
        # whatever the ring's dtype), in the first n_new rows.
        frames = self.frames = torch.zeros((1, self.cfg.block_size, d),
                                           device=self.device)
        self.loop = graphs.BlockLoop(
            model, self.state.block, self.state.memory, self._settings(),
            frames=lambda ints: frames, extcap=self.cfg.block_size,
            pool=self.chunk.pool)
        self.reset()

    def _settings(self) -> LoopSettings:
        """The loop's static arguments, from this object's attributes (a
        caller may change them between blocks, as the JAX session allows;
        the loop then captures anew)."""
        check_eos_commit(self.eos_commit)
        return LoopSettings(self.beam_size, self.pre_beam, self.ctc_weight,
                            self.use_bbd, self.max_length, self.penalty,
                            self.eos_commit, self.lm_weight)

    def reset(self):
        """Reset streaming state between utterances; the device state is
        rewritten in place."""
        st = self.state
        self.chunk.reset()
        st.vis_len = 0
        st.processed_block = 0
        graphs.write_tree(st.block, fresh_block_state(
            self.cfg, 1, self.beam_size, self.device))
        st.memory.zero_()
        self.frames.zero_()

    @staticmethod
    def encodes(n_frames: int, is_final: bool) -> bool:
        """Whether a chunk of `n_frames` feature frames runs the encoder: a
        final chunk always does (it flushes the carried buffers, whatever
        its own length); a shorter one than 3 frames is dropped."""
        return n_frames >= 3 or is_final

    def process_block(self, feats: torch.Tensor, is_final: bool = False
                      ) -> BeamArrays:
        """Feed a normalised feature chunk (1, T, n_mels); run the encoder
        and every beam block that is ready."""
        return self.process_input(graphs.ChunkInput("normalized", feats),
                                  is_final)

    def process_input(self, source: "graphs.ChunkInput",
                      is_final: bool = False) -> BeamArrays:
        """Feed a chunk (waveform, features or normalised features, see
        ``graphs.ChunkInput``); run the encoder and every beam block that
        is ready."""
        st = self.state
        cfg = self.cfg
        if self.encodes(source.n_frames(cfg.hop_length), is_final):
            self.chunk.step(source, is_final)
        while True:
            cur_end = geometry.block_end(cfg, st.processed_block)
            buf_len = self.chunk.enc_len
            if cur_end < buf_len:
                self._decode_one_block(cur_end, block_is_final=False)
                st.processed_block += 1
            elif is_final and buf_len > 0:
                self._decode_one_block(buf_len, block_is_final=True)
                break
            else:
                break
        return st.arrays

    def _extend_memory(self, cur_end: int) -> int:
        """Copy the encoder's frames [vis_len, cur_end) into the raw-frame
        ring (in place: the ring is append-only and no snapshot holds it)
        and into the new frames' buffer; returns how many frames were
        added. The chunk step holds at most max_enc_frames frames, so they
        fit."""
        st = self.state
        if cur_end <= st.vis_len:
            return 0
        n_new = cur_end - st.vis_len
        if n_new > self.loop.extcap:
            raise RuntimeError(f"a block adds {n_new} frames, more than "
                               f"{self.loop.extcap}")
        new_frames = self.chunk.ring[:, st.vis_len:cur_end]
        st.memory[:, st.vis_len:cur_end] = new_frames.to(st.memory.dtype)
        self.frames[:, :n_new] = new_frames
        return n_new

    def _decode_one_block(self, cur_end: int, block_is_final: bool):
        st = self.state
        vis = st.vis_len
        n_new = self._extend_memory(cur_end)
        st.vis_len = vis + n_new
        if st.vis_len == 0:
            return
        self.loop.settings = self._settings()
        self.loop.run(vis=[vis], n_new=[n_new], new_vis=[st.vis_len],
                      stepping=[True], block_final=[block_is_final])

    def _beam_on_host(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """yseq and xpos (B, ylen) and scores (B,) as numpy copies: the
        device state is rewritten in place by the next block or reset."""
        arrays = self.state.arrays
        ylen = int(arrays.ylen[0])
        return (arrays.yseq[0, :, :ylen].cpu().numpy().copy(),
                arrays.xpos[0, :, :ylen].cpu().numpy().copy(),
                arrays.score[0].cpu().numpy().copy())

    def best_hypothesis(self) -> Tuple[np.ndarray, np.ndarray, float]:
        """(token_ids, xpos, score) of the best hypothesis; with
        coverage_weight set, re-ranked by score + CoverageScorer."""
        yseq_h, xpos_h, score_h = self._beam_on_host()
        best = 0
        if self.coverage_weight:
            from speechcatcher_tpu_torch.decode.scorers import CoverageScorer

            cov = CoverageScorer(self.coverage_weight)
            scores = [float(score_h[b]) + cov.score(yseq_h[b, 1:])
                      for b in range(self.beam_size)]
            best = int(np.argmax(scores))
        return yseq_h[best], xpos_h[best], float(score_h[best])

    def nbest_hypotheses(self) -> List[Tuple[np.ndarray, np.ndarray, float]]:
        yseq_h, xpos_h, score_h = self._beam_on_host()
        return [(yseq_h[b], xpos_h[b], float(score_h[b]))
                for b in range(self.beam_size)]
