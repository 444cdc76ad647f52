"""The streaming geometry: every length the host works out for a stream.

A stream's samples become STFT frames (``plan_frontend``), its feature
frames subsampled frames (``plan_subsample``), and those run through the
encoder in blocks whose emitted frames the beam search reads block by
block (``plan_blocks``, ``block_end``); each stage carries a remainder to
the next chunk. The session (``streaming``, ``decode.graphs.ChunkStep``,
the eager ``StreamingEncoder.step``: ``plan_chunk``) and the engine (a
tick and its finals: ``plan_streams``; the stall guard; its buffers'
capacities) take every such length from here.

The functions take Python ints or numpy arrays of per-stream counters, so
one call plans one stream or S streams. Host arithmetic only: no torch,
no device. Where the frontend runs, a chunk's STFT has more frames than
``stft_trim`` (at least 1 + win // hop), since the hop is no longer than
the window; the boundary cuts rely on it.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np

# The conv subsampling's (kernels, strides) along time, by input layer.
CONV_SPECS = {
    "conv2d": ([3, 3], [2, 2]),
    "conv2d6": ([3, 5], [2, 3]),
    "conv2d8": ([3, 3, 3], [2, 2, 2]),
}


def subsampled_len(n_in, input_layer: str):
    """Frames out of the conv subsampling for `n_in` in (or mel bins: the
    kernels are square): the VALID kernel/stride walk of ``CONV_SPECS``
    ('linear' keeps the length). An int, a numpy array or a torch tensor;
    below the first kernel the count is not positive."""
    if input_layer == "linear":
        return n_in
    kernels, strides = CONV_SPECS[input_layer]
    for k, s in zip(kernels, strides):
        n_in = (n_in - k) // s + 1
    return n_in


def stft_frames(cfg, n_samples):
    """The STFT's frames over `n_samples` samples (centred)."""
    return 1 + n_samples // cfg.hop_length


def stft_trim(cfg) -> int:
    """Frames cut from each side of a boundary between two chunks' STFTs:
    those whose window reaches past the chunk's samples."""
    return math.ceil(math.ceil(cfg.win_length / cfg.hop_length) / 2)


def lead(cfg) -> int:
    """Frames of block 0 before its first hop: a stream's first blocks
    emit them besides a hop a block."""
    return cfg.block_size - cfg.look_ahead - cfg.hop_size


def block_end(cfg, pb):
    """The encoder frames the beam search may read for block `pb` (counted
    from 0): the block's end without its look-ahead. The block is ready
    once more frames than that have been emitted."""
    return cfg.block_size - cfg.look_ahead + cfg.hop_size * pb


class FrontendPlan(NamedTuple):
    """A chunk's frontend (``plan_frontend``)."""

    n_process: object  # samples through the STFT, padding included (0: none)
    pad: object        # zeros appended to reach the window (a final)
    lo: object         # frames cut at the start
    hi: object         # frames cut at the end
    n_frames: object   # frames kept
    keep_from: object  # where the carry starts in carry + new samples
    n_keep: object     # samples carried to the next chunk (0 after a final)


def plan_frontend(cfg, n_carry, n_new, first, final: bool) -> FrontendPlan:
    """The frontend of `n_new` samples after a carry of `n_carry`; `first`
    while no chunk of the stream has run the frontend yet. A chunk runs
    whole hops once it holds more than a window, cuts ``stft_trim`` frames
    at each boundary with another chunk and carries the rest; a final runs
    everything, zero-padded to a window if shorter."""
    win, hop = cfg.win_length, cfg.hop_length
    trim = stft_trim(cfg)
    n = n_carry + n_new
    lo = np.where(first, 0, trim)
    if final:
        n_process = np.maximum(n, win)
        frames = np.maximum(stft_frames(cfg, n_process) - lo, 0)
        return FrontendPlan(n_process, n_process - n, lo, np.zeros_like(n),
                            frames, n, np.zeros_like(n))
    overlap = win - hop
    runs = n > win
    n_process = np.where(runs, overlap + (n - overlap) // hop * hop, 0)
    n_keep = np.where(runs, n - n_process + overlap, n)
    frames = np.where(
        runs, np.maximum(stft_frames(cfg, n_process) - lo - trim, 0), 0)
    return FrontendPlan(n_process, np.zeros_like(n), lo, np.full_like(n, trim),
                        frames, n - n_keep, n_keep)


class SubsamplePlan(NamedTuple):
    """A chunk's conv subsampling (``plan_subsample``)."""

    n_in: object       # carried + new feature frames
    n_conv_in: object  # of them through the conv (0: too few, all carried)
    n_sub: object      # subsampled frames out
    n_keep: object     # feature frames carried to the next chunk


def plan_subsample(cfg, n_carry, n_new, final: bool) -> SubsamplePlan:
    """The subsampling of `n_new` feature frames after a carry of
    `n_carry`: a chunk convolves whole strides once it holds three and
    carries its residue and two strides; a final convolves all."""
    sub = cfg.subsample
    n_in = n_carry + n_new
    if final:
        return SubsamplePlan(
            n_in, n_in, np.maximum(subsampled_len(n_in, cfg.input_layer), 0),
            np.zeros_like(n_in))
    n_strides = n_in // sub - 1
    runs = n_strides >= 2
    n_conv_in = np.where(runs, n_strides * sub, 0)
    return SubsamplePlan(
        n_in, n_conv_in,
        np.where(runs, subsampled_len(n_conv_in, cfg.input_layer), 0),
        np.where(runs, n_in % sub + 2 * sub, n_in))


class BlockPlan(NamedTuple):
    """A chunk's encoder blocks (``plan_blocks``)."""

    total: object        # carried + new subsampled frames
    block_num: object    # blocks run
    n_blocks_in: object  # frames they read
    y_length: object     # frames they emit
    n_keep: object       # subsampled frames carried to the next chunk


def plan_blocks(cfg, n_carry, n_new, npb, final: bool, maxb=None
                ) -> BlockPlan:
    """The blocks over `n_new` subsampled frames after a carry of
    `n_carry`, `npb` blocks having run before. A chunk runs every full
    block (at most `maxb`) and emits a hop each, the first chunk of a
    stream also block 0's ``lead``; a final runs every frame left, its
    last block emitting the remainder."""
    bs, hop = cfg.block_size, cfg.hop_size
    overlap = bs - hop
    total = n_carry + n_new
    first = npb == 0
    if final:
        some = total > 0
        block_num = np.where(
            some, np.maximum(-(-(total - overlap) // hop), 1), 0)
        y_length = np.where(some, np.where(first, total, total - lead(cfg)),
                            0)
        return BlockPlan(total, block_num, total, y_length,
                         np.zeros_like(total))
    block_num = np.where(total > bs, (total - overlap) // hop, 0)
    if maxb is not None:
        block_num = np.minimum(block_num, maxb)
    runs = block_num > 0
    return BlockPlan(
        total, block_num, np.where(runs, block_num * hop + overlap, 0),
        np.where(runs, block_num * hop + np.where(first, lead(cfg), 0), 0),
        total - block_num * hop)


def plan_streams(cfg, n_wave, n_new, first_wave, n_raw, n_post, npb,
                 final: bool, maxb=None):
    """A chunk of `n_new` samples for streams whose carries hold `n_wave`
    samples, `n_raw` feature and `n_post` subsampled frames, `npb` blocks
    having run: (``FrontendPlan``, ``SubsamplePlan``, ``BlockPlan``). The
    engine's tick (at most `maxb` blocks) and its finals."""
    fe = plan_frontend(cfg, n_wave, n_new, first_wave, final)
    sp = plan_subsample(cfg, n_raw, fe.n_frames, final)
    return fe, sp, plan_blocks(cfg, n_post, sp.n_sub, npb, final, maxb)


class ChunkPlan(NamedTuple):
    """The host arithmetic of one chunk step of the session
    (``plan_chunk``): every length and count, as Python ints. ``kind`` says
    what the step does:

    - "buffer": too few feature frames to subsample; they are carried;
    - "hold": subsampled, but no block is full; the frames are carried;
    - "empty": a final with no frame at all;
    - "short": a final of the first chunk no longer than a block
      (``_infer_short``);
    - "blocks": ``block_num`` blocks through ``_infer_core``."""

    kind: str
    is_final: bool
    first_chunk: bool   # no block processed before (npb == 0)
    n_in: int           # carried + new feature frames
    n_conv_in: int      # of them through the conv subsampling
    n_sub: int          # subsampled frames that gives (0: no conv)
    n_before: int       # feature frames carried to the next chunk
    total: int          # carried + new subsampled frames (total_frame_num)
    n_blocks_in: int    # of them read by the blocks
    block_num: int
    y_length: int       # frames emitted
    n_after: int        # subsampled frames carried to the next chunk
    npb: int            # blocks processed after this chunk


def plan_chunks(cfg, n_before: int, n_feats, n_after: int, npb: int,
                is_final: bool) -> List[ChunkPlan]:
    """The chunk step's plan for each of the chunk lengths `n_feats`
    (feature frames), with `n_before` feature and `n_after` subsampled
    frames carried and `npb` blocks processed."""
    n_feats = np.atleast_1d(np.asarray(n_feats, np.int64))
    sp = plan_subsample(cfg, n_before, n_feats, is_final)
    bp = plan_blocks(cfg, n_after, sp.n_sub, npb, is_final)
    first = npb == 0
    if is_final:
        kind = np.select(
            [bp.total == 0, first & (bp.total <= cfg.block_size)],
            ["empty", "short"], "blocks")
    else:
        kind = np.select([sp.n_conv_in == 0, bp.block_num == 0],
                         ["buffer", "hold"], "blocks")
    buffer = kind == "buffer"
    blocks = kind == "blocks"
    runs = blocks | (kind == "short")
    cols = np.broadcast_arrays(
        sp.n_in, np.where(buffer, sp.n_in, sp.n_conv_in), sp.n_sub,
        sp.n_keep, np.where(buffer, 0, bp.total),
        np.where(runs, bp.n_blocks_in, 0), np.where(blocks, bp.block_num, 0),
        np.where(runs, bp.y_length, 0), np.where(buffer, n_after, bp.n_keep),
        np.where(blocks, npb + bp.block_num, npb))
    return [ChunkPlan(str(k), is_final, bool(first), *map(int, row))
            for k, row in zip(kind, zip(*cols))]


def plan_chunk(cfg, n_before: int, n_feats: int, n_after: int, npb: int,
               is_final: bool) -> ChunkPlan:
    """The chunk step's plan (the JAX package's ``StreamingEncoder.step``
    outside its jit-compiled functions): carried feature frames
    `n_before`, the chunk's `n_feats`, carried subsampled frames `n_after`,
    blocks processed `npb`."""
    return plan_chunks(cfg, n_before, n_feats, n_after, npb, is_final)[0]


def would_stall(cfg, maxb: int, ecap: int, buf_len):
    """Whether one more tick could overflow a ring of `ecap` encoder frames
    that holds `buf_len`: a tick emits at most `maxb` blocks of a hop and
    block 0's lead."""
    return buf_len + maxb * cfg.hop_size + lead(cfg) > ecap


def carry_capacity(cfg):
    """(RCAP, PCAP): the most feature and subsampled frames a session's
    chunk step of a decodable utterance holds. Past PCAP = max_enc_frames
    + block_size subsampled frames the utterance has more encoder frames
    than the decode state holds; RCAP feature frames subsample to more
    than PCAP even after the carried residue is cut off."""
    pcap = cfg.max_enc_frames + cfg.block_size
    return cfg.subsample * (pcap + 4), pcap


class EngineCapacities(NamedTuple):
    """The engine's buffer capacities for chunks of A samples."""

    WCAP: int      # waveform carry: never more than a window
    FCAP: int      # STFT frames of a carry and a chunk
    RCAP: int      # feature frames: a chunk's and the residue
    SUBCAP: int    # subsampled frames of RCAP feature frames
    MAXB: int      # blocks a tick: the carry (under a block) and SUBCAP
    PCAP: int      # subsampled frames carried and new
    ECAP: int      # encoder frames a stream holds
    EXTCAP: int    # frames a beam round makes visible: at most a block
    ECAP_PAD: int  # the ring: ECAP and EXTCAP rows of tail padding, to 64


def engine_capacities(cfg, chunk_samples: int) -> EngineCapacities:
    """The engine's capacities. The encoder ring carries EXTCAP rows of
    tail padding so that a round's new-frames gather never clips its
    start; writes stay under ECAP (``would_stall`` and the finals' clamp).
    It is rounded to a multiple of 64 as in the JAX engine, so both rings
    have one shape."""
    bs, hop = cfg.block_size, cfg.hop_size
    wcap = cfg.win_length
    fcap = stft_frames(cfg, wcap + chunk_samples)
    rcap = fcap + 3 * cfg.subsample + 4
    subcap = subsampled_len(rcap, cfg.input_layer)
    maxb = max(1, -(-subcap // hop) + 1)
    pcap = max((maxb - 1) * hop + bs + hop, bs + subcap)
    ecap = cfg.max_enc_frames
    return EngineCapacities(wcap, fcap, rcap, subcap, maxb, pcap, ecap, bs,
                            -(-(ecap + bs) // 64) * 64)
