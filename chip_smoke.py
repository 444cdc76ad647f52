#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Builds the port's CUDA kernels from ``speechcatcher_tpu_torch/csrc`` with
nvcc for sm_90a, holds each kernel against its plain PyTorch version at the
flagship main-path shapes (the attention kernels also in the strided form
the main path hands them) and times both, then drives the port's paths at
flagship width (random weights from a seed), for the transformer encoder and
for the conformer encoder (``flagship_config(encoder_type="conformer")``):
three utterances through ``Speech2TextStreaming``, and ten streams through
the batched ``StreamingEngine`` (8 slots), each final held against the
single-stream session. Each path reads the launch counts of all eight
kernels, set to 0 just before it. It replays the fixtures blessed by the JAX
package (a transformer utterance that stops early and a token-rich one, a
conformer utterance and a token-rich one, one engine run), decodes at small width on the card
and the CPU, times ticks with 32 busy slots, and prints JSON lines. The
last line is ``{"ok": true, "device": {...}}``; any failure exits non-zero
before it.

Kernel F (each LayerNorm of the beam step with its residual add, bias
add and cache-row write) is held against its plain twin at the beam
step's rows, kernel G (each layer's lane self-attention) against its
twin at the beam step's hypotheses and positions, and kernel H (each
layer's cross-attention) against its twin at the beam step's, the
sessions' and a model directory's streams, beams and encoder lengths;
``--profile beam-step`` runs those alone, then times the graphed beam step
of the benchmark configurations at 32 and 256 streams (device ms and
kernels a replay), each block bit-equal to the eager loop.

ESPnet's conformer with its Transformer LM fused into the beam search, at
the published widths of the benchmark's ``aishell-cb-conformer-lm``
(``lm_path``, alone with ``--profile lm``): the LM's step against the
benchmark's plain full forward, the graphed session and engine held
bit-equal to the eager ones, the engine's finals equal to the session's.

The precision modes: kernel B on bfloat16 log-prob rows against its plain
version and, to the last bit, against itself on the widened rows; the
bfloat16 GEMM route of ``linear`` against the widened float32 product, timed
beside the float32 GEMM; the transformer session in ``dtype="bfloat16"``,
``"int8"`` and ``"int8-all"`` and the conformer session in ``"bfloat16"``;
the engine in the serving default (bfloat16 weights and bfloat16 decoder
cache, CTC ring and frame ring, mu-law wire) against the session on the same
model; the precision fixture (sessions in ``"bfloat16"`` and ``"int8-all"``,
the engine in the serving default); a model directory written from seed 0
and loaded through ``Speech2TextStreaming(model_dir=...)``; and warm RTF and
tick p50 of float32 and the serving default taken in turns.

The device-resident beam loop and chunk step (``graph_path``, for the
transformer and the conformer): every block loop, session chunk step and
engine encode runs as CUDA graphs on the card; here each graphed block,
chunk step and encode of a 6 s utterance and of the engine path's ten
streams is run again through the eager loop or ``StreamingEncoder.step``
on a copy of the same state, and every leaf must be bit-equal. It prints
beam steps and host syncs per block, the graphs captured and their memory,
the runtime calls the host makes and the device's idle share under
torch.profiler (an utterance and ticks, graphed and eager), tick p50/p95
and RTF graphed against eager in three interleaved pairs, the dp = 2 tick
against the unsharded engine, and, after the session's
``capture_graphs(8000)``, three more utterances that must capture nothing
and hold no more memory. Every other path runs through the graphs too,
with the launch counts of the eager loop and step.

The app and serving layer, on a flagship that emits tokens (the token-rich
fixture's weights and biases): ``recognize_file`` on a 70 s WAV serially
through the session and batched over the engine (equal .txt and .json), the
command line in a subprocess against ``load_model`` + ``recognize_file`` in
this process, and six websocket clients on ``start_server`` over an 8-slot
engine, each final equal to the single-stream session's, a ninth client
refused as busy, and nothing caught, quarantined or logged as an error.

Training and offline greedy decode: kernels A and E through their autograd
Functions at the training shapes (16, 40 and 392 windows), each gradient
equal to plain autograd's, and B, C and D refusing operands that require
grad; for the flagship transformer and conformer, the train step as CUDA
graphs (one per batch signature, two buckets in one pool, then a 16 s
signature) against the eager step under WarmupLR and a binding clip,
bit-equal under deterministic algorithms, with A's (E's) forward and
backward counted per graphed step, every loss finite and falling on a
repeated batch, the CTC loop's graph nodes and share, profiles and
timing pairs, and ``evaluate`` (greedy WER) graphed against eager; one
small-width train step on the card against the CPU; a batch
of eight waveforms of 2-30 s through ``greedy_decode_batch`` (RTF; at
small width equal to the CPU's tokens); and the trainer's command line
as a process, resumed from its checkpoint.

    python3 chip_smoke.py                       # everything
    python3 chip_smoke.py --profile             # device time of one utterance
    python3 chip_smoke.py --profile engine      # device time of engine ticks
    python3 chip_smoke.py --profile engine --precision serving_default
    python3 chip_smoke.py --profile conformer   # one conformer utterance
    python3 chip_smoke.py --profile tiling      # attention kernels, 1-32 windows
    python3 chip_smoke.py --profile recursion   # CTC recursion, 5-160 hypotheses
    python3 chip_smoke.py --profile recognize   # recognize() on 70 s, 1 and 4
    python3 chip_smoke.py --profile train       # a train step, graphed and eager
    python3 chip_smoke.py --profile train-memory       # step and eval memory
    python3 chip_smoke.py --profile train-in-process   # train paths, profiles
    python3 chip_smoke.py --profile mesh-step   # the eager step a mesh runs
    python3 chip_smoke.py --profile beam-step   # F, G, H, graphed beam steps
    python3 chip_smoke.py --profile lm          # the LM configuration's paths

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import functools
import json
import logging
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_flagship.json"
ENGINE_FIXTURE = (ROOT / "tests" / "fixtures"
                  / "torch_port_engine_flagship.json")
CONFORMER_FIXTURE = (ROOT / "tests" / "fixtures"
                     / "torch_port_conformer_flagship.json")
TOKENS_FIXTURE = (ROOT / "tests" / "fixtures"
                  / "torch_port_flagship_tokens.json")
CONFORMER_TOKENS_FIXTURE = (ROOT / "tests" / "fixtures"
                            / "torch_port_conformer_tokens.json")
PRECISION_FIXTURE = (ROOT / "tests" / "fixtures"
                     / "torch_port_precision_flagship.json")
PRECISIONS = ("float32", "ctc_ring_bf16", "serving_default", "int8",
              "int8_all")
# Scores where values are stored in bfloat16 (CTC log-prob ring, decoder
# cache, projected K/V): two runs that sum in another order (the engine's
# batched GEMMs and the session's, the card and the CPU) can put a stored
# value on either side of a rounding boundary, one bfloat16 ulp apart (0.03
# at a log-prob of -8), so final scores of -20 to -60 agree to 1e-3, not the
# 1e-4 of float32 storage. Tokens and positions are held exactly.
BF16_STORAGE_SCORE_TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_FLOPS = 67e12          # H100 SXM float32 peak outside the tensor cores
CHUNK_SECONDS = 0.5
ENGINE_MAXB = 2  # StreamingEngine.MAXB at flagship with 8192-sample chunks
# The app paths' model: the weights (seed 1) and emission profile (EOS +2,
# blank +8) of the token-rich fixture. With EOS +4 and blank +10 the
# flagship's transcript of a 27 s span is empty.
TALKER_SEED, TALKER_BIASES = 1, (2.0, 8.0)


_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also carries the seconds since
    the script started."""
    if "phase" in obj:
        obj = obj | {"elapsed_s": round(time.perf_counter() - _START, 1)}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of fn over reps calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(n_bytes: float, n_ops: float):
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / FP32_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def check_attention(dev, cfg, n_blocks: int, rel: bool):
    """Kernel A (rel=False) or E at (n_blocks, H, W, dk): the session runs
    one or two windows per step, the engine 8 slots x ENGINE_MAXB. Held
    against the plain version for contiguous operands and in the main
    path's form: q, k, v (and E's pos) as the transposed views of
    (N, W, H*dk) projections, the result merged back to (N, W, H*dk)
    through transpose(1, 2).reshape, which must be a view. Timed in that
    form, in turns with one scaled_dot_product_attention call on the same
    operands."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from speechcatcher_tpu_torch.models.encoder import block_attention_mask
    from speechcatcher_tpu_torch.ops.kernels import (
        block_attention as attention_mod,
        rel_attention as rel_mod,
    )
    from speechcatcher_tpu_torch.ops.kernels.block_attention import (
        attention_plan,
        block_attention,
        block_attention_plain,
    )
    from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
        rel_block_attention,
        rel_block_attention_plain,
    )

    kernel, plain = ((rel_block_attention, rel_block_attention_plain) if rel
                     else (block_attention, block_attention_plain))
    plans = (rel_mod if rel else attention_mod)._PLANS
    name = kernel.__name__
    n, h, w = n_blocks, cfg.encoder_heads, cfg.block_size + 2
    dk = cfg.encoder_dim // h
    rng = np.random.default_rng(5 if rel else 1)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev)

    def projected(lead):
        return rand(lead, w, h * dk).reshape(lead, w, h, dk).transpose(1, 2)

    mask = torch.from_numpy(block_attention_mask(cfg.block_size)).to(dev)
    biases = [rand(h, dk), rand(h, dk)] if rel else []
    forms = {
        "contiguous": [rand(n, h, w, dk) for _ in range(3)]
        + ([rand(h, w, dk)] if rel else []) + biases + [mask],
        "projection": [projected(n) for _ in range(3)]
        + ([projected(1)[0]] if rel else []) + biases + [mask],
    }
    tol = 1e-5
    errs = {}
    for form, args in forms.items():
        got = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        errs[form] = float((got - ref).abs().max())
        if not errs[form] <= tol or not bool((got[:, :, 0] == 0).all()):
            fail(f"{name} disagrees at N={n} ({form} operands): "
                 f"max_abs_err={errs[form]} (tol {tol})")
        merged = got.transpose(1, 2).reshape(n, w, h * dk)
        if merged.data_ptr() != got.data_ptr():
            fail(f"{name}: merging the heads of the result copies")
    args = forms["projection"]
    q, k, v = args[:3]
    library, lib_q, lib_mask, extra = library_call(rel, args, mask, dk)

    def main_form():
        return kernel(*args).transpose(1, 2).reshape(n, w, h * dk)

    ms, lib_ms, k_all, l_all = timed_pairs(
        main_form,
        lambda: F.scaled_dot_product_attention(lib_q, k, v,
                                               attn_mask=lib_mask))
    n_bytes = (4 * q.numel() + extra + mask.numel()) * 4
    n_ops = (3 if rel else 2) * (2 * n * h * w * w * dk)
    b_ms, b_by = bound(n_bytes, n_ops)
    # The tiling follows the number of blocks (one query row a warp, or two
    # once there are more blocks than SMs): the same launch under either,
    # with a fresh plan each time.
    limit = attention_mod.ONE_ROW_MAX_BLOCKS
    by_tiling = {}
    for rows_per_warp, forced in ((1, float("inf")), (2, -1)):
        attention_mod.ONE_ROW_MAX_BLOCKS = forced
        plans.clear()
        by_tiling[rows_per_warp] = device_us(main_form, name + "_kernel")
    attention_mod.ONE_ROW_MAX_BLOCKS = limit
    plans.clear()
    return {
        "name": name, "route": "cuda",
        "source": "speechcatcher_tpu_torch/csrc/"
                  + ("rel_attention.cu" if rel else "block_attention.cu"),
        "replaces": "speechcatcher_tpu/ops/pallas/"
                    + ("rel_attention.py:151" if rel
                       else "block_attention.py:108"),
        "shape": [n, h, w, dk],
        "operands": "transposed views of (N, W, H*dk) projections",
        "max_abs_err": max(errs.values()), "max_abs_err_by_form": errs,
        "tol": tol, "ms": ms, "ms_runs": k_all,
        "ms_contiguous": cuda_ms(lambda: kernel(*forms["contiguous"]), 200),
        "device_us": device_us(main_form, name + "_kernel"),
        "device_us_contiguous": device_us(
            lambda: kernel(*forms["contiguous"]), name + "_kernel"),
        "rows_per_warp": attention_plan(name, q, k, v, mask,
                                        *args[3:-1]).rpw,
        "device_us_by_rows_per_warp": by_tiling,
        "plain_ms": cuda_ms(lambda: plain(*args), 200),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_ms_runs": l_all, "library": library,
    }


RECURSION_KERNEL = "ctc_forward_recursion_kernel"
RECURSION_STREAMS = (1, 8, 32)   # one stream, the engine at 8 and 32 slots
# B holds its plain version to this: the kernel scans the recursion in log
# steps, so its float32 sums associate in another order than the plain
# version's frame-by-frame loop (about ten ulps at |r| of a few thousand).
# Frames outside [start, end) are fills and must be equal to the last bit.
RECURSION_TOL_ABS, RECURSION_TOL_REL = 1e-4, 1e-5


def recursion_ranges(t_cap: int) -> dict:
    """name -> ((start lo, hi), (end lo, hi)), hi exclusive: the range the
    kernel table has always used, the main path's (a 4-6 s utterance has
    40 to 150 frames) and a full ring."""
    return {"table": ((1, 30), (150, 400)),
            "main_path": ((1, 30), (40, 150)),
            "full_ring": ((1, 2), (t_cap, t_cap + 1))}


def recursion_reference_operands(dev, t_cap: int, n: int, start_range,
                                 end_range, edges: bool = False):
    """Operands of kernel B's reference form: xn, xb, phi_shift (T, N),
    start, end (N,) int32, olen0 (N,) float32. With `edges`, the last
    hypothesis gets end <= start and the first start = 1 with olen0."""
    import numpy as np
    import torch

    from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import LOGZERO

    rng = np.random.default_rng(2)

    def logp():
        return np.log(rng.random((t_cap, n), dtype=np.float32) + 1e-3)

    xn, xb = logp(), logp()
    phi = logp() * 3
    phi[0] = LOGZERO
    start = rng.integers(*start_range, size=n).astype(np.int32)
    end = np.minimum(rng.integers(*end_range, size=n), t_cap).astype(np.int32)
    if edges:
        start[0] = 1
        end[-1] = start[-1] - (n % 2)
    olen0 = (start == 1).astype(np.float32)
    return [torch.from_numpy(a).to(dev)
            for a in (xn, xb, phi, start, end, olen0)]


def recursion_stream_operands(dev, cfg, s_dim: int, beam: int,
                              start_range, end_range, edge=None,
                              ring_dtype=None):
    """Operands of kernel B's main-path form as ctc_advance_state makes
    them: xn (S, B, T) gathered from an (S, V, T) log-prob ring, xb its
    blank row as an (S, 1, T) view (stride V * T over streams), phi (S, B, T) unshifted, olen (S,) int64, enc_len
    (S,) int32, r_src (S, B, 2, T). `edge` changes stream 0: "olen0" gives
    it no token yet, "empty" an end at or before its start. `ring_dtype`
    (default float32) is the ring's, and so xn's and xb's."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    vocab, t_cap = cfg.vocab_size, cfg.max_enc_frames
    ring = torch.from_numpy(np.log(rng.random(
        (s_dim, vocab, t_cap), dtype=np.float32) + 1e-3)).to(
            dev, ring_dtype or torch.float32)
    token = torch.from_numpy(rng.integers(1, vocab, size=(s_dim, beam))
                             ).to(dev)
    xn = ring[torch.arange(s_dim, device=dev)[:, None], token, :]
    xb = ring[:, None, 0, :]
    phi = torch.from_numpy(np.log(rng.random(
        (s_dim, beam, t_cap), dtype=np.float32) + 1e-3) * 3).to(dev)
    olen = rng.integers(*start_range, size=s_dim).astype(np.int64)
    enc_len = np.minimum(rng.integers(*end_range, size=s_dim),
                         t_cap).astype(np.int32)
    if edge == "olen0":
        olen[0] = 0
    elif edge == "empty":
        olen[0], enc_len[0] = 3, 2
    r_src = torch.from_numpy(np.log(rng.random(
        (s_dim, beam, 2, t_cap), dtype=np.float32) + 1e-3) * 50).to(dev)
    return [xn, xb, phi, torch.from_numpy(olen).to(dev),
            torch.from_numpy(enc_len).to(dev), r_src]


def recursion_error(what: str, got, ref, filled) -> float:
    """Max abs error of B against its plain version; fails outside the
    tolerance, or where a fill (`filled`, broadcast against the result)
    is not equal to the last bit."""
    import torch

    torch.cuda.synchronize()
    diff = (got - ref).abs()
    if not bool((diff <= RECURSION_TOL_ABS
                 + RECURSION_TOL_REL * ref.abs()).all()):
        fail(f"{what} disagrees: max_abs_err={float(diff.max())}")
    if not bool((got == ref)[filled.expand_as(got)].all()):
        fail(f"{what}: a frame outside [start, end) differs from the fill")
    return float(diff.max())


def recursion_widened_equal(what: str, got, widened) -> None:
    """Fail unless B on bfloat16 rows equals B on the same rows widened to
    float32, to the last bit."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got, widened):
        fail(f"{what}: differs from the kernel on the widened rows by "
             f"{float((got - widened).abs().max())}")


def check_ctc_recursion(dev, cfg, beam: int):
    """Kernel B against its plain version in both forms (the reference
    form with (T, N) operands, and the main path's: time-minor (S, B, T)
    operands, the blank row at stride 0, per-stream olen and enc_len, the
    frames from `end` on copied from r_src) at 1, 8 and 32 streams of
    `beam` hypotheses over the three ranges of recursion_ranges, each with
    a hypothesis whose end is at or before its start and one with no token
    yet. The same cases again with bfloat16 log-prob rows (gathered from a
    bfloat16 ring): within the tolerance of the plain version, and equal to
    the last bit to the kernel on the same rows widened to float32. Timed in
    the main path's form on float32 and on bfloat16 rows; the row's numbers
    are those of one stream at the table's range."""
    import torch

    from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
        ctc_forward_recursion,
        ctc_forward_recursion_plain,
        ctc_forward_recursion_streams,
        ctc_forward_recursion_streams_plain,
    )

    t_cap = cfg.max_enc_frames
    t_idx = torch.arange(t_cap, device=dev)
    errs, errs_bf16, by_case = [], [], []
    for s_dim in RECURSION_STREAMS:
        n = s_dim * beam
        for name, (start_range, end_range) in recursion_ranges(t_cap).items():
            args = recursion_reference_operands(dev, t_cap, n, start_range,
                                                end_range, edges=True)
            start, end = args[3], args[4]
            filled = ((t_idx[:, None] < start[None, :])
                      | (t_idx[:, None] >= end[None, :]))[None]
            errs.append(recursion_error(
                f"ctc_forward_recursion (N={n}, {name})",
                ctc_forward_recursion(*args),
                ctc_forward_recursion_plain(*args), filled))
            bargs = [a.bfloat16() for a in args[:2]] + args[2:]
            got = ctc_forward_recursion(*bargs)
            errs_bf16.append(recursion_error(
                f"ctc_forward_recursion, bfloat16 rows (N={n}, {name})",
                got, ctc_forward_recursion_plain(*bargs), filled))
            recursion_widened_equal(
                f"ctc_forward_recursion (N={n}, {name})", got,
                ctc_forward_recursion(bargs[0].float(), bargs[1].float(),
                                      *bargs[2:]))
            for edge in (None, "olen0", "empty"):
                for ring_dtype in (torch.float32, torch.bfloat16):
                    sargs = recursion_stream_operands(
                        dev, cfg, s_dim, beam, start_range, end_range, edge,
                        ring_dtype)
                    olen, enc_len = sargs[3], sargs[4]
                    begin = olen.clamp(min=1, max=t_cap)
                    filled = ((t_idx[None, :] < begin[:, None])
                              | (t_idx[None, :] >= enc_len[:, None])
                              )[:, None, None, :]
                    what = (f"ctc_forward_recursion_streams, {ring_dtype} "
                            f"rows (N={n}, {name}, edge {edge})")
                    got = ctc_forward_recursion_streams(*sargs)
                    err = recursion_error(
                        what, got,
                        ctc_forward_recursion_streams_plain(*sargs), filled)
                    if ring_dtype == torch.float32:
                        errs.append(err)
                        continue
                    errs_bf16.append(err)
                    recursion_widened_equal(
                        what, got, ctc_forward_recursion_streams(
                            sargs[0].float(), sargs[1].float(), *sargs[2:]))
            by_case.append(time_recursion(dev, cfg, s_dim, beam, name,
                                          start_range, end_range))
    # The row: one stream at the table's range, in the main path's form
    # (the first case timed above).
    row = by_case[0]
    sargs = recursion_stream_operands(dev, cfg, 1, beam,
                                      *recursion_ranges(t_cap)["table"])
    olen = int(sargs[3][0])
    begin = min(max(olen, 1), t_cap)
    end = int(sargs[4][0])
    frames = max(end - begin, 0)
    # What the function needs, which is less than the kernel moves (it
    # stages whole rows). Read: xn[begin:end) and phi[begin-1:end-1) per
    # hypothesis, the blank row's [begin:end) once, xn[0] where the stream
    # has no token yet, r_src from `end` on, olen (int64) and enc_len
    # (int32); written: r_new.
    # The log-prob rows (xn, xb) take `row` bytes a value, the rest four.
    def n_bytes(row: int) -> int:
        return (((beam + 1) * frames + beam * (olen == 0)) * row
                + (beam * frames + 2 * beam * (t_cap - end)
                   + 2 * beam * t_cap) * 4 + 12)

    # Two lse2 (7 ops each) and two adds per recursed frame.
    b_ms, b_by = bound(n_bytes(4), 16 * frames * beam)
    b_ms_bf16, _ = bound(n_bytes(2), 16 * frames * beam)
    return {
        "name": "ctc_forward_recursion", "route": "cuda",
        "source": "speechcatcher_tpu_torch/csrc/ctc_recursion.cu",
        "replaces": "speechcatcher_tpu/ops/pallas/ctc_recursion.py:88",
        "shape": [1, beam, t_cap],
        "operands": "time-minor (S, B, T), blank row at stride 0",
        "max_abs_err": max(errs + errs_bf16),
        "max_abs_err_bf16_rows": max(errs_bf16),
        "bf16_rows_equal_widened": True,
        "tol": f"{RECURSION_TOL_ABS} + {RECURSION_TOL_REL}*|ref|, "
               "fills exact; bfloat16 rows equal to the widened rows' "
               "result to the last bit",
        "ms": row["ms"], "device_us": row["device_us"],
        "ms_bf16": row["ms_bf16"], "device_us_bf16": row["device_us_bf16"],
        "bound_ms_bf16": b_ms_bf16,
        "ms_reference": row["ms_reference"],
        "device_us_reference": row["device_us_reference"],
        "by_case": by_case,
        "plain_ms": cuda_ms(
            lambda: ctc_forward_recursion_streams_plain(*sargs), 3, 1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "library": None,
    }


def time_recursion(dev, cfg, s_dim: int, beam: int, name: str,
                   start_range, end_range) -> dict:
    """Call time (event mean over 200 calls) and device time per launch of
    kernel B at s_dim * beam hypotheses over one range, in the main path's
    form on float32 and on bfloat16 rows, and in the reference form."""
    import torch

    from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
        ctc_forward_recursion,
        ctc_forward_recursion_streams,
    )

    t_cap = cfg.max_enc_frames
    n = s_dim * beam
    args = recursion_reference_operands(dev, t_cap, n, start_range, end_range)
    sargs = recursion_stream_operands(dev, cfg, s_dim, beam, start_range,
                                      end_range)
    bargs = recursion_stream_operands(dev, cfg, s_dim, beam, start_range,
                                      end_range, ring_dtype=torch.bfloat16)
    begin = sargs[3].clamp(min=1, max=t_cap)
    # float32 and bfloat16 rows in turns.
    ms, ms_bf16, _, _ = timed_pairs(
        lambda: ctc_forward_recursion_streams(*sargs),
        lambda: ctc_forward_recursion_streams(*bargs))
    return {"n": n, "range": name,
            "recursed_frames_max": int((sargs[4] - begin).max()),
            "ms": ms, "ms_bf16": ms_bf16,
            "device_us": device_us(
                lambda: ctc_forward_recursion_streams(*sargs),
                RECURSION_KERNEL),
            "device_us_bf16": device_us(
                lambda: ctc_forward_recursion_streams(*bargs),
                RECURSION_KERNEL),
            "ms_reference": cuda_ms(
                lambda: ctc_forward_recursion(*args), 200),
            "device_us_reference": device_us(
                lambda: ctc_forward_recursion(*args), RECURSION_KERNEL)}


def profile_recursion(dev, cfg, beam: int = 5):
    """Kernel B's call and device time at 1, 8 and 32 streams of `beam`
    hypotheses over the three ranges."""
    t_cap = cfg.max_enc_frames
    for s_dim in RECURSION_STREAMS:
        for name, (start_range, end_range) in recursion_ranges(t_cap).items():
            emit({"phase": "profile_recursion"} | time_recursion(
                dev, cfg, s_dim, beam, name, start_range, end_range))


def timed_pairs(kernel, library, reps: int = 200, pairs: int = 3):
    """Kernel and library call timed in turns (kernel, library, kernel,
    ...), `pairs` times each by cuda_ms; the median of each side."""
    import statistics

    k_ms, l_ms = [], []
    for _ in range(pairs):
        k_ms.append(cuda_ms(kernel, reps))
        l_ms.append(cuda_ms(library, reps))
    return statistics.median(k_ms), statistics.median(l_ms), k_ms, l_ms


def check_ring_append(dev, cfg, n_new: int, n_slots: int):
    """Kernel C, exact against its plain version: a contiguous (S, V, TN)
    `new` of the ring's dtype, and the main path's form, the transposed
    view of time-major (S, TN, V) float32 log-probs, into float32 and
    bfloat16 rings, at the session's (1, V, T) ring with n_new columns and
    at the engine's (n_slots, V, T) ring with up to EXTCAP = block_size.
    Timed at the session's form against one slice assignment from the
    same view, in interleaved pairs."""
    import numpy as np
    import torch

    from speechcatcher_tpu_torch.ops.kernels.ring_append import (
        ring_append_cols,
        ring_append_cols_plain,
    )

    v, t_cap, extcap = cfg.vocab_size, cfg.max_enc_frames, cfg.block_size
    rng = np.random.default_rng(3)
    errs = []

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    def check(s, tn, dtype, time_major, starts, counts):
        ring0 = rand(s, v, t_cap).to(dev, dtype)
        if time_major:
            new = rand(s, tn, v).to(dev).transpose(1, 2)
        else:
            new = rand(s, v, tn).to(dev, dtype)
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        count = torch.tensor(counts, dtype=torch.int32, device=dev)
        got = ring_append_cols(ring0.clone(), new, start, count)
        ref = ring_append_cols_plain(ring0.clone(), new, start, count)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"ring_append_cols differs ({s} slots, TN {tn}, {dtype}, "
                 f"{'time-major f32' if time_major else 'contiguous'} new, "
                 f"starts {starts}, counts {counts})")
        errs.append(float((got.float() - ref.float()).abs().max()))

    for dtype in (torch.float32, torch.bfloat16):
        for time_major in (False, True):
            for st0, cnt in ((100, n_new), (t_cap - 5, n_new), (7, 0),
                             (40, n_new + 9)):
                check(1, n_new, dtype, time_major, [st0], [cnt])
        # The engine's ring: fill levels across it, counts 0..EXTCAP+3, one
        # span hanging off the end.
        starts = rng.integers(0, t_cap - extcap, size=n_slots)
        starts[0], starts[-1] = 0, t_cap - extcap // 2
        counts = rng.integers(0, extcap + 4, size=n_slots)
        counts[1] = 0
        for tn in (extcap, n_new):
            check(n_slots, tn, dtype, True, starts.tolist(), counts.tolist())
    s = 1
    ring = torch.zeros((s, v, t_cap), dtype=torch.float32, device=dev)
    new_tm = torch.randn((s, n_new, v), device=dev)
    start = torch.tensor([100], dtype=torch.int32, device=dev)
    count = torch.tensor([n_new], dtype=torch.int32, device=dev)

    def kernel():
        ring_append_cols(ring, new_tm.transpose(1, 2), start, count)

    def library():
        ring[:, :, 100:100 + n_new] = new_tm.transpose(1, 2)

    ms, lib_ms, k_all, l_all = timed_pairs(kernel, library)
    ring_e = torch.zeros((n_slots, v, t_cap), dtype=torch.float32, device=dev)
    new_e = torch.randn((n_slots, extcap, v), device=dev)
    start_e = torch.full((n_slots,), 100, dtype=torch.int32, device=dev)
    count_e = torch.full((n_slots,), extcap, dtype=torch.int32, device=dev)
    b_ms, b_by = bound(2 * s * v * n_new * 4 + 2 * s * 4, 0)
    return {
        "name": "ring_append_cols", "route": "cuda",
        "source": "speechcatcher_tpu_torch/csrc/ring_append.cu",
        "replaces": "speechcatcher_tpu/ops/pallas/ring_append.py:227",
        "shape": [s, v, t_cap, n_new], "new": "time-major f32, transposed",
        "max_abs_err": max(errs), "tol": 0.0,
        "ms": ms, "ms_runs": k_all,
        "device_us": device_us(kernel, "ring_append_cols_kernel"),
        "device_us_engine": device_us(
            lambda: ring_append_cols(ring_e, new_e.transpose(1, 2), start_e,
                                     count_e),
            "ring_append_cols_kernel"),
        "engine_shape": [n_slots, v, t_cap, extcap],
        "plain_ms": cuda_ms(lambda: ring_append_cols_plain(
            ring, new_tm.transpose(1, 2), start, count), 200),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_ms_runs": l_all,
        "library": "slice assignment from the transposed view",
    }


def device_us(fn, kernel: str, reps: int = 50):
    """Device time per launch of `kernel` under torch.profiler (None when
    the profiler shows no device time for it in three tries: a trace now
    and then comes back without the kernel's device rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if kernel in e.key and e.self_device_time_total > 0]
        if rows:
            return (sum(e.self_device_time_total for e in rows)
                    / sum(e.count for e in rows))
    return None


def check_ring_append_rows(dev, cfg, n_slots: int):
    """Kernel D at the engine's three ring shapes (flagship, 8192-sample
    chunks), float32 and bfloat16 rings, exact, for a contiguous `new` of
    the ring's dtype, a strided one (a slice along time, as the post carry
    gets `sub[:, :SUBCAP]`) and float32 into bfloat16 (contiguous and
    strided); timed at the enc_out append against `index_put_`, in
    interleaved pairs."""
    import numpy as np
    import torch

    from speechcatcher_tpu_torch.ops.kernels.ring_append import (
        ring_append_rows,
        ring_append_rows_plain,
    )

    s = n_slots
    d = cfg.encoder_dim
    # (ring, T, D, TN): enc_out (ECAP_PAD rows), post (PCAP), raw (RCAP).
    shapes = [("enc_out", 832, d, 40), ("post", 72, d, 16),
              ("raw", 70, cfg.n_mels, 54)]
    rng = np.random.default_rng(4)
    errs = []
    for name, t_cap, width, tn in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            cache0 = torch.from_numpy(rng.standard_normal(
                (1, s, t_cap, width), dtype=np.float32)).to(dev, dtype)
            big = torch.from_numpy(rng.standard_normal(
                (1, s, tn + 7, width), dtype=np.float32)).to(dev)
            forms = {"contiguous": big[:, :, :tn].contiguous().to(dtype),
                     "strided": big.to(dtype)[:, :, 3:tn + 3]}
            if dtype == torch.bfloat16:
                forms["f32 contiguous"] = big[:, :, :tn].contiguous()
                forms["f32 strided"] = big[:, :, 3:tn + 3]
            # Fill levels across the ring, counts 0..TN+3, one span hanging
            # off the end.
            start = rng.integers(0, t_cap - tn, size=s)
            start[0], start[-1] = 0, t_cap - tn // 2
            count = rng.integers(0, tn + 4, size=s)
            count[1] = 0
            start_t = torch.from_numpy(start.astype(np.int32)).to(dev)
            count_t = torch.from_numpy(count.astype(np.int32)).to(dev)
            for form, new in forms.items():
                got = ring_append_rows(cache0.clone(), new, start_t, count_t)
                ref = ring_append_rows_plain(cache0.clone(), new, start_t,
                                             count_t)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    fail(f"ring_append_rows differs ({name}, {dtype}, "
                         f"{form} new)")
                errs.append(float((got.float() - ref.float()).abs().max()))
    # Timing: the flagship enc_out append of a first chunk at every slot.
    t_cap, tn = 832, 40
    cache = torch.zeros((1, s, t_cap, d), dtype=torch.float32, device=dev)
    new = torch.randn((1, s, tn, d), device=dev)
    start = torch.full((s,), 100, dtype=torch.int32, device=dev)
    count = torch.full((s,), tn, dtype=torch.int32, device=dev)
    s_idx = torch.arange(s, device=dev).repeat_interleave(tn)
    t_idx = 100 + torch.arange(tn, device=dev).repeat(s)
    vals = new[0].reshape(s * tn, d)

    def kernel():
        ring_append_rows(cache, new, start, count)

    def library():
        cache[0].index_put_((s_idx, t_idx), vals)

    ms, lib_ms, k_all, l_all = timed_pairs(kernel, library)
    n_rows = int(count.sum())
    b_ms, b_by = bound(2 * n_rows * d * 4 + 2 * s * 4, 0)
    return {
        "name": "ring_append_rows", "route": "cuda",
        "source": "speechcatcher_tpu_torch/csrc/ring_append.cu",
        "replaces": "speechcatcher_tpu/ops/pallas/ring_append.py:147",
        "shape": [1, s, t_cap, d, tn], "max_abs_err": max(errs), "tol": 0.0,
        "ms": ms, "ms_runs": k_all,
        "device_us": device_us(kernel, "ring_append_rows_kernel"),
        "plain_ms": cuda_ms(
            lambda: ring_append_rows_plain(cache, new, start, count), 50),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_ms_runs": l_all,
        "library": "Tensor.index_put_ (precomputed indices)",
    }


def check_ring_append_rows_session(dev, cfg, chunk_samples: int):
    """Kernel D at the session's one slot into its three float32 buffers:
    the carried features ``carry.raw`` (RCAP, n_mels), the carried
    subsampled frames ``carry.post`` (PCAP, d) and the emitted-frame ring
    (max_enc_frames, d), with every row count a stream of
    `chunk_samples`-sample chunks appends there (``chunk_signatures``:
    feature frames, subsampled frames, frames emitted, finals included).
    Each count at the start, mid-buffer, flush with the end and hanging
    off it, with count = rows (as the session appends), rows - 1 and 0,
    for a contiguous and a strided `new`; exact over the whole buffer.
    Timed at the ring append of one block's hop_size frames."""
    import numpy as np
    import torch

    from speechcatcher_tpu_torch.geometry import carry_capacity
    from speechcatcher_tpu_torch.ops.kernels.ring_append import (
        ring_append_rows,
        ring_append_rows_plain,
    )
    from speechcatcher_tpu_torch.streaming import chunk_signatures

    rcap, pcap = carry_capacity(cfg)
    d = cfg.encoder_dim
    rows = {"raw": set(), "post": set(), "ring": set()}
    for key in chunk_signatures(cfg, chunk_samples):
        if key[0] == "frontend":
            rows["raw"].add(key[1] - key[2] - key[3])
        elif key[0] == "subsample":
            rows["post"].add(key[1].n_sub)
        else:
            rows["ring"].add(key[1].y_length)
    buffers = {"raw": (rcap, cfg.n_mels), "post": (pcap, d),
               "ring": (cfg.max_enc_frames, d)}
    rng = np.random.default_rng(5)
    errs, cases = [], 0
    for name, (t_cap, width) in buffers.items():
        cache0 = torch.from_numpy(rng.standard_normal(
            (1, 1, t_cap, width), dtype=np.float32)).to(dev)
        for n in sorted(rows[name] - {0}):
            big = torch.from_numpy(rng.standard_normal(
                (1, 1, n + 7, width), dtype=np.float32)).to(dev)
            forms = {"contiguous": big[:, :, :n].contiguous(),
                     "strided": big[:, :, 3:n + 3]}
            starts = {0, int(rng.integers(0, t_cap - n + 1)), t_cap - n,
                      t_cap - (n + 1) // 2}
            for start in sorted(starts):
                for count in sorted({n, n - 1, 0}):
                    start_t = torch.tensor([start], dtype=torch.int32,
                                           device=dev)
                    count_t = torch.tensor([count], dtype=torch.int32,
                                           device=dev)
                    for form, new in forms.items():
                        got = ring_append_rows(cache0.clone(), new, start_t,
                                               count_t)
                        ref = ring_append_rows_plain(cache0.clone(), new,
                                                     start_t, count_t)
                        if not torch.equal(got, ref):
                            fail(f"ring_append_rows differs at the "
                                 f"session's {name} buffer ({n} rows, "
                                 f"start {start}, count {count}, {form} "
                                 "new)")
                        errs.append(float((got - ref).abs().max()))
                        cases += 1
    # Timing: one block's frames into the emitted-frame ring.
    t_cap, tn = cfg.max_enc_frames, cfg.hop_size
    cache = torch.zeros((1, 1, t_cap, d), device=dev)
    new = torch.randn((1, 1, tn, d), device=dev)
    start = torch.full((1,), t_cap // 2, dtype=torch.int32, device=dev)
    count = torch.full((1,), tn, dtype=torch.int32, device=dev)
    t_idx = t_cap // 2 + torch.arange(tn, device=dev)
    vals = new[0, 0]

    def kernel():
        ring_append_rows(cache, new, start, count)

    def library():
        cache[0, 0].index_put_((t_idx,), vals)

    ms, lib_ms, k_all, l_all = timed_pairs(kernel, library)
    b_ms, b_by = bound(2 * tn * d * 4 + 2 * 4, 0)
    return {
        "name": "ring_append_rows", "route": "cuda", "where": "session",
        "shapes": {name: [1, 1, t, w] for name, (t, w) in buffers.items()},
        "rows": {name: sorted(r) for name, r in rows.items()},
        "chunk_samples": chunk_samples, "cases": cases,
        "max_abs_err": max(errs), "tol": 0.0,
        "timed_shape": [1, 1, t_cap, d, tn], "ms": ms, "ms_runs": k_all,
        "device_us": device_us(kernel, "ring_append_rows_kernel"),
        "plain_ms": cuda_ms(
            lambda: ring_append_rows_plain(cache, new, start, count), 50),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_ms_runs": l_all,
        "library": "Tensor.index_put_ (precomputed indices)",
    }

# Kernel F's rows in the beam step: (S x beam, d) at the drain's compact
# width 32 and the backlog's 256 slots, beam 3, at both configurations'
# decoder widths.
ADD_LAYER_NORM_SHAPES = ((96, 512), (768, 512), (96, 256), (768, 256))
ADD_LAYER_NORM = "speechcatcher_tpu_torch.ops.kernels.add_layer_norm"


def optional_wrapper(module: str):
    """The wrapper of a kernel (the function that names its module), or
    None in a checkout from before the kernel: the beam-step phase
    measures the parent commit with this script too."""
    import importlib
    import importlib.util

    if importlib.util.find_spec(module) is None:
        return None
    return getattr(importlib.import_module(module), module.rsplit(".", 1)[1])


def check_add_layer_norm(dev):
    """Kernel F against its plain twin at ADD_LAYER_NORM_SHAPES, without
    and with the cache write (a float32 and a bfloat16 (N, 48, d) cache,
    a third of the rows not writing, one row past the capacity): the
    residual sums and the cache rows exact, the normalised rows within
    1e-5 of their largest value (the twin's sums run in another order).
    Each shape with the float32 cache write timed: CUDA-event ms, device
    us, the twin's ms and the bound (bytes: each operand read once, each
    result written once). The yardstick, F.layer_norm of the finished sum,
    is the norm alone. Returns the rows."""
    import numpy as np
    import torch

    from speechcatcher_tpu_torch.ops.kernels.add_layer_norm import (
        add_layer_norm,
        add_layer_norm_plain,
    )

    lmax = 48
    rows = []
    for n, d in ADD_LAYER_NORM_SHAPES:
        rng = np.random.default_rng(n + d)

        def rand(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape).astype(np.float32)).to(dev)

        p = {"weight": 1.0 + 0.1 * rand(d), "bias": 0.1 * rand(d)}
        h, y, b = 3.0 * rand(n, d) + 1.0, rand(n, d), rand(d)
        pos = torch.from_numpy(rng.integers(0, lmax, n)).to(dev)
        pos[0] = lmax
        write = torch.from_numpy(rng.random(n) < 0.67).to(dev)
        ref_h, ref_hn = add_layer_norm_plain(p, h, y, b)
        errs, abs_errs = {}, {}
        for form in ("none", "float32", "bfloat16"):
            if form == "none":
                got_h, got_hn = add_layer_norm(p, h, y, b)
            else:
                dtype = getattr(torch, form)
                cache0 = rand(n, lmax, d).to(dtype)
                cache = cache0.clone()
                got_h, got_hn = add_layer_norm(p, h, y, b, cache, pos, write)
                keep = (write & (pos < lmax))[:, None]
                at = pos.clamp(max=lmax - 1)
                idx = torch.arange(n, device=dev)
                cache0[idx, at] = torch.where(keep, got_hn.to(dtype),
                                              cache0[idx, at])
                torch.cuda.synchronize()
                if not torch.equal(cache, cache0):
                    fail(f"add_layer_norm ({n}, {d}): the {form} cache "
                         "differs from the kernel's rows written by the "
                         "twin's rule")
            torch.cuda.synchronize()
            if not torch.equal(got_h, ref_h):
                fail(f"add_layer_norm ({n}, {d}, {form}): h + (y + bias) "
                     "differs from the twin's")
            abs_errs[form] = float((got_hn - ref_hn).abs().max())
            errs[form] = abs_errs[form] / float(ref_hn.abs().max())
            if errs[form] > 1e-5:
                fail(f"add_layer_norm ({n}, {d}, {form}): relative error "
                     f"{errs[form]:.3g} > 1e-5")
        cache = torch.zeros((n, lmax, d), device=dev)

        def kernel():
            add_layer_norm(p, h, y, b, cache, pos, write)

        written = int((write & (pos < lmax)).sum())
        b_ms, b_by = bound(4 * (4 * n * d + 3 * d + written * d)
                           + 9 * n, 8 * n * d)
        summed = ref_h.clone()
        rows.append({
            "name": "add_layer_norm", "route": "cuda",
            "source": "speechcatcher_tpu_torch/csrc/add_layer_norm.cu",
            "replaces": "none (the JAX package's norms are XLA fusions)",
            "shape": [n, d], "cache": [n, lmax, d],
            "max_rel_err": errs, "max_abs_err": max(abs_errs.values()),
            "tol": 1e-5, "ms": cuda_ms(kernel, 200),
            "device_us": device_us(kernel, "add_layer_norm_kernel"),
            "plain_ms": cuda_ms(lambda: add_layer_norm_plain(
                p, h, y, b, cache, pos, write), 50),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: torch.nn.functional.layer_norm(
                summed, (d,), p["weight"], p["bias"], 1e-12), 200),
            "library": "F.layer_norm of the finished sum (the norm alone)",
        })
    return rows


# Kernel G's calls in the beam step: N = S x beam hypotheses at the drain's
# compact width 32 and the backlog's 256 slots, beam 3, Lmax = max_tokens,
# at both configurations' decoder widths (d, heads); every hypothesis at
# one position, as a stream's hypotheses are in the beam search.
LANE_ATTENTION = "speechcatcher_tpu_torch.ops.kernels.lane_attention"
LANE_ATTENTION_WIDTHS = (("de-xl-transformer", 512, 8),
                         ("aishell-cb-conformer", 256, 4))
LANE_ATTENTION_ROWS = (96, 768)
LANE_ATTENTION_POS = (0, 16, 32, 64, 191)
LANE_ATTENTION_LMAX = 192
LANE_ATTENTION_TOL = 2e-6


def check_lane_attention(dev, timed=True, widths=LANE_ATTENTION_WIDTHS,
                         sizes=LANE_ATTENTION_ROWS,
                         positions=LANE_ATTENTION_POS):
    """Kernel G against its plain twin at `widths` x `sizes` x
    `positions` (LANE_ATTENTION_*, Lmax 192, beam 3) for a float32
    and a bfloat16 cache, over a lane map whose hypotheses share a prefix
    and branch after it: the largest error against the twin evaluated in
    float64, over the largest |u|, within LANE_ATTENTION_TOL (the float32
    twin's own error on the card, cuBLAS's sums, reaches 4e-6 at N = 768
    and is printed beside it, with the kernel's distance to the float32
    twin), and the kernel's result bit-equal when every row at t >= pos
    holds NaN (it never reads one; the twin would, as 0 x NaN). With
    `timed`, each case also gets CUDA-event ms, device us, the twin's ms
    and the bound (bytes: the P history rows read once, qk, hn_self, lane
    and pos read, u written; operations 4 N h (P + 1) d). Returns the
    rows."""
    import numpy as np
    import torch

    from speechcatcher_tpu_torch.ops.kernels.lane_attention import (
        lane_attention,
        lane_attention_plain,
    )

    lmax, beam = LANE_ATTENTION_LMAX, BEAM_STEP_BEAM
    rows = []
    for config, d, heads in widths:
        dk = d // heads
        for n in sizes:
            s = n // beam
            rng = np.random.default_rng(n + d)

            def rand(*shape):
                return torch.from_numpy(rng.standard_normal(
                    shape).astype(np.float32)).to(dev)

            qk, hn, cache32 = rand(n, heads, d), rand(n, d), rand(n, lmax, d)
            lane_np = rng.integers(0, beam, (s, beam, lmax)).astype(np.int32)
            lane_np[:, :, :lmax // 3] = 0
            lane = torch.from_numpy(lane_np).to(dev)
            for p in positions:
                pos = torch.full((n,), p, dtype=torch.int64, device=dev)
                hidden = (torch.arange(lmax, device=dev) >= p)[None, :, None]
                for dtype in (torch.float32, torch.bfloat16):
                    cache = cache32.to(dtype)
                    got = lane_attention(qk, cache, hn, lane, pos, dk)
                    twin = lane_attention_plain(qk, cache, hn, lane, pos, dk)
                    ref = lane_attention_plain(qk.double(), cache,
                                               hn.double(), lane, pos, dk)
                    nan = torch.where(hidden, float("nan"),
                                      cache.float()).to(dtype)
                    again = lane_attention(qk, nan, hn, lane, pos, dk)
                    torch.cuda.synchronize()
                    what = (f"lane_attention {config} N={n} pos={p} "
                            f"{str(dtype)[6:]}")
                    if not torch.equal(again, got):
                        fail(f"{what}: a row at t >= pos changed the result")
                    scale = float(ref.abs().max())
                    abs_err = float((got - ref).abs().max())
                    err = abs_err / scale
                    if not err <= LANE_ATTENTION_TOL:
                        fail(f"{what}: relative error {err:.3g} > "
                             f"{LANE_ATTENTION_TOL}")
                    row = {"name": "lane_attention", "route": "cuda",
                           "source": "speechcatcher_tpu_torch/csrc/"
                                     "lane_attention.cu",
                           "replaces": "none (the JAX package's lane "
                                       "attention is XLA)",
                           "config": config, "shape": [n, heads, d],
                           "cache": [n, lmax, d], "cache_dtype":
                               str(dtype)[6:], "pos": p,
                           "max_rel_err": err, "max_abs_err": abs_err,
                           "tol": LANE_ATTENTION_TOL,
                           "rel_err_to_float32_twin": float(
                               (got - twin).abs().max()) / scale,
                           "float32_twin_rel_err": float(
                               (twin - ref).abs().max()) / scale}
                    if timed:
                        def kernel():
                            lane_attention(qk, cache, hn, lane, pos, dk)

                        valid = min(p, lmax)
                        b_ms, b_by = bound(
                            n * valid * d * cache.element_size()
                            + 4 * (2 * n * heads * d + n * d + n * valid)
                            + 8 * n, 4 * n * heads * (valid + 1) * d)
                        row |= {
                            "ms": cuda_ms(kernel, 100),
                            "device_us": device_us(kernel,
                                                   "lane_attention_kernel"),
                            "plain_ms": cuda_ms(lambda: lane_attention_plain(
                                qk, cache, hn, lane, pos, dk), 20),
                            "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None,
                            "library": "none: no PyTorch call reads rows "
                                       "through a lane map"}
                    rows.append(row)
    return rows


# Kernel H's calls: (configuration, heads, dk, beam, T, streams). The beam
# step's at the serving beam 3 over the ring's T = 832 rows, at the drain's
# compact width 32 and the backlog tick's 256 slots, for both
# configurations' decoder heads; the sessions' and engines' beam 5 (its
# second weighted-sum pass, one live query of four) at one stream and 8
# slots; and ``recognize_path``'s model directory without a config.yaml (4
# heads of 128 over a 2,112-row ring at beam 5: 61 KB of shared memory, the
# launch's opt-in). CROSS_ATTENTION_SMALL: the rt64 finals' compact widths
# 1-4, where the (stream, head) blocks leave most SMs idle.
CROSS_ATTENTION = "speechcatcher_tpu_torch.ops.kernels.cross_attention"
CROSS_ATTENTION_WIDTHS = (("de-xl-transformer", 8, 64, 3, 832, (32, 256)),
                          ("aishell-cb-conformer", 4, 64, 3, 832, (32, 256)),
                          ("de-xl-transformer", 8, 64, 5, 832, (1, 8)),
                          ("model-dir", 4, 128, 5, 2112, (1, 4)))
CROSS_ATTENTION_SMALL = (1, 2, 4)
CROSS_ATTENTION_TOL = 1e-5


def cross_attention_error(got, q, mk, mv, enc_len):
    """H's distance from its twin evaluated in float64, as (the largest
    error over its tolerance, which passes at <= 1; the largest error; the
    largest |out|). The tolerance is CROSS_ATTENTION_TOL of the largest
    |out|. With bfloat16 K/V the weights are rounded to bfloat16 from the
    kernel's float32 softmax and from the twin's float64 one: a weight
    within a float32 ulp of a bfloat16 rounding boundary may round either
    way (about 5e-5 of the weights), which moves its output row by one
    bfloat16 ulp of that weight, at most 2^-7 w_t |v_t|. So there each row
    also admits four such moves of its largest weighted V row."""
    import torch

    from speechcatcher_tpu_torch.ops.kernels.cross_attention import (
        cross_attention_plain,
    )

    q64 = q.double()
    ref = cross_attention_plain(q64, mk, mv, enc_len)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = (got.double() - ref).abs()
    tol = torch.full_like(err, CROSS_ATTENTION_TOL * scale)
    if mk.dtype == torch.bfloat16:
        s, h, t, dk = mk.shape
        beam = q64.shape[0] // s
        valid = (torch.arange(t, device=got.device)[None, :]
                 < enc_len.long()[:, None])[:, None, None, :]
        qh = q64.reshape(s, beam, h, dk).transpose(1, 2)
        sc = torch.matmul(qh.to(torch.bfloat16).double(),
                          mk.double().transpose(2, 3)) / dk ** 0.5
        w = torch.softmax(torch.where(valid, sc, -1e300), dim=-1)
        w = torch.where(valid, w, 0.0)
        most = (w[..., None] * mv.double()[:, :, None].abs()
                ).amax(dim=(3, 4))                       # (S, h, B)
        tol = tol + 4 * 2.0 ** -7 * most.transpose(1, 2).reshape(
            s * beam, h, 1).expand(-1, -1, dk).reshape(s * beam, h * dk)
    return float((err / tol).max()), float(err.max()), scale


def check_cross_attention(dev, timed=True, widths=CROSS_ATTENTION_WIDTHS,
                          small=CROSS_ATTENTION_SMALL):
    """Kernel H against its plain twin at `widths` (CROSS_ATTENTION_WIDTHS)
    for float32 and bfloat16 K/V, each stream's ``enc_len`` as backlog256
    gives it (``backlog_enc_lens``: whole uploads up to 32 streams, as the
    drain sees them, part-way streams above, as the tick does) with the
    edges 0, 1, T - 1 and T among them: within ``cross_attention_error``'s
    bound of the twin evaluated in float64 (the card tests' bound), and the
    kernel's result bit-equal when every K/V row at t >= enc_len holds NaN
    (it never reads one; the twin would, as 0 x NaN). With `timed`, each
    case also gets CUDA-event ms, device us, the bound (bytes: the enc_len
    rows of K and V read once, q read, the result written; operations 4 S
    h B L dk), the old path's ms (the twin in float32, the composition the
    step ran before H: both products over all T rows, the masks and the
    re-layouts) and, for float32 K/V, the library's ms (one
    ``F.scaled_dot_product_attention`` over the same views with the
    enc_len boolean mask, in interleaved pairs with H; its rows at enc_len
    0 are NaN, as SDPA gives a row with no key); and the first width's
    float32 call at `small` streams (the rt64 finals' widths) the same.
    Returns the rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.decoder import head_major
    from speechcatcher_tpu_torch.ops.kernels.cross_attention import (
        cross_attention,
        cross_attention_plain,
    )

    cfg = flagship_config()
    rows = []
    cases = [(c, h, dk, beam, t, s, dt)
             for c, h, dk, beam, t, streams in widths for s in streams
             for dt in (torch.float32, torch.bfloat16)]
    if timed:
        cases += [widths[0][:5] + (s, torch.float32) for s in small]
    for config, heads, dk, beam, t, s, dtype in cases:
        rng = np.random.default_rng([s, heads, dk, beam])

        def rand(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape).astype(np.float32)).to(dev)

        lens = backlog_enc_lens(cfg, s, final=s <= 32, seed=s)
        if s >= 4:
            lens[:4] = (0, 1, t - 1, t)
        enc_len = torch.from_numpy(lens.astype(np.int32)).to(dev)
        q = rand(s * beam, heads * dk)
        mk = head_major(rand(s, t, heads * dk), heads, dtype)
        mv = head_major(rand(s, t, heads * dk), heads, dtype)
        got = cross_attention(q, mk, mv, enc_len)
        twin = cross_attention_plain(q, mk, mv, enc_len)
        hidden = (torch.arange(t, device=dev)[None, :]
                  >= enc_len.long()[:, None])[:, None, :, None]
        again = cross_attention(
            q, torch.where(hidden, float("nan"), mk.float()).to(dtype),
            torch.where(hidden, float("nan"), mv.float()).to(dtype),
            enc_len)
        worst, abs_err, scale = cross_attention_error(got, q, mk, mv,
                                                      enc_len)
        what = (f"cross_attention {config} S={s} beam={beam} T={t} "
                f"{str(dtype)[6:]}")
        if not torch.equal(again, got):
            fail(f"{what}: a K/V row at t >= enc_len changed the result")
        if not worst <= 1.0:
            fail(f"{what}: error {worst:.3g} times its bound (relative "
                 f"error {abs_err / scale:.3g})")
        row = {"name": "cross_attention", "route": "cuda",
               "source": "speechcatcher_tpu_torch/csrc/cross_attention.cu",
               "replaces": "none (the JAX package's cross-attention is "
                           "XLA)",
               "config": config, "shape": [s, heads, t, dk], "beam": beam,
               "kv_dtype": str(dtype)[6:],
               "enc_len_mean": float(lens.mean()),
               "max_rel_err": abs_err / scale, "max_abs_err": abs_err,
               "err_over_bound": worst,
               "tol": CROSS_ATTENTION_TOL,
               "rel_err_to_float32_twin": float(
                   (got - twin).abs().max()) / scale}
        if timed:
            def kernel():
                cross_attention(q, mk, mv, enc_len)

            read = int(np.minimum(lens, t).sum())
            b_ms, b_by = bound(
                2 * read * heads * dk * mk.element_size()
                + 4 * 2 * s * beam * heads * dk + 4 * s,
                4 * beam * read * heads * dk)
            row |= {
                "ms": cuda_ms(kernel, 100),
                "device_us": device_us(kernel, "cross_attention_kernel"),
                "plain_ms": cuda_ms(lambda: cross_attention_plain(
                    q, mk, mv, enc_len), 50),
                "plain": "the twin in float32: the old path's composition",
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library": "none: SDPA takes no bfloat16 K/V beside a "
                           "float32 query"}
            if dtype == torch.float32:
                lib_q = q.reshape(s, beam, heads, dk).transpose(1, 2)
                lib_mask = ~hidden.transpose(2, 3)       # (S, 1, 1, T)

                def library():
                    F.scaled_dot_product_attention(lib_q, mk, mv,
                                                   attn_mask=lib_mask)

                ms, lib_ms, k_all, l_all = timed_pairs(kernel, library,
                                                       reps=100)
                row |= {"ms": ms, "ms_runs": k_all, "library_ms": lib_ms,
                        "library_ms_runs": l_all,
                        "library": "F.scaled_dot_product_attention, the "
                                   "enc_len boolean mask (timed only; the "
                                   "port never calls it)"}
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def flagship_model(dev, seed: int, encoder_type: str = "transformer",
                   precision: str = "float32", biases=(4.0, 10.0)):
    """The flagship with random weights from `seed`. "serving_default"
    builds the serving model of the JAX package's bench.py (_build_model):
    decoder cache, CTC log-prob ring and emitted-frame ring stored in
    bfloat16 and the matmul weights cast to bfloat16; "int8" then quantises
    the encoder's linears and "int8_all" every eligible linear to int8.
    "ctc_ring_bf16" is the float32 model with only the CTC log-prob ring in
    bfloat16 (what kernel B reads). `biases` are added to the EOS logit of
    the decoder and the blank logit of the CTC head."""
    import torch

    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel

    if precision not in PRECISIONS:
        fail(f"unknown precision {precision!r}")
    cfg = flagship_config(encoder_type=encoder_type)
    if precision == "ctc_ring_bf16":
        cfg = cfg.replace(ctc_ring_dtype="bfloat16")
    elif precision != "float32":
        cfg = cfg.replace(cache_dtype="bfloat16", ctc_ring_dtype="bfloat16",
                          enc_ring_dtype="bfloat16")
    model = ASRModel.random_init(cfg, seed=seed, device=dev)
    # Emission profile of a trained model: by default EOS +4 on the decoder
    # output, blank +10 on the CTC head, so finals stop after a few steps.
    with torch.no_grad():
        model.params["decoder"]["output_layer"]["bias"][cfg.eos_id] += \
            biases[0]
        model.params["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += biases[1]
    if precision in ("serving_default", "int8", "int8_all"):
        from speechcatcher_tpu_torch.ops.layers import (
            cast_params,
            quantize_params_int8,
        )

        model.params = cast_params(model.params)
        if precision != "serving_default":
            model.params = quantize_params_int8(
                model.params,
                scope=None if precision == "int8_all" else ("encoder",))
    return model


def decode_chunked(s2t, audio, rate: int):
    """Stream audio in CHUNK_SECONDS chunks; (results, nbest, latencies)."""
    import torch

    step = int(CHUNK_SECONDS * rate)
    chunks = [audio[i:i + step] for i in range(0, len(audio), step)]
    lat = []
    results = []
    nbest = None
    for i, chunk in enumerate(chunks):
        final = i == len(chunks) - 1
        t0 = time.perf_counter()
        if final:
            # Read the beam before the session resets itself.
            s2t.feed(chunk, is_final=True)
            nbest = s2t.beam_search.nbest_hypotheses()
            results = s2t._assemble(is_final=True)
            s2t.reset()
        else:
            s2t(chunk)
        if s2t.model.device.type == "cuda":
            torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return results, nbest, lat


def check_launches(phase: str, counters, launches: dict, zero=()) -> None:
    """Emit a path's launch counts; fail unless every kernel of the path
    (all but those in `zero`) launched and none of `zero` did."""
    emit({"phase": phase + "_launches", **launches})
    for c in counters:
        count = launches[c.__name__]
        if c in zero and count:
            fail(f"kernel {c.__name__} was launched {count} times on the "
                 f"{phase}, which must not run it")
        if c not in zero and count <= 0:
            fail(f"kernel {c.__name__} was not launched on the {phase}")


def main_path(dev, counters, model, phase: str = "main_path", zero=(),
              dtype: str = "float32", lengths=(4.0, 5.0, 6.0)):
    """Flagship utterances of 4, 5 and 6 s in 0.5 s chunks through a
    session in the precision mode `dtype` (which changes `model`)."""
    import numpy as np
    import torch

    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    s2t = Speech2TextStreaming(model=model, beam_size=5, device=dev,
                               dtype=dtype)
    if dtype != "float32":
        ctc_lo = model.params["ctc"]["ctc_lo"]["weight"].dtype
        w_1 = model.params["encoder"]["layers"][0]["feed_forward"]["w_1"][
            "weight"].dtype
        want = {"bfloat16": (torch.bfloat16, torch.bfloat16),
                "int8": (torch.bfloat16, torch.int8),
                "int8-all": (torch.int8, torch.int8)}[dtype]
        if (ctc_lo, w_1) != want or model.cfg.cache_dtype != "bfloat16":
            fail(f"{phase}: dtype={dtype!r} left weights {ctc_lo}, {w_1}")
    rate = model.cfg.sample_rate
    for c in counters:
        c.launches = 0
    rows = []
    for i, seconds in enumerate(lengths):
        audio = synth_audio(seconds, seed=100 + i, rate=rate)
        t0 = time.perf_counter()
        results, nbest, lat = decode_chunked(s2t, audio, rate)
        wall = time.perf_counter() - t0
        best_score = nbest[0][2]
        if not math.isfinite(best_score) or len(nbest[0][0]) < 2:
            fail(f"utterance {i}: bad best hypothesis {nbest[0]}")
        rows.append({
            "phase": phase, "dtype": dtype, "utterance": i,
            "tokens": len(results[0][2]) if results else 0,
            "hyp_len": int(len(nbest[0][0])),
            "score": best_score, "audio_s": seconds, "wall_s": wall,
            "rtf": wall / seconds, "chunks": len(lat),
            "p50_chunk_ms": float(np.median(lat)) * 1e3,
            "max_chunk_ms": float(np.max(lat)) * 1e3,
        })
    launches = {c.__name__: c.launches for c in counters}
    for row in rows:
        emit(row)
    check_launches(phase, counters, launches, zero)
    return launches


def fixture_replay(dev, path=FIXTURE, encoder_type: str = "transformer",
                   tol: float = 1e-4):
    """A fixture blessed by the JAX session, replayed on the card: tokens
    and positions exact, score within rel. `tol`. Reports the replay's
    launches of the CTC recursion kernel (one per beam step)."""
    from speechcatcher_tpu_torch.config import ModelConfig, flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
        ctc_forward_recursion,
    )
    from speechcatcher_tpu_torch.params import params_checksum, random_params
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    fx = json.loads(path.read_text())
    cfg = ModelConfig(**fx["cfg"])
    if cfg != flagship_config(encoder_type=encoder_type):
        fail(f"{path.name}: config is not flagship_config("
             f"encoder_type={encoder_type!r})")
    tree = random_params(cfg, fx["seed"])
    if params_checksum(tree) != fx["weights_sha256"]:
        fail("fixture weights checksum mismatch")
    tree["decoder"]["output_layer"]["bias"][cfg.eos_id] += fx["eos_bias"]
    tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += fx["blank_bias"]
    model = ASRModel.from_numpy(cfg, tree, device=dev)
    s2t = Speech2TextStreaming(model=model, beam_size=fx["beam_size"],
                               device=dev)
    audio = synth_audio(fx["audio_seconds"], fx["audio_seed"],
                        rate=cfg.sample_rate)
    launched = ctc_forward_recursion.launches
    t0 = time.perf_counter()
    _, nbest, _ = decode_chunked(s2t, audio, cfg.sample_rate)
    wall = time.perf_counter() - t0
    launched = ctc_forward_recursion.launches - launched
    loop = s2t.beam_search.loop
    FIXTURE_STEPS[path.name] = (encoder_type, dict(loop.step_counts))
    yseq, xpos, score = nbest[0]
    tokens_ok = [int(x) for x in yseq] == fx["yseq"]
    xpos_ok = [int(x) for x in xpos] == fx["xpos"]
    rel = abs(score - fx["score"]) / max(1.0, abs(fx["score"]))
    emit({"phase": "fixture", "fixture": path.name,
          "tokens_equal": tokens_ok, "xpos_equal": xpos_ok, "score": score,
          "score_ref": fx["score"], "score_rel_err": rel, "tol": tol,
          "hyp_len": len(yseq), "wall_s": wall,
          "ctc_forward_recursion_launches": launched}
         | steps_per_block([loop]))
    if not (tokens_ok and xpos_ok and rel <= tol):
        fail(f"{path.name}: replay disagrees with the JAX-blessed decode")
    if launched < len(yseq) - 2:
        fail(f"{path.name}: {launched} launches of the CTC recursion kernel "
             f"for {len(yseq)} tokens")


def small_reference(dev, encoder_type: str = "transformer"):
    """A decode with many tokens, at the real block geometry and small
    widths: the card (kernels) against the port's plain path on the CPU.
    For the transformer, seed 1's smallest gap between the two best
    expansions is 4.3e-3 on the CPU, far above float noise."""
    import numpy as np
    import torch

    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.params import random_params
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    cfg = flagship_config(encoder_dim=64, encoder_heads=4, encoder_layers=4,
                          decoder_dim=64, decoder_heads=4, decoder_layers=2,
                          encoder_linear_units=256, decoder_linear_units=256,
                          encoder_type=encoder_type)
    tree = random_params(cfg, 1)
    audio = synth_audio(6.0, 201, rate=cfg.sample_rate)
    best = {}
    for d in (torch.device("cpu"), dev):
        model = ASRModel.from_numpy(cfg, tree, device=d)
        s2t = Speech2TextStreaming(model=model, beam_size=5, device=d)
        best[d.type] = decode_chunked(s2t, audio, cfg.sample_rate)[1][0]
    (cy, cx, cs), (gy, gx, gs) = best["cpu"], best["cuda"]
    rel = abs(gs - cs) / max(1.0, abs(cs))
    same = np.array_equal(cy, gy) and np.array_equal(cx, gx)
    emit({"phase": "small_reference", "encoder_type": encoder_type,
          "hyp_len": len(gy),
          "tokens_equal": bool(same), "score": gs, "score_cpu": cs,
          "score_rel_err": rel})
    if not (same and rel <= 1e-4):
        fail("the card's decode differs from the CPU reference")


# ---------------------------------------------------------------------------
# Batched engine
# ---------------------------------------------------------------------------

def engine_streams(n: int, seconds, starts, int16_every: int, seed0: int,
                   single=(), rate: int = 16000, mulaw: bool = False):
    """Synthetic streams for drive_engine: audio (float32; the quantised
    values for int16 and mu-law streams, so that a session fed the float32
    audio hears what the engine decodes from the wire), first tick, wire
    format and whether the final goes through finalize() instead of
    finalize_batch. With `mulaw` every stream comes as mu-law bytes."""
    import numpy as np

    from speechcatcher_tpu_torch.serve.wire import (
        mulaw_decode,
        mulaw_encode_f32,
    )
    from speechcatcher_tpu_torch.synth import synth_audio

    streams = []
    for k in range(n):
        audio = synth_audio(seconds[k], seed0 + k, rate=rate)
        wire = "int16" if int16_every and k % int16_every == 0 else "float32"
        if mulaw:
            wire = "mulaw"
            audio = mulaw_decode(mulaw_encode_f32(audio))
        elif wire == "int16":
            audio = (np.round(np.clip(audio, -1.0, 1.0) * 32767.0)
                     .astype(np.int16).astype(np.float32) / 32767.0)
        streams.append({"audio": audio, "start": int(starts[k]),
                        "wire": wire, "single": k in single})
    return streams


def drive_engine(engine, streams, chunk: int, sync=None):
    """Serve the streams through a StreamingEngine (the JAX package's or
    the port's; they share the API). Stream k takes a free slot from tick
    streams[k]["start"] on, in order; every tick feeds one chunk to each
    stream with more than a chunk left; a stream with at most a chunk left
    is finalized after that tick with its tail, together with the others
    that end there (finalize_batch), or alone (finalize) where "single" is
    set. Returns (finals {k: (yseq, xpos, score)}, tick seconds, slots
    used per stream)."""
    import numpy as np

    from speechcatcher_tpu_torch.serve.wire import encode_chunk

    waiting = list(range(len(streams)))
    live = {}          # stream -> [slot, samples fed]
    finals, tick_s, slot_of = {}, [], {}
    t = 0
    while waiting or live:
        while waiting and streams[waiting[0]]["start"] <= t:
            s = engine.acquire_slot()
            if s is None:
                break
            k = waiting.pop(0)
            live[k] = [s, 0]
            slot_of[k] = s
        batch = {}
        for k, (s, pos) in live.items():
            a = streams[k]["audio"]
            if len(a) - pos > chunk:
                batch[s] = encode_chunk(a[pos:pos + chunk],
                                        streams[k]["wire"])
                live[k][1] += chunk
        if batch:
            t0 = time.perf_counter()
            engine.tick(batch)
            if sync is not None:
                sync()
            tick_s.append(time.perf_counter() - t0)
        done = [k for k, (s, pos) in live.items()
                if len(streams[k]["audio"]) - pos <= chunk]

        def tail(k):
            return encode_chunk(streams[k]["audio"][live[k][1]:],
                                streams[k]["wire"])

        res = engine.finalize_batch({live[k][0]: tail(k) for k in done
                                     if not streams[k]["single"]})
        for k in done:
            if streams[k]["single"]:
                res[live[k][0]] = engine.finalize(live[k][0], tail(k))
            if live[k][0] not in res:
                fail(f"stream {k} was not finalized")
            yseq, xpos, score = res[live[k][0]]
            finals[k] = (np.asarray(yseq).astype(np.int64),
                         np.asarray(xpos).astype(np.int64), float(score))
            del live[k]
        t += 1
    return finals, tick_s, slot_of


def single_stream_final(s2t, audio, chunk: int):
    """The port's Speech2TextStreaming over the engine's chunking: full
    chunks, then the tail (at most one chunk) as the final chunk."""
    n_full = (len(audio) - 1) // chunk
    for i in range(n_full):
        s2t(audio[i * chunk:(i + 1) * chunk])
    s2t.beam_search.process_block(
        s2t.apply_frontend(audio[n_full * chunk:], s2t.frontend_states,
                           True)[0], is_final=True)
    yseq, xpos, score = s2t.beam_search.best_hypothesis()
    s2t.reset()
    return yseq.astype("int64"), xpos.astype("int64"), float(score)


def _sync(dev):
    import torch

    return torch.cuda.synchronize if dev.type == "cuda" else None


def engine_path(dev, counters, model, chunk: int = 8192,
                phase: str = "engine_path", zero=(), mulaw: bool = False,
                score_tol: float = 1e-4, mesh=None, reference=None,
                finals_out=None):
    """Ten streams of 3-6 s through the port's StreamingEngine at
    n_slots=8, staggered, every other one int16 (or all of them mu-law);
    the last two wait for freed slots; two finals go through finalize().
    Each final must equal the port's single-stream session on the same
    model, audio and chunking: tokens and positions exactly, the score
    within rel. `score_tol`. With a `mesh` the engine is sharded over it
    (``shard_engine``) and each final must equal `reference`, the unsharded
    engine's finals (which equal the session's), the same way. The finals
    go into `finals_out`."""
    import numpy as np

    from speechcatcher_tpu_torch.parallel.serve_sharding import shard_engine
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

    streams = engine_path_streams(model.cfg.sample_rate, mulaw)
    n = len(streams)
    seconds = [len(st["audio"]) / model.cfg.sample_rate for st in streams]
    engine = StreamingEngine(model, n_slots=8, beam_size=5,
                             chunk_samples=chunk, device=dev)
    if engine.MAXB != ENGINE_MAXB:
        fail(f"engine MAXB is {engine.MAXB}; kernels A and E were checked "
             f"at {ENGINE_MAXB} blocks per slot")
    if mesh is not None:
        engine = shard_engine(engine, mesh)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    finals, tick_s, slot_of = drive_engine(engine, streams, chunk,
                                           sync=_sync(dev))
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    reused = len(slot_of) - len(set(slot_of.values()))
    emit({"phase": phase, "n_slots": 8, "streams": n,
          "replicas": [r.S for r in getattr(engine, "replicas", [engine])],
          "slots_reused": reused, "ticks": len(tick_s),
          "p50_tick_ms": float(np.median(tick_s)) * 1e3,
          "max_tick_ms": float(np.max(tick_s)) * 1e3,
          "chunk_ms": chunk / model.cfg.sample_rate * 1e3,
          "wall_s": wall, "audio_s": float(sum(seconds)),
          "hbm_bytes_per_stream": engine.hbm_bytes_per_stream()["total"],
          "graph_bytes_per_stream":
              engine.graph_bytes_per_stream()["total"]})
    check_launches(phase, counters, launches, zero)
    if reused < 2:
        fail(f"only {reused} streams reused a freed slot")
    if finals_out is not None:
        finals_out.update(finals)

    s2t = (Speech2TextStreaming(model=model, beam_size=5, device=dev)
           if reference is None else None)
    what = "single-stream session" if reference is None else "unsharded engine"
    worst = 0.0
    for k, st in enumerate(streams):
        ry, rx, rs = (single_stream_final(s2t, st["audio"], chunk)
                      if reference is None else reference[k])
        ey, ex, es = finals[k]
        rel = abs(es - rs) / max(1.0, abs(rs))
        worst = max(worst, rel)
        if not (np.array_equal(ey, ry) and np.array_equal(ex, rx)
                and rel <= score_tol):
            fail(f"{phase} stream {k} ({st['wire']}, "
                 f"{'finalize' if st['single'] else 'finalize_batch'}) "
                 f"differs from the {what}: "
                 f"{ey.tolist()} / {ry.tolist()}, score {es} / {rs}")
    against = "_vs_single_stream" if reference is None else "_vs_unsharded"
    emit({"phase": phase + against, "streams": n,
          "tokens_equal": True, "xpos_equal": True,
          "max_score_rel_err": worst, "score_tol": score_tol,
          "hyp_lens": [len(finals[k][0]) for k in range(n)]})
    return launches


# ---------------------------------------------------------------------------
# Precision modes
# ---------------------------------------------------------------------------

def check_gemm(dev, cfg):
    """The bfloat16 GEMM of ``linear`` at the FFN's (rows, 512) x (512,
    2048): which route the card takes (one library GEMM with a float32
    result, or the widened float32 product), its result against the widened
    product of the same rounded operands (products of two bfloat16 are exact
    in float32, so only the order of the sum differs: 1e-5 of the largest
    output), and its time beside the float32 GEMM's, in turns. Rows: one and
    two windows of a session step, the engine's 8 slots x ENGINE_MAXB."""
    import numpy as np
    import torch

    from speechcatcher_tpu_torch.ops import layers

    route = layers.gemm_route(dev)
    d, hidden = cfg.encoder_dim, cfg.encoder_linear_units
    w = cfg.block_size + 2
    rng = np.random.default_rng(11)
    weight = torch.from_numpy(
        rng.standard_normal((hidden, d), dtype=np.float32)
        / np.float32(math.sqrt(d))).to(dev)
    bias = torch.from_numpy(rng.standard_normal(hidden, dtype=np.float32)
                            ).to(dev)
    p32 = {"weight": weight, "bias": bias}
    p16 = layers.cast_params({"lin": p32})["lin"]
    p8 = layers.quantize_params_int8({"lin": p16}, scope=None)["lin"]
    if (p16["weight"].dtype, p8["weight"].dtype) != (torch.bfloat16,
                                                     torch.int8):
        fail("cast_params / quantize_params_int8 left the weight dtype")
    rows_out = []
    for rows in (w, 2 * w, 8 * ENGINE_MAXB * w):
        x = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)
                             ).to(dev)
        xr = x.bfloat16().float()
        errs = {}
        for name, p, wide in (
                ("bfloat16", p16, p16["weight"].float()),
                ("int8", p8, p8["weight"].float())):
            got = layers.linear(p, x)
            ref = torch.matmul(xr, wide.t())
            if name == "int8":
                ref = ref * p8["weight_scale"]
            ref = ref + bias
            torch.cuda.synchronize()
            if got.dtype != torch.float32:
                fail(f"linear on a {name} weight returned {got.dtype}")
            errs[name] = float((got - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max())
            if not errs[name] <= tol:
                fail(f"linear on a {name} weight ({route}) differs from the "
                     f"widened product at {rows} rows: {errs[name]} > {tol}")
        ms16, ms32, _, _ = timed_pairs(lambda: layers.linear(p16, x),
                                       lambda: layers.linear(p32, x))
        rows_out.append({
            "rows": rows, "max_abs_err": errs,
            "linear_bf16_ms": ms16, "linear_f32_ms": ms32,
            "linear_int8_ms": cuda_ms(lambda: layers.linear(p8, x), 200),
            "linear_bf16_device_us": profiled_device_us(
                lambda: layers.linear(p16, x)),
            "linear_f32_device_us": profiled_device_us(
                lambda: layers.linear(p32, x)),
            "linear_int8_device_us": profiled_device_us(
                lambda: layers.linear(p8, x)),
        })
    emit({"phase": "gemm", "route": route,
          "mm_out_dtype_capability": layers.MM_OUT_DTYPE,
          "shape": [d, hidden], "tol": "1e-5 of the largest output",
          "by_rows": rows_out})
    return route


def profiled_device_us(fn, reps: int = 50):
    """Device time of all kernels of one call of fn under torch.profiler
    (None when three traces came back without device rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.self_device_time_total > 0)
        if total:
            return total / reps
    return None


def precision_fixture_replay(dev):
    """The precision fixture blessed by the JAX package, replayed on the
    card: the session in each blessed ``dtype=`` mode and the engine in the
    serving default, tokens and positions exact, scores within rel.
    BF16_STORAGE_SCORE_TOL.
    The sessions replay through the graphs; the beam-step trace (the gap
    between the two best candidates of every step, read on the host) comes
    from a second, eager decode. A session that disagrees prints the first
    beam step whose best candidate differs from the blessed trace, with the
    gap there on either side."""
    import speechcatcher_tpu_torch.decode.beam_search as bs
    from speechcatcher_tpu_torch.config import ModelConfig, flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.ops.layers import cast_params
    from speechcatcher_tpu_torch.params import params_checksum, random_params
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    fx = json.loads(PRECISION_FIXTURE.read_text())
    cfg = ModelConfig(**fx["cfg"])
    if cfg != flagship_config():
        fail("precision fixture config is not flagship_config()")
    tree = random_params(cfg, fx["seed"])
    if params_checksum(tree) != fx["weights_sha256"]:
        fail("precision fixture weights checksum mismatch")
    tree["decoder"]["output_layer"]["bias"][cfg.eos_id] += fx["eos_bias"]
    tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += fx["blank_bias"]
    audio = synth_audio(fx["audio_seconds"], fx["audio_seed"],
                        rate=cfg.sample_rate)
    beam = fx["beam_size"]
    for dtype, ref in fx["sessions"].items():
        model = ASRModel.from_numpy(cfg, tree, device=dev)
        s2t = Speech2TextStreaming(model=model, beam_size=beam, device=dev,
                                   dtype=dtype)
        _, nbest, _ = decode_chunked(s2t, audio, cfg.sample_rate)
        steps = []
        with beam_step_trace(bs, beam, steps):
            decode_chunked(make_eager(s2t), audio, cfg.sample_rate)
        yseq, xpos, score = nbest[0]
        same = ([int(x) for x in yseq] == ref["yseq"]
                and [int(x) for x in xpos] == ref["xpos"])
        rel = abs(score - ref["score"]) / max(1.0, abs(ref["score"]))
        row = {"phase": "precision_fixture", "dtype": dtype,
               "tokens_equal": same, "score": score,
               "score_ref": ref["score"], "score_rel_err": rel,
               "score_tol": BF16_STORAGE_SCORE_TOL,
               "hyp_len": len(yseq), "beam_steps": len(steps),
               "min_gap": min(g for _, g in steps)}
        if not same:
            for i, ((best, gap), (rbest, rgap)) in enumerate(
                    zip(steps, ref["steps"])):
                if best != rbest:
                    row["first_differing_step"] = {
                        "step": i, "best": best, "best_ref": rbest,
                        "gap": gap, "gap_ref": rgap}
                    break
        emit(row)
        if not (same and rel <= BF16_STORAGE_SCORE_TOL):
            fail(f"precision fixture, dtype={dtype!r}: the replay disagrees "
                 "with the JAX-blessed decode")
    ex = fx["engine"]
    ecfg = cfg.replace(cache_dtype="bfloat16", ctc_ring_dtype="bfloat16",
                       enc_ring_dtype="bfloat16")
    model = ASRModel.from_numpy(ecfg, tree, device=dev)
    model.params = cast_params(model.params)
    streams = engine_streams(len(ex["streams"]),
                             [st["seconds"] for st in ex["streams"]],
                             [st["start"] for st in ex["streams"]], 0,
                             ex["audio_seed0"], rate=cfg.sample_rate,
                             mulaw=True)
    engine = StreamingEngine(model, n_slots=ex["n_slots"], beam_size=beam,
                             chunk_samples=ex["chunk_samples"], device=dev)
    finals, _, _ = drive_engine(engine, streams, ex["chunk_samples"],
                                sync=_sync(dev))
    worst = 0.0
    for k, ref in enumerate(ex["finals"]):
        yseq, xpos, score = finals[k]
        rel = abs(score - ref["score"]) / max(1.0, abs(ref["score"]))
        worst = max(worst, rel)
        if not (yseq.tolist() == ref["yseq"] and xpos.tolist() == ref["xpos"]
                and rel <= BF16_STORAGE_SCORE_TOL):
            fail(f"precision fixture, engine stream {k} disagrees with the "
                 f"JAX engine: {yseq.tolist()} / {ref['yseq']}, score "
                 f"{score} / {ref['score']}")
    emit({"phase": "precision_fixture", "engine": "serving_default",
          "streams": len(ex["finals"]), "tokens_equal": True,
          "max_score_rel_err": worst, "score_tol": BF16_STORAGE_SCORE_TOL,
          "hyp_lens": [len(f["yseq"]) for f in ex["finals"]]})


class beam_step_trace:
    """While active, appends (index of the best candidate, its lead over
    the second) of every beam step's global top-B selection to `steps`."""

    def __init__(self, beam_search_module, beam: int, steps: list):
        self.bs, self.beam, self.steps = beam_search_module, beam, steps

    def __enter__(self):
        self.topk = self.bs._topk_stable

        def spy(x, k):
            vals, idx = self.topk(x, k)
            if x.shape[-1] == self.beam * self.beam:
                v = vals[0]
                if int((v > self.bs.NEG_INF / 10).sum()) >= 2:
                    self.steps.append((int(idx[0, 0]), float(v[0] - v[1])))
            return vals, idx

        self.bs._topk_stable = spy
        return self

    def __exit__(self, *exc):
        self.bs._topk_stable = self.topk
        return False


def espnet_state_dict(tree, cfg, conv_spelling: str = "conv",
                      out_spelling: str = "out", bn_spelling: str = "norm"):
    """A numpy parameter tree's leaves under ESPnet's checkpoint key names
    (the inverse of ``checkpoint.convert_state_dict``), in either spelling
    of the conv stack (``embed.conv.N`` / ``embed.N``), of the embed output
    (``out`` / ``out.0``) and of the conformer's BatchNorm (``norm`` /
    ``batch_norm``), plus entries the converter drops."""
    import numpy as np

    from speechcatcher_tpu_torch.params import tree_leaves

    def flat(prefix, sub, out, rename=lambda k: k):
        for path, leaf in tree_leaves(sub):
            keys = [rename(k) for k in path.strip("/").split("/")]
            out[prefix + ".".join(keys)] = leaf

    sd = {}
    embed = tree["encoder"]["embed"]
    if cfg.input_layer == "linear":
        flat("encoder.embed.0.", embed["out"], sd)
        flat("encoder.embed.1.", embed["norm"], sd)
    else:
        stack = ("encoder.embed.conv." if conv_spelling == "conv"
                 else "encoder.embed.")
        for i, conv in enumerate(embed["convs"]):
            flat(f"{stack}{2 * i}.", conv, sd)
        flat(f"encoder.embed.{out_spelling}.", embed["out"], sd)
    for part, name in (("encoder", "encoders"), ("decoder", "decoders")):
        stacked = {}
        flat("", tree[part]["layers"], stacked,
             rename=lambda k: bn_spelling if k == "batch_norm" else k)
        for key, leaf in stacked.items():
            for i in range(leaf.shape[0]):
                sd[f"{part}.{name}.{i}.{key}"] = leaf[i]
        flat(f"{part}.after_norm.", tree[part]["after_norm"], sd)
    sd["decoder.embed.0.weight"] = tree["decoder"]["embed"]["weight"]
    flat("decoder.output_layer.", tree["decoder"]["output_layer"], sd)
    flat("ctc.ctc_lo.", tree["ctc"]["ctc_lo"], sd)
    sd["frontend.logmel.melmat"] = np.zeros((4, 3), np.float32)
    sd["normalize.mean"] = np.zeros(cfg.n_mels, np.float32)
    if cfg.encoder_type == "conformer":
        sd[f"encoder.encoders.0.conv_module.{bn_spelling}"
           ".num_batches_tracked"] = np.asarray(7, np.int64)
    return sd


def write_model_dir(root: Path, cfg, tree, config=None,
                    wrap: str = "model") -> Path:
    """An ESPnet-layout package under `root` from a numpy parameter tree:
    ``exp/<run>/valid.acc.ave_6best.pth`` (``{"model": state_dict}``, or
    under "state_dict", or bare), ``exp/asr_stats_raw/train/
    feats_stats.npz`` in the sum / sum_square / count form and, when
    `config` (an ESPnet config dict) is given, ``exp/<run>/config.yaml``.
    Returns the run directory, which is the model directory."""
    import numpy as np
    import torch

    run = root / "exp" / "asr_train_asr_streaming"
    run.mkdir(parents=True)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in espnet_state_dict(tree, cfg).items()}
    torch.save({"model": sd} if wrap == "model" else
               {"state_dict": sd} if wrap == "state_dict" else sd,
               run / "valid.acc.ave_6best.pth")
    if config is not None:
        import yaml

        with open(run / "config.yaml", "w") as f:
            yaml.safe_dump(config, f)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((1000, cfg.n_mels)) * 2.0 + 1.0
    stats = root / "exp" / "asr_stats_raw" / "train"
    stats.mkdir(parents=True)
    np.savez(stats / "feats_stats.npz", sum=feats.sum(0),
             sum_square=(feats ** 2).sum(0),
             count=np.asarray(feats.shape[0]))
    return run


def model_dir_path(dev, cfg=None):
    """A model directory of `cfg`'s widths (default: the flagship's)
    written from seed 0 without a config.yaml (the architecture is then
    inferred from the checkpoint's shapes over the default config: at the
    flagship's width 4 heads of 128), loaded through
    ``Speech2TextStreaming(model_dir=...)`` and ``create_streaming_
    interface`` on the card: the same decode as the same weights and
    statistics passed as ``model=``."""
    import tempfile

    import numpy as np

    from speechcatcher_tpu_torch.checkpoint import (
        find_stats,
        load_normalization_stats,
    )
    from speechcatcher_tpu_torch.config import ModelConfig, flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.params import random_params
    from speechcatcher_tpu_torch.streaming import (
        Speech2TextStreaming,
        create_streaming_interface,
    )
    from speechcatcher_tpu_torch.synth import synth_audio

    cfg = cfg or flagship_config()
    tree = random_params(cfg, 0)
    tree["decoder"]["output_layer"]["bias"][cfg.eos_id] += 4.0
    tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += 10.0
    audio = synth_audio(5.0, seed=101, rate=cfg.sample_rate)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run = write_model_dir(Path(tmp), cfg, tree)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = Speech2TextStreaming(model_dir=run, beam_size=5, device=dev)
        t_load = time.perf_counter() - t0
        made = create_streaming_interface(run, beam_size=5, device=dev)
        mean, std = load_normalization_stats(find_stats(run))
    lcfg = loaded.cfg
    inferred = ("encoder_dim", "decoder_dim", "encoder_layers",
                "decoder_layers", "vocab_size", "encoder_linear_units",
                "decoder_linear_units")
    if lcfg != ModelConfig(**{k: getattr(cfg, k) for k in inferred}) \
            or loaded.model.device != dev:
        fail(f"model directory: inferred config {lcfg} on "
             f"{loaded.model.device}")
    given = Speech2TextStreaming(
        model=ASRModel.from_numpy(lcfg, tree, device=dev, mean=mean, std=std),
        beam_size=5, device=dev)
    ref = decode_chunked(given, audio, lcfg.sample_rate)[1][0]
    for name, s2t in (("model_dir=", loaded),
                      ("create_streaming_interface", made)):
        yseq, xpos, score = decode_chunked(s2t, audio, lcfg.sample_rate)[1][0]
        if not (np.array_equal(yseq, ref[0]) and np.array_equal(xpos, ref[1])
                and score == ref[2] and len(yseq) >= 2
                and math.isfinite(score)):
            fail(f"model directory: {name} decodes {yseq.tolist()} ({score}), "
                 f"model= decodes {ref[0].tolist()} ({ref[2]})")
    emit({"phase": "model_dir", "tokens_equal": True, "hyp_len": len(ref[0]),
          "score": ref[2], "heads": lcfg.encoder_heads,
          "write_s": t_write, "load_s": t_load})


def precision_turns(dev, models: dict, chunk: int = 8192):
    """Warm RTF of one 6 s utterance and engine tick p50 (8 busy slots, 10
    ticks) of the float32 model and the serving default, taken in turns
    (float32, serving default, serving default, float32) in one run."""
    import numpy as np

    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    rate = models["float32"].cfg.sample_rate
    audio = synth_audio(6.0, seed=102, rate=rate)
    seconds = [(10 * chunk + 3000) / rate] * 8
    streams = engine_streams(8, seconds, [0] * 8, 2, 700, rate=rate)
    sessions = {k: Speech2TextStreaming(model=m, beam_size=5, device=dev)
                for k, m in models.items()}
    for k, m in models.items():            # warm-up
        decode_chunked(sessions[k], audio, rate)
        drive_engine(StreamingEngine(m, n_slots=8, beam_size=5,
                                     chunk_samples=chunk, device=dev),
                     streams, chunk, sync=_sync(dev))
    order = ("float32", "serving_default", "serving_default", "float32")
    rtf = {k: [] for k in models}
    p50 = {k: [] for k in models}
    for k in order:
        t0 = time.perf_counter()
        decode_chunked(sessions[k], audio, rate)
        rtf[k].append((time.perf_counter() - t0) / 6.0)
    for k in order:
        engine = StreamingEngine(models[k], n_slots=8, beam_size=5,
                                 chunk_samples=chunk, device=dev)
        _, tick_s, _ = drive_engine(engine, streams, chunk, sync=_sync(dev))
        p50[k].append(float(np.median(tick_s)) * 1e3)
    emit({"phase": "precision_turns", "order": list(order),
          "warm_rtf": rtf, "engine_p50_tick_ms": p50, "n_slots": 8,
          "audio_s": 6.0})



def engine_load_point(dev, model, n_slots: int = 32, n_ticks: int = 12,
                      chunk: int = 8192):
    """All slots busy for about n_ticks ticks: tick time against the
    chunk's duration (a tick slower than its chunk cannot keep up)."""
    import numpy as np

    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    seconds = [(n_ticks * chunk + 4000 + 37 * k) / model.cfg.sample_rate
               for k in range(n_slots)]
    streams = engine_streams(n_slots, seconds, starts=[0] * n_slots,
                             int16_every=2, seed0=500,
                             rate=model.cfg.sample_rate)
    engine = StreamingEngine(model, n_slots=n_slots, beam_size=5,
                             chunk_samples=chunk, device=dev)
    t0 = time.perf_counter()
    finals, tick_s, _ = drive_engine(engine, streams, chunk, sync=_sync(dev))
    wall = time.perf_counter() - t0
    chunk_ms = chunk / model.cfg.sample_rate * 1e3
    bad = [k for k, (y, _, sc) in finals.items()
           if len(y) < 2 or not math.isfinite(sc)]
    if len(finals) != n_slots or bad:
        fail(f"load point: bad finals for streams {bad}")
    emit({"phase": "engine_load", "n_slots": n_slots, "ticks": len(tick_s),
          "p50_tick_ms": float(np.median(tick_s)) * 1e3,
          "max_tick_ms": float(np.max(tick_s)) * 1e3,
          "chunk_ms": chunk_ms,
          "p50_tick_over_chunk": float(np.median(tick_s)) * 1e3 / chunk_ms,
          "final_batch_s": wall - float(np.sum(tick_s)),
          "hbm_bytes_per_stream": engine.hbm_bytes_per_stream()["total"],
          "graph_bytes_per_stream":
              engine.graph_bytes_per_stream()["total"]})


def engine_fixture_replay(dev):
    """The engine fixture blessed by the JAX engine, replayed on the card."""
    from speechcatcher_tpu_torch.config import ModelConfig, flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.params import params_checksum, random_params
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    fx = json.loads(ENGINE_FIXTURE.read_text())
    cfg = ModelConfig(**fx["cfg"])
    if cfg != flagship_config():
        fail("engine fixture config is not flagship_config()")
    tree = random_params(cfg, fx["seed"])
    if params_checksum(tree) != fx["weights_sha256"]:
        fail("engine fixture weights checksum mismatch")
    tree["decoder"]["output_layer"]["bias"][cfg.eos_id] += fx["eos_bias"]
    tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += fx["blank_bias"]
    model = ASRModel.from_numpy(cfg, tree, device=dev)
    sp = fx["streams"]
    streams = engine_streams(len(sp), [s["seconds"] for s in sp],
                             [s["start"] for s in sp], fx["int16_every"],
                             fx["audio_seed0"], rate=cfg.sample_rate)
    engine = StreamingEngine(model, n_slots=fx["n_slots"],
                             beam_size=fx["beam_size"],
                             chunk_samples=fx["chunk_samples"], device=dev)
    finals, _, _ = drive_engine(engine, streams, fx["chunk_samples"],
                                sync=_sync(dev))
    worst = 0.0
    for k, ref in enumerate(fx["finals"]):
        yseq, xpos, score = finals[k]
        rel = abs(score - ref["score"]) / max(1.0, abs(ref["score"]))
        worst = max(worst, rel)
        if not (yseq.tolist() == ref["yseq"] and xpos.tolist() == ref["xpos"]
                and rel <= 1e-4):
            fail(f"engine fixture stream {k} disagrees with the JAX engine: "
                 f"{yseq.tolist()} / {ref['yseq']}")
    emit({"phase": "engine_fixture", "streams": len(sp), "tokens_equal": True,
          "xpos_equal": True, "max_score_rel_err": worst,
          "hyp_lens": [len(f["yseq"]) for f in fx["finals"]]})


def profile_engine(dev, precision: str = "float32"):
    """torch.profiler over warm engine ticks at S=8: device time by kernel
    and the device's idle share of the ticks' wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    model = flagship_model(dev, seed=0, precision=precision)
    chunk = 8192
    seconds = [(10 * chunk + 3000) / model.cfg.sample_rate] * 8
    streams = engine_streams(8, seconds, [0] * 8, 2, 700,
                             rate=model.cfg.sample_rate)
    engine = StreamingEngine(model, n_slots=8, beam_size=5,
                             chunk_samples=chunk, device=dev)
    drive_engine(engine, streams, chunk, sync=_sync(dev))  # warm-up
    engine = StreamingEngine(model, n_slots=8, beam_size=5,
                             chunk_samples=chunk, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, tick_s, _ = drive_engine(engine, streams, chunk, sync=_sync(dev))
        wall = time.perf_counter() - t0
    report_profile(prof, {"phase": "profile_engine", "precision": precision,
                          "n_slots": 8, "ticks": len(tick_s),
                          "tick_wall_ms": sum(tick_s) * 1e3}, wall)


def report_profile(prof, head: dict, wall: float):
    """Emit device busy time, idle share and the largest kernels of a
    torch.profiler run (device events only: a CPU op's row repeats its
    kernels' time)."""
    import torch

    averages = prof.key_averages()
    # A range's row on the device timeline repeats its kernels' time.
    rows = [e for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: -e.self_device_time_total)
    # GEMM and convolution kernels by name (cuBLAS, CUTLASS, cuDNN's
    # implicit GEMM; "nvjet" are cuBLAS's Hopper kernels).
    gemm_names = ("gemm", "gemv", "cutlass", "cublas", "nvjet")
    gemm_us = sum(e.self_device_time_total for e in rows
                  if any(k in e.key.lower() for k in gemm_names))
    emit(head | {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
                 "device_idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
                 "device_kernels": sum(e.count for e in rows),
                 "gemm_ms": gemm_us / 1e3, "gemm_share": gemm_us / busy_us})
    ours = ("block_attention_kernel", "rel_block_attention_kernel",
            "ctc_forward_recursion_kernel", "ring_append_cols_kernel",
            "ring_append_rows_kernel")
    for i, e in enumerate(rows):
        if i >= 12 and not any(k in e.key for k in ours):
            continue
        emit({"phase": head["phase"] + "_kernel", "name": e.key[:90],
              "count": e.count, "device_ms": e.self_device_time_total / 1e3,
              "share": e.self_device_time_total / busy_us})
    # The host side: the PyTorch operators that take most host time.
    ops = [e for e in averages
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    ops.sort(key=lambda e: -e.self_cpu_time_total)
    for e in ops[:10]:
        emit({"phase": head["phase"] + "_host_op", "name": e.key,
              "count": e.count, "self_host_ms": e.self_cpu_time_total / 1e3,
              "share_of_wall": e.self_cpu_time_total / 1e3 / (wall * 1e3)})


def profile_utterance(dev, encoder_type: str = "transformer",
                      precision: str = "float32"):
    """torch.profiler over one warm 6 s utterance of the main path: device
    busy time by kernel and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    model = flagship_model(dev, seed=0, encoder_type=encoder_type,
                           precision=precision)
    s2t = Speech2TextStreaming(model=model, beam_size=5, device=dev)
    audio = synth_audio(6.0, seed=102, rate=model.cfg.sample_rate)
    decode_chunked(s2t, audio, model.cfg.sample_rate)  # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_chunked(s2t, audio, model.cfg.sample_rate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, {"phase": "profile", "encoder_type": encoder_type,
                          "precision": precision, "audio_s": 6.0}, wall)


# ---------------------------------------------------------------------------
# The app and serving layer
# ---------------------------------------------------------------------------

class ErrorRecords(logging.Handler):
    """Counts the ERROR records logged anywhere while it is attached: the
    serving layer logs every exception it catches to keep serving."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(f"{record.name}: {record.getMessage()}")

    def __enter__(self):
        logging.getLogger().addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger().removeHandler(self)


def long_recording(seconds: float, rate: int, seed: int = 820):
    """int16 PCM of `seconds`: speech-like stretches of 8-12 s
    (``synth_audio``) between pauses of 0.5-1 s of faint noise. Seed 820
    at 70 s gives one energy cut before the last 10 s (at 54.3 s)."""
    import numpy as np

    from speechcatcher_tpu_torch.synth import synth_audio

    rng = np.random.default_rng(seed)
    parts, n = [], 0
    while n < seconds * rate:
        talk = synth_audio(float(rng.uniform(8.0, 12.0)), seed + len(parts),
                           rate=rate)
        pause = 0.003 * rng.standard_normal(int(rng.uniform(0.5, 1.0) * rate))
        parts += [talk, pause.astype(np.float32)]
        n += len(talk) + len(pause)
    audio = np.concatenate(parts)[:int(seconds * rate)]
    return (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16)


def recognize_path(dev, counters, model, smi: str) -> dict:
    """``recognize_file`` on a 70 s WAV, the flagship from TALKER_SEED
    with TALKER_BIASES, through the session
    (num_processes=1) and the batched engine (4): energy segmentation, the
    split of spans longer than the decode state holds, paragraphs and token
    timestamps; the .txt and .json of both must be equal byte for byte.
    Then the command line in a subprocess, ``python3 -m
    speechcatcher_tpu_torch.recognize -m <dir> -n 4``, on a model directory
    written by write_model_dir from the same weights: its .txt and .json must equal
    ``load_model`` + ``recognize_file`` of the same directory in this
    process (without a config.yaml the directory loads with 4 heads of 128,
    so it is held against itself, not against the 8-head model)."""
    import shutil
    import tempfile

    import torch

    from speechcatcher_tpu_torch.endpointing import segment_speech
    from speechcatcher_tpu_torch.params import random_params
    from speechcatcher_tpu_torch.recognize import (
        _split_overlong_spans,
        load_model,
        recognize_file,
    )
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.utils.audio import write_wav

    cfg = model.cfg
    rate = cfg.sample_rate
    pcm = long_recording(70.0, rate)
    audio_s = len(pcm) / rate
    # The spans recognize() decodes: energy cuts (not in the last 10 s),
    # then the split at 0.9 x the encoder frames the decode state holds.
    cuts = [e / 100.0 for _, e in segment_speech(pcm, rate)
            if e < (audio_s - 10.0) * 100.0]
    frame_sec = cfg.hop_length * cfg.subsample / rate
    spans = _split_overlong_spans(
        list(zip([0.0] + cuts, cuts + [audio_s])),
        0.9 * cfg.max_enc_frames * frame_sec)
    if not cuts or len(spans) <= len(cuts) + 1:
        fail(f"recognize_path: {len(cuts)} energy cuts and {len(spans)} "
             f"spans; the recording must be cut and split")
    s2t = Speech2TextStreaming(model=model, beam_size=5, device=dev)
    by_path, written = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav = tmp / "recording.wav"
        write_wav(wav, pcm, rate)
        for n, phase, zero in (
                (1, "recognize_serial", ("rel_block_attention",)),
                (4, "recognize_batched", ("rel_block_attention",))):
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            res = recognize_file(s2t, str(wav), output_file=str(tmp / phase),
                                 quiet=True, progress=False, num_processes=n)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {c.__name__: c.launches for c in counters}
            written[phase] = ((tmp / f"{phase}.txt").read_text(),
                              (tmp / f"{phase}.json").read_text())
            paragraphs = res["paragraphs"]
            n_tokens = sum(len(p["tokens"]) for p in paragraphs)
            emit({"phase": phase, "num_processes": n, "audio_s": audio_s,
                  "wall_s": wall, "rtf": wall / audio_s,
                  "energy_cuts": len(cuts), "spans": len(spans),
                  "paragraphs": len(paragraphs), "tokens": n_tokens,
                  "nvidia_smi": smi})
            check_launches(phase, counters, launches,
                           [c for c in counters if c.__name__ in zero])
            by_path[phase] = launches
            stamps = [t for p in paragraphs for t in p["token_timestamps"]]
            if (n_tokens < 2 or len(stamps) != n_tokens
                    or stamps != sorted(stamps) or not all(
                        p["start"] <= t <= p["end"] for p in paragraphs
                        for t in p["token_timestamps"])):
                fail(f"{phase}: bad paragraphs {paragraphs}")
        serial, batched = (json.loads(written[p][1])["paragraphs"]
                           for p in ("recognize_serial", "recognize_batched"))
        if written["recognize_serial"] != written["recognize_batched"]:
            diff = [(k, a[k], b[k]) for a, b in zip(serial, batched)
                    for k in a if a[k] != b[k]]
            fail(f"recognize_file: the batched engine's .txt/.json differ "
                 f"from the serial session's ({len(serial)} / "
                 f"{len(batched)} paragraphs): {str(diff)[:3000]}")

        tree = random_params(cfg, TALKER_SEED)
        tree["decoder"]["output_layer"]["bias"][cfg.eos_id] += \
            TALKER_BIASES[0]
        tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += TALKER_BIASES[1]
        run = write_model_dir(tmp / "model", cfg, tree)
        # Both entry points run on the card unless told otherwise.
        on_cpu = {} if dev.type == "cuda" else {"device": "cpu"}
        loaded = load_model(str(run), quiet=True, **on_cpu)
        if loaded.model.device != dev:
            fail(f"load_model put the model on {loaded.model.device}")
        recognize_file(loaded, str(wav), output_file=str(tmp / "load_model"),
                       quiet=True, progress=False, num_processes=4)
        ref = ((tmp / "load_model.txt").read_text(),
               (tmp / "load_model.json").read_text())
        cli_wav = tmp / "cli" / "recording.wav"
        cli_wav.parent.mkdir()
        shutil.copy(wav, cli_wav)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "speechcatcher_tpu_torch.recognize",
             "-m", str(run), "-n", "4", "--quiet", "--no-progress",
             *(["-d", "cpu"] if on_cpu else []), str(cli_wav)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"the command line exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        cli = ((cli_wav.parent / "recording.wav.txt").read_text(),
               (cli_wav.parent / "recording.wav.json").read_text())
        if cli != ref:
            fail("the command line's .txt/.json differ from load_model + "
                 "recognize_file in this process")
        emit({"phase": "recognize_cli", "num_processes": 4,
              "heads": loaded.cfg.encoder_heads, "wall_s": wall,
              "paragraphs": len(json.loads(cli[1])["paragraphs"]),
              "txt_equal": True, "json_equal": True})
    return by_path


def server_path(dev, counters, model, smi: str, phase: str = "server_path",
                mesh=None, reference=None) -> dict:
    """The websocket server as ``speechcatcher_tpu_torch_server`` runs it,
    in this process: ``start_server`` on 127.0.0.1 over a SessionManager
    of an 8-slot engine (int16 wire; endpointing off, so each stream ends
    in one final at eof). Six clients send the Vosk config, 3-6 s of int16
    PCM in 0.25 s messages as fast as they can, then eof, all at once; two
    more hold the other slots, and a ninth is refused as busy. Each final
    must equal ``_assemble_final`` over the single-stream session's final
    on the audio the server staged; the manager must have caught nothing
    and the engine quarantined nothing. With a `mesh` the engine is
    sharded over it (``--dp``); `reference` keeps the session's finals
    between calls."""
    import asyncio
    import socket

    import numpy as np
    import websockets

    from speechcatcher_tpu_torch.parallel.serve_sharding import shard_engine
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.serve.server import (
        Session,
        SessionManager,
        start_server,
    )
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    rate, chunk, n_clients = model.cfg.sample_rate, 8192, 6
    pcms = []
    for k in range(n_clients):
        a = synth_audio(3.0 + 0.55 * k, 900 + k, rate=rate)
        pcm = (np.clip(a, -1.0, 1.0) * 32767).astype(np.int16)
        # A whole number of chunks would leave the final an empty tail.
        pcms.append(pcm[:-1] if len(pcm) % chunk == 0 else pcm)
    engine = StreamingEngine(model, n_slots=8, beam_size=5,
                             chunk_samples=chunk, device=dev)
    if mesh is not None:
        engine = shard_engine(engine, mesh)
    manager = SessionManager(engine, finalize_update_iters=10**6,
                             max_partial_iters=10**6, wire="int16")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    uri = f"ws://127.0.0.1:{port}"

    async def connect():
        for _ in range(400):
            try:
                return await websockets.connect(uri, max_size=None)
            except OSError:
                await asyncio.sleep(0.05)
        fail(f"{phase}: the server did not come up")

    async def open_client():
        ws = await connect()
        await ws.send(json.dumps({"config": {"sample_rate": rate}}))
        reply = await asyncio.wait_for(ws.recv(), 60)
        if json.loads(reply) != {"partial": ""}:
            fail(f"{phase}: config answered with {reply!r}")
        return ws

    async def stream(ws, pcm):
        step = rate // 4
        for i in range(0, len(pcm), step):
            await ws.send(pcm[i:i + step].tobytes())
        await ws.send(json.dumps({"eof": 1}))
        partials = 0
        while True:
            msg = json.loads(await asyncio.wait_for(ws.recv(), 300))
            if "result" in msg:
                await ws.close()
                return msg, partials
            partials += 1

    async def drive():
        server = asyncio.ensure_future(start_server(
            "127.0.0.1", port, manager, tick_interval=0.002))
        try:
            clients = [await open_client() for _ in range(n_clients)]
            holders = [await open_client() for _ in range(8 - n_clients)]
            refused = await connect()
            busy = await asyncio.wait_for(refused.recv(), 60)
            await refused.close()
            t0 = time.perf_counter()
            results = await asyncio.wait_for(asyncio.gather(
                *(stream(ws, pcm) for ws, pcm in zip(clients, pcms))), 600)
            wall = time.perf_counter() - t0
            for ws in holders:
                await ws.close()
        finally:
            server.cancel()
            try:
                await server
            except asyncio.CancelledError:
                pass
        return results, busy, wall

    for c in counters:
        c.launches = 0
    results, busy, wall = asyncio.run(drive())
    launches = {c.__name__: c.launches for c in counters}
    snap = manager.metrics.snapshot()
    emit({"phase": phase, "n_slots": 8, "clients": n_clients,
          "replicas": [r.S for r in getattr(engine, "replicas", [engine])],
          "audio_s": sum(len(p) for p in pcms) / rate, "wall_s": wall,
          "partials": [p for _, p in results], "busy_reply": busy,
          "caught": manager.caught, "quarantined": engine.quarantined,
          "metrics": snap, "nvidia_smi": smi})
    check_launches(phase, counters, launches,
                   [c for c in counters if c.__name__ == "rel_block_attention"])
    if busy != "Server busy, please try again later.":
        fail(f"{phase}: the ninth client got {busy!r}")
    if any(manager.caught.values()) or engine.quarantined:
        fail(f"{phase}: caught {manager.caught}, quarantined "
             f"{engine.quarantined}")
    if snap["total_finals"] != n_clients:
        fail(f"{phase}: {snap['total_finals']} finals")

    # The reference: the session over what the server staged (int16 times
    # the ring's float32 scale) in the engine's chunking.
    if reference is None:
        reference = {}
    if not reference:
        s2t = Speech2TextStreaming(model=model, beam_size=5, device=dev)
        for k, pcm in enumerate(pcms):
            audio = pcm.astype(np.float32) * np.float32(1 / 32767.0)
            reference[k] = single_stream_final(s2t, audio, chunk)[:2]
    words = 0
    for k in range(n_clients):
        sess = Session(slot=None)
        want = manager._assemble_final(sess, *reference[k])
        if sess.slot is not None:
            engine.release_slot(sess.slot)
        got = results[k][0]
        if got != want:
            fail(f"{phase} client {k}: final {got} differs from the "
                 f"single-stream session's {want}")
        words += len(got["result"])
    if words < 2:
        fail(f"{phase}: {words} words in {n_clients} finals")
    emit({"phase": phase + "_vs_single_stream", "clients": n_clients,
          "text_equal": True, "word_times_equal": True, "words": words})
    return launches


def profile_recognize(dev):
    """torch.profiler over one warm ``recognize`` of the 70 s recording of
    recognize_path, batched over 4 streams and then serial: device busy
    time by kernel and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speechcatcher_tpu_torch.recognize import recognize
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

    model = flagship_model(dev, seed=TALKER_SEED, biases=TALKER_BIASES)
    s2t = Speech2TextStreaming(model=model, beam_size=5, device=dev)
    rate = model.cfg.sample_rate
    pcm = long_recording(70.0, rate)
    for n in (4, 1):
        recognize(s2t, pcm, rate, num_processes=n, progress=False,
                  quiet=True)  # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            recognize(s2t, pcm, rate, num_processes=n, progress=False,
                      quiet=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report_profile(prof, {"phase": f"profile_recognize_{n}",
                              "num_processes": n,
                              "audio_s": len(pcm) / rate}, wall)


# ---------------------------------------------------------------------------
# Training and offline greedy decode
# ---------------------------------------------------------------------------

# Windows per layer of encoder_forward_train at batch 8 and the flagship's
# block geometry: the 2 s, 4 s and 32 s sample buckets of BucketBatcher.
TRAIN_WINDOWS = (16, 40, 392)
TRAIN_LR, TRAIN_CLIP = 1e-3, 5.0
# The single-card train paths' losses by encoder type, which the tp ranks
# must reproduce.
TRAIN_LOSSES: dict = {}


def attention_grad(dev, cfg, n_blocks: int, rel: bool) -> dict:
    """Kernel A (rel=False) or E through its autograd Function at a
    training shape, the operands in the main path's form (transposed views
    of (N, W, H*dk) projections that require grad; E's pos a view of a
    projected table, its biases trainable leaves). The forward must equal
    the plain version as the kernel lines require; every gradient of the
    Function's backward must equal plain autograd's on the same card inputs
    (it is the same plain code, so 0.0 is expected). Kernel, SDPA and plain
    forward are timed in three interleaved rounds; the backward (the plain
    recompute and its VJP) by CUDA events."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from speechcatcher_tpu_torch.models.encoder import block_attention_mask
    from speechcatcher_tpu_torch.ops.kernels.block_attention import (
        BlockAttentionFn,
        block_attention,
        block_attention_plain,
        plain_vjp,
    )
    from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
        RelBlockAttentionFn,
        rel_block_attention,
        rel_block_attention_plain,
    )

    kernel, plain, fn = ((rel_block_attention, rel_block_attention_plain,
                          RelBlockAttentionFn) if rel else
                         (block_attention, block_attention_plain,
                          BlockAttentionFn))
    name = kernel.__name__
    n, h, w = n_blocks, cfg.encoder_heads, cfg.block_size + 2
    dk = cfg.encoder_dim // h
    rng = np.random.default_rng(n + (7 if rel else 3))

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev)

    bases = [rand(n, w, h * dk).requires_grad_() for _ in range(3)]
    if rel:
        bases += [rand(1, w, h * dk).requires_grad_(),
                  rand(h, dk).requires_grad_(), rand(h, dk).requires_grad_()]

    def operands():
        views = [b.reshape(n, w, h, dk).transpose(1, 2) for b in bases[:3]]
        if rel:
            views += [bases[3].reshape(1, w, h, dk).transpose(1, 2)[0],
                      bases[4], bases[5]]
        return views

    mask = torch.from_numpy(block_attention_mask(cfg.block_size)).to(dev)
    cot = rand(n, h, w, dk)
    out = kernel(*operands(), mask)
    if type(out.grad_fn).__name__ != fn.__name__ + "Backward":
        fail(f"attention_grad: {name} with trainable operands did not go "
             f"through {fn.__name__} (grad_fn {out.grad_fn})")
    got = torch.autograd.grad(out, bases, cot)
    ref_out = plain(*operands(), mask)
    ref = torch.autograd.grad(ref_out, bases, cot)
    torch.cuda.synchronize()
    fwd_err = float((out - ref_out).detach().abs().max())
    grad_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    if not fwd_err <= 1e-5 or grad_err != 0.0:
        fail(f"attention_grad: {name} at N={n}: forward differs by "
             f"{fwd_err} (tol 1e-5) or a gradient by {grad_err} (expected "
             f"0.0: the backward is plain autograd's own code)")

    args = [x.detach() for x in operands()] + [mask]
    q, k, v = args[:3]
    library, lib_q, lib_mask, extra = library_call(rel, args, mask, dk)

    def kernel_fwd():
        return kernel(*args).transpose(1, 2).reshape(n, w, h * dk)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(lib_q, k, v,
                                              attn_mask=lib_mask)

    import statistics

    runs = {"kernel": [], "sdpa": [], "plain": []}
    for _ in range(3):
        runs["kernel"].append(cuda_ms(kernel_fwd, 50))
        runs["sdpa"].append(cuda_ms(sdpa_fwd, 50))
        runs["plain"].append(cuda_ms(lambda: plain(*args), 50))
    before = fn.backward_launches
    bwd_ms = cuda_ms(lambda: plain_vjp(plain, tuple(args[:-1]), (mask,),
                                       cot, fn), 20)
    fn.backward_launches = before
    n_bytes = (4 * q.numel() + extra + mask.numel()) * 4
    n_ops = (3 if rel else 2) * (2 * n * h * w * w * dk)
    b_ms, b_by = bound(n_bytes, n_ops)
    row = {"phase": "attention_grad", "name": name, "shape": [n, h, w, dk],
           "forward_max_abs_err": fwd_err, "grad_max_abs_diff": grad_err,
           "ms": statistics.median(runs["kernel"]),
           "sdpa_ms": statistics.median(runs["sdpa"]),
           "plain_ms": statistics.median(runs["plain"]),
           "ms_runs": runs["kernel"], "sdpa_ms_runs": runs["sdpa"],
           "plain_ms_runs": runs["plain"], "backward_ms": bwd_ms,
           "device_us": device_us(kernel_fwd, name + "_kernel"),
           "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": n_bytes,
           "library": library}
    emit(row)
    return row


def library_call(rel: bool, args, mask, dk: int):
    """The library yardstick of A or E on the same operands: (description,
    query, mask, bytes beyond q, k, v and the output). For E, SDPA takes
    (q+u) and the shifted, scaled position scores precomputed as an
    additive float mask (masked: the float32 minimum); it is not the same
    function, since SDPA does not zero row 0."""
    import torch

    from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
        MASK_MIN,
        rel_shift,
    )

    q = args[0]
    if not rel:
        return ("torch.nn.functional.scaled_dot_product_attention", q,
                mask != 0, 0)
    pos, bias_u, bias_v = args[3:6]
    bd = rel_shift(torch.matmul(q + bias_v[None, :, None, :],
                                pos.transpose(-1, -2)[None]))
    return ("torch.nn.functional.scaled_dot_product_attention "
            "(shifted position scores precomputed as an additive float "
            "mask; row 0 not zeroed)", q + bias_u[None, :, None, :],
            torch.where(mask != 0, bd / math.sqrt(dk), MASK_MIN),
            pos.numel() + 2 * bias_u.numel())


def refuse_grad_on_card(dev) -> None:
    """B, C and D have no backward: each must refuse an operand that
    requires grad on the card, and run without grad mode."""
    import torch

    from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
        ctc_forward_recursion,
    )
    from speechcatcher_tpu_torch.ops.kernels.ring_append import (
        ring_append_cols,
        ring_append_rows,
    )

    i32 = dict(dtype=torch.int32, device=dev)
    calls = {
        "ctc_forward_recursion": (ctc_forward_recursion, [
            torch.randn(6, 3, device=dev), torch.randn(6, 3, device=dev),
            torch.randn(6, 3, device=dev), torch.zeros(3, **i32),
            torch.full((3,), 6, **i32), torch.ones(3, device=dev)]),
        "ring_append_cols": (ring_append_cols, [
            torch.zeros(2, 4, 8, device=dev),
            torch.randn(2, 4, 3, device=dev), torch.zeros(2, **i32),
            torch.full((2,), 3, **i32)]),
        "ring_append_rows": (ring_append_rows, [
            torch.zeros(2, 2, 8, 4, device=dev),
            torch.randn(2, 2, 3, 4, device=dev), torch.zeros(2, **i32),
            torch.full((2,), 3, **i32)]),
    }
    for name, (call, ops) in calls.items():
        ops[1].requires_grad_()
        try:
            call(*ops)
        except RuntimeError as err:
            if "has no backward" not in str(err):
                raise
        else:
            fail(f"{name} accepted an operand that requires grad")
        with torch.no_grad():
            call(*ops)
    torch.cuda.synchronize()
    emit({"phase": "refuse_grad", "refused": sorted(calls)})


def train_batch(model, bucket_s=None):
    """(first training batch, eval utterances, batcher) of
    synthetic_dataset(32) split 9:1, batched by BucketBatcher(batch 8), as
    the trainer's command line makes them; with `bucket_s`, the first batch
    of that sample bucket (seconds)."""
    from speechcatcher_tpu_torch.data import (
        BucketBatcher,
        synthetic_dataset,
        train_eval_split,
    )

    cfg = model.cfg
    utts = synthetic_dataset(32, cfg, model.tokenizer)
    train_utts, eval_utts = train_eval_split(utts, 0.1)
    batcher = BucketBatcher(model.frontend, model.tokenizer, batch_size=8,
                            input_layer=cfg.input_layer)
    for b in batcher.batches(train_utts, shuffle_seed=0):
        if bucket_s is None or b.feats.shape[1] == model.frontend.n_frames(
                bucket_s * cfg.sample_rate):
            return b, eval_utts, batcher
    fail(f"no training batch in the {bucket_s} s bucket")


def reset_counts(counters, fns) -> None:
    for c in counters:
        c.launches = 0
    for f in fns:
        f.backward_launches = 0


def counts(counters, fns) -> dict:
    """Each kernel's launches and each Function's backwards."""
    return {c.__name__: c.launches for c in counters} | {
        f.__name__ + ".backward_launches": f.backward_launches for f in fns}


def add_counts(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def train_blocks(cfg, n_frames: int) -> int:
    """Blocks per utterance of encoder_forward_train for `n_frames`
    feature frames (0: the plain path of one block or less)."""
    from speechcatcher_tpu_torch.geometry import subsampled_len

    total = subsampled_len(n_frames, cfg.input_layer)
    if total <= cfg.block_size:
        return 0
    return math.ceil((total - cfg.block_size + cfg.hop_size)
                     / cfg.hop_size)


def expect_counts(phase: str, launches: dict, want: dict) -> None:
    emit({"phase": phase + "_launches", **launches})
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad:
        fail(f"{phase}: launch counts (got, expected) {bad}")


# The train paths' schedule: WarmupLR over TRAIN_WARMUP steps and a
# global-norm clip that binds in some of the steps, so that the learning
# rate, the bias corrections and the clip factor change from replay to
# replay (on the card the first step's gradient norm is about 2,000 for
# the transformer and 11,000 for the conformer, the later ones 13 to 640);
# the batches of synthetic_dataset(32)'s train split by index, the 4 s and
# the 2 s sample bucket in turns (the two signatures of one pool).
TRAIN_WARMUP, TRAIN_GRAPH_CLIP = 3, 40.0
TRAIN_ORDER = (0, 2, 1, 3, 4, 2)
# The long signature: 8 utterances of 12-16 s (the 16 s sample bucket);
# the longest (``--profile train-memory``): 28-32 s, the 32 s bucket.
LONG_SECONDS = (12.0, 16.0)
LONGEST_SECONDS = (28.0, 32.0)


def train_schedule(model):
    """(optimizer, the steps' batches in TRAIN_ORDER, eval batches with
    their refs) of the train paths, as the trainer's command line makes
    them: synthetic_dataset(32) split 9:1, batched by BucketBatcher (batch
    8); the train split in its first epoch's order."""
    from speechcatcher_tpu_torch.data import (
        synthetic_dataset,
        train_eval_split,
    )
    from speechcatcher_tpu_torch.training import make_optimizer

    _, eval_utts, batcher = train_batch(model)
    train_utts, _ = train_eval_split(
        synthetic_dataset(32, model.cfg, model.tokenizer), 0.1)
    batches = list(batcher.batches(train_utts, shuffle_seed=0))
    steps = [batches[i] for i in TRAIN_ORDER]
    if {b.feats.shape for b in steps[0::2]} == {b.feats.shape
                                                for b in steps[1::2]}:
        fail("train_schedule: the steps do not alternate two buckets")
    opt = make_optimizer(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         grad_clip=TRAIN_GRAPH_CLIP)
    return opt, steps, list(batcher.batches(eval_utts, with_refs=True))


def long_batch(model, seconds=LONG_SECONDS, with_refs: bool = False):
    """A batch of 8 utterances of `seconds` (least, most), one signature;
    with `with_refs`, (batch, reference texts)."""
    from speechcatcher_tpu_torch.data import BucketBatcher, synthetic_dataset

    utts = synthetic_dataset(8, model.cfg, model.tokenizer, seed=1,
                             min_sec=seconds[0], max_sec=seconds[1])
    batcher = BucketBatcher(model.frontend, model.tokenizer, batch_size=8,
                            input_layer=model.cfg.input_layer)
    return next(iter(batcher.batches(utts, with_refs=with_refs)))


class eager_training:
    """While active, ``train_step`` and ``evaluate`` run their programs
    without graphs: the reference the graphs are held against (no entry
    point can select it). With `norms`, each eager step appends its global
    gradient norm (a host read)."""

    def __init__(self, norms=None):
        self.norms = norms

    def __enter__(self):
        from speechcatcher_tpu_torch import training

        self._saved = (training.graphed, training._global_norm_sq)
        training.graphed = lambda device: False
        if self.norms is not None:
            norm_sq, norms = training._global_norm_sq, self.norms

            def recorded(grads, state):
                sq = norm_sq(grads, state)
                norms.append(float(sq.sqrt()))
                return sq
            training._global_norm_sq = recorded
        return self

    def __exit__(self, *exc):
        from speechcatcher_tpu_torch import training

        training.graphed, training._global_norm_sq = self._saved


class timed_captures:
    """While active, the seconds of each ``capture_graphs`` call (warm-up
    and captures) by its first graph's name."""

    def __init__(self):
        self.seconds = []

    def __enter__(self):
        import torch

        from speechcatcher_tpu_torch.decode import graphs

        self._saved = capture = graphs.capture_graphs

        def timed(programs, warmup, pool):
            t0 = time.perf_counter()
            out = capture(programs, warmup, pool)
            torch.cuda.synchronize()
            self.seconds.append((programs[0][0], time.perf_counter() - t0))
            return out
        graphs.capture_graphs = timed
        return self

    def __exit__(self, *exc):
        from speechcatcher_tpu_torch.decode import graphs

        graphs.capture_graphs = self._saved


def worst(values) -> float:
    """The largest of `values`, NaN if any is NaN (Python's ``max`` drops a
    NaN that is not the first element)."""
    values = [float(v) for v in values]
    return math.nan if any(map(math.isnan, values)) else max(values)


def tree_max_diff(a, b) -> float:
    """Largest absolute difference between two lists of tensors, NaN where
    any element of either is NaN or both are infinite."""
    return worst(float((x - y).detach().abs().max()) for x, y in zip(a, b))


class deterministic_algorithms:
    """While active, ``torch.use_deterministic_algorithms(True)`` (warnings
    only where an operator has no deterministic form): the atomic-add
    backwards (cuDNN's weight gradients, scatters) sum in a fixed order,
    so the eager step repeats itself to the last bit."""

    def __enter__(self):
        import torch

        self._saved = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        import torch

        torch.use_deterministic_algorithms(self._saved)


def train_runs(dev, counters, fns, cfg, tree, steps, opt) -> dict:
    """The steps on three models from `tree`: eager twice (the yardstick of
    the eager step against itself; the first records the gradient norms)
    and graphed, each to its end before the next starts. The graphed run's
    launch counts start from 0 just before it. {name: (losses per step
    [loss, ctc, att], state, model, step ms)}, the norms and the graphed
    run's launches and capture seconds."""
    import torch

    from speechcatcher_tpu_torch import training
    from speechcatcher_tpu_torch.models.asr_model import ASRModel

    out: dict = {"norms": []}
    for name in ("eager", "eager_again", "graphed"):
        model = ASRModel.from_numpy(cfg, tree, dev)
        state = opt.init(model.params)
        if name == "graphed":
            ctx = timed_captures()
        else:
            ctx = eager_training(out["norms"] if name == "eager" else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters, fns)
        losses, step_ms = [], []
        with ctx:
            for b in steps:
                t0 = time.perf_counter()
                _, _, m = training.train_step(model.params, state, b, cfg,
                                              opt)
                losses.append([float(m[k]) for k in training.METRICS])
                step_ms.append((time.perf_counter() - t0) * 1e3)
        if name == "graphed":
            out["launches"] = counts(counters, fns)
            out["capture_s"] = ctx.seconds
        out[name] = (losses, state, model, step_ms)
    return out


def held_to_eager(phase: str, runs: dict, within: bool = True) -> dict:
    """The graphed run against the eager one: each step's three losses and
    the parameters, mu and nu after the last step, against the eager run's
    difference from itself (the yardstick: 0 where the eager step repeats
    to the last bit). With `within`, every difference must lie within its
    yardstick; without, only the first step's losses must be equal (the
    forward repeats itself; the atomic-add backwards of the default
    algorithms move the later steps by chance). Every loss, and every
    difference of parameters and moments, must be finite (a NaN fails
    every comparison), and the graphed run's loss must fall on the batch
    that TRAIN_ORDER repeats. Returns the row it prints."""
    (le, se, _, _), (l2, s2, _, _), (lg, sg, _, _) = (
        runs["eager"], runs["eager_again"], runs["graphed"])
    loss_yard = worst(abs(a - b) for x, y in zip(le, l2) for a, b in zip(x, y))
    loss_diff = worst(abs(a - b) for x, y in zip(le, lg) for a, b in zip(x, y))
    row = {"phase": phase + "_vs_eager", "steps": len(le),
           "losses_graphed": lg, "losses_eager": le,
           "loss_max_diff": loss_diff, "loss_yardstick": loss_yard}
    bad = not loss_diff <= loss_yard
    sane = all(math.isfinite(v) for run in (le, l2, lg) for x in run
               for v in x) and math.isfinite(loss_yard)
    for key in ("leaves", "mu", "nu"):
        yard = tree_max_diff(getattr(se, key), getattr(s2, key))
        diff = tree_max_diff(getattr(se, key), getattr(sg, key))
        row[key + "_max_diff"], row[key + "_yardstick"] = diff, yard
        bad = bad or not diff <= yard
        sane = sane and math.isfinite(diff) and math.isfinite(yard)
    row["count"] = [int(se.count), int(sg.count)]
    # TRAIN_ORDER's last batch is also an earlier step's: the second time
    # its loss is lower.
    again = [i for i, b in enumerate(TRAIN_ORDER) if b == TRAIN_ORDER[-1]]
    row["repeated_batch_losses"] = [lg[i][0] for i in again]
    emit(row)
    if not sane or not lg[again[-1]][0] < lg[again[0]][0]:
        fail(f"{phase}: a loss, parameter or moment is not finite, or the "
             f"loss on the batch of steps {[i + 1 for i in again]} did not "
             f"fall: {row}")
    if not within:
        bad = not le[0] == l2[0] == lg[0]
    if bad or row["count"] != [len(le)] * 2:
        fail(f"{phase}: the graphed steps differ from the eager ones beyond "
             f"the eager steps' own spread: {row}")
    return row


def graph_nodes(graph) -> int:
    """Nodes of a captured graph kept with ``keep_graph=True``, through the
    ``libcuda``'s ``cuGraphGetNodes``."""
    import ctypes

    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        fail(f"cuGraphGetNodes returned {err}")
    return n.value


def measured_graph(fn, reps: int = 5):
    """(nodes, replay ms by CUDA events) of fn captured alone (warm-up on
    a side stream, its own pool; launches recorded, not counted)."""
    import torch

    from speechcatcher_tpu_torch.ops.kernels import _plan

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _plan.recording(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    capture = torch.cuda.graph(graph, capture_error_mode="thread_local")
    with _plan.recording(capture.capture_stream), capture:
        fn()
    graph.instantiate()
    with _plan.recording(torch.cuda.current_stream()):
        ms = cuda_ms(graph.replay, reps, warmup=1)
    return graph_nodes(graph), ms


def ctc_share(phase: str, model, state, opt, batch, smi: str) -> dict:
    """At a captured signature: the nodes and replay ms of the whole step
    (on a copy of the state) and of the CTC loss with its backward alone
    (the unrolled loop over the encoder frames), and the CTC's share."""
    import dataclasses as dc

    import torch

    from speechcatcher_tpu_torch import training
    from speechcatcher_tpu_torch.models.ctc import ctc_loss
    from speechcatcher_tpu_torch.models.encoder import encoder_forward_train

    cfg = model.cfg
    copy = dc.replace(state, count=state.count.clone(),
                      leaves=[x.detach().clone() for x in state.leaves],
                      mu=[x.clone() for x in state.mu],
                      nu=[x.clone() for x in state.nu], graphs=None)
    step_nodes, step_ms = measured_graph(lambda: training._step(
        model.params, state, batch, cfg, opt, update=copy))
    del copy
    with torch.no_grad():
        hs, hlens = encoder_forward_train(model.params["encoder"],
                                          batch.feats, batch.feat_lens, cfg)
    hs = hs.detach().requires_grad_()
    ctc = model.params["ctc"]
    wrt = [hs, ctc["ctc_lo"]["weight"], ctc["ctc_lo"]["bias"]]

    def ctc_step():
        loss = ctc_loss(ctc, hs, hlens, batch.tokens, batch.token_lens,
                        blank=cfg.blank_id)
        return torch.autograd.grad(loss, wrt)

    ctc_nodes, ctc_ms = measured_graph(ctc_step)
    row = {"phase": phase + "_ctc_share", "batch": list(batch.feats.shape),
           "encoder_frames": hs.shape[1], "step_graph_nodes": step_nodes,
           "step_replay_ms": step_ms, "ctc_graph_nodes": ctc_nodes,
           "ctc_replay_ms": ctc_ms, "ctc_node_share": ctc_nodes / step_nodes,
           "ctc_time_share": ctc_ms / step_ms, "card": smi}
    emit(row)
    return row


def step_profile(model, state, opt, batch, mode: str) -> dict:
    """One warm train step (graphed, or eager under ``eager_training``)
    under torch.profiler: host-issued kernels, graph launches, device busy
    time and idle share, GEMM share; of the eager step also the device
    time of A's (E's) forward kernel and of its backward (the plain
    recompute and its VJP, the range ``*_plain_backward``)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from speechcatcher_tpu_torch import training

    ctx = eager_training() if mode == "eager" else contextlib.nullcontext()
    with ctx:
        training.train_step(model.params, state, batch, model.cfg, opt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            training.train_step(model.params, state, batch, model.cfg, opt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    averages = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in averages if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in rows)
    gemm_us = sum(e.self_device_time_total for e in rows
                  if any(k in e.key.lower() for k in (
                      "gemm", "gemv", "cutlass", "cublas", "nvjet")))
    rel = model.cfg.encoder_type == "conformer"
    kernel = "rel_block_attention" if rel else "block_attention"
    fwd_us = sum(e.self_device_time_total for e in rows
                 if kernel + "_kernel" in e.key
                 and (rel or "rel_block_attention_kernel" not in e.key))
    bwd_us = sum(e.device_time_total for e in averages
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.key == kernel + "_plain_backward")
    return {"mode": mode, "encoder_type": model.cfg.encoder_type,
            "batch": list(batch.feats.shape)} | device_share(
        averages, wall) | runtime_calls(averages) | {
        "device_kernels": sum(e.count for e in rows),
        "gemm_share": gemm_us / busy_us,
        "attention_forward_ms": fwd_us / 1e3,
        "attention_forward_share": fwd_us / busy_us,
        "attention_backward_ms": bwd_us / 1e3,
        "attention_backward_share": bwd_us / busy_us}


def step_timing(runs: dict, batch, opt, pairs: int = 3, steps: int = 3):
    """Mean wall ms of `steps` train steps on `batch`, graphed and eager,
    in `pairs` interleaved pairs (the order alternates) on the warm models
    of `runs`."""
    import contextlib

    import torch

    from speechcatcher_tpu_torch import training

    out = {"graphed": [], "eager": []}
    for p in range(pairs):
        for mode in (("graphed", "eager") if p % 2 == 0
                     else ("eager", "graphed")):
            _, state, model, _ = runs[mode]
            ctx = (eager_training() if mode == "eager"
                   else contextlib.nullcontext())
            with ctx:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    training.train_step(model.params, state, batch,
                                        model.cfg, opt)
                torch.cuda.synchronize()
            out[mode].append((time.perf_counter() - t0) * 1e3 / steps)
    return out


def graphed_train_path(dev, counters, fns, smi: str,
                       encoder_type: str) -> dict:
    """The flagship's train step as CUDA graphs against the eager step: six
    steps alternating the 4 s and 2 s buckets (two signatures, one pool)
    under WarmupLR with a binding clip, with the default algorithms (the
    first step's losses equal; the eager step's spread against itself
    printed) and with deterministic ones (every loss, parameter and moment
    equal), then two more on the 16 s signature (deterministic); A (E for
    the conformer) forward and backward L times a graphed step; the CTC
    loop's nodes and share; timing pairs, graphed against eager;
    ``evaluate`` graphed against eager (transformer). Returns the
    launches of the graphed steps and evaluation."""
    import torch

    from speechcatcher_tpu_torch import training
    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.decode import graphs
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.params import random_params

    rel = encoder_type == "conformer"
    phase = "conformer_train_path" if rel else "train_path"
    cfg = flagship_config(encoder_type=encoder_type)
    L = cfg.encoder_layers
    tree = random_params(cfg, 0)
    opt, steps, eval_batches = train_schedule(ASRModel.from_numpy(
        cfg, tree, dev))
    n = len(steps)
    want = {"block_attention": 0 if rel else L * n,
            "rel_block_attention": L * n if rel else 0,
            "BlockAttentionFn.backward_launches": 0 if rel else L * n,
            "RelBlockAttentionFn.backward_launches": L * n if rel else 0,
            "ctc_forward_recursion": 0, "ring_append_cols": 0,
            "ring_append_rows": 0}
    captured0 = len(graphs.CAPTURED)
    runs = train_runs(dev, counters, fns, cfg, tree, steps, opt)
    TRAIN_LOSSES[encoder_type] = [x[0] for x in runs["graphed"][0]]
    norms = runs["norms"]
    clipped = sum(x >= TRAIN_GRAPH_CLIP for x in norms)
    held_to_eager(phase + "_default_algorithms", runs, within=False)
    launches = runs["launches"]
    expect_counts(phase, launches, want)
    state = runs["graphed"][1]
    new = graphs.CAPTURED[captured0:]
    emit({"phase": phase, "card": smi, "steps": n,
          "batches": [list(b.feats.shape) for b in steps],
          "windows_per_layer": [b.feats.shape[0] * train_blocks(
              cfg, b.feats.shape[1]) for b in steps],
          "grad_norms": norms, "clip": TRAIN_GRAPH_CLIP,
          "clipped_steps": clipped, "warmup_steps": TRAIN_WARMUP,
          "step_ms": {k: runs[k][3] for k in ("eager", "graphed")},
          "graphs": [{"name": g.name, "pool_bytes": g.pool_bytes}
                     for g in new],
          "capture_s": runs["capture_s"],
          "pool_bytes": state.graphs.pool_bytes(),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    if not 0 < clipped < n:
        fail(f"{phase}: the clip {TRAIN_GRAPH_CLIP} binds in {clipped} of "
             f"{n} steps (norms {norms}): it must bind in some, not all")
    if len(state.graphs.entries) != 2:
        fail(f"{phase}: {len(state.graphs.entries)} signatures captured")
    model = runs["graphed"][2]
    long = long_batch(model)
    shares = [ctc_share(phase, model, state, opt, b, smi)
              for b in (steps[1], steps[0], long)]
    emit({"phase": phase + "_timing", "card": smi,
          "batch": list(steps[0].feats.shape),
          "step_ms_pairs": step_timing(runs, steps[0], opt),
          "ctc_time_share": {str(r["encoder_frames"]): r["ctc_time_share"]
                             for r in shares}})
    if not rel:
        launches = add_counts(launches, graphed_evaluate(
            phase, counters, fns, runs, eval_batches, smi))
    del runs, state, model
    torch.cuda.empty_cache()
    # Deterministic algorithms: the same six steps, every leaf equal; then
    # the 16 s signature in the same pool: one capture, two replays, on
    # the three states as they are.
    with deterministic_algorithms():
        runs = train_runs(dev, counters, fns, cfg, tree, steps, opt)
        held_to_eager(phase, runs)
        more = {}
        for name in ("eager", "eager_again", "graphed"):
            losses, st, model, ms = runs[name]
            ctx = (timed_captures() if name == "graphed"
                   else eager_training())
            torch.cuda.synchronize()
            reset_counts(counters, fns)
            with ctx:
                for _ in range(2):
                    t0 = time.perf_counter()
                    _, _, m = training.train_step(model.params, st, long,
                                                  cfg, opt)
                    losses.append([float(m[k]) for k in training.METRICS])
                    ms.append((time.perf_counter() - t0) * 1e3)
            if name == "graphed":
                more = {"launches": counts(counters, fns),
                        "capture_s": ctx.seconds}
        held_to_eager(phase + "_long", runs)
    expect_counts(phase + "_long", more["launches"],
                  {k: v // n * 2 for k, v in want.items()})
    state = runs["graphed"][1]
    emit({"phase": phase + "_long", "card": smi,
          "batch": list(long.feats.shape), "windows_per_layer":
          long.feats.shape[0] * train_blocks(cfg, long.feats.shape[1]),
          "step_ms": {k: runs[k][3][-2:] for k in ("eager", "graphed")},
          "capture_s": more["capture_s"], "graph": graphs.CAPTURED[-1].name,
          "signature_pool_bytes": graphs.CAPTURED[-1].pool_bytes,
          "pool_bytes": state.graphs.pool_bytes(),
          "signatures": len(state.graphs.entries),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    del runs, state
    torch.cuda.empty_cache()
    return add_counts(launches, more["launches"])


def graphed_evaluate(phase: str, counters, fns, runs: dict, eval_batches,
                     smi: str) -> dict:
    """``evaluate`` of the graphed model on the eval split with the
    tokenizer, graphed (launch counts from 0: two encoder passes a batch
    with more than one block) against eager on the same tree: the three
    losses to the last bit, WER and CER equal."""
    import torch

    from speechcatcher_tpu_torch.decode import graphs
    from speechcatcher_tpu_torch.training import evaluate

    model = runs["graphed"][2]
    cfg = model.cfg
    L = cfg.encoder_layers
    captured0 = len(graphs.CAPTURED)
    torch.cuda.synchronize()
    reset_counts(counters, fns)
    t0 = time.perf_counter()
    got = evaluate(model.params, cfg, eval_batches, model.tokenizer)
    wall = time.perf_counter() - t0
    launches = counts(counters, fns)
    t0 = time.perf_counter()
    again = evaluate(model.params, cfg, eval_batches, model.tokenizer)
    replay_wall = time.perf_counter() - t0
    with eager_training():
        t0 = time.perf_counter()
        want = evaluate(model.params, cfg, eval_batches, model.tokenizer)
        eager_wall = time.perf_counter() - t0
    blocked = sum(train_blocks(cfg, b.feats.shape[1]) > 0
                  for b, _ in eval_batches)
    new = graphs.CAPTURED[captured0:]
    emit({"phase": phase + "_eval", **got, "eager": want,
          "eval_batches": len(eval_batches), "graphs": [
              {"name": g.name, "pool_bytes": g.pool_bytes} for g in new],
          "wall_ms": {"first": wall * 1e3, "graphed": replay_wall * 1e3,
                      "eager": eager_wall * 1e3}, "card": smi})
    if not all(math.isfinite(got[k]) for k in ("loss", "ctc", "att", "wer")):
        fail(f"{phase} eval: {got}")
    if got != want or again != got:
        fail(f"{phase} eval: graphed {got} (again {again}), eager {want}")
    if len(new) != 2 * len({b.feats.shape for b, _ in eval_batches}):
        fail(f"{phase} eval: {len(new)} graphs captured")
    # Each eval batch runs the encoder twice: the loss and the greedy WER.
    expect_counts(phase + "_eval", launches, {
        "block_attention": 2 * L * blocked, "rel_block_attention": 0,
        "BlockAttentionFn.backward_launches": 0})
    return launches


def small_train_config():
    """Small width at the flagship's block geometry: 2 + 2 layers, d 256,
    4 heads, conv2d."""
    from speechcatcher_tpu_torch.config import flagship_config

    return flagship_config(encoder_dim=256, decoder_dim=256,
                           encoder_heads=4, decoder_heads=4,
                           encoder_layers=2, decoder_layers=2,
                           encoder_linear_units=1024,
                           decoder_linear_units=1024)


# Card against CPU for one train_step at small width. Loss: float32 sums in
# another order. Gradients: per leaf within 1e-3 relative plus 5e-4 of the
# leaf's largest magnitude (at least 1e-8): atomic-add backwards (cuDNN's
# weight gradients among them) sum in no fixed order, and cuBLAS and cuDNN
# sum in other orders and forms than the CPU; the worst
# leaf, the second subsampling conv's weight (each element a sum of 15,048
# products, through the algorithm cuDNN's heuristics pick), read 1.4e-4 of
# its scale beyond the relative part on the first run. Parameters after the
# step: adamw's first update is lr * g / (|g| + eps), about lr * sign(g), so
# an element whose gradient is float32 noise may move lr either way on each
# side: within 2 * lr everywhere, and within 1e-6 for all but 1% of the
# elements.
TRAIN_VS_CPU_LOSS_RTOL = 1e-5
TRAIN_VS_CPU_GRAD_RTOL, TRAIN_VS_CPU_GRAD_SCALE = 1e-3, 5e-4
TRAIN_VS_CPU_PARAM_CLOSE, TRAIN_VS_CPU_PARAM_FAR_SHARE = 1e-6, 0.01


def train_vs_cpu(dev) -> None:
    """One train_step at small width on the card and on the CPU from the
    same weights and batch (8 utterances of the 4 s bucket: 5 blocks
    each): loss, every gradient and every updated parameter."""
    import numpy as np
    import torch

    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.params import (
        params_to_numpy,
        random_params,
        tree_leaves,
        tree_map,
    )
    from speechcatcher_tpu_torch.training import (
        TrainBatch,
        joint_loss,
        make_optimizer,
        train_step,
    )

    cfg = small_train_config()
    tree = random_params(cfg, 3)
    cpu = torch.device("cpu")
    batch_cpu, _, _ = train_batch(ASRModel.from_numpy(cfg, tree, cpu),
                                  bucket_s=4)
    out = []
    for d in (cpu, dev):
        model = ASRModel.from_numpy(cfg, tree, d)
        batch = TrainBatch(*(x.to(d) for x in batch_cpu))
        opt = make_optimizer(lr=TRAIN_LR, grad_clip=TRAIN_CLIP)
        state = opt.init(model.params)
        loss, _ = joint_loss(model.params, batch, cfg)
        grads = torch.autograd.grad(loss, state.leaves)
        for x, g in zip(state.leaves, grads):
            x.grad = g
        grad_tree = params_to_numpy(tree_map(lambda x: x.grad,
                                             model.params))
        _, _, m = train_step(model.params, state, batch, cfg, opt)
        out.append((loss.item(), grad_tree, params_to_numpy(model.params),
                    float(m["loss"])))
    (l_cpu, g_cpu, p_cpu, s_cpu), (l_gpu, g_gpu, p_gpu, s_gpu) = out
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst_grad, worst_leaf = 0.0, ""
    for (path, gc), (_, gg) in zip(tree_leaves(g_cpu), tree_leaves(g_gpu)):
        atol = max(TRAIN_VS_CPU_GRAD_SCALE * float(np.abs(gc).max()), 1e-8)
        excess = float((np.abs(gg - gc) - TRAIN_VS_CPU_GRAD_RTOL
                        * np.abs(gc)).max()) / atol
        if math.isnan(excess) or excess > worst_grad:
            worst_grad, worst_leaf = excess, path
    diffs = np.concatenate([np.abs(pg - pc).ravel() for (_, pc), (_, pg) in
                            zip(tree_leaves(p_cpu), tree_leaves(p_gpu))])
    far = float((diffs > TRAIN_VS_CPU_PARAM_CLOSE).mean())
    row = {"phase": "train_vs_cpu", "config": "flagship geometry, d 256, "
           "4 heads, 2 + 2 layers, conv2d",
           "batch": list(batch_cpu.feats.shape), "loss_cpu": l_cpu,
           "loss_card": l_gpu, "loss_rel_err": loss_rel,
           "loss_tol": TRAIN_VS_CPU_LOSS_RTOL,
           "grad_worst_share_of_tol": worst_grad,
           "grad_worst_leaf": worst_leaf,
           "grad_tol": [TRAIN_VS_CPU_GRAD_RTOL, TRAIN_VS_CPU_GRAD_SCALE],
           "param_max_abs_diff": float(diffs.max()),
           "param_share_beyond_1e-6": far,
           "step_loss_cpu": s_cpu, "step_loss_card": s_gpu}
    emit(row)
    if (not loss_rel <= TRAIN_VS_CPU_LOSS_RTOL or not worst_grad <= 1.0
            or not float(diffs.max()) <= 2 * TRAIN_LR
            or far > TRAIN_VS_CPU_PARAM_FAR_SHARE):
        fail(f"train_vs_cpu: the card's train step differs from the CPU's: "
             f"{row}")


def greedy_path(dev, counters, fns, smi: str) -> dict:
    """greedy_decode_batch of 8 waveforms of 2-30 s on the flagship (random
    weights of the talker, whose CTC head emits), its RTF and launches;
    then at small width, the card's tokens against the CPU's, exactly."""
    import torch

    from speechcatcher_tpu_torch.decode.greedy import greedy_decode_batch
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.params import random_params
    from speechcatcher_tpu_torch.synth import synth_audio

    model = flagship_model(dev, seed=TALKER_SEED, biases=TALKER_BIASES)
    rate = model.cfg.sample_rate
    seconds = (2.0, 5.5, 9.0, 12.5, 16.0, 21.0, 25.5, 30.0)
    waves = [synth_audio(s, seed=300 + i, rate=rate)
             for i, s in enumerate(seconds)]
    greedy_decode_batch(model, waves[:2])  # warm-up
    torch.cuda.synchronize()
    reset_counts(counters, fns)
    t0 = time.perf_counter()
    out = greedy_decode_batch(model, waves)
    wall = time.perf_counter() - t0
    launches = counts(counters, fns)
    emit({"phase": "greedy_path", "utterances": len(waves),
          "audio_s": sum(seconds), "wall_s": wall,
          "rtf": wall / sum(seconds), "tokens": [len(i) for _, i in out],
          "nvidia_smi": smi})
    expect_counts("greedy_path", launches, {
        "block_attention": model.cfg.encoder_layers,
        "rel_block_attention": 0, "ctc_forward_recursion": 0,
        "ring_append_cols": 0, "ring_append_rows": 0,
        "BlockAttentionFn.backward_launches": 0})

    cfg = small_train_config()
    tree = random_params(cfg, 5)
    tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] -= 2.0
    on_cpu, on_card = (greedy_decode_batch(ASRModel.from_numpy(cfg, tree, d),
                                           waves)
                       for d in (torch.device("cpu"), dev))
    n_tokens = sum(len(ids) for _, ids in on_cpu)
    emit({"phase": "greedy_vs_cpu", "tokens": n_tokens,
          "equal": on_cpu == on_card})
    if on_cpu != on_card or n_tokens < 8:
        fail("greedy_vs_cpu: the card's tokens differ from the CPU's (or "
             f"too few: {n_tokens})")
    return launches


def train_cli(dev) -> list:
    """``python -m speechcatcher_tpu_torch.training --steps 3 --batch 8
    --save-dir <dir>`` in a subprocess (the default config), then the
    command line's ``main`` in this process (a start of Python, torch and
    the card saved each): ``--resume --steps 1``, whose first loss must be
    that of the saved parameters on the first batch, and ``--num-processes
    2`` without ``--coordinator``, which must exit non-zero saying it takes
    effect only with it. Returns the first run's losses."""
    import contextlib
    import io
    import re
    import tempfile

    import torch

    from speechcatcher_tpu_torch import training
    from speechcatcher_tpu_torch.config import ModelConfig
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.utils.save import load_checkpoint

    # The card is the command's default device; a CPU rehearsal names it.
    device = ["--device", "cpu"] if dev.type == "cpu" else []

    def run(*flags):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "speechcatcher_tpu_torch.training",
             *flags, *device], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        return res, time.perf_counter() - t0

    def run_here(*flags):
        """``training.main`` on `flags`: (exit code, stdout, stderr)."""
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        code = 0
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                training.main([*flags, *device])
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else 1
        return (subprocess.CompletedProcess([], code, out.getvalue(),
                                            err.getvalue()),
                time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as tmp:
        res, wall = run("--steps", "3", "--batch", "8", "--save-dir", tmp)
        if res.returncode != 0:
            fail(f"train_cli: exit {res.returncode}: {res.stderr[-2000:]}")
        losses = re.findall(r"^step \d+: loss (\S+)", res.stdout, re.M)
        evals = re.findall(r"^eval @ step 3: .*", res.stdout, re.M)
        res2, wall2 = run_here("--steps", "1", "--batch", "8",
                               "--save-dir", tmp, "--resume")
        if res2.returncode != 0:
            fail(f"train_cli --resume: exit {res2.returncode}: "
                 f"{res2.stderr[-2000:]}")
        resumed = re.findall(r"^step 4: loss (\S+)", res2.stdout, re.M)
        params, cfg, step = load_checkpoint(Path(tmp), step=3, device=dev)
        model = ASRModel.random_init(ModelConfig(), seed=0, device=dev)
        batch, _, _ = train_batch(model)
        with torch.no_grad():
            loss = float(training.joint_loss(params, batch, cfg)[0])
        saved = sorted(p.name for p in Path(tmp).glob("params_*.pt"))
    res3, _ = run_here("--steps", "1", "--num-processes", "2")
    row = {"phase": "train_cli", "losses": losses, "eval": evals,
           "wall_s": wall, "resume_wall_s": wall2, "resumed_loss": resumed,
           "saved_params_loss": loss, "saved": saved,
           "num_processes_2_exit": res3.returncode}
    emit(row)
    if (len(losses) != 3 or len(evals) != 1 or len(resumed) != 1
            or not all(math.isfinite(float(x)) for x in losses)
            or not abs(float(resumed[0]) - loss) <= 1e-4 or step != 3
            or saved != ["params_3.pt", "params_4.pt"]):
        fail(f"train_cli: {row}")
    if (res3.returncode == 0
            or "only with --coordinator" not in res3.stderr):
        fail(f"train_cli: --num-processes 2 exited {res3.returncode}: "
             f"{res3.stderr[-500:]}")
    return [float(x) for x in losses]


def profile_train(dev) -> None:
    """torch.profiler over one warm flagship train step of the 4 s bucket
    (batch 8, 40 windows per layer) in the train paths' schedule, graphed
    and eager (``step_profile``), for the transformer and the conformer:
    host-issued kernels, graph launches, device busy time, idle share,
    GEMM share, A's (E's) forward and backward. The whole run takes these
    from this mode in a process of its own (``train_profiles``)."""
    import torch

    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel

    for encoder_type in ("transformer", "conformer"):
        model = ASRModel.random_init(
            flagship_config(encoder_type=encoder_type), seed=0, device=dev)
        opt, steps, _ = train_schedule(model)
        state = opt.init(model.params)
        for mode in ("graphed", "eager"):
            emit({"phase": "profile_train"} | step_profile(
                model, state, opt, steps[0], mode))
        del model, state
        torch.cuda.empty_cache()


def profile_train_memory(dev, smi: str) -> None:
    """Device memory of the flagship's train step and ``evaluate``, per
    encoder, at the 4 s bucket of the train paths and then at the 32 s
    signature (8 utterances of LONGEST_SECONDS) in the same state: two
    steps eager, then two graphed (capture and a replay); of each, the
    peak allocated above what the model and state hold and the reserved
    memory left after it; of the graphed, its signature's pool. Then
    ``evaluate`` on the 32 s batch, graphed and eager: the tree's eval
    pool (two programs) and the peaks."""
    import contextlib

    import torch

    from speechcatcher_tpu_torch import training
    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.decode import graphs
    from speechcatcher_tpu_torch.models.asr_model import ASRModel

    def measured(fn) -> dict:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return {"peak_above_bytes": torch.cuda.max_memory_allocated() - base,
                "reserved_growth_bytes": torch.cuda.memory_reserved()
                - reserved}

    for encoder_type in ("transformer", "conformer"):
        model = ASRModel.random_init(
            flagship_config(encoder_type=encoder_type), seed=0, device=dev)
        cfg = model.cfg
        opt, steps, _ = train_schedule(model)
        state = opt.init(model.params)
        longest, refs = long_batch(model, LONGEST_SECONDS, with_refs=True)
        torch.cuda.synchronize()
        row = {"phase": "profile_train_memory", "encoder_type": encoder_type,
               "card": smi, "model_and_state_bytes":
               torch.cuda.memory_allocated()}
        for name, batch in (("4s", steps[0]), ("32s", longest)):
            for mode in ("eager", "graphed"):
                ctx = (eager_training() if mode == "eager"
                       else contextlib.nullcontext())

                def two_steps():
                    with ctx:
                        for _ in range(2):
                            training.train_step(model.params, state, batch,
                                                cfg, opt)
                row[f"{name}_{mode}"] = measured(two_steps)
            row[f"{name}_batch"] = list(batch.feats.shape)
            row[f"{name}_signature_pool_bytes"] = (
                graphs.CAPTURED[-1].pool_bytes)
        row["train_pool_bytes"] = state.graphs.pool_bytes()
        for mode in ("eager", "graphed"):
            ctx = (eager_training() if mode == "eager"
                   else contextlib.nullcontext())

            def evaluate():
                with ctx:
                    training.evaluate(model.params, cfg, [(longest, refs)],
                                      model.tokenizer)
            row[f"eval_32s_{mode}"] = measured(evaluate)
        row["eval_pool_bytes"] = training._eval_graphs(
            model.params).pool_bytes()
        emit(row)
        del model, state
        torch.cuda.empty_cache()


# Capture-and-teardown cycles of ``--profile train-in-process``, each
# encoder in turn.
TRAIN_CYCLES = 10


def profile_train_in_process(dev, smi: str) -> None:
    """The graphed train paths and their profiles in one process, per
    encoder ``graphed_train_path`` then ``step_profile`` graphed and eager
    at the 4 s bucket: the order of an earlier whole run, one process of
    which ended in a segmentation fault in the conformer's profile (the
    whole run now profiles in a process of its own, ``train_profiles``).
    Then TRAIN_CYCLES cycles of each encoder in turn, in the same process:
    a fresh model and state, three graphed steps over two signatures,
    ``evaluate`` graphed, a graphed step under torch.profiler, and the
    teardown of all of it (train and eval graphs, pools). faulthandler
    prints every thread's Python stack on such a fault."""
    import gc

    import torch

    from speechcatcher_tpu_torch import training

    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel

    counters, fns = kernel_counters()
    for encoder_type in ("transformer", "conformer"):
        graphed_train_path(dev, counters, fns, smi, encoder_type)
        model = ASRModel.random_init(
            flagship_config(encoder_type=encoder_type), seed=0, device=dev)
        opt, steps, _ = train_schedule(model)
        state = opt.init(model.params)
        for mode in ("graphed", "eager"):
            emit({"phase": "profile_train"} | step_profile(
                model, state, opt, steps[0], mode) | {"card": smi})
        del model, state
        torch.cuda.empty_cache()
    for cycle in range(TRAIN_CYCLES):
        for encoder_type in ("transformer", "conformer"):
            model = ASRModel.random_init(
                flagship_config(encoder_type=encoder_type), seed=cycle,
                device=dev)
            opt, steps, eval_batches = train_schedule(model)
            state = opt.init(model.params)
            losses = [float(training.train_step(
                model.params, state, b, model.cfg, opt)[2]["loss"])
                for b in steps[:3]]
            got = training.evaluate(model.params, model.cfg, eval_batches,
                                    model.tokenizer)
            prof = step_profile(model, state, opt, steps[0], "graphed")
            emit({"phase": "train_cycle", "cycle": cycle,
                  "encoder_type": encoder_type, "losses": losses,
                  "eval_loss": got["loss"],
                  "signatures": len(state.graphs.entries),
                  "pool_bytes": state.graphs.pool_bytes(),
                  "graph_launches": prof["graph_launches"]})
            if not all(map(math.isfinite, losses + [got["loss"]])):
                fail(f"train_cycle {cycle} {encoder_type}: {losses}, {got}")
            del model, state, opt, steps, eval_batches
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


MESH_STEPS = 5


def _eager_steps(params, state, batch, cfg, opt, mesh=None) -> dict:
    """One warm train step, then MESH_STEPS timed one by one."""
    import statistics

    import torch

    from speechcatcher_tpu_torch.training import train_step

    train_step(params, state, batch, cfg, opt, mesh)
    torch.cuda.synchronize()
    losses, step_ms = [], []
    for _ in range(MESH_STEPS):
        t0 = time.perf_counter()
        _, _, m = train_step(params, state, batch, cfg, opt, mesh)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return {"losses": losses, "step_ms": step_ms,
            "median_step_ms": statistics.median(step_ms)}


def _mesh_step_rank(devices):
    """One tp rank of ``profile_mesh_step``: both encoders' eager steps on
    its shards."""
    import torch

    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.parallel.mesh import make_mesh, shard_params
    from speechcatcher_tpu_torch.parallel.tp import set_tp_group

    mesh = make_mesh(TP, tp=TP, devices=devices)
    set_tp_group(mesh.tp_group)
    out = {}
    for encoder_type in ("transformer", "conformer"):
        model = ASRModel.random_init(
            flagship_config(encoder_type=encoder_type), seed=0,
            device=mesh.device)
        opt, steps, _ = train_schedule(model)
        params = shard_params(model.params, mesh)
        state = opt.init(params, mesh)
        out[encoder_type] = _eager_steps(params, state, steps[0], model.cfg,
                                         opt, mesh)
        del model, params, state
        torch.cuda.empty_cache()
    return out


def profile_mesh_step(dev, smi: str) -> None:
    """The eager train step, the program a mesh runs (``train_step`` takes
    no graph under a mesh or a tp group), at the train paths' first batch
    (8 x 4 s), each encoder: on the card with the graphs off, then at tp
    = 2 on two gloo ranks of the card; one warm step, then MESH_STEPS
    timed. Then the trainer's command line, 4 steps of batch 8, as one
    NCCL process (``--coordinator``) and as one plain process: wall
    seconds. It measures the package beside the script: a copy of the
    script in the root of another checkout (a parent commit's) measures
    that one, so two commits compare in one call on one card."""
    import re
    import socket

    import torch

    from speechcatcher_tpu_torch import training
    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel

    row = {"phase": "profile_mesh_step", "card": smi,
           "package": str(Path(training.__file__).parent)}
    if hasattr(training, "graphed"):
        training.graphed = lambda device: False
    for encoder_type in ("transformer", "conformer"):
        model = ASRModel.random_init(
            flagship_config(encoder_type=encoder_type), seed=0, device=dev)
        opt, steps, _ = train_schedule(model)
        state = opt.init(model.params)
        row[encoder_type + "_one_card"] = _eager_steps(
            model.params, state, steps[0], model.cfg, opt)
        del model, state
        torch.cuda.empty_cache()
    for r, got in enumerate(on_ranks(_mesh_step_rank, dev, timeout=900)):
        for encoder_type, res in got.items():
            row[f"{encoder_type}_tp{TP}_rank{r}"] = res

    def trainer(*flags) -> dict:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "speechcatcher_tpu_torch.training",
             "--steps", "4", "--batch", "8", *flags], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"--profile mesh-step: the trainer {flags} exited "
                 f"{res.returncode}: {res.stderr[-2000:]}")
        return {"wall_s": time.perf_counter() - t0, "losses": re.findall(
            r"^step \d+: loss (\S+)", res.stdout, re.M)}

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    row["nccl_trainer"] = trainer("--coordinator", f"127.0.0.1:{port}",
                                  "--num-processes", "1", "--process-id",
                                  "0")
    row["one_process_trainer"] = trainer()
    emit(row)


def train_profiles(smi: str) -> list:
    """``python3 chip_smoke.py --profile train`` in a process of its own
    (torch.profiler's state stays out of this long run): its rows, each
    printed here with the card."""
    res = subprocess.run([sys.executable, "-X", "faulthandler",
                          str(ROOT / "chip_smoke.py"), "--profile", "train"],
                         cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    rows = [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith('{"phase": "profile_train"')]
    if res.returncode != 0 or len(rows) != 4:
        fail(f"--profile train: exit {res.returncode}, {len(rows)} rows: "
             f"{res.stderr[-2000:]}")
    for row in rows:
        emit(row | {"card": smi})
    return rows


# ---------------------------------------------------------------------------
# Multi-card: engine replicas and tp ranks on the one card
# ---------------------------------------------------------------------------

TP = 2
TP_STREAMS = 4
# A tp=2 train step against the single-card step on the same batch: the
# row-parallel sums add in another order, so the first loss agrees to float32
# rounding; after an update, elements whose gradient is float32 noise move
# lr either way (see TRAIN_VS_CPU_*), and the losses of later steps agree to
# this.
TP_TRAIN_LOSS_RTOL = 1e-4


def kernel_counters():
    """(the eight kernel wrappers, the two autograd Functions): what
    carries a launch count."""
    from speechcatcher_tpu_torch.ops.kernels.add_layer_norm import (
        add_layer_norm,
    )
    from speechcatcher_tpu_torch.ops.kernels.block_attention import (
        BlockAttentionFn,
        block_attention,
    )
    from speechcatcher_tpu_torch.ops.kernels.cross_attention import (
        cross_attention,
    )
    from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
        ctc_forward_recursion,
    )
    from speechcatcher_tpu_torch.ops.kernels.lane_attention import (
        lane_attention,
    )
    from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
        RelBlockAttentionFn,
        rel_block_attention,
    )
    from speechcatcher_tpu_torch.ops.kernels.ring_append import (
        ring_append_cols,
        ring_append_rows,
    )

    return ([block_attention, rel_block_attention, ctc_forward_recursion,
             ring_append_cols, ring_append_rows, add_layer_norm,
             lane_attention, cross_attention],
            [BlockAttentionFn, RelBlockAttentionFn])


def tp_attention_config(cfg, tp: int = TP):
    """A config whose attention has the shape of one tp rank's: H/tp heads
    of the same d/H (check_attention and attention_grad read the heads and
    the width)."""
    return cfg.replace(encoder_heads=cfg.encoder_heads // tp,
                       encoder_dim=cfg.encoder_dim // tp)


def on_ranks(fn, dev, timeout: float, args=(), n: int = TP):
    """``run_ranks`` of `fn` over n gloo ranks that all drive this card
    (NCCL takes one rank per card); the rendezvous file in a fresh
    temporary directory."""
    import tempfile

    from speechcatcher_tpu_torch.parallel.launch import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(fn, n, str(Path(tmp) / "rendezvous"),
                         backend="gloo", devices=[dev] * n,
                         timeout=timeout, args=args)


def _collectives_rank(devices):
    import torch
    import torch.distributed as dist

    r = dist.get_rank()
    x = torch.full((4,), float(r + 1), device=devices[r])
    y = x.clone()
    dist.all_reduce(y)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    z = x.clone()
    dist.broadcast(z, 0)
    return {"all_reduce": y.tolist(), "all_gather": torch.cat(parts).tolist(),
            "broadcast": z.tolist(), "device": str(y.device)}


def gloo_collectives(out: list) -> None:
    """Which collectives gloo takes on CUDA tensors in this build: all_reduce,
    all_gather (what gather_from_tp uses) and broadcast on two ranks of the
    card (`out`: each rank's ``_collectives_rank``). A refused one fails the
    run with the rank's traceback."""
    want = {"all_reduce": [3.0] * 4, "all_gather": [1.0] * 4 + [2.0] * 4,
            "broadcast": [1.0] * 4}
    emit({"phase": "gloo_cuda_collectives", "ranks": out})
    for got in out:
        if {k: got[k] for k in want} != want or "cuda" not in got["device"]:
            fail(f"gloo_cuda_collectives: {got}")


def _tp_train_rank(devices, smi):
    """One tp rank of tp_train_path: A (or E) at the rank's 4 heads against
    its plain version, forward and gradients, at the first batch's windows;
    then the first 3 flagship transformer steps and the first conformer
    step of the train paths' schedule (``train_schedule``), counts from 0
    after the check."""
    import torch

    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.parallel.mesh import make_mesh, shard_params
    from speechcatcher_tpu_torch.parallel.tp import set_tp_group
    from speechcatcher_tpu_torch.training import train_step

    counters, fns = kernel_counters()
    mesh = make_mesh(TP, tp=TP, devices=devices)
    set_tp_group(mesh.tp_group)
    dev = mesh.device
    out = {}
    for encoder_type, n_steps in (("transformer", 3), ("conformer", 1)):
        model = ASRModel.random_init(
            flagship_config(encoder_type=encoder_type), seed=0, device=dev)
        cfg = model.cfg
        opt, steps, _ = train_schedule(model)
        windows = steps[0].feats.shape[0] * train_blocks(
            cfg, steps[0].feats.shape[1])
        row = attention_grad(dev, tp_attention_config(cfg), windows,
                             rel=encoder_type == "conformer")
        params = model.params = shard_params(model.params, mesh)
        state = opt.init(params, mesh)
        torch.cuda.synchronize()
        reset_counts(counters, fns)
        losses, step_ms = [], []
        for batch in steps[:n_steps]:
            t0 = time.perf_counter()
            _, _, m = train_step(params, state, batch, cfg, opt, mesh)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        out[encoder_type] = {
            "losses": losses, "step_ms": step_ms,
            "launches": counts(counters, fns),
            "attention": {k: row[k] for k in (
                "name", "shape", "forward_max_abs_err", "grad_max_abs_diff",
                "ms", "sdpa_ms", "plain_ms", "backward_ms", "bound_ms",
                "bound_by")}}
        del model, params, state
    return mesh.coord, out


def tp_train_path(out: list, smi: str) -> dict:
    """Two gloo ranks on the card at tp=2 (`out`: each rank's
    ``_tp_train_rank``), each with its shards of the flagship: the first
    3 transformer steps and the first conformer step of the train paths'
    schedule, eager by configuration under the mesh. Losses equal the
    single-card graphed steps' (TRAIN_LOSSES) to rel. TP_TRAIN_LOSS_RTOL
    on both ranks; each rank launches A (E for the conformer) and its
    backward once per layer and step, at 4 heads. Returns the launches and
    backwards summed over the ranks."""
    from speechcatcher_tpu_torch.config import flagship_config

    total = {}
    for coord, res in out:
        for encoder_type, got in res.items():
            want = TRAIN_LOSSES[encoder_type][:len(got["losses"])]
            rel = worst(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                              want))
            emit({"phase": "tp_train_path", "encoder": encoder_type,
                  "rank_coord": coord, "losses": got["losses"],
                  "single_card_losses": want, "max_loss_rel_err": rel,
                  "loss_rtol": TP_TRAIN_LOSS_RTOL, "step_ms": got["step_ms"],
                  "attention": got["attention"], "nvidia_smi": smi})
            if not rel <= TP_TRAIN_LOSS_RTOL:
                fail(f"tp_train_path {encoder_type} rank {coord}: losses "
                     f"{got['losses']} vs single-card {want}")
            L = flagship_config(encoder_type=encoder_type).encoder_layers
            n = len(got["losses"])
            rel_enc = encoder_type == "conformer"
            expect_counts(f"tp_train_path_{encoder_type}_rank{coord[1]}",
                          got["launches"], {
                "block_attention": 0 if rel_enc else L * n,
                "rel_block_attention": L * n if rel_enc else 0,
                "BlockAttentionFn.backward_launches": 0 if rel_enc else L * n,
                "RelBlockAttentionFn.backward_launches":
                    L * n if rel_enc else 0,
                "ctc_forward_recursion": 0, "ring_append_cols": 0,
                "ring_append_rows": 0})
            for key, v in got["launches"].items():
                total[key] = total.get(key, 0) + v
            heads = flagship_config().encoder_heads // TP
            if got["attention"]["shape"][1] != heads:
                fail(f"tp_train_path: attention checked at "
                     f"{got['attention']['shape']}")
    emit({"phase": "tp_train_path_summary", "ranks": len(out), **total})
    return total


def tp_engine_streams(rate: int):
    return engine_streams(TP_STREAMS, [3.0, 4.0, 5.0, 6.0], [0] * TP_STREAMS,
                          int16_every=2, seed0=300, rate=rate)


def _tp_engine_rank(devices):
    """One tp rank of tp_engine_path: the flagship engine (TP_STREAMS
    slots) sharded at tp=2, driven over tp_engine_streams; records the
    smallest positive gap between the k-th and (k+1)-th candidate of every
    top-k of the beam search."""
    import torch

    from speechcatcher_tpu_torch.decode import beam_search
    from speechcatcher_tpu_torch.parallel.mesh import make_mesh
    from speechcatcher_tpu_torch.parallel.serve_sharding import shard_engine
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    counters, _ = kernel_counters()
    mesh = make_mesh(TP, tp=TP, devices=devices)
    dev = mesh.device
    model = flagship_model(dev, seed=0)
    engine = shard_engine(StreamingEngine(
        model, n_slots=TP_STREAMS, beam_size=5, chunk_samples=8192,
        device=dev), mesh)
    gaps = []

    def recording_topk(x, k):
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        if x.shape[-1] > k:
            gap = vals[..., k - 1] - vals[..., k]
            gaps.append(torch.where(torch.isfinite(gap) & (gap > 0), gap,
                                    float("inf")).amin())
        return vals[..., :k], idx[..., :k]

    beam_search._topk_stable = recording_topk
    streams = tp_engine_streams(model.cfg.sample_rate)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    finals, tick_s, _ = drive_engine(engine, streams, 8192,
                                     sync=torch.cuda.synchronize)
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    margin = float(torch.stack(gaps).amin()) if gaps else None
    return (mesh.coord, {k: (y.tolist(), x.tolist(), s)
                         for k, (y, x, s) in finals.items()},
            launches, margin, tick_s, wall)


def tp_engine_path(out: list, counters, smi: str, ref: dict,
                   ref_tick_s) -> dict:
    """Two gloo ranks on the card, one flagship engine at tp=2 over
    TP_STREAMS streams (`out`: each rank's ``_tp_engine_rank``); each final
    on both ranks equals the unsharded engine's on the same streams
    (`ref`; tokens and positions exactly, the score within rel. 1e-4).
    Prints each rank's closest top-k margin."""
    import numpy as np

    total = {c.__name__: 0 for c in counters}
    for coord, finals, launches, margin, tick_s, wall in out:
        worst = 0.0
        for k in range(TP_STREAMS):
            ry, rx, rs = ref[k]
            ey, ex, es = finals[k]
            rel = abs(es - rs) / max(1.0, abs(rs))
            worst = max(worst, rel)
            if ey != ry.tolist() or ex != rx.tolist() or not rel <= 1e-4:
                fail(f"tp_engine_path rank {coord} stream {k}: {ey} / "
                     f"{ry.tolist()}, score {es} / {rs} (closest top-k "
                     f"margin {margin})")
        emit({"phase": "tp_engine_path", "rank_coord": coord,
              "streams": TP_STREAMS, "tokens_equal": True,
              "xpos_equal": True, "max_score_rel_err": worst,
              "closest_topk_margin": margin,
              "hyp_lens": [len(finals[k][0]) for k in range(TP_STREAMS)],
              "p50_tick_ms": float(np.median(tick_s)) * 1e3,
              "unsharded_p50_tick_ms": float(np.median(ref_tick_s)) * 1e3,
              "wall_s": wall, "nvidia_smi": smi})
        check_launches(f"tp_engine_path_rank{coord[1]}", counters, launches,
                       [c for c in counters
                        if c.__name__ == "rel_block_attention"])
        for c in counters:
            total[c.__name__] += launches[c.__name__]
    return total


def _tp_rank(devices, smi):
    """One rank of the tp phases, all in one spawn of the two ranks (each
    spawn costs a start of Python, torch and the card): the collectives,
    then tp_train_path's and tp_engine_path's work."""
    return (_collectives_rank(devices), _tp_train_rank(devices, smi),
            _tp_engine_rank(devices))


def tp_paths(dev, counters, smi: str):
    """gloo_cuda_collectives, tp_train_path and tp_engine_path from one
    spawn of two gloo ranks on the card, after the unsharded engine's run
    that tp_engine_path holds the ranks against. Returns the train and
    the engine path's launches."""
    import torch

    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    model = flagship_model(dev, seed=0)
    ref, ref_tick_s, _ = drive_engine(
        StreamingEngine(model, n_slots=TP_STREAMS, beam_size=5,
                        chunk_samples=8192, device=dev),
        tp_engine_streams(model.cfg.sample_rate), 8192,
        sync=torch.cuda.synchronize)
    del model
    t0 = time.perf_counter()
    out = on_ranks(_tp_rank, dev, timeout=900, args=(smi,))
    emit({"phase": "tp_ranks", "ranks": len(out),
          "wall_s": time.perf_counter() - t0})
    gloo_collectives([o[0] for o in out])
    return (tp_train_path([o[1] for o in out], smi),
            tp_engine_path([o[2] for o in out], counters, smi, ref,
                           ref_tick_s))


def nccl_trainer(dev, want_losses) -> None:
    """The trainer's command line as one NCCL process on the card:
    ``--coordinator 127.0.0.1:<free port> --num-processes 1 --process-id 0
    --steps 2``. NCCL initialises on the card and the dp all-reduces of the
    step (counts, metrics, gradients) run through it; the losses equal the
    one-process run's (train_cli) to the 4 printed decimals."""
    import re
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "speechcatcher_tpu_torch.training",
         "--steps", "2", "--batch", "8", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "1", "--process-id", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    losses = [float(x) for x in
              re.findall(r"^step \d+: loss (\S+)", res.stdout, re.M)]
    emit({"phase": "nccl_trainer", "exit": res.returncode, "losses": losses,
          "one_process_losses": want_losses[:2], "wall_s": wall})
    if (res.returncode != 0 or len(losses) != 2
            or not all(abs(a - b) <= 1e-4
                       for a, b in zip(losses, want_losses))):
        fail(f"nccl_trainer: exit {res.returncode}, losses {losses} vs "
             f"{want_losses[:2]}: {res.stderr[-2000:]}")


# ---------------------------------------------------------------------------
# The device-resident beam loop: CUDA graphs against the eager loop
# ---------------------------------------------------------------------------

def bit_equal(what: str, got, want) -> None:
    """Fail unless every tensor of the tree `got` equals the one at the same
    place of `want` to the last bit."""
    import torch

    from speechcatcher_tpu_torch.decode.graphs import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    if len(a) != len(b):
        fail(f"{what}: the trees differ in structure")
    for i, (g, w) in enumerate(zip(a, b)):
        if (g.shape != w.shape or g.dtype != w.dtype
                or not torch.equal(g.contiguous().view(torch.uint8),
                                   w.contiguous().view(torch.uint8))):
            fail(f"{what}: leaf {i} {tuple(g.shape)} of the graphs differs "
                 "from the eager loop")


class GraphCheck:
    """While active, every graphed block loop and engine encode is run a
    second time through the eager reference (``BlockLoop._run_eager``, the
    eager ``_encode_into``) on a copy of the state it started from, and
    every leaf of the graphs' result must equal the eager one to the last
    bit. So is every graphed chunk step of a session (``ChunkStep.step``),
    against the eager ``StreamingEncoder.step`` on a copy of its state and
    the chunk's features from the eager frontend: the emitted frames and
    every leaf of the next state, and the step's launches of A and E. The
    eager runs' launches are not counted; their beam steps are
    (``eager_steps``: the eager loop makes steps + 1 host syncs a
    block)."""

    def __init__(self):
        self.blocks = self.encodes = self.eager_steps = self.chunks = 0

    def __enter__(self):
        import copy

        import torch

        from speechcatcher_tpu_torch.decode import beam_search as bs
        from speechcatcher_tpu_torch.decode import graphs
        from speechcatcher_tpu_torch.ops.kernels import _plan
        from speechcatcher_tpu_torch.serve.engine import StreamingEngine

        check = self
        run_graphs = graphs.BlockLoop._run_graphs
        encode = StreamingEngine._encode
        step = bs.block_step

        def counted_step(*args, **kwargs):
            check.eager_steps += 1
            return step(*args, **kwargs)

        def checked_run(loop):
            start = graphs.clone_tree(loop.state)
            run_graphs(loop)
            ref = copy.copy(loop)
            ref.state = start
            ref.stepping0 = torch.zeros_like(loop.stepping0)
            bs.block_step = counted_step
            try:
                with _plan.recording():
                    ref._run_eager()
            finally:
                bs.block_step = step
            bit_equal(f"block {check.blocks}", loop.state, start)
            check.blocks += 1

        def checked_encode(engine, audio, bk):
            start = graphs.clone_tree(engine.buffers)
            encode(engine, audio, bk)
            with _plan.recording():
                engine._encode_into(start, engine._audio_in[audio.dtype].dev,
                                    engine._enc_ints.dev, bk["maxb"])
            bit_equal(f"encode {check.encodes}", engine.buffers, start)
            check.encodes += 1

        from speechcatcher_tpu_torch.ops.kernels.block_attention import (
            block_attention,
        )
        from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
            rel_block_attention,
        )

        step_chunk = graphs.ChunkStep.step
        attention = [block_attention, rel_block_attention]

        def checked_chunk(chunk, source, is_final):
            if not chunk.graphed:
                return step_chunk(chunk, source, is_final)
            start = chunk.state()
            start = dataclasses.replace(start, **{
                name: getattr(start, name).clone() for name in CARRIED
                if getattr(start, name) is not None})
            enc0 = chunk.enc_len
            before = [f.launches for f in attention]
            plan = step_chunk(chunk, source, is_final)
            graphed = [f.launches - b for f, b in zip(attention, before)]
            fe = chunk.frontend
            with _plan.recording() as rec:
                if source.kind == "wave":
                    feats = fe(source.data)
                    feats = feats[:, source.lo:feats.shape[1] - source.hi]
                elif source.kind == "features":
                    feats = fe.normalize_only(source.data)
                else:
                    feats = source.data
                ys, nxt = chunk.encoder.step(feats, start, is_final)
            eager = [rec.get((f, "launches"), 0) for f in attention]
            what = f"chunk step {check.chunks} ({plan.kind})"
            if graphed != eager:
                fail(f"{what}: A and E launched {graphed} times in the "
                     f"graphs, {eager} in the eager step")
            bit_equal(what + " frames", chunk.ring[:, enc0:chunk.enc_len],
                      ys)
            if (nxt is None) != is_final:
                fail(f"{what}: the eager step's state after it")
            if nxt is not None:
                got = chunk.state()
                for name in CARRIED:
                    a, b = getattr(got, name), getattr(nxt, name)
                    if (a is None) != (b is None):
                        fail(f"{what}: {name} carried in one step only")
                    if a is not None:
                        bit_equal(f"{what} {name}", a, b)
                if got.n_processed_blocks != nxt.n_processed_blocks:
                    fail(f"{what}: blocks processed")
            check.chunks += 1
            return plan

        self._restore = [(graphs.BlockLoop, "_run_graphs", run_graphs),
                         (StreamingEngine, "_encode", encode),
                         (graphs.ChunkStep, "step", step_chunk)]
        graphs.BlockLoop._run_graphs = checked_run
        StreamingEngine._encode = checked_encode
        graphs.ChunkStep.step = checked_chunk
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._restore:
            setattr(owner, name, fn)


# The leaves of an EncoderState a chunk step carries to the next.
CARRIED = ("buf_before", "buf_after", "prev_addin", "past_ctx")


def make_eager(obj):
    """Run a session's or an engine's block loops and chunk steps, and an
    engine's encode, without graphs: the same programs eagerly, the
    comparison's other side (an engine's finalize runs its chunk step
    eagerly anyway). No entry point reaches it; on the card they all run
    the graphs."""
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    if not isinstance(obj, StreamingEngine):
        obj.beam_search.loop.graphed = False
        obj.beam_search.chunk.graphed = False
        return obj
    obj.graphed = False
    obj._loop.graphed = False
    obj._finalizer.loop.graphed = False
    make = obj._block_loop

    def eager_loop(*args):
        loop = make(*args)
        loop.graphed = False
        return loop

    obj._block_loop = eager_loop
    return obj


# Beam steps per block of the fixtures' graphed decodes: file name ->
# (encoder type, {live steps: blocks}), filled by fixture_replay.
FIXTURE_STEPS: dict = {}
K_CHOICES = (1, 2, 4, 8)


def steps_per_block(loops) -> dict:
    """Live beam steps per block of the graphed runs of `loops`: mean, max
    and the blocks by their step count."""
    hist: dict = {}
    for loop in loops:
        for n, blocks in loop.step_counts.items():
            hist[n] = hist.get(n, 0) + blocks
    blocks = sum(hist.values())
    return {"blocks": blocks,
            "steps_per_block_mean": sum(n * b for n, b in hist.items())
            / max(blocks, 1),
            "steps_per_block_max": max(hist, default=0),
            "steps_per_block_hist": {str(n): hist[n] for n in sorted(hist)}}


def replay_costs(loop, n: int = 50) -> dict:
    """On the warm graphed `loop`, every stream stopped (a step replay is
    then an identity, checked to the last bit): the device time of one
    masked beam step (CUDA events over n queued replays), and what one
    host readback adds to a replay (n replays each followed by its
    readback, less n queued replays and one wait, per replay)."""
    import torch

    from speechcatcher_tpu_torch.decode.graphs import clone_tree

    if bool(loop.state.stepping.any()):
        fail("replay_costs: a stream of the loop is still stepping")
    step = loop._graphs[1].graph
    before = clone_tree(loop.state)
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        step.replay()
    t1.record()
    t1.synchronize()
    step_ms = t0.elapsed_time(t1) / n
    start = time.perf_counter()
    for _ in range(n):
        step.replay()
    torch.cuda.synchronize()
    queued = time.perf_counter() - start
    start = time.perf_counter()
    for _ in range(n):
        step.replay()
        loop._flag.read()
    waited = time.perf_counter() - start
    bit_equal("replay_costs", loop.state, before)
    return {"masked_step_ms": step_ms,
            "readback_ms": (waited - queued) / n * 1e3}


def price_k(costs: dict, hist: dict) -> dict:
    """Mean cost in ms per block of K steps a replay, for each K of
    K_CHOICES, over blocks counted by their live steps (`hist`): a block of
    n steps makes max(1, ceil(n/K)) replays, each with a readback, and
    K per replay less n masked steps."""
    blocks = sum(hist.values())
    out = {}
    for k in K_CHOICES:
        total = 0.0
        for n, b in hist.items():
            replays = max(1, -(-int(n) // k))
            total += b * (replays * costs["readback_ms"]
                          + (replays * k - int(n)) * costs["masked_step_ms"])
        out[str(k)] = total / max(blocks, 1)
    return out


# The beam step's widths: finalize_batch's compact drain at 32 streams and
# the backlog tick's 256 slots; beam 3 as the benchmark's cells serve.
BEAM_STEP_WIDTHS = (32, 256)
BEAM_STEP_BEAM = 3
BEAM_STEP_POS = 32


# backlog256's uploads (benchmark/traffic/backlog256.json): log-normal,
# median 6 s, sigma 0.5, 2-20 s.
BACKLOG_UTTERANCE_S = (6.0, 0.5, 2.0, 20.0)


def backlog_enc_lens(cfg, s_dim: int, final: bool, seed: int):
    """Encoder frames visible to `s_dim` streams as backlog256 gives them:
    a final's whole upload (the drain), or a tick's stream part-way
    through it (uniform). Capped at the configuration's max_enc_frames."""
    import numpy as np

    median, sigma, lo, hi = BACKLOG_UTTERANCE_S
    rng = np.random.default_rng(seed)
    secs = np.clip(rng.lognormal(math.log(median), sigma, s_dim), lo, hi)
    if not final:
        secs = secs * rng.random(s_dim)
    frame_s = cfg.hop_length * cfg.subsample / cfg.sample_rate
    return np.clip(np.round(secs / frame_s), 1,
                   cfg.max_enc_frames).astype(np.int64)


def step_at_enc_lens(loop, enc_lens, reps: int) -> float:
    """The masked step's device ms (``replay_costs``) with the step's
    visible frames (the uploaded row the step reads as ``vis_len``) set to
    `enc_lens`, then restored. Every stream is stopped, so the state stays
    bit-equal; only the work that reads the frames changes."""
    import torch

    row = loop.ints.dev[2]
    saved = row.clone()
    row.copy_(torch.as_tensor(enc_lens, dtype=row.dtype, device=row.device))
    try:
        return replay_costs(loop, reps)["masked_step_ms"]
    finally:
        row.copy_(saved)


def graph_kernels(graph, reps: int = 10) -> dict:
    """Kernels one replay of `graph` runs on the card, by torch.profiler
    over `reps` replays: all of them, kernels F's, G's and H's, cuBLAS's
    ``gemmSN`` ones (the cross-attention's value product before H) and the
    twelve that took the most device time, with their launches and us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    names = [e.name for e in kernels]
    by_name: dict = {}
    for e in kernels:
        n, us = by_name.get(e.name[:80], (0, 0.0))
        by_name[e.name[:80]] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"kernels_per_replay": len(names) / reps,
            "add_layer_norm_per_replay":
                sum("add_layer_norm_kernel" in n for n in names) / reps,
            "lane_attention_per_replay":
                sum("lane_attention_kernel" in n for n in names) / reps,
            "cross_attention_per_replay":
                sum("cross_attention_kernel" in n for n in names) / reps,
            "gemmSN_per_replay": sum("gemmSN" in n for n in names) / reps,
            "top_kernels_per_replay": {k: [n / reps, us / reps]
                                       for k, (n, us) in top}}


def beam_step_costs(dev, smi: str, blocks: int = 3, reps: int = 40) -> None:
    """The graphed beam step of the benchmark's configurations (the
    flagship, ESPnet's conformer at the AISHELL-1 widths and that with its
    Transformer LM, random weights with the cells' emission biases; the
    LM's configuration is skipped in a checkout without the LM) at
    BEAM_STEP_WIDTHS streams:
    `blocks` blocks through a ``BlockLoop`` over random frames, each held
    bit-equal to the eager loop (``GraphCheck``), then, every stream
    stopped, the step graph's replays: device ms a step (CUDA events over
    `reps` masked steps, which run every kernel of a live one), kernels a
    replay by the profiler and by the capture's launch record, kernel F's
    among them (19 a step at six layers, 33 more with the LM's 16) and
    kernel G's (6, 16 more with the LM) and kernel H's (6; any of them 0
    in a checkout without it). A step's cost in G grows with the
    hypotheses' positions (the composition before G read all Lmax rows
    whatever they were): the row gives the loop's mean pos / Lmax, and the
    step's ms again with every stream's position set to BEAM_STEP_POS, a
    typical drain position (5 tokens a second into a 6 s utterance). H's
    grows with the streams' visible frames (the composition before it read
    all T ring rows): the step's ms again with each stream's frames drawn
    as backlog256 gives them (``step_at_enc_lens``)."""
    import functools
    import json

    import numpy as np
    import torch

    from speechcatcher_tpu_torch.config import ModelConfig, flagship_config
    from speechcatcher_tpu_torch.decode import beam_search as bs
    from speechcatcher_tpu_torch.decode.graphs import BlockLoop
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.serve.engine import _ring_frames

    configs = [("de-xl-transformer", flagship_config(), (2.0, 8.0))]
    for name in ("aishell-cb-conformer", "aishell-cb-conformer-lm"):
        conf = json.loads((ROOT / "benchmark" / "configs"
                           / f"{name}.json").read_text())
        if "lm_layers" in conf["model"] and not hasattr(ModelConfig,
                                                         "lm_layers"):
            continue  # a checkout without the LM
        configs.append((name, ModelConfig(**conf["model"]),
                        (conf["emission_bias"]["eos"],
                         conf["emission_bias"]["blank"])))
    fused = optional_wrapper(ADD_LAYER_NORM)
    lane_fn = optional_wrapper(LANE_ATTENTION)
    cross_fn = optional_wrapper(CROSS_ATTENTION)
    for name, cfg, biases in configs:
        lm_layers = getattr(cfg, "lm_layers", 0)
        model = ASRModel.random_init(cfg, seed=3, device=dev)
        with torch.no_grad():
            model.params["decoder"]["output_layer"]["bias"][cfg.eos_id] += \
                biases[0]
            model.params["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += biases[1]
        for s_dim in BEAM_STEP_WIDTHS:
            ecap = -(-(cfg.max_enc_frames + cfg.block_size) // 64) * 64
            gen = torch.Generator(device=dev).manual_seed(s_dim)
            memory = torch.randn((s_dim, ecap, cfg.encoder_dim), device=dev,
                                 generator=gen)
            settings = bs.LoopSettings(
                BEAM_STEP_BEAM, cfg.pre_beam_size, cfg.ctc_weight, True,
                cfg.max_tokens,
                **({"lm_weight": cfg.lm_weight} if lm_layers else {}))
            loop = BlockLoop(
                model, bs.fresh_block_state(cfg, s_dim, BEAM_STEP_BEAM, dev),
                memory, settings,
                frames=functools.partial(_ring_frames, memory,
                                         cfg.block_size),
                extcap=cfg.block_size)
            vis = 0
            with GraphCheck() as check:
                for b in range(blocks):
                    n_new = cfg.block_size if b == 0 else cfg.hop_size
                    loop.run(np.full(s_dim, vis), np.full(s_dim, n_new),
                             np.full(s_dim, vis + n_new), np.ones(s_dim),
                             np.zeros(s_dim))
                    vis += n_new
            step = loop._graphs[1]
            record = {f.__name__: n for (f, _), n in step.launches.items()}
            ylen = loop.state.arrays.ylen
            mean_pos = float((ylen - 1).float().mean()) / cfg.max_tokens
            costs = replay_costs(loop, reps)
            again = replay_costs(loop, reps)["masked_step_ms"]
            # The drain's widths see whole uploads, the tick's streams
            # part-way through theirs.
            drawn = backlog_enc_lens(cfg, s_dim, final=s_dim <= 32,
                                     seed=s_dim)
            at_lens = [step_at_enc_lens(loop, drawn, reps) for _ in range(2)]
            ylen.fill_(BEAM_STEP_POS + 1)
            at_pos = [replay_costs(loop, reps)["masked_step_ms"]
                      for _ in range(2)]
            row = {"phase": "beam_step", "config": name, "streams": s_dim,
                   "rows": s_dim * BEAM_STEP_BEAM, "nvidia_smi": smi,
                   "blocks_checked": check.blocks, "live_steps": loop.steps,
                   "mean_pos_over_lmax": mean_pos,
                   "step_ms": costs["masked_step_ms"], "step_ms_again": again,
                   f"step_ms_at_pos_{BEAM_STEP_POS}": at_pos,
                   "step_ms_at_backlog_enc_len": at_lens,
                   "backlog_enc_len_mean": float(drawn.mean()),
                   "backlog_enc_len_max": int(drawn.max()),
                   "readback_ms": costs["readback_ms"],
                   "launch_record": record, **graph_kernels(step.graph)}
            for fn, want in ((fused, 3 * cfg.decoder_layers + 1
                              + (2 * lm_layers + 1 if lm_layers else 0)),
                             (lane_fn, cfg.decoder_layers + lm_layers),
                             (cross_fn, cfg.decoder_layers)):
                if fn is not None and record.get(fn.__name__) != want:
                    fail(f"beam_step {name} S={s_dim}: {fn.__name__} "
                         f"launched {record.get(fn.__name__)} times a step")
            emit(row)
            del loop, memory
        del model
        torch.cuda.empty_cache()


# The LM step against the plain full forward at the published widths: both
# float32 (TF32 off), the step through kernels F and G, the reference
# through whole-sequence cuBLAS products; log-probabilities of about -8.4.
LM_STEP_TOL = 1e-4


def lm_path(dev, counters, smi: str) -> dict:
    """ESPnet's conformer with its Transformer LM at the published widths
    (the benchmark's ``aishell-cb-conformer-lm``, random weights from seed
    3 with its emission biases): the LM's incremental step on the card
    against the benchmark's plain full causal forward over 20-token
    prefixes of 2 x 3 hypotheses read through a lane map shuffled every
    step; then, every graphed block loop and chunk step held bit-equal to
    the eager one (``GraphCheck``), three utterances through the session
    and the engine path's ten streams through an 8-slot engine (finals by
    ``finalize_batch`` and ``finalize``), each final equal to the
    single-stream session's; the launch counts."""
    import numpy as np
    import torch

    from benchmark.reference import cb_conformer_lm as lmr
    from speechcatcher_tpu_torch.config import ModelConfig
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.models.lm import init_lm_cache, lm_step
    from speechcatcher_tpu_torch.params import params_to_numpy
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    conf = json.loads((ROOT / "benchmark" / "configs"
                       / "aishell-cb-conformer-lm.json").read_text())
    cfg = ModelConfig(**conf["model"])
    model = ASRModel.random_init(cfg, seed=3, device=dev)
    with torch.no_grad():
        model.params["decoder"]["output_layer"]["bias"][cfg.eos_id] += \
            conf["emission_bias"]["eos"]
        model.params["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += \
            conf["emission_bias"]["blank"]

    # The LM step against the full forward.
    lm_tree = tensor_tree(params_to_numpy(model.params)["lm"], dev)
    ref_lm = lmr.LanguageModel(lm_tree, cfg.lm_heads)
    s_dim, b_dim, steps = 2, 3, 20
    n = s_dim * b_dim
    rng = np.random.default_rng(3)
    ys = rng.integers(1, cfg.vocab_size - 1, size=(s_dim, b_dim, steps))
    ys[:, :, 0] = cfg.sos_id
    perm = [rng.permutation(b_dim) for _ in range(steps)]
    inv = [np.argsort(p) for p in perm]
    want = {(a, h): ref_lm.logp(ys[a, h]) for a in range(s_dim)
            for h in range(b_dim)}
    cache = init_lm_cache(cfg, n, dev)
    worst = 0.0
    with torch.no_grad():
        for t in range(steps):
            lane = np.zeros((s_dim, b_dim, cfg.max_tokens), np.int32)
            for b in range(b_dim):
                lane[:, b, :t] = [inv[u][perm[t][b]] for u in range(t)]
            tokens = torch.tensor([ys[a, perm[t][b], t] for a in range(s_dim)
                                   for b in range(b_dim)], device=dev)
            got = lm_step(model.params["lm"], cache, tokens,
                          torch.full((n,), t, device=dev),
                          torch.from_numpy(lane).to(dev),
                          torch.ones(n, dtype=torch.bool, device=dev), cfg)
            for a in range(s_dim):
                for b in range(b_dim):
                    gap = (got[a * b_dim + b] - want[a, perm[t][b]][t]).abs()
                    worst = max(worst, float(gap.max()))
    emit({"phase": "lm_step_vs_reference", "card": smi, "positions": steps,
          "hypotheses": n, "max_abs_err": worst, "tol": LM_STEP_TOL})
    if not worst <= LM_STEP_TOL:
        fail(f"the LM step is {worst} off the full forward")

    rate = cfg.sample_rate
    for c in counters:
        c.launches = 0
    with GraphCheck() as check:
        s2t = Speech2TextStreaming(model=model, beam_size=5, device=dev)
        rows = []
        for i, seconds in enumerate((4.0, 5.0, 6.0)):
            audio = synth_audio(seconds, seed=100 + i, rate=rate)
            _, nbest, lat = decode_chunked(s2t, audio, rate)
            yseq, _, score = nbest[0]
            if not math.isfinite(score) or len(yseq) < 2:
                fail(f"lm_path utterance {i}: bad best hypothesis {nbest[0]}")
            rows.append({"utterance": i, "hyp_len": int(len(yseq)),
                         "score": score, "p50_chunk_ms":
                             float(np.median(lat)) * 1e3})
        chunk = 8192
        streams = engine_path_streams(rate)
        engine = StreamingEngine(model, n_slots=8, beam_size=5,
                                 chunk_samples=chunk, device=dev)
        finals, tick_s, slot_of = drive_engine(engine, streams, chunk,
                                               sync=_sync(dev))
    launches = {c.__name__: c.launches for c in counters}
    session = Speech2TextStreaming(model=model, beam_size=5, device=dev)
    worst_rel = 0.0
    for k, st in enumerate(streams):
        ry, rx, rs = single_stream_final(session, st["audio"], chunk)
        ey, ex, es = finals[k]
        rel = abs(es - rs) / max(1.0, abs(rs))
        worst_rel = max(worst_rel, rel)
        if not (np.array_equal(ey, ry) and np.array_equal(ex, rx)
                and rel <= 1e-4):
            fail(f"lm_path stream {k}: the engine's final differs from the "
                 f"session's: {ey.tolist()} / {ry.tolist()}, {es} / {rs}")
    emit({"phase": "lm_path", "card": smi, "utterances": rows,
          "blocks_checked": check.blocks, "chunk_steps_checked": check.chunks,
          "encodes_checked": check.encodes, "streams": len(streams),
          "hyp_lens": [len(finals[k][0]) for k in range(len(streams))],
          "slots_reused": len(slot_of) - len(set(slot_of.values())),
          "p50_tick_ms": float(np.median(tick_s)) * 1e3,
          "max_score_rel_err": worst_rel,
          "hbm_bytes_per_stream": engine.hbm_bytes_per_stream(),
          "graph_bytes_per_stream": engine.graph_bytes_per_stream()})
    # ESPnet's conformer runs kernel A, never E.
    check_launches("lm_path", counters, launches,
                   zero=[c for c in counters
                         if c.__name__ == "rel_block_attention"])
    return launches


def tensor_tree(tree, dev):
    """A numpy tree of dicts as tensors on `dev`."""
    import torch

    if isinstance(tree, dict):
        return {k: tensor_tree(v, dev) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dev)


def engine_loops(engine) -> list:
    return ([engine._loop, engine._finalizer.loop]
            + [loop for _, loop in engine._compact.values()])


def loop_stats(loops) -> dict:
    """Beam steps per block, host syncs per block and step replays of the
    graphed runs of `loops`."""
    from speechcatcher_tpu_torch.decode import graphs

    blocks = sum(x.blocks for x in loops)
    steps = sum(x.steps for x in loops)
    return {"blocks": blocks, "steps": steps,
            "steps_per_block_mean": steps / max(blocks, 1),
            "steps_per_block_max": max((x.max_steps for x in loops),
                                       default=0),
            "syncs_per_block_graphed": sum(x.syncs for x in loops)
            / max(blocks, 1),
            # The eager loop reads any(stepping) before every step and
            # once more to stop.
            "syncs_per_block_eager": (steps + blocks) / max(blocks, 1),
            "step_replays": sum(x._graphs[1].replays for x in loops
                                if x._graphs),
            "steps_per_replay": graphs.STEPS_PER_REPLAY,
            "steps_per_block_hist":
                steps_per_block(loops)["steps_per_block_hist"]}


def runtime_calls(averages) -> dict:
    """Counts of the CUDA runtime calls the host made, from a profile's
    `key_averages()`: kernels it launched itself (cudaLaunchKernel and
    kin), graph launches, copies and waits."""
    import torch

    out = {"kernel_launches": 0, "graph_launches": 0, "memcpy": 0,
           "host_waits": 0}
    for e in averages:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if "LaunchKernel" in e.key:
            out["kernel_launches"] += e.count
        elif e.key == "cudaGraphLaunch":
            out["graph_launches"] += e.count
        elif e.key.startswith("cudaMemcpy"):
            out["memcpy"] += e.count
        elif e.key in ("cudaStreamSynchronize", "cudaEventSynchronize",
                       "cudaDeviceSynchronize"):
            out["host_waits"] += e.count
    return out


def device_share(averages, wall: float) -> dict:
    """Device busy time (kernels and copies on the card) and its idle
    share of `wall` seconds, from a profile's `key_averages()`."""
    import torch

    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.self_device_time_total > 0)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3)}


def graph_profiles(runs: dict, smi: str, encoder_type: str,
                   utterance_modes=("graphed", "eager"),
                   tick_modes=("graphed", "eager")) -> None:
    """One warm 6 s utterance (for each of `utterance_modes`) and 10 warm
    ticks of 8 slots (`tick_modes`) under torch.profiler, on the warm
    session and engine of each mode of `runs`: the device's idle share and
    the runtime calls the host made (kernels it issued itself, per
    tick)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speechcatcher_tpu_torch.synth import synth_audio

    for mode in utterance_modes:
        s2t = runs[mode][0]
        rate = s2t.model.cfg.sample_rate
        audio = synth_audio(6.0, seed=102, rate=rate)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode_chunked(s2t, audio, rate)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        averages = prof.key_averages()
        emit({"phase": "graph_profile_utterance", "mode": mode,
              "encoder_type": encoder_type, "audio_s": 6.0, "card": smi}
             | device_share(averages, wall) | runtime_calls(averages))
    for mode in tick_modes:
        engine = runs[mode][1]
        rate = engine.cfg.sample_rate
        chunk = engine.A
        streams = engine_streams(8, [(10 * chunk + 3000) / rate] * 8,
                                 [0] * 8, 2, 700, rate=rate)
        slots = [engine.acquire_slot() for _ in streams]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(10):
                engine.tick({s: st["audio"][i * chunk:(i + 1) * chunk]
                             for s, st in zip(slots, streams)})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        averages = prof.key_averages()
        calls = runtime_calls(averages)
        emit({"phase": "graph_profile_ticks", "mode": mode,
              "encoder_type": encoder_type, "n_slots": 8, "ticks": 10,
              "card": smi} | device_share(averages, wall) | calls
             | {"kernel_launches_per_tick": calls["kernel_launches"] / 10,
                "graph_launches_per_tick": calls["graph_launches"] / 10})
        engine.finalize_batch({s: None for s in slots})


def graph_timing(runs: dict, smi: str, encoder_type: str,
                 pairs: int = 3) -> None:
    """Tick p50/p95 of the engine path's ten streams and the RTF of a 6 s
    utterance, graphed and eager, in `pairs` interleaved pairs on the warm
    sessions and engines of `runs`; the graphed finals must equal the
    eager ones."""
    import numpy as np

    from speechcatcher_tpu_torch.synth import synth_audio

    s2t, engine = runs["graphed"]
    rate = s2t.model.cfg.sample_rate
    chunk = engine.A
    streams = engine_path_streams(rate)
    audio = synth_audio(6.0, seed=102, rate=rate)
    out = {mode: {"p50": [], "p95": [], "rtf": [], "finals": None}
           for mode in runs}
    for p in range(pairs):
        order = ("graphed", "eager") if p % 2 == 0 else ("eager", "graphed")
        for mode in order:
            s2t, engine = runs[mode]
            t0 = time.perf_counter()
            decode_chunked(s2t, audio, rate)
            out[mode]["rtf"].append((time.perf_counter() - t0) / 6.0)
            finals, tick_s, _ = drive_engine(engine, streams, chunk,
                                             sync=_sync(engine.device))
            out[mode]["finals"] = finals
            out[mode]["p50"].append(float(np.median(tick_s)) * 1e3)
            out[mode]["p95"].append(float(np.percentile(tick_s, 95)) * 1e3)
    for k, (gy, gx, gs) in out["graphed"]["finals"].items():
        ey, ex, es = out["eager"]["finals"][k]
        if not (np.array_equal(gy, ey) and np.array_equal(gx, ex)
                and gs == es):
            fail(f"graph_timing: stream {k}'s final differs between the "
                 f"graphs and the eager loop: {gy.tolist()} / {ey.tolist()}")
    emit({"phase": "graph_timing", "encoder_type": encoder_type,
          "pairs": pairs, "card": smi,
          "tick_p50_ms": {m: v["p50"] for m, v in out.items()},
          "tick_p95_ms": {m: v["p95"] for m, v in out.items()},
          "utterance_rtf": {m: v["rtf"] for m, v in out.items()},
          "finals_equal": True})


def dp_tick_ratio(engine, smi: str, mesh) -> None:
    """Tick p50 of the engine path's ten streams over dp = 2 replicas of 4
    slots on this card against the warm unsharded 8-slot `engine`, both
    graphed, in turns (unsharded, dp, dp, unsharded) after one pass of the
    dp engine that captures its graphs."""
    import numpy as np

    from speechcatcher_tpu_torch.parallel.serve_sharding import shard_engine
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    chunk = engine.A
    streams = engine_path_streams(engine.cfg.sample_rate)
    engines = {"unsharded": engine,
               "dp2": shard_engine(StreamingEngine(
                   engine.model, n_slots=8, beam_size=5,
                   chunk_samples=chunk, device=engine.device), mesh)}
    drive_engine(engines["dp2"], streams, chunk, sync=_sync(engine.device))
    p50 = {k: [] for k in engines}
    for name in ("unsharded", "dp2", "dp2", "unsharded"):
        _, tick_s, _ = drive_engine(engines[name], streams, chunk,
                                    sync=_sync(engine.device))
        p50[name].append(float(np.median(tick_s)) * 1e3)
    emit({"phase": "graph_dp_tick_ratio", "card": smi, "tick_p50_ms": p50,
          "dp2_over_unsharded": float(np.median(p50["dp2"])
                                      / np.median(p50["unsharded"]))})


def engine_path_streams(rate: int, mulaw: bool = False):
    """The engine path's ten streams (3 to 6 s, two a tick, every other one
    int16 or all mu-law, two finals through finalize())."""
    n = 10
    seconds = [3.0 + 3.0 * k / (n - 1) for k in range(n)]
    return engine_streams(n, seconds, starts=[k // 2 for k in range(n)],
                          int16_every=2, seed0=300, single=(3, 8), rate=rate,
                          mulaw=mulaw)


def k_choice(s2t, engine, smi: str, encoder_type: str) -> None:
    """Prices K (beam steps a replay) on the card: the masked step's and
    the readback's cost on the warm session's and engine's loops, over the
    steps per block of this encoder's token-rich fixture decode (session)
    and of the engine path (engine)."""
    from speechcatcher_tpu_torch.decode import graphs

    fixtures = {name: hist for name, (enc, hist) in FIXTURE_STEPS.items()
                if enc == encoder_type}
    rich = (CONFORMER_TOKENS_FIXTURE if encoder_type == "conformer"
            else TOKENS_FIXTURE).name
    if rich not in fixtures:
        fail(f"k_choice: {rich} was not replayed before")
    costs = {"session": replay_costs(s2t.beam_search.loop),
             "engine": replay_costs(engine._loop)}
    priced = {"token_rich_fixture": price_k(costs["session"],
                                            fixtures[rich]),
              "engine": price_k(costs["engine"],
                                dict(engine._loop.step_counts))}
    emit({"phase": "graph_k_choice", "encoder_type": encoder_type,
          "card": smi, "costs": costs,
          "fixture_steps_per_block": {
              name: {str(n): hist[n] for n in sorted(hist)}
              for name, hist in fixtures.items()},
          "cost_ms_per_block": priced,
          "k_in_use": graphs.STEPS_PER_REPLAY,
          "k_cheapest": {what: min(v, key=v.get)
                         for what, v in priced.items()}})


# What graph_timing's passes may add to the card's allocated memory: the
# leak it guards against is a compact set per final width, tens of MB each
# at flagship width.
HELD_GROWTH_LIMIT = 1 << 20


def graph_path(dev, counters, smi: str, encoder_type: str,
               dp_mesh=None, full_profile: bool = True) -> dict:
    """The block loop, the session's chunk step and the engine's encode as
    CUDA graphs at flagship width: a 6 s session utterance and the engine
    path's ten streams (their finals through finalize_batch and finalize)
    with every block, chunk step and encode held against the eager
    reference on the same inputs, bit-equal on every leaf; launch counts
    (B once per replayed step: K a replay); steps and host syncs per
    block; the graphs captured and their memory; the price of K; then
    profiles (an utterance graphed and eager; ticks graphed and, with
    `full_profile`, eager), timings, and (with `dp_mesh`)
    the dp = 2 tick ratio. Once ``capture_graphs`` ran, serving and
    decoding capture nothing more and hold no more memory; the session's
    graphs and pool bytes for 0.5 s chunks (and with `full_profile` for
    8192-sample chunks)."""
    import torch

    from speechcatcher_tpu_torch.decode import graphs
    from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
        ctc_forward_recursion,
    )
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    phase = "graph_path_" + encoder_type
    model = flagship_model(dev, seed=0, encoder_type=encoder_type)
    rate = model.cfg.sample_rate
    k = graphs.STEPS_PER_REPLAY
    captured0 = len(graphs.CAPTURED)
    for c in counters:
        c.launches = 0
    with GraphCheck() as check:
        s2t = Speech2TextStreaming(model=model, beam_size=5, device=dev)
        decode_chunked(s2t, synth_audio(6.0, seed=102, rate=rate), rate)
        session = loop_stats([s2t.beam_search.loop])
        session_eager_steps = check.eager_steps
        session_b = ctc_forward_recursion.launches
        engine = StreamingEngine(model, n_slots=8, beam_size=5, device=dev)
        drive_engine(engine, engine_path_streams(rate), 8192,
                     sync=_sync(dev))
        eng = loop_stats(engine_loops(engine))
    launches = {c.__name__: c.launches for c in counters}
    check_launches(phase, counters, launches,
                   zero=(counters[0] if encoder_type == "conformer"
                         else counters[1],))
    # B launches once a beam step, K steps a replay; the live steps (some
    # stream stepping) are the eager loop's steps.
    replays = session["step_replays"] + eng["step_replays"]
    live = session["steps"] + eng["steps"]
    if launches["ctc_forward_recursion"] != k * replays:
        fail(f"{phase}: B launched {launches['ctc_forward_recursion']} "
             f"times for {replays} replays of {k} steps")
    if live != check.eager_steps:
        fail(f"{phase}: {live} live steps in the graphs, "
             f"{check.eager_steps} in the eager loop")
    if session_b != k * session["step_replays"]:
        fail(f"{phase}: the session's B launches do not match its replays")
    new = graphs.CAPTURED[captured0:]
    by_name: dict = {}
    for g in new:
        key = g.name.split("(")[0] + g.name[g.name.index(")") + 1:]
        n_, b_ = by_name.get(key, (0, 0))
        by_name[key] = (n_ + 1, b_ + g.pool_bytes)
    emit({"phase": phase, "card": smi, "blocks_checked": check.blocks,
          "encodes_checked": check.encodes,
          "chunk_steps_checked": check.chunks, "bit_equal": True,
          "session": session | {"eager_steps": session_eager_steps},
          "engine": eng | {"eager_steps":
                           check.eager_steps - session_eager_steps},
          "launches": launches,
          "graphs_captured": len(new),
          "graph_pool_bytes": sum(g.pool_bytes for g in new),
          "graphs_by_kind": {key: {"count": v[0], "pool_bytes": v[1]}
                             for key, v in by_name.items()}})
    if check.blocks == 0 or check.encodes == 0 or check.chunks == 0:
        fail(f"{phase}: nothing went through the graphs")
    k_choice(s2t, engine, smi, encoder_type)
    # The same session and engine (warm, graphs captured: every encode and
    # compact width too) against an eager pair, warmed the same way.
    engine.capture_graphs()
    captured = len(graphs.CAPTURED)
    emit({"phase": phase + "_memory", "card": smi,
          "compact_widths": sorted(engine._compact),
          "hbm_bytes_per_stream": engine.hbm_bytes_per_stream(),
          "graph_bytes_per_stream": engine.graph_bytes_per_stream()})
    if sorted(engine._compact) != engine._compact_widths():
        fail(f"{phase}: compact sets {sorted(engine._compact)}, widths "
             f"{engine._compact_widths()}")
    eager = (make_eager(Speech2TextStreaming(model=model, beam_size=5,
                                             device=dev)),
             make_eager(StreamingEngine(model, n_slots=8, beam_size=5,
                                        device=dev)))
    decode_chunked(eager[0], synth_audio(6.0, seed=102, rate=rate), rate)
    drive_engine(eager[1], engine_path_streams(rate), 8192, sync=_sync(dev))
    runs = {"graphed": (s2t, engine), "eager": eager}
    graph_profiles(runs, smi, encoder_type,
                   tick_modes=("graphed", "eager") if full_profile
                   else ("graphed",))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    graph_timing(runs, smi, encoder_type)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(dev) - held
    emit({"phase": phase + "_held", "captured_while_serving":
          len(graphs.CAPTURED) - captured, "allocated_growth_bytes": grown,
          "limit_bytes": HELD_GROWTH_LIMIT})
    if len(graphs.CAPTURED) != captured or grown > HELD_GROWTH_LIMIT:
        fail(f"{phase}: serving after capture_graphs captured "
             f"{len(graphs.CAPTURED) - captured} graphs and grew the "
             f"allocated memory by {grown} bytes")
    engine_finals_held(engine, smi, phase)
    session_graphs(dev, s2t, smi, phase, also=(8192,) if full_profile else ())
    if dp_mesh is not None:
        dp_tick_ratio(engine, smi, dp_mesh)
    return launches


def engine_finals_held(engine, smi: str, phase: str) -> None:
    """finalize() at many carried fills on the warm `engine` after its
    capture_graphs: twelve streams of 0.4 to 6.3 s, each finalized alone
    with its own tail (the short-segment final included), capture nothing
    and hold no more memory."""
    import torch

    from speechcatcher_tpu_torch.decode import graphs

    dev = engine.device
    n = 12
    seconds = [round(0.4 + 0.537 * k, 3) for k in range(n)]
    streams = engine_streams(n, seconds, starts=[k // 4 for k in range(n)],
                             int16_every=3, seed0=330, single=range(n),
                             rate=engine.cfg.sample_rate)
    captured = len(graphs.CAPTURED)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    finals, _, _ = drive_engine(engine, streams, engine.A, sync=_sync(dev))
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(dev) - held
    emit({"phase": phase + "_finals_held", "streams_s": seconds,
          "tails": [len(st["audio"]) - (len(st["audio"]) - 1)
                    // engine.A * engine.A for st in streams],
          "captured_while_serving": len(graphs.CAPTURED) - captured,
          "allocated_growth_bytes": grown, "limit_bytes": HELD_GROWTH_LIMIT,
          "card": smi})
    if len(finals) != n:
        fail(f"{phase}: {len(finals)} of {n} streams finalized")
    if len(graphs.CAPTURED) != captured or grown > HELD_GROWTH_LIMIT:
        fail(f"{phase}: finalize after capture_graphs captured "
             f"{len(graphs.CAPTURED) - captured} graphs and grew the "
             f"allocated memory by {grown} bytes")


def session_graph_sizes(s2t) -> dict:
    """The graphs a session holds (chunk steps and block loop) and what
    their captures reserved, in all and by kind."""
    bs = s2t.beam_search
    held = list(bs.chunk._graphs.values()) + list(bs.loop._graphs or ())
    kinds: dict = {}
    for g in held:
        kind = kinds.setdefault(g.name.split("(")[0] + g.name[
            g.name.index(")") + 1:], {"count": 0, "pool_bytes": 0})
        kind["count"] += 1
        kind["pool_bytes"] += g.pool_bytes
    return {"graphs": len(held),
            "pool_bytes": sum(g.pool_bytes for g in held),
            "graphs_by_kind": kinds}


def session_graphs(dev, s2t, smi: str, phase: str, also=()) -> None:
    """``capture_graphs`` of the session's chunk size (0.5 s) on the warm
    graphed session `s2t`; then three utterances of other lengths capture
    nothing and hold no more memory. The graphs and pool bytes of a
    session of that chunk size, and of fresh sessions of the chunk sizes
    `also`, captured up front."""
    import torch

    from speechcatcher_tpu_torch.decode import graphs
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    model = s2t.model
    rate = model.cfg.sample_rate
    chunk = int(CHUNK_SECONDS * rate)
    t0 = time.perf_counter()
    signatures = s2t.capture_graphs(chunk)
    sizes = {chunk: {"signatures": signatures,
                     "capture_s": time.perf_counter() - t0}
             | session_graph_sizes(s2t)}
    captured = len(graphs.CAPTURED)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    for i, seconds in enumerate((2.7, 4.35, 7.9)):
        decode_chunked(s2t, synth_audio(seconds, seed=310 + i, rate=rate),
                       rate)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(dev) - held
    emit({"phase": phase + "_session_held", "chunk_samples": chunk,
          "utterances_s": [2.7, 4.35, 7.9],
          "captured_while_decoding": len(graphs.CAPTURED) - captured,
          "allocated_growth_bytes": grown, "limit_bytes": HELD_GROWTH_LIMIT,
          "card": smi})
    if len(graphs.CAPTURED) != captured or grown > HELD_GROWTH_LIMIT:
        fail(f"{phase}: decoding after capture_graphs({chunk}) captured "
             f"{len(graphs.CAPTURED) - captured} graphs and grew the "
             f"allocated memory by {grown} bytes")
    for samples in also:
        fresh = Speech2TextStreaming(model=model, beam_size=5, device=dev)
        t0 = time.perf_counter()
        signatures = fresh.capture_graphs(samples)
        sizes[samples] = ({"signatures": signatures,
                           "capture_s": time.perf_counter() - t0}
                          | session_graph_sizes(fresh))
        del fresh
    emit({"phase": phase + "_session_graphs", "card": smi,
          "by_chunk_samples": sizes})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", nargs="?", const="utterance",
                    choices=("utterance", "engine", "conformer", "tiling",
                             "recursion", "recognize", "train",
                             "train-memory", "train-in-process",
                             "mesh-step", "beam-step", "lm"),
                    help="profile one main-path utterance (default), "
                    "engine ticks at S=8, one conformer utterance, or the "
                    "attention kernels' device time under either tiling "
                    "at 1 to 32 windows, or the CTC recursion kernel's time "
                    "at 5 to 160 hypotheses, or recognize() on 70 s, "
                    "serial and batched, or a flagship train step of "
                    "either encoder, graphed and eager, or the train "
                    "step's and evaluate's memory at 4 s and 32 s, or the "
                    "graphed train paths with their profiles in one "
                    "process, or the eager step a mesh runs (one card, tp "
                    "= 2, the NCCL trainer), or kernels F and G and the "
                    "graphed beam step of the benchmark configurations "
                    "at 32 and 256 streams, or the LM configuration's "
                    "step, session and engine (lm_path), then stop")
    ap.add_argument("--precision", choices=PRECISIONS, default="float32",
                    help="the model of --profile, --profile engine and "
                    "--profile conformer: float32, that with only the CTC "
                    "log-prob ring in bfloat16 (ctc_ring_bf16), the serving "
                    "default (bfloat16 weights, decoder cache, CTC ring and "
                    "frame ring), or that with int8 encoder linears (int8) "
                    "or every eligible linear in int8 (int8_all)")
    args = ap.parse_args()
    faulthandler.enable()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.device import resolve_device
    from speechcatcher_tpu_torch.ops.kernels import _build
    from speechcatcher_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})
    lib = _build.library()
    emit({"phase": "build", "seconds": lib.build_seconds, "built": lib.built,
          "library": str(lib.path.relative_to(ROOT))})
    if args.profile == "beam-step":
        if optional_wrapper(ADD_LAYER_NORM) is not None:
            for row in check_add_layer_norm(dev):
                emit({"phase": "kernel", **row})
        if optional_wrapper(LANE_ATTENTION) is not None:
            for row in check_lane_attention(dev):
                emit({"phase": "kernel", **row})
        if optional_wrapper(CROSS_ATTENTION) is not None:
            for row in check_cross_attention(dev):
                emit({"phase": "kernel", **row})
        beam_step_costs(dev, smi)
        return 0
    counters, fns = kernel_counters()
    (block_attention, rel_block_attention, ctc_forward_recursion,
     ring_append_cols, ring_append_rows, add_layer_norm,
     lane_attention, cross_attention) = counters

    if args.profile == "lm":
        lm_path(dev, counters, smi)
        return 0
    if args.profile == "utterance":
        profile_utterance(dev, precision=args.precision)
        return 0
    if args.profile == "engine":
        profile_engine(dev, precision=args.precision)
        return 0
    if args.profile == "recognize":
        profile_recognize(dev)
        return 0
    if args.profile == "train":
        profile_train(dev)
        return 0
    if args.profile == "train-memory":
        profile_train_memory(dev, smi)
        return 0
    if args.profile == "train-in-process":
        profile_train_in_process(dev, smi)
        return 0
    if args.profile == "mesh-step":
        profile_mesh_step(dev, smi)
        return 0
    if args.profile == "conformer":
        profile_utterance(dev, encoder_type="conformer",
                          precision=args.precision)
        return 0
    cfg = flagship_config()
    if args.profile == "recursion":
        profile_recursion(dev, cfg)
        return 0
    if args.profile == "tiling":
        for rel in (False, True):
            for n_blocks in (1, 2, 3, 4, 6, 8, 11, 16, 24, 32):
                k = check_attention(dev, cfg, n_blocks, rel)
                emit({"phase": "profile_tiling"} | {key: k[key] for key in (
                    "name", "shape", "rows_per_warp", "device_us",
                    "device_us_by_rows_per_warp")})
        return 0
    # Main-path shapes: 0.5 s chunks give the encoder one block per step
    # mostly, two on some; the beam is 5; each block appends hop_size frames.
    # The engine's ring appends are timed at its enc_out shape with 8 slots;
    # the engine runs 8 (a window per slot) to 8 x ENGINE_MAXB attention
    # windows per layer.
    checks = [
        check_attention(dev, cfg, n_blocks, rel)
        for rel in (False, True) for n_blocks in (2, 8, 8 * ENGINE_MAXB)]
    # recognize_file's batched engine runs 4 slots: 4 to 8 windows.
    checks.append(check_attention(dev, cfg, 4, rel=False))
    # A model directory without a config.yaml loads with the default 4
    # heads: one window of 4 heads of 128.
    checks.append(check_attention(dev, cfg.replace(encoder_heads=4), 1,
                                  rel=False))
    # A tp=2 rank's attention, 4 heads of 64, at the tp engine's 4 slots x
    # ENGINE_MAXB windows; D at a dp=2 replica's 4 of the 8 slots.
    checks += [check_attention(dev, tp_attention_config(cfg),
                               TP_STREAMS * ENGINE_MAXB, rel)
               for rel in (False, True)]
    checks.append(check_ring_append_rows(dev, cfg, n_slots=8 // TP))
    # The session's D appends: one slot into its carries and its ring.
    checks.append(check_ring_append_rows_session(
        dev, cfg, int(CHUNK_SECONDS * cfg.sample_rate)))
    kernels = [
        check_attention(dev, cfg, n_blocks=1, rel=False),
        check_attention(dev, cfg, n_blocks=1, rel=True),
        check_ctc_recursion(dev, cfg, beam=5),
        check_ring_append(dev, cfg, n_new=cfg.hop_size, n_slots=8),
        check_ring_append_rows(dev, cfg, n_slots=8),
    ]
    fused_rows = check_add_layer_norm(dev)
    checks += fused_rows[1:]
    kernels.append(fused_rows[0])
    # G: every case checked, the drain's width-32 flagship call at a
    # typical position timed.
    checks += check_lane_attention(dev, timed=False)
    kernels += check_lane_attention(dev, widths=LANE_ATTENTION_WIDTHS[:1],
                                    sizes=(96,), positions=(32,))[:1]
    # H: every case checked, the drain's width-32 flagship call timed.
    checks += check_cross_attention(dev, timed=False)
    kernels += check_cross_attention(
        dev, widths=(CROSS_ATTENTION_WIDTHS[0][:5] + ((32,),),),
        small=())[:1]
    for k in checks + kernels:
        emit({"phase": "kernel", **k})
    check_gemm(dev, cfg)
    worst = {}
    for k in checks + kernels:
        worst[k["name"]] = max(worst.get(k["name"], 0.0), k["max_abs_err"])
    # dp=2: two engine replicas of 4 slots on this one card.
    dp_mesh = make_mesh(TP, devices=[dev] * TP)
    # Each path runs every kernel but those it must not: the transformer
    # never runs E, the conformer never A. The session appends its encoder
    # frames and carries with D, at one slot.
    model = flagship_model(dev, seed=0)
    by_path = {"utterance": main_path(
        dev, counters, model, zero=(rel_block_attention,))}
    fixture_replay(dev)
    fixture_replay(dev, TOKENS_FIXTURE)
    small_reference(dev)
    engine_finals = {}
    by_path["engine"] = engine_path(dev, counters, model,
                                    zero=(rel_block_attention,),
                                    finals_out=engine_finals)
    by_path["dp_engine"] = engine_path(
        dev, counters, model, phase="dp_engine_path",
        zero=(rel_block_attention,), mesh=dp_mesh, reference=engine_finals)
    by_path["graph_path"] = graph_path(dev, counters, smi, "transformer",
                                       dp_mesh=dp_mesh)
    engine_fixture_replay(dev)
    engine_load_point(dev, model)
    # The app and serving layer on the float32 flagship that talks: no
    # exception caught, no slot quarantined, no ERROR record.
    talker = flagship_model(dev, seed=TALKER_SEED, biases=TALKER_BIASES)
    with ErrorRecords() as errors:
        by_path.update(recognize_path(dev, counters, talker, smi))
        server_finals = {}
        by_path["server"] = server_path(dev, counters, talker, smi,
                                        reference=server_finals)
        by_path["dp_server"] = server_path(
            dev, counters, talker, smi, phase="dp_server_path",
            mesh=dp_mesh, reference=server_finals)
    if errors.records:
        fail(f"ERROR records on the serving paths: {errors.records[:5]}")
    del talker
    # The precision modes. Each session mode casts a float32 model of its
    # own; the engine serves the serving default over the mu-law wire.
    for dtype in ("bfloat16", "int8", "int8-all"):
        key = dtype.replace("-", "_")
        by_path["utterance_" + key] = main_path(
            dev, counters, flagship_model(dev, seed=0),
            phase="precision_path_" + key, dtype=dtype, lengths=(5.0, 6.0),
            zero=(rel_block_attention,))
    serving = flagship_model(dev, seed=0, precision="serving_default")
    by_path["engine_serving_default"] = engine_path(
        dev, counters, serving, phase="precision_engine_path",
        zero=(rel_block_attention,), mulaw=True,
        score_tol=BF16_STORAGE_SCORE_TOL)
    precision_fixture_replay(dev)
    model_dir_path(dev)
    precision_turns(dev, {"float32": model, "serving_default": serving})
    del model, serving
    conformer = flagship_model(dev, seed=0, encoder_type="conformer")
    by_path["conformer_utterance"] = main_path(
        dev, counters, conformer, phase="conformer_path",
        zero=(block_attention,))
    by_path["conformer_utterance_bfloat16"] = main_path(
        dev, counters, flagship_model(dev, seed=0, encoder_type="conformer"),
        phase="precision_conformer_path_bfloat16", dtype="bfloat16",
        lengths=(5.0, 6.0), zero=(block_attention,))
    fixture_replay(dev, CONFORMER_FIXTURE, encoder_type="conformer",
                   tol=1e-5)
    fixture_replay(dev, CONFORMER_TOKENS_FIXTURE, encoder_type="conformer")
    small_reference(dev, encoder_type="conformer")
    engine_finals = {}
    by_path["conformer_engine"] = engine_path(
        dev, counters, conformer, phase="conformer_engine_path",
        zero=(block_attention,), finals_out=engine_finals)
    by_path["dp_conformer_engine"] = engine_path(
        dev, counters, conformer, phase="dp_conformer_engine_path",
        zero=(block_attention,), mesh=dp_mesh, reference=engine_finals)
    by_path["conformer_graph_path"] = graph_path(dev, counters, smi,
                                                 "conformer",
                                                 full_profile=False)
    del conformer
    # ESPnet's conformer with its Transformer LM at the published widths.
    by_path["lm"] = lm_path(dev, counters, smi)
    # Training and offline greedy decode: A and E through their autograd
    # Functions at the training shapes, B, C and D refusing grad, then the
    # paths.
    grad_rows = [attention_grad(dev, cfg, n, rel) for rel in (False, True)
                 for n in TRAIN_WINDOWS]
    for row in grad_rows:
        worst[row["name"]] = max(worst[row["name"]],
                                 row["forward_max_abs_err"])
    refuse_grad_on_card(dev)
    backward = {}
    for path, run in (("train", functools.partial(
            graphed_train_path, encoder_type="transformer")),
                      ("conformer_train", functools.partial(
                          graphed_train_path, encoder_type="conformer")),
                      ("greedy", greedy_path)):
        got = run(dev, counters, fns, smi)
        by_path[path] = {c.__name__: got[c.__name__] for c in counters}
        for f in fns:
            key = f.__name__ + ".backward_launches"
            backward[key] = backward.get(key, 0) + got[key]
    train_profiles(smi)
    # tp=2 on two gloo ranks of this card: the collectives, the train step
    # and the engine.
    got, by_path["tp_engine"] = tp_paths(dev, counters, smi)
    by_path["tp_train"] = {c.__name__: got[c.__name__] for c in counters}
    for f in fns:
        key = f.__name__ + ".backward_launches"
        backward[key] += got[key]
    train_vs_cpu(dev)
    nccl_trainer(dev, train_cli(dev))
    backward_of = {"block_attention": "BlockAttentionFn.backward_launches",
                   "rel_block_attention":
                       "RelBlockAttentionFn.backward_launches"}
    summary = []
    for k in kernels:
        name = k["name"]
        summary.append({key: k[key] for key in (
            "name", "route", "source", "replaces")} | {
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": worst[name],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]} | ({
            # A and E: backwards on the training paths and the training
            # shapes' rows of attention_grad.
            "backward_launches": backward[backward_of[name]],
            "train_rows": [{key: r[key] for key in (
                "shape", "ms", "device_us", "bound_ms", "bound_by",
                "sdpa_ms", "plain_ms", "backward_ms")}
                for r in grad_rows if r["name"] == name]}
            if name in backward_of else {}) | {
            # B on bfloat16 rows beside the float32 form.
            key: k[key] for key in ("device_us", "ms_bf16", "device_us_bf16",
                                    "bound_ms_bf16") if "ms_bf16" in k})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
