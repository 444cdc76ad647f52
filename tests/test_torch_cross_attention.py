"""Kernel H (``ops.kernels.cross_attention``) on the CPU: its plain twin and
its plan, and its use in ``decoder_step``.

- ``cross_attention`` through the twin is bit-equal to the
  composition the beam step ran before the kernel (kept below as
  ``_composed``, with the mask it was handed built from ``enc_len`` as
  ``decoder_step`` built it), for float32 and bfloat16 K/V, beams 1, 3 and
  5, int32 and int64 ``enc_len``, and streams at ``enc_len`` 0, 1, T - 1
  and T.
- What the kernel computes (only the rows below ``enc_len``) is the twin's
  function: a float64 model of it agrees with the twin, ``enc_len`` 0
  gives zeros, and other values in the rows at t >= enc_len change no
  output.
- The plan refuses what the kernel does not take before the CPU/CUDA
  branch; operands that require grad raise.
- One ``decoder_step`` calls the op once a layer, with the step's
  ``enc_len``.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from speechcatcher_tpu_torch.config import flagship_config, tiny_config
from speechcatcher_tpu_torch.models import decoder as dec
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.ops.kernels import cross_attention as cam
from speechcatcher_tpu_torch.ops.kernels.block_attention import MASK_MIN
from speechcatcher_tpu_torch.ops.kernels.cross_attention import (
    cross_attention,
    cross_attention_plain,
)


def _composed(q, mk, mv, valid):
    """The beam step's cross-attention as the decoder composed it before
    kernel H, verbatim."""
    s, h, t, dk = mk.shape
    n = q.shape[0]
    b = n // s
    qh = q.reshape(s, b, h, dk).transpose(1, 2).to(mk.dtype).float()
    scores = torch.matmul(qh, mk.float().transpose(2, 3)) / math.sqrt(dk)
    keep = valid[:, None, None, :]
    scores = torch.where(keep, scores, MASK_MIN)
    attn = torch.softmax(scores, dim=-1)
    attn = torch.where(keep, attn, 0.0)
    out = torch.matmul(attn.to(mv.dtype).float(), mv.float())
    return out.transpose(1, 2).reshape(n, h * dk)


def _rows(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def _operands(rng, s, beam, h, t, dk, kv_dtype):
    q = _rows(rng, s * beam, h * dk)
    mk = _rows(rng, s, h, t, dk).to(kv_dtype)
    mv = _rows(rng, s, h, t, dk).to(kv_dtype)
    return q, mk, mv


# Streams at the edges: none visible, one row, all but the last, all.
EDGES = (0, 1, 9, 10)


@pytest.mark.parametrize("len_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("beam", [1, 3, 5])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_the_twin_is_the_composition_before_bit_for_bit(kv_dtype, beam,
                                                        len_dtype):
    rng = np.random.default_rng(beam)
    t, h, dk = 10, 2, 8
    q, mk, mv = _operands(rng, len(EDGES), beam, h, t, dk,
                          getattr(torch, kv_dtype))
    enc_len = torch.tensor(EDGES, dtype=len_dtype)
    valid = torch.arange(t)[None, :] < enc_len.long()[:, None]
    got = dec.cross_attention(q, mk, mv, enc_len)
    want = _composed(q, mk, mv, valid)
    assert got.dtype == torch.float32 and got.shape == (len(EDGES) * beam,
                                                        h * dk)
    assert np.array_equal(_bits(got), _bits(want))


def _model_out(q, mk, mv, enc_len):
    """What H computes, in float64 numpy: for each stream, head and query
    the softmax over the rows t < enc_len alone (the query rounded to the
    K/V dtype, the weights to the V dtype), zeros where enc_len is 0."""
    s, h, t, dk = mk.shape
    beam = q.shape[0] // s
    qr = q.to(mk.dtype).double().numpy().reshape(s, beam, h, dk)
    k, v = mk.double().numpy(), mv.double().numpy()
    out = np.zeros((s, beam, h, dk))
    for i in range(s):
        n = min(int(enc_len[i]), t)
        if n == 0:
            continue
        for j in range(h):
            sc = qr[i, :, j] @ k[i, j, :n].T / math.sqrt(dk)
            w = np.exp(sc - sc.max(axis=1, keepdims=True))
            w = torch.from_numpy(w / w.sum(axis=1, keepdims=True))
            w = w.to(mv.dtype).double().numpy()
            out[i, :, j] = w @ v[i, j, :n]
    return out.reshape(s * beam, h * dk)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_the_twin_reads_only_the_rows_below_enc_len(kv_dtype):
    rng = np.random.default_rng(7)
    s, beam, t, h, dk = 5, 3, 12, 2, 8
    dtype = getattr(torch, kv_dtype)
    q, mk, mv = _operands(rng, s, beam, h, t, dk, dtype)
    enc_len = torch.tensor([0, 3, 11, 12, 40])
    got = cross_attention(q, mk, mv, enc_len)
    np.testing.assert_allclose(got.numpy(), _model_out(q, mk, mv, enc_len),
                               rtol=1e-5, atol=1e-5)
    # The float64 twin, the card's reference, is the same function.
    ref = cross_attention_plain(q.double(), mk, mv, enc_len)
    assert ref.dtype == torch.float64
    np.testing.assert_allclose(ref.numpy(), _model_out(q, mk, mv, enc_len),
                               rtol=1e-6, atol=1e-6)
    # enc_len 0: exact zeros.
    assert not bool(got[:beam].any())
    # Other finite values at t >= enc_len change nothing, to the bit.
    hidden = (torch.arange(t)[None, :] >= enc_len[:, None])[:, None, :, None]
    other_k = torch.where(hidden, 1e3 * _rows(rng, s, h, t, dk),
                          mk.float()).to(dtype)
    other_v = torch.where(hidden, 1e3 * _rows(rng, s, h, t, dk),
                          mv.float()).to(dtype)
    again = cross_attention(q, other_k, other_v, enc_len)
    assert np.array_equal(_bits(again), _bits(got))


def _refused(**over):
    s, beam, h, t, dk = 2, 3, 2, 16, 8
    args = {"q": torch.zeros(s * beam, h * dk),
            "mk": torch.zeros(s, h, t, dk), "mv": torch.zeros(s, h, t, dk),
            "enc_len": torch.zeros(s, dtype=torch.int64)}
    args.update(over)
    return args


def _kv(s=2, h=2, t=16, dk=8, beam=3, dtype=torch.float32):
    return dict(q=torch.zeros(s * beam, h * dk),
                mk=torch.zeros(s, h, t, dk, dtype=dtype),
                mv=torch.zeros(s, h, t, dk, dtype=dtype))


REFUSED = {
    "dk_6": _kv(dk=6),
    "dk_12": _kv(dk=12),
    "dk_20": _kv(dk=20),
    "dk_260": _kv(dk=260),
    "beam_12_over_4096_rows_at_dk_256": _kv(s=1, h=1, t=4096, dk=256,
                                            beam=12),
    "kv_float16": _kv(dtype=torch.float16),
    "mv_other_dtype": dict(mv=torch.zeros(2, 2, 16, 8,
                                          dtype=torch.bfloat16)),
    "mv_other_shape": dict(mv=torch.zeros(2, 2, 15, 8)),
    "mv_other_strides": dict(
        mv=torch.zeros(2, 16, 2, 8).transpose(1, 2)),
    "mk_inner_stride_2": dict(mk=torch.zeros(2, 2, 16, 16)[..., ::2]),
    "q_inner_stride_2": dict(q=torch.zeros(6, 32)[:, ::2]),
    "q_float64": dict(q=torch.zeros(6, 16, dtype=torch.float64)),
    "q_bfloat16": dict(q=torch.zeros(6, 16, dtype=torch.bfloat16)),
    "q_other_width": dict(q=torch.zeros(6, 24)),
    "q_not_streams_x_beam": dict(q=torch.zeros(5, 16)),
    "q_3d": dict(q=torch.zeros(2, 3, 16)),
    "mk_3d": dict(mk=torch.zeros(2, 16, 16)),
    "enc_len_float": dict(enc_len=torch.zeros(2)),
    "enc_len_int16": dict(enc_len=torch.zeros(2, dtype=torch.int16)),
    "enc_len_other_streams": dict(enc_len=torch.zeros(3,
                                                      dtype=torch.int64)),
    "enc_len_2d": dict(enc_len=torch.zeros(2, 1, dtype=torch.int64)),
    "no_streams": dict(q=torch.zeros(0, 16), mk=torch.zeros(0, 2, 16, 8),
                       mv=torch.zeros(0, 2, 16, 8),
                       enc_len=torch.zeros(0, dtype=torch.int64)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_plan_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        cross_attention(**_refused(**REFUSED[case]))


@pytest.mark.parametrize("h,dk,beam,s,t", [
    (8, 64, 3, 32, 832), (8, 64, 3, 256, 832), (4, 64, 3, 256, 832),
    (4, 64, 5, 1, 832), (4, 64, 10, 8, 832), (2, 64, 3, 4, 832),
    (2, 8, 3, 2, 832), (2, 8, 5, 4, 832), (1, 8, 1, 1, 832),
    (4, 32, 3, 2, 832), (2, 128, 3, 2, 832), (1, 256, 2, 2, 832),
    (4, 128, 5, 4, 2112), (1, 256, 11, 1, 4096), (4, 16, 3, 4, 832),
    (4, 4, 3, 2, 160)])
def test_the_widths_and_beams_the_decoders_run_are_planned(h, dk, beam, s,
                                                           t):
    """Both benchmark configurations (dk 64, 8 and 4 heads) and their tp =
    2 shares at the ring's 832 rows, the session's beam 5 and the
    endpointing default 10, the tiny (dk 8) and the card tests' widths; a
    model directory without a config.yaml (4 heads of 128, a 2048-frame
    ring: past 48 KB of shared memory), the largest beam at dk 256 over
    4096 rows, the card tests' 64-wide flagship (4 heads of 16) and the
    tiny configuration with 4 heads (dk 4, a model directory's)."""
    args = _kv(s=s, h=h, t=t, dk=dk, beam=beam)
    enc_len = torch.full((s,), 400, dtype=torch.int32)
    got = cross_attention(**args, enc_len=enc_len)
    assert got.shape == (s * beam, h * dk)


@pytest.mark.parametrize("dk,group", [(4, 1), (8, 1), (16, 1), (32, 2),
                                      (64, 4), (128, 8), (256, 16)])
def test_lanes_per_row(dk, group):
    assert cam.lanes_per_row(dk) == group
    assert dk // (4 * group) in (1, 2, 4)     # the kernel's instantiations


@pytest.mark.parametrize("blocks,want", [(8, 8), (256, 8), (263, 8),
                                         (264, 4), (2048, 4)])
def test_warps_per_block(blocks, want):
    assert cam.warps_per_block(blocks) == want


def test_the_plan_of_the_main_path_layout():
    """``head_major``'s (S, h, T, dk) K/V and the decoder's (N, h·dk)
    query: the strides the kernel steps by."""
    s, beam, h, t, dk = 4, 3, 8, 832, 64
    kv = dec.head_major(torch.zeros(s, t, h * dk), h, torch.bfloat16)
    args = cam._plan_args(torch.zeros(s * beam, h * dk), kv, kv,
                          torch.zeros(s, dtype=torch.int32))
    assert (args.q_ns, args.kv_ss, args.kv_hs, args.kv_ts) == (
        h * dk, h * t * dk, t * dk, dk)
    assert (args.s, args.h, args.t, args.dk, args.beam) == (s, h, t, dk,
                                                            beam)
    assert (args.group, args.warps, args.kv_bytes, args.len_bytes) == (
        4, 8, 2, 4)
    assert args.smem_bytes == cam.shared_bytes(beam, t, dk, 8) == 4 * (
        3 * (64 + 832) + 8 * 4 * 64)
    assert args.sqrt_dk == pytest.approx(8.0)


def test_operands_that_require_grad_raise():
    args = _refused()
    args["q"].requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        cross_attention(**args)
    with torch.no_grad():
        cross_attention(**args)


@pytest.mark.parametrize("width", ["tiny", "flagship"])
def test_decoder_step_attends_through_the_kernel_once_a_layer(width,
                                                              monkeypatch):
    cfg = (tiny_config() if width == "tiny"
           else flagship_config(encoder_layers=1, max_tokens=16,
                                max_enc_frames=64))
    model = ASRModel.random_init(cfg, seed=2, device="cpu")
    calls = []

    def counted(q, mk, mv, enc_len):
        calls.append((tuple(q.shape), tuple(mk.shape), mv.dtype,
                      enc_len.tolist()))
        return cross_attention_plain(q, mk, mv, enc_len)

    monkeypatch.setattr(dec, "cross_attention", counted)
    beam, s = 2, 2
    n = beam * s
    rng = np.random.default_rng(1)
    cache = dec.init_decoder_cache(cfg, n, torch.device("cpu"))
    memory = _rows(rng, s, 20, cfg.encoder_dim)
    logp, _ = dec.decoder_step(
        model.params["decoder"], model.dec_pe, cache, memory,
        torch.zeros(n, dtype=torch.int32), torch.tensor([0, 1, 2, 3]),
        torch.tensor([20, 12]), torch.zeros(s, beam, cfg.max_tokens,
                                            dtype=torch.int32),
        torch.ones(n, dtype=torch.bool), cfg, beam)
    d, heads = cfg.decoder_dim, cfg.decoder_heads
    assert calls == [((n, d), (s, heads, 20, d // heads), torch.float32,
                      [20, 12])] * cfg.decoder_layers
    assert bool(torch.isfinite(logp).all())
