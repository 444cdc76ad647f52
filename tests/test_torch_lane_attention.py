"""Kernel G (``ops.kernels.lane_attention``) on the CPU: its plain twin and
its plan, and its use in ``decoder_step``.

- ``_attend_cached_lane`` through the twin is bit-equal to the composition
  the beam step ran before the kernel (kept below as ``_composed``), at
  the tiny width and at d 256 / 4 heads and d 512 / 8 heads, for float32
  and bfloat16 caches and beams 1 and 3, with positions 0 (the self column
  alone), inside the history, Lmax - 1 and past Lmax, and lane maps that
  branch mid-history.
- What the kernel computes (only the rows below ``pos``, the softmax over
  them and the self row) is the twin's function: a float64 model of it
  agrees with the twin, and rows at t >= pos filled with 1e30 change no
  output.
- The plan refuses what the kernel does not take before the CPU/CUDA
  branch; operands that require grad raise.
- One ``decoder_step`` calls the op once a layer.

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
from speechcatcher_tpu_torch.ops.kernels import lane_attention as lam
from speechcatcher_tpu_torch.ops.kernels.block_attention import MASK_MIN
from speechcatcher_tpu_torch.ops.kernels.lane_attention import (
    lane_attention,
    lane_attention_plain,
)
from speechcatcher_tpu_torch.ops.layers import dense_weight
from speechcatcher_tpu_torch.parallel.tp import local_heads


def _composed(q, hh, hn_self, p_attn, lane, hist_valid, beam, n_head):
    """The beam step's lane self-attention as the decoder composed it
    before kernel G, verbatim."""
    n, t, d = hh.shape
    s = n // beam
    h = local_heads(n_head)
    dk = d // n_head
    wk = dense_weight(p_attn["linear_k"]).reshape(h, dk, d)
    wv = dense_weight(p_attn["linear_v"]).reshape(h, dk, d)
    qk = torch.einsum("nhk,hkd->nhd", q.reshape(n, h, dk), wk)
    hhl = hh.float().reshape(s, beam, t, d)
    idx = lane.long()[..., None].expand(s, beam, t, d)
    rows = torch.gather(hhl, 1, idx).reshape(n, t, d)
    scores = torch.einsum("nhd,ntd->nht", qk, rows) / math.sqrt(dk)
    scores = torch.where(hist_valid[:, None, :], scores, MASK_MIN)
    self_score = torch.einsum("nhd,nd->nh", qk, hn_self) / math.sqrt(dk)
    scores = torch.cat([scores, self_score[:, :, None]], dim=2)
    attn = torch.softmax(scores, dim=-1)
    hist_attn = torch.where(hist_valid[:, None, :], attn[:, :, :t], 0.0)
    u = torch.einsum("nht,ntd->nhd", hist_attn, rows)
    u = u + attn[:, :, t][:, :, None] * hn_self[:, None, :]
    out = torch.einsum("nhd,hkd->nhk", u, wv)
    bias = p_attn["linear_v"].get("bias")
    if bias is not None:
        out = out + bias.reshape(h, dk)
    return out.reshape(n, h * dk)


def _rows(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().view(np.uint32)


def _lanes(rng, s, beam, lmax):
    """A lane map whose hypotheses share a prefix and branch mid-history:
    lane 0 up to a stream's branch point, then a random parent a row."""
    lane = rng.integers(0, beam, size=(s, beam, lmax)).astype(np.int32)
    for si in range(s):
        lane[si, :, :int(rng.integers(1, lmax))] = 0
    return torch.from_numpy(lane)


def _positions(s, beam, lmax):
    """One hypothesis at each of 0, 1, Lmax // 2, Lmax - 1, Lmax and
    Lmax + 3, round the (S, B) grid."""
    cycle = [0, 1, lmax // 2, lmax - 1, lmax, lmax + 3]
    return torch.tensor([cycle[i % len(cycle)] for i in range(s * beam)],
                        dtype=torch.int64)


def _self_attn(rng, d):
    return {name: {"weight": _rows(rng, d, d) / math.sqrt(d),
                   "bias": 0.1 * _rows(rng, d)}
            for name in ("linear_k", "linear_v")}


WIDTHS = {"tiny": (tiny_config().decoder_dim, tiny_config().decoder_heads),
          "d256_h4": (256, 4), "d512_h8": (512, 8)}


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_twin_is_the_composition_it_replaces(width, cache_dtype, beam):
    d, heads = WIDTHS[width]
    s, lmax = 4, 12
    n = s * beam
    rng = np.random.default_rng(d + beam)
    p = _self_attn(rng, d)
    q, hn = _rows(rng, n, d), _rows(rng, n, d)
    hh = _rows(rng, n, lmax, d).to(getattr(torch, cache_dtype))
    lane = _lanes(rng, s, beam, lmax)
    pos = _positions(s, beam, lmax)
    hist = torch.arange(lmax)[None, :] < pos[:, None]
    got = dec._attend_cached_lane(q, hh, hn, p, lane, pos, heads)
    want = _composed(q, hh, hn, p, lane, hist, beam, heads)
    assert np.array_equal(_bits(got), _bits(want))


def _model_u(qk, cache, hn_self, lane, pos, dk):
    """What the kernel computes, in float64: for t < min(pos, Lmax) the row
    at cache[s·B + lane[s, b, t], t], the softmax over those rows' scores
    and the self row's, the weighted sum; no other row is read."""
    qk, cache, hn = (x.double().numpy() for x in (qk, cache.float(),
                                                   hn_self))
    lane, pos = lane.numpy(), pos.numpy()
    s_dim, beam, lmax = lane.shape
    u = np.zeros(qk.shape)
    for n in range(qk.shape[0]):
        s, b = divmod(n, beam)
        valid = int(min(max(pos[n], 0), lmax))
        rows = np.stack([cache[s * beam + lane[s, b, t], t]
                         for t in range(valid)] + [hn[n]])
        scores = qk[n] @ rows.T / math.sqrt(dk)
        w = np.exp(scores - scores.max(axis=1, keepdims=True))
        u[n] = (w / w.sum(axis=1, keepdims=True)) @ rows
    return u


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_the_twin_reads_only_the_history_below_pos(cache_dtype):
    rng = np.random.default_rng(11)
    s, beam, lmax, h, d, dk = 4, 3, 10, 4, 32, 8
    n = s * beam
    qk, hn = _rows(rng, n, h, d) / 2, _rows(rng, n, d)
    cache = _rows(rng, n, lmax, d).to(getattr(torch, cache_dtype))
    lane = _lanes(rng, s, beam, lmax)
    pos = torch.tensor([0, 1, 5, 9, 10, 14, 3, 7, 2, 4, 4, 8])
    got = lane_attention(qk, cache, hn, lane, pos, dk)
    np.testing.assert_allclose(got.numpy(),
                               _model_u(qk, cache, hn, lane, pos, dk),
                               rtol=1e-5, atol=1e-5)
    # A stream's hypotheses share their position in the beam search: rows
    # at t >= pos, of every lane of the stream, are never read.
    pos = torch.tensor([0, 4, 9, 13]).repeat_interleave(beam)
    got = lane_attention(qk, cache, hn, lane, pos, dk)
    hidden = torch.arange(lmax)[None, :] >= pos[:, None]
    poisoned = torch.where(hidden[:, :, None], 1e30,
                           cache.float()).to(cache.dtype)
    again = lane_attention(qk, poisoned, hn, lane, pos, dk)
    assert np.array_equal(_bits(again), _bits(got))
    # pos 0: the self row alone, whatever the cache holds.
    assert torch.equal(got[:beam], hn[:beam, None, :].expand(beam, h, d))


def _refused(**over):
    n, h, d, lmax, s = 6, 2, 32, 8, 2
    args = {"qk": torch.zeros(n, h, d), "cache": torch.zeros(n, lmax, d),
            "hn_self": torch.zeros(n, d),
            "lane": torch.zeros(s, n // s, lmax, dtype=torch.int32),
            "pos": torch.zeros(n, dtype=torch.int64), "dk": 16}
    args.update(over)
    return args


def _width(d, h=2, lmax=8, n=6):
    return dict(qk=torch.zeros(n, h, d), cache=torch.zeros(n, lmax, d),
                hn_self=torch.zeros(n, d),
                lane=torch.zeros(2, n // 2, lmax, dtype=torch.int32))


REFUSED = {
    "d_200": _width(200),
    "d_6": _width(6),
    "hd_8192": _width(1024, h=8),
    "h_64": _width(16, h=64),
    "d_2048": _width(2048, h=1),
    "lmax_1024": _width(32, lmax=1024),
    "shared_memory_above_48k": _width(128, h=32, lmax=512),
    "qk_inner_stride_2": dict(qk=torch.zeros(6, 2, 64)[:, :, ::2]),
    "cache_inner_stride_2": dict(cache=torch.zeros(6, 8, 64)[:, :, ::2]),
    "hn_transposed": dict(hn_self=torch.zeros(32, 6).t()),
    "qk_float64": dict(qk=torch.zeros(6, 2, 32, dtype=torch.float64)),
    "cache_float16": dict(cache=torch.zeros(6, 8, 32, dtype=torch.float16)),
    "hn_bfloat16": dict(hn_self=torch.zeros(6, 32, dtype=torch.bfloat16)),
    "lane_int64": dict(lane=torch.zeros(2, 3, 8, dtype=torch.int64)),
    "lane_not_n": dict(lane=torch.zeros(2, 2, 8, dtype=torch.int32)),
    "lane_other_lmax": dict(lane=torch.zeros(2, 3, 9, dtype=torch.int32)),
    "pos_int32": dict(pos=torch.zeros(6, dtype=torch.int32)),
    "pos_strided": dict(pos=torch.zeros(12, dtype=torch.int64)[::2]),
    "cache_other_n": dict(cache=torch.zeros(5, 8, 32)),
    "dk_0": dict(dk=0),
    "qk_2d": dict(qk=torch.zeros(6, 64)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_plan_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises((ValueError, TypeError)):
        lane_attention(**_refused(**REFUSED[case]))


def test_the_widths_the_decoders_run_are_planned():
    """Both benchmark configurations and their tp = 2 shares, the tiny and
    the small card-test widths."""
    for h, d in ((8, 512), (4, 512), (4, 256), (2, 256), (2, 16), (4, 64)):
        lane_attention(**_refused(**_width(d, h=h, lmax=192), dk=d // h))


def test_operands_that_require_grad_raise():
    args = _refused()
    args["qk"].requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        lane_attention(**args)
    with torch.no_grad():
        lane_attention(**args)


@pytest.mark.parametrize("n,want", [(1, 16), (96, 16), (132, 16),
                                    (133, 8), (768, 8)])
def test_warps_per_block(n, want):
    assert lam.warps_per_block(n) == want


@pytest.mark.parametrize("width", ["tiny", "flagship"])
def test_decoder_step_attends_through_the_kernel_once_a_layer(width,
                                                              monkeypatch):
    cfg = (tiny_config() if width == "tiny"
           else flagship_config(encoder_layers=1, max_tokens=16,
                                max_enc_frames=64))
    model = ASRModel.random_init(cfg, seed=2, device="cpu")
    calls = []

    def counted(qk, cache, hn_self, lane, pos, dk):
        calls.append((tuple(qk.shape), tuple(cache.shape), dk))
        return lane_attention_plain(qk, cache, hn_self, lane, pos, dk)

    monkeypatch.setattr(dec, "lane_attention", counted)
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
    assert calls == [((n, heads, d), (n, cfg.max_tokens, d),
                      d // heads)] * cfg.decoder_layers
    assert bool(torch.isfinite(logp).all())
