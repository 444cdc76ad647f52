"""Kernel F (``ops.kernels.add_layer_norm``) on the CPU: its plain twin and
its plan, and its use in ``decoder_step``.

- The twin is bit-equal to ``layer_norm(p, h + (y + b))``, the composition
  the beam step computed before the kernel, with and without ``y`` and
  ``bias``, at the configurations' decoder widths 256 and 512.
- The cache write: rows that do not write keep their old value, a row at
  ``pos >= Lmax`` is dropped, a bfloat16 cache holds the round-to-nearest-
  even cast of the normalised row.
- The plan refuses an unsupported width, dtype or stride, and a bias
  without ``y``, before the CPU/CUDA branch; operands that require grad
  raise.
- One ``decoder_step`` calls the fused op 3L + 1 times and ``layer_norm``
  never, at the tiny and the flagship widths.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from speechcatcher_tpu_torch.config import flagship_config, tiny_config
from speechcatcher_tpu_torch.models import decoder as dec
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.ops.kernels import add_layer_norm as aln
from speechcatcher_tpu_torch.ops.kernels.add_layer_norm import (
    add_layer_norm,
    add_layer_norm_plain,
)
from speechcatcher_tpu_torch.ops.layers import layer_norm


def _rows(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _norm(rng, d):
    return {"weight": 1.0 + 0.1 * _rows(rng, d), "bias": 0.1 * _rows(rng, d)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().view(np.uint32)


@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("form", ["h", "h_y", "h_y_bias"])
def test_twin_is_the_composition_it_replaces(form, d):
    rng = np.random.default_rng(d)
    p = _norm(rng, d)
    h = 3.0 * _rows(rng, 96, d) + 1.0
    y = _rows(rng, 96, d) if form != "h" else None
    b = _rows(rng, d) if form == "h_y_bias" else None
    got_h, got_hn = add_layer_norm(p, h, y, b)
    want_h = h if y is None else h + (y if b is None else y + b)
    assert np.array_equal(_bits(got_h), _bits(want_h))
    assert np.array_equal(_bits(got_hn), _bits(layer_norm(p, want_h)))
    if y is None:
        assert got_h is h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_rows_follow_write_and_capacity(dtype):
    rng = np.random.default_rng(3)
    n, lmax, d = 6, 8, 16
    p = _norm(rng, d)
    h, y, b = _rows(rng, n, d), _rows(rng, n, d), _rows(rng, d)
    old = _rows(rng, n, lmax, d).to(dtype)
    cache = old.clone()
    pos = torch.tensor([0, 3, 7, lmax, lmax + 5, 2])
    write = torch.tensor([True, False, True, True, True, True])
    _, hn = add_layer_norm(p, h, y, b, cache, pos, write)
    for row in range(n):
        writes = bool(write[row]) and int(pos[row]) < lmax
        for t in range(lmax):
            want = (hn[row].to(dtype) if writes and t == int(pos[row])
                    else old[row, t])
            assert torch.equal(cache[row, t], want), (row, t)
    if dtype == torch.bfloat16:
        # The stored row is the RNE cast of the float32 row: within half a
        # bfloat16 ulp of it, and equal to numpy's RNE of the same bits.
        row = hn[0].numpy().view(np.uint32).astype(np.uint64)
        rne = ((row + 0x7FFF + ((row >> 16) & 1)) >> 16).astype(np.uint16)
        assert np.array_equal(cache[0, 0].view(torch.int16).numpy()
                              .view(np.uint16), rne)


def _refused(**over):
    rng = np.random.default_rng(5)
    n, lmax, d = 4, 6, 32
    args = {"p": _norm(rng, d), "h": _rows(rng, n, d), "y": _rows(rng, n, d),
            "bias": _rows(rng, d), "cache": torch.zeros(n, lmax, d),
            "pos": torch.zeros(n, dtype=torch.int64),
            "write": torch.ones(n, dtype=torch.bool)}
    args.update(over)
    return args


REFUSED = {
    "d_not_a_multiple_of_4": dict(p=_norm(np.random.default_rng(0), 6),
                                  h=torch.zeros(4, 6), y=None, bias=None,
                                  cache=None, pos=None, write=None),
    "d_above_1024": dict(p=_norm(np.random.default_rng(0), 2048),
                         h=torch.zeros(4, 2048), y=None, bias=None,
                         cache=None, pos=None, write=None),
    "h_float64": dict(h=torch.zeros(4, 32, dtype=torch.float64)),
    "y_bfloat16": dict(y=torch.zeros(4, 32, dtype=torch.bfloat16)),
    "cache_float16": dict(cache=torch.zeros(4, 6, 32, dtype=torch.float16)),
    "h_strided": dict(h=torch.zeros(4, 64)[:, ::2]),
    "y_transposed": dict(y=torch.zeros(32, 4).t()),
    "cache_strided": dict(cache=torch.zeros(4, 6, 64)[:, :, ::2]),
    "pos_int32": dict(pos=torch.zeros(4, dtype=torch.int32)),
    "write_uint8": dict(write=torch.ones(4, dtype=torch.uint8)),
    "bias_without_y": dict(y=None),
    "cache_without_pos": dict(pos=None),
    "h_3d": dict(h=torch.zeros(1, 4, 32)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_plan_refuses_what_the_kernel_does_not_take(case):
    args = _refused(**REFUSED[case])
    with pytest.raises((ValueError, TypeError)):
        add_layer_norm(**args)


def test_operands_that_require_grad_raise():
    args = _refused()
    args["y"].requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        add_layer_norm(**args)
    with torch.no_grad():
        add_layer_norm(**args)


@pytest.mark.parametrize("n,want", [(1, 1), (96, 1), (263, 1), (264, 2),
                                    (768, 4), (1056, 8), (100000, 8)])
def test_rows_per_block_fill_the_card_first(n, want):
    assert aln.rows_per_block(n) == want


@pytest.mark.parametrize("width", ["tiny", "flagship"])
def test_decoder_step_normalises_only_through_the_fused_op(width,
                                                           monkeypatch):
    cfg = (tiny_config() if width == "tiny"
           else flagship_config(encoder_layers=1, max_tokens=16,
                                max_enc_frames=64))
    model = ASRModel.random_init(cfg, seed=2, device="cpu")
    calls = {"fused": 0, "cached": 0, "layer_norm": 0}

    def fused(*args, **kwargs):
        calls["fused"] += 1
        calls["cached"] += len(args) > 4 and args[4] is not None
        return add_layer_norm_plain(*args, **kwargs)

    def plain(*args, **kwargs):
        calls["layer_norm"] += 1
        return layer_norm(*args, **kwargs)

    monkeypatch.setattr(dec, "add_layer_norm", fused)
    monkeypatch.setattr(dec, "layer_norm", plain)
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
    layers = cfg.decoder_layers
    assert calls == {"fused": 3 * layers + 1, "cached": layers,
                     "layer_norm": 0}
    assert bool(torch.isfinite(logp).all())
