"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import n, t

from speechcatcher_tpu.models.encoder import block_attention_mask
from speechcatcher_tpu.ops.pallas.block_attention import (
    block_attention as jax_block_attention,
)
from speechcatcher_tpu.ops.pallas.ctc_recursion import (
    LANES,
    ctc_forward_recursion as jax_ctc_forward_recursion,
)
from speechcatcher_tpu.ops.conformer import rel_shift as jax_rel_shift
from speechcatcher_tpu.ops.pallas.rel_attention import (
    rel_block_attention as jax_rel_block_attention,
)
from speechcatcher_tpu.ops.pallas.ring_append import (
    ring_append_cols as jax_ring_append_cols,
    ring_append_rows as jax_ring_append_rows,
)
from speechcatcher_tpu_torch.ops.kernels.block_attention import block_attention
from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
    LOGZERO,
    ctc_forward_recursion,
)
from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
    rel_block_attention,
    rel_shift,
)
from speechcatcher_tpu_torch.ops.kernels.ring_append import (
    ring_append_cols,
    ring_append_rows,
    ring_append_rows_plain,
)


@pytest.mark.parametrize("n_blk,h,w,dk", [(3, 8, 42, 64), (5, 2, 6, 4)])
def test_block_attention_matches_pallas(n_blk, h, w, dk):
    rng = np.random.default_rng(w)
    q, k, v = (rng.standard_normal((n_blk, h, w, dk), dtype=np.float32)
               for _ in range(3))
    mask = block_attention_mask(w - 2)
    ref = jax_block_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), interpret=True)
    got = block_attention(t(q), t(k), t(v), t(mask))
    np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-5)
    assert np.all(n(got)[:, :, 0, :] == 0.0)  # fully masked row


@pytest.mark.parametrize("n_blk,h,w,dk", [(11, 4, 42, 16), (11, 2, 7, 8)])
def test_rel_block_attention_matches_pallas(n_blk, h, w, dk):
    """n = 11 is not a multiple of the Pallas kernel's 8-window tile."""
    rng = np.random.default_rng(w + 100)

    def rand(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    q, k, v = (rand(n_blk, h, w, dk) for _ in range(3))
    pos, bias_u, bias_v = rand(h, w, dk), rand(h, dk), rand(h, dk)
    mask = block_attention_mask(w - 2)
    args = (q, k, v, pos, bias_u, bias_v, mask)
    ref = jax_rel_block_attention(*map(jnp.asarray, args), interpret=True)
    got = rel_block_attention(*map(t, args))
    np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-5)
    assert np.all(n(got)[:, :, 0, :] == 0.0)  # fully masked row


@pytest.mark.parametrize("tq,tk", [(6, 6), (4, 7), (7, 4)])
def test_rel_shift_matches_jax(tq, tk):
    x = np.random.default_rng(tq * 10 + tk).standard_normal(
        (2, 3, tq, tk), dtype=np.float32)
    np.testing.assert_array_equal(n(rel_shift(t(x))),
                                  n(jax_rel_shift(jnp.asarray(x))))


def test_ctc_forward_recursion_matches_pallas():
    rng = np.random.default_rng(0)
    t_cap, n_hyp = 32, LANES

    def logp():
        return np.log(rng.random((t_cap, n_hyp), dtype=np.float32) + 1e-3)

    xn, xb = logp(), logp()
    phi = logp() * 3
    phi[0] = LOGZERO
    start = rng.integers(0, 6, size=n_hyp).astype(np.int32)
    end = rng.integers(4, t_cap + 1, size=n_hyp).astype(np.int32)
    olen0 = (rng.random(n_hyp) < 0.5).astype(np.float32)
    ref = jax_ctc_forward_recursion(
        *(jnp.asarray(a) for a in (xn, xb, phi, start, end, olen0)),
        interpret=True)
    got = ctc_forward_recursion(*(t(a) for a in (xn, xb, phi, start, end,
                                                  olen0)))
    assert got.shape == (2, t_cap, n_hyp)
    np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_append_cols_equals_pallas(dtype):
    rng = np.random.default_rng(1)
    s, v, t_cap, tn = 6, 16, 256, 20
    ring = rng.standard_normal((s, v, t_cap)).astype(np.float32)
    new = rng.standard_normal((s, v, tn)).astype(np.float32)
    start = np.array([0, t_cap - 7, 100, 30, 255, 130], np.int32)
    n_new = np.array([tn, tn, 0, tn + 9, 3, 11], np.int32)  # 0 and > TN
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax_ring_append_cols(jnp.asarray(ring, jdt), jnp.asarray(new, jdt),
                               jnp.asarray(start), jnp.asarray(n_new),
                               interpret=True)
    tdt = getattr(torch, dtype)
    ring_t = t(ring).to(tdt)
    got = ring_append_cols(ring_t, t(new).to(tdt), t(start), t(n_new))
    assert got.data_ptr() == ring_t.data_ptr()  # in place
    np.testing.assert_array_equal(n(got.float()),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_append_rows_equals_pallas(dtype):
    """The edges of the Pallas kernel's own test: start 0, start T-TN, a
    zero count, counts above TN and spans hanging off the ring end."""
    rng = np.random.default_rng(2)
    l_dim, s_dim, t_cap, d, tn = 2, 9, 128, 8, 5
    cache = rng.standard_normal((l_dim, s_dim, t_cap, d)).astype(np.float32)
    new = rng.standard_normal((l_dim, s_dim, tn, d)).astype(np.float32)
    start = np.array([0, t_cap - tn, 40, t_cap - 2, 127, 64, 3, 90, 200],
                     np.int32)
    n_new = np.array([tn, tn, 0, tn, tn + 4, 3, 1, tn + 1, 2], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax_ring_append_rows(jnp.asarray(cache, jdt), jnp.asarray(new, jdt),
                               jnp.asarray(start), jnp.asarray(n_new),
                               interpret=True)
    tdt = getattr(torch, dtype)
    cache_t = t(cache).to(tdt)
    got = ring_append_rows(cache_t, t(new).to(tdt), t(start), t(n_new))
    assert got.data_ptr() == cache_t.data_ptr()  # in place
    np.testing.assert_array_equal(n(got.float()),
                                  np.asarray(ref.astype(jnp.float32)))
    plain = ring_append_rows_plain(t(cache).to(tdt), t(new).to(tdt),
                                   t(start), t(n_new))
    assert torch.equal(plain, got)


def test_wrappers_check_shapes():
    x = torch.zeros(2, 3, 6, 4)
    with pytest.raises(ValueError):
        block_attention(x, x, x, torch.zeros(5, 5))
    with pytest.raises(ValueError):
        rel_block_attention(x, x, x, torch.zeros(3, 6, 5), torch.zeros(3, 4),
                            torch.zeros(3, 4), torch.zeros(6, 6))
    with pytest.raises(ValueError):
        ctc_forward_recursion(torch.zeros(4, 3), torch.zeros(4, 3),
                              torch.zeros(4, 3), torch.zeros(2),
                              torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError):
        ring_append_cols(torch.zeros(2, 3, 8), torch.zeros(2, 4, 2),
                         torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        ring_append_rows(torch.zeros(1, 2, 8, 4), torch.zeros(1, 2, 3, 5),
                         torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))
