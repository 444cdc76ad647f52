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
from speechcatcher_tpu_torch.ops.kernels import ring_append as ring_mod
from speechcatcher_tpu_torch.ops.kernels.ring_append import (
    _cols_plan,
    _rows_plan,
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


# The forms the producers hand the kernels: the time-major log-probs of
# ctc_extend through a transposed view, the post carry's `sub[:, :SUBCAP]`
# slice, float32 staging into a bfloat16 ring. JAX casts `new` inside the
# call (ring_append.py:153, :233), so both sides get the same float32 data.
@pytest.mark.parametrize("form", ["time_major", "f32_into_bf16",
                                  "time_major_f32_into_bf16"])
def test_ring_append_cols_forms_equal_pallas(form):
    rng = np.random.default_rng(11)
    s, v, t_cap, tn = 6, 16, 256, 20
    ring = rng.standard_normal((s, v, t_cap)).astype(np.float32)
    new_tm = rng.standard_normal((s, tn, v)).astype(np.float32)
    new = np.ascontiguousarray(new_tm.transpose(0, 2, 1))   # (S, V, TN)
    start = np.array([0, t_cap - 7, 100, 30, 255, 130], np.int32)
    n_new = np.array([tn, tn, 0, tn + 9, 3, 11], np.int32)  # 0 and > TN
    bf16 = form.endswith("bf16")
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    ref = jax_ring_append_cols(jnp.asarray(ring, jdt), jnp.asarray(new),
                               jnp.asarray(start), jnp.asarray(n_new),
                               interpret=True)
    ring_t = t(ring).to(torch.bfloat16 if bf16 else torch.float32)
    new_t = t(new_tm).transpose(1, 2) if "time_major" in form else t(new)
    assert new_t.dtype == torch.float32
    got = ring_append_cols(ring_t, new_t, t(start), t(n_new))
    assert got.data_ptr() == ring_t.data_ptr()  # in place
    np.testing.assert_array_equal(n(got.float()),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("form", ["strided", "strided_bf16", "permuted",
                                  "f32_into_bf16", "strided_f32_into_bf16"])
def test_ring_append_rows_forms_equal_pallas(form):
    """`new` as a slice along time (stride on dim 2), with (L, S) stored
    swapped, or float32 into a bfloat16 cache; the edge starts and counts
    of test_ring_append_rows_equals_pallas."""
    rng = np.random.default_rng(12)
    l_dim, s_dim, t_cap, d, tn = 2, 9, 128, 8, 5
    cache = rng.standard_normal((l_dim, s_dim, t_cap, d)).astype(np.float32)
    big = rng.standard_normal((l_dim, s_dim, tn + 4, d)).astype(np.float32)
    new = big[:, :, 2:tn + 2]
    start = np.array([0, t_cap - tn, 40, t_cap - 2, 127, 64, 3, 90, 200],
                     np.int32)
    n_new = np.array([tn, tn, 0, tn, tn + 4, 3, 1, tn + 1, 2], np.int32)
    into_bf16 = form != "strided" and form != "permuted"
    jdt = jnp.bfloat16 if into_bf16 else jnp.float32
    ref = jax_ring_append_rows(jnp.asarray(cache, jdt), jnp.asarray(new),
                               jnp.asarray(start), jnp.asarray(n_new),
                               interpret=True)
    cache_t = t(cache).to(torch.bfloat16 if into_bf16 else torch.float32)
    if form == "permuted":
        new_t = t(np.ascontiguousarray(new.transpose(1, 0, 2, 3))
                  ).transpose(0, 1)
    elif form.startswith("strided"):
        new_t = t(big)[:, :, 2:tn + 2]
        if form == "strided_bf16":
            new_t = t(big).to(torch.bfloat16)[:, :, 2:tn + 2]
    else:
        new_t = t(np.ascontiguousarray(new))
    assert not new_t.is_contiguous() or form == "f32_into_bf16"
    got = ring_append_rows(cache_t, new_t, t(start), t(n_new))
    assert got.data_ptr() == cache_t.data_ptr()  # in place
    np.testing.assert_array_equal(n(got.float()),
                                  np.asarray(ref.astype(jnp.float32)))


def test_ring_append_plans():
    """The launch arguments each plan hands the kernel: shapes, new's
    strides in elements (0 on dims of extent 1), element sizes, and the
    read order of kernel C."""
    i32 = dict(dtype=torch.int32)
    st, nn = torch.zeros(3, **i32), torch.zeros(3, **i32)
    ring = torch.zeros(3, 16, 64, dtype=torch.bfloat16)
    tm = _cols_plan(ring, torch.zeros(3, 5, 16).transpose(1, 2), st, nn)
    assert (tm.new_ss, tm.new_sv, tm.new_st, tm.t_fastest) == (80, 1, 16, 0)
    assert (tm.s_dim, tm.v_dim, tm.t_cap, tm.tn) == (3, 16, 64, 5)
    assert (tm.in_bytes, tm.out_bytes) == (4, 2)
    vm = _cols_plan(ring, torch.zeros(3, 16, 5, dtype=torch.bfloat16), st, nn)
    assert (vm.new_ss, vm.new_sv, vm.new_st, vm.t_fastest) == (80, 5, 1, 1)
    assert (vm.in_bytes, vm.out_bytes) == (2, 2)
    cache = torch.zeros(1, 3, 40, 8)
    big = torch.zeros(1, 3, 12, 8)
    rp = _rows_plan(cache, big[:, :, 2:9], st, nn)
    assert (rp.new_sl, rp.new_ss, rp.new_st) == (0, 96, 8)
    assert (rp.l_dim, rp.s_dim, rp.t_cap, rp.tn, rp.d) == (1, 3, 40, 7, 8)
    assert (rp.in_bytes, rp.out_bytes) == (4, 4)


def test_ring_append_plan_cache():
    """One plan per input signature: a second call with the same shapes,
    strides, dtypes and devices reuses it; on the CPU it carries no entry
    point."""
    ring_mod._COLS_PLANS.clear()
    i32 = dict(dtype=torch.int32)
    args = (torch.zeros(2, 4, 32), torch.ones(2, 3, 4).transpose(1, 2),
            torch.tensor([0, 5], **i32), torch.tensor([3, 2], **i32))
    ring_append_cols(*args)
    (plan,) = ring_mod._COLS_PLANS.values()
    ring_append_cols(*args)
    assert list(ring_mod._COLS_PLANS.values()) == [plan]
    assert plan.fn is None
    ring_append_cols(args[0], args[1].contiguous(), *args[2:])
    assert len(ring_mod._COLS_PLANS) == 2


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


# (plan, ring, new, start, n_new, error): each refusal of the plans, which
# run before the CPU/CUDA branch, so both routes refuse alike.
_REFUSALS = {
    "cols_ring_not_contiguous": (
        _cols_plan, lambda: torch.zeros(2, 8, 4).transpose(1, 2),
        lambda: torch.zeros(2, 4, 3), lambda: _i32(2), lambda: _i32(2),
        ValueError),
    "rows_ring_not_contiguous": (
        _rows_plan, lambda: torch.zeros(1, 8, 2, 4).transpose(1, 2),
        lambda: torch.zeros(1, 2, 3, 4), lambda: _i32(2), lambda: _i32(2),
        ValueError),
    "rows_last_dim_not_contiguous": (
        _rows_plan, lambda: torch.zeros(1, 2, 8, 4),
        lambda: torch.zeros(1, 2, 4, 3).transpose(2, 3), lambda: _i32(2),
        lambda: _i32(2), ValueError),
    "cols_start_int64": (
        _cols_plan, lambda: torch.zeros(2, 4, 8), lambda: torch.zeros(2, 4, 3),
        lambda: torch.zeros(2, dtype=torch.int64), lambda: _i32(2),
        TypeError),
    "rows_n_new_float": (
        _rows_plan, lambda: torch.zeros(1, 2, 8, 4),
        lambda: torch.zeros(1, 2, 3, 4), lambda: _i32(2),
        lambda: torch.zeros(2), TypeError),
    "cols_start_shape": (
        _cols_plan, lambda: torch.zeros(2, 4, 8), lambda: torch.zeros(2, 4, 3),
        lambda: _i32(3), lambda: _i32(2), ValueError),
    "rows_n_new_shape": (
        _rows_plan, lambda: torch.zeros(1, 2, 8, 4),
        lambda: torch.zeros(1, 2, 3, 4), lambda: _i32(2), lambda: _i32(2, 1),
        ValueError),
    "cols_start_not_contiguous": (
        _cols_plan, lambda: torch.zeros(2, 4, 8), lambda: torch.zeros(2, 4, 3),
        lambda: _i32(4)[::2], lambda: _i32(2), ValueError),
    "cols_ring_float16": (
        _cols_plan, lambda: torch.zeros(2, 4, 8, dtype=torch.float16),
        lambda: torch.zeros(2, 4, 3, dtype=torch.float16), lambda: _i32(2),
        lambda: _i32(2), TypeError),
    "rows_ring_float64": (
        _rows_plan, lambda: torch.zeros(1, 2, 8, 4, dtype=torch.float64),
        lambda: torch.zeros(1, 2, 3, 4, dtype=torch.float64),
        lambda: _i32(2), lambda: _i32(2), TypeError),
    "cols_new_float64": (
        _cols_plan, lambda: torch.zeros(2, 4, 8),
        lambda: torch.zeros(2, 4, 3, dtype=torch.float64), lambda: _i32(2),
        lambda: _i32(2), TypeError),
    "cols_new_float16_into_bf16": (
        _cols_plan, lambda: torch.zeros(2, 4, 8, dtype=torch.bfloat16),
        lambda: torch.zeros(2, 4, 3, dtype=torch.float16), lambda: _i32(2),
        lambda: _i32(2), TypeError),
    "rows_new_bf16_into_f32": (
        _rows_plan, lambda: torch.zeros(1, 2, 8, 4),
        lambda: torch.zeros(1, 2, 3, 4, dtype=torch.bfloat16),
        lambda: _i32(2), lambda: _i32(2), TypeError),
    "cols_devices_differ": (
        _cols_plan, lambda: torch.zeros(2, 4, 8), lambda: torch.zeros(2, 4, 3),
        lambda: _i32(2).to("meta"), lambda: _i32(2), ValueError),
    "rows_on_meta": (
        _rows_plan, lambda: torch.zeros(1, 2, 8, 4, device="meta"),
        lambda: torch.zeros(1, 2, 3, 4, device="meta"),
        lambda: _i32(2).to("meta"), lambda: _i32(2).to("meta"), ValueError),
    "rows_no_rows": (
        _rows_plan, lambda: torch.zeros(1, 2, 0, 4),
        lambda: torch.zeros(1, 2, 3, 4), lambda: _i32(2), lambda: _i32(2),
        ValueError),
    "cols_shape": (
        _cols_plan, lambda: torch.zeros(2, 4, 8), lambda: torch.zeros(2, 5, 3),
        lambda: _i32(2), lambda: _i32(2), ValueError),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_ring_append_plans_refuse(case):
    plan, *makers, error = _REFUSALS[case]
    with pytest.raises(error):
        plan(*(m() for m in makers))


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
    # The CPU route refuses what the card refuses: dtypes and indices.
    i32 = dict(dtype=torch.int32)
    with pytest.raises(TypeError):
        ctc_forward_recursion(torch.zeros(4, 3), torch.zeros(4, 3),
                              torch.zeros(4, 3),
                              torch.zeros(3, dtype=torch.int64),
                              torch.zeros(3, **i32), torch.zeros(3))
    with pytest.raises(TypeError):
        ctc_forward_recursion(torch.zeros(4, 3, dtype=torch.float64),
                              torch.zeros(4, 3), torch.zeros(4, 3),
                              torch.zeros(3, **i32), torch.zeros(3, **i32),
                              torch.zeros(3))
    with pytest.raises(TypeError):
        ring_append_cols(torch.zeros(2, 3, 8), torch.zeros(2, 3, 2),
                         torch.zeros(2, dtype=torch.int64),
                         torch.zeros(2, **i32))
    with pytest.raises(TypeError):
        ring_append_cols(torch.zeros(2, 3, 8),
                         torch.zeros(2, 3, 2, dtype=torch.float64),
                         torch.zeros(2, **i32), torch.zeros(2, **i32))
    with pytest.raises(ValueError):
        ring_append_rows(torch.zeros(1, 2, 8, 4), torch.zeros(1, 2, 3, 4),
                         torch.zeros(3, **i32), torch.zeros(2, **i32))
    with pytest.raises(TypeError):
        ring_append_rows(torch.zeros(1, 2, 8, 4), torch.zeros(1, 2, 3, 4),
                         torch.zeros(2, **i32), torch.zeros(2))
    with pytest.raises(TypeError):
        ring_append_rows(torch.zeros(1, 2, 8, 4),
                         torch.zeros(1, 2, 3, 4, dtype=torch.float16),
                         torch.zeros(2, **i32), torch.zeros(2, **i32))
