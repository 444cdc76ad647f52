"""Kernel B of the PyTorch port on the CPU: the reference form against the
JAX package's Pallas kernel in interpret mode, the main path's form against
the reference form, ``ctc_advance_state`` against the JAX function, the
plans of both forms with their refusals, bfloat16 log-prob rows in both
forms (against Pallas on the same rows, and exactly against the float32 form
on the widened rows), and the algebra of the CUDA kernel's scan (a plain float32 model of it, kept here for the tests alone)
against the frame-by-frame plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import n, t

from speechcatcher_tpu.ops.pallas.ctc_recursion import (
    LANES,
    ctc_forward_recursion as jax_ctc_forward_recursion,
)
from speechcatcher_tpu_torch.ops.kernels import ctc_recursion as mod
from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
    LOGZERO,
    MAX_T,
    _reference_plan,
    _streams_plan,
    ctc_forward_recursion,
    ctc_forward_recursion_plain,
    ctc_forward_recursion_streams,
    ctc_forward_recursion_streams_plain,
)

T_CAP = 32


def _logp(rng, *shape):
    return np.log(rng.random(shape, dtype=np.float32) + 1e-3)


def _reference_case(case: str, n_hyp: int = LANES, t_cap: int = T_CAP):
    """(xn, xb, phi_shift, start, end, olen0) as numpy arrays for one edge
    of the range handling."""
    rng = np.random.default_rng(sorted(_CASES).index(case))
    xn, xb = _logp(rng, t_cap, n_hyp), _logp(rng, t_cap, n_hyp)
    phi = _logp(rng, t_cap, n_hyp) * 3
    phi[0] = LOGZERO
    start = rng.integers(0, 6, size=n_hyp).astype(np.int32)
    end = rng.integers(4, t_cap + 1, size=n_hyp).astype(np.int32)
    olen0 = (rng.random(n_hyp) < 0.5).astype(np.float32)
    if case == "start_gt_0_end_lt_t":
        start = rng.integers(3, 9, size=n_hyp).astype(np.int32)
        end = rng.integers(10, t_cap - 2, size=n_hyp).astype(np.int32)
    elif case == "end_le_start":
        start = rng.integers(2, t_cap, size=n_hyp).astype(np.int32)
        end = (start - rng.integers(0, 3, size=n_hyp)).astype(np.int32)
    elif case == "start_1_olen0":
        start[:] = 1
        olen0[:] = 1.0
    elif case == "start_1_no_olen0":
        start[:] = 1
        olen0[:] = 0.0
    elif case == "logzero_frames":
        xn[7] = LOGZERO
        xn[11:13, ::2] = LOGZERO
        start[:] = 1
        end[:] = t_cap
    elif case == "whole_ring":
        start[:] = 0
        end[:] = t_cap
    return xn, xb, phi, start, end, olen0


_CASES = ("mixed", "strided", "start_gt_0_end_lt_t", "end_le_start",
          "start_1_olen0", "start_1_no_olen0", "logzero_frames", "whole_ring")


@pytest.mark.parametrize("case", _CASES)
def test_reference_form_matches_pallas(case):
    """The (T, N) form against the Pallas kernel in interpret mode, 1e-5
    absolute (float32, the same operation order on both sides)."""
    args = _reference_case(case)
    ref = jax_ctc_forward_recursion(*(jnp.asarray(a) for a in args),
                                    interpret=True)
    targs = [t(a) for a in args]
    if case == "strided":   # (T, N) views of time-minor (N, T) storage
        targs[:3] = [t(np.ascontiguousarray(a.T)).t() for a in args[:3]]
        assert targs[0].stride() == (1, T_CAP)
    got = ctc_forward_recursion(*targs)
    assert got.shape == (2, T_CAP, LANES) and got.is_contiguous()
    np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-5)


def _stream_operands(seed: int, s_dim: int = 3, beam: int = 4,
                     t_cap: int = 40, vocab: int = 6,
                     ring_dtype: torch.dtype = torch.float32):
    """The main path's operands as ctc_advance_state makes them."""
    rng = np.random.default_rng(seed)
    ring = t(_logp(rng, s_dim, vocab, t_cap)).to(ring_dtype)
    token = t(rng.integers(1, vocab, size=(s_dim, beam)))
    xn = ring[torch.arange(s_dim)[:, None], token, :]
    xb = ring[:, None, 0, :]
    phi = t(_logp(rng, s_dim, beam, t_cap) * 3)
    olen = t(np.array([0, 1, 5][:s_dim], np.int64))
    enc_len = t(np.array([t_cap, 17, 4][:s_dim], np.int32))  # last: end<start
    r_src = t(_logp(rng, s_dim, beam, 2, t_cap) * 50)
    return [xn, xb, phi, olen, enc_len, r_src]


@pytest.mark.parametrize("olen_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("enc_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("xb_form", ["row", "expanded", "contiguous"])
def test_streams_form_equals_reference_form(olen_dtype, enc_dtype, xb_form):
    """The main path's form is the reference form on shifted, transposed
    operands with the frames from end on taken from r_src: equal to the
    last bit on the CPU, where both run the one plain recursion."""
    xn, xb, phi, olen, enc_len, r_src = _stream_operands(1)
    s_dim, beam, t_cap = xn.shape
    olen, enc_len = olen.to(olen_dtype), enc_len.to(enc_dtype)
    if xb_form == "expanded":
        xb = xb.expand(s_dim, beam, t_cap)
    elif xb_form == "contiguous":
        xb = xb.expand(s_dim, beam, t_cap).contiguous()
    else:
        assert xb.shape == (s_dim, 1, t_cap)
    got = ctc_forward_recursion_streams(xn, xb, phi, olen, enc_len, r_src)
    assert got.shape == (s_dim, beam, 2, t_cap) and got.is_contiguous()

    n_hyp = s_dim * beam
    phi_shift = torch.cat([torch.full((s_dim, beam, 1), LOGZERO),
                           phi[:, :, :-1]], dim=2)

    def to_tn(a):
        return a.expand(s_dim, beam, t_cap).reshape(n_hyp, t_cap).t(
            ).contiguous()

    start = olen.long().clamp(min=1, max=t_cap)
    r_tn = ctc_forward_recursion(
        to_tn(xn), to_tn(xb), to_tn(phi_shift),
        start.repeat_interleave(beam).to(torch.int32),
        enc_len.repeat_interleave(beam).to(torch.int32),
        (olen == 0).repeat_interleave(beam).float())
    ref = r_tn.permute(2, 0, 1).reshape(s_dim, beam, 2, t_cap).clone()
    for s in range(s_dim):
        ref[s, :, :, int(enc_len[s]):] = r_src[s, :, :, int(enc_len[s]):]
    assert torch.equal(got, ref)
    # What the edges must show: stream 0 starts from x_n[0], stream 2 (end
    # before start) is LOGZERO up to end and r_src from there.
    assert torch.equal(got[0, :, 0, 0], xn[0, :, 0])
    assert bool((got[2, :, :, :4] == LOGZERO).all())
    assert torch.equal(got[2, :, :, 4:], r_src[2, :, :, 4:])


def test_streams_twin_is_the_cpu_route():
    args = _stream_operands(2)
    assert torch.equal(ctc_forward_recursion_streams(*args),
                       ctc_forward_recursion_streams_plain(*args))


# ---------------------------------------------------------------------------
# bfloat16 log-prob rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", _CASES)
def test_reference_form_bfloat16_rows(case):
    """bfloat16 xn and xb, float32 phi_shift: against the Pallas kernel on
    the same bfloat16 rows in interpret mode (1e-5 absolute, as in float32:
    both widen first), and equal to the last bit to the float32 form on the
    rows widened beforehand."""
    args = _reference_case(case)
    targs = [t(a) for a in args]
    targs[:2] = [a.bfloat16() for a in targs[:2]]
    if case == "strided":
        targs[:3] = [a.t().contiguous().t() for a in targs[:3]]
    jargs = [jnp.asarray(a) for a in args]
    jargs[:2] = [a.astype(jnp.bfloat16) for a in jargs[:2]]
    ref = jax_ctc_forward_recursion(*jargs, interpret=True)
    got = ctc_forward_recursion(*targs)
    assert got.dtype == torch.float32 and got.shape == (2, T_CAP, LANES)
    np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-5)
    widened = ctc_forward_recursion(targs[0].float(), targs[1].float(),
                                    *targs[2:])
    assert torch.equal(got, widened)
    # The rows really were rounded: the float32 rows give another result.
    assert not torch.equal(got, ctc_forward_recursion(*(t(a) for a in args)))


@pytest.mark.parametrize("xb_form", ["row", "expanded", "contiguous"])
def test_streams_form_bfloat16_rows(xb_form):
    """Rows gathered from a bfloat16 ring, the blank row a view of it: equal
    to the last bit to the float32 form on the widened rows, and to the
    reference form on bfloat16 rows."""
    xn, xb, phi, olen, enc_len, r_src = _stream_operands(
        1, ring_dtype=torch.bfloat16)
    s_dim, beam, t_cap = xn.shape
    assert xn.dtype == xb.dtype == torch.bfloat16
    if xb_form == "expanded":
        xb = xb.expand(s_dim, beam, t_cap)
    elif xb_form == "contiguous":
        xb = xb.expand(s_dim, beam, t_cap).contiguous()
    got = ctc_forward_recursion_streams(xn, xb, phi, olen, enc_len, r_src)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, ctc_forward_recursion_streams(
        xn.float(), xb.float(), phi, olen, enc_len, r_src))
    assert torch.equal(got, ctc_forward_recursion_streams_plain(
        xn, xb, phi, olen, enc_len, r_src))

    n_hyp = s_dim * beam
    phi_shift = torch.cat([torch.full((s_dim, beam, 1), LOGZERO),
                           phi[:, :, :-1]], dim=2)

    def to_tn(a):
        return a.expand(s_dim, beam, t_cap).reshape(n_hyp, t_cap).t()

    r_tn = ctc_forward_recursion(
        to_tn(xn), to_tn(xb), to_tn(phi_shift),
        olen.clamp(min=1, max=t_cap).repeat_interleave(beam).to(torch.int32),
        enc_len.repeat_interleave(beam).to(torch.int32),
        (olen == 0).repeat_interleave(beam).float())
    ref = r_tn.permute(2, 0, 1).reshape(s_dim, beam, 2, t_cap).clone()
    for s in range(s_dim):
        ref[s, :, :, int(enc_len[s]):] = r_src[s, :, :, int(enc_len[s]):]
    assert torch.equal(got, ref)


def test_bfloat16_plans():
    """The row dtype is part of the plan: two bytes a value, and 16-byte
    loads only when every log-prob row starts on eight values."""
    s_dim, beam, vocab = 3, 5, 7
    olen = torch.zeros(s_dim, dtype=torch.int64)

    def plan(t_cap, dtype):
        ring = torch.zeros(s_dim, vocab, t_cap, dtype=dtype)
        xn = torch.zeros(s_dim, beam, t_cap, dtype=dtype)
        return _streams_plan(xn, ring[:, None, 0, :],
                             torch.zeros(s_dim, beam, t_cap), olen,
                             _i32(s_dim), torch.zeros(s_dim, beam, 2, t_cap))

    assert (plan(16, torch.float32).row_bytes,
            plan(16, torch.bfloat16).row_bytes) == (4, 2)
    assert plan(16, torch.bfloat16).vec == 1
    # T = 12: rows start on four values, not on eight.
    assert (plan(12, torch.float32).vec, plan(12, torch.bfloat16).vec) == (1, 0)
    x = torch.zeros(12, 5, dtype=torch.bfloat16)
    p = _reference_plan(x, x, torch.zeros(12, 5), _i32(5), _i32(5),
                        torch.zeros(5))
    assert (p.row_bytes, p.vec, p.xn_ss, p.xn_st) == (2, 0, 1, 5)
    # Its own plan-cache entry beside the float32 one.
    mod._STREAMS_PLANS.clear()
    for dtype in (torch.float32, torch.bfloat16, torch.bfloat16):
        ctc_forward_recursion_streams(
            *_stream_operands(3, ring_dtype=dtype))
    assert sorted(p.args.row_bytes for p in mod._STREAMS_PLANS.values()) \
        == [2, 4]


@pytest.mark.parametrize("ring_dtype", ["float32", "bfloat16"])
def test_ctc_advance_state_matches_jax_over_steps(ring_dtype):
    """Three streams with uneven enc_len and olen through extend, score and
    advance of both packages (JAX on the CPU scans the recursion, the port
    runs it frame by frame: equal up to float reassociation), with the
    log-prob ring in float32 and in bfloat16 (both round alike on append)."""
    import speechcatcher_tpu.decode.ctc_prefix as J
    import speechcatcher_tpu_torch.decode.ctc_prefix as P

    s_dim, beam, t_cap, vocab, k = 3, 3, 64, 16, 5
    blank, eos = 0, vocab - 1
    rng = np.random.default_rng(14)
    js = J.init_ctc_state(s_dim, beam, t_cap, vocab,
                          ring_dtype=getattr(jnp, ring_dtype))
    ps = P.init_ctc_state(s_dim, beam, t_cap, vocab, torch.device("cpu"),
                          ring_dtype=getattr(torch, ring_dtype))
    last = np.full((s_dim, beam), eos, np.int32)
    olen = np.array([0, 2, 1], np.int32)

    def compare(a, b, **tol):
        assert str(a.logp.dtype) == "torch." + str(b.logp.dtype)
        for name in ("logp", "enc_len", "r", "s"):
            np.testing.assert_allclose(
                n(getattr(a, name).float()),
                np.asarray(jnp.asarray(getattr(b, name), jnp.float32)),
                err_msg=name, **tol)

    appends = {0: [7, 4, 5], 2: [3, 6, 0], 3: [5, 0, 9]}
    for step in range(5):
        if step in appends:
            logits = rng.standard_normal((s_dim, 9, vocab)).astype(np.float32)
            new = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
            n_new = np.array(appends[step], np.int32)
            js = J.ctc_extend(js, jnp.asarray(new), jnp.asarray(n_new))
            ps = P.ctc_extend(ps, t(new), t(n_new))
            compare(ps, js, rtol=1e-5, atol=1e-4)
        cand = np.stack([np.stack([rng.permutation(np.arange(1, vocab))[:k]
                                   for _ in range(beam)])
                         for _ in range(s_dim)]).astype(np.int32)
        if last[0, 0] not in cand[0, 0]:
            cand[0, 0, 1] = last[0, 0]
        j_sc, j_psi = J.ctc_score_candidates(js, jnp.asarray(last),
                                             jnp.asarray(olen),
                                             jnp.asarray(cand), blank, eos)
        p_sc, p_psi = P.ctc_score_candidates(ps, t(last), t(olen), t(cand),
                                             blank, eos)
        np.testing.assert_allclose(n(p_psi), n(j_psi), rtol=1e-5, atol=1e-4)
        src = rng.integers(0, beam, size=(s_dim, beam)).astype(np.int32)
        chosen = np.take_along_axis(cand[:, :, 0], src, axis=1)
        chosen[1, 2] = eos  # outside the candidate set: slot-0 fallback
        js = J.ctc_advance_state(js, j_psi, jnp.asarray(src),
                                 jnp.asarray(chosen), jnp.asarray(cand),
                                 jnp.asarray(last), jnp.asarray(olen))
        # The beam search holds olen as int64, the scorer enc_len as int32.
        p_olen = t(olen).long() if step % 2 else t(olen)
        prev_r = ps.r.clone()
        new_ps = P.ctc_advance_state(ps, p_psi, t(src), t(chosen), t(cand),
                                     t(last), p_olen)
        assert torch.equal(ps.r, prev_r)        # r is never written in place
        assert new_ps.r.shape == ps.r.shape and new_ps.r.is_contiguous()
        ps = new_ps
        compare(ps, js, rtol=1e-5, atol=1e-3)
        last, olen = chosen, olen + 1


@pytest.mark.parametrize("ring_dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ctc_advance_state_hands_the_kernel_the_scorer_layout(monkeypatch,
                                                              ring_dtype):
    """One call, operands as the scorer holds them: xn gathered time-minor
    in the ring's dtype (no widened copy), the blank row a view of the ring
    (never expanded), phi unshifted, olen and enc_len per stream in the
    caller's integer types."""
    import speechcatcher_tpu_torch.decode.ctc_prefix as P

    s_dim, beam, t_cap, vocab, k = 2, 3, 24, 8, 4
    rng = np.random.default_rng(5)
    state = P.init_ctc_state(s_dim, beam, t_cap, vocab, torch.device("cpu"),
                             ring_dtype=ring_dtype)
    new = t(_logp(rng, s_dim, 10, vocab))
    state = P.ctc_extend(state, new, t(np.array([10, 6], np.int32)))
    cand = t(np.stack([np.stack([rng.permutation(np.arange(1, vocab))[:k]
                                 for _ in range(beam)])
                       for _ in range(s_dim)]).astype(np.int32))
    last = torch.full((s_dim, beam), vocab - 1, dtype=torch.int32)
    olen = torch.zeros(s_dim, dtype=torch.int64)
    _, psi = P.ctc_score_candidates(state, last, olen, cand, 0, vocab - 1)
    calls = []

    def spy(*args):
        calls.append(args)
        return ctc_forward_recursion_streams(*args)

    monkeypatch.setattr(P, "ctc_forward_recursion_streams", spy)
    src = torch.zeros((s_dim, beam), dtype=torch.int64)
    out = P.ctc_advance_state(state, psi, src, cand[:, :, 0].long(), cand,
                              last, olen)
    (args,) = calls
    xn, xb, phi, got_olen, enc_len, r_src = args
    assert xn.shape == phi.shape == (s_dim, beam, t_cap)
    assert xn.dtype == xb.dtype == ring_dtype
    assert phi.dtype == r_src.dtype == out.r.dtype == torch.float32
    assert xn.stride(-1) == phi.stride(-1) == 1
    assert xb.shape == (s_dim, 1, t_cap)
    assert xb.data_ptr() == state.logp.data_ptr()      # a view of the ring
    assert got_olen is olen and enc_len is state.enc_len
    assert enc_len.dtype == torch.int32
    assert r_src.shape == (s_dim, beam, 2, t_cap)
    assert out.r.shape == (s_dim, beam, 2, t_cap)
    # phi is unshifted: with olen == 0 every source row is r_sum or r_b of
    # the initial state, whose frame 0 the shifted form would have dropped.
    assert torch.equal(phi[:, :, 0],
                       torch.logsumexp(r_src, dim=2)[:, :, 0])


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def test_reference_plan_arguments():
    """N hypotheses as N streams of beam 1; strides in elements over
    (stream, beam, time), 0 on dims of extent 1."""
    x = torch.zeros(12, 5)
    p = _reference_plan(x, x, x, _i32(5), _i32(5), torch.zeros(5))
    assert (p.s_dim, p.beam, p.t_cap, p.vec) == (5, 1, 12, 0)
    assert (p.xn_ss, p.xn_sb, p.xn_st) == (1, 0, 5)
    assert (p.phi_ss, p.phi_sb, p.phi_st) == (1, 0, 5)
    assert (p.src_ss, p.src_sb, p.src_sk) == (0, 0, 0)
    xt = torch.zeros(5, 12).t()                 # time-minor storage
    p = _reference_plan(xt, x, xt[:, ::1], _i32(5), _i32(5), torch.zeros(5))
    assert (p.xn_ss, p.xn_st, p.xb_ss, p.xb_st) == (12, 1, 1, 5)
    one = torch.zeros(12, 1)
    p = _reference_plan(one, one, one, _i32(1), _i32(1), torch.zeros(1))
    assert (p.s_dim, p.xn_ss, p.xn_st) == (1, 0, 1)


def test_streams_plan_arguments():
    """Strides of the scorer's tensors: the blank row of an (S, V, T) ring
    has stride V*T over streams and 0 over the beam; int32 or int64
    lengths; 16-byte loads when every row starts on four floats."""
    s_dim, beam, t_cap, vocab = 3, 5, 16, 7
    ring = torch.zeros(s_dim, vocab, t_cap)
    xn = torch.zeros(s_dim, beam, t_cap)
    xb = ring[:, None, 0, :]
    r_src = torch.zeros(s_dim, beam, 2, t_cap)
    olen = torch.zeros(s_dim, dtype=torch.int64)
    p = _streams_plan(xn, xb, xn, olen, _i32(s_dim), r_src)
    assert (p.s_dim, p.beam, p.t_cap) == (s_dim, beam, t_cap)
    assert (p.xn_ss, p.xn_sb, p.xn_st) == (beam * t_cap, t_cap, 1)
    assert (p.xb_ss, p.xb_sb, p.xb_st) == (vocab * t_cap, 0, 1)
    assert (p.src_ss, p.src_sb, p.src_sk) == (beam * 2 * t_cap, 2 * t_cap,
                                              t_cap)
    assert (p.olen_bytes, p.enc_bytes, p.vec) == (8, 4, 1)
    # An expanded blank row is read the same way; odd T or rows that start
    # off four floats take scalar loads.
    p = _streams_plan(xn, xb.expand(s_dim, beam, t_cap), xn, _i32(s_dim),
                      olen, r_src)
    assert (p.xb_sb, p.olen_bytes, p.enc_bytes, p.vec) == (0, 4, 8, 1)
    odd = torch.zeros(s_dim, beam, 15)
    p = _streams_plan(odd, odd[:, :1], odd, olen, _i32(s_dim),
                      torch.zeros(s_dim, beam, 2, 15))
    assert p.vec == 0
    big = torch.zeros(s_dim, beam, t_cap + 2)[:, :, 1:t_cap + 1]
    assert _streams_plan(big, xb, xn, olen, _i32(s_dim), r_src).vec == 0
    # r_src as a strided view (a slice of a wider beam).
    wide = torch.zeros(s_dim, beam + 2, 2, t_cap)[:, 1:beam + 1]
    p = _streams_plan(xn, xb, xn, olen, _i32(s_dim), wide)
    assert (p.src_ss, p.src_sb, p.src_sk) == ((beam + 2) * 2 * t_cap,
                                              2 * t_cap, t_cap)


def test_plan_cache():
    """One plan per input signature and form; on the CPU it carries no
    entry point; the launch counter belongs to the reference wrapper."""
    mod._PLANS.clear()
    mod._STREAMS_PLANS.clear()
    x = torch.zeros(6, 2)
    args = (x, x, x, _i32(2), torch.full((2,), 6, dtype=torch.int32),
            torch.zeros(2))
    ctc_forward_recursion(*args)
    (plan,) = mod._PLANS.values()
    ctc_forward_recursion(*args)
    assert list(mod._PLANS.values()) == [plan] and plan.fn is None
    assert plan.out_shape == (2, 6, 2)
    ctc_forward_recursion(x.t().contiguous().t(), *args[1:])
    assert len(mod._PLANS) == 2
    sargs = _stream_operands(3)
    ctc_forward_recursion_streams(*sargs)
    ctc_forward_recursion_streams(*sargs)
    (splan,) = mod._STREAMS_PLANS.values()
    assert splan.fn is None and splan.out_shape == (3, 4, 2, 40)
    sargs[3] = sargs[3].to(torch.int32)
    ctc_forward_recursion_streams(*sargs)
    assert len(mod._STREAMS_PLANS) == 2 and len(mod._PLANS) == 2
    assert ctc_forward_recursion.launches == 0
    assert not hasattr(ctc_forward_recursion_streams, "launches")


def _ref_ok():
    x = torch.zeros(8, 3)
    return [x, x.clone(), x.clone(), _i32(3), _i32(3), torch.zeros(3)]


def _streams_ok():
    return [torch.zeros(2, 3, 8), torch.zeros(2, 1, 8), torch.zeros(2, 3, 8),
            torch.zeros(2, dtype=torch.int64), _i32(2),
            torch.zeros(2, 3, 2, 8)]


def _swap(maker, index, value):
    def make():
        args = maker()
        args[index] = value(args[index])
        return args
    return make


# name -> (form, operands, error): each refusal of the plans, which run
# before the CPU/CUDA branch, so both routes refuse alike.
_REFUSALS = {
    "ref_start_int64": ("ref", _swap(_ref_ok, 3, lambda a: a.long()),
                        TypeError),
    "ref_end_int64": ("ref", _swap(_ref_ok, 4, lambda a: a.long()),
                      TypeError),
    "ref_olen0_int": ("ref", _swap(_ref_ok, 5, lambda a: a.int()), TypeError),
    "ref_xn_float64": ("ref", _swap(_ref_ok, 0, lambda a: a.double()),
                       TypeError),
    "ref_phi_bfloat16": ("ref", _swap(_ref_ok, 2, lambda a: a.bfloat16()),
                         TypeError),
    "ref_xb_shape": ("ref", _swap(_ref_ok, 1, lambda a: a[:, :2]),
                     ValueError),
    "ref_rank": ("ref", _swap(_ref_ok, 0, lambda a: a[None]), ValueError),
    "ref_start_shape": ("ref", _swap(_ref_ok, 3, lambda a: _i32(2)),
                        ValueError),
    "ref_olen0_shape": ("ref", _swap(_ref_ok, 5, lambda a: a[:, None]),
                        ValueError),
    "ref_end_not_contiguous": ("ref", _swap(_ref_ok, 4,
                                            lambda a: _i32(6)[::2]),
                               ValueError),
    "ref_devices_differ": ("ref", _swap(_ref_ok, 3, lambda a: a.to("meta")),
                           ValueError),
    "ref_on_meta": ("ref", lambda: [a.to("meta") for a in _ref_ok()],
                    ValueError),
    "ref_no_frames": ("ref", lambda: [torch.zeros(0, 3)] * 3 + _ref_ok()[3:],
                      ValueError),
    "ref_too_many_frames": (
        "ref", lambda: [torch.zeros(MAX_T + 1, 1)] * 3
        + [_i32(1), _i32(1), torch.zeros(1)], ValueError),
    "streams_xn_float64": ("streams",
                           _swap(_streams_ok, 0, lambda a: a.double()),
                           TypeError),
    "streams_xb_bfloat16": ("streams",
                            _swap(_streams_ok, 1, lambda a: a.bfloat16()),
                            TypeError),
    # Log-prob rows: float32 or bfloat16, both alike.
    "ref_rows_float16": ("ref", lambda: [a.half() for a in _ref_ok()[:2]]
                         + _ref_ok()[2:], TypeError),
    "ref_xn_bfloat16_alone": ("ref", _swap(_ref_ok, 0,
                                           lambda a: a.bfloat16()),
                              TypeError),
    "ref_xb_bfloat16_alone": ("ref", _swap(_ref_ok, 1,
                                           lambda a: a.bfloat16()),
                              TypeError),
    "streams_rows_float16": ("streams",
                             lambda: [a.half() for a in _streams_ok()[:2]]
                             + _streams_ok()[2:], TypeError),
    "streams_xn_bfloat16_alone": ("streams",
                                  _swap(_streams_ok, 0,
                                        lambda a: a.bfloat16()),
                                  TypeError),
    "streams_phi_bfloat16": ("streams",
                             _swap(_streams_ok, 2, lambda a: a.bfloat16()),
                             TypeError),
    "streams_r_src_bfloat16": ("streams",
                               _swap(_streams_ok, 5, lambda a: a.bfloat16()),
                               TypeError),
    "streams_r_src_float16": ("streams",
                              _swap(_streams_ok, 5, lambda a: a.half()),
                              TypeError),
    "streams_olen_float": ("streams",
                           _swap(_streams_ok, 3, lambda a: a.float()),
                           TypeError),
    "streams_enc_len_int16": ("streams",
                              _swap(_streams_ok, 4, lambda a: a.short()),
                              TypeError),
    "streams_xn_inner_stride": (
        "streams", _swap(_streams_ok, 0,
                         lambda a: torch.zeros(2, 3, 16)[:, :, ::2]),
        ValueError),
    "streams_xb_inner_stride": (
        "streams", _swap(_streams_ok, 1,
                         lambda a: torch.zeros(2, 1, 16)[:, :, ::2]),
        ValueError),
    "streams_phi_inner_stride": (
        "streams", _swap(_streams_ok, 2,
                         lambda a: torch.zeros(2, 8, 3).transpose(1, 2)),
        ValueError),
    "streams_r_src_inner_stride": (
        "streams", _swap(_streams_ok, 5,
                         lambda a: torch.zeros(2, 3, 8, 2).transpose(2, 3)),
        ValueError),
    # A row expanded along time has stride 0 there: the kernel would read T
    # floats past its one element.
    "streams_xn_expanded_in_time": (
        "streams", _swap(_streams_ok, 0,
                         lambda a: torch.zeros(2, 3, 1).expand(2, 3, 8)),
        ValueError),
    "streams_xb_expanded_in_time": (
        "streams", _swap(_streams_ok, 1,
                         lambda a: torch.zeros(2, 1, 1).expand(2, 1, 8)),
        ValueError),
    "streams_phi_expanded_in_time": (
        "streams", _swap(_streams_ok, 2,
                         lambda a: torch.zeros(2, 3, 1).expand(2, 3, 8)),
        ValueError),
    "streams_r_src_expanded_in_time": (
        "streams", _swap(_streams_ok, 5,
                         lambda a: torch.zeros(2, 3, 2, 1).expand(2, 3, 2, 8)),
        ValueError),
    "streams_too_many_frames": (
        "streams", lambda: [
            torch.zeros(1, 1, MAX_T + 1), torch.zeros(1, 1, MAX_T + 1),
            torch.zeros(1, 1, MAX_T + 1), torch.zeros(1, dtype=torch.int64),
            _i32(1), torch.zeros(1, 1, 2, MAX_T + 1)], ValueError),
    "streams_phi_shape": ("streams",
                          _swap(_streams_ok, 2, lambda a: a[:, :2]),
                          ValueError),
    "streams_xb_shape": ("streams",
                         _swap(_streams_ok, 1, lambda a: a.expand(2, 2, 8)),
                         ValueError),
    "streams_r_src_shape": ("streams",
                            _swap(_streams_ok, 5, lambda a: a[:, :, :1]),
                            ValueError),
    "streams_rank": ("streams", _swap(_streams_ok, 0, lambda a: a[0]),
                     ValueError),
    "streams_olen_shape": ("streams",
                           _swap(_streams_ok, 3, lambda a: a[:1]),
                           ValueError),
    "streams_enc_len_not_contiguous": (
        "streams", _swap(_streams_ok, 4, lambda a: _i32(4)[::2]),
        ValueError),
    "streams_devices_differ": (
        "streams", _swap(_streams_ok, 5, lambda a: a.to("meta")),
        ValueError),
}


@pytest.mark.parametrize("route", ["plan", "cpu_route"])
@pytest.mark.parametrize("case", list(_REFUSALS))
def test_refusals(case, route):
    form, make, error = _REFUSALS[case]
    fn = {("ref", "plan"): _reference_plan,
          ("ref", "cpu_route"): ctc_forward_recursion,
          ("streams", "plan"): _streams_plan,
          ("streams", "cpu_route"): ctc_forward_recursion_streams}[form, route]
    with pytest.raises(error):
        fn(*make())


def test_accepted_operands_pass_the_plans():
    """The refusal cases' starting points are themselves accepted."""
    _reference_plan(*_ref_ok())
    _streams_plan(*_streams_ok())
    for ok, plan in ((_ref_ok, _reference_plan), (_streams_ok, _streams_plan)):
        args = ok()
        plan(*(a.bfloat16() for a in args[:2]), *args[2:])
    # A ring of one frame is never stepped along time: any stride there.
    one = [a[..., :1] for a in _streams_ok()[:3]]
    p = _streams_plan(*one, *_streams_ok()[3:5],
                      torch.zeros(2, 3, 2, 8)[..., ::8])
    assert (p.t_cap, p.xn_st, p.xb_st, p.phi_st) == (1, 1, 1, 1)


# ---------------------------------------------------------------------------
# The algebra of the CUDA kernel's scan
# ---------------------------------------------------------------------------

F32 = np.float32


def _lse2(a, b):
    mx, mn = max(a, b), min(a, b)
    return F32(mx + np.log1p(np.exp(max(F32(mn - mx), F32(-30.0)))))


def _then(first, second):
    """Two maps x -> lse(x + a, c) composed, first then second; None is no
    map (a frame outside the range), left out by predicate."""
    if first is None:
        return second
    if second is None:
        return first
    return (F32(first[0] + second[0]),
            _lse2(F32(first[1] + second[0]), second[1]))


def _apply(m, x):
    return x if m is None else _lse2(F32(x + m[0]), m[1])


def _inclusive(maps):
    """Hillis-Steele over one warp, as the shuffles do it."""
    delta = 1
    while delta < len(maps):
        maps = [m if i < delta else _then(maps[i - delta], m)
                for i, m in enumerate(maps)]
        delta *= 2
    return maps


def _exclusive_scan(maps, warp):
    """Per thread, the composition of all earlier threads' maps: a scan
    within each warp, then over the warps' totals."""
    warps = [_inclusive(maps[i:i + warp]) for i in range(0, len(maps), warp)]
    totals = [None] + _inclusive([w[-1] for w in warps])[:-1]
    return [_then(totals[wi], None if li == 0 else w[li - 1])
            for wi, w in enumerate(warps) for li in range(len(w))]


def scan_recursion(xn, xb, phi_shift, start, end, olen0, threads=8, warp=4):
    """A float32 model of csrc/ctc_recursion.cu for (T, N) numpy operands:
    per hypothesis, `threads` threads of `warp`-wide warps take consecutive
    frames each; r_n first, then r_b from r_n[t-1]."""
    t_cap, n_hyp = xn.shape
    per = -(-t_cap // threads)
    r = np.full((2, t_cap, n_hyp), LOGZERO, F32)
    for h in range(n_hyp):
        st, en = max(int(start[h]), 0), min(int(end[h]), t_cap)
        fill = np.full(t_cap, LOGZERO, F32)
        if olen0[h] > 0.5:
            fill[0] = xn[0, h]
        chunks = [(min(i * per, t_cap), min(i * per + per, t_cap))
                  for i in range(threads)]
        ranges = [(max(c0, st), min(c1, en)) for c0, c1 in chunks]

        def line(a, c_of, carry0, out_fill, step):
            maps = []
            for lo, hi in ranges:
                m = None
                for f in range(lo, hi):
                    m = _then(m, (a[f], F32(c_of(f) + a[f])))
                maps.append(m)
            out = out_fill.copy()
            for (lo, hi), before in zip(ranges, _exclusive_scan(maps, warp)):
                x = _apply(before, carry0)
                for f in range(lo, hi):
                    x = out[f] = step(x, f)
            return out

        rn = line(xn[:, h], lambda f: phi_shift[f, h],
                  F32(LOGZERO) if st == 0 else fill[st - 1], fill,
                  lambda x, f: F32(_lse2(x, phi_shift[f, h]) + xn[f, h]))

        def rn_before(f):
            return F32(LOGZERO) if f == 0 else rn[f - 1]

        rb = line(xb[:, h], rn_before, F32(LOGZERO),
                  np.full(t_cap, LOGZERO, F32),
                  lambda x, f: F32(_lse2(rn_before(f), x) + xb[f, h]))
        r[0, :, h], r[1, :, h] = rn, rb
    return r


@pytest.mark.parametrize("threads,warp", [(8, 4), (16, 4), (32, 8), (4, 4)])
@pytest.mark.parametrize("case", [c for c in _CASES if c != "strided"])
def test_scan_algebra_matches_the_sequential_recursion(case, threads, warp):
    """The scan (compose, warp-sized scans, the carry at start - 1, frames
    outside the range left out by predicate) against the frame-by-frame
    plain version: rtol 1e-5 on recursed frames (the sums associate in
    another order), fills equal to the last bit."""
    args = _reference_case(case, n_hyp=12, t_cap=37)
    with np.errstate(over="ignore"):
        got = scan_recursion(*args, threads=threads, warp=warp)
    ref = n(ctc_forward_recursion_plain(*(t(a) for a in args)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    start, end = args[3], args[4]
    t_idx = np.arange(37)[:, None]
    filled = (t_idx < start[None, :]) | (t_idx >= end[None, :])
    assert np.array_equal(got[:, filled], ref[:, filled])


def test_scan_algebra_on_a_long_blank_heavy_ring():
    """T = 768 with the log-probs of a blank-heavy softmax, where r reaches
    a few thousand: the scan stays within the tolerance the card's checks
    use, 1e-4 + 1e-5 * |ref|."""
    rng = np.random.default_rng(3)
    t_cap, n_hyp, vocab = 768, 3, 32
    logits = rng.standard_normal((t_cap, vocab)).astype(F32)
    logits[:, 0] += 6.0
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    xn = np.ascontiguousarray(logp[:, 1:1 + n_hyp]).astype(F32)
    xb = np.repeat(logp[:, :1], n_hyp, axis=1).astype(F32)
    phi = (_logp(rng, t_cap, n_hyp) * 3).astype(F32)
    phi[0] = LOGZERO
    start = np.array([1, 1, 9], np.int32)
    end = np.array([768, 300, 768], np.int32)
    olen0 = np.array([1, 0, 0], F32)
    got = scan_recursion(xn, xb, phi, start, end, olen0, threads=256, warp=32)
    ref = n(ctc_forward_recursion_plain(
        *(t(a) for a in (xn, xb, phi, start, end, olen0))))
    assert float(np.abs(ref[:, :768]).max()) > 1000.0
    assert np.all(np.abs(got - ref) <= 1e-4 + 1e-5 * np.abs(ref))
