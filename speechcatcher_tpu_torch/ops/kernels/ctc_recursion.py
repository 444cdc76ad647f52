"""CTC prefix forward recursion.

Port of ``speechcatcher_tpu/ops/pallas/ctc_recursion.py::
ctc_forward_recursion`` (``pallas_call`` at :88). Over t in [start, end) per
hypothesis:

    r_n[t] = lse(r_n[t-1], phi[t-1]) + x_n[t]
    r_b[t] = lse(r_n[t-1], r_b[t-1]) + x_b[t]

with ``lse(a, b) = max + log1p(exp(max(min - max, -30)))``; outside the range
r is LOGZERO, except ``r_n[0] = x_n[0]`` where the hypothesis has no token
yet.

Two forms over one device body (``csrc/ctc_recursion.cu``: a block per
hypothesis, the rows staged in shared memory, the recursion over
[start, end) alone and as a scan in log steps):

- ``ctc_forward_recursion``, the reference form, with the JAX function's
  signature: ``xn``, ``xb``, ``phi_shift`` (T, N) of any strides, ``start``,
  ``end``, ``olen0`` per hypothesis -> (2, T, N).
- ``ctc_forward_recursion_streams``, the main path's form, which reads the
  scorer's operands as they lie: time-minor (S, B, T) ``xn`` and ``phi``
  (unshifted: the kernel reads ``phi[t-1]``), the blank row as an (S, 1, T)
  view, ``olen`` and ``enc_len`` per stream, and ``r_src`` (S, B, 2, T),
  whose frames from ``end`` on are copied into the (S, B, 2, T) result.

Both routes check the operands alike, once per input signature: the plan
does every check and holds the launch's integers in a ``ctypes.Structure``,
cached under the signature. On a CUDA tensor a call is then one dict lookup,
the ``data_ptr()``s, one ``torch.empty``, the raw current stream and one
foreign call; on a CPU tensor it runs the ``*_plain`` twin.

The log-prob rows ``xn`` and ``xb`` come in the ring's dtype, float32 or
bfloat16 (both alike; any other dtype, or a mix, is refused); ``phi``,
``r_src`` and the result are float32. The kernel widens bfloat16 rows where
it stages them, which is exact: the result on bfloat16 rows equals, to the
last bit, the result on the same rows widened beforehand. The plain twins
widen with ``.float()``.

The kernel's scan adds the same float32 terms in another order than the
frame-by-frame plain version: they agree within ``1e-4 + 1e-5 * |ref|``
(about ten ulps where r reaches a few thousand), and to the last bit on
every frame outside [start, end). ``launches`` on ``ctc_forward_recursion``
counts the launches of both forms.
"""

from __future__ import annotations

import ctypes

import torch

from speechcatcher_tpu_torch.ops.kernels import _build, _plan

LOGZERO = -1.0e10
# kMaxT in csrc/ctc_recursion.cu: five rows of T floats a block, within the
# 48 KB of shared memory a block gets without opting in to more.
MAX_T = 2448
_LENGTH_DTYPES = (torch.int32, torch.int64)


class _CtcArgs(ctypes.Structure):
    """The launch's integers of ``sc_ctc_forward_recursion`` and
    ``sc_ctc_forward_recursion_streams`` (``CtcArgs``): strides in elements
    over stream, beam and time (the reference form is N streams of beam 1),
    ``r_src``'s over stream, beam and plane."""

    _fields_ = (
        [(f"{t}_s{d}", ctypes.c_longlong)
         for t in ("xn", "xb", "phi") for d in "sbt"]
        + [(f"src_s{d}", ctypes.c_longlong) for d in "sbk"]
        + [(name, ctypes.c_int)
           for name in ("s_dim", "beam", "t_cap", "olen_bytes", "enc_bytes",
                        "vec", "row_bytes")])


def _lse2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    return mx + torch.log1p(torch.exp(torch.clamp(mn - mx, min=-30.0)))


_ROW_DTYPES = (torch.float32, torch.bfloat16)


def _check_common(name: str, rows: dict, lengths: dict, s_dim: int,
                  t_cap: int, length_dtypes: dict) -> int:
    """The checks both forms share: xn and xb of one dtype, float32 or
    bfloat16, every other row float32; per-stream vectors of the expected
    shape and dtype, contiguous; one device; 1 <= T <= MAX_T. Returns the
    log-prob rows' element size."""
    xn, xb = rows["xn"], rows["xb"]
    if xn.dtype not in _ROW_DTYPES:
        raise TypeError(f"{name}: xn and xb must be float32 or bfloat16, "
                        f"xn is {xn.dtype}")
    if xb.dtype != xn.dtype:
        raise TypeError(f"{name}: xn and xb must share one dtype, got "
                        f"{xn.dtype} and {xb.dtype}")
    for what, a in rows.items():
        if what not in ("xn", "xb") and a.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {a.dtype}")
    for what, a in lengths.items():
        if a.shape != (s_dim,):
            raise ValueError(f"{name}: {what} must be ({s_dim},), got "
                             f"{tuple(a.shape)}")
        if a.dtype not in length_dtypes[what]:
            raise TypeError(f"{name}: {what} must be "
                            f"{' or '.join(map(str, length_dtypes[what]))}, "
                            f"got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    _plan.check_devices(name, *rows.values(), *lengths.values())
    if not 1 <= t_cap <= MAX_T:
        raise ValueError(f"{name}: 1 to {MAX_T} frames, got T={t_cap}")
    return xn.element_size()


def _reference_plan(xn, xb, phi_shift, start, end, olen0) -> _CtcArgs:
    """Check a ``ctc_forward_recursion`` signature; its launch arguments."""
    name = "ctc_forward_recursion"
    if xn.dim() != 2 or xb.shape != xn.shape or phi_shift.shape != xn.shape:
        raise ValueError(f"{name}: xn, xb, phi_shift must share one (T, N) "
                         f"shape, got {tuple(xn.shape)}, {tuple(xb.shape)}, "
                         f"{tuple(phi_shift.shape)}")
    t_cap, n = xn.shape
    rows = {"xn": xn, "xb": xb, "phi_shift": phi_shift}
    row_bytes = _check_common(
        name, rows, {"start": start, "end": end, "olen0": olen0}, n, t_cap,
        {"start": (torch.int32,), "end": (torch.int32,),
         "olen0": (torch.float32,)})
    st = []
    for a in rows.values():
        s_t, s_n = _plan.strides(a)
        st += [s_n, 0, s_t]
    return _CtcArgs(*st, 0, 0, 0, n, 1, t_cap, 0, 0, 0, row_bytes)


def _streams_plan(xn, xb, phi, olen, enc_len, r_src) -> _CtcArgs:
    """Check a ``ctc_forward_recursion_streams`` signature; its launch
    arguments."""
    name = "ctc_forward_recursion_streams"
    if xn.dim() != 3 or phi.shape != xn.shape:
        raise ValueError(f"{name}: xn and phi must share one (S, B, T) "
                         f"shape, got {tuple(xn.shape)} and "
                         f"{tuple(phi.shape)}")
    s_dim, beam, t_cap = xn.shape
    if tuple(xb.shape) not in ((s_dim, 1, t_cap), (s_dim, beam, t_cap)):
        raise ValueError(f"{name}: xb must be ({s_dim}, 1, {t_cap}) or "
                         f"({s_dim}, {beam}, {t_cap}), got {tuple(xb.shape)}")
    if tuple(r_src.shape) != (s_dim, beam, 2, t_cap):
        raise ValueError(f"{name}: r_src must be ({s_dim}, {beam}, 2, "
                         f"{t_cap}), got {tuple(r_src.shape)}")
    rows = {"xn": xn, "xb": xb, "phi": phi, "r_src": r_src}
    row_bytes = _check_common(
        name, rows, {"olen": olen, "enc_len": enc_len}, s_dim, t_cap,
        {"olen": _LENGTH_DTYPES, "enc_len": _LENGTH_DTYPES})
    # The kernel steps every row along time at stride 1 (a row expanded
    # along time, stride 0, would be read past its one element).
    for what, a in rows.items():
        if t_cap > 1 and a.stride(-1) != 1:
            raise ValueError(f"{name}: {what}'s last dim must be contiguous "
                             f"(strides {a.stride()})")
    st = {what: _plan.strides(a) for what, a in rows.items()}
    # 16-byte loads need every row to start on a multiple of 16 bytes: four
    # float32, eight bfloat16 (the C entry point checks the base pointers
    # and else goes scalar).
    per_load = 16 // row_bytes
    vec = t_cap % per_load == 0 and all(
        x % per == 0 for what, per in (("xn", per_load), ("xb", per_load),
                                       ("phi", 4)) for x in st[what][:2])
    return _CtcArgs(*st["xn"][:2], 1, *st["xb"][:2], 1, *st["phi"][:2], 1,
                    *st["r_src"][:3], s_dim, beam, t_cap,
                    olen.element_size(), enc_len.element_size(), int(vec),
                    row_bytes)


def ctc_forward_recursion_plain(xn, xb, phi_shift, start, end, olen0):
    """Plain PyTorch version. The loop runs only over the frames some
    hypothesis recurses on; every other frame holds its init value, which
    is also the carry the recursion would have entered with."""
    t_cap, n = xn.shape
    xn, xb, phi_shift = xn.float(), xb.float(), phi_shift.float()
    start = start.long()
    end = end.long()
    init0 = olen0 > 0.5
    r = torch.full((2, t_cap, n), LOGZERO, dtype=torch.float32,
                   device=xn.device)
    r[0, 0] = torch.where(init0, xn[0], LOGZERO)
    lo = int(start.clamp(0, t_cap).min())
    hi = int(torch.maximum(end, start).clamp(0, t_cap).max())
    if lo > 0:
        rn, rb = r[0, lo - 1].clone(), r[1, lo - 1].clone()
    else:
        rn = torch.full((n,), LOGZERO, dtype=torch.float32, device=xn.device)
        rb = rn.clone()
    for t in range(lo, hi):
        in_rec = (t >= start) & (t < end)
        rn_rec = _lse2(rn, phi_shift[t]) + xn[t]
        rb_rec = _lse2(rn, rb) + xb[t]
        rn = torch.where(in_rec, rn_rec, r[0, t])
        rb = torch.where(in_rec, rb_rec, r[1, t])
        r[0, t] = rn
        r[1, t] = rb
    return r


def ctc_forward_recursion_streams_plain(xn, xb, phi, olen, enc_len, r_src):
    """Plain PyTorch version of the main path's form, on
    ``ctc_forward_recursion_plain``."""
    s_dim, beam, t_cap = xn.shape
    n = s_dim * beam
    xn, xb = xn.float(), xb.float()
    olen = olen.long()
    end = enc_len.long()
    phi_shift = torch.cat(
        [torch.full_like(phi[:, :, :1], LOGZERO), phi[:, :, :-1]], dim=2)

    def to_tn(a):  # (S, B or 1, T) -> (T, N)
        return a.expand(s_dim, beam, t_cap).reshape(n, t_cap).t()

    r_tn = ctc_forward_recursion_plain(
        to_tn(xn), to_tn(xb), to_tn(phi_shift),
        olen.clamp(min=1).clamp(max=t_cap).repeat_interleave(beam),
        end.repeat_interleave(beam),
        (olen == 0).float().repeat_interleave(beam))
    r_new = r_tn.permute(2, 0, 1).reshape(s_dim, beam, 2, t_cap)
    # Frames at or after end keep the source hypothesis' values.
    valid = torch.arange(t_cap, device=xn.device)[None, :] < end[:, None]
    return torch.where(valid[:, None, None, :], r_new, r_src).contiguous()


def _signature(*operands) -> tuple:
    return tuple(x for a in operands
                 for x in (a.shape, a.stride(), a.dtype, a.device))


_PLANS: dict = {}
_STREAMS_PLANS: dict = {}


def ctc_forward_recursion(xn: torch.Tensor, xb: torch.Tensor,
                          phi_shift: torch.Tensor, start: torch.Tensor,
                          end: torch.Tensor, olen0: torch.Tensor
                          ) -> torch.Tensor:
    """The reference form. xn, xb (T, N) float32 or bfloat16 (both alike)
    and phi_shift (T, N) float32, any strides (phi_shift[t] is phi[t-1],
    LOGZERO at t = 0); start, end (N,) int32;
    olen0 (N,) float32, 1.0 where the hypothesis has no token yet -> r
    (2, T, N) float32 [r_n, r_b], LOGZERO outside [start, end)."""
    _plan.refuse_grad("ctc_forward_recursion", xn, xb, phi_shift, olen0)
    key = _signature(xn, xb, phi_shift, start, end, olen0)
    plan = _PLANS.get(key)
    if plan is None:
        args = _reference_plan(xn, xb, phi_shift, start, end, olen0)
        plan = _plan.launch(_PLANS, key, args, "sc_ctc_forward_recursion",
                            xn.device, (2, args.t_cap, args.s_dim))
    if plan.fn is None:
        return ctc_forward_recursion_plain(xn, xb, phi_shift, start, end,
                                           olen0)
    r = torch.empty(plan.out_shape, dtype=torch.float32, device=xn.device)
    err = plan.fn(xn.data_ptr(), xb.data_ptr(), phi_shift.data_ptr(),
                  start.data_ptr(), end.data_ptr(), olen0.data_ptr(),
                  r.data_ptr(), plan.address, _build.stream_ptr(xn))
    if err:
        _plan.raise_launch_error("ctc_forward_recursion", err)
    _plan.count(ctc_forward_recursion)
    return r


ctc_forward_recursion.launches = 0


def ctc_forward_recursion_streams(xn: torch.Tensor, xb: torch.Tensor,
                                  phi: torch.Tensor, olen: torch.Tensor,
                                  enc_len: torch.Tensor, r_src: torch.Tensor
                                  ) -> torch.Tensor:
    """The main path's form, for S streams of B hypotheses. xn (S, B, T)
    and xb (S, 1, T) or (S, B, T) in the ring's dtype, float32 or bfloat16
    (both alike), phi (S, B, T) float32, all with inner stride 1 (phi
    unshifted); olen, enc_len (S,) int32 or int64: the recursion runs
    over [min(max(olen, 1), T), enc_len), with r_n[0] = x_n[0] where olen is
    0; r_src (S, B, 2, T) float32 -> a new contiguous (S, B, 2, T) float32
    r, equal to r_src from enc_len on."""
    _plan.refuse_grad("ctc_forward_recursion_streams", xn, xb, phi, r_src)
    key = _signature(xn, xb, phi, olen, enc_len, r_src)
    plan = _STREAMS_PLANS.get(key)
    if plan is None:
        args = _streams_plan(xn, xb, phi, olen, enc_len, r_src)
        plan = _plan.launch(
            _STREAMS_PLANS, key, args, "sc_ctc_forward_recursion_streams",
            xn.device, (args.s_dim, args.beam, 2, args.t_cap))
    if plan.fn is None:
        return ctc_forward_recursion_streams_plain(xn, xb, phi, olen,
                                                   enc_len, r_src)
    r = torch.empty(plan.out_shape, dtype=torch.float32, device=xn.device)
    err = plan.fn(xn.data_ptr(), xb.data_ptr(), phi.data_ptr(),
                  olen.data_ptr(), enc_len.data_ptr(), r_src.data_ptr(),
                  r.data_ptr(), plan.address, _build.stream_ptr(xn))
    if err:
        _plan.raise_launch_error("ctc_forward_recursion_streams", err)
    _plan.count(ctc_forward_recursion)
    return r
