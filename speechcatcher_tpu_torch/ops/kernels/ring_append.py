"""In-place appends on the engine's rings: columns of the time-minor CTC
log-prob ring and rows of the (L, S, T, D) frame rings.

Ports of ``speechcatcher_tpu/ops/pallas/ring_append.py``:

- ``ring_append_cols`` (``pallas_call`` at :227):
  ``ring[s, :, start[s]+i] = new[s, :, i]`` for ``i < min(n_new[s], TN)``;
- ``ring_append_rows`` (``pallas_call`` at :147):
  ``cache[l, s, start[s]+i, :] = new[l, s, i, :]`` for the same ``i``.

``start`` is clipped to [0, T-1] and whatever lands at or past T is dropped.
The ring is written IN PLACE (the JAX versions donate it) and returned.
float32 and bfloat16 rings; ``new`` is of the ring's dtype or float32, cast
on the way in as the JAX versions cast (``new.astype(ring.dtype)``), and may
have any strides (``ring_append_rows`` needs its last dim contiguous), so
callers pass their producers' tensors as they are.

Both routes check the operands alike, once per input signature: the plan
(``_cols_plan`` / ``_rows_plan``, plain Python) does every check and holds
the launch's integers in a ``ctypes.Structure``, cached under the
signature. On a CUDA tensor a call is then one dict lookup, four
``data_ptr()`` reads, the raw current stream and one foreign call into
``csrc/ring_append.cu`` (only the written elements move); on a CPU tensor it
runs the ``*_plain`` twin.
"""

from __future__ import annotations

import ctypes

import torch

from speechcatcher_tpu_torch.ops.kernels import _build, _plan

_RING_DTYPES = (torch.float32, torch.bfloat16)


class _ColsArgs(ctypes.Structure):
    """The launch's integers of ``sc_ring_append_cols`` (``ColsArgs``)."""

    _fields_ = [("new_ss", ctypes.c_longlong), ("new_sv", ctypes.c_longlong),
                ("new_st", ctypes.c_longlong), ("s_dim", ctypes.c_int),
                ("v_dim", ctypes.c_int), ("t_cap", ctypes.c_int),
                ("tn", ctypes.c_int), ("in_bytes", ctypes.c_int),
                ("out_bytes", ctypes.c_int), ("t_fastest", ctypes.c_int)]


class _RowsArgs(ctypes.Structure):
    """The launch's integers of ``sc_ring_append_rows`` (``RowsArgs``)."""

    _fields_ = [("new_sl", ctypes.c_longlong), ("new_ss", ctypes.c_longlong),
                ("new_st", ctypes.c_longlong), ("l_dim", ctypes.c_int),
                ("s_dim", ctypes.c_int), ("t_cap", ctypes.c_int),
                ("tn", ctypes.c_int), ("d", ctypes.c_int),
                ("in_bytes", ctypes.c_int), ("out_bytes", ctypes.c_int)]


def _signature(ring, new, start, n_new) -> tuple:
    return (ring.shape, ring.stride(), ring.dtype, ring.device,
            new.shape, new.stride(), new.dtype, new.device,
            start.shape, start.stride(), start.dtype, start.device,
            n_new.shape, n_new.stride(), n_new.dtype, n_new.device)


def _check_common(name: str, ring, new, start, n_new) -> None:
    """The checks both kernels share (S is the ring's third dim from the
    end)."""
    if ring.dtype not in _RING_DTYPES:
        raise TypeError(f"{name}: ring dtype {ring.dtype} unsupported")
    if new.dtype not in (ring.dtype, torch.float32):
        raise TypeError(f"{name}: new is {new.dtype}, ring is {ring.dtype} "
                        "(the ring's dtype or float32 expected)")
    s_dim = ring.shape[-3]
    for what, a in (("start", start), ("n_new", n_new)):
        if a.shape != (s_dim,):
            raise ValueError(f"{name}: {what} must be ({s_dim},), got "
                             f"{tuple(a.shape)}")
        if a.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    _plan.check_devices(name, ring, new, start, n_new)
    if not ring.is_contiguous():
        raise ValueError(f"{name}: the ring must be contiguous")


def _cols_plan(ring, new, start, n_new) -> _ColsArgs:
    """Check a ``ring_append_cols`` signature; its launch arguments."""
    if ring.dim() != 3 or new.dim() != 3 or new.shape[:2] != ring.shape[:2]:
        raise ValueError(f"ring_append_cols: ring (S, V, T) and new "
                         f"(S, V, TN) expected, got {tuple(ring.shape)} and "
                         f"{tuple(new.shape)}")
    _check_common("ring_append_cols", ring, new, start, n_new)
    s_dim, v_dim, t_cap = ring.shape
    ss, sv, st = _plan.strides(new)
    return _ColsArgs(ss, sv, st, s_dim, v_dim, t_cap, new.shape[2],
                     new.element_size(), ring.element_size(), int(st == 1))


def _rows_plan(cache, new, start, n_new) -> _RowsArgs:
    """Check a ``ring_append_rows`` signature; its launch arguments."""
    if (cache.dim() != 4 or new.dim() != 4 or new.shape[:2] != cache.shape[:2]
            or new.shape[3] != cache.shape[3]):
        raise ValueError(f"ring_append_rows: cache (L, S, T, D) and new "
                         f"(L, S, TN, D) expected, got {tuple(cache.shape)} "
                         f"and {tuple(new.shape)}")
    l_dim, s_dim, t_cap, d = cache.shape
    if t_cap == 0:
        raise ValueError("ring_append_rows: the ring holds no rows")
    _check_common("ring_append_rows", cache, new, start, n_new)
    sl, ss, st, sd = _plan.strides(new)
    if sd not in (0, 1):
        raise ValueError("ring_append_rows: new's last dim must be "
                         "contiguous")
    return _RowsArgs(sl, ss, st, l_dim, s_dim, t_cap, new.shape[2], d,
                     new.element_size(), cache.element_size())


def _launch(plans: dict, key: tuple, planner, entry: str, ring, new, start,
            n_new) -> _plan.Launch:
    """Plan a new signature and cache it."""
    return _plan.launch(plans, key, planner(ring, new, start, n_new), entry,
                        ring.device)


def ring_append_cols_plain(ring, new, start, n_new):
    """Plain PyTorch version; writes into ``ring`` and returns it."""
    s_dim, _, t_cap = ring.shape
    tn = new.shape[2]
    starts = start.clamp(0, t_cap - 1).tolist()
    counts = n_new.tolist()
    for s in range(s_dim):
        cnt = max(0, min(int(counts[s]), tn, t_cap - starts[s]))
        if cnt:
            ring[s, :, starts[s]:starts[s] + cnt] = new[s, :, :cnt].to(ring.dtype)
    return ring


_COLS_PLANS: dict = {}


def ring_append_cols(ring: torch.Tensor, new: torch.Tensor,
                     start: torch.Tensor, n_new: torch.Tensor) -> torch.Tensor:
    """ring (S, V, T) float32/bfloat16, contiguous, modified in place; new
    (S, V, TN) of the ring's dtype or float32, any strides (the transposed
    view of time-major (S, TN, V) log-probs reads as it lies); start, n_new
    (S,) int32. Returns ring."""
    _plan.refuse_grad("ring_append_cols", ring, new)
    key = _signature(ring, new, start, n_new)
    plan = _COLS_PLANS.get(key) or _launch(
        _COLS_PLANS, key, _cols_plan, "sc_ring_append_cols", ring, new,
        start, n_new)
    if plan.fn is None:
        return ring_append_cols_plain(ring, new, start, n_new)
    err = plan.fn(ring.data_ptr(), new.data_ptr(), start.data_ptr(),
                  n_new.data_ptr(), plan.address, _build.stream_ptr(ring))
    if err:
        _plan.raise_launch_error("ring_append_cols", err)
    _plan.count(ring_append_cols)
    return ring


ring_append_cols.launches = 0


def ring_append_rows_plain(cache, new, start, n_new):
    """Plain PyTorch version; writes into ``cache`` and returns it."""
    _, s_dim, t_cap, _ = cache.shape
    tn = new.shape[2]
    starts = start.clamp(0, t_cap - 1).tolist()
    counts = n_new.tolist()
    for s in range(s_dim):
        cnt = max(0, min(int(counts[s]), tn, t_cap - starts[s]))
        if cnt:
            cache[:, s, starts[s]:starts[s] + cnt] = new[:, s, :cnt].to(
                cache.dtype)
    return cache


_ROWS_PLANS: dict = {}


def ring_append_rows(cache: torch.Tensor, new: torch.Tensor,
                     start: torch.Tensor, n_new: torch.Tensor) -> torch.Tensor:
    """cache (L, S, T, D) float32/bfloat16, contiguous, modified in place;
    new (L, S, TN, D) of the cache's dtype or float32, any strides on its
    first three dims, its last dim contiguous; start, n_new (S,) int32.
    Returns cache."""
    _plan.refuse_grad("ring_append_rows", cache, new)
    key = _signature(cache, new, start, n_new)
    plan = _ROWS_PLANS.get(key) or _launch(
        _ROWS_PLANS, key, _rows_plan, "sc_ring_append_rows", cache, new,
        start, n_new)
    if plan.fn is None:
        return ring_append_rows_plain(cache, new, start, n_new)
    err = plan.fn(cache.data_ptr(), new.data_ptr(), start.data_ptr(),
                  n_new.data_ptr(), plan.address, _build.stream_ptr(cache))
    if err:
        _plan.raise_launch_error("ring_append_rows", err)
    _plan.count(ring_append_rows)
    return cache


ring_append_rows.launches = 0
