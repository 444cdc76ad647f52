"""In-place appends on the engine's rings: columns of the time-minor CTC
log-prob ring and rows of the (L, S, T, D) frame rings.

Ports of ``speechcatcher_tpu/ops/pallas/ring_append.py``:

- ``ring_append_cols`` (``pallas_call`` at :227):
  ``ring[s, :, start[s]+i] = new[s, :, i]`` for ``i < min(n_new[s], TN)``;
- ``ring_append_rows`` (``pallas_call`` at :147):
  ``cache[l, s, start[s]+i, :] = new[l, s, i, :]`` for the same ``i``.

``start`` is clipped to [0, T-1] and whatever lands at or past T is dropped.
The ring is written IN PLACE (the JAX versions donate it) and returned. On a
CUDA tensor each wrapper launches its kernel in ``csrc/ring_append.cu``
(only the written elements move); on a CPU tensor it runs its ``*_plain``
twin. float32 and bfloat16 rings.
"""

from __future__ import annotations

import torch

from speechcatcher_tpu_torch.ops.kernels import _build

_ENTRY = {torch.float32: "sc_ring_append_cols_f32",
          torch.bfloat16: "sc_ring_append_cols_bf16"}


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


def ring_append_cols(ring: torch.Tensor, new: torch.Tensor,
                     start: torch.Tensor, n_new: torch.Tensor) -> torch.Tensor:
    """ring (S, V, T) float32/bfloat16, modified in place; new (S, V, TN) of
    the ring's dtype; start, n_new (S,) int32. Returns ring."""
    if ring.dim() != 3 or new.dim() != 3 or new.shape[:2] != ring.shape[:2]:
        raise ValueError(f"ring_append_cols: ring (S, V, T) and new "
                         f"(S, V, TN) expected, got {tuple(ring.shape)} and "
                         f"{tuple(new.shape)}")
    s_dim, v_dim, t_cap = ring.shape
    if start.shape != (s_dim,) or n_new.shape != (s_dim,):
        raise ValueError("ring_append_cols: start and n_new must be (S,)")
    if ring.dtype not in _ENTRY:
        raise TypeError(f"ring_append_cols: ring dtype {ring.dtype} "
                        "unsupported")
    if ring.device.type == "cpu":
        return ring_append_cols_plain(ring, new, start, n_new)
    if new.dtype != ring.dtype:
        raise TypeError(f"ring_append_cols: new is {new.dtype}, ring is "
                        f"{ring.dtype}")
    for name, a in (("start", start), ("n_new", n_new)):
        if a.dtype != torch.int32:
            raise TypeError(f"ring_append_cols: {name} must be int32")
    _build.check_cuda("ring_append_cols", ring, new, start, n_new)
    lib = _build.library()
    lib.call(_ENTRY[ring.dtype], ring.data_ptr(), new.data_ptr(),
             start.data_ptr(), n_new.data_ptr(), s_dim, v_dim, t_cap,
             new.shape[2], _build.stream_ptr(ring))
    ring_append_cols.launches += 1
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


def _unit_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest copy unit (16, 4 or 2 bytes) that divides the row pitch
    and both base addresses."""
    for unit in (16, 4, 2):
        if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    raise ValueError(f"ring_append_rows: rows of {row_bytes} B are not "
                     "2-byte aligned")


def ring_append_rows(cache: torch.Tensor, new: torch.Tensor,
                     start: torch.Tensor, n_new: torch.Tensor) -> torch.Tensor:
    """cache (L, S, T, D) float32/bfloat16, modified in place; new
    (L, S, TN, D) of the cache's dtype; start, n_new (S,) int32. Returns
    cache."""
    if (cache.dim() != 4 or new.dim() != 4 or new.shape[:2] != cache.shape[:2]
            or new.shape[3] != cache.shape[3]):
        raise ValueError(f"ring_append_rows: cache (L, S, T, D) and new "
                         f"(L, S, TN, D) expected, got {tuple(cache.shape)} "
                         f"and {tuple(new.shape)}")
    l_dim, s_dim, t_cap, d_dim = cache.shape
    if start.shape != (s_dim,) or n_new.shape != (s_dim,):
        raise ValueError("ring_append_rows: start and n_new must be (S,)")
    if t_cap == 0:
        raise ValueError("ring_append_rows: the ring holds no rows")
    if cache.dtype not in _ENTRY:
        raise TypeError(f"ring_append_rows: cache dtype {cache.dtype} "
                        "unsupported")
    if cache.device.type == "cpu":
        return ring_append_rows_plain(cache, new, start, n_new)
    if new.dtype != cache.dtype:
        raise TypeError(f"ring_append_rows: new is {new.dtype}, cache is "
                        f"{cache.dtype}")
    for name, a in (("start", start), ("n_new", n_new)):
        if a.dtype != torch.int32:
            raise TypeError(f"ring_append_rows: {name} must be int32")
    _build.check_cuda("ring_append_rows", cache, new, start, n_new)
    row_bytes = d_dim * cache.element_size()
    unit = _unit_bytes(row_bytes, cache.data_ptr(), new.data_ptr())
    lib = _build.library()
    lib.call("sc_ring_append_rows", cache.data_ptr(), new.data_ptr(),
             start.data_ptr(), n_new.data_ptr(), l_dim, s_dim, t_cap,
             new.shape[2], row_bytes, unit, _build.stream_ptr(cache))
    ring_append_rows.launches += 1
    return cache


ring_append_rows.launches = 0
