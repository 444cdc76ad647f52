"""Residual add, bias add, LayerNorm and the decoder cache's row write in
one kernel (F), for the decoder's beam step.

It ports no TPU kernel (the JAX package's norms are XLA fusions): it exists
because the port's beam step is bound by its kernel count. One call on rows
(N, d) computes

- ``h_new = h + (y + bias)``, ``y`` and ``bias`` optional (without ``y``,
  ``h_new`` is ``h`` itself);
- ``hn = layer_norm(p, h_new)``, the formula of ``ops.layers.layer_norm``
  (variance as the mean of squared deviations, eps 1e-12);
- optionally ``cache[row, min(pos[row], Lmax-1)] = hn`` cast to the cache's
  dtype (round to nearest even for bfloat16), only where ``write[row]`` and
  ``pos[row] < Lmax``: a row past the capacity is dropped, a row that does
  not write leaves the old value (``decoder_step``'s write; ``pos`` is
  never negative there).

and returns ``(h_new, hn)``, both float32. ``add_layer_norm_plain`` is that
composition in PyTorch, operation for operation, so on the CPU the decoder
computes what it computed before the kernel existed, to the bit.

The plan (``_plan_args``, plain Python) checks a signature once and caches
the launch's integers: float32 rows (N, d) with inner stride 1, d a
multiple of 4 up to 1024, float32 (d,) weight, beta and bias, a float32 or
bfloat16 (N, Lmax, d) cache with inner stride 1, int64 ``pos`` and bool
``write`` of (N,). It refuses anything else before the CPU/CUDA branch.
On a CUDA tensor a call is one dict lookup, two ``torch.empty``, the
``data_ptr()``s and one foreign call into ``csrc/add_layer_norm.cu`` (one
warp a row); on a CPU tensor it runs the plain twin. The kernel has no
backward: a call on operands that require grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from speechcatcher_tpu_torch.ops.kernels import _build, _plan
from speechcatcher_tpu_torch.ops.layers import LAYERNORM_EPS, layer_norm

MAX_D = 1024           # 32 lanes x kMaxVec float4s in the kernel
_CACHE_DTYPES = (torch.float32, torch.bfloat16)
_SMS = 132             # streaming multiprocessors of the H100
_MAX_ROWS_PER_BLOCK = 8


class _Args(ctypes.Structure):
    """The launch's integers of ``sc_add_layer_norm`` (``AddLayerNormArgs``
    in ``csrc/add_layer_norm.cu``)."""

    _fields_ = [("h_rs", ctypes.c_longlong), ("y_rs", ctypes.c_longlong),
                ("cache_rs", ctypes.c_longlong),
                ("cache_ps", ctypes.c_longlong), ("n", ctypes.c_int),
                ("d", ctypes.c_int), ("lmax", ctypes.c_int),
                ("has_y", ctypes.c_int), ("has_bias", ctypes.c_int),
                ("cache_bytes", ctypes.c_int),
                ("rows_per_block", ctypes.c_int), ("eps", ctypes.c_float)]


def rows_per_block(n: int) -> int:
    """Warps (rows) of one block: one while the rows do not fill the SMs,
    then the largest power of two up to 8 that still leaves every SM a
    block."""
    rpb = 1
    while rpb < _MAX_ROWS_PER_BLOCK and n >= 2 * rpb * _SMS:
        rpb *= 2
    return rpb


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _meta(t: Optional[torch.Tensor]) -> tuple:
    return () if t is None else (t.shape, t.stride(), t.dtype, t.device)


def _check_vector(what: str, t: torch.Tensor, d: int) -> None:
    if t.shape != (d,) or t.dtype != torch.float32 or t.stride() != (1,):
        raise ValueError(f"add_layer_norm: {what} must be a contiguous "
                         f"float32 ({d},), got {tuple(t.shape)} {t.dtype} "
                         f"strides {t.stride()}")


def _check_rows(what: str, t: torch.Tensor, shape) -> None:
    if (t.dim() != 2 or tuple(t.shape) != tuple(shape)
            or t.dtype != torch.float32 or t.stride(1) != 1):
        raise ValueError(f"add_layer_norm: {what} must be float32 "
                         f"{tuple(shape)} rows with inner stride 1, got "
                         f"{tuple(t.shape)} {t.dtype} strides {t.stride()}")


def _plan_args(p, h, y, bias, cache, pos, write) -> _Args:
    """Check a signature; its launch arguments."""
    if h.dim() != 2:
        raise ValueError(f"add_layer_norm: h must be (N, d) rows, got "
                         f"{tuple(h.shape)}")
    n, d = h.shape
    if d == 0 or d % 4 or d > MAX_D:
        raise ValueError(f"add_layer_norm: d = {d} unsupported (a multiple "
                         f"of 4 up to {MAX_D})")
    _check_rows("h", h, (n, d))
    _check_vector("weight", p["weight"], d)
    _check_vector("beta", p["bias"], d)
    tensors = [h, p["weight"], p["bias"]]
    if y is not None:
        _check_rows("y", y, (n, d))
        tensors.append(y)
    if bias is not None:
        if y is None:
            raise ValueError("add_layer_norm: a bias without y")
        _check_vector("bias", bias, d)
        tensors.append(bias)
    given = [a is not None for a in (cache, pos, write)]
    if any(given) and not all(given):
        raise ValueError("add_layer_norm: cache, pos and write come together")
    lmax = cache_rs = cache_ps = cache_bytes = 0
    if cache is not None:
        if (cache.dim() != 3 or cache.shape[0] != n or cache.shape[2] != d
                or cache.shape[1] == 0 or cache.stride(2) != 1):
            raise ValueError(f"add_layer_norm: cache must be (N, Lmax, d) = "
                             f"({n}, Lmax, {d}) with inner stride 1, got "
                             f"{tuple(cache.shape)} strides {cache.stride()}")
        if cache.dtype not in _CACHE_DTYPES:
            raise TypeError(f"add_layer_norm: cache dtype {cache.dtype} "
                            "unsupported")
        for what, a, dtype in (("pos", pos, torch.int64),
                               ("write", write, torch.bool)):
            if a.shape != (n,) or a.dtype != dtype or a.stride() != (1,):
                raise ValueError(f"add_layer_norm: {what} must be a "
                                 f"contiguous {dtype} ({n},), got "
                                 f"{tuple(a.shape)} {a.dtype}")
        lmax = cache.shape[1]
        cache_rs, cache_ps = _plan.strides(cache)[:2]
        cache_bytes = cache.element_size()
        tensors += [cache, pos, write]
    _plan.check_devices("add_layer_norm", *tensors)
    return _Args(_plan.strides(h)[0], 0 if y is None else _plan.strides(y)[0],
                 cache_rs,
                 cache_ps, n, d, lmax, int(y is not None),
                 int(bias is not None), cache_bytes, rows_per_block(n),
                 LAYERNORM_EPS)


def add_layer_norm_plain(p, h, y=None, bias=None, cache=None, pos=None,
                         write=None):
    """Plain PyTorch version: ``ops.layers.layer_norm`` of ``h + (y +
    bias)`` and ``decoder_step``'s fixed-shape write of the cache row."""
    if y is not None:
        h = h + (y if bias is None else y + bias)
    hn = layer_norm(p, h)
    if cache is not None:
        lmax = cache.shape[1]
        keep = (write & (pos < lmax))[:, None]
        rows = torch.arange(h.shape[0], device=h.device)
        at = pos.clamp(max=lmax - 1)
        cache[rows, at] = torch.where(keep, hn.to(cache.dtype),
                                      cache[rows, at])
    return h, hn


_PLANS: dict = {}


def add_layer_norm(p, h: torch.Tensor, y: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   cache: Optional[torch.Tensor] = None,
                   pos: Optional[torch.Tensor] = None,
                   write: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p: a norm's {"weight", "bias"}; h, y (N, d) float32 rows; bias (d,);
    cache (N, Lmax, d) float32/bfloat16, written in place; pos (N,) int64;
    write (N,) bool. Returns (h + (y + bias), its LayerNorm), both (N, d)
    float32; the first is `h` itself without `y`."""
    _plan.refuse_grad("add_layer_norm", *(a for a in (
        h, y, bias, p["weight"], p["bias"]) if a is not None))
    key = (_meta(h), _meta(y), _meta(bias), _meta(p["weight"]),
           _meta(p["bias"]), _meta(cache), _meta(pos), _meta(write))
    plan = _PLANS.get(key) or _plan.launch(
        _PLANS, key, _plan_args(p, h, y, bias, cache, pos, write),
        "sc_add_layer_norm", h.device)
    if plan.fn is None:
        return add_layer_norm_plain(p, h, y, bias, cache, pos, write)
    hn = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    h_new = h if y is None else torch.empty_like(hn)
    err = plan.fn(h.data_ptr(), _ptr(y), _ptr(bias), p["weight"].data_ptr(),
                  p["bias"].data_ptr(), h_new.data_ptr(), hn.data_ptr(),
                  _ptr(cache), _ptr(pos), _ptr(write), plan.address,
                  _build.stream_ptr(h))
    if err:
        _plan.raise_launch_error("add_layer_norm", err)
    _plan.count(add_layer_norm)
    return h_new, hn


add_layer_norm.launches = 0
