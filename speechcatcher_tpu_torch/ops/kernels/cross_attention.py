"""The decoder beam step's cross-attention over a block's projected K/V, in
one kernel (H).

It ports no TPU kernel (the JAX package's cross-attention is XLA). It exists
because the composition it replaces contracted every query with all T rows
of the K/V ring and masked the rows at or past the stream's encoder length
afterwards, though only those below it count. One call, for N = S·B
hypotheses (B a stream, in (S, B) order), takes

- ``q`` (N, h·dk) float32: the queries, h the heads this rank holds;
- ``mk``, ``mv`` (S, h, T, dk) float32 or bfloat16: the layer's projected
  K and V, head-major (``models.decoder.head_major``), in the cache dtype;
- ``enc_len`` (S,) int32 or int64: the encoder frames each stream sees,
  rows t < enc_len (all T where enc_len >= T);

and returns (N, h·dk) float32, for each hypothesis and head the softmax
over its stream's rows t < enc_len of ``q_h · K_t / sqrt(dk)`` applied to
the V rows. With bfloat16 K/V the query is rounded to bfloat16 before the
score contraction and the weights to the V dtype before the value
contraction; both accumulate in float32. ``enc_len`` 0 gives zeros.

``cross_attention_plain`` is the composition the beam step ran before the
kernel, operation for operation (the mask built from ``enc_len``, scores
over all T rows set to ``MASK_MIN`` past it, the masked weights zeroed). On
the CPU the decoder therefore computes to the bit what it computed before.
Given a float64 ``q`` it computes in float64, the card's reference. The
kernel never reads a K or V row at t >= enc_len; the masked entries'
weights are exactly 0 in the twin, so only the order of the float32 sums
differs.

The plan (``_plan_args``, plain Python) checks a signature once and caches
the launch's integers: q with inner stride 1, mk and mv of one shape,
dtype and strides with inner stride 1, dk a power of two from 4 to
``MAX_DK`` (every configuration's: 4 to 128), the block's shared memory (B·(dk + T) + warps·4·dk floats)
within Hopper's 227 KB (past 48 KB the launch opts in), which at the
ring's T = 832 and dk 64 allows a beam of 63 (4 warps) or 62 (8 warps),
and an int32 or int64 ``enc_len``. It refuses anything else before the
CPU/CUDA branch. On a CUDA tensor a call is one
dict lookup, one ``torch.empty``, the ``data_ptr()``s and one foreign call
into ``csrc/cross_attention.cu`` (a block a stream and head); on a CPU
tensor it runs the plain twin. The kernel has no backward: a call on
operands that require grad raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from speechcatcher_tpu_torch.ops.kernels import _build, _plan
from speechcatcher_tpu_torch.ops.kernels.block_attention import MASK_MIN

MAX_DK = 256
MAX_SHARED = 232448     # a block's limit on Hopper, with the opt-in attribute
_KV_DTYPES = (torch.float32, torch.bfloat16)
_LEN_DTYPES = (torch.int32, torch.int64)
_QUERIES = 4            # kQueries in the kernel: the weighted sum's batch
_SMS = 132              # streaming multiprocessors of the H100


class _Args(ctypes.Structure):
    """The launch's integers of ``sc_cross_attention``
    (``CrossAttentionArgs`` in ``csrc/cross_attention.cu``)."""

    _fields_ = [("q_ns", ctypes.c_longlong),
                ("kv_ss", ctypes.c_longlong), ("kv_hs", ctypes.c_longlong),
                ("kv_ts", ctypes.c_longlong),
                ("len_ss", ctypes.c_longlong),
                ("s", ctypes.c_int), ("h", ctypes.c_int), ("t", ctypes.c_int),
                ("dk", ctypes.c_int), ("beam", ctypes.c_int),
                ("group", ctypes.c_int), ("warps", ctypes.c_int),
                ("kv_bytes", ctypes.c_int), ("len_bytes", ctypes.c_int),
                ("smem_bytes", ctypes.c_int), ("sqrt_dk", ctypes.c_float)]


def warps_per_block(blocks: int) -> int:
    """Warps of one block (one stream and head): 8 while the blocks do not
    fill two an SM, so that each block's rows spread over more warps, else
    4."""
    return 8 if blocks < 2 * _SMS else 4


def lanes_per_row(dk: int) -> int:
    """Lanes that share one K or V row of a power-of-two dk: dk / 16, four
    float4s each, from dk 16 up; one below (one float4 at dk 4, two at
    8)."""
    return max(1, dk // 16)


def shared_bytes(beam: int, t: int, dk: int, warps: int) -> int:
    """A block's shared memory: the queries (B x dk floats), the scores
    (B x T) and the warps' partial sums (warps x 4 x dk)."""
    return 4 * (beam * (dk + t) + warps * _QUERIES * dk)


def _check(what: str, t: torch.Tensor, shape, dtypes) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype not in dtypes
            or t.stride(-1) != 1):
        raise ValueError(f"cross_attention: {what} must be {tuple(shape)} "
                         f"of {', '.join(map(str, dtypes))} with inner "
                         f"stride 1, got {tuple(t.shape)} {t.dtype} strides "
                         f"{t.stride()}")


def _plan_args(q, mk, mv, enc_len) -> _Args:
    """Check a signature; its launch arguments."""
    if q.dim() != 2 or mk.dim() != 4 or enc_len.dim() != 1:
        raise ValueError("cross_attention: q (N, h*dk), mk and mv "
                         "(S, h, T, dk) and enc_len (S,)")
    s, h, t, dk = mk.shape
    n = q.shape[0]
    if s == 0 or n % s or h == 0 or t == 0:
        raise ValueError(f"cross_attention: N = {n} queries do not divide "
                         f"among S = {s} streams, or h = {h}, T = {t}")
    beam = n // s
    if dk & (dk - 1) or not 4 <= dk <= MAX_DK:
        raise ValueError(f"cross_attention: dk = {dk} unsupported (a "
                         f"power of two from 4 to {MAX_DK})")
    warps = warps_per_block(s * h)
    need = shared_bytes(beam, t, dk, warps)
    if need > MAX_SHARED:
        raise ValueError(f"cross_attention: beam {beam} over T = {t} rows "
                         f"at dk = {dk} needs {need} bytes of shared memory "
                         f"(at most {MAX_SHARED}: 4 x (beam x (dk + T) + "
                         f"{warps} x {_QUERIES} x dk))")
    _check("q", q, (n, h * dk), (torch.float32,))
    _check("mk", mk, (s, h, t, dk), _KV_DTYPES)
    if mv.shape != mk.shape or mv.dtype != mk.dtype \
            or mv.stride() != mk.stride():
        raise ValueError(f"cross_attention: mv {tuple(mv.shape)} {mv.dtype} "
                         f"strides {mv.stride()} differs from mk "
                         f"{tuple(mk.shape)} {mk.dtype} strides "
                         f"{mk.stride()}")
    if enc_len.shape != (s,) or enc_len.dtype not in _LEN_DTYPES:
        raise ValueError(f"cross_attention: enc_len must be an int32 or "
                         f"int64 ({s},), got {tuple(enc_len.shape)} "
                         f"{enc_len.dtype}")
    _plan.check_devices("cross_attention", q, mk, mv, enc_len)
    kv_ss, kv_hs, kv_ts = _plan.strides(mk)[:3]
    return _Args(_plan.strides(q)[0], kv_ss, kv_hs, kv_ts,
                 _plan.strides(enc_len)[0], s, h, t, dk, beam,
                 lanes_per_row(dk), warps, mk.element_size(),
                 enc_len.element_size(), need, math.sqrt(dk))


def cross_attention_plain(q, mk, mv, enc_len):
    """Plain PyTorch version: the beam step's cross-attention as the
    decoder composed it before the kernel (the operands widened to ``q``'s
    dtype: float32 there; given a float64 ``q`` it is the float64
    reference the card's check holds both against)."""
    s, h, t, dk = mk.shape
    n = q.shape[0]
    b = n // s
    valid = (torch.arange(t, device=enc_len.device)[None, :]
             < enc_len.long()[:, None])
    qh = q.reshape(s, b, h, dk).transpose(1, 2).to(mk.dtype).to(q.dtype)
    scores = torch.matmul(qh, mk.to(q.dtype).transpose(2, 3)) / math.sqrt(dk)
    keep = valid[:, None, None, :]
    scores = torch.where(keep, scores, MASK_MIN)
    attn = torch.softmax(scores, dim=-1)
    attn = torch.where(keep, attn, 0.0)
    out = torch.matmul(attn.to(mv.dtype).to(q.dtype), mv.to(q.dtype))
    return out.transpose(1, 2).reshape(n, h * dk)


def _meta(t: torch.Tensor) -> tuple:
    return (t.shape, t.stride(), t.dtype, t.device)


_PLANS: dict = {}


def cross_attention(q: torch.Tensor, mk: torch.Tensor, mv: torch.Tensor,
                    enc_len: torch.Tensor) -> torch.Tensor:
    """q (N, h·dk) float32; mk, mv (S, h, T, dk) float32/bfloat16; enc_len
    (S,) int32/int64. Returns (N, h·dk) float32."""
    _plan.refuse_grad("cross_attention", q, mk, mv)
    key = tuple(map(_meta, (q, mk, mv, enc_len)))
    plan = _PLANS.get(key) or _plan.launch(
        _PLANS, key, _plan_args(q, mk, mv, enc_len), "sc_cross_attention",
        q.device)
    if plan.fn is None:
        return cross_attention_plain(q, mk, mv, enc_len)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = plan.fn(q.data_ptr(), mk.data_ptr(), mv.data_ptr(),
                  enc_len.data_ptr(), out.data_ptr(), plan.address,
                  _build.stream_ptr(q))
    if err:
        _plan.raise_launch_error("cross_attention", err)
    _plan.count(cross_attention)
    return out


cross_attention.launches = 0
