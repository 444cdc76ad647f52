"""The decoder beam step's self-attention over its lane-mapped activation
cache, in one kernel (G).

It ports no TPU kernel (the JAX package's lane attention is XLA). It exists
because the composition it replaces gathered each layer's whole (N, Lmax, d)
cache into a float32 copy and contracted that copy twice, though only a
hypothesis's first ``pos`` rows are its history. One call, for N = S·B
hypotheses, takes

- ``qk`` (N, h, d) float32: the query with the layer's K projection folded
  in, h the heads this rank holds;
- ``cache`` (N, Lmax, d) float32 or bfloat16: the layer's cached rows;
  row t of hypothesis (s, b) lies at ``cache[s·B + lane[s, b, t], t]``;
- ``hn_self`` (N, d) float32: this step's own row;
- ``lane`` (S, B, Lmax) int32 and ``pos`` (N,) int64: rows t < pos are the
  history (all Lmax where pos >= Lmax);
- ``dk``: the width of one head, d / n_head;

and returns ``u`` (N, h, d) float32, the weighted sum of the history rows
and the self row under the softmax of their scores ``qk[n, j] · row /
sqrt(dk)``. ``decoder_step`` applies the V projection and its bias to it.

``lane_attention_plain`` is the composition the beam step ran before the
kernel, operation for operation: every row gathered in float32, masked
scores set to ``MASK_MIN``, the self score appended as a last column, the
masked weights zeroed. On the CPU the decoder therefore computes to the bit
what it computed before. The kernel never reads a row at t >= pos; the
masked entries' weights are exactly 0 in the twin, so only the order of the
float32 sums differs.

The plan (``_plan_args``, plain Python) checks a signature once and caches
the launch's integers: qk, hn_self with inner stride 1, d a multiple of 4
up to 128 or a multiple of 128 up to 1024, h <= 32, h·d <= 4096, 1 <= Lmax
<= 512, the block's shared memory within 48 KB, int32 ``lane`` and int64
``pos``.
It refuses anything else before the CPU/CUDA branch. On a CUDA tensor a
call is one dict lookup, one ``torch.empty``, the ``data_ptr()``s and one
foreign call into ``csrc/lane_attention.cu`` (a block a hypothesis); on a
CPU tensor it runs the plain twin. The kernel has no backward: a call on
operands that require grad raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from speechcatcher_tpu_torch.ops.kernels import _build, _plan
from speechcatcher_tpu_torch.ops.kernels.block_attention import MASK_MIN

MAX_D = 1024            # 32 lanes x 8 float4s a row in the kernel
MAX_HEADS = 32
MAX_HD = 4096           # qk's h x d floats staged in shared memory
MAX_LMAX = 512
MAX_SHARED = 48 * 1024  # a block's static limit, no opt-in attribute
_CACHE_DTYPES = (torch.float32, torch.bfloat16)
_SMS = 132              # streaming multiprocessors of the H100


class _Args(ctypes.Structure):
    """The launch's integers of ``sc_lane_attention``
    (``LaneAttentionArgs`` in ``csrc/lane_attention.cu``)."""

    _fields_ = [("qk_ns", ctypes.c_longlong), ("qk_hs", ctypes.c_longlong),
                ("cache_rs", ctypes.c_longlong),
                ("cache_ps", ctypes.c_longlong),
                ("hn_rs", ctypes.c_longlong),
                ("lane_ss", ctypes.c_longlong),
                ("lane_bs", ctypes.c_longlong),
                ("n", ctypes.c_int), ("h", ctypes.c_int), ("d", ctypes.c_int),
                ("lmax", ctypes.c_int), ("beam", ctypes.c_int),
                ("warps", ctypes.c_int), ("cache_bytes", ctypes.c_int),
                ("smem_bytes", ctypes.c_int), ("sqrt_dk", ctypes.c_float)]


def shared_bytes(h: int, d: int, lmax: int) -> int:
    """A block's shared memory: qk (h x d floats), each history row's
    offset (Lmax int64) and the scores (h x (Lmax + 1) floats)."""
    return 4 * h * d + 8 * lmax + 4 * h * (lmax + 1)


def warps_per_block(n: int) -> int:
    """Warps of one block (one hypothesis): 16 while the hypotheses do not
    fill the SMs, so that each block's rows spread over more warps, else
    8."""
    return 16 if n <= _SMS else 8


def _check(what: str, t: torch.Tensor, shape, dtypes) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype not in dtypes
            or t.stride(-1) != 1):
        raise ValueError(f"lane_attention: {what} must be {tuple(shape)} of "
                         f"{', '.join(map(str, dtypes))} with inner stride "
                         f"1, got {tuple(t.shape)} {t.dtype} strides "
                         f"{t.stride()}")


def _plan_args(qk, cache, hn_self, lane, pos, dk) -> _Args:
    """Check a signature; its launch arguments."""
    if qk.dim() != 3 or cache.dim() != 3 or lane.dim() != 3:
        raise ValueError("lane_attention: qk (N, h, d), cache (N, Lmax, d) "
                         "and lane (S, B, Lmax) are 3-D")
    n, h, d = qk.shape
    lmax = cache.shape[1]
    s, beam = lane.shape[:2]
    if d == 0 or d % 4 or (d > 128 and d % 128) or d > MAX_D:
        raise ValueError(f"lane_attention: d = {d} unsupported (a multiple "
                         f"of 4 up to 128 or of 128 up to {MAX_D})")
    if not 0 < h <= MAX_HEADS or h * d > MAX_HD:
        raise ValueError(f"lane_attention: h x d = {h} x {d} unsupported "
                         f"(h up to {MAX_HEADS}, h x d up to {MAX_HD})")
    if not 0 < lmax <= MAX_LMAX:
        raise ValueError(f"lane_attention: Lmax = {lmax} unsupported (1 to "
                         f"{MAX_LMAX})")
    if s * beam != n or dk <= 0:
        raise ValueError(f"lane_attention: lane {tuple(lane.shape)} does not "
                         f"map N = {n} hypotheses, or dk = {dk}")
    if shared_bytes(h, d, lmax) > MAX_SHARED:
        raise ValueError(f"lane_attention: h = {h}, d = {d}, Lmax = {lmax} "
                         f"need {shared_bytes(h, d, lmax)} bytes of shared "
                         f"memory (at most {MAX_SHARED})")
    _check("qk", qk, (n, h, d), (torch.float32,))
    _check("cache", cache, (n, lmax, d), _CACHE_DTYPES)
    _check("hn_self", hn_self, (n, d), (torch.float32,))
    _check("lane", lane, (s, beam, lmax), (torch.int32,))
    if pos.shape != (n,) or pos.dtype != torch.int64 or pos.stride() != (1,):
        raise ValueError(f"lane_attention: pos must be a contiguous int64 "
                         f"({n},), got {tuple(pos.shape)} {pos.dtype}")
    _plan.check_devices("lane_attention", qk, cache, hn_self, lane, pos)
    qk_ns, qk_hs = _plan.strides(qk)[:2]
    cache_rs, cache_ps = _plan.strides(cache)[:2]
    lane_ss, lane_bs = _plan.strides(lane)[:2]
    return _Args(qk_ns, qk_hs, cache_rs, cache_ps, _plan.strides(hn_self)[0],
                 lane_ss, lane_bs, n, h, d, lmax, beam, warps_per_block(n),
                 cache.element_size(), shared_bytes(h, d, lmax),
                 math.sqrt(dk))


def lane_attention_plain(qk, cache, hn_self, lane, pos, dk):
    """Plain PyTorch version: the beam step's lane attention from ``qk`` to
    ``u`` as the decoder composed it before the kernel (the rows widened
    to ``qk``'s dtype: float32 there; given float64 operands it is the
    float64 reference the card's check holds both against)."""
    n, t, d = cache.shape
    s, beam = lane.shape[:2]
    hist_valid = torch.arange(t, device=pos.device)[None, :] < pos[:, None]
    hhl = cache.to(qk.dtype).reshape(s, beam, t, d)
    idx = lane.long()[..., None].expand(s, beam, t, d)
    rows = torch.gather(hhl, 1, idx).reshape(n, t, d)
    scores = torch.einsum("nhd,ntd->nht", qk, rows) / math.sqrt(dk)
    scores = torch.where(hist_valid[:, None, :], scores, MASK_MIN)
    self_score = torch.einsum("nhd,nd->nh", qk, hn_self) / math.sqrt(dk)
    scores = torch.cat([scores, self_score[:, :, None]], dim=2)
    attn = torch.softmax(scores, dim=-1)
    hist_attn = torch.where(hist_valid[:, None, :], attn[:, :, :t], 0.0)
    u = torch.einsum("nht,ntd->nhd", hist_attn, rows)
    return u + attn[:, :, t][:, :, None] * hn_self[:, None, :]


def _meta(t: torch.Tensor) -> tuple:
    return (t.shape, t.stride(), t.dtype, t.device)


_PLANS: dict = {}


def lane_attention(qk: torch.Tensor, cache: torch.Tensor,
                   hn_self: torch.Tensor, lane: torch.Tensor,
                   pos: torch.Tensor, dk: int) -> torch.Tensor:
    """qk (N, h, d) float32; cache (N, Lmax, d) float32/bfloat16; hn_self
    (N, d) float32; lane (S, B, Lmax) int32; pos (N,) int64; dk the head
    width. Returns u (N, h, d) float32."""
    _plan.refuse_grad("lane_attention", qk, hn_self, cache)
    key = (*map(_meta, (qk, cache, hn_self, lane, pos)), dk)
    plan = _PLANS.get(key) or _plan.launch(
        _PLANS, key, _plan_args(qk, cache, hn_self, lane, pos, dk),
        "sc_lane_attention", qk.device)
    if plan.fn is None:
        return lane_attention_plain(qk, cache, hn_self, lane, pos, dk)
    out = torch.empty(qk.shape, dtype=torch.float32, device=qk.device)
    err = plan.fn(qk.data_ptr(), cache.data_ptr(), hn_self.data_ptr(),
                  lane.data_ptr(), pos.data_ptr(), out.data_ptr(),
                  plan.address, _build.stream_ptr(qk))
    if err:
        _plan.raise_launch_error("lane_attention", err)
    _plan.count(lane_attention)
    return out


lane_attention.launches = 0
