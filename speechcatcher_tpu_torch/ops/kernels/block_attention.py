"""Masked block attention for the streaming encoder.

Port of ``speechcatcher_tpu/ops/pallas/block_attention.py::block_attention``
(``pallas_call`` at :108): ``softmax(mask(Q·Kᵀ/√dk))·V`` inside
(block_size+2)-wide windows, with one static (W, W) geometry mask. Masked
scores are filled with the float32 minimum before the softmax and masked
probabilities are zeroed after it, so a fully masked row gives exactly 0.

q, k, v are (N, H, W, dk) float32 with any strides on their first three
dims and inner stride 1, so the transposed view that ``mha_project`` makes
of an (N, W, H·dk) projection is read as it lies. On a CUDA tensor the
wrapper launches the hand-written kernel of ``csrc/block_attention.cu``
(``csrc/attention.cuh``: a block per (window, head, tile of query rows), a
warp per score row) and returns the ``transpose(1, 2)`` view of a contiguous
(N, W, H, dk) result, which the caller's ``transpose(1, 2).reshape(N, W,
H·dk)`` merges without a copy. On a CPU tensor it runs
``block_attention_plain``, the same arithmetic in PyTorch.

Training: where grad mode is on and an operand requires grad, the call goes
through ``BlockAttentionFn``, whose backward recomputes the attention
through ``block_attention_plain`` and takes its VJP, as the JAX package's
``custom_vjp`` rematerialises its XLA reference. ``backward_launches`` on
the Function counts those backwards on the card; any other call takes the
path above unchanged.

Both routes check the operands alike, once per input signature:
``attention_plan`` (plain Python, shared with ``rel_block_attention``) does
every check and holds the launch's integers in a ``ctypes.Structure``,
cached under the signature. A call on the card is then one dict lookup, the
``data_ptr()``s, one ``torch.empty``, the raw current stream and one foreign
call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from speechcatcher_tpu_torch.ops.kernels import _build, _plan

MASK_MIN = float(torch.finfo(torch.float32).min)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
MAX_W = 128          # kMaxW in csrc/attention.cuh: four columns per lane
WARPS_PER_BLOCK = 8  # the most row warps of one block
# A warp takes one query row while that gives every block an SM of the H100
# to itself, and two rows beyond (half the blocks, each reading K and V from
# shared memory once for two rows).
ONE_ROW_MAX_BLOCKS = 132


class _AttnArgs(ctypes.Structure):
    """The launch's integers of ``sc_block_attention`` and
    ``sc_rel_block_attention`` (``AttnArgs`` in ``csrc/attention.cuh``)."""

    _fields_ = (
        [(f"{t}_s{d}", ctypes.c_longlong) for t in "qkv" for d in "nhw"]
        + [(name, ctypes.c_longlong)
           for name in ("pos_sh", "pos_sw", "bu_sh", "bv_sh")]
        + [(name, ctypes.c_int)
           for name in ("n", "h", "w", "dk", "warps", "rpw", "tiles", "vec",
                        "smem_vec", "smem_scalar")]
        + [("scale", ctypes.c_float)])


def _tiling(n: int, h: int, w: int) -> tuple:
    """(row warps per block, query rows per warp, blocks per window and
    head): tiles of about WARPS_PER_BLOCK rows a warp each (or twice that),
    evened out so that the last tile is as full as the others (W = 42: 6
    tiles of 7 rows, or 3 of 14)."""
    rpw = 1 if n * h * -(-w // WARPS_PER_BLOCK) <= ONE_ROW_MAX_BLOCKS else 2
    tiles = -(-w // (WARPS_PER_BLOCK * rpw))
    rows = -(-w // tiles)
    return -(-rows // rpw), rpw, tiles


def _smem_floats(rel: bool, vec: bool, w: int, dk: int, rows: int) -> int:
    """Floats of shared memory a block of `rows` query rows uses
    (``attn_layout`` in ``csrc/attention.cuh``): K and V, the tile's q rows
    and, for the relative kernel, pos, the q + v rows and the raw position
    scores."""
    ks = 4 * ((dk // 4) | 1) if vec else dk | 1
    floats = w * ks + w * dk + rows * dk
    if rel:
        floats += w * ks + (rows + 1) * dk + (rows + 1) * w
    return floats


def attention_plan(name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, mask: torch.Tensor,
                   pos: Optional[torch.Tensor] = None,
                   bias_u: Optional[torch.Tensor] = None,
                   bias_v: Optional[torch.Tensor] = None) -> _AttnArgs:
    """Check a ``block_attention`` signature (or, with pos and the biases,
    a ``rel_block_attention`` one); its launch arguments."""
    rel = pos is not None
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one (N, H, W, dk) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n, h, w, dk = q.shape
    if min(h, w, dk) < 1:
        raise ValueError(f"{name}: empty (N, H, W, dk) = {tuple(q.shape)}")
    if mask.shape != (w, w):
        raise ValueError(f"{name}: mask must be ({w}, {w}), "
                         f"got {tuple(mask.shape)}")
    rows_of = {"q": q, "k": k, "v": v}   # operands read in rows of dk floats
    if rel:
        if pos.shape != (h, w, dk):
            raise ValueError(f"{name}: pos must be ({h}, {w}, {dk}), "
                             f"got {tuple(pos.shape)}")
        for what, b in (("bias_u", bias_u), ("bias_v", bias_v)):
            if b.shape != (h, dk):
                raise ValueError(f"{name}: {what} must be ({h}, {dk}), "
                                 f"got {tuple(b.shape)}")
        rows_of.update(pos=pos, bias_u=bias_u, bias_v=bias_v)
    for what, a in (*rows_of.items(), ("mask", mask)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: float32 operands only, {what} is "
                            f"{a.dtype}")
    _plan.check_devices(name, *rows_of.values(), mask)
    st = {what: _plan.strides(a) for what, a in rows_of.items()}
    for what, s in st.items():
        if s[-1] not in (0, 1):
            raise ValueError(f"{name}: {what}'s last dim must be contiguous "
                             f"(strides {rows_of[what].stride()})")
    if not mask.is_contiguous():
        raise ValueError(f"{name}: the mask must be contiguous")
    if w > MAX_W:
        raise ValueError(f"{name}: windows of at most {MAX_W} frames, "
                         f"got W={w}")
    warps, rpw, tiles = _tiling(n, h, w)
    rows = warps * rpw
    # 16-byte loads need every row to start on a multiple of four floats
    # (the C entry point checks the base pointers and else goes scalar).
    vec = dk % 4 == 0 and all(x % 4 == 0 for what in ("q", "k", "v", "pos")
                              if what in st for x in st[what][:-1])
    smem_vec = 4 * _smem_floats(rel, True, w, dk, rows) if vec else 0
    smem_scalar = 4 * _smem_floats(rel, False, w, dk, rows)
    if max(smem_vec, smem_scalar) > SMEM_LIMIT:
        raise ValueError(f"{name}: W={w}, dk={dk} needs "
                         f"{max(smem_vec, smem_scalar)} B of shared memory, "
                         f"more than {SMEM_LIMIT}")
    pos_st = st["pos"][:2] if rel else [0, 0]
    bias_st = [st["bias_u"][0], st["bias_v"][0]] if rel else [0, 0]
    return _AttnArgs(*st["q"][:3], *st["k"][:3], *st["v"][:3], *pos_st,
                     *bias_st, n, h, w, dk, warps, rpw, tiles, int(vec),
                     smem_vec, smem_scalar, math.sqrt(dk))


def block_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: q, k, v (N, H, W, dk), mask (W, W)."""
    q, k, v = q.float(), k.float(), v.float()
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    keep = mask != 0
    scores = torch.where(keep, scores, MASK_MIN)
    attn = torch.softmax(scores, dim=-1)
    attn = torch.where(keep, attn, 0.0)
    return torch.matmul(attn, v)


_PLANS: dict = {}


def _launch(key: tuple, q, k, v, mask) -> _plan.Launch:
    """Plan a new signature and cache it."""
    args = attention_plan("block_attention", q, k, v, mask)
    return _plan.launch(_PLANS, key, args, "sc_block_attention", q.device,
                        (args.n, args.w, args.h, args.dk))


def _block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The forward call: the kernel on the card, the plain version on the
    CPU."""
    key = (q.shape, q.stride(), q.dtype, q.device,
           k.shape, k.stride(), k.dtype, k.device,
           v.shape, v.stride(), v.dtype, v.device,
           mask.shape, mask.stride(), mask.dtype, mask.device)
    plan = _PLANS.get(key) or _launch(key, q, k, v, mask)
    if plan.fn is None:
        return block_attention_plain(q, k, v, mask)
    out = torch.empty(plan.out_shape, dtype=torch.float32, device=q.device)
    err = plan.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), plan.address, _build.stream_ptr(q))
    if err:
        _plan.raise_launch_error("block_attention", err)
    _plan.count(block_attention)
    return out.transpose(1, 2)


def plain_vjp(plain, operands: tuple, fixed: tuple, grad: torch.Tensor,
              fn) -> tuple:
    """Gradients of ``plain(*operands, *fixed)`` for the cotangent `grad`,
    recomputed through autograd (what the JAX ``custom_vjp`` does with its
    XLA reference); counts one backward on the card. A profiler sees it as
    the range ``<plain's name>_backward``."""
    with torch.profiler.record_function(plain.__name__ + "_backward"):
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in operands]
            out = plain(*xs, *fixed)
        grads = torch.autograd.grad(out, xs, grad)
    if grad.device.type == "cuda":
        _plan.count(fn, "backward_launches")
    return grads


class BlockAttentionFn(torch.autograd.Function):
    """Kernel A with a backward: the forward is the kernel (the plain
    version on the CPU), the backward the VJP of
    ``block_attention_plain`` recomputed from the saved operands. The mask
    gets no gradient."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _block_attention(q, k, v, mask)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, mask = ctx.saved_tensors
        return (*plain_vjp(block_attention_plain, (q, k, v), (mask,), grad,
                           BlockAttentionFn), None)


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """(N, H, W, dk) float32 q, k, v (any strides on N, H, W) and a
    contiguous (W, W) float32 mask -> (N, H, W, dk); on the card, the
    transposed view of a contiguous (N, W, H, dk) tensor. Where autograd
    must follow the call (grad mode on and q, k or v requiring grad) it goes
    through ``BlockAttentionFn``."""
    if _plan.needs_grad(q, k, v):
        return BlockAttentionFn.apply(q, k, v, mask)
    return _block_attention(q, k, v, mask)


block_attention.launches = 0
