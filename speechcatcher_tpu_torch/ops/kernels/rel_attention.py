"""Masked relative-position block attention for the streaming conformer.

Port of ``speechcatcher_tpu/ops/pallas/rel_attention.py::rel_block_attention``
(``pallas_call`` at :151): inside (block_size+2)-wide windows,

    softmax(mask(((q + u)·kᵀ + rel_shift((q + v)·posᵀ)) / √dk))·V

with one position table ``pos`` (H, W, dk) and the Transformer-XL biases
``u``, ``v`` (H, dk) shared by every window, and one static (W, W) geometry
mask. ``rel_shift`` is the legacy reshape trick, which for tq == tk == W
reads

    out[q, k] = raw[q, k - q + W - 1]   for k <= q
    out[q, q + 1] = 0
    out[q, k] = raw[q + 1, k - q - 2]   for k >= q + 2

(the k > q entries wrap from the next query row). Masked scores are filled
with the float32 minimum before the softmax and masked probabilities are
zeroed after it, so a fully masked row gives exactly 0.

q, k, v, pos and the biases are float32 with any strides on their leading
dims and inner stride 1, so the transposed views that ``mha_project`` and
``rel_position_attention`` make of their projections are read as they lie.
On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/rel_attention.cu`` (``csrc/attention.cuh``: a block per (window,
head, tile of query rows), a warp per score row, the shift as index
arithmetic over the tile's raw rows) and returns the ``transpose(1, 2)``
view of a contiguous (N, W, H, dk) result, which the caller merges into
(N, W, H·dk) without a copy. On a CPU tensor it runs
``rel_block_attention_plain``, the same arithmetic in PyTorch. Both routes
check the operands alike, once per input signature, through
``block_attention.attention_plan``. Where grad mode is on and an operand
requires grad, the call goes through ``RelBlockAttentionFn``, whose backward
recomputes the plain version and takes its VJP (``backward_launches`` counts
those backwards on the card).
"""

from __future__ import annotations

import math

import torch

from speechcatcher_tpu_torch.ops.kernels import _build, _plan
from speechcatcher_tpu_torch.ops.kernels.block_attention import (
    MASK_MIN,
    attention_plan,
    plain_vjp,
)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Legacy Transformer-XL relative shift of (B, H, Tq, Tk) scores: pad a
    zero column in front, view as (Tk+1, Tq), drop the first row."""
    b, h, tq, tk = x.shape
    padded = torch.cat([x.new_zeros((b, h, tq, 1)), x], dim=-1)
    return padded.reshape(b, h, tk + 1, tq)[:, :, 1:].reshape(b, h, tq, tk)


def rel_block_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, pos: torch.Tensor,
                              bias_u: torch.Tensor, bias_v: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: q, k, v (N, H, W, dk), pos (H, W, dk),
    bias_u, bias_v (H, dk), mask (W, W)."""
    q, k, v, pos = q.float(), k.float(), v.float(), pos.float()
    dk = q.shape[-1]
    q_u = q + bias_u.float()[None, :, None, :]
    q_v = q + bias_v.float()[None, :, None, :]
    ac = torch.matmul(q_u, k.transpose(-1, -2))
    bd = rel_shift(torch.matmul(q_v, pos.transpose(-1, -2)[None]))
    scores = (ac + bd) / math.sqrt(dk)
    keep = mask != 0
    scores = torch.where(keep, scores, MASK_MIN)
    attn = torch.softmax(scores, dim=-1)
    attn = torch.where(keep, attn, 0.0)
    return torch.matmul(attn, v)


_PLANS: dict = {}


def _launch(key: tuple, q, k, v, pos, bias_u, bias_v, mask) -> _plan.Launch:
    """Plan a new signature and cache it."""
    args = attention_plan("rel_block_attention", q, k, v, mask, pos, bias_u,
                          bias_v)
    return _plan.launch(_PLANS, key, args, "sc_rel_block_attention",
                        q.device, (args.n, args.w, args.h, args.dk))


def _rel_block_attention(q, k, v, pos, bias_u, bias_v, mask):
    """The forward call: the kernel on the card, the plain version on the
    CPU."""
    key = (q.shape, q.stride(), q.dtype, q.device,
           k.shape, k.stride(), k.dtype, k.device,
           v.shape, v.stride(), v.dtype, v.device,
           pos.shape, pos.stride(), pos.dtype, pos.device,
           bias_u.shape, bias_u.stride(), bias_u.dtype, bias_u.device,
           bias_v.shape, bias_v.stride(), bias_v.dtype, bias_v.device,
           mask.shape, mask.stride(), mask.dtype, mask.device)
    plan = _PLANS.get(key) or _launch(key, q, k, v, pos, bias_u, bias_v, mask)
    if plan.fn is None:
        return rel_block_attention_plain(q, k, v, pos, bias_u, bias_v, mask)
    out = torch.empty(plan.out_shape, dtype=torch.float32, device=q.device)
    err = plan.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                  bias_u.data_ptr(), bias_v.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), plan.address, _build.stream_ptr(q))
    if err:
        _plan.raise_launch_error("rel_block_attention", err)
    _plan.count(rel_block_attention)
    return out.transpose(1, 2)


class RelBlockAttentionFn(torch.autograd.Function):
    """Kernel E with a backward: the forward is the kernel (the plain
    version on the CPU), the backward the VJP of
    ``rel_block_attention_plain`` recomputed from the saved operands, with
    real gradients for q, k, v, pos, bias_u and bias_v (the linear_pos
    projection and the Transformer-XL biases train). The mask gets none."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, q, k, v, pos, bias_u, bias_v, mask):
        ctx.save_for_backward(q, k, v, pos, bias_u, bias_v, mask)
        return _rel_block_attention(q, k, v, pos, bias_u, bias_v, mask)

    @staticmethod
    def backward(ctx, grad):
        *operands, mask = ctx.saved_tensors
        return (*plain_vjp(rel_block_attention_plain, tuple(operands),
                           (mask,), grad, RelBlockAttentionFn), None)


def rel_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos: torch.Tensor, bias_u: torch.Tensor,
                        bias_v: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """(N, H, W, dk) float32 q, k, v, a shared (H, W, dk) position table and
    (H, dk) biases (any strides on the leading dims) and a contiguous (W, W)
    float32 mask -> (N, H, W, dk); on the card, the transposed view of a
    contiguous (N, W, H, dk) tensor. Where autograd must follow the call
    (grad mode on and an operand requiring grad) it goes through
    ``RelBlockAttentionFn``."""
    if _plan.needs_grad(q, k, v, pos, bias_u, bias_v):
        return RelBlockAttentionFn.apply(q, k, v, pos, bias_u, bias_v, mask)
    return _rel_block_attention(q, k, v, pos, bias_u, bias_v, mask)


rel_block_attention.launches = 0
