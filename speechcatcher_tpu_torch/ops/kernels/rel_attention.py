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

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/rel_attention.cu`` (one block per (n, h) pair, the shift as index
arithmetic in shared memory). On a CPU tensor it runs
``rel_block_attention_plain``, the same arithmetic in PyTorch.
"""

from __future__ import annotations

import math

import torch

from speechcatcher_tpu_torch.ops.kernels import _build
from speechcatcher_tpu_torch.ops.kernels.block_attention import (
    MASK_MIN,
    SMEM_LIMIT,
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


def rel_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos: torch.Tensor, bias_u: torch.Tensor,
                        bias_v: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """(N, H, W, dk) float32 q, k, v, a shared (H, W, dk) position table,
    (H, dk) biases and a (W, W) mask -> (N, H, W, dk)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"rel_block_attention: q, k, v must share one "
                         f"(N, H, W, dk) shape, got {q.shape}, {k.shape}, "
                         f"{v.shape}")
    n, h, w, dk = q.shape
    if pos.shape != (h, w, dk):
        raise ValueError(f"rel_block_attention: pos must be ({h}, {w}, {dk}),"
                         f" got {tuple(pos.shape)}")
    for name, b in (("bias_u", bias_u), ("bias_v", bias_v)):
        if b.shape != (h, dk):
            raise ValueError(f"rel_block_attention: {name} must be ({h}, "
                             f"{dk}), got {tuple(b.shape)}")
    if mask.shape != (w, w):
        raise ValueError(f"rel_block_attention: mask must be ({w}, {w}), "
                         f"got {tuple(mask.shape)}")
    if q.device.type == "cpu":
        return rel_block_attention_plain(q, k, v, pos, bias_u, bias_v, mask)
    operands = (q, k, v, pos, bias_u, bias_v, mask)
    for a in operands:
        if a.dtype != torch.float32:
            raise TypeError(f"rel_block_attention: float32 operands only, "
                            f"got {a.dtype}")
    _build.check_cuda("rel_block_attention", *operands)
    lib = _build.library()
    smem = lib.lib.sc_rel_block_attention_smem_bytes(w, dk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"rel_block_attention: W={w}, dk={dk} needs {smem} "
                         f"B of shared memory, more than {SMEM_LIMIT}")
    out = torch.empty_like(q)
    lib.call("sc_rel_block_attention", *(a.data_ptr() for a in operands),
             out.data_ptr(), n * h, h, w, dk, math.sqrt(dk),
             _build.stream_ptr(q))
    rel_block_attention.launches += 1
    return out


rel_block_attention.launches = 0
