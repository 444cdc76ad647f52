"""Transformer building blocks on parameter dictionaries of tensors.

Port of ``speechcatcher_tpu/ops/layers.py``. Parameters keep the torch
layout the JAX package already uses (Linear weights (out, in)). Contracts
kept from the reference: LayerNorm eps 1e-12; FFN Linear→ReLU→Linear;
attention fills masked scores with the float32 minimum before the softmax
and zeroes masked probabilities after it, so a fully masked row outputs 0;
sinusoidal PE scaled by sqrt(d).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from speechcatcher_tpu_torch.ops.kernels.block_attention import (
    MASK_MIN,
    block_attention,
)

Params = Dict[str, torch.Tensor]

LAYERNORM_EPS = 1e-12


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b with a torch-layout (out, in) float32 weight."""
    y = torch.matmul(x, p["weight"].t())
    if "bias" in p:
        y = y + p["bias"]
    return y


def layer_norm(p: Params, x: torch.Tensor, eps: float = LAYERNORM_EPS
               ) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    xhat = (x - mean) * torch.rsqrt(var + eps)
    return xhat * p["weight"] + p["bias"]


def feed_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Position-wise FFN: w_2(relu(w_1(x)))."""
    return linear(p["w_2"], torch.relu(linear(p["w_1"], x)))


def mha_project(p: Params, x: torch.Tensor, name: str, n_head: int
                ) -> torch.Tensor:
    """(B, T, d) → (B, H, T, d_k) through a torch-layout Linear."""
    b, t, d = x.shape
    y = linear(p[name], x)
    return y.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B,H,Tq,dk) x (B,H,Tk,dk) attention; mask broadcastable to
    (B, 1, Tq, Tk), nonzero = attend."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        keep = mask != 0
        scores = torch.where(keep, scores, MASK_MIN)
        attn = torch.softmax(scores, dim=-1)
        attn = torch.where(keep, attn, 0.0)
    else:
        attn = torch.softmax(scores, dim=-1)
    return torch.matmul(attn, v)


def multi_head_attention(p: Params, query: torch.Tensor, key: torch.Tensor,
                         value: torch.Tensor, mask: Optional[torch.Tensor],
                         n_head: int) -> torch.Tensor:
    """Project, attend, merge heads, output projection.

    A 2-D mask is the streaming encoder's shared block-geometry mask and
    goes to the block_attention kernel; (B, Tq, Tk) and (B, 1, Tk) masks go
    to the plain attention."""
    b = query.shape[0]
    q = mha_project(p, query, "linear_q", n_head)
    k = mha_project(p, key, "linear_k", n_head)
    v = mha_project(p, value, "linear_v", n_head)
    if mask is not None and mask.dim() == 2:
        # The kernel reads the projections' transposed views as they lie
        # and returns the view that the merge below turns back without a
        # copy.
        x = block_attention(q, k, v, mask)
    else:
        if mask is not None and mask.dim() == 3:
            mask = mask[:, None, :, :]
        x = scaled_dot_attention(q, k, v, mask)
    x = x.transpose(1, 2).reshape(b, -1, p["linear_out"]["weight"].shape[1])
    return linear(p["linear_out"], x)


def sinusoidal_pe_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    """(max_len, d_model) float32 PE table."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32)
        * -(math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def add_positional_encoding(x: torch.Tensor, pe_table: torch.Tensor,
                            offset: int) -> torch.Tensor:
    """x * sqrt(d) + pe[offset : offset+T]. The start clamps so the window
    stays inside the table, as the JAX package's dynamic slice does."""
    t = x.shape[-2]
    start = max(0, min(int(offset), pe_table.shape[0] - t))
    return x * math.sqrt(x.shape[-1]) + pe_table[start:start + t]
