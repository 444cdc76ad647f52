"""Conformer building blocks: convolution module and relative-position MHA.

Port of ``speechcatcher_tpu/ops/conformer.py`` (inference):

- ``conv_module``: optional LayerNorm → pointwise (2C) → GLU → depthwise
  'same' conv → BatchNorm from running statistics → Swish → pointwise;
  the layer of both conformers (the port's and ESPnet's
  ``contextual_block_conformer``).
- ``rel_position_attention``: Transformer-XL "legacy" relative attention
  with learned pos_bias_u / pos_bias_v and the reshape-trick ``rel_shift``.
  The streaming encoder's windows (a shared 2-D geometry mask, one shared
  position table, tq == tk) go to the ``rel_block_attention`` kernel, as the
  JAX package routes them to its Pallas kernel; every other call takes the
  plain PyTorch path, which the JAX package also computes outside Pallas.

Under a tp group (``parallel.tp``) the attention runs on the rank's heads:
``linear_pos`` is column-parallel like q/k/v, and every rank holds the
whole ``pos_bias_u`` and ``pos_bias_v`` and uses its heads' rows. The
convolution module stays replicated (BatchNorm uses running statistics).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
    MASK_MIN,
    rel_block_attention,
    rel_shift,
)
from speechcatcher_tpu_torch.ops.layers import (
    Params,
    copy_to_tp_inputs,
    layer_norm,
    linear,
    mha_project,
    row_parallel_linear,
    swish,
)
from speechcatcher_tpu_torch.parallel.tp import local_rows


def conv_module(p: Params, x: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    """(B, T, C) → (B, T, C). Conv weights keep torch's Conv1d layout
    (out, in/groups, k); the inner LayerNorm is applied only when the
    parameters have one. bfloat16 conv weights are widened to float32 and
    the activations are not rounded (the promotion of a float32 × bfloat16
    product), unlike ``linear``."""
    if "layernorm" in p:
        x = layer_norm(p["layernorm"], x, eps=1e-5)
    w1 = p["pointwise_conv1"]["weight"][:, :, 0].float()
    h = torch.matmul(x, w1.t()) + p["pointwise_conv1"]["bias"]
    a, b = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(b)

    # Depthwise conv with 'same' zero padding over the whole window.
    dw = p["depthwise_conv"]["weight"].float()             # (C, 1, k)
    h = F.conv1d(h.transpose(1, 2), dw, p["depthwise_conv"]["bias"],
                 padding=(dw.shape[-1] - 1) // 2, groups=dw.shape[0])
    h = h.transpose(1, 2)

    bn = p["batch_norm"]
    h = (h - bn["running_mean"]) * torch.rsqrt(bn["running_var"] + eps)
    h = h * bn["weight"] + bn["bias"]
    h = swish(h)
    w2 = p["pointwise_conv2"]["weight"][:, :, 0].float()
    return torch.matmul(h, w2.t()) + p["pointwise_conv2"]["bias"]


def rel_position_attention(
    p: Params,
    query: torch.Tensor,    # (B, Tq, d)
    key: torch.Tensor,      # (B, Tk, d)
    value: torch.Tensor,    # (B, Tk, d)
    pos_emb: torch.Tensor,  # (1 or B, Tk, d)
    mask: Optional[torch.Tensor],
    n_head: int,
) -> torch.Tensor:
    """Relative-position multi-head attention; mask 2-D (Tq, Tk), 3-D
    (B, Tq, Tk) or (B, 1, Tk), nonzero = attend. `n_head` counts every
    rank's heads."""
    b, tq = query.shape[:2]
    query, key, value = copy_to_tp_inputs(query, key, value)
    q = mha_project(p, query, "linear_q", n_head)
    k = mha_project(p, key, "linear_k", n_head)
    v = mha_project(p, value, "linear_v", n_head)
    h, dk = q.shape[1], q.shape[3]
    pos = linear(p["linear_pos"], pos_emb)
    pos = pos.reshape(pos_emb.shape[0], -1, h, dk).transpose(1, 2)
    bias_u, bias_v = local_rows(p["pos_bias_u"]), local_rows(p["pos_bias_v"])

    if (mask is not None and mask.dim() == 2 and pos.shape[0] == 1
            and pos.shape[2] == key.shape[1] and tq == key.shape[1]):
        # The kernel reads the projections' transposed views as they lie
        # and returns the view that the merge below turns back without a
        # copy.
        out = rel_block_attention(q, k, v, pos[0], bias_u, bias_v, mask)
    else:
        q_u = q + bias_u[None, :, None, :]
        q_v = q + bias_v[None, :, None, :]
        ac = torch.matmul(q_u, k.transpose(-1, -2))
        bd = rel_shift(torch.matmul(q_v, pos.transpose(-1, -2)))
        scores = (ac + bd) / math.sqrt(dk)
        if mask is not None:
            if mask.dim() == 3:
                mask = mask[:, None, :, :]
            keep = mask != 0
            scores = torch.where(keep, scores, MASK_MIN)
            attn = torch.softmax(scores, dim=-1)
            attn = torch.where(keep, attn, 0.0)
        else:
            attn = torch.softmax(scores, dim=-1)
        out = torch.matmul(attn, v)
    out = out.transpose(1, 2).reshape(b, tq, h * dk)
    return row_parallel_linear(p["linear_out"], out)
