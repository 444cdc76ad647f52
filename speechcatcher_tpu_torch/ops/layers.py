"""Transformer building blocks on parameter dictionaries of tensors.

Port of ``speechcatcher_tpu/ops/layers.py``. Parameters keep the torch
layout the JAX package already uses (Linear weights (out, in)). Contracts
kept from the reference: LayerNorm eps 1e-12; FFN Linear→ReLU→Linear;
attention fills masked scores with the float32 minimum before the softmax
and zeroes masked probabilities after it, so a fully masked row outputs 0;
sinusoidal PE scaled by sqrt(d).

Precision modes: ``cast_params`` stores the matmul weights in bfloat16 and
``quantize_params_int8`` stores linear weights as int8 beside a float32
per-output-channel ``weight_scale``. ``linear`` then rounds its input to
bfloat16, accumulates the products in float32 and returns float32 in every
mode, so normalisation and softmax stay float32. Where the JAX package
splits on its backend, the port follows the non-TPU branch.

Tensor parallelism (``parallel.tp``): under a tp group the attention runs
on the rank's heads and the column-parallel linears (q/k/v, w_1) on its
output columns; ``row_parallel_linear`` sums the row-parallel products
(linear_out, w_2) over the group before adding the bias once. Without a
group every function here runs what it runs on one card.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from speechcatcher_tpu_torch.ops.kernels.block_attention import (
    MASK_MIN,
    block_attention,
)
from speechcatcher_tpu_torch.parallel.tp import (
    copy_to_tp,
    local_heads,
    reduce_from_tp,
    tp_size,
)

Params = Dict[str, torch.Tensor]

LAYERNORM_EPS = 1e-12

# Capability, tested once at import: this PyTorch has the ``aten::mm``
# overload that takes bfloat16 operands and returns a float32 product
# (``torch.mm(a, b, out_dtype=torch.float32)``; CUDA tensors only).
MM_OUT_DTYPE = "dtype" in torch.ops.aten.mm.overloads()


def gemm_route(device: torch.device) -> str:
    """How ``linear`` multiplies bfloat16 operands into float32 on `device`:
    "mm_out_dtype" (one library GEMM on the tensor cores, float32
    accumulator and result) or "widened" (both rounded operands widened to
    float32 and multiplied there; products of two bfloat16 are exact in
    float32, so the two differ only in the order of the sum)."""
    dev = torch.device(device)
    return "mm_out_dtype" if dev.type == "cuda" and MM_OUT_DTYPE else "widened"


def _walk(fn, tree, path: str = ""):
    """Apply fn(path, leaf) to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cast_params(params, dtype: torch.dtype = torch.bfloat16):
    """Cast matmul weights to bfloat16 for mixed-precision inference; norms,
    biases, position biases and the token embedding stay float32. Caught:
    every float32 leaf of two or more dims named ``weight`` outside a norm,
    so the linears, the conv2d subsampling kernels and the conformer's
    pointwise and depthwise conv weights. Works on a layer-stacked tree and
    on the port's per-layer lists alike; returns a new tree."""
    def cast(path, x):
        if (x.dtype == torch.float32 and x.dim() >= 2 and "weight" in path
                and "norm" not in path
                and not path.endswith("embed/weight")):
            return x.to(dtype)
        return x

    return _walk(cast, params)


def quantize_params_int8(params,
                         scope: Optional[Sequence[str]] = ("encoder",)):
    """Weight-only int8 quantisation of linear weights, symmetric and per
    output channel: weight (..., out, in) → int8 beside a float32
    ``weight_scale`` (..., out), ``s = max(max|w| / 127, 1e-12)``,
    ``q = clip(round(w / s), -127, 127)``.

    Eligible: dicts holding a 2-D or 3-D (layer-stacked) float ``weight``
    whose path avoids norm, embed and conv. `scope` keeps the quantisation to
    paths that contain one of its entries (default: the encoder; None for
    every eligible linear). The tree keeps the int8 leaves; ``linear``
    multiplies them as exact bfloat16 casts and scales the float32 sum."""
    def walk(node, path):
        if isinstance(node, dict):
            w = node.get("weight")
            eligible = (
                isinstance(w, torch.Tensor) and w.dim() in (2, 3)
                and w.dtype in (torch.float32, torch.bfloat16)
                and not any(t in path for t in ("norm", "embed", "conv"))
                and (scope is None or any(s in path for s in scope))
            )
            out = {}
            for k, v in node.items():
                if k == "weight" and eligible:
                    wf = v.float()
                    s = (wf.abs().amax(dim=-1) / 127.0).clamp(min=1e-12)
                    out["weight"] = torch.clamp(
                        torch.round(wf / s[..., None]), -127, 127
                    ).to(torch.int8)
                    out["weight_scale"] = s
                else:
                    out[k] = walk(v, f"{path}/{k}")
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}")
                              for i, v in enumerate(node))
        return node

    return walk(params, "")


def dense_weight(p: Params) -> torch.Tensor:
    """A torch-layout (out, in) weight as a dense float32 tensor: bfloat16
    widened, int8 dequantised by its per-channel scale."""
    w = p["weight"]
    if w.dtype == torch.int8:
        return w.float() * p["weight_scale"][:, None]
    return w.float()


def _matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., in) · (out, in)ᵀ for bfloat16 operands, accumulated in and
    returned as float32 (torch.matmul of two bfloat16 tensors would round
    the result to bfloat16)."""
    if gemm_route(x.device) == "mm_out_dtype":
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return torch.matmul(x.float(), w.float().t())


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b with a torch-layout (out, in) weight; float32 result.

    A bfloat16 weight (cast_params) rounds the input to bfloat16; an int8
    weight (quantize_params_int8) multiplies as its exact bfloat16 cast and
    the float32 sum takes the per-output-channel scale. Products accumulate
    in float32 on every path."""
    w = p["weight"]
    if w.dtype == torch.int8:
        y = _matmul_bf16(x.bfloat16(), w.bfloat16()) * p["weight_scale"]
    elif w.dtype == torch.bfloat16:
        y = _matmul_bf16(x.bfloat16(), w)
    else:
        y = torch.matmul(x.float(), w.t())
    if "bias" in p:
        y = y + p["bias"]
    return y


def row_parallel_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``linear`` of a row-parallel leaf (linear_out, w_2): under a tp group
    each rank holds the weight's columns of its input features, the partial
    products are summed over the group and the bias is added once."""
    if tp_size() == 1:
        return linear(p, x)
    y, bias = row_parallel_product(p, x)
    return y if bias is None else y + bias


def row_parallel_product(p: Params, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``row_parallel_linear`` with its bias apart: the product (summed over
    the tp group under one) and the bias (None without one), for a caller
    that adds the bias inside a later kernel."""
    y = linear({k: v for k, v in p.items() if k != "bias"}, x)
    if tp_size() > 1:
        y = reduce_from_tp(y)
    return y, p.get("bias")


def layer_norm(p: Params, x: torch.Tensor, eps: float = LAYERNORM_EPS
               ) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    xhat = (x - mean) * torch.rsqrt(var + eps)
    return xhat * p["weight"] + p["bias"]


def swish(x: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(x): the conformers' convolution module and ESPnet's
    conformer feed-forwards."""
    return x * torch.sigmoid(x)


def feed_forward(p: Params, x: torch.Tensor, activation=torch.relu
                 ) -> torch.Tensor:
    """Position-wise FFN: w_2(activation(w_1(x))), ReLU by default."""
    return row_parallel_linear(
        p["w_2"], activation(linear(p["w_1"], copy_to_tp(x))))


def mha_project(p: Params, x: torch.Tensor, name: str, n_head: int
                ) -> torch.Tensor:
    """(B, T, d) → (B, H, T, d_k) through a torch-layout Linear; H is the
    rank's share of `n_head` under a tp group."""
    b, t = x.shape[:2]
    y = linear(p[name], x)
    h = local_heads(n_head)
    return y.reshape(b, t, h, y.shape[-1] // h).transpose(1, 2)


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
    to the plain attention. `n_head` counts every rank's heads."""
    b = query.shape[0]
    query, key, value = copy_to_tp_inputs(query, key, value)
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
    return row_parallel_linear(p["linear_out"], x)


def copy_to_tp_inputs(query: torch.Tensor, key: torch.Tensor,
                      value: torch.Tensor):
    """``copy_to_tp`` of an attention's inputs, once for a tensor that
    serves as several (self-attention's query, key and value)."""
    q = copy_to_tp(query)
    k = q if key is query else copy_to_tp(key)
    v = k if value is key else (q if value is query else copy_to_tp(value))
    return q, k, v


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
                            offset: Union[int, torch.Tensor]) -> torch.Tensor:
    """x * sqrt(d) + pe[offset : offset+T]. The start clamps so the window
    stays inside the table, as the JAX package's dynamic slice does.

    `offset` is a host int or a 0-d integer tensor on the table's device;
    the tensor form gathers the rows without reading the offset on the host
    (a captured chunk step's stream offset changes between replays), with
    the same values as the slice."""
    t = x.shape[-2]
    if isinstance(offset, torch.Tensor):
        start = offset.long().clamp(0, pe_table.shape[0] - t)
        pe = pe_table[start + torch.arange(t, device=pe_table.device)]
    else:
        start = max(0, min(int(offset), pe_table.shape[0] - t))
        pe = pe_table[start:start + t]
    return x * math.sqrt(x.shape[-1]) + pe
