"""Weights: random initialisation as numpy, and numpy → the port's tensors.

``random_params(cfg, seed)`` draws a parameter tree with exactly the layout
of the JAX package's ``ASRModel.random_init(...).params``: nested dicts (and
the ``convs`` list), layer-stacked ``layers`` leaves with a leading layer
axis, torch-layout (out, in) Linear weights, float32 everywhere. The
distributions are those of the JAX initialisers (uniform ±1/sqrt(fan_in)
weights, zero biases, unit LayerNorm, standard-normal token embedding; for
the port's conformer also Xavier-uniform position biases, for both
conformers identity BatchNorm statistics), drawn from
``np.random.default_rng(seed)``; the numbers differ from JAX's own
random_init, which uses JAX keys.

``params_from_numpy(tree, device)`` turns any such numpy tree into tensors,
whether it came from here or from the JAX package; ``params_to_numpy`` turns
the port's tree (``layers`` as lists) back into that layout.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List

import numpy as np
import torch

from speechcatcher_tpu_torch.config import CB_CONFORMER, ModelConfig
from speechcatcher_tpu_torch.geometry import CONV_SPECS, subsampled_len

def _uniform(rng: np.random.Generator, shape, bound: float) -> np.ndarray:
    return ((rng.random(shape, dtype=np.float32) * 2.0 - 1.0)
            * np.float32(bound)).astype(np.float32)


def _linear(rng, d_in: int, d_out: int, lead=()) -> Dict[str, np.ndarray]:
    return {
        "weight": _uniform(rng, tuple(lead) + (d_out, d_in),
                           1.0 / math.sqrt(d_in)),
        "bias": np.zeros(tuple(lead) + (d_out,), np.float32),
    }


def _layer_norm(d: int, lead=()) -> Dict[str, np.ndarray]:
    return {"weight": np.ones(tuple(lead) + (d,), np.float32),
            "bias": np.zeros(tuple(lead) + (d,), np.float32)}


def _mha(rng, d: int, lead) -> Dict[str, Any]:
    return {name: _linear(rng, d, d, lead)
            for name in ("linear_q", "linear_k", "linear_v", "linear_out")}


def _ffn(rng, d: int, hidden: int, lead) -> Dict[str, Any]:
    return {"w_1": _linear(rng, d, hidden, lead),
            "w_2": _linear(rng, hidden, d, lead)}


def _rel_mha(rng, d: int, n_head: int, lead) -> Dict[str, Any]:
    """Relative-position attention: the four projections, a bias-free
    linear_pos and Xavier-uniform pos_bias_u / pos_bias_v (H, dk)."""
    p = _mha(rng, d, lead)
    p["linear_pos"] = {"weight": _uniform(rng, tuple(lead) + (d, d),
                                          1.0 / math.sqrt(d))}
    dk = d // n_head
    bound = math.sqrt(6.0 / (n_head + dk))
    p["pos_bias_u"] = _uniform(rng, tuple(lead) + (n_head, dk), bound)
    p["pos_bias_v"] = _uniform(rng, tuple(lead) + (n_head, dk), bound)
    return p


def _conv_module(rng, c: int, kernel_size: int, lead) -> Dict[str, Any]:
    """Conformer convolution module: torch Conv1d layout (out, in/groups,
    k), identity BatchNorm running statistics."""
    lead = tuple(lead)

    def conv(out_ch, in_ch, k, bound):
        return {"weight": _uniform(rng, lead + (out_ch, in_ch, k), bound),
                "bias": np.zeros(lead + (out_ch,), np.float32)}

    return {
        "pointwise_conv1": conv(2 * c, c, 1, 1.0 / math.sqrt(c)),
        "depthwise_conv": conv(c, 1, kernel_size,
                               1.0 / math.sqrt(kernel_size)),
        "batch_norm": {"weight": np.ones(lead + (c,), np.float32),
                       "bias": np.zeros(lead + (c,), np.float32),
                       "running_mean": np.zeros(lead + (c,), np.float32),
                       "running_var": np.ones(lead + (c,), np.float32)},
        "pointwise_conv2": conv(c, c, 1, 1.0 / math.sqrt(c)),
    }


def _encoder(rng, cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.encoder_dim
    if cfg.input_layer == "linear":
        embed: Dict[str, Any] = {"out": _linear(rng, cfg.n_mels, d),
                                 "norm": _layer_norm(d)}
    else:
        kernels, _ = CONV_SPECS[cfg.input_layer]
        convs: List[Dict[str, np.ndarray]] = []
        in_ch = 1
        for k in kernels:
            convs.append({
                "weight": _uniform(rng, (d, in_ch, k, k),
                                   1.0 / math.sqrt(in_ch * k * k)),
                "bias": np.zeros((d,), np.float32),
            })
            in_ch = d
        feat = subsampled_len(cfg.n_mels, cfg.input_layer)
        embed = {"convs": convs, "out": _linear(rng, d * feat, d)}
    lead = (cfg.encoder_layers,)
    if cfg.encoder_type == "conformer":
        layers = {
            "self_attn": _rel_mha(rng, d, cfg.encoder_heads, lead),
            "feed_forward": _ffn(rng, d, cfg.encoder_linear_units, lead),
            "feed_forward_macaron": _ffn(rng, d, cfg.encoder_linear_units,
                                         lead),
            "conv_module": _conv_module(rng, d, cfg.conformer_kernel_size,
                                        lead),
            **{name: _layer_norm(d, lead) for name in (
                "norm_ff", "norm_ff_macaron", "norm_mha", "norm_conv",
                "norm_final")},
        }
    elif cfg.encoder_type == CB_CONFORMER:
        # ESPnet's layer: plain attention (no position projection or
        # biases), a macaron feed-forward only with macaron_style.
        layers = {
            "self_attn": _mha(rng, d, lead),
            "feed_forward": _ffn(rng, d, cfg.encoder_linear_units, lead),
            "conv_module": _conv_module(rng, d, cfg.conformer_kernel_size,
                                        lead),
            **{name: _layer_norm(d, lead) for name in (
                "norm_ff", "norm_mha", "norm_conv", "norm_final")},
        }
        if cfg.macaron_style:
            layers["feed_forward_macaron"] = _ffn(
                rng, d, cfg.encoder_linear_units, lead)
            layers["norm_ff_macaron"] = _layer_norm(d, lead)
    else:
        layers = {
            "self_attn": _mha(rng, d, lead),
            "feed_forward": _ffn(rng, d, cfg.encoder_linear_units, lead),
            "norm1": _layer_norm(d, lead),
            "norm2": _layer_norm(d, lead),
        }
    return {"embed": embed, "layers": layers, "after_norm": _layer_norm(d)}


def _decoder(rng, cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.decoder_dim
    lead = (cfg.decoder_layers,)
    embed = {"weight": rng.standard_normal((cfg.vocab_size, d),
                                           dtype=np.float32)}
    layers = {
        "self_attn": _mha(rng, d, lead),
        "src_attn": _mha(rng, d, lead),
        "feed_forward": _ffn(rng, d, cfg.decoder_linear_units, lead),
        "norm1": _layer_norm(d, lead),
        "norm2": _layer_norm(d, lead),
        "norm3": _layer_norm(d, lead),
    }
    return {"embed": embed, "layers": layers, "after_norm": _layer_norm(d),
            "output_layer": _linear(rng, d, cfg.vocab_size)}


def _lm(rng, cfg: ModelConfig) -> Dict[str, Any]:
    """ESPnet's ``TransformerLM`` (``pos_enc: null``): the token embedding,
    the linear input layer (Linear, LayerNorm, ReLU), pre-norm layers of
    self-attention and a ReLU feed-forward, the after-norm and the output
    layer over the vocabulary."""
    d = cfg.lm_dim
    lead = (cfg.lm_layers,)
    return {
        "embed": {"weight": rng.standard_normal(
            (cfg.vocab_size, cfg.lm_embed_dim), dtype=np.float32)},
        "input_layer": {"out": _linear(rng, cfg.lm_embed_dim, d),
                        "norm": _layer_norm(d)},
        "layers": {
            "self_attn": _mha(rng, d, lead),
            "feed_forward": _ffn(rng, d, cfg.lm_linear_units, lead),
            "norm1": _layer_norm(d, lead),
            "norm2": _layer_norm(d, lead),
        },
        "after_norm": _layer_norm(d),
        "output_layer": _linear(rng, d, cfg.vocab_size),
    }


def random_params(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """Random numpy parameter tree with the JAX package's exact layout (and,
    with ``lm_layers``, the fused LM's ``lm`` subtree, drawn last)."""
    rng = np.random.default_rng(seed)
    tree = {
        "encoder": _encoder(rng, cfg),
        "decoder": _decoder(rng, cfg),
        "ctc": {"ctc_lo": _linear(rng, cfg.encoder_dim, cfg.vocab_size)},
    }
    if cfg.lm_layers:
        tree["lm"] = _lm(rng, cfg)
    return tree


def tree_map(fn, tree):
    """Apply fn to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree, path=""):
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def unstack_layers(stacked):
    """Layer-stacked tree (leading layer axis) → list of per-layer trees of
    views."""
    n = next(tree_leaves(stacked))[1].shape[0]
    return [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]


def params_checksum(tree) -> str:
    """sha256 over every leaf's path, shape, dtype and bytes."""
    h = hashlib.sha256()
    for path, leaf in tree_leaves(tree):
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(f"{path}:{a.shape}:{a.dtype}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def params_from_numpy(tree, device) -> Dict[str, Any]:
    """Numpy (or array-like) tree → the same tree of tensors on `device`."""
    dev = torch.device(device)
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(dev), tree
    )


def _stack_layers(layers: list):
    """Per-layer numpy trees (dicts of arrays) → one tree of arrays with a
    leading layer axis."""
    if isinstance(layers[0], dict):
        return {k: _stack_layers([l[k] for l in layers]) for k in layers[0]}
    return np.stack(layers)


def params_to_numpy(params) -> Dict[str, Any]:
    """The port's tree (each ``layers`` entry a list of per-layer dicts) →
    numpy in the JAX pytree layout (layers stacked on a leading axis), the
    inverse of ``params_from_numpy`` + ``unstack_layers``. bfloat16 leaves
    widen to float32 (numpy has no bfloat16)."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            items = [walk(v) for v in node]
            return (_stack_layers(items) if key == "layers"
                    else type(node)(items))
        x = node.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()

    return walk(params)


def trainable_leaves(params) -> List[torch.Tensor]:
    """Mark every floating-point leaf trainable (``requires_grad_()``) and
    return them in ``tree_leaves`` order. The per-layer views of the port's
    tree are leaves of their own here: gradients and in-place updates land
    on the views, whose memory is the stacked tensor's."""
    leaves = []
    for _, x in tree_leaves(params):
        if x.is_floating_point():
            leaves.append(x.requires_grad_())
    return leaves
