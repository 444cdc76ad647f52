"""Seeded random weights, made on the device in a few calls of a
``torch.Generator`` on the card: one uniform draw for every uniform leaf,
one normal draw for the token embedding.

The values are drawn from the configuration's ``weights_seed``, not from
``--seed``: with random weights the number of tokens a model emits a second
depends on the draw (one draw emitted four times as many as another on the
same traffic), and that is the work a serving cell does. ``--seed`` drives
the traffic and its audio only.

The tree has the layout in which the program loads weights
(``ASRModel.from_numpy``: nested dicts, the encoder's ``convs`` list, layer
leaves stacked on a leading axis, torch-layout (out, in) linear weights) and
the distributions of the program's own random initialisation: uniform
±1/sqrt(fan_in) weights, zero biases, unit LayerNorms, a standard-normal
token embedding, Xavier-uniform position biases and identity BatchNorm
statistics. The configuration's emission biases are then added to the
decoder's EOS logit and the CTC head's blank logit.

The same tree is handed to the program (as numpy, through its loader,
which copies it) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SEED_MASK = (1 << 63) - 1


def _specs(m: Dict) -> Dict:
    """The tree with leaves ("u", shape, bound), ("n", shape), ("0", shape)
    or ("1", shape)."""
    d, vocab = m["encoder_dim"], m["vocab_size"]

    def lin(d_in, d_out, lead=(), bias=True):
        p = {"weight": ("u", lead + (d_out, d_in), 1.0 / math.sqrt(d_in))}
        if bias:
            p["bias"] = ("0", lead + (d_out,))
        return p

    def norm(n, lead=()):
        return {"weight": ("1", lead + (n,)), "bias": ("0", lead + (n,))}

    def mha(lead):
        return {k: lin(d, d, lead) for k in ("linear_q", "linear_k",
                                              "linear_v", "linear_out")}

    def ffn(hidden, lead):
        return {"w_1": lin(d, hidden, lead), "w_2": lin(hidden, d, lead)}

    if m["input_layer"] != "conv2d":
        raise ValueError("the benchmark's weights know the conv2d input layer")
    f2 = ((m["n_mels"] - 3) // 2 + 1 - 3) // 2 + 1
    embed = {"convs": [
        {"weight": ("u", (d, 1, 3, 3), 1.0 / 3.0), "bias": ("0", (d,))},
        {"weight": ("u", (d, d, 3, 3), 1.0 / math.sqrt(d * 9)),
         "bias": ("0", (d,))}],
        "out": lin(d * f2, d)}
    el = (m["encoder_layers"],)
    if m["encoder_type"] == "conformer":
        h = m["encoder_heads"]
        dk = d // h
        attn = mha(el)
        attn["linear_pos"] = {"weight": ("u", el + (d, d),
                                         1.0 / math.sqrt(d))}
        xb = math.sqrt(6.0 / (h + dk))
        attn["pos_bias_u"] = ("u", el + (h, dk), xb)
        attn["pos_bias_v"] = ("u", el + (h, dk), xb)
        k = m["conformer_kernel_size"]
        conv = {
            "pointwise_conv1": {"weight": ("u", el + (2 * d, d, 1),
                                           1.0 / math.sqrt(d)),
                                "bias": ("0", el + (2 * d,))},
            "depthwise_conv": {"weight": ("u", el + (d, 1, k),
                                          1.0 / math.sqrt(k)),
                               "bias": ("0", el + (d,))},
            "batch_norm": {"weight": ("1", el + (d,)),
                           "bias": ("0", el + (d,)),
                           "running_mean": ("0", el + (d,)),
                           "running_var": ("1", el + (d,))},
            "pointwise_conv2": {"weight": ("u", el + (d, d, 1),
                                           1.0 / math.sqrt(d)),
                                "bias": ("0", el + (d,))},
        }
        layers = {"self_attn": attn,
                  "feed_forward": ffn(m["encoder_linear_units"], el),
                  "feed_forward_macaron": ffn(m["encoder_linear_units"], el),
                  "conv_module": conv,
                  **{n: norm(d, el) for n in ("norm_ff", "norm_ff_macaron",
                                              "norm_mha", "norm_conv",
                                              "norm_final")}}
    else:
        layers = {"self_attn": mha(el),
                  "feed_forward": ffn(m["encoder_linear_units"], el),
                  "norm1": norm(d, el), "norm2": norm(d, el)}
    dl = (m["decoder_layers"],)
    decoder = {"embed": {"weight": ("n", (vocab, d))},
               "layers": {"self_attn": mha(dl), "src_attn": mha(dl),
                          "feed_forward": ffn(m["decoder_linear_units"], dl),
                          "norm1": norm(d, dl), "norm2": norm(d, dl),
                          "norm3": norm(d, dl)},
               "after_norm": norm(d),
               "output_layer": lin(d, vocab)}
    return {"encoder": {"embed": embed, "layers": layers,
                        "after_norm": norm(d)},
            "decoder": decoder,
            "ctc": {"ctc_lo": lin(d, vocab)}}


def _leaves(tree, path=()) -> List[Tuple[tuple, tuple]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make_tree(m: Dict, bias: Dict, seed: int, device) -> Dict:
    """The weight tree of configuration `m` on `device`, drawn from
    `seed`."""
    spec = _specs(m)
    leaves = _leaves(spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    uniform = [(p, s) for p, s in leaves if s[0] == "u"]
    n_u = sum(math.prod(s[1]) for _, s in uniform)
    flat = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    out = _specs(m)
    off = 0
    for path, (_, shape, bound) in uniform:
        n = math.prod(shape)
        _set(out, path, (flat[off:off + n] * bound).reshape(shape))
        off += n
    for path, s in leaves:
        if s[0] == "n":
            _set(out, path, torch.randn(s[1], generator=gen, device=device))
        elif s[0] in "01":
            _set(out, path, torch.full(s[1], float(s[0]), device=device))
    eos, blank = m["vocab_size"] - 1, 0
    out["decoder"]["output_layer"]["bias"][eos] += bias["eos"]
    out["ctc"]["ctc_lo"]["bias"][blank] += bias["blank"]
    return out


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def copy_into(dst, src) -> None:
    """Write the values of tree `src` into the tensors of tree `dst` (the
    same layout, or dst's layers as per-layer views of stacked leaves)."""
    if isinstance(dst, dict):
        for k in dst:
            copy_into(dst[k], src[k])
    elif isinstance(dst, list) and isinstance(src, list):
        for a, b in zip(dst, src):
            copy_into(a, b)
    elif isinstance(dst, list):     # per-layer views of a stacked tree
        for i, layer in enumerate(dst):
            copy_into(layer, _index(src, i))
    else:
        dst.copy_(src)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
