"""Seeded random weights, made on the device in a few calls of a
``torch.Generator`` on the card: one uniform draw for every uniform leaf,
one normal draw for the token embedding.

The values are drawn from the configuration's ``weights_seed``, not from
``--seed``: with random weights the number of tokens a model emits a second
depends on the draw (one draw emitted four times as many as another on the
same traffic), and that is the work a serving cell does. ``--seed`` drives
the traffic and its audio only.

The tree's layout and distributions are those of the configuration's
reference module (``weight_specs`` in ``benchmark/reference/<name>.py``),
which reads it: each leaf ("u", shape, bound) uniform in ±bound, ("n",
shape) standard-normal, ("0", shape) or ("1", shape) constant. The leaves
are drawn in the order of their sorted paths. The configuration's emission
biases are then added to the decoder's EOS logit and the CTC head's blank
logit.

The same tree is handed to the program (as numpy, through its loader,
which copies it) and to the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

SEED_MASK = (1 << 63) - 1


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


def make_tree(m: Dict, bias: Dict, seed: int, device,
              specs: Callable[[Dict], Dict]) -> Dict:
    """The weight tree of configuration `m` on `device`, drawn from `seed`
    in the layout ``specs(m)`` gives (the reference's ``weight_specs``)."""
    spec = specs(m)
    leaves = _leaves(spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    uniform = [(p, s) for p, s in leaves if s[0] == "u"]
    n_u = sum(math.prod(s[1]) for _, s in uniform)
    flat = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    out = specs(m)
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
