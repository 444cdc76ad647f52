"""Tensor parallelism: the tp group of this process and Megatron's conjugate
collectives as autograd Functions.

The JAX package lets GSPMD insert the collectives of a tensor-parallel
program. The port runs one process per card and inserts them by hand, at
the points the sharding rules of ``parallel.mesh`` (``_param_spec``) imply:

- ``copy_to_tp`` before a column-parallel linear (q/k/v, w_1, linear_pos,
  output_layer, ctc_lo): identity forward; the backward all-reduces the
  input gradient, whose parts each rank computes from its own columns.
- ``reduce_from_tp`` after a row-parallel linear (linear_out, w_2) and the
  vocab-sharded embedding lookup: all-reduce forward, identity backward.
- ``gather_from_tp`` after the vocab-sharded output projections
  (output_layer, ctc_lo): all-gather on the last axis, its backward the
  rank's own slice, so every softmax, argmax and kernel after it sees the
  whole vocabulary on every rank.

They act only while a tp group of more than one rank is set
(``set_tp_group``). Without one each is the identity on its argument, so
the single-card path runs exactly the operations it runs without this
module: no collective, no copy, no host sync.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_GROUP: Optional[dist.ProcessGroup] = None
_SIZE = 1
_RANK = 0


def set_tp_group(group: Optional[dist.ProcessGroup]) -> None:
    """Make `group` this process's tp group (None: no tensor parallelism).
    A group of one rank is no tensor parallelism."""
    global _GROUP, _SIZE, _RANK
    size = 1 if group is None else dist.get_world_size(group)
    _GROUP = group if size > 1 else None
    _SIZE = size if size > 1 else 1
    _RANK = dist.get_rank(group) if size > 1 else 0


def tp_size() -> int:
    return _SIZE


def tp_rank() -> int:
    return _RANK


def tp_group() -> Optional[dist.ProcessGroup]:
    return _GROUP


def local_heads(n_head: int) -> int:
    """The attention heads of this rank: n_head / tp."""
    if n_head % _SIZE:
        raise ValueError(f"tp={_SIZE} does not divide {n_head} heads")
    return n_head // _SIZE


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a tensor that every rank holds whole and uses
    in tp parts along dim 0 (the conformer's (H, dk) position biases)."""
    if _SIZE == 1:
        return x
    n = x.shape[0] // _SIZE
    return x[_RANK * n:(_RANK + 1) * n]


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, group=_GROUP)
    return y


def _all_gather_last(x: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(_SIZE)]
    dist.all_gather(parts, x.contiguous(), group=_GROUP)
    return torch.cat(parts, dim=-1)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.width = x.shape[-1]
        return _all_gather_last(x)

    @staticmethod
    def backward(ctx, grad):
        w = ctx.width
        return grad[..., _RANK * w:(_RANK + 1) * w].contiguous()


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel linear (identity without a group)."""
    return x if _GROUP is None else _CopyToTP.apply(x)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum of the ranks' partial results (identity without a group)."""
    return x if _GROUP is None else _ReduceFromTP.apply(x)


def gather_from_tp(x: torch.Tensor) -> torch.Tensor:
    """The ranks' last-axis blocks side by side (identity without a
    group)."""
    return x if _GROUP is None else _GatherFromTP.apply(x)


def vocab_lookup(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows `ids` of a (vocab, d) embedding whose rows the tp ranks split in
    blocks: each rank looks up the ids in its block, zeros the others, and
    the ranks' rows are summed. Without a group: ``weight[ids]``."""
    if _GROUP is None:
        return weight[ids]
    n = weight.shape[0]
    local = ids - _RANK * n
    mine = (local >= 0) & (local < n)
    rows = torch.where(mine[..., None], weight[local.clamp(0, n - 1)], 0.0)
    return _ReduceFromTP.apply(rows)
