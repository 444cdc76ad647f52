"""CTC head: projection, log-softmax, greedy decode, and training loss (port
of ``speechcatcher_tpu/models/ctc.py``).

The loss goes through ``torch.nn.functional.ctc_loss`` where the JAX package
calls ``optax.ctc_loss``; both return the per-sequence negative log
likelihood without length normalisation, and both losses here take the batch
mean. They differ on an infeasible alignment (more labels, with their
repeats, than frames): optax clamps it to a large finite value, torch returns
``inf``. The trainer's batcher never builds such a batch (its 2U+1 guard,
``data.BucketBatcher``).

Under a tp group (``parallel.tp``) ``ctc_lo`` is vocab-sharded and its
logits are gathered before any softmax or argmax: everything after them,
the CTC recursion's input and the log-prob ring included, is the same on
every rank. Under a mesh (``ctc_loss``'s `mesh`) the mean runs over the
global batch of the dp ranks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from speechcatcher_tpu_torch.ops.layers import Params, linear
from speechcatcher_tpu_torch.parallel.tp import copy_to_tp, gather_from_tp


def ctc_logits(params: Params, hs: torch.Tensor) -> torch.Tensor:
    """(B, T, d) encoder output → (B, T, vocab) logits."""
    return gather_from_tp(linear(params["ctc_lo"], copy_to_tp(hs)))


def ctc_log_softmax(params: Params, hs: torch.Tensor) -> torch.Tensor:
    # Upcast before normalizing, whatever dtype the frames arrive in.
    return torch.log_softmax(ctc_logits(params, hs).float(), dim=-1)


def ctc_argmax(params: Params, hs: torch.Tensor) -> torch.Tensor:
    return torch.argmax(ctc_logits(params, hs), dim=-1)


def ctc_greedy_collapse(predictions: torch.Tensor, lengths: torch.Tensor,
                        blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop repeats, then blanks, of (B, T) argmax ids within `lengths`.

    Returns (tokens (B, T) left-packed with blank padding, counts (B,)). The
    kept tokens move left through a stable sort on the int form of ``~keep``,
    as ``jnp.argsort(~keep, stable=True)`` does in the JAX package."""
    b, t = predictions.shape
    dev = predictions.device
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=predictions.dtype,
                                 device=dev), predictions[:, :-1]], dim=1)
    keep = (predictions != blank) & (predictions != prev) & valid
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    packed = torch.gather(predictions, 1, order)
    counts = keep.sum(dim=1)
    packed = torch.where(torch.arange(t, device=dev)[None, :]
                         < counts[:, None], packed, blank)
    return packed, counts


def ctc_loss(params: Params, hs: torch.Tensor, hlens: torch.Tensor,
             ys: torch.Tensor, ylens: torch.Tensor, blank: int = 0,
             global_batch: Optional[int] = None) -> torch.Tensor:
    """Mean over the batch of the per-sequence CTC loss: hs (B, T, d), hlens
    (B,), ys (B, U) labels (0-padded), ylens (B,). With `global_batch` the
    sum over these rows is divided by it: this dp rank's share of the mean
    over the global batch.

    ``F.ctc_loss`` takes float32 log-probabilities (T, B, V). Its backward
    returns the gradient with respect to the logits under the log-softmax
    (the posteriors it subtracts sum to one per frame), so the gradient is
    right only through ``log_softmax``, as here."""
    logp = torch.log_softmax(ctc_logits(params, hs).float(), dim=-1)
    per_seq = F.ctc_loss(logp.transpose(0, 1), ys.long(), hlens.long(),
                         ylens.long(), blank=blank, reduction="none")
    if global_batch is None:
        return per_seq.mean()
    return per_seq.sum() / global_batch
