"""CTC head: projection, log-softmax, greedy decode, and training loss (port
of ``speechcatcher_tpu/models/ctc.py``).

The loss is the port's own copy of the formulation the JAX package calls,
``optax.ctc_loss`` (``ctc_loss_with_forward_probs``): a loop over the frames
of log-space updates of the blank and label states, every forbidden
transition weighted by ``LOG_EPSILON`` rather than excluded, so an
infeasible alignment (more labels, with their repeats, than frames) gets
optax's large finite value. Autograd through the loop gives the gradient,
as ``jax.grad`` through optax's ``lax.scan`` does. Lengths stay on the
device: nothing reads the card, so a CUDA graph can capture the loss.

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


# optax.ctc_loss's log_epsilon: the log-probability of a forbidden
# transition.
LOG_EPSILON = -1e5


class LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` of two tensors of one shape, differentiated as
    JAX differentiates ``jnp.logaddexp``: ``g · exp(x - out)`` for each
    operand x. Equal in exact arithmetic to torch's ``g / (1 + exp(y -
    x))``, but where the operands lie near ``LOG_EPSILON`` multiples (an
    infeasible alignment) ``x - out`` keeps out's rounding, and the
    gradients follow optax's only with its formula."""

    @staticmethod
    def forward(ctx, x, y):
        out = torch.logaddexp(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, y, out = ctx.saved_tensors
        return grad * torch.exp(x - out), grad * torch.exp(y - out)


def _add_to_tail(phi: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """phi with ``score`` log-added to every column but the first (optax's
    ``update_phi_score``)."""
    return torch.cat([phi[:, :1], LogAddExp.apply(phi[:, 1:], score)],
                     dim=1)


def ctc_nll(logits: torch.Tensor, hlens: torch.Tensor, ys: torch.Tensor,
            ylens: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood of (B, T, V) float32
    logits, frames at or past `hlens` padding, against (B, N) labels of
    lengths `ylens`: optax's ``ctc_loss_with_forward_probs`` step for step.

    ``phi`` (B, N + 1) holds the log-probability of having emitted n labels
    and sitting on a blank, ``emit`` (B, N) that of sitting on label n. A
    frame first moves emit to phi (forbidden before a repeated label), then
    steps: a label is emitted from the blank before it or repeated, a blank
    is repeated or follows the label (only before a repeated label; the
    other case took the first move). A padded frame keeps the state. The
    loss is ``-phi[ylens]`` after a last emit-to-phi move. The label
    log-probabilities are a product with the labels' one-hot rows, as
    optax's einsum: exact, and its backward a product too (no atomics)."""
    b, t, k = logits.shape
    n = ys.shape[1]
    dev = logits.device
    logp = torch.log_softmax(logits, dim=-1)
    ys = ys.long()
    repeat = F.pad((ys[:, :-1] == ys[:, 1:]).to(logp.dtype), (0, 1))
    emit_to_phi = LOG_EPSILON * repeat
    blank_to_phi = LOG_EPSILON * (1.0 - repeat)
    one_hot = (ys[:, :, None] == torch.arange(k, device=dev)).to(logp.dtype)
    logp_emit = torch.bmm(logp, one_hot.transpose(1, 2)).transpose(0, 1)
    logp_phi = logp[:, :, blank].transpose(0, 1)[:, :, None]   # (T, B, 1)
    pad = (torch.arange(t, device=dev)[:, None]
           >= hlens[None, :])[:, :, None]                      # (T, B, 1)
    phi = F.pad(torch.full((b, n), LOG_EPSILON, device=dev), (1, 0))
    emit = torch.full((b, n), LOG_EPSILON, device=dev)
    for i in range(t):
        phi_in = _add_to_tail(phi, emit + emit_to_phi)
        next_emit = LogAddExp.apply(phi_in[:, :-1] + logp_emit[i],
                                    emit + logp_emit[i])
        next_phi = _add_to_tail(phi_in + logp_phi[i],
                                emit + logp_phi[i] + blank_to_phi)
        emit = torch.where(pad[i], emit, next_emit)
        phi = torch.where(pad[i], phi, next_phi)
    last = _add_to_tail(phi, emit)
    pick = (torch.arange(n + 1, device=dev)
            == ylens[:, None].long()).to(last.dtype)
    return -(last * pick).sum(dim=1)


def ctc_loss(params: Params, hs: torch.Tensor, hlens: torch.Tensor,
             ys: torch.Tensor, ylens: torch.Tensor, blank: int = 0,
             global_batch: Optional[int] = None) -> torch.Tensor:
    """Mean over the batch of the per-sequence CTC loss (``ctc_nll``): hs
    (B, T, d), hlens (B,), ys (B, U) labels (0-padded), ylens (B,). With
    `global_batch` the sum over these rows is divided by it: this dp rank's
    share of the mean over the global batch."""
    per_seq = ctc_nll(ctc_logits(params, hs).float(), hlens, ys, ylens,
                      blank)
    if global_batch is None:
        return per_seq.mean()
    return per_seq.sum() / global_batch
