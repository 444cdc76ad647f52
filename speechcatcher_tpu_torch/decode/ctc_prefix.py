"""Streaming CTC prefix scorer (port of
``speechcatcher_tpu/decode/ctc_prefix.py``).

Candidate scores need no recursion: log_psi(h·c) = lse_t(phi[t-1] +
x_n[t, c]) plus the init term, all from the previous step's forward
variables. The O(T) forward recursion runs only for the B survivors, through
the ``ctc_forward_recursion_streams`` kernel.

Layout is time-minor: log-probs live as (S, V, Tcap), forward variables as
(S, B, 2, Tcap). LOGZERO = -1e10.

In place: ``ctc_extend`` appends into the log-prob ring in place (the
``ring_append_cols`` kernel). The ring is append-only, and beam snapshots
never hold it (their ring is empty). ``r`` and ``s`` are never written in
place: every function returns new tensors for them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
    LOGZERO,
    ctc_forward_recursion_streams,
)
from speechcatcher_tpu_torch.ops.kernels.ring_append import ring_append_cols


class CTCScorerState(NamedTuple):
    """Scorer state for a batch of streams."""

    logp: torch.Tensor     # (S, V, Tcap) CTC log-softmax outputs, time-minor
    enc_len: torch.Tensor  # (S,) int32 valid frames
    r: torch.Tensor        # (S, B, 2, Tcap) forward vars [non-blank, blank]
    s: torch.Tensor        # (S, B) prefix scores


def init_ctc_state(n_streams: int, beam: int, t_cap: int, vocab: int,
                   device: torch.device,
                   ring_dtype: torch.dtype = torch.float32,
                   empty_ring: bool = False) -> CTCScorerState:
    """Fresh scorer state; empty_ring=True gives an (S, 0, 0) log-prob ring
    (beam snapshots, slot resets), which allocates nothing."""
    ring_shape = (n_streams, 0, 0) if empty_ring else (n_streams, vocab, t_cap)
    return CTCScorerState(
        logp=torch.zeros(ring_shape, dtype=ring_dtype, device=device),
        enc_len=torch.zeros((n_streams,), dtype=torch.int32, device=device),
        r=torch.full((n_streams, beam, 2, t_cap), LOGZERO,
                     dtype=torch.float32, device=device),
        s=torch.zeros((n_streams, beam), dtype=torch.float32, device=device),
    )


def ctc_extend(state: CTCScorerState, new_logp: torch.Tensor,
               n_new: torch.Tensor) -> CTCScorerState:
    """Append up to Tnew frames (S, Tnew, V) per stream to the ring and
    continue the cumulative-blank recursion into them. n_new is (S,) int or
    bool (bool means all-or-none). Nothing here reads the card: the block
    loop's prologue graph captures it."""
    t_new = new_logp.shape[1]
    if n_new.dtype == torch.bool:
        n_new = torch.where(n_new, t_new, 0)
    n_new = n_new.to(torch.int32)
    old_len = state.enc_len
    # Non-finite frames must never enter the ring: NaN would propagate
    # through _fill_blank's cumulative sums.
    new_logp = torch.where(torch.isfinite(new_logp), new_logp, LOGZERO)
    # The kernel reads the time-major frames through the transposed view
    # and casts float32 into a bfloat16 ring itself: no copy in front.
    logp = ring_append_cols(state.logp, new_logp.transpose(1, 2), old_len,
                            n_new)
    new_len = old_len + n_new
    r = _fill_blank(logp, state.r, old_len, new_len)
    return CTCScorerState(logp=logp, enc_len=new_len, r=r, s=state.s)


def _fill_blank(logp: torch.Tensor, r: torch.Tensor, from_len: torch.Tensor,
                to_len: torch.Tensor) -> torch.Tensor:
    """New r with columns [from_len, to_len) per stream filled by the
    cumulative-blank continuation r_b[t] = r_b[t-1] + x_blank[t], r_n =
    LOGZERO."""
    t_cap = logp.shape[2]
    from_len = from_len.long()
    to_len = to_len.long()
    xb = logp[:, 0, :].float()                                  # (S, Tcap)
    t_idx = torch.arange(t_cap, device=logp.device)[None, :]
    in_new = (t_idx >= from_len[:, None]) & (t_idx < to_len[:, None])
    cxb = torch.cumsum(torch.where(t_idx < to_len[:, None], xb, 0.0), dim=1)
    prev = (from_len - 1).clamp(min=0)
    has_prev = from_len > 0
    base_cxb = torch.where(has_prev, cxb.gather(1, prev[:, None])[:, 0], 0.0)
    beam = r.shape[1]
    r_base = torch.where(
        has_prev[:, None],
        r[:, :, 1, :].gather(2, prev[:, None, None].expand(-1, beam, 1))[..., 0],
        0.0,
    )                                                           # (S, B)
    new_rb = r_base[:, :, None] + (cxb[:, None, :] - base_cxb[:, None, None])
    r1 = torch.where(in_new[:, None, :], new_rb, r[:, :, 1, :])
    r0 = torch.where(in_new[:, None, :], LOGZERO, r[:, :, 0, :])
    return torch.stack([r0, r1], dim=2)


def ctc_score_candidates(state: CTCScorerState, last_ids: torch.Tensor,
                         olen: torch.Tensor, cand_ids: torch.Tensor,
                         blank: int, eos: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate prefix scores without recursion.

    Returns (log_psi - s_prev with LOGZERO at non-candidates, log_psi), both
    (S, B, V)."""
    if blank == eos:
        # The blank column is overwritten after the EOS column is set: a
        # shared id would erase the EOS score.
        raise ValueError(f"blank ({blank}) must differ from eos ({eos})")
    s_dim, vocab, t_cap = state.logp.shape
    beam = state.r.shape[1]
    dev = state.logp.device
    t_idx = torch.arange(t_cap, device=dev)
    olen = olen.long()
    cand = cand_ids.long()

    r_sum = torch.logsumexp(state.r, dim=2)                     # (S, B, T)
    is_last = cand == last_ids.long()[:, :, None]               # (S, B, K)
    phi = torch.where(is_last[..., None], state.r[:, :, None, 1, :],
                      r_sum[:, :, None, :])                     # (S, B, K, T)
    s_idx = torch.arange(s_dim, device=dev)[:, None, None]
    xn_c = state.logp[s_idx, cand, :].float()                   # (S, B, K, T)

    start = olen.clamp(min=1).clamp(max=t_cap)
    end = state.enc_len.long()
    in_range = (t_idx[None, :] >= start[:, None]) & (t_idx[None, :] < end[:, None])
    phi_shift = torch.cat(
        [torch.full_like(phi[..., :1], LOGZERO), phi[..., :-1]], dim=-1)
    terms = torch.where(in_range[:, None, None, :], phi_shift + xn_c, LOGZERO)
    init_term = torch.where((olen == 0)[:, None, None], xn_c[..., 0], LOGZERO)
    log_psi_c = torch.logsumexp(
        torch.cat([terms, init_term[..., None]], dim=-1), dim=-1)  # (S, B, K)

    log_psi = torch.full((s_dim, beam, vocab), LOGZERO, dtype=torch.float32,
                         device=dev)
    log_psi.scatter_(2, cand, log_psi_c)
    end_frame = (end - 1).clamp(min=0)
    eos_score = r_sum.gather(2, end_frame[:, None, None].expand(-1, beam, 1))
    log_psi[:, :, eos] = eos_score[..., 0]
    log_psi[:, :, blank] = LOGZERO
    return log_psi - state.s[:, :, None], log_psi


def ctc_advance_state(state: CTCScorerState, log_psi: torch.Tensor,
                      src_idx: torch.Tensor, chosen: torch.Tensor,
                      cand_ids: torch.Tensor, last_ids: torch.Tensor,
                      olen: torch.Tensor) -> CTCScorerState:
    """Forward recursion for the B survivors (select_state semantics).

    A chosen token outside the candidate set (possible for EOS) takes
    candidate slot 0's forward variables, as the reference does. The
    returned ``r`` is a new tensor: ``state.r`` is never written in place."""
    s_dim, _, _, t_cap = state.r.shape
    dev = state.r.device
    src = src_idx.long()
    chosen = chosen.long()
    k = cand_ids.shape[2]

    r_src = state.r.gather(1, src[:, :, None, None].expand(-1, -1, 2, t_cap))
    last_src = last_ids.long().gather(1, src)
    cand_src = cand_ids.long().gather(1, src[:, :, None].expand(-1, -1, k))
    psi_src = log_psi.gather(
        1, src[:, :, None].expand(-1, -1, log_psi.shape[2]))
    s_new = psi_src.gather(2, chosen[:, :, None])[..., 0]

    in_cands = (cand_src == chosen[:, :, None]).any(dim=-1)
    token_r = torch.where(in_cands, chosen, cand_src[:, :, 0])

    r_sum = torch.logsumexp(r_src, dim=2)
    phi = torch.where((token_r == last_src)[:, :, None], r_src[:, :, 1, :],
                      r_sum)                                    # (S, B, T)
    s_idx = torch.arange(s_dim, device=dev)[:, None]
    xn = state.logp[s_idx, token_r, :]                          # (S, B, T)
    xb = state.logp[:, None, 0, :]                              # (S, 1, T)

    # One launch: the kernel reads the rows in the ring's dtype (it widens
    # bfloat16 itself), shifts phi, derives start and end from olen and
    # enc_len, and copies the frames from end on from r_src.
    r_new = ctc_forward_recursion_streams(xn, xb, phi, olen, state.enc_len,
                                          r_src)
    return CTCScorerState(logp=state.logp, enc_len=state.enc_len, r=r_new,
                          s=s_new)
