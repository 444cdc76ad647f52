"""Greedy CTC decoding paths (port of ``speechcatcher_tpu/decode/greedy.py``).

Offline batch transcription: whole utterances through the training-mode
encoder (``encoder_forward_train``, kernel A or E in every layer) and the
vectorized greedy collapse, for when beam-search accuracy is not needed;
and a small host-side CTC prefix beam search over one utterance's
log-probabilities.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple

import numpy as np
import torch

from speechcatcher_tpu_torch.config import ModelConfig
from speechcatcher_tpu_torch.models.ctc import ctc_argmax, ctc_greedy_collapse
from speechcatcher_tpu_torch.models.encoder import encoder_forward_train


@torch.no_grad()
def _encode_and_collapse(params, feats: torch.Tensor, ilens: torch.Tensor,
                         cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens (B, T') left-packed, counts (B,)) of a feature batch."""
    enc_out, olens = encoder_forward_train(params["encoder"], feats, ilens,
                                           cfg)
    preds = ctc_argmax(params["ctc"], enc_out)
    return ctc_greedy_collapse(preds, olens, blank=cfg.blank_id)


@torch.no_grad()
def greedy_decode_batch(model, waveforms: List[np.ndarray],
                        rate: int = 16000) -> List[Tuple[str, List[int]]]:
    """N float32 waveforms → [(text, token_ids)], padded to a common length
    and decoded as one batch on the model's device."""
    assert rate == model.cfg.sample_rate
    max_len = max(len(w) for w in waveforms)
    batch = np.zeros((len(waveforms), max_len), np.float32)
    for i, w in enumerate(waveforms):
        batch[i, : len(w)] = w
    feats = model.frontend(batch)
    ilens = torch.tensor([model.frontend.n_frames(len(w)) for w in waveforms],
                         dtype=torch.int32, device=feats.device)
    tokens, counts = _encode_and_collapse(model.params, feats, ilens,
                                          model.cfg)
    tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
    out = []
    for i in range(len(waveforms)):
        ids = [int(t) for t in tokens[i, : counts[i]]]
        out.append((model.tokenizer.ids_to_text(ids), ids))
    return out


def ctc_prefix_beam_search_host(log_probs: np.ndarray, beam_size: int = 10,
                                blank: int = 0) -> List[int]:
    """CTC prefix beam search over one utterance's (T, V) log-probabilities,
    on the host (the production joint decoder is decode/beam_search.py)."""
    t_len, _ = log_probs.shape
    # beam: prefix -> (p_blank, p_nonblank) in log space
    NEG = -1e30

    def lse(a, b):
        m = max(a, b)
        if m <= NEG / 2:
            return NEG
        return m + np.log1p(np.exp(min(a, b) - m))

    beam = {(): (0.0, NEG)}
    for t in range(t_len):
        row = log_probs[t]
        top = np.argsort(-row)[: max(beam_size * 2, 8)]
        new = defaultdict(lambda: (NEG, NEG))
        for prefix, (pb, pnb) in beam.items():
            p_tot = lse(pb, pnb)
            b0, n0 = new[prefix]
            new[prefix] = (lse(b0, p_tot + row[blank]), n0)
            for c in top:
                c = int(c)
                if c == blank:
                    continue
                p_c = row[c]
                if prefix and prefix[-1] == c:
                    # The same symbol again: extending needs a blank between.
                    b0, n0 = new[prefix]
                    new[prefix] = (b0, lse(n0, pnb + p_c))
                    ext = prefix + (c,)
                    b1, n1 = new[ext]
                    new[ext] = (b1, lse(n1, pb + p_c))
                else:
                    ext = prefix + (c,)
                    b1, n1 = new[ext]
                    new[ext] = (b1, lse(n1, p_tot + p_c))
        ranked = sorted(new.items(), key=lambda kv: -lse(*kv[1]))
        beam = dict(ranked[:beam_size])
    best = max(beam.items(), key=lambda kv: lse(*kv[1]))[0]
    return list(best)
