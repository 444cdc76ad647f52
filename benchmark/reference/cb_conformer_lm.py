"""Plain reference of ESPnet's streaming conformer decoded with its
Transformer language model by shallow fusion, as ESPnet's AISHELL-1 recipe
decodes it (``espnet2/bin/asr_inference_streaming.py`` adds the LM to the
blockwise synchronous beam search, ``espnet/nets/batch_beam_search_online.py``,
as a third full scorer weighted by ``lm_weight``), for the check that decides
``correct`` in the cells of a configuration that names
``"reference": "cb_conformer_lm"``.

The acoustic model is ``cb_conformer``'s, imported from it; this module adds
the LM, ``TransformerLM`` of ``espnet2/lm/transformer_lm.py`` with
``pos_enc: null``, as one full causal forward over a whole prefix::

    x = embed[y]                                 # (T, embed_unit), no scale
    x = ReLU(LayerNorm_1e-5(W_in x + b_in))      # the ``linear`` input layer
    for each of ``layer`` layers (pre-norm, LayerNorm eps 1e-12):
        x = x + MHA(LN1(x))                      # causal, keys y != 0
        x = x + W_2 ReLU(W_1 LN2(x) + b_1) + b_2
    logp = log_softmax(W_out LN_after(x) + b_out)

and ``rescore``, which adds ``lm_weight`` times the LM's log-probability of
each served token to its joint score and to the hypothesis' total, and takes
a token's candidates from the pre-beam over the full scorers' weighted sum
``(1 - ctc_weight)·dec + lm_weight·lm`` (ESPnet's ``pre_beam_score_key
"full"``), with EOS and the served token. The rest of the rule is
``asr.Reference.rescore``'s.

Float32 throughout, TF32 off: the harness turns both of torch's TF32
switches off before the reference judges (``harness.serve.run_cell``), and
the LM's products are matrix products alone (no convolution), which
PyTorch runs in TF32 only when asked; ``in_tf32`` is the control.

Departures from ESPnet, each what the served model computes too: no dropout
(inference); the keys' mask ``y != 0`` of ``TransformerLM._target_mask`` is
kept, though the CTC prefix scorer never lets the blank (id 0) into a
prefix; the LM's positions are the decoder's, the prefix with its leading
``<sos/eos>``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import asr
from benchmark.reference import cb_conformer
from benchmark.reference.asr import in_tf32  # noqa: F401  (the control)

# torch.nn.LayerNorm's default eps, that of the LM's input layer.
INPUT_NORM_EPS = 1e-5


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def weight_specs(m: Dict) -> Dict:
    """``cb_conformer.weight_specs`` and the LM's subtree ``lm``, in the
    layout the program loads it (layer leaves stacked on a leading axis,
    torch-layout (out, in) linear weights), at ESPnet's shapes and initial
    distributions: ``torch.nn.Embedding``'s standard normal embedding,
    ``torch.nn.Linear``'s uniform ±1/sqrt(fan_in) weights and biases
    (``TransformerLM`` initialises nothing itself), unit LayerNorms."""
    spec = cb_conformer.weight_specs(m)
    d, e, vocab = m["lm_dim"], m["lm_embed_dim"], m["vocab_size"]
    ll = (m["lm_layers"],)

    def lin(d_in, d_out, lead=()):
        bound = 1.0 / math.sqrt(d_in)
        return {"weight": ("u", lead + (d_out, d_in), bound),
                "bias": ("u", lead + (d_out,), bound)}

    def norm(lead=()):
        return {"weight": ("1", lead + (d,)), "bias": ("0", lead + (d,))}

    spec["lm"] = {
        "embed": {"weight": ("n", (vocab, e))},
        "input_layer": {"out": lin(e, d), "norm": norm()},
        "layers": {
            "self_attn": {k: lin(d, d, ll) for k in (
                "linear_q", "linear_k", "linear_v", "linear_out")},
            "feed_forward": {"w_1": lin(d, m["lm_linear_units"], ll),
                             "w_2": lin(m["lm_linear_units"], d, ll)},
            "norm1": norm(ll), "norm2": norm(ll)},
        "after_norm": norm(),
        "output_layer": lin(d, vocab),
    }
    return spec


# ---------------------------------------------------------------------------
# The language model
# ---------------------------------------------------------------------------

class LanguageModel:
    """ESPnet's ``TransformerLM`` over the ``lm`` subtree."""

    def __init__(self, p, heads: int):
        self.p = p
        self.heads = heads

    @torch.no_grad()
    def logp(self, ys: Sequence[int]) -> torch.Tensor:
        """(T, vocab) log-probabilities of the token after each prefix
        ys[:t + 1]: one causal forward over the whole sequence."""
        p = self.p
        dev = p["embed"]["weight"].device
        y = torch.as_tensor(np.asarray(ys, np.int64), device=dev)
        t = y.shape[0]
        x = p["embed"]["weight"][y][None]                     # (1, T, e)
        h = asr._lin(p["input_layer"]["out"], None, x)
        norm = p["input_layer"]["norm"]
        x = torch.relu(F.layer_norm(h, (h.shape[-1],), norm["weight"],
                                    norm["bias"], INPUT_NORM_EPS))
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))
        keep = causal & (y != 0)[None, :]
        pl = p["layers"]
        for i in range(pl["norm1"]["weight"].shape[0]):
            hn = asr._ln(pl["norm1"], i, x)
            x = x + asr._mha(pl["self_attn"], i, hn, hn, keep, self.heads)
            x = x + asr._ffn(pl["feed_forward"], i, asr._ln(pl["norm2"], i, x))
        x = asr._ln(p["after_norm"], None, x)
        return torch.log_softmax(asr._lin(p["output_layer"], None, x)[0],
                                 dim=-1)


# ---------------------------------------------------------------------------
# The served hypothesis, rescored with the LM
# ---------------------------------------------------------------------------

class Reference(cb_conformer.Reference):
    """``cb_conformer.Reference`` with the LM fused into ``rescore``."""

    def __init__(self, model_cfg: Dict, tree, device):
        super().__init__(model_cfg, tree, device)
        self.lm = LanguageModel(tree["lm"], model_cfg["lm_heads"])
        self.lm_weight = float(model_cfg["lm_weight"])

    @torch.no_grad()
    def decoder_logp(self, enc: torch.Tensor, yseq: Sequence[int],
                     xpos: Sequence[int]) -> List[np.ndarray]:
        """The decoder's log-probabilities (float64, vocab) after each
        prefix yseq[:j], j >= 1, over the frames visible when yseq[j] was
        chosen: ``asr.Reference.rescore``'s decoder, step by step."""
        g = self.g
        p = self.tree["decoder"]
        pl = p["layers"]
        mem_k = [asr._heads(asr._lin(pl["src_attn"]["linear_k"], i,
                                     enc[None]), g.dec_heads)
                 for i in range(g.dec_layers)]
        mem_v = [asr._heads(asr._lin(pl["src_attn"]["linear_v"], i,
                                     enc[None]), g.dec_heads)
                 for i in range(g.dec_layers)]
        cache: List[List[torch.Tensor]] = [[] for _ in range(g.dec_layers)]
        out = []
        for j in range(1, len(yseq)):
            vis = int(xpos[j]) + 1
            h = p["embed"]["weight"][int(yseq[j - 1])][None, None] \
                * math.sqrt(g.d) + self.dec_pe[j - 1][None, None]
            for i in range(g.dec_layers):
                hn = asr._ln(pl["norm1"], i, h)
                cache[i].append(hn)
                hist = torch.cat(cache[i], dim=1)
                h = h + asr._mha(pl["self_attn"], i, hn, hist, None,
                                 g.dec_heads)
                hn = asr._ln(pl["norm2"], i, h)
                q = asr._heads(asr._lin(pl["src_attn"]["linear_q"], i, hn),
                               g.dec_heads)
                att = torch.softmax(
                    asr._mm(q, mem_k[i][:, :, :vis].transpose(-1, -2))
                    / math.sqrt(q.shape[-1]), dim=-1)
                att = asr._mm(att, mem_v[i][:, :, :vis]).transpose(
                    1, 2).reshape(1, 1, g.d)
                h = h + asr._lin(pl["src_attn"]["linear_out"], i, att)
                h = h + asr._ffn(pl["feed_forward"], i,
                                 asr._ln(pl["norm3"], i, h))
            h = asr._ln(p["after_norm"], None, h)
            out.append(torch.log_softmax(
                asr._lin(p["output_layer"], None, h)[0, 0],
                dim=-1).double().cpu().numpy())
        return out

    @torch.no_grad()
    def rescore(self, enc: torch.Tensor, x_ctc: np.ndarray,
                yseq: Sequence[int], xpos: Sequence[int],
                beam: int) -> asr.Rescored:
        g = self.g
        w, lam = g.ctc_weight, self.lm_weight
        decs = self.decoder_logp(enc, yseq, xpos)
        lms = self.lm.logp(list(yseq[:-1])).double().cpu().numpy()
        ctc = asr.CTCPrefix(x_ctc, g.blank)
        r = ctc.root()
        psi_prev = 0.0
        total_dec = total_lm = 0.0
        gaps = []
        for j in range(1, len(yseq)):
            tok, last = int(yseq[j]), int(yseq[j - 1])
            vis = int(xpos[j]) + 1
            dec, lm = decs[j - 1], lms[j - 1]
            full = (1.0 - w) * dec + lam * lm
            # Candidates: the pre-beam by the full scorers' weighted sum
            # (stable, lower id on ties), EOS (always scored) and the served
            # token; not blank.
            order = np.argsort(-full, kind="stable")[:min(g.pre_beam,
                                                          g.vocab)]
            cands = np.unique(np.concatenate([order, [g.eos, tok]]))
            cands = cands[cands != g.blank]
            olen = j - 1
            rn, rb = ctc.extended(r, vis)
            non_eos = cands[cands != g.eos]
            psi = dict(zip(non_eos.tolist(),
                           ctc.psi_many(rn, rb, non_eos, last, olen,
                                        vis).tolist()))
            psi[g.eos] = ctc.psi(rn, rb, g.eos, last, olen, vis, g.eos)
            joint = np.array([full[c] + w * (psi[c] - psi_prev)
                              for c in cands.tolist()])
            own = full[tok] + w * (psi[tok] - psi_prev)
            thr = np.sort(joint)[::-1][min(beam, len(joint)) - 1]
            gaps.append(max(0.0, float(thr - own)))
            total_dec += float(dec[tok])
            total_lm += float(lm[tok])
            col = tok if (tok != g.eos or g.eos in order) else int(order[0])
            r = ctc.advance(r, col, last, olen, vis)
            psi_prev = psi[tok]
        score = (1.0 - w) * total_dec + w * psi_prev + lam * total_lm
        return asr.Rescored(float(score), np.asarray(gaps, np.float64))
