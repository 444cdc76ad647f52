"""The comparison that decides ``correct`` for the serving cells.

After the window has closed and the program's state is freed, a sample of
the utterances whose finals came back in the window, drawn from the seed
with the longest among them, is recomputed by the plain reference from the
same audio, cut into the chunks the server fed (the wire's int16 chunks,
then the staged tail), and the same weights. For each, the configuration's
reference (``Reference.rescore`` of the module ``Cell.reference``,
``benchmark/reference/<name>.py``) scores the served hypothesis.

Numbers compared, each against its limit from ``benchmark/checks/<cell>``:

- ``score_gap``: the widest gap, per token, between a served final's score
  and the reference's score of the same tokens at the same encoder
  positions (a score is a sum over the tokens, so its rounding grows with
  their number);
- ``rank_gap``: the widest amount by which a served token's joint score lies
  below the ``beam``-th best joint score of its prefix's candidates (0 for a
  token that the search could have kept);
- ``tokens``: the tokens the sample served, at least ``min_tokens`` (a
  search that stops stepping serves none).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

WIRE_SCALE = np.float32(1.0 / 32767.0)


def chunks_of(pcm: np.ndarray, tail: int, chunk: int) -> List[np.ndarray]:
    """The audio as the engine heard it: full chunks through the int16
    wire (divided by 32767 on the card), then the tail as staged (times the
    staging ring's float32 1/32767). None when `tail` does not fit."""
    n_full = len(pcm) - tail
    if tail < 0 or n_full < 0 or n_full % chunk:
        return None
    out = [pcm[i:i + chunk].astype(np.float32) / np.float32(32767.0)
           for i in range(0, n_full, chunk)]
    out.append(pcm[n_full:].astype(np.float32) * WIRE_SCALE)
    return out


def sample(served: Sequence, k: int, seed: int) -> List:
    """The longest served utterance and k - 1 others drawn from the seed."""
    done = [sv for sv in served if sv.result is not None]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].utt.pcm))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng((int(seed) * 7919 + 17) & ((1 << 63) - 1))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def reference_readings(ref, picked: Sequence, chunk: int, beam: int
                       ) -> Dict:
    """The reference's readings of the served finals in `picked`."""
    score_gap = rank_gap = 0.0
    tokens = 0
    for sv in picked:
        yseq, xpos, score = sv.result
        chunks = chunks_of(sv.utt.pcm, sv.tail, chunk)
        enc = ref.encode(chunks) if chunks is not None else None
        if (enc is None or not math.isfinite(score)
                or (len(xpos) > 1 and int(np.max(xpos[1:])) >= enc.shape[0])):
            score_gap = rank_gap = float("inf")
            continue
        n = len(yseq) - 1
        tokens += n
        if n < 1:
            continue
        r = ref.rescore(enc, ref.ctc_logp(enc), yseq, xpos, beam)
        score_gap = max(score_gap, abs(float(score) - r.score) / n)
        rank_gap = max(rank_gap, float(r.token_gaps.max()))
    return {"score_gap": score_gap, "rank_gap": rank_gap, "tokens": tokens,
            "utterances": len(picked)}


def verdict(readings: Dict, checks: Dict) -> bool:
    """Every number within its limit, and a sample of enough tokens."""
    return (readings["utterances"] > 0
            and readings["tokens"] >= checks["min_tokens"]
            and all(readings[k] <= v for k, v in checks["limits"].items()))


def compared(readings: Dict, checks: Dict) -> Dict:
    """Each number compared beside its limit, in the result's last key."""
    out = {k: {"value": readings[k], "limit": v}
           for k, v in checks["limits"].items()}
    out["tokens"] = {"value": readings["tokens"],
                     "limit": checks["min_tokens"]}
    return out


def report_lines(readings: Dict, checks: Dict) -> List[str]:
    lines = [f"{k} {readings[k]!r} limit {v!r}"
             for k, v in checks["limits"].items()]
    lines.append(f"tokens {readings['tokens']} limit at least "
                 f"{checks['min_tokens']}")
    return lines
