"""The one traffic generator: utterances and their arrival schedule from a
traffic file's parameters and ``--seed``.

Every seed gets the same set of utterance lengths and pauses (a deck of the
distribution's quantiles, so the work a run offers does not move with the
seed), dealt in the seed's order; the seed draws the audio, the order and
the phases. Audio is speech-like: a 3 Hz amplitude-modulated tone, its pitch
drawn from the seed, in white noise, as 16 kHz int16 PCM (the server's wire
format). Utterances are slices of a bank of such recordings made once in
set-up.

Two loops, by the file's ``loop``:

- ``open``: ``speakers`` real-time talkers. Each sends an utterance in
  ``piece_samples`` pieces on a fixed schedule (a piece is due when its last
  sample has been spoken), eof with the last piece, pauses, then opens a new
  session for the next utterance, whatever the server does. Each talker
  starts at a random phase of its first utterance-and-pause cycle.
- ``closed``: ``pool_size`` sessions, each holding a whole utterance staged
  before its first tick (an upload, then eof); a session whose final returns
  is replaced at once by a new one with the next utterance. The first
  utterances start at a random phase, so finals do not arrive together.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

SEED_MASK = (1 << 63) - 1


def deck(dist: Dict, n: int) -> np.ndarray:
    """n values at the quantiles (i + 0.5) / n of a log-normal (median,
    sigma) clipped to [min, max], or a uniform [min, max] without sigma."""
    q = (np.arange(n) + 0.5) / n
    if "sigma" in dist:
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in q])
        v = dist["median"] * np.exp(dist["sigma"] * z)
    else:
        v = dist["min"] + q * (dist["max"] - dist["min"])
    return np.clip(v, dist["min"], dist["max"])


def speech_like(seconds: float, rng: np.random.Generator,
                rate: int) -> np.ndarray:
    t = np.arange(int(seconds * rate)) / rate
    f0 = 180.0 + 120.0 * rng.random()
    tone = 0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(2 * np.pi
                                                                 * 3 * t))
    x = tone + 0.05 * rng.standard_normal(len(t))
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)


@dataclass
class Utterance:
    uid: int
    pcm: np.ndarray        # int16 samples


class Traffic:
    def __init__(self, spec: Dict, seed: int, rate: int = 16000):
        self.spec = spec
        self.rate = rate
        self.rng = np.random.default_rng(int(seed) & SEED_MASK)
        n = spec["deck_size"]
        self.lengths = deck(spec["utterance_s"], n)[self.rng.permutation(n)]
        self.pauses = (deck(spec["pause_s"], n)[self.rng.permutation(n)]
                       if "pause_s" in spec else np.zeros(n))
        longest = float(spec["utterance_s"]["max"])
        self.bank = [speech_like(longest, self.rng, rate)
                     for _ in range(spec["bank_size"])]
        self.offsets = self.rng.random(n)
        self.phases = self.rng.random(max(spec.get("speakers", 0),
                                          spec["pool_size"]))
        self._next = 0

    def utterance(self, truncate: float = 0.0) -> Utterance:
        """The next utterance of the deck; `truncate` ∈ [0, 1) drops that
        share of its start (a talker met mid-utterance)."""
        k = self._next
        self._next += 1
        i = k % len(self.lengths)
        n = int(round(self.lengths[i] * self.rate))
        src = self.bank[k % len(self.bank)]
        start = int(self.offsets[i] * (len(src) - n))
        pcm = src[start:start + n]
        cut = int(truncate * n)
        return Utterance(k, pcm[cut:])

    def pause(self, k: int) -> float:
        return float(self.pauses[k % len(self.pauses)])

    def piece_due(self, u0: float, n_samples: int) -> List[float]:
        """Due times of an utterance's pieces sent from u0 on."""
        p = self.spec["piece_samples"]
        n_pieces = max(1, math.ceil(n_samples / p))
        return [u0 + min((k + 1) * p, n_samples) / self.rate
                for k in range(n_pieces)]
