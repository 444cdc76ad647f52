"""The traffic generator: deterministic by seed, the stated distributions,
the same work for every seed, and the due-time schedule."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness.traffic import Traffic, deck

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def spec(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["serve-rt64", "backlog256"])
def test_same_seed_same_traffic(name):
    s = spec(name)
    s["bank_size"] = 2
    a, b = Traffic(s, 3_000_000_019), Traffic(s, 3_000_000_019)
    for _ in range(5):
        ua, ub = a.utterance(), b.utterance()
        assert np.array_equal(ua.pcm, ub.pcm)
    assert np.array_equal(a.phases, b.phases)


@pytest.mark.parametrize("name", ["serve-rt64", "backlog256"])
def test_every_seed_offers_the_same_lengths(name):
    s = spec(name)
    s["bank_size"] = 2
    a, b = Traffic(s, 1), Traffic(s, 2**33 + 5)
    assert not np.array_equal(a.lengths, b.lengths)
    assert np.array_equal(np.sort(a.lengths), np.sort(b.lengths))


@pytest.mark.parametrize("name", ["serve-rt64", "backlog256"])
def test_lengths_follow_the_stated_distribution(name):
    dist = spec(name)["utterance_s"]
    v = deck(dist, spec(name)["deck_size"])
    assert v.min() >= dist["min"] and v.max() <= dist["max"]
    assert abs(np.median(v) - dist["median"]) < 0.02 * dist["median"]
    logs = np.log(v[(v > dist["min"]) & (v < dist["max"])])
    q1, q3 = np.quantile(logs, [0.25, 0.75])
    # The log-normal's quartiles lie 0.674 sigma either side of the median.
    assert abs((q3 - q1) / 2 / 0.6745 - dist["sigma"]) < 0.05


def test_pauses_are_uniform_in_their_range():
    p = deck(spec("serve-rt64")["pause_s"], 512)
    assert p.min() >= 0.3 and p.max() <= 1.5
    assert abs(p.mean() - 0.9) < 1e-3


def test_pieces_are_due_when_their_last_sample_is_spoken():
    s = spec("serve-rt64")
    s["bank_size"] = 1
    t = Traffic(s, 9)
    assert t.piece_due(10.0, 9000) == [10.25, 10.5, 10.5625]


def test_audio_is_int16_speech_like():
    s = spec("backlog256")
    s["bank_size"] = 1
    u = Traffic(s, 5).utterance()
    assert u.pcm.dtype == np.int16
    assert 2.0 * 16000 <= len(u.pcm) <= 20.0 * 16000
    assert 0.05 < np.abs(u.pcm / 32767.0).mean() < 0.5
