"""The latency and rate arithmetic: percentiles over all samples,
latencies timed from when the audio was due, rates over the window."""

import math

import pytest

from benchmark.harness import serve
from benchmark.harness.traffic import Utterance
from conftest import tiny_cell


def test_nearest_rank_takes_the_tail_of_all_samples():
    values = list(range(1, 101))
    assert serve.nearest_rank(values, 0.95) == 95
    assert serve.nearest_rank(values[::-1], 0.95) == 95
    assert serve.nearest_rank([7.0], 0.95) == 7.0
    assert serve.nearest_rank(list(range(1, 21)), 0.95) == 19
    assert math.isnan(serve.nearest_rank([], 0.95))


class _Engine:
    A = 8192


class _System:
    engine = _Engine()


def test_chunks_are_due_with_the_piece_that_completes_them():
    cell = tiny_cell()
    loop = serve.Loop(_System(), None, cell.traffic)

    class _Traffic:
        rate = 16000

        @staticmethod
        def piece_due(u0, n):
            return [u0 + min((k + 1) * 4000, n) / 16000
                    for k in range(math.ceil(n / 4000))]

        @staticmethod
        def pause(uid):
            return 0.5

    loop.tr = _Traffic()
    import numpy as np

    loop._schedule_talk(0, 100.0, Utterance(0, np.zeros(20000, np.int16)))
    opened = [e for e in loop.events if e[2] == "open"][0][3]
    # Chunk 0 ends at sample 8191, in piece 2 (due at 12000 samples);
    # chunk 1 at sample 16383, in piece 4, the last (20000 samples).
    assert opened.chunk_due == [100.75, 101.25]
    assert opened.due_eof == 101.25
    talk = [e for e in loop.events if e[2] == "talk"][0]
    assert talk[0] == pytest.approx(101.75)


def test_window_rates_and_latencies_on_the_cpu():
    cell = tiny_cell(seconds=2.5)
    from benchmark.harness import weights
    from benchmark.harness.traffic import Traffic

    m = cell.config["model"]
    tree = weights.make_tree(m, cell.config["emission_bias"],
                             cell.config["weights_seed"], "cpu",
                             cell.reference.weight_specs)
    system = serve.System(m, tree, cell.traffic, "cpu")
    out = serve.serve_window(system, Traffic(cell.traffic, cell.seed), cell)
    system.close()
    system.unwatch()
    rec = out["record"]
    assert out["counts"]["partials"] > 0 and out["attempted"] > 0
    assert out["failed"] == 0
    assert out["e2e"]["audio_rate"] == pytest.approx(
        rec["audio_samples"] / 16000 / rec["window_s"])
    # Open loop: a partial cannot come before its audio was due, and
    # real time bounds the audio a window can consume.
    assert out["e2e"]["partial_p95_ms"] > 0
    assert out["e2e"]["final_p95_ms"] > 0
    assert out["e2e"]["audio_rate"] < 4 * cell.traffic["speakers"]
