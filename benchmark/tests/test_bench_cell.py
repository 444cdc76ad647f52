"""A whole serving run on the CPU at tiny size, past the look for a chip:
the tiny cell comes out correct, and each fault a serving cell can have,
planted underneath the timed path, turns ``correct`` false."""

import numpy as np
import pytest
import torch

from benchmark.harness import check, serve, weights
from conftest import tiny_cell


def correct(out, cell) -> bool:
    return check.verdict(out["readings"], cell.checks)


@pytest.mark.parametrize("named", [None, "asr"],
                         ids=["default-reference", "named-asr"])
@pytest.mark.parametrize("loop", ["open", "closed"])
@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
def test_a_sound_run_is_correct(loop, encoder_type, named, monkeypatch):
    """A sound run is correct, and the configuration read the other way
    (naming ``"reference": "asr"`` or naming none) draws its own tree and
    reads the same sample bit for bit."""
    judged = []

    def judge(ref, served, cell):
        judged.append(list(served))
        return serve_judge(ref, served, cell)

    serve_judge = serve.judge
    monkeypatch.setattr(serve, "judge", judge)
    cell = tiny_cell(loop, encoder_type=encoder_type, reference=named)
    out = serve.run_cell(cell, device="cpu")
    assert out["failed"] == 0
    assert out["readings"]["tokens"] > 10
    assert correct(out, cell), out["readings"]
    other = tiny_cell(loop, encoder_type=encoder_type,
                      reference=None if named else "asr")
    assert other.reference is cell.reference
    m = other.config["model"]
    tree = weights.make_tree(m, other.config["emission_bias"],
                             other.config["weights_seed"], "cpu",
                             other.reference.weight_specs)
    again = serve_judge(other.reference.Reference(m, tree, "cpu"),
                        judged[0], other)
    assert again == out["readings"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from speechcatcher_tpu_torch.decode import beam_search

    def stuck(params, dec_pe, cross_kv, st, *args, **kwargs):
        return st._replace(stepping=torch.zeros_like(st.stepping))

    monkeypatch.setattr(beam_search, "block_step", stuck)
    cell = tiny_cell("closed")
    out = serve.run_cell(cell, device="cpu")
    assert not correct(out, cell)
    assert out["readings"]["tokens"] == 0


def test_half_of_the_batch_left_out(monkeypatch):
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    tick = StreamingEngine.tick

    def half(self, audio):
        keep = sorted(audio)[::2]
        return tick(self, {s: audio[s] for s in keep})

    monkeypatch.setattr(StreamingEngine, "tick", half)
    cell = tiny_cell("closed")
    out = serve.run_cell(cell, device="cpu")
    assert not correct(out, cell)
    assert out["readings"]["score_gap"] > cell.checks["limits"]["score_gap"]


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    finalize_batch = StreamingEngine.finalize_batch

    def altered(self, finals):
        out = finalize_batch(self, finals)
        for s, (yseq, xpos, score) in list(out.items()):
            yseq = yseq.copy()
            if len(yseq) > 2:
                yseq[1] = 1 + (int(yseq[1]) % (self.cfg.vocab_size - 2))
            out[s] = (yseq, xpos, score)
        return out

    monkeypatch.setattr(StreamingEngine, "finalize_batch", altered)
    cell = tiny_cell("open")
    out = serve.run_cell(cell, device="cpu")
    assert not correct(out, cell)
    assert out["readings"]["score_gap"] > 1e-3


def test_the_sample_holds_the_longest_and_follows_the_seed():
    class S:
        def __init__(self, n):
            self.utt = type("U", (), {"pcm": np.zeros(n)})()
            self.result = (np.zeros(2), np.zeros(2), 0.0)

    served = [S(n) for n in (5, 50, 7, 9, 11, 3)]
    a = check.sample(served, 3, 11)
    assert a[0] is served[1] and len(a) == 3
    assert [id(x) for x in check.sample(served, 3, 11)] == [id(x) for x in a]


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_the_control_in_the_programs_place_is_not_correct(loop):
    """The reference in TF32 (the precision below the configuration's
    float32) put in the program's place, judged by the check under the
    committed limits, is not correct; the program on the same sample is."""
    import json
    from pathlib import Path

    from benchmark.calibrate import controlled
    from benchmark.harness.traffic import Traffic

    cell = tiny_cell(loop, seconds=2.5)
    reference = cell.reference
    committed = json.loads((Path(check.__file__).resolve().parents[1]
                            / "checks" / "xl-transformer.serve-rt64.json")
                           .read_text())
    checks = dict(cell.checks, limits=committed["limits"])
    m = cell.config["model"]
    tree = weights.make_tree(m, cell.config["emission_bias"],
                             cell.config["weights_seed"], "cpu",
                             reference.weight_specs)
    system = serve.System(m, tree, cell.traffic, "cpu")
    out = serve.serve_window(system, Traffic(cell.traffic, cell.seed), cell)
    system.close()
    system.unwatch()
    ref = reference.Reference(m, tree, "cpu")
    spec = cell.traffic
    picked = check.sample(out["served"], checks["sample"], cell.seed)
    program = check.reference_readings(ref, picked, spec["chunk_samples"],
                                       spec["beam"])
    control = check.reference_readings(
        ref, controlled(ref, picked, spec["chunk_samples"], spec["beam"],
                        reference.in_tf32),
        spec["chunk_samples"], spec["beam"])
    assert check.verdict(program, checks), program
    assert control["tokens"] == program["tokens"] > 0
    assert not check.verdict(control, checks)
    assert control["score_gap"] > checks["limits"]["score_gap"]
