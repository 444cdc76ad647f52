"""The ``aishell-cb-conformer-lm`` configuration and its cell
``cb-conformer-lm.backlog256``: the cell resolves the reference
``cb_conformer_lm`` and reads the backlog's metrics and ``mfu.cbl``; its
weight layout loads into the port and the reference scores the port's
session final as served; the LM's FLOPs of a row by hand; ``mfu.cbl`` on a
hand-made record; and a tiny traced run of the conformer with an LM on the
CPU through ``program_trace.py``, correct, with the program's ``lm.rows``
among its counts."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell, weights
from benchmark.harness.traffic import speech_like
from benchmark.reference import cb_conformer_lm
from benchmark.roofline import lm_flops, peaks
from conftest import tiny_cell
from test_bench_cb_conformer import cbc_model, reader
from test_bench_reference import session_final

CELL = "cb-conformer-lm.backlog256"
LM = dict(lm_layers=2, lm_dim=16, lm_heads=2, lm_linear_units=32,
          lm_embed_dim=8, lm_weight=0.3)


def lm_model() -> dict:
    return dict(cbc_model(), **LM)


def test_the_cell_resolves_cb_conformer_lm():
    c = cell.load(CELL, 4_111_222_333, 1.0, False, 0.0)
    assert c.config["reference"] == "cb_conformer_lm"
    assert c.reference is cb_conformer_lm
    assert [m["name"] for m in c.per_layer] == [
        "engine.tick_ms.backlog", "gemm.share.backlog",
        "block_attention_roofline", "ctc_recursion_roofline",
        "device.idle.backlog", "mfu.cbl"]
    assert [m["name"] for m in c.end_to_end] == ["audio_rate", "setup_s"]
    # aishell-cb-conformer's model and the LM at the recipe's widths,
    # nothing cut.
    m = c.config["model"]
    base = cell.load("cb-conformer.backlog256", 1, 1.0, False, 0.0)
    assert {k: v for k, v in m.items() if not k.startswith("lm_")} == \
        base.config["model"]
    assert (m["lm_layers"], m["lm_dim"], m["lm_heads"], m["lm_linear_units"],
            m["lm_embed_dim"], m["lm_weight"]) == (16, 512, 8, 2048, 128, 0.3)
    assert c.config["reduced"] == []


@pytest.mark.parametrize("seconds,seed", [(1.3, 3), (3.3, 4_100_000_001)])
def test_the_layout_loads_into_the_port(seconds, seed):
    """The tree of ``weight_specs`` through ``ASRModel.from_numpy``: the
    reference scores the port's session final as served."""
    m = lm_model()
    tree = weights.make_tree(m, {"eos": 2.0, "blank": 6.0}, seed, "cpu",
                             cb_conformer_lm.weight_specs)
    assert tree["lm"]["layers"]["self_attn"]["linear_q"]["weight"].shape == (
        m["lm_layers"], m["lm_dim"], m["lm_dim"])
    assert bool(tree["lm"]["output_layer"]["bias"].abs().max() > 0)
    pcm = speech_like(seconds, np.random.default_rng(seed), 16000)
    chunks, yseq, xpos, score, _ = session_final(m, tree, pcm)
    ref = cb_conformer_lm.Reference(m, tree, "cpu")
    enc = ref.encode(chunks)
    r = ref.rescore(enc, ref.ctc_logp(enc), yseq, xpos, 3)
    assert len(yseq) > 2
    assert abs(r.score - score) < 1e-4
    assert r.token_gaps.max() < 1e-4


def test_the_lm_flops_of_a_row_by_hand():
    m = dict(lm_model(), lm_dim=512, lm_linear_units=2048, lm_embed_dim=128,
             lm_layers=16, vocab_size=4233)
    d, pos = 512, 9
    layer = 4 * (2 * d * d) + 2 * (2 * (pos + 1) * d) + 2 * (2 * d * 2048)
    want = 2 * 128 * d + 16 * layer + 2 * d * 4233
    assert lm_flops.lm_row_flops(m, pos) == want


def test_mfu_cbl_adds_the_lm_rows_that_stepped():
    read = reader("mfu.cbl")
    m = lm_model()
    block = {"stepping": [[1, 1, 0], [1, 0, 0], [1, 0, 0]],
             "olen": [[0, 3, 5], [1, 4, 5], [2, 4, 5]],
             "new_vis": [10, 20, 30], "beam": 2}
    rec = {"config": m, "window_s": 2.0, "audio_samples": 6400,
           "blocks": [block]}
    lm = 2 * sum(lm_flops.lm_row_flops(m, p) for p in (0, 3, 1, 2))
    want = (reader("mfu.cbc")(rec)
            + 100 * lm / 2.0 / peaks.FP32_FLOPS)
    assert read(rec) == pytest.approx(want, rel=1e-12)
    assert read(rec) > reader("mfu.cbc")(rec)
    # Without an LM, or without the step log, nothing to read.
    assert read(dict(rec, config=cbc_model())) is None
    assert read(dict(rec, blocks=[{"steps": 3}])) is None


def test_a_traced_run_reports_lm_rows(monkeypatch):
    """A tiny cell of the conformer with an LM through ``program_trace.run``
    on the CPU: correct, and the counts hold ``lm.rows``."""
    from benchmark import program_trace
    from benchmark.harness import trace

    def stop(self):
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    monkeypatch.setattr(trace.Trace, "_profile", staticmethod(
        lambda: torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])))
    monkeypatch.setattr(trace.Trace, "warm", lambda self: None)
    monkeypatch.setattr(trace.Trace, "stop", stop)
    c = tiny_cell("closed", seconds=2.0)
    c.config = dict(c.config, model=lm_model(), reference="cb_conformer_lm")
    c.reference = cell.reference("tiny", c.config)
    c.trace = True
    out = program_trace.run(c, True, device="cpu")
    assert out["correct"] and out["failed"] == 0
    assert out["counts"]["lm.rows"] > 0

