"""The port's tracer (``utils.metrics.TRACER``) on the CPU at ``tiny_config``.

A ``SessionManager`` run: three sessions ticked together, then finalized in
one compact batch of three slots (four rows) beside a sub-block session that
takes ``finalize``. The block loops run their graphed route, with each
"graph" replaying its own program eagerly (the CPU has no CUDA graphs), so
that the host's wait on ``any(stepping)`` is there to trace. Off, the tracer
records nothing and reads no clock; on, the run's outputs are the same, and
its spans nest as the serving path does and its counters match the run.
Then the owners of a hand-made profiler trace
(``benchmark.harness.owners``) and the per-layer values read from a
hand-made record.
"""

import json
import threading
import time
import types
from collections import Counter

import numpy as np
import pytest
import torch

from benchmark.harness import owners
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.decode import beam_search as bs
from speechcatcher_tpu_torch.decode import graphs
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.serve.engine import StreamingEngine
from speechcatcher_tpu_torch.serve.server import SessionManager
from speechcatcher_tpu_torch.synth import synth_audio
from speechcatcher_tpu_torch.utils import metrics
from speechcatcher_tpu_torch.utils.metrics import TRACER, Tracer

CFG = tiny_config()
CHUNK = 8192
TREE = random_params(CFG, 2)
# The same with a fused LM (``models.lm``).
LM_CFG = tiny_config(lm_layers=2, lm_dim=16, lm_heads=2, lm_linear_units=32,
                     lm_embed_dim=8, lm_weight=0.3)
LM_TREE = random_params(LM_CFG, 2)

# Each span of the serving path and the spans it may lie in.
PARENTS = {
    "serve.tick": {None},
    "serve.stage": {"serve.tick"},
    "engine.tick": {"serve.tick"},
    "engine.tick.readback": {"engine.tick"},
    "engine.tick.plan": {"engine.tick"},
    "engine.tick.encode": {"engine.tick"},
    "beam.block": {"engine.tick", "engine.final.drain",
                   "engine.final.fallback"},
    "beam.sync": {"beam.block"},
    "serve.partials": {"serve.tick"},
    "engine.finalize_batch": {"serve.tick"},
    "engine.final.plan": {"engine.finalize_batch"},
    "engine.final.extract": {"engine.finalize_batch"},
    "engine.final.encode": {"engine.finalize_batch"},
    "engine.final.drain": {"engine.finalize_batch"},
    "engine.final.readback": {"engine.finalize_batch"},
    "engine.final.reset": {"engine.finalize_batch"},
    "engine.final.fallback": {"engine.finalize_batch"},
    "serve.finals": {"serve.tick"},
}


def pcm16(seconds: float, seed: int) -> bytes:
    a = synth_audio(seconds, seed)
    return (np.clip(a, -1, 1) * 32000).astype(np.int16).tobytes()


class _Replay:
    def __init__(self, program):
        self.program = program

    def replay(self):
        self.program()


def graphed_on_cpu(mp) -> list:
    """Every BlockLoop made from now on takes its graphed route, each graph
    replaying its program eagerly; returns the loops made."""
    made = []
    init = graphs.BlockLoop.__init__

    def graphed_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.graphed = True
        made.append(self)

    def capture(self):
        if self._graphs is None:
            flag = torch.zeros(2, dtype=torch.int32)
            held = {}
            self._graphs = [
                _Replay(lambda: self._prologue(self.state, self.stepping0,
                                               held)),
                _Replay(lambda: self._step(self.state, held["cross_kv"],
                                           flag)),
                _Replay(lambda: self._epilogue(self.state, self.stepping0))]
            self._flag = types.SimpleNamespace(read=flag.tolist)
        return self._graphs

    mp.setattr(graphs.BlockLoop, "__init__", graphed_init)
    mp.setattr(graphs.BlockLoop, "capture", capture)
    return made


def serve(long_seconds=(2.0, 2.0, 2.0), short_seconds=0.25, cfg=CFG,
          tree=TREE):
    """The long sessions ticked while they hold a chunk, then every
    session's final in one tick; returns every tick's messages."""
    engine = StreamingEngine(ASRModel.from_numpy(cfg, tree, device="cpu"),
                             n_slots=len(long_seconds) + 1, beam_size=2,
                             chunk_samples=CHUNK, device="cpu")
    mgr = SessionManager(engine)
    sids = [mgr.open_session() for _ in range(len(long_seconds) + 1)]
    for k, (sid, sec) in enumerate(zip(sids, long_seconds)):
        mgr.feed(sid, pcm16(sec, k + 1))
    mgr.feed(sids[-1], pcm16(short_seconds, 9))
    log = []
    while any(mgr.sessions[s].staged.available() >= CHUNK for s in sids):
        log.append(mgr.tick())
    for sid in sids:
        mgr.request_final(sid)
    log.append(mgr.tick())
    return log


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        made = graphed_on_cpu(mp)
        TRACER.reset()
        with pytest.MonkeyPatch.context() as clock:
            def no_clock():
                raise AssertionError("a span read the clock while off")

            clock.setattr(metrics, "time", types.SimpleNamespace(
                perf_counter_ns=no_clock, perf_counter=time.perf_counter))
            off = serve()
        off_export = TRACER.export()
        del made[:]
        TRACER.start()
        try:
            on = serve()
        finally:
            TRACER.stop()
        export = TRACER.export()
        TRACER.reset()
        return {"off": off, "off_export": off_export, "on": on,
                "export": export, "loops": list(made)}


def test_off_records_nothing_and_on_serves_the_same(runs):
    assert runs["off_export"] == {"spans": [], "counts": {}}
    assert runs["on"] == runs["off"]
    finals = [m for tick in runs["on"] for m in tick.values()
              if "result" in m]
    assert len(finals) == 4
    assert any(m["result"] for m in finals)


def test_every_span_nests_inside_its_parent(runs):
    spans = runs["export"]["spans"]
    assert {s[0] for s in spans} == set(PARENTS)
    for name, t0, t1, parent, tick in spans:
        assert t1 is not None and t0 <= t1
        p = None if parent is None else spans[parent]
        assert (None if p is None else p[0]) in PARENTS[name], name
        if p is not None:
            assert p[1] <= t0 and t1 <= p[2]
            assert p[4] == tick
    ticks = [s for s in spans if s[0] == "serve.tick"]
    assert len({s[4] for s in ticks}) == len(ticks) == len(runs["on"])


def test_beam_counters_follow_the_loops(runs):
    loops = runs["loops"]
    names = Counter(s[0] for s in runs["export"]["spans"])
    assert names["beam.sync"] == sum(lp.syncs for lp in loops) > 0
    assert names["beam.block"] == sum(lp.blocks for lp in loops) > 0


def test_final_counters_match_the_batch(runs):
    counts = runs["export"]["counts"]
    # Three slots at compact width four, the sub-block session alone.
    assert counts["engine.final.slots"] == 3
    assert counts["engine.final.rows"] == 4
    assert counts["engine.final.fallbacks"] == 1
    # No LM, no LM rows.
    assert "lm.rows" not in counts


def lm_steps_seen(mp) -> list:
    """The rows (width x beam) of every LM step the beam steps run."""
    seen = []
    step = bs.lm_step

    def counted(params, cache, tokens, *args):
        seen.append(tokens.shape[0])
        return step(params, cache, tokens, *args)

    mp.setattr(bs, "lm_step", counted)
    return seen


def test_lm_rows_count_width_times_beam_each_step(monkeypatch):
    """``lm.rows`` adds each step replay's width x beam, on the graphed
    route of the tick, the compact finals and the fallback."""
    made = graphed_on_cpu(monkeypatch)
    seen = lm_steps_seen(monkeypatch)
    TRACER.reset()
    TRACER.start()
    try:
        serve(cfg=LM_CFG, tree=LM_TREE)
    finally:
        TRACER.stop()
    counts = TRACER.export()["counts"]
    TRACER.reset()
    assert counts["lm.rows"] == sum(seen) > 0
    assert counts["lm.rows"] == sum(lp.syncs * lp.lm_rows
                                    for lp in made)
    assert len(set(seen)) > 1    # the tick's width and compact ones


def test_cross_rows_count_the_rows_each_step_attends(monkeypatch):
    """``cross.rows`` adds, each step replay, the K/V rows a layer's
    cross-attention reads (every stream's visible frames, capped at the
    ring), and ``cross.ring_rows`` the ring's S x T: the same sums as the
    cross-attention's own operands, one call a layer, on the graphed route
    of the tick, the compact finals and the fallback."""
    from speechcatcher_tpu_torch.models import decoder as dec

    made = graphed_on_cpu(monkeypatch)
    seen = []
    attend = dec.cross_attention

    def counted(q, mk, mv, enc_len):
        seen.append((int(enc_len.clamp(max=mk.shape[2]).sum()),
                     mk.shape[0] * mk.shape[2]))
        return attend(q, mk, mv, enc_len)

    monkeypatch.setattr(dec, "cross_attention", counted)
    TRACER.reset()
    TRACER.start()
    try:
        serve()
    finally:
        TRACER.stop()
    counts = TRACER.export()["counts"]
    TRACER.reset()
    layers = CFG.decoder_layers
    assert len(seen) % layers == 0
    assert counts["cross.rows"] * layers == sum(r for r, _ in seen) > 0
    assert counts["cross.ring_rows"] * layers == sum(t for _, t in seen)
    assert 0 < counts["cross.rows"] < counts["cross.ring_rows"]
    assert counts["cross.ring_rows"] == sum(
        lp.syncs * lp.cross_ring_rows for lp in made)


def test_lm_step_is_a_range_in_an_eager_trace(monkeypatch):
    """The eager route's LM steps are ``lm.step`` ranges of the profiler's
    trace, one a step; the tracer's spans stay its own."""
    seen = lm_steps_seen(monkeypatch)
    TRACER.reset()
    TRACER.start()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            serve(long_seconds=(1.2,), short_seconds=0.2, cfg=LM_CFG,
                  tree=LM_TREE)
    finally:
        TRACER.stop()
    spans = {s[0] for s in TRACER.export()["spans"]}
    TRACER.reset()
    names = Counter(e.name for e in prof.events())
    assert names["lm.step"] == len(seen) > 0
    assert "lm.step" not in spans


def test_spans_are_profiler_annotations(tmp_path):
    TRACER.reset()
    TRACER.start()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            serve(long_seconds=(1.2,), short_seconds=0.2)
    finally:
        TRACER.stop()
    spans = Counter(s[0] for s in TRACER.export()["spans"])
    TRACER.reset()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotations = Counter(e["name"] for e in events
                          if e.get("cat") == "user_annotation")
    assert spans["serve.tick"] > 0 and spans["engine.final.fallback"] > 0
    assert annotations == spans
    assert "lm.step" not in annotations


def test_off_reads_no_clock_and_counts_nothing(monkeypatch):
    tr = Tracer()

    def no_clock():
        raise AssertionError("read the clock")

    monkeypatch.setattr(metrics, "time", types.SimpleNamespace(
        perf_counter_ns=no_clock))
    with tr.span("a"):
        with tr.span("b"):
            tr.count("c", 3)
    assert tr.span("a") is tr.span("b")
    assert tr.export() == {"spans": [], "counts": {}}


def test_past_the_cap_spans_are_dropped_and_counted():
    tr = Tracer(cap=2)
    tr.start()
    with tr.span("a"):
        with tr.span("b"):
            with tr.span("c"):
                pass
    out = tr.export()
    assert [s[0] for s in out["spans"]] == ["a", "b"]
    assert out["spans"][1][3] == 0
    assert out["counts"] == {"tracing.dropped": 1}


def test_a_span_with_none_open_around_it_starts_a_tick():
    tr = Tracer()
    tr.start()
    with tr.span("t"):
        with tr.span("u"):
            pass
        other = threading.Thread(target=lambda: tr.span("v").__enter__())
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    with tr.span("t"):
        pass
    spans = {(s[0], s[4]): s for s in tr.export()["spans"]}
    assert set(spans) == {("t", 0), ("u", 0), ("v", 1), ("t", 2)}
    assert spans[("u", 0)][3] == 0 and spans[("v", 1)][3] is None
    assert spans[("v", 1)][2] is None   # still open in its thread


# -- owners of a traced slice --------------------------------------------------

def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_owners_by_correlation_and_gaps_split_at_spans():
    ann = "user_annotation"
    events = [
        _x(ann, "serve.tick", 0, 100),   # the harness's range
        _x(ann, "serve.tick", 1, 98),    # the program's span
        _x(ann, "engine.tick", 10, 30),
        _x(ann, "engine.finalize_batch", 50, 45),
        _x(ann, "beam.sync", 60, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _x("cuda_runtime", "cudaGraphLaunch", 55, 1, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 97, 0.2, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, tid=2, corr=4),
        _x("kernel", "gemm", 15, 20, tid=7, corr=1),
        _x("kernel", "step_a", 56, 2, tid=7, corr=2),
        _x("kernel", "step_b", 72, 8, tid=7, corr=2),
        _x("gpu_memcpy", "copy", 97.5, 1.5, tid=7, corr=3),
        _x("kernel", "other", 36, 2, tid=7, corr=4),
    ]
    out = owners.attribute(events)
    fin = "serve.tick/engine.finalize_batch"
    want_dev = {"serve.tick/engine.tick": 20, fin: 10, "serve.tick": 1.5,
                owners.NO_SPAN: 2}
    assert out["device_by_span"] == pytest.approx(
        {k: v * 1e-6 for k, v in want_dev.items()})
    want_idle = {"serve.tick/engine.tick": 3, "serve.tick": 12.5,
                 fin: 25, fin + "/beam.sync": 10}
    assert out["idle_by_span"] == pytest.approx(
        {k: v * 1e-6 for k, v in want_idle.items()})
    longest, parts = out["gaps"][0]
    assert longest == pytest.approx(18e-6)
    assert [p for p, _ in parts] == ["serve.tick", fin,
                                     "serve.tick/engine.tick"]
    assert [s for _, s in parts] == pytest.approx([10e-6, 6e-6, 2e-6])
    assert out["by_kernel"]["step_b"] == pytest.approx({fin: 8e-6})
    assert out["events_by_span"] == {"serve.tick/engine.tick": 1, fin: 2,
                                     "serve.tick": 1, owners.NO_SPAN: 1}
    # Every gap here is under 50 µs; under 5 µs only [35, 36).
    assert out["short_idle_by_span"] == out["idle_by_span"]
    short = owners.attribute(events, short_us=5)["short_idle_by_span"]
    assert short == pytest.approx({"serve.tick/engine.tick": 1e-6})


def _record():
    ms = 1_000_000
    spans = [
        ["engine.finalize_batch", 100 * ms, 130 * ms, None, 0],
        ["engine.final.extract", 101 * ms, 104 * ms, 0, 0],
        ["engine.final.drain", 105 * ms, 125 * ms, 0, 0],
        ["engine.final.encode", 104 * ms, 105 * ms, 0, 0],
        ["beam.sync", 110 * ms, 112 * ms, 2, 0],
        ["beam.sync", 115 * ms, 119 * ms, 2, 0],
        ["engine.finalize_batch", 500 * ms, 510 * ms, None, 1],
    ]
    fin = "serve.tick/engine.finalize_batch"
    return {
        "program": {"spans": spans, "counts": {
            "engine.final.fallbacks": 1, "engine.final.slots": 3,
            "engine.final.rows": 4}},
        "trace": {"t0": 0.0, "t1": 1.0,
                  "device_by_span": {fin + "/engine.final.encode": 0.004,
                                     fin + "/engine.final.extract": 0.001,
                                     fin + "/engine.final.reset": 0.0005,
                                     "serve.tick/engine.tick": 0.01},
                  "idle_by_span": {fin: 0.006,
                                   fin + "/engine.final.drain/beam.block"
                                   "/beam.sync": 0.002,
                                   "serve.tick": 0.05}},
    }


@pytest.mark.parametrize("name,value", [
    ("final.drain_ms.rt", 10.0),
    ("final.idle_ms.rt", 4.0),
    ("beam.sync_wait_ms.rt", 3.0),
    ("final.fallback_share.rt", 25.0),
    ("final.drain_ms.backlog", 10.0),
    ("final.encode_dev_ms.backlog", 4.0),
    ("final.state_dev_ms.backlog", 1.5),
    ("final.pad_share.backlog", 25.0),
])
def test_readings_of_a_record(name, value):
    read = owners.READINGS[name]
    assert read(_record()) == pytest.approx(value)
    assert read({"spans": {}, "trace": None}) is None
    bare = _record()
    bare["program"] = {"spans": [], "counts": {}}
    bare["trace"] = {"t0": 0.0, "t1": 1.0, "device_by_span": {},
                     "idle_by_span": {}}
    assert read(bare) is None
