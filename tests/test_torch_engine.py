"""The batched engine: the port's StreamingEngine against the JAX package's
on the same weights and the same audio, on the CPU.

Each case drives both engines through one script of slot acquisitions,
ticks and finals. Every tick's partials and every final's tokens and token
positions must be equal, and final scores agree within rel. 1e-5 (float32
on both sides; JAX's CPU path runs the CTC recursion as an associative
scan, the port sequentially). Each case runs both engines once (a
module-scoped cache) and two tests read the run.
"""

import copy
from typing import Dict, List

import numpy as np
import pytest

from test_torch_common import bias_outputs, jax_model, synth_audio

from speechcatcher_tpu.serve.engine import StreamingEngine as JaxEngine
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.serve.engine import StreamingEngine
from speechcatcher_tpu_torch.serve.wire import encode_chunk

CH = 8192


def _utt(n_chunks: int, extra: int, seed: int) -> np.ndarray:
    """n_chunks full chunks plus `extra` samples."""
    n = n_chunks * CH + extra
    return synth_audio(n / 16000 + 0.01, seed)[:n]


class Script:
    """Drives one engine and records what it returns."""

    def __init__(self, eng):
        self.eng = eng
        self.log: List[tuple] = []
        self.scores: List[float] = []
        self.slot: Dict[str, int] = {}
        self.audio: Dict[str, np.ndarray] = {}
        self.wire: Dict[str, str] = {}
        self.pos: Dict[str, int] = {}

    def start(self, key, audio, wire="float32"):
        s = self.eng.acquire_slot()
        self.log.append(("acquire", key, s))
        self.slot[key], self.audio[key] = s, audio
        self.wire[key], self.pos[key] = wire, 0

    def _take(self, key, n=None):
        a = self.audio[key][self.pos[key]:]
        a = a if n is None else a[:n]
        self.pos[key] += len(a)
        return encode_chunk(a, self.wire[key])

    def tick(self, *keys):
        out = self.eng.tick({self.slot[k]: self._take(k, CH) for k in keys})
        self.log.append(("tick", {k: out.get(self.slot[k]) for k in keys}))

    def _record(self, key, res):
        yseq, xpos, score = res
        self.log.append(("final", key, [int(x) for x in yseq],
                         [int(x) for x in xpos]))
        self.scores.append(float(score))

    def finalize_batch(self, *keys):
        res = self.eng.finalize_batch(
            {self.slot[k]: self._take(k) for k in keys})
        self.log.append(("finalized", sorted(k for k in keys
                                             if self.slot[k] in res)))
        for k in keys:
            if self.slot[k] in res:
                self._record(k, res[self.slot[k]])

    def finalize(self, key):
        self._record(key, self.eng.finalize(self.slot[key], self._take(key)))


def staggered_churn(sc: Script, wire: str = "float32"):
    """Three streams with staggered starts; batched finals free slots that
    two later streams reuse; one oversize tail; one single-slot final.
    Every stream comes over `wire`."""
    sc.start("a", _utt(3, 1500, 11), wire)
    sc.tick("a")
    sc.start("b", _utt(2, 4000, 12), wire)
    sc.tick("a", "b")
    sc.start("c", _utt(5, 300, 13), wire)
    sc.tick("a", "b", "c")
    sc.finalize_batch("a", "b")
    sc.start("d", _utt(3, 6000, 14), wire)
    sc.tick("c", "d")
    sc.tick("c", "d")
    sc.finalize("c")  # a tail of more than one chunk
    sc.start("e", _utt(2, 100, 15), wire)
    sc.tick("d", "e")
    sc.tick("e")
    sc.finalize_batch("d", "e")


def wire_formats(sc: Script):
    """int16 and mu-law ingest: a mixed-format tick, all-uint8 and
    all-int16 ticks, int16 and uint8 tails."""
    sc.start("p", _utt(3, 2500, 21), wire="int16")
    sc.start("q", _utt(3, 700, 22), wire="mulaw")
    sc.start("r", _utt(2, 5000, 23))
    sc.tick("p", "q", "r")
    sc.tick("q")
    sc.tick("p")
    sc.tick("p", "q", "r")
    sc.finalize_batch("p", "q")
    sc.finalize("r")


def two_streams(sc: Script):
    sc.start("a", _utt(5, 3000, 31))
    sc.tick("a")
    sc.start("b", _utt(3, 900, 32))
    for _ in range(3):
        sc.tick("a", "b")
    sc.tick("a")
    sc.finalize_batch("a", "b")


def short_segment(sc: Script):
    """A sub-block utterance, never ticked, finalized beside a long one:
    the short-segment fallback of finalize_batch."""
    sc.start("long", _utt(2, 3000, 41))
    sc.start("short", synth_audio(6000 / 16000, 42)[:6000])
    sc.tick("long")
    sc.tick("long")
    sc.finalize_batch("long", "short")


def near_capacity(sc: Script):
    """max_enc_frames=56: seven chunks reach the tick stall, and the tail's
    drain gathers new frames from inside the last EXTCAP rows of the
    ring."""
    sc.start("a", _utt(7, 5000, 4))
    for _ in range(7):
        sc.tick("a")
    sc.finalize_batch("a")
    sc.log.append(("drain_max_start", sc.eng._last_drain_max_start))


def capacity_clamp(sc: Script):
    """max_enc_frames=56: the stream stalls (its later chunks are dropped)
    and its final, a whole chunk, would overflow the ring, so
    finalize_batch clamps it to a decode-only drain."""
    sc.start("a", _utt(9, CH, 5))
    for _ in range(9):
        sc.tick("a")
    sc.finalize_batch("a")


# name: (config overrides, engine kwargs, (eos, blank) biases, script,
#        JAX kernel D in interpret mode)
CASES = {
    "staggered_churn": ({}, dict(n_slots=3, use_bbd=True), (0.0, 0.0),
                        staggered_churn, True),
    "wire_formats": ({}, dict(n_slots=3, use_bbd=False), (0.0, 0.0),
                     wire_formats, False),
    "espnet_nobbd": ({}, dict(n_slots=2, use_bbd=False, eos_commit="espnet"),
                     (4.0, 3.0), two_streams, False),
    "bf16_ring_espnet_bbd": (dict(enc_ring_dtype="bfloat16"),
                             dict(n_slots=2, use_bbd=True,
                                  eos_commit="espnet"),
                             (4.0, 3.0), two_streams, False),
    "short_segment": ({}, dict(n_slots=3), (0.0, 0.0), short_segment, False),
    "near_capacity": (dict(max_enc_frames=56), dict(n_slots=1), (0.0, 0.0),
                      near_capacity, False),
    "capacity_clamp": (dict(max_enc_frames=56), dict(n_slots=1), (0.0, 0.0),
                       capacity_clamp, False),
}

_RUNS: Dict[str, tuple] = {}


def _run_case(name, monkeypatch):
    if name not in _RUNS:
        cfg_kw, eng_kw, biases, script, interpret = CASES[name]
        cfg = tiny_config(**cfg_kw)
        tree = bias_outputs(random_params(cfg, 7), cfg, *biases)
        kw = dict(beam_size=3, chunk_samples=CH, **eng_kw)
        with monkeypatch.context() as m:
            if interpret:
                m.setenv("SC_RING_APPEND_INTERPRET", "1")
            jax_sc = Script(JaxEngine(jax_model(cfg, copy.deepcopy(tree)),
                                      **kw))
            script(jax_sc)
        port_sc = Script(StreamingEngine(
            ASRModel.from_numpy(cfg, tree, device="cpu"), device="cpu", **kw))
        script(port_sc)
        _RUNS[name] = (jax_sc, port_sc)
    return _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_engine_ticks_match_jax(name, monkeypatch):
    jax_sc, port_sc = _run_case(name, monkeypatch)
    ticks = [e for e in jax_sc.log if e[0] == "tick"]
    assert any(any(v for v in e[1].values()) for e in ticks) or \
        name == "short_segment"  # partials were not all empty
    assert [e for e in port_sc.log if e[0] != "final"] == \
        [e for e in jax_sc.log if e[0] != "final"]


@pytest.mark.parametrize("name", list(CASES))
def test_engine_finals_match_jax(name, monkeypatch):
    jax_sc, port_sc = _run_case(name, monkeypatch)
    j_finals = [e for e in jax_sc.log if e[0] == "final"]
    assert j_finals and all(len(e[2]) > 2 for e in j_finals)
    assert [e for e in port_sc.log if e[0] == "final"] == j_finals
    np.testing.assert_allclose(port_sc.scores, jax_sc.scores, rtol=1e-5)
    if name == "near_capacity":
        eng = port_sc.eng
        start = dict((e[0], e[1]) for e in port_sc.log)["drain_max_start"]
        assert start > eng.ECAP - eng.EXTCAP  # inside the clip zone


def test_engine_capacities_and_memory_match_jax():
    cfg = tiny_config()
    tree = random_params(cfg, 7)
    kw = dict(n_slots=2, beam_size=3, chunk_samples=CH)
    j = JaxEngine(jax_model(cfg, copy.deepcopy(tree)), **kw)
    p = StreamingEngine(ASRModel.from_numpy(cfg, tree, device="cpu"),
                        device="cpu", **kw)
    for cap in ("WCAP", "FCAP", "RCAP", "SUBCAP", "MAXB", "PCAP", "ECAP",
                "EXTCAP", "ECAP_PAD"):
        assert getattr(p, cap) == getattr(j, cap), cap
    assert p.hbm_bytes_per_stream() == j.hbm_bytes_per_stream()
    s = p.acquire_slot()
    assert not p.slot_would_stall(s)
    p.c.buf_len[s] = p.ECAP
    assert p.slot_would_stall(s)
    p.release_slot(s)
    assert not p.c.active[s]


def test_finalize_batch_quarantines_a_failing_fallback(monkeypatch):
    """A fallback slot whose finalize raises is reset and left out of the
    result; the batched slot's final stands."""
    cfg = tiny_config()
    eng = StreamingEngine(ASRModel.random_init(cfg, seed=3, device="cpu"),
                          n_slots=2, beam_size=3, chunk_samples=CH,
                          device="cpu")
    long_s, short_s = eng.acquire_slot(), eng.acquire_slot()
    a = _utt(2, 3000, 51)
    eng.tick({long_s: a[:CH]})
    eng.tick({long_s: a[CH:2 * CH]})

    def broken(s, last_audio=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(eng, "finalize", broken)
    out = eng.finalize_batch({long_s: a[2 * CH:],
                              short_s: synth_audio(0.3, 52)})
    assert set(out) == {long_s} and len(out[long_s][0]) > 2
    assert not eng.c.active.any() and eng.quarantined == 1
    assert eng.acquire_slot() is not None


def test_engine_defaults_to_the_card():
    m = ASRModel.random_init(tiny_config(), seed=0, device="cpu")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingEngine(m, n_slots=1)
