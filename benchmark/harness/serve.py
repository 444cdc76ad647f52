"""The serving cells: the port's Vosk server front (``SessionManager`` over
one ``StreamingEngine``) driven by the batcher's loop (tick when
``ready()``, else sleep ``tick_interval_s``) in one thread, with the
traffic's sessions opened, fed and closed between ticks.

Latencies are taken on the host clock from when the audio was due: a
partial from the moment the piece that completed its chunk was due, a final
from the moment its utterance's last piece and eof were due, both to the
return of the ``SessionManager.tick`` that produced them. The rate is the
audio the ticks and the finals' tails consumed in the window, over the
window's seconds, the window's ends being tick ends.
"""

from __future__ import annotations

import gc
import heapq
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.harness.spans import Spans
from benchmark.harness.traffic import Traffic, Utterance


@dataclass
class Served:
    """One utterance as served."""

    utt: Utterance
    due_eof: float
    sid: int = -1
    chunk_due: List[float] = field(default_factory=list)
    partials: int = 0
    result: Optional[Tuple[np.ndarray, np.ndarray, float]] = None
    tail: int = -1
    final_at: float = float("nan")
    refused: bool = False


class System:
    """The program under test, built from a configuration and the traffic's
    server settings."""

    def __init__(self, model_cfg: Dict, tree, traffic: Dict, device: str):
        from speechcatcher_tpu_torch.config import ModelConfig
        from speechcatcher_tpu_torch.decode import graphs
        from speechcatcher_tpu_torch.models.asr_model import ASRModel
        from speechcatcher_tpu_torch.serve.engine import StreamingEngine
        from speechcatcher_tpu_torch.serve.server import SessionManager

        from benchmark.harness.weights import to_numpy

        self.model_cfg = model_cfg
        self.cfg = ModelConfig(**model_cfg)
        self.model = ASRModel.from_numpy(self.cfg, to_numpy(tree),
                                         device=device)
        self.engine = StreamingEngine(
            self.model, n_slots=traffic["pool_size"],
            beam_size=traffic["beam"], chunk_samples=traffic["chunk_samples"],
            ctc_weight=model_cfg["ctc_weight"], device=device)
        self.engine.capture_graphs()
        self.manager = SessionManager(
            self.engine,
            finalize_update_iters=traffic["finalize_update_iters"],
            max_partial_iters=traffic["max_partial_iters"],
            wire=traffic["wire"])
        self.spans = Spans()
        self.results: Dict[int, Tuple] = {}
        self.tails: Dict[int, int] = {}
        eng, man = self.engine, self.manager
        fin = self.spans.wrap("engine.finalize_batch", eng.finalize_batch)

        def finalize_batch(finals):
            for s, a in finals.items():
                self.tails[s] = 0 if a is None else len(a)
            out = fin(finals)
            self.results.update(out)
            return out

        eng.finalize_batch = finalize_batch
        etick = self.spans.wrap("engine.tick", eng.tick)
        self.tick_samples = 0

        def tick(audio):
            self.tick_samples += len(audio) * eng.A
            return etick(audio)

        eng.tick = tick
        self.tick = self.spans.wrap("serve.tick", man.tick)
        self.unwatch = self.spans.watch_block_loops(graphs.BlockLoop)

    def failures(self) -> int:
        return (sum(self.manager.caught.values())
                + int(self.engine.quarantined))

    def close(self) -> None:
        """Close every session (their slots are reset)."""
        for sid in list(self.manager.sessions):
            self.manager.close_session(sid)


def warm_up(system: System, traffic: Traffic) -> None:
    """Serve a few short utterances end to end (an eager final of a short
    segment among them) so that nothing lazy is left for the window."""
    man = system.manager
    chunk = system.engine.A
    sids = []
    for seconds in (1.0, 2.0 + chunk / 16000.0, 4.0):
        pcm = traffic.bank[0][:int(seconds * 16000)]
        sid = man.open_session()
        man.feed(sid, pcm.tobytes())
        man.request_final(sid)
        sids.append(sid)
    for _ in range(200):
        if not man.ready():
            break
        system.tick()
    for sid in sids:
        man.close_session(sid)
    system.results.clear()
    system.tails.clear()


class Loop:
    """One run of a serving cell: lead-in, window, drain."""

    def __init__(self, system: System, traffic: Traffic, spec: Dict):
        self.sys = system
        self.tr = traffic
        self.spec = spec
        self.events: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self.served: List[Served] = []
        self.by_sid: Dict[int, Served] = {}
        self.ticks: List[Tuple[float, float, int]] = []
        self.partial_lat: List[Tuple[float, float]] = []
        self.refused = 0

    # -- schedule --------------------------------------------------------
    def _push(self, due: float, kind: str, payload) -> None:
        self._seq += 1
        heapq.heappush(self.events, (due, self._seq, kind, payload))

    def _schedule_talk(self, talker: int, u0: float, utt: Utterance) -> None:
        """A talker's utterance from u0 on: its pieces, its eof, and after
        its pause the next utterance."""
        due = self.tr.piece_due(u0, len(utt.pcm))
        sv = Served(utt, due_eof=due[-1])
        p = self.spec["piece_samples"]
        chunk = self.sys.engine.A
        n_chunks = len(utt.pcm) // chunk
        sv.chunk_due = [due[((c + 1) * chunk - 1) // p]
                        for c in range(n_chunks)]
        self._push(u0, "open", sv)
        for k, t in enumerate(due):
            self._push(t, "piece", (sv, k))
        self._push(due[-1], "eof", sv)
        nxt = due[-1] + self.tr.pause(utt.uid)
        self._push(nxt, "talk", talker)

    def start_open(self, t0: float) -> None:
        for k in range(self.spec["speakers"]):
            utt = self.tr.utterance()
            cycle = len(utt.pcm) / self.tr.rate + self.tr.pause(utt.uid)
            phi = self.tr.phases[k] * cycle
            length = len(utt.pcm) / self.tr.rate
            if phi < length:
                cut = int(phi / length * len(utt.pcm))
                utt = Utterance(utt.uid, utt.pcm[cut:])
                self._schedule_talk(k, t0, utt)
            else:
                self._push(t0 + cycle - phi, "talk", k)

    def _open_closed(self, now: float, truncate: float = 0.0) -> None:
        utt = self.tr.utterance(truncate)
        sv = Served(utt, due_eof=now)
        self._open(sv)
        if sv.sid >= 0:
            self.sys.manager.feed(sv.sid, utt.pcm.tobytes())
            self.sys.manager.request_final(sv.sid)

    def start_closed(self, now: float) -> None:
        for k in range(self.spec["pool_size"]):
            self._open_closed(now, float(self.tr.phases[k]))

    def _open(self, sv: Served) -> None:
        sid = self.sys.manager.open_session()
        self.served.append(sv)
        if sid is None:
            sv.refused = True
            self.refused += 1
            return
        sv.sid = sid
        self.by_sid[sid] = sv

    def _deliver(self, now: float) -> None:
        man = self.sys.manager
        while self.events and self.events[0][0] <= now:
            due, _, kind, payload = heapq.heappop(self.events)
            if kind == "talk":
                self._schedule_talk(payload, due, self.tr.utterance())
            elif kind == "open":
                self._open(payload)
            elif kind == "piece":
                sv, k = payload
                if sv.sid >= 0:
                    p = self.spec["piece_samples"]
                    man.feed(sv.sid, sv.utt.pcm[k * p:(k + 1) * p].tobytes())
            elif kind == "eof":
                if payload.sid >= 0:
                    man.request_final(payload.sid)

    # -- the loop ----------------------------------------------------------
    def tick(self, closed: bool) -> None:
        sys_ = self.sys
        man = sys_.manager
        slot_of = {sid: s.slot for sid, s in man.sessions.items()}
        sys_.results.clear()
        sys_.tails.clear()
        samples0 = sys_.tick_samples
        t_a = time.perf_counter()
        out = sys_.tick()
        t_b = time.perf_counter()
        samples = sys_.tick_samples - samples0
        for sid, msg in out.items():
            sv = self.by_sid.get(sid)
            if sv is None:
                continue
            if "partial" in msg:
                if sv.partials < len(sv.chunk_due):
                    due = sv.chunk_due[sv.partials]
                    self.partial_lat.append((due, t_b - due))
                sv.partials += 1
                continue
            slot = slot_of.get(sid, -1)
            sv.final_at = t_b
            sv.result = sys_.results.get(slot)
            sv.tail = sys_.tails.get(slot, -1)
            samples += max(sv.tail, 0)
            man.close_session(sid)
            del self.by_sid[sid]
            if closed:
                self._open_closed(t_b)
        self.ticks.append((t_a, t_b, samples))

    def run(self, lead_in: float, seconds: float, grace: float,
            trace=None, trace_seconds: float = 0.0) -> Dict:
        """Serve from now on: `lead_in` seconds, then the window of
        `seconds`, then until the window's finals are back (at most `grace`
        seconds more). With `trace`, the window's last `trace_seconds` are
        profiled; the trace is read back after the loop."""
        closed = self.spec["loop"] == "closed"
        man = self.sys.manager
        interval = self.spec["tick_interval_s"]
        t0 = time.perf_counter()
        if closed:
            self.start_closed(t0)
        else:
            self.start_open(t0)
        w0 = t0 + lead_in
        w1 = w0 + seconds
        tr0 = w1 - min(trace_seconds, seconds)
        tracing = False
        spans_on = False
        window_ticks = None
        while True:
            now = time.perf_counter()
            if not spans_on and now >= w0:
                self.sys.spans.reset()
                self.sys.spans.on = spans_on = True
                self.sys.spans.annotate = self.sys.spans.steps = \
                    trace is not None
                tick0 = len(self.ticks)
                fail0 = self.sys.failures()
                refused0 = self.refused
            if trace is not None and not tracing and window_ticks is None \
                    and now >= tr0:
                trace.start()
                tracing = True
            if spans_on and window_ticks is None and now >= w1:
                if tracing:
                    trace.stop()
                self.sys.spans.on = False
                window_ticks = (tick0, len(self.ticks))
                fail1 = self.sys.failures()
                refused1 = self.refused
            if window_ticks is not None and (closed or self._drained(w0, w1)
                                             or now > w1 + grace):
                break
            if not closed:
                self._deliver(now)
            if man.ready():
                self.tick(closed)
            else:
                time.sleep(interval)
        return {"w0": w0, "w1": w1, "ticks": window_ticks,
                "failures": fail1 - fail0, "refused": refused1 - refused0,
                "trace": trace.summary() if tracing else None}

    def _drained(self, w0: float, w1: float) -> bool:
        return all(sv.result is not None or sv.refused
                   or not (w0 <= sv.due_eof < w1)
                   for sv in self.served)


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-quantile of all values by the nearest-rank rule (the smallest
    value with at least a share q of the values at or below it)."""
    v = sorted(values)
    if not v:
        return float("nan")
    return float(v[max(0, math.ceil(q * len(v)) - 1)])


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def serve_window(system: System, traffic: Traffic, cell, trace=None
                 ) -> Dict:
    """Serve the cell's traffic: lead-in, the window, the drain. Returns the
    window's numbers, its per-layer record and the utterances it finished
    (the sample for the check)."""
    spec = cell.traffic
    loop = Loop(system, traffic, spec)
    w = loop.run(spec["lead_in_s"], cell.seconds, spec["grace_s"], trace,
                 spec.get("trace_seconds", cell.seconds))
    closed = spec["loop"] == "closed"
    if closed:
        in_window = [sv for sv in loop.served
                     if w["w0"] <= sv.final_at < w["w1"]]
    else:
        in_window = [sv for sv in loop.served
                     if w["w0"] <= sv.due_eof < w["w1"]]
    missing = sum(1 for sv in in_window
                  if sv.result is None or not math.isfinite(sv.result[2]))
    t_lo, t_hi = w["ticks"]
    ticks = loop.ticks[t_lo:t_hi]
    window_s = (ticks[-1][1] - ticks[0][0]) if ticks else float("nan")
    samples = sum(t[2] for t in ticks)
    partial_lat = [lat for due, lat in loop.partial_lat
                   if w["w0"] <= due < w["w1"]]
    e2e = {
        "audio_rate": samples / 16000.0 / window_s,
        "partial_p95_ms": 1e3 * nearest_rank(partial_lat, 0.95),
        "final_p95_ms": 1e3 * nearest_rank(
            [sv.final_at - sv.due_eof for sv in in_window
             if sv.result is not None], 0.95),
    }
    rec = {"config": system.model_cfg, "traffic": spec, "beam": spec["beam"],
           "spans": {k: system.spans.mean_ms(k)
                     for k in ("serve.tick", "engine.tick",
                               "engine.finalize_batch")},
           "blocks": list(system.spans.blocks), "window_s": window_s,
           "audio_samples": samples, "trace": w["trace"]}
    return {"w0": w["w0"], "e2e": e2e, "record": rec, "served": in_window,
            "attempted": len(in_window),
            "failed": missing + w["failures"] + (w["refused"] if closed
                                                 else 0),
            "counts": {"finals": len(in_window), "partials": len(partial_lat),
                       "ticks": len(ticks),
                       "trace_s": (w["trace"] or {}).get("phases_s"),
                       "step_log_s": (system.spans.log_s
                                      if trace is not None else None)}}


def judge(ref, served, cell) -> Dict:
    """The reference's readings of a sample of the served finals."""
    from benchmark.harness import check

    spec = cell.traffic
    picked = check.sample(served, cell.checks["sample"], cell.seed)
    return check.reference_readings(ref, picked, spec["chunk_samples"],
                                    spec["beam"])


def run_cell(cell, device: str = "cuda") -> Dict:
    """Build, warm, serve the window, then judge the sample. Returns the
    end-to-end numbers, the per-layer record, the check's readings and what
    the result line reports of the device."""
    import torch

    from benchmark.harness import weights
    from benchmark.harness.trace import Trace

    m = cell.config["model"]
    tree = weights.make_tree(m, cell.config["emission_bias"],
                             cell.config["weights_seed"], device,
                             cell.reference.weight_specs)
    traffic = Traffic(cell.traffic, cell.seed)
    system = System(m, tree, cell.traffic, device)
    warm_up(system, traffic)
    trace = Trace() if cell.trace else None
    if trace is not None:
        trace.warm()
        system.spans.pin(cell.traffic["pool_size"])
    sync(device)
    # What set-up left is kept out of the collector's passes in the window.
    gc.collect()
    gc.freeze()
    out = serve_window(system, traffic, cell, trace)
    gc.unfreeze()
    sync(device)
    out["e2e"]["setup_s"] = out["w0"] - cell.t_process
    out["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                if device == "cuda" else 0)
    system.close()
    system.unwatch()
    del system
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["readings"] = judge(cell.reference.Reference(m, tree, device),
                            out.pop("served"), cell)
    return out
