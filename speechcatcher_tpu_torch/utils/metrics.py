"""Serving metrics: per-tick latency window, RTF, active streams (port of
``speechcatcher_tpu/utils/metrics.py``), and the program's tracer
(``TRACER``): spans and counters at the serve, engine, finals and beam-loop
boundaries, on the profiler's clock while ``torch.profiler`` records.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch


class ServingMetrics:
    def __init__(self, chunk_seconds: float, window: int = 256):
        self.chunk_seconds = chunk_seconds
        self.tick_latencies = deque(maxlen=window)
        self.active_streams = 0
        self.total_ticks = 0
        self.total_finals = 0
        self._tick_start = 0.0

    def tick_begin(self, active_streams: int):
        self.active_streams = active_streams
        self._tick_start = time.perf_counter()

    def tick_end(self):
        self.tick_latencies.append(time.perf_counter() - self._tick_start)
        self.total_ticks += 1

    def finalized(self):
        self.total_finals += 1

    def snapshot(self) -> Dict[str, float]:
        lat = np.asarray(self.tick_latencies) if self.tick_latencies else (
            np.zeros(1)
        )
        return {
            "active_streams": self.active_streams,
            "tick_p50_ms": float(np.percentile(lat, 50) * 1e3),
            "tick_p95_ms": float(np.percentile(lat, 95) * 1e3),
            "rtf": float(np.percentile(lat, 50) / self.chunk_seconds),
            "total_ticks": self.total_ticks,
            "total_finals": self.total_finals,
        }


# What a span is while the tracer is off: it enters and leaves.
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("tracer", "name", "rec", "index", "tick", "annotation")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        parent = stack[-1] if stack else None
        self.tick = next(tr._ticks) if parent is None else parent.tick
        self.rec = [self.name, time.perf_counter_ns(), None,
                    None if parent is None else parent.index, self.tick]
        spans = tr.spans
        if len(spans) < tr.cap:
            self.index = len(spans)
            spans.append(self.rec)
        else:
            self.index = None
            tr.count("tracing.dropped")
        stack.append(self)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return None

    def __exit__(self, *exc) -> bool:
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.rec[2] = time.perf_counter_ns()
        self.tracer._stack().pop()
        return False


class Tracer:
    """Spans and counters of the program, off until ``start``.

    ``span(name)`` is a context manager. Off, it is one attribute test and
    a shared no-op: no clock is read and nothing is recorded. On, it records
    [name, start ns, end ns, parent index, tick] on the
    ``time.perf_counter_ns`` clock; a span opened with no span open around
    it in its thread starts a new tick, and the spans inside it share its
    tick number. While ``torch.profiler`` records, a span is also a
    ``record_function`` range of its name, so it lies in the profiler's
    trace beside the kernels launched inside it. Past ``cap`` spans, spans
    are dropped and counted (``tracing.dropped``).

    Spans time the host and read nothing back from the device. None goes
    inside a captured CUDA graph's program (it would run once, at the
    capture): spans lie around replays."""

    def __init__(self, cap: int = 1 << 20):
        self.on = False
        self.cap = cap
        self.spans: List[list] = []
        self.counts: Dict[str, int] = {}
        self._ticks = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()

    def start(self) -> None:
        self.on = True

    def stop(self) -> None:
        self.on = False

    def reset(self) -> None:
        """Forget every span and count (between ticks: a span still open
        is not recorded anew)."""
        self.spans = []
        self.counts = {}
        self._ticks = itertools.count()

    def span(self, name: str):
        if not self.on:
            return _OFF
        return _Span(self, name)

    def annotate(self, name: str):
        """A ``record_function`` range of `name` while ``torch.profiler``
        records, else the shared no-op; no span. For work inside a program
        that may be captured into a CUDA graph, where no span may go: the
        range is host-side, so it names the work of eager runs only (a
        replay runs no host code)."""
        if torch.autograd._profiler_enabled():
            return torch.profiler.record_function(name)
        return _OFF

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            with self._lock:
                self.counts[name] = self.counts.get(name, 0) + n

    def export(self) -> Dict:
        """The spans, as lists [name, start ns, end ns (None while open),
        parent index, tick], and the counters."""
        return {"spans": [list(r) for r in self.spans],
                "counts": dict(self.counts)}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


# The process's tracer: the serving path's spans and counters go to it.
TRACER = Tracer()
