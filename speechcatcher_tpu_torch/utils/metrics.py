"""Serving metrics: per-tick latency window, RTF, active streams (port of
``speechcatcher_tpu/utils/metrics.py``), and a ``torch.profiler`` trace in
place of the JAX profiler's.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict

import numpy as np


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


# The running trace: like the JAX profiler's, one per process.
_profiler = None


def start_profiler_trace(logdir: str):
    """Start a ``torch.profiler`` trace of the host and, where there is one,
    the card; ``stop_profiler_trace`` writes it into `logdir` as a Chrome
    trace (``*.pt.trace.json``)."""
    global _profiler
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    if _profiler is not None:
        raise RuntimeError("a profiler trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _profiler = profile(activities=activities,
                        on_trace_ready=tensorboard_trace_handler(logdir))
    _profiler.start()
    return logdir


def stop_profiler_trace():
    global _profiler
    prof, _profiler = _profiler, None
    if prof is None:
        raise RuntimeError("no profiler trace is running")
    prof.stop()
