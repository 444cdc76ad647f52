"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over CPU and
CUDA, its Chrome trace read back (kernels inside CUDA graph replays come
with their names and launch grids from the profiler's kernel records).

From it: the seconds in which some kernel, copy or set ran on the device
(the union of their intervals), each kernel's calls, seconds and grids, and
the idle gaps between device work, each named by the innermost harness span
(a ``record_function`` range) the host was in at the gap's middle."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """``warm`` starts and stops the profiler once in set-up (its first
    start in a process takes seconds); ``start`` and ``stop`` then bound
    the recorded slice, and ``summary`` reads it back afterwards, outside
    the window."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.start_s = 0.0
        self.phases: Dict[str, float] = {}

    @staticmethod
    def _profile():
        import torch

        return torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])

    def warm(self) -> None:
        import torch

        t = time.perf_counter()
        with self._profile():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self.phases["warm"] = time.perf_counter() - t

    def start(self) -> None:
        t = time.perf_counter()
        self.prof = self._profile()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - t

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.phases["stop"] = time.perf_counter() - self.t1

    def summary(self) -> Dict:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            self.phases["export"] = time.perf_counter() - t
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            self.phases["load"] = time.perf_counter() - t
        self.prof = None
        out = summarize(events, self.t1 - self.t0)
        out["t0"], out["t1"] = self.t0, self.t1
        self.phases["summary"] = time.perf_counter() - t
        self.phases["start"] = self.start_s
        out["phases_s"] = dict(self.phases, events=len(events))
        return out


def summarize(events: List[Dict], window_s: float) -> Dict:
    dev = []
    spans = []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    grids: Dict[str, List] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            name = e.get("name", "?")
            k = kernels[name]
            k[0] += 1
            k[1] += dur * 1e-6
            grid = (e.get("args") or {}).get("grid")
            if grid is not None and cat == "kernel":
                grids[name].append((tuple(grid), dur * 1e-6))
        elif cat == "user_annotation":
            spans.append((ts, ts + dur, e.get("name", "?")))
    dev.sort()
    merged: List[List[float]] = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1],
             merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    spans.sort()
    starts = [s[0] for s in spans]

    def host_at(t: float) -> str:
        best = None
        i = bisect.bisect_right(starts, t)
        for a, b, name in spans[max(0, i - 256):i]:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "host.other"

    top_gaps = [[host_at((a + b) / 2), g * 1e-6] for g, a, b in gaps[:10]]
    top_ops = sorted(([n, v[1]] for n, v in kernels.items()),
                     key=lambda x: -x[1])[:10]
    return {"window_s": window_s, "busy_s": busy_s,
            "kernels": {n: (int(v[0]), v[1]) for n, v in kernels.items()},
            "grids": dict(grids),
            "breakdown": {"device_ops": top_ops, "idle_gaps": top_gaps}}
