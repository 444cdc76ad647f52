"""Owners of the device's time in a traced slice, by the program's spans.

With the program's tracer on (``speechcatcher_tpu_torch.utils.metrics.
TRACER``), every span of the serve tick, the engine tick, the finals and the
beam loop is a ``record_function`` range in the profiler's Chrome trace, on
the trace's own clock, beside the harness's ranges of the same names. Here
each annotation is named by its path, the names of the annotations around it
on its thread from the outermost in, joined by ``/`` (an annotation inside
one of the same name adds nothing: the harness's ``serve.tick`` around the
program's). From the trace's events:

- ``device_by_span``: each kernel, copy and set's device seconds, put down to
  the innermost annotation around the runtime call that launched it
  (``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...,
  joined to the device record on ``args.correlation``); ``host.other``
  where no annotation was open;
- ``idle_by_span``: the seconds of every gap between device work, split at
  annotation boundaries onto the innermost annotation over each part;
- ``short_idle_by_span``: the same for the gaps shorter than ``short_us``
  µs alone, which are mostly the spacing of kernels the device runs back
  to back (a graph's nodes) rather than a wait for the host;
- ``gaps``: the longest gaps, each with its parts;
- ``by_kernel``: ``device_by_span`` for each kernel name;
- ``events_by_span``: the number of device records under each span.

``READINGS`` computes per-layer values from a run's record that holds the
tracer's ``export()`` under ``program`` and these tables under ``trace``;
each returns None where its span, counter or table is absent.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "host.other"

Annotation = Tuple[float, float, str, object]  # start µs, end µs, path, tid


def _annotations(events: List[Dict]) -> List[Annotation]:
    """The trace's annotations with their paths, by start."""
    raw = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e.get("name", "?"), e.get("tid"))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"),
                 key=lambda a: (a[0], -a[1]))
    open_: Dict[object, List[Annotation]] = defaultdict(list)
    out: List[Annotation] = []
    for ts, te, name, tid in raw:
        stack = open_[tid]
        while stack and stack[-1][1] <= ts:
            stack.pop()
        if stack and te <= stack[-1][1]:
            parent = stack[-1][2]
            last = parent.rsplit("/", 1)[-1]
            path = parent if last == name else f"{parent}/{name}"
        else:
            path = name
        a = (ts, te, path, tid)
        stack.append(a)
        out.append(a)
    return out


def _segments(annots: List[Annotation]) -> Tuple[List[float], List[str]]:
    """The timeline cut at every annotation boundary: segment k runs from
    bounds[k] to bounds[k + 1] under the innermost open annotation (the
    latest started; NO_SPAN where none is open)."""
    bounds = sorted({t for a in annots for t in a[:2]})
    opening = defaultdict(list)
    closing = defaultdict(list)
    for i, a in enumerate(annots):
        opening[a[0]].append(i)
        closing[a[1]].append(i)
    active: List[int] = []
    owners: List[str] = []
    for t in bounds:
        for i in closing.get(t, ()):
            if i in active:
                active.remove(i)
        active.extend(i for i in opening.get(t, ()) if annots[i][1] > t)
        owners.append(annots[active[-1]][2] if active else NO_SPAN)
    return bounds, owners


def _owner(segments, t: float) -> str:
    bounds, owners = segments
    k = bisect.bisect_right(bounds, t) - 1
    return owners[k] if k >= 0 else NO_SPAN


def _split(segments, a: float, b: float) -> List[Tuple[str, float]]:
    """[a, b) cut into the parts under each innermost annotation."""
    bounds, owners = segments
    parts: Dict[str, float] = defaultdict(float)
    k = bisect.bisect_right(bounds, a) - 1
    t = a
    while t < b:
        nxt = bounds[k + 1] if k + 1 < len(bounds) else b
        end = min(nxt, b)
        parts[owners[k] if k >= 0 else NO_SPAN] += end - t
        t = end
        k += 1
    return sorted(parts.items(), key=lambda p: -p[1])


def attribute(events: List[Dict], top: int = 10,
              short_us: float = 50.0) -> Dict:
    """The owners of the slice's device and idle time (seconds, by path)."""
    annots = _annotations(events)
    by_tid: Dict[object, List[Annotation]] = defaultdict(list)
    for a in annots:
        by_tid[a[3]].append(a)
    tid_segments = {tid: _segments(a) for tid, a in by_tid.items()}
    launched: Dict[object, str] = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in DEVICE_CATS:
            device.append(e)
        elif (e.get("cat") in RUNTIME_CATS and corr is not None
              and e.get("tid") in tid_segments):
            launched[corr] = _owner(tid_segments[e["tid"]], float(e["ts"]))
    device_by: Dict[str, float] = defaultdict(float)
    events_by: Dict[str, int] = defaultdict(int)
    by_kernel: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    busy = []
    for e in device:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        path = launched.get((e.get("args") or {}).get("correlation"),
                            NO_SPAN)
        device_by[path] += dur * 1e-6
        events_by[path] += 1
        by_kernel[e.get("name", "?")][path] += dur * 1e-6
        busy.append((ts, ts + dur))
    busy.sort()
    merged: List[List[float]] = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    segments = _segments(annots)
    idle_by: Dict[str, float] = defaultdict(float)
    short_by: Dict[str, float] = defaultdict(float)
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        parts = _split(segments, a, b)
        for path, us in parts:
            idle_by[path] += us * 1e-6
            if b - a < short_us:
                short_by[path] += us * 1e-6
        gaps.append([(b - a) * 1e-6, [[p, us * 1e-6] for p, us in parts]])
    gaps.sort(key=lambda g: -g[0])
    return {"device_by_span": dict(device_by),
            "idle_by_span": dict(idle_by),
            "short_idle_by_span": dict(short_by), "gaps": gaps[:top],
            "by_kernel": {k: dict(v) for k, v in by_kernel.items()},
            "events_by_span": dict(events_by)}


# -- per-layer values from a run's record --------------------------------------

def _spans_ms(rec: Dict, name: str, in_slice: bool = False
              ) -> Optional[List[float]]:
    """Host ms of each closed span `name` of the record's program export
    (with `in_slice`, of those that started inside the traced slice)."""
    prog = rec.get("program")
    if not prog:
        return None
    lo, hi = -1, float("inf")
    if in_slice:
        t = rec.get("trace")
        if not t:
            return None
        lo, hi = t["t0"] * 1e9, t["t1"] * 1e9
    return [(r[2] - r[1]) * 1e-6 for r in prog["spans"]
            if r[0] == name and r[2] is not None and lo <= r[1] < hi]


def _under(rec: Dict, table: str, names: set) -> Optional[float]:
    """Seconds of the trace's `table` under any span of `names` (None
    where the table is absent or empty: no device work was traced)."""
    t = rec.get("trace") or {}
    if not t.get(table):
        return None
    return sum(s for path, s in t[table].items()
               if names & set(path.split("/")))


def _per_call_ms(rec: Dict, table: str, names: set, per: str
                 ) -> Optional[float]:
    seconds = _under(rec, table, names)
    calls = _spans_ms(rec, per, in_slice=True)
    if seconds is None or not calls:
        return None
    return 1e3 * seconds / len(calls)


def _count(rec: Dict, name: str) -> Optional[int]:
    prog = rec.get("program")
    return None if not prog else prog["counts"].get(name, 0)


def drain_ms(rec: Dict) -> Optional[float]:
    """Mean host ms of ``engine.final.drain`` per ``finalize_batch``."""
    calls = _spans_ms(rec, "engine.finalize_batch")
    if not calls:
        return None
    return sum(_spans_ms(rec, "engine.final.drain")) / len(calls)


def final_idle_ms(rec: Dict) -> Optional[float]:
    """Device-idle ms under ``engine.finalize_batch`` and its children per
    call that started in the traced slice."""
    return _per_call_ms(rec, "idle_by_span", {"engine.finalize_batch"},
                        "engine.finalize_batch")


def sync_wait_ms(rec: Dict) -> Optional[float]:
    """Mean host ms of a ``beam.sync`` (the wait on ``any(stepping)``)."""
    d = _spans_ms(rec, "beam.sync")
    return sum(d) / len(d) if d else None


def fallback_share(rec: Dict) -> Optional[float]:
    """``finalize`` calls over them plus the slots finalized compactly."""
    fb = _count(rec, "engine.final.fallbacks")
    slots = _count(rec, "engine.final.slots")
    if fb is None or fb + slots == 0:
        return None
    return 100.0 * fb / (fb + slots)


def encode_dev_ms(rec: Dict) -> Optional[float]:
    """Device ms launched under ``engine.final.encode`` per call in the
    slice."""
    return _per_call_ms(rec, "device_by_span", {"engine.final.encode"},
                        "engine.final.encode")


def state_dev_ms(rec: Dict) -> Optional[float]:
    """Device ms launched under ``engine.final.extract`` and
    ``engine.final.reset`` per compact finalize in the slice."""
    return _per_call_ms(rec, "device_by_span",
                        {"engine.final.extract", "engine.final.reset"},
                        "engine.final.extract")


def pad_share(rec: Dict) -> Optional[float]:
    """Padding rows over the compact rows run."""
    rows = _count(rec, "engine.final.rows")
    if not rows:
        return None
    return 100.0 * (rows - _count(rec, "engine.final.slots")) / rows


READINGS: Dict[str, Callable[[Dict], Optional[float]]] = {
    "final.drain_ms.rt": drain_ms,
    "final.idle_ms.rt": final_idle_ms,
    "beam.sync_wait_ms.rt": sync_wait_ms,
    "final.fallback_share.rt": fallback_share,
    "final.drain_ms.backlog": drain_ms,
    "final.encode_dev_ms.backlog": encode_dev_ms,
    "final.state_dev_ms.backlog": state_dev_ms,
    "final.pad_share.backlog": pad_share,
}
