"""A serving cell's traced run with the program's own spans and counters.

    python3 benchmark/program_trace.py --workload <cell> --seed <n> \
        --seconds <s> --tracer <0|1> [--out <file>]

Serves the cell through the harness's own ``serve.run_cell``, as
``benchmark/run.py --trace 1`` does (the same set-up, window, profiled slice
and check). With ``--tracer 1`` the program's tracer
(``speechcatcher_tpu_torch.utils.metrics.TRACER``) is on from set-up to the
end of the profiled slice, and the report adds what it recorded: host ms of
each span in the window and in the profiled slice, its counters, the graph
captures of set-up and lead-in, the owners of the slice's device and idle
time by span (``benchmark.harness.owners``), among them the owners of the
copy kernels, and the per-layer values of ``owners.READINGS``. With
``--tracer 0`` the tracer stays off: the pair of runs prices it. The report
is one JSON line on standard output (the long tables left out) and, whole,
in ``--out``.

A stand-in: ``run.py`` does not turn the tracer on. Once ``--trace 1``
runs record the tracer and the owners themselves, this script goes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import owners  # noqa: E402

T_PROCESS = cells.process_seconds()
TOP = 30


def host_ms(spans, lo: float, hi: float):
    """Calls, mean ms and total ms of each span name started in [lo, hi)
    (perf_counter seconds)."""
    acc = defaultdict(list)
    for name, t0, t1, *_ in spans:
        if t1 is not None and lo * 1e9 <= t0 < hi * 1e9:
            acc[name].append((t1 - t0) * 1e-6)
    return {n: [len(v), sum(v) / len(v), sum(v)] for n, v in acc.items()}


def longest_ticks(spans, lo: float, hi: float, n: int = 5):
    """The n longest serve ticks started in [lo, hi): each tick's host ms
    and the host ms of its spans by name."""
    ticks = defaultdict(lambda: defaultdict(float))
    for name, t0, t1, _parent, tick in spans:
        if t1 is not None:
            ticks[tick][name] += (t1 - t0) * 1e-6
    roots = [(r[4], (r[2] - r[1]) * 1e-6) for r in spans
             if r[0] == "serve.tick" and r[2] is not None
             and lo * 1e9 <= r[1] < hi * 1e9]
    roots.sort(key=lambda x: -x[1])
    return [[ms, dict(ticks[tick])] for tick, ms in roots[:n]]


def by_leaf(table):
    """A table by path summed by its innermost span name."""
    out = defaultdict(float)
    for path, s in table.items():
        out[path.rsplit("/", 1)[-1]] += s
    return dict(out)


def top(table, n: int = TOP):
    return dict(sorted(table.items(), key=lambda kv: -kv[1])[:n])


@contextlib.contextmanager
def owned(tracer, setup: Dict):
    """The harness's traced run with the program's tracer beside it: the
    window's start (where ``Loop.run`` resets the harness's spans) moves
    what the tracer recorded so far into `setup` and starts it afresh; the
    profiled slice's stop stops it; the slice's summary adds the owners'
    tables (``owners.attribute``)."""
    from benchmark.harness import spans, trace

    reset, stop, summarize = spans.Spans.reset, trace.Trace.stop, \
        trace.summarize

    def window_starts(self):
        reset(self)
        if tracer.on:
            setup.update(tracer.export())
            tracer.reset()

    def slice_stops(self):
        tracer.stop()
        stop(self)

    def owners_too(events, window_s):
        out = summarize(events, window_s)
        out.update(owners.attribute(events))
        return out

    spans.Spans.reset = window_starts
    trace.Trace.stop = slice_stops
    trace.summarize = owners_too
    try:
        yield
    finally:
        spans.Spans.reset = reset
        trace.Trace.stop = stop
        trace.summarize = summarize
        tracer.stop()


def run(cell, tracer_on: bool, device: str = "cuda"):
    from benchmark.harness import check, serve
    from speechcatcher_tpu_torch.utils.metrics import TRACER

    setup: Dict = {"spans": [], "counts": {}}
    TRACER.reset()
    with owned(TRACER, setup):
        if tracer_on:
            TRACER.start()
        out = serve.run_cell(cell, device)
    rec = out["record"]
    rec["program"] = TRACER.export()
    TRACER.reset()
    tr = rec["trace"]
    w0, w1 = out["w0"], out["w0"] + cell.seconds
    captures = [(r[2] - r[1]) * 1e-9 for r in setup["spans"]
                if r[0] == "graphs.capture" and r[2] is not None]
    copies = defaultdict(float)
    for kernel, table in tr["by_kernel"].items():
        if "direct_copy" in kernel:
            for path, s in table.items():
                copies[path] += s
    return {
        "workload": cell.name, "seed": cell.seed, "tracer": int(tracer_on),
        "correct": check.verdict(out["readings"], cell.checks),
        "attempted": out["attempted"], "failed": out["failed"],
        "e2e": out["e2e"], "per_layer": cells.per_layer(cell, rec),
        "readings": {n: f(rec) for n, f in owners.READINGS.items()},
        "harness_spans_ms": rec["spans"],
        "host_ms": host_ms(rec["program"]["spans"], w0, w1),
        "slice_host_ms": host_ms(rec["program"]["spans"], tr["t0"],
                                 tr["t1"]),
        "longest_ticks": longest_ticks(rec["program"]["spans"], w0, w1),
        "counts": rec["program"]["counts"],
        "setup": {"graphs.capture": [len(captures), sum(captures)],
                  "counts": setup["counts"]},
        "busy_s": tr["busy_s"], "window_s": tr["window_s"],
        "device_by_leaf": by_leaf(tr["device_by_span"]),
        "idle_by_leaf": by_leaf(tr["idle_by_span"]),
        "short_idle_by_leaf": by_leaf(tr["short_idle_by_span"]),
        "events_by_span": top(tr["events_by_span"]),
        "device_by_span": top(tr["device_by_span"]),
        "idle_by_span": top(tr["idle_by_span"]),
        "copy_by_span": top(dict(copies)),
        "gaps": tr["gaps"], "breakdown": tr["breakdown"],
        "memory_peak_bytes": out["memory_peak_bytes"],
        "phases_s": tr["phases_s"], "counts_run": out["counts"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), required=True)
    ap.add_argument("--trace-seconds", type=float, default=None,
                    help="profile the window's last seconds (default: "
                    "the traffic's trace_seconds)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload, args.seed, args.seconds, True,
                      T_PROCESS)
    if args.trace_seconds is not None:
        cell.traffic["trace_seconds"] = args.trace_seconds
    import torch

    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA device", file=sys.stderr)
        return 2
    report = run(cell, bool(args.tracer))
    from benchmark.run import power_limit

    report["device"] = {"kind": torch.cuda.get_device_name(0),
                        "power_limit_w": power_limit()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report))
    short = {k: v for k, v in report.items()
             if k not in ("device_by_span", "idle_by_span", "copy_by_span",
                          "breakdown", "gaps")}
    print(json.dumps(short), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
