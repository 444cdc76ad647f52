"""The benchmark of ``speechcatcher_tpu_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the machine it is started on, from
the root of a checkout, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``, the
numbers the correctness check compared, each beside its limit (also the
last lines on standard error). Exits non-zero, printing no result, without
enough CUDA devices, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell as cells  # noqa: E402

T_PROCESS = cells.process_seconds()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = cells.load(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_PROCESS)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness import serve

    out = serve.run_cell(cell)
    found = cells.forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: loaded {', '.join(found)}: the measured process "
              f"may not load JAX or the JAX package", file=sys.stderr)
        return 3

    readings = out["readings"]
    from benchmark.harness.check import compared, report_lines, verdict

    if args.trace:
        metrics = cells.per_layer(cell, out["record"])
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit_w": power_limit()}
    result = {"correct": verdict(readings, cell.checks),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device, "counts": out["counts"]}
    trace = out["record"]["trace"]
    if args.trace and trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        result["breakdown"] = trace["breakdown"]
    result["check"] = compared(readings, cell.checks)
    for line in report_lines(readings, cell.checks):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def power_limit():
    """The card's power limit in watts, as nvidia-smi reads it (None where
    it cannot)."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
