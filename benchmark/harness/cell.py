"""A cell as ``BENCHMARK.json`` names it, and everything the harness finds
for it by name: ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json``, ``benchmark/checks/<cell>.json``, the
plain reference ``benchmark/reference/<name>.py`` that the configuration
names under ``"reference"`` (``asr`` where it names none) and one reader
``benchmark/metrics/<metric>.py`` for each per-layer metric."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "speechcatcher_tpu")
REFERENCE_NAME = re.compile(r"[a-z0-9_]+")
# What the harness takes from a reference module: ``Reference(model, tree,
# device)``, the plain model that the check scores served finals with;
# ``weight_specs(model)``, the layout of the weight tree that it and the
# program read; ``in_tf32()``, the context in which it computes the control.
REFERENCE_API = ("Reference", "weight_specs", "in_tf32")


def process_seconds() -> float:
    """Seconds since this process started (Linux /proc), on the clock of
    ``time.perf_counter``: the moment the process began, as that clock reads
    it."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.perf_counter() - (uptime - start)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    checks: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    seed: int
    seconds: float
    trace: bool
    t_process: float
    reference: ModuleType


def load(name: str, seed: int, seconds: float, trace: bool,
         t_process: float) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]

    def mine(metric: Dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    config = json.loads((BENCH / "configs" / f"{w['config']}.json")
                        .read_text())
    return Cell(
        name=name, chips=w["chips"], config=config,
        traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        checks=json.loads((BENCH / "checks" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
        seed=seed, seconds=seconds, trace=trace, t_process=t_process,
        reference=reference(w["config"], config))


def reference(config_name: str, config: Dict) -> ModuleType:
    """The module ``benchmark/reference/<name>.py`` that configuration
    `config_name` names under ``"reference"`` (``asr`` where it names
    none), checked to define ``REFERENCE_API``. Stops the run, naming the
    configuration, where the name is not of ``[a-z0-9_]+``, the file is
    missing or lies outside ``benchmark/reference/``, or a name is not
    defined."""
    name = config.get("reference", "asr")
    where = f"configuration {config_name!r}: reference {name!r}"
    if not isinstance(name, str) or not REFERENCE_NAME.fullmatch(name):
        raise SystemExit(f"{where} is not a name of [a-z0-9_]+")
    home = (BENCH / "reference").resolve()
    path = (home / f"{name}.py").resolve()
    if path.parent != home or not path.is_file():
        raise SystemExit(f"{where}: no file {name}.py in {home}")
    # Imported under its package's name, as ``import`` would, so that the
    # harness and the tests share one module and its state.
    qualified = f"benchmark.reference.{name}"
    mod = sys.modules.get(qualified)
    if mod is None or Path(mod.__file__).resolve() != path:
        spec = importlib.util.spec_from_file_location(qualified, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[qualified] = mod
        spec.loader.exec_module(mod)
    missing = [a for a in REFERENCE_API if not callable(getattr(mod, a, None))]
    if missing:
        raise SystemExit(f"{where}: {path.name} does not define "
                         f"{', '.join(missing)}")
    return mod


def reader(metric: str):
    """The ``read(record)`` function of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``speechcatcher_tpu_torch`` is not ``speechcatcher_tpu``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def per_layer(cell: Cell, record: Dict) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer:
        value: Optional[float] = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
