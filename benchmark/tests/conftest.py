"""Shared pieces of the benchmark's CPU tests: a tiny cell (the port's
``tiny_config`` under a cut-down copy of each traffic file) that the harness
serves on the CPU."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]


def tiny_model(**overrides) -> dict:
    from speechcatcher_tpu_torch.config import tiny_config

    return dataclasses.asdict(tiny_config(**overrides))


def tiny_cell(loop: str = "open", seed: int = 4_000_000_007,
              encoder_type: str = "transformer", seconds: float = 3.0,
              reference: Optional[str] = None):
    """The tiny cell; with `reference`, its configuration names that
    reference module (without, it names none)."""
    from benchmark.harness.cell import Cell
    from benchmark.harness.cell import reference as resolve

    name = "serve-rt64" if loop == "open" else "backlog256"
    traffic = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    traffic.update(pool_size=6, speakers=4, lead_in_s=1.0, grace_s=30.0,
                   trace_seconds=1.0, deck_size=16, bank_size=4,
                   utterance_s={"median": 2.0, "sigma": 0.5, "min": 1.0,
                                "max": 4.0})
    config = {"model": tiny_model(encoder_type=encoder_type),
              "emission_bias": {"eos": 2.0, "blank": 8.0}, "weights_seed": 1}
    if reference is not None:
        config["reference"] = reference
    # The whole window is judged, so that a fault that touches some streams
    # cannot slip past a small sample.
    checks = {"sample": 1000, "min_tokens": 1,
              "limits": {"score_gap": 1e-4, "rank_gap": 1e-3}}
    return Cell(name="tiny", chips=1, config=config, traffic=traffic,
                checks=checks, end_to_end=[], per_layer=[], seed=seed,
                seconds=seconds, trace=False, t_process=time.perf_counter(),
                reference=resolve("tiny", config))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
