"""Each cell of BENCHMARK.json on the card, for a short window: the command
a benchmark check runs, its result line and its verdict. Needs an NVIDIA GPU
(``-m cuda``); run on the card with

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card with -m cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "3141592653589", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert result["failed"] == 0
