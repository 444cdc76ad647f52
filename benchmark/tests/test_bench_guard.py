"""The import guard: nothing under benchmark/ imports JAX or the JAX
package, and the reference imports nothing of the program. Names are
compared by their whole top-level part: ``speechcatcher_tpu_torch`` begins
with ``speechcatcher_tpu`` but is not it."""

import ast
from pathlib import Path

import pytest

from benchmark.harness import cell

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "speechcatcher_tpu"}


def imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(imports(path)) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "speechcatcher_tpu_torch" not in set(imports(path))


def test_loaded_modules_compare_by_whole_top_level_name():
    assert cell.forbidden_modules(["speechcatcher_tpu_torch.serve",
                                   "numpy", "jaxtyping"]) == []
    assert cell.forbidden_modules(["speechcatcher_tpu.models", "jax.numpy",
                                   "flax"]) == ["flax", "jax",
                                                "speechcatcher_tpu"]


def test_the_harness_loads_no_jax(tmp_path):
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.run, benchmark.harness.serve, "
            "benchmark.harness.check, benchmark.calibrate; "
            "from benchmark.harness import cell; "
            "import speechcatcher_tpu_torch.serve.server; "
            "print(cell.forbidden_modules(sys.modules))" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
