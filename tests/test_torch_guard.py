"""The port stands alone: no module of speechcatcher_tpu_torch, nor
chip_smoke.py, imports JAX or the JAX package, and the package imports with
JAX blocked."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_jax_package_imports():
    files = sorted((ROOT / "speechcatcher_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "speechcatcher_tpu", "optax"):
                bad.append(f"{f.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['speechcatcher_tpu'] = None\n"
        "import speechcatcher_tpu_torch.streaming\n"
        "import speechcatcher_tpu_torch.decode.scorers\n"
        "import speechcatcher_tpu_torch.ops.kernels._build\n"
        "import speechcatcher_tpu_torch.serve.engine\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card the smoke run exits non-zero and prints no result,
    whether beside the package or alone in a directory."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
