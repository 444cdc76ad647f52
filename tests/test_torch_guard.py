"""The port stands alone: no module of speechcatcher_tpu_torch, nor
chip_smoke.py, imports JAX or the JAX package, none imports PyYAML at import
time, and the package imports with JAX and PyYAML blocked."""

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
            if top in ("jax", "jaxlib", "speechcatcher_tpu", "optax",
                       "orbax"):
                bad.append(f"{f.relative_to(ROOT)}: {name}")
    assert not bad, bad


def _import_time_imports(node):
    """Names imported when the module is imported: every import outside a
    function body."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        if isinstance(child, ast.Import):
            for alias in child.names:
                yield alias.name
        elif isinstance(child, ast.ImportFrom) and child.module:
            yield child.module
        else:
            yield from _import_time_imports(child)


def test_yaml_is_imported_only_where_it_is_used():
    """A machine that runs the port may lack PyYAML: no module of the port
    imports it at import time, only the functions that read a yaml file."""
    files = sorted((ROOT / "speechcatcher_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"speechcatcher_tpu_torch/checkpoint.py",
            "speechcatcher_tpu_torch/utils/zoo.py"} <= names
    bad = [f"{f.relative_to(ROOT)}: {name}" for f in files
           for name in _import_time_imports(ast.parse(f.read_text()))
           if name.split(".")[0] == "yaml"]
    assert not bad, bad
    # The check sees an import at module level, in a class body and under
    # a module-level `if` or `try`, and none inside a function.
    seen = list(_import_time_imports(ast.parse(
        "import yaml\n"
        "try:\n    import yaml.a\nexcept ImportError:\n    pass\n"
        "class C:\n    import yaml.b\n"
        "def f():\n    import yaml.c\n")))
    assert seen == ["yaml", "yaml.a", "yaml.b"]


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['speechcatcher_tpu'] = None\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['orbax'] = None\n"
        "import speechcatcher_tpu_torch.streaming\n"
        "import speechcatcher_tpu_torch.decode.scorers\n"
        "import speechcatcher_tpu_torch.ops.kernels._build\n"
        "import speechcatcher_tpu_torch.serve.engine\n"
        "import speechcatcher_tpu_torch.checkpoint\n"
        "import speechcatcher_tpu_torch.utils.zoo\n"
        "import speechcatcher_tpu_torch.recognize\n"
        "import speechcatcher_tpu_torch.endpointing_cli\n"
        "import speechcatcher_tpu_torch.wer\n"
        "import speechcatcher_tpu_torch.decode_kaldidir\n"
        "import speechcatcher_tpu_torch.serve.server\n"
        "import speechcatcher_tpu_torch.serve.vosk_test_client\n"
        "import speechcatcher_tpu_torch.utils.metrics\n"
        "import speechcatcher_tpu_torch.utils.term\n"
        "import speechcatcher_tpu_torch.training\n"
        "import speechcatcher_tpu_torch.data\n"
        "import speechcatcher_tpu_torch.decode.greedy\n"
        "import speechcatcher_tpu_torch.utils.save\n"
        "import speechcatcher_tpu_torch.parallel.mesh\n"
        "import speechcatcher_tpu_torch.parallel.tp\n"
        "import speechcatcher_tpu_torch.parallel.serve_sharding\n"
        "import speechcatcher_tpu_torch.parallel.launch\n"
        "import speechcatcher_tpu_torch.parallel.dryrun\n"
        "from speechcatcher_tpu_torch import load_model, recognize_file\n"
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


def test_packaging_names_the_port():
    """An installed package holds every kernel source the build compiles
    or hashes, and each console script of the port names a function."""
    import fnmatch
    import importlib
    import tomllib

    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = meta["tool"]["setuptools"]["package-data"][
        "speechcatcher_tpu_torch"]
    pkg = ROOT / "speechcatcher_tpu_torch"
    sources = [f.relative_to(pkg).as_posix()
               for f in (pkg / "csrc").iterdir() if f.is_file()]
    assert any(s.endswith(".cuh") for s in sources)
    missing = [s for s in sources
               if not any(fnmatch.fnmatch(s, g) for g in globs)]
    assert not missing, missing
    scripts = {k: v for k, v in meta["project"]["scripts"].items()
               if v.startswith("speechcatcher_tpu_torch.")}
    assert set(scripts) == {
        "speechcatcher_tpu_torch", "speechcatcher_tpu_torch_server",
        "speechcatcher_tpu_torch_compute_wer",
        "speechcatcher_tpu_torch_endpointing",
        "speechcatcher_tpu_torch_decode_kaldidir",
        "speechcatcher_tpu_torch_vosk_client"}
    for target in scripts.values():
        module, func = target.split(":")
        assert callable(getattr(importlib.import_module(module), func))


def test_package_import_is_light():
    """Importing the package loads its config only, none of the models,
    the decoder or the app; the lazy exports load their modules on first
    use."""
    code = (
        "import sys\n"
        "import speechcatcher_tpu_torch as p\n"
        "heavy = [m for m in sys.modules if m.startswith(\n"
        "         'speechcatcher_tpu_torch.') and m != 'speechcatcher_tpu_torch.config']\n"
        "assert not heavy, heavy\n"
        "assert callable(p.Speech2TextStreaming) and 'de_streaming_transformer_m' in p.tags\n"
        "assert 'speechcatcher_tpu_torch.recognize' in sys.modules\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
