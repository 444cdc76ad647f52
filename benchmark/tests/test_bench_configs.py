"""A configuration names the reference module that checks it and draws its
weights: the flagship's resolves to ``asr`` and draws, leaf for leaf, the
tree the harness drew before the weight layout moved into the reference;
a name that no usable module answers stops the run in ``cell.load``, naming
the configuration, before the card or a weight is touched."""

import hashlib
import json
import shutil
import sys
from pathlib import Path

import pytest

from benchmark.harness import cell, weights
from benchmark.reference import asr
from conftest import tiny_model

BENCH = Path(__file__).resolve().parents[1]
WORKLOADS = [w["name"] for w in
             json.loads((BENCH.parent / "BENCHMARK.json").read_text())
             ["workloads"]]

# sha256 over every leaf (its path, dtype, shape and bytes, in sorted-path
# order) of ``make_tree(tiny_config(encoder_type=...), {"eos": 2.0,
# "blank": 8.0}, seed, "cpu")``, as the harness drew it while the layout
# was ``benchmark/harness/weights.py``'s own.
DRAWN = {
    ("transformer", 1):
        "6bbaa2bcd6a8a1d26a8eececf5056f70fa1617881572465f902cdeed80d761b6",
    ("transformer", 4_100_000_001):
        "10297b04a6296e41a17df411658f7660489d4b1c9a747ecfe46269af0888fabb",
    ("conformer", 1):
        "dbf7375e3bd4c280d5ccca83e21b050be36fff4294ef666170baf5fe687e3204",
    ("conformer", 4_100_000_001):
        "f9cd7754c838ed923c685656da8b109a156619b21ef0bb12a4d3b40d8b8a16bd",
}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in leaves(tree):
        a = t.detach().cpu().contiguous().numpy()
        h.update(f"{path} {a.dtype} {a.shape}\n".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_flagship_cells_resolve_to_asr(workload):
    c = cell.load(workload, 4_111_222_333, 1.0, False, 0.0)
    assert "reference" not in c.config
    assert c.reference is asr


@pytest.mark.parametrize("encoder_type,seed", sorted(DRAWN))
def test_the_draw_is_the_one_before_the_layout_moved(encoder_type, seed):
    tree = weights.make_tree(tiny_model(encoder_type=encoder_type),
                             {"eos": 2.0, "blank": 8.0}, seed, "cpu",
                             asr.weight_specs)
    assert digest(tree) == DRAWN[encoder_type, seed]


REJECTED = {"unknown": "no_such_reference", "escapes": "../harness/serve",
            "capital": "Asr", "dot": "asr.v2", "lacks-weight-specs": "partial"}


@pytest.mark.parametrize("name", list(REJECTED.values()), ids=list(REJECTED))
def test_a_reference_that_cannot_check_stops_the_run(name, tmp_path,
                                                     monkeypatch):
    """``run.py`` on a checkout whose configuration names `name` stops in
    ``cell.load`` with a message naming the configuration and the name,
    before it looks for a card or draws a weight."""
    from benchmark import run

    bench = tmp_path / "benchmark"
    for d in ("traffic", "checks", "harness"):
        shutil.copytree(BENCH / d, bench / d)
    (bench / "reference").mkdir()
    (bench / "reference" / "partial.py").write_text(
        "Reference = in_tf32 = object\n")
    w = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    w["workloads"] = [dict(w["workloads"][0], config="broken")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(w))
    config = json.loads((BENCH / "configs" / "de-xl-transformer.json")
                        .read_text())
    (bench / "configs").mkdir()
    (bench / "configs" / "broken.json").write_text(
        json.dumps(dict(config, reference=name)))
    monkeypatch.setattr(cell, "ROOT", tmp_path)
    monkeypatch.setattr(cell, "BENCH", bench)
    # Whatever the loader imports from the scratch checkout leaves with it.
    monkeypatch.setitem(sys.modules, f"benchmark.reference.{name}", None)

    def touched(*args, **kwargs):
        raise AssertionError("touched before the reference was checked")

    monkeypatch.setattr("torch.cuda.is_available", touched)
    monkeypatch.setattr(weights, "make_tree", touched)
    with pytest.raises(SystemExit) as stop:
        run.main(["--workload", w["workloads"][0]["name"], "--seed",
                  "4111222333", "--seconds", "1"])
    assert "configuration 'broken'" in str(stop.value)
    assert repr(name) in str(stop.value)
    if name == "partial":
        assert "weight_specs" in str(stop.value)
        assert "Reference" not in str(stop.value).split("define")[-1]
