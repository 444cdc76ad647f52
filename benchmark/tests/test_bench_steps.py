"""The beam loop's step log (what each beam step reads, logged in the
traced run) and the readers built on it: ``mfu.serve``'s decoder rows and
kernel B's roofline; the attention rooflines' kernel names."""

import importlib.util
import time
from pathlib import Path

import pytest

from benchmark.harness import serve, weights
from benchmark.harness.traffic import Traffic
from benchmark.metrics import _common
from benchmark.roofline import kernels, model_flops, peaks
from conftest import tiny_cell, tiny_model

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class StubTrace:
    """The profiler's place in a traced run, on the CPU: the slice's host
    times and a kernel table of its own."""

    def __init__(self, kernel_table):
        self.kernels = kernel_table

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()

    def summary(self):
        return {"t0": self.t0, "t1": self.t1, "window_s": self.t1 - self.t0,
                "busy_s": 0.0, "kernels": self.kernels, "grids": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_the_step_log_follows_each_beam_step(loop):
    cell = tiny_cell(loop, seconds=2.5)
    m = cell.config["model"]
    tree = weights.make_tree(m, cell.config["emission_bias"],
                             cell.config["weights_seed"], "cpu",
                             cell.reference.weight_specs)
    system = serve.System(m, tree, cell.traffic, "cpu")
    trace = StubTrace({"ctc_forward_recursion_kernel<float>": (1, 1.0)})
    out = serve.serve_window(system, Traffic(cell.traffic, cell.seed), cell,
                             trace)
    system.close()
    system.unwatch()
    blocks = out["record"]["blocks"]
    logged = [b for b in blocks if b["stepping"]]
    assert logged and out["counts"]["step_log_s"] > 0
    for b in blocks:
        n = len(b["stepping"])
        assert len(b["olen"]) == len(b["end"]) == len(b["step_t"]) == n
        assert b["beam"] == cell.traffic["beam"]
        assert sorted(b["step_t"]) == b["step_t"]
        # The eager route steps while some stream steps.
        assert all(any(s) for s in b["stepping"])
        for i in range(n - 1):
            for s, on in enumerate(b["stepping"][i]):
                # A stepping stream's prefix grows by one token a step; a
                # stream that stopped keeps its own.
                grown = b["olen"][i + 1][s] - b["olen"][i][s]
                assert grown == (1 if on else 0)
        for s, on in enumerate(b["stepping"][0] if n else []):
            if on:
                assert b["end"][0][s] == b["new_vis"][s]
        assert max(_common.stream_steps(b), default=0) <= n
    assert out["record"]["trace"]["t0"] < out["record"]["trace"]["t1"]


def test_mfu_counts_the_rows_each_stream_stepped():
    m = tiny_model()
    block = {"stepping": [[1, 1, 0], [1, 0, 0], [1, 0, 0]],
             "new_vis": [10, 20, 30], "beam": 2}
    rec = {"config": m, "window_s": 2.0, "audio_samples": 6400,
           "blocks": [block]}
    flops = (10 * model_flops.frame_flops(m)
             + 3 * 2 * model_flops.decoder_row_flops(m, 10)
             + 1 * 2 * model_flops.decoder_row_flops(m, 20))
    assert _common.serve_mfu(rec) == pytest.approx(
        100 * flops / 2.0 / peaks.FP32_FLOPS, rel=1e-12)
    # Without the step log (an untraced run) there is nothing to count.
    assert _common.serve_mfu(dict(rec, blocks=[{"steps": 3}])) is None


def test_ctc_recursion_roofline_counts_the_steps_in_the_slice():
    read = reader("ctc_recursion_roofline")
    block = {"step_t": [0.5, 1.5, 2.5], "olen": [[0, 3], [1, 4], [2, 5]],
             "end": [[5, 8], [5, 8], [6, 9]], "t_cap": 10, "beam": 2,
             "stepping": [[1, 1]] * 3}
    trace = {"t0": 1.0, "t1": 3.0, "grids": {},
             "kernels": {"void ctc_forward_recursion_kernel<float>(x)":
                         (2, 1e-6),
                         "block_attention_kernel": (9, 5.0)}}
    bound = sum(peaks.bound_s(*kernels.ctc_recursion(2, 10, o, e))
                for o, e in (([1, 4], [5, 8]), ([2, 5], [6, 9])))
    rec = {"blocks": [block], "trace": trace}
    assert read(rec) == pytest.approx(100 * bound / 1e-6, rel=1e-12)
    assert read(dict(rec, trace=None)) is None
    no_b = dict(trace, kernels={"block_attention_kernel": (9, 5.0)})
    assert read(dict(rec, trace=no_b)) is None


def test_the_attention_rooflines_tell_a_from_e():
    read = reader("block_attention_roofline")
    m = tiny_model()
    h = m["encoder_heads"]
    grids = {"block_attention_kernel(float const*)": [((4 * h, 1, 1), 2e-6)],
             "rel_block_attention_kernel(float const*)":
                 [((8 * h, 1, 1), 7e-6)]}
    kern = {n: (1, c[0][1]) for n, c in grids.items()}
    rec = {"config": m, "trace": {"grids": grids, "kernels": kern}}
    bound = peaks.bound_s(*kernels.block_attention(
        4, h, m["block_size"] + 2, m["encoder_dim"] // h))
    assert read(rec) == pytest.approx(100 * bound / 2e-6, rel=1e-12)
