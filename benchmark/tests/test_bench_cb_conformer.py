"""The ``aishell-cb-conformer`` configuration and its cell
``cb-conformer.backlog256``: the cell resolves the reference
``cb_conformer``; its weight layout loads into the port and gives, through
the port's session, the reference's encoder frames and scores; its three
readers on hand-made records; its FLOP count by hand; and a tiny traced run
of ESPnet's conformer on the CPU through ``program_trace.py``, correct, with
the program's ``encoder.windows`` counter among its counts."""

import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import cell, weights
from benchmark.harness.traffic import speech_like
from benchmark.reference import cb_conformer
from benchmark.roofline import cb_conformer_flops, kernels, model_flops, peaks
from conftest import tiny_cell, tiny_model
from test_bench_reference import session_final

METRICS = Path(__file__).resolve().parents[1] / "metrics"
CELL = "cb-conformer.backlog256"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cbc_model(macaron: bool = True, kernel: int = 5) -> dict:
    return tiny_model(encoder_type="contextual_block_conformer",
                      macaron_style=macaron, conformer_kernel_size=kernel)


def test_the_cell_resolves_cb_conformer():
    c = cell.load(CELL, 4_111_222_333, 1.0, False, 0.0)
    assert c.config["reference"] == "cb_conformer"
    assert c.reference is cb_conformer
    assert c.config["model"]["encoder_type"] == "contextual_block_conformer"
    # The backlog's readers of the flagship cell, then the cell's own.
    assert [m["name"] for m in c.per_layer] == [
        "engine.tick_ms.backlog", "gemm.share.backlog",
        "block_attention_roofline", "ctc_recursion_roofline",
        "device.idle.backlog", "mfu.cbc", "conv_module.share.cbc"]
    assert [m["name"] for m in c.end_to_end] == ["audio_rate", "setup_s"]
    # The published widths, nothing cut.
    m = c.config["model"]
    assert (m["encoder_dim"], m["encoder_heads"], m["encoder_layers"],
            m["encoder_linear_units"], m["conformer_kernel_size"],
            m["vocab_size"], m["hop_length"]) == (256, 4, 12, 2048, 15,
                                                   4233, 128)
    assert c.config["reduced"] == []


@pytest.mark.parametrize("macaron", [True, False])
@pytest.mark.parametrize("seconds,seed", [(1.3, 3), (3.3, 4_100_000_001)])
def test_the_layout_loads_into_the_port(macaron, seconds, seed):
    """The tree of ``weight_specs`` through ``ASRModel.from_numpy``: the
    port's session emits the reference's frames and the reference scores
    the port's final as served."""
    m = cbc_model(macaron)
    tree = weights.make_tree(m, {"eos": 2.0, "blank": 8.0}, seed, "cpu",
                             cb_conformer.weight_specs)
    assert ("feed_forward_macaron" in tree["encoder"]["layers"]) == macaron
    assert tree["encoder"]["layers"]["conv_module"]["depthwise_conv"][
        "weight"].shape == (m["encoder_layers"], m["encoder_dim"], 1, 5)
    pcm = speech_like(seconds, np.random.default_rng(seed), 16000)
    chunks, yseq, xpos, score, frames = session_final(m, tree, pcm)
    ref = cb_conformer.Reference(m, tree, "cpu")
    enc = ref.encode(chunks)
    assert enc.shape == frames.shape
    assert torch.allclose(enc, frames, atol=2e-5, rtol=1e-5)
    r = ref.rescore(enc, ref.ctc_logp(enc), yseq, xpos, 3)
    assert len(yseq) > 2
    assert abs(r.score - score) < 1e-4
    assert r.token_gaps.max() < 1e-4


def test_the_flops_of_one_layer_by_hand():
    m = dict(cbc_model(True, 15), encoder_dim=256, encoder_linear_units=2048,
             block_size=40)
    w, d = 42, 256
    proj = 4 * (2 * w * d * d)                  # q, k, v, out
    attn = 2 * w * w * d + 2 * w * w * d        # scores, weighted values
    ffn = 2 * w * d * 2048 + 2 * w * 2048 * d   # w_1, w_2
    conv = 2 * w * d * (2 * d) + 2 * w * d * 15 + 2 * w * d * d
    assert cb_conformer_flops.layer_flops(m) == proj + attn + 2 * ffn + conv
    plain = dict(m, macaron_style=False)
    assert cb_conformer_flops.layer_flops(plain) == proj + attn + ffn + conv
    per_frame = (model_flops.subsample_flops_per_frame(m)
                 + m["encoder_layers"] * (proj + attn + 2 * ffn + conv)
                 / m["hop_size"]
                 + 2 * d * m["vocab_size"]
                 + m["decoder_layers"] * 4 * d * d)
    assert cb_conformer_flops.frame_flops(m) == pytest.approx(per_frame,
                                                              rel=1e-12)


def test_mfu_cbc_counts_the_conformer_and_the_rows_that_stepped():
    read = reader("mfu.cbc")
    m = cbc_model()
    block = {"stepping": [[1, 1, 0], [1, 0, 0], [1, 0, 0]],
             "new_vis": [10, 20, 30], "beam": 2}
    rec = {"config": m, "window_s": 2.0, "audio_samples": 6400,
           "blocks": [block]}
    frames = 6400 / (m["hop_length"] * 4)
    flops = (frames * cb_conformer_flops.frame_flops(m)
             + 3 * 2 * model_flops.decoder_row_flops(m, 10)
             + 1 * 2 * model_flops.decoder_row_flops(m, 20))
    assert read(rec) == pytest.approx(100 * flops / 2.0 / peaks.FP32_FLOPS,
                                      rel=1e-12)
    # Without the step log, or for another encoder, nothing to read.
    assert read(dict(rec, blocks=[{"steps": 3}])) is None
    assert read(dict(rec, config=tiny_model())) is None


def test_block_attention_roofline_reads_kernel_a_in_the_conformer():
    """The flagship's reader of kernel A, on a record of the conformer's
    widths (4 heads of 64 over 42-row windows)."""
    read = reader("block_attention_roofline")
    m = cbc_model()
    h = m["encoder_heads"]
    grids = {"void block_attention_kernel<64>(float const*)":
             [((6 * h, 1, 1), 3e-6), ((2 * h, 1, 1), 1e-6)],
             "conv_depthwise2d_forward_kernel": [((8, 1, 1), 9e-6)]}
    kern = {n: (len(c), sum(s for _, s in c)) for n, c in grids.items()}
    rec = {"config": m, "trace": {"grids": grids, "kernels": kern}}
    bound = sum(peaks.bound_s(*kernels.block_attention(
        n, h, m["block_size"] + 2, m["encoder_dim"] // h)) for n in (6, 2))
    assert read(rec) == pytest.approx(100 * bound / 4e-6, rel=1e-12)
    assert read(dict(rec, trace=None)) is None


def test_conv_module_share_cbc_reads_the_depthwise_kernel():
    """The kernel's name as the H100's trace gave it at 15 taps (cut where
    the trace record cuts it), compared as a whole identifier; its
    specialised sibling counts too, a backward kernel does not."""
    read = reader("conv_module.share.cbc")
    kern = {
        "void at::native::(anonymous namespace)::"
        "conv_depthwise2d_forward_kernel_generic<float, int>(torch::"
        "headeronly::detail::GenericPackedTensorAccessor<torch::headeronly::"
        "detail::TensorAccessor<c10::ArrayR": (120, 3e-3),
        "void at::native::(anonymous namespace)::"
        "conv_depthwise2d_forward_kernel<3, float, int>(x)": (2, 1e-3),
        "void block_attention_kernel<64>(float const*)": (4, 2e-3),
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8": (9, 5e-3),
        "conv_depthwise2d_backward_kernel": (1, 7.0),
    }
    rec = {"trace": {"kernels": kern, "grids": {}}}
    total = 3e-3 + 1e-3 + 2e-3 + 5e-3 + 7.0
    assert read(rec) == pytest.approx(100 * 4e-3 / total, rel=1e-12)
    for name in list(kern)[:2]:
        del kern[name]
    assert read(rec) is None
    assert read({"trace": None}) is None


def test_a_traced_run_reports_encoder_windows(monkeypatch):
    """A tiny cell of ESPnet's conformer through ``program_trace.run`` on
    the CPU (the profiler records the CPU alone): correct, and the counts
    hold ``encoder.windows``, the windows the engine's encodes sent through
    the layer stack."""
    from benchmark import program_trace
    from benchmark.harness import trace

    def stop(self):
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    monkeypatch.setattr(trace.Trace, "_profile", staticmethod(
        lambda: torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])))
    monkeypatch.setattr(trace.Trace, "warm", lambda self: None)
    monkeypatch.setattr(trace.Trace, "stop", stop)
    c = tiny_cell("closed", seconds=2.0)
    c.config = dict(c.config, model=cbc_model(), reference="cb_conformer")
    c.reference = cell.reference("tiny", c.config)
    c.trace = True
    out = program_trace.run(c, True, device="cpu")
    assert out["correct"] and out["failed"] == 0
    assert out["counts"]["encoder.windows"] > 0
    assert out["host_ms"]["engine.tick.encode"][0] > 0
