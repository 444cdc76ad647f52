"""ESPnet's contextual-block conformer (``encoder_type=
"contextual_block_conformer"``) in the port against the benchmark's plain
reference of it (``benchmark/reference/cb_conformer.py``) on the CPU, at
``tiny_config``'s widths (d 16, 2 heads, 2 layers, block 8 / hop 4 /
look-ahead 2) and ESPnet's default frontend (n_fft and window 512, hop
128), for a macaron and a plain layer and two odd kernel sizes.

The weights are the reference's layout drawn by the benchmark's
``make_tree``, then made non-trivial so that no sub-block is an identity:
every LayerNorm affine, the BatchNorm's statistics and affine away from
identity, every bias non-zero. The cases:

- ``StreamingEncoder.step`` chunk by chunk against the reference's ``run``
  over the same feature chunks: a stream of several chunks and a
  short-segment final;
- ``StreamingEngine`` over four streams of staggered lengths (a sub-block
  one among them), its emitted frames and its finals against the reference
  stream by stream: each final's score and each token's rank gap from the
  reference's ``rescore``; the transformer too, at this frontend's window
  and hop (the engine's tick frontend counts its frames from both);
- the tolerance has teeth: the reference computed in TF32, with ReLU
  feed-forwards, or with the convolution module's BatchNorm left out is
  outside it;
- the tracer's ``encoder.windows`` counts the windows the engine's encodes
  send through the layer stack.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import asr
from benchmark.reference import cb_conformer as cbr
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.models.encoder import StreamingEncoder
from speechcatcher_tpu_torch.serve import engine as engine_module
from speechcatcher_tpu_torch.serve.engine import StreamingEngine
from speechcatcher_tpu_torch.synth import synth_audio
from speechcatcher_tpu_torch.utils.metrics import TRACER

CH = 8192
BEAM = 3
KINDS = [(True, 3), (True, 7), (False, 3), (False, 7)]
KIND_IDS = [f"{'macaron' if m else 'plain'}-k{k}" for m, k in KINDS]

# Emitted frames leave the final LayerNorm at unit scale. Both sides compute
# in float32 with the sums in another order (the port's GEMMs, kernel A's
# plain route and the engine's batched windows against the reference's
# per-window products): their gap reads 4e-7 to 1.2e-6. With TF32 operands
# it reads 9e-4 to 2e-3.
FRAME_ATOL = 2e-5
# A served final's score is a sum over its tokens of log-probabilities of
# a few units each; the float32 gap above moves it by 2e-7 to 2e-6.
SCORE_ATOL = 1e-4
# A served token lies inside its prefix's top BEAM by the reference's joint
# scores; a gap above float32 rounding would mean a token the search could
# not have kept.
RANK_ATOL = 1e-4


# ESPnet's DefaultFrontend, which the AISHELL-1 recipe runs.
FRONTEND = dict(n_fft=512, win_length=512, hop_length=128)


def config(macaron: bool, kernel: int):
    return tiny_config(encoder_type="contextual_block_conformer",
                       macaron_style=macaron, conformer_kernel_size=kernel,
                       **FRONTEND)


def reference_of(cfg):
    return cbr if cfg.encoder_type == "contextual_block_conformer" else asr


def tree_of(cfg, seed: int):
    """The reference's layout drawn from `seed`, then no sub-block an
    identity."""
    m = dataclasses.asdict(cfg)
    tree = weights.make_tree(m, {"eos": 2.0, "blank": 8.0}, seed, "cpu",
                             reference_of(cfg).weight_specs)
    g = torch.Generator().manual_seed(seed)

    def draw(x, lo, hi):
        x.copy_(torch.rand(x.shape, generator=g) * (hi - lo) + lo)

    def walk(node, path=""):
        for k, v in node.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                walk(v, p)
            elif k == "running_mean" or k == "bias":
                v.add_(torch.rand(v.shape, generator=g) * 0.2 - 0.1)
            elif k == "running_var":
                draw(v, 0.5, 2.0)
            elif k == "weight" and ("norm" in path):
                draw(v, 0.5, 1.5)

    walk(tree["encoder"])
    walk(tree["decoder"])
    return m, tree


def model_of(cfg, tree) -> ASRModel:
    return ASRModel.from_numpy(cfg, weights.to_numpy(tree), device="cpu")


def feature_chunks(sizes, seed: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((n, 80)).astype(np.float32))
            for n in sizes]


def port_steps(model: ASRModel, chunks) -> torch.Tensor:
    enc = StreamingEncoder(model.params["encoder"], model.cfg)
    state = enc.init_state()
    out = []
    for i, x in enumerate(chunks):
        y, state = enc.step(x[None], state, i == len(chunks) - 1)
        out.append(y[0])
    return torch.cat(out)


# A stream of several chunks (sub-kernel, block-filling and odd sizes; the
# last is the final) and a first chunk that is final and no longer than a
# block after subsampling (the short segment).
STREAMS = {"chunks": [37, 64, 2, 50, 23], "short": [30]}


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("macaron,kernel", KINDS, ids=KIND_IDS)
def test_encoder_step_matches_the_reference(macaron, kernel, stream):
    cfg = config(macaron, kernel)
    m, tree = tree_of(cfg, 11 + kernel)
    chunks = feature_chunks(STREAMS[stream], 5)
    got = port_steps(model_of(cfg, tree), chunks)
    ref = cbr.Reference(m, tree, "cpu").encoder.run(chunks)
    assert got.shape == ref.shape and got.shape[0] > 0
    if stream == "chunks":
        assert got.shape[0] > cfg.block_size
    assert (got - ref).abs().max() < FRAME_ATOL


def conv_module_without_batch_norm(p, i, x):
    """``asr._conv_module`` with the BatchNorm left out."""
    w1 = p["pointwise_conv1"]["weight"][i][:, :, 0]
    a, b = (x @ w1.t() + p["pointwise_conv1"]["bias"][i]).chunk(2, dim=-1)
    h = a * torch.sigmoid(b)
    dw = p["depthwise_conv"]["weight"][i]
    h = torch.nn.functional.conv1d(
        h.transpose(1, 2), dw, p["depthwise_conv"]["bias"][i],
        padding=(dw.shape[-1] - 1) // 2, groups=dw.shape[0]).transpose(1, 2)
    h = h * torch.sigmoid(h)
    w2 = p["pointwise_conv2"]["weight"][i][:, :, 0]
    return h @ w2.t() + p["pointwise_conv2"]["bias"][i]


FAULTS = {
    "tf32": lambda mp: None,
    "relu_ffn": lambda mp: mp.setattr(cbr, "_swish", torch.relu),
    "no_batch_norm": lambda mp: mp.setattr(asr, "_conv_module",
                                           conv_module_without_batch_norm),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("macaron,kernel", KINDS[::3], ids=KIND_IDS[::3])
def test_the_tolerance_has_teeth(macaron, kernel, fault, monkeypatch):
    cfg = config(macaron, kernel)
    m, tree = tree_of(cfg, 11 + kernel)
    chunks = feature_chunks(STREAMS["chunks"], 5)
    got = port_steps(model_of(cfg, tree), chunks)
    ref = cbr.Reference(m, tree, "cpu")
    FAULTS[fault](monkeypatch)
    if fault == "tf32":
        with cbr.in_tf32():
            bad = ref.encoder.run(chunks)
    else:
        bad = ref.encoder.run(chunks)
    assert (got - bad).abs().max() > 10 * FRAME_ATOL


def _utt(n_chunks: int, extra: int, seed: int) -> np.ndarray:
    n = n_chunks * CH + extra
    return synth_audio(n / 16000 + 0.01, seed)[:n]


# Staggered streams: (first tick, full chunks, tail samples); "short" is a
# sub-block utterance never ticked (the engine's fallback ``finalize``).
SCHEDULE = {"a": (0, 3, 1500), "b": (1, 2, 4000), "c": (2, 4, 300),
            "short": (None, 0, 6000)}


def serve(cfg, tree):
    """The schedule through a 4-slot engine: ticks, the emitted frames of
    each ticked stream before its final, then one finalize_batch."""
    eng = StreamingEngine(model_of(cfg, tree), n_slots=4, beam_size=BEAM,
                          chunk_samples=CH, device="cpu")
    audio = {k: _utt(n, extra, 31 + i)
             for i, (k, (_, n, extra)) in enumerate(sorted(SCHEDULE.items()))}
    slot = {k: eng.acquire_slot() for k in sorted(SCHEDULE)}
    done = {k: 0 for k in SCHEDULE}
    tick = 0
    while any(first is not None and first <= tick and done[k] < n
              for k, (first, n, _) in SCHEDULE.items()):
        feed = {}
        for k, (first, n, _) in SCHEDULE.items():
            if first is not None and first <= tick and done[k] < n:
                feed[slot[k]] = audio[k][done[k] * CH:(done[k] + 1) * CH]
                done[k] += 1
        if feed:
            eng.tick(feed)
        tick += 1
    frames = {k: eng.buffers.enc_out[slot[k], :int(eng.c.buf_len[slot[k]])]
              .clone() for k in SCHEDULE}
    finals = eng.finalize_batch(
        {slot[k]: audio[k][n * CH:] for k, (_, n, _) in SCHEDULE.items()})
    chunks = {k: [audio[k][i * CH:(i + 1) * CH] for i in range(n)]
              + [audio[k][n * CH:]] for k, (_, n, _) in SCHEDULE.items()}
    return {k: finals[slot[k]] for k in SCHEDULE}, frames, chunks


# The transformer beside ESPnet's conformer: the engine's tick frontend at
# this frontend's geometry serves both.
ENGINE_CONFIGS = [config(m, k) for m, k in KINDS] + [
    tiny_config(**FRONTEND)]


@pytest.mark.parametrize("cfg", ENGINE_CONFIGS,
                         ids=KIND_IDS + ["transformer"])
def test_engine_streams_match_the_reference(cfg):
    m, tree = tree_of(cfg, 21 + cfg.conformer_kernel_size)
    finals, frames, chunks = serve(cfg, tree)
    ref = reference_of(cfg).Reference(m, tree, "cpu")
    tokens = 0
    for k in sorted(SCHEDULE):
        enc = ref.encode(chunks[k])
        n = frames[k].shape[0]
        assert n <= enc.shape[0]
        if SCHEDULE[k][0] is not None:
            assert n > 0
            assert (frames[k] - enc[:n]).abs().max() < FRAME_ATOL, k
        yseq, xpos, score = finals[k]
        r = ref.rescore(enc, ref.ctc_logp(enc), yseq, xpos, BEAM)
        tokens += len(yseq) - 1
        assert abs(r.score - score) < SCORE_ATOL, k
        if len(r.token_gaps):
            assert r.token_gaps.max() < RANK_ATOL, k
    assert tokens >= 8


def test_encoder_windows_counts_what_the_engine_encodes(monkeypatch):
    """``encoder.windows`` adds the windows (streams × blocks) of every
    tick encode and final encode: the batch of the layer stack's inputs."""
    cfg = config(True, 3)
    _, tree = tree_of(cfg, 3)
    seen = []
    layers = engine_module.apply_layers_infer

    def counted(layer_params, xs_chunk, *args, **kwargs):
        seen.append(xs_chunk.shape[0] * xs_chunk.shape[1])
        return layers(layer_params, xs_chunk, *args, **kwargs)

    monkeypatch.setattr(engine_module, "apply_layers_infer", counted)
    TRACER.reset()
    TRACER.start()
    try:
        serve(cfg, tree)
    finally:
        TRACER.stop()
    counts = TRACER.export()["counts"]
    TRACER.reset()
    assert sum(seen) > 0
    assert counts["encoder.windows"] == sum(seen)
