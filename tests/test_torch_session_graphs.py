"""The session's chunk step (``decode.graphs.ChunkStep``) on the CPU.

On the card every chunk of a ``Speech2TextStreaming`` session is up to
three CUDA graphs over an encoder carry at fixed addresses: its input (the
frontend of a waveform or the normalisation of features), the conv
subsampling and the blocks, one graph per static signature. Here the same
programs run eagerly:

- against the port's ``StreamingEncoder.step`` on the same features and
  state, bit-exactly, on every kind of chunk (buffering only, subsampled
  but held, the first blocks, one block, several blocks, a final with a
  short tail, the ``_infer_short`` final, a zero-length flush of carried
  frames, an empty final), at ``tiny`` and at the W = 42 block geometry,
  for the transformer and the conformer;
- against the JAX package's ``StreamingEncoder.step`` on the same numpy
  weights within ``TOL`` (``test_torch_modules.py``'s tolerance);
- the frontend program (a device sample count, the reflect padding as an
  index map) against ``apply_frontend``, bit-exactly, at every final tail
  length of a frame count;
- ``add_positional_encoding`` with a device offset against the host
  offset, bit-exactly, inside the table and at the clamp;
- a property: every signature a decode reaches is in the set
  ``Speech2TextStreaming.capture_graphs`` captures for its chunk size;
- under the dispatch mode of ``test_torch_graph_loop.py`` that raises on
  every host sync, the programs never read the card, both encoders, in
  float32, bfloat16 and int8;
- a session decode through the programs against the JAX session: tokens
  and positions exact, scores within rtol 1e-4.
"""

from __future__ import annotations

import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_common import bias_outputs, jax_config, jax_model, n, t
from test_torch_common import synth_audio
from test_torch_graph_loop import no_host_sync
from test_torch_streaming import _run

from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.decode import graphs
from speechcatcher_tpu_torch.decode.graphs import ChunkInput, ChunkStep
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.models.encoder import StreamingEncoder
from speechcatcher_tpu_torch.ops.layers import (
    add_positional_encoding,
    sinusoidal_pe_table,
)
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

TOL = dict(rtol=1e-4, atol=1e-4)
SCORE_RTOL = 1e-4

CONFIGS = {
    "tiny": tiny_config(),
    # The flagship's block geometry (W = 42) at small widths.
    "w42": tiny_config(block_size=40, hop_size=16, look_ahead=16,
                       encoder_dim=32, encoder_heads=4, decoder_dim=32,
                       decoder_heads=4, max_enc_frames=384),
}

# Feature frames per chunk (the last one final) that end in a chunk of the
# kind named, for the tiny geometry (block 8, hop 4) and the W = 42 one
# (block 40, hop 16); subsampling by 4 in both.
SEQUENCES = {
    "buffer": ([5], [5]),
    "hold": ([5, 20], [5, 20]),
    "first_blocks": ([48], [180]),
    "several_blocks": ([48, 40], [180, 200]),
    "final_tail": ([48, 40, 7], [180, 200, 13]),
    "short_final": ([30], [100]),
    "flush": ([48, 40, 0], [180, 200, 0]),
    "empty_final": ([5, 0], [5, 0]),
}
# The plan kind of the last chunk, and whether it is final.
LAST = {"buffer": ("buffer", False), "hold": ("hold", False),
        "first_blocks": ("blocks", False),
        "several_blocks": ("blocks", False),
        "final_tail": ("blocks", True), "short_final": ("short", True),
        "flush": ("blocks", True), "empty_final": ("empty", True)}


@functools.lru_cache(maxsize=None)
def _model(cfg_name: str, encoder_type: str, seed: int = 3):
    cfg = CONFIGS[cfg_name].replace(encoder_type=encoder_type)
    tree = random_params(cfg, seed)
    return cfg, tree, ASRModel.from_numpy(cfg, tree, device="cpu")


def _chunks(cfg_name: str, kind: str):
    sizes = SEQUENCES[kind][0 if cfg_name == "tiny" else 1]
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    return [(rng.standard_normal((1, size, 80)).astype(np.float32),
             i == len(sizes) - 1 and LAST[kind][1])
            for i, size in enumerate(sizes)]


def _equal(what, got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert torch.equal(got, want), f"{what} differs"


@pytest.mark.parametrize("kind", list(SEQUENCES))
@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_chunk_program_equals_step(cfg_name, encoder_type, kind):
    """Each chunk through the programs equals ``StreamingEncoder.step`` on
    the same features and state: the emitted frames and every leaf of the
    next state, to the last bit."""
    _, _, model = _model(cfg_name, encoder_type)
    chunk = ChunkStep(model)
    ref = StreamingEncoder(model.params["encoder"], model.cfg, model.enc_pe)
    state = ref.init_state()
    plans = []
    for feats, final in _chunks(cfg_name, kind):
        ys, state = ref.step(t(feats), state, final)
        start = chunk.enc_len
        plans.append(chunk.step(ChunkInput("normalized", t(feats)), final))
        _equal("frames", chunk.ring[:, start:chunk.enc_len], ys)
        got = chunk.state()
        if final:
            assert state is None
            continue
        for name in ("buf_before", "buf_after", "prev_addin", "past_ctx"):
            a, b = getattr(got, name), getattr(state, name)
            assert (a is None) == (b is None), name
            if a is not None:
                _equal(name, a, b)
        assert got.n_processed_blocks == state.n_processed_blocks
    assert (plans[-1].kind, plans[-1].is_final) == LAST[kind]
    if kind == "several_blocks":
        assert plans[-1].block_num > 1
    if kind == "first_blocks":
        assert plans[-1].first_chunk and plans[-1].block_num == 1


@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_chunk_program_matches_jax(cfg_name, encoder_type):
    """The programs' emitted frames against the JAX package's
    ``StreamingEncoder.step`` on the same numpy weights and features, over
    a stream that goes through every kind of chunk, and over a short
    final."""
    from speechcatcher_tpu.models.encoder import StreamingEncoder as JE

    cfg, tree, model = _model(cfg_name, encoder_type)
    import jax

    jparams = jax.tree.map(jnp.asarray, tree["encoder"])
    for kind in ("final_tail", "short_final"):
        sizes = [5, 20] + SEQUENCES[kind][0 if cfg_name == "tiny" else 1]
        rng = np.random.default_rng(7)
        je = JE(jparams, jax_config(cfg))
        js = je.init_state()
        chunk = ChunkStep(model)
        for i, size in enumerate(sizes):
            final = i == len(sizes) - 1
            feats = rng.standard_normal((1, size, 80)).astype(np.float32)
            jy, js = je.step(jnp.asarray(feats), js, final)
            start = chunk.enc_len
            chunk.step(ChunkInput("normalized", t(feats)), final)
            got = n(chunk.ring[:, start:chunk.enc_len])
            assert got.shape == jy.shape, (kind, i)
            np.testing.assert_allclose(got, n(jy), **TOL)


def test_frontend_program_equals_apply_frontend():
    """The frontend program of a frame count (the sample count a device
    integer) equals ``apply_frontend`` at every final length of that
    frame count, and on streaming chunks, to the last bit; so do the
    normalisation program and ``normalize_only``."""
    _, _, model = _model("tiny", "transformer")
    s2t = Speech2TextStreaming(model=model, beam_size=2, device="cpu")
    chunk = s2t.beam_search.chunk
    audio = synth_audio(1.0, 11)
    hop = model.cfg.hop_length
    cases = [(audio[:n], None, True) for n in range(3200, 3200 + hop, 7)]
    cases += [(audio[:n], {"waveform_buffer": audio[:320]}, final)
              for n in (500, 4000, 8000) for final in (False, True)]
    for speech, states, final in cases:
        want, _ = s2t.apply_frontend(speech, states, final)
        source, _ = s2t._wave_input(speech, states, final)
        _input_program(chunk, source)
        _equal("features", chunk.carry.raw[:, :want.shape[1]], want)
    feats = np.random.default_rng(2).standard_normal((40, 80)).astype(
        np.float32)
    _input_program(chunk, ChunkInput("features", feats))
    _equal("normalized", chunk.carry.raw[:, :40],
           model.frontend.normalize_only(feats))


def _input_program(chunk: ChunkStep, source: ChunkInput) -> None:
    """Only the input's program, into the front of a zeroed carry."""
    chunk.reset()
    key = source.key(chunk.cfg.hop_length)
    chunk.ints.put(np.array([0, 0, 0, 0, 0, 0, len(source.data)], np.int32))
    chunk._input(key).put(chunk._padded(key, source.data))
    chunk._program(key)(chunk.carry, chunk.ring)


def test_device_offset_positional_encoding_equals_host_offset():
    rng = np.random.default_rng(4)
    pe = t(sinusoidal_pe_table(16, 64))
    x = t(rng.standard_normal((2, 10, 16)).astype(np.float32))
    # Inside the table, its last window, and past it (the start clamps).
    for offset in (0, 7, 54, 55, 63, 200):
        _equal(f"offset {offset}",
               add_positional_encoding(x, pe, torch.tensor(offset)),
               add_positional_encoding(x, pe, offset))


@functools.lru_cache(maxsize=None)
def _keys(chunk_samples: int) -> frozenset:
    _, _, model = _model("w42", "transformer")
    s2t = Speech2TextStreaming(model=model, beam_size=2, device="cpu")
    return frozenset(s2t.graph_keys(chunk_samples))


@settings(max_examples=40, deadline=None)
@given(chunk_samples=st.sampled_from([2048, 4096, 8000, 8192]),
       n_samples=st.integers(1, 16000 * 5))
def test_capture_set_covers_every_reachable_signature(chunk_samples,
                                                      n_samples):
    """A decode of an utterance of `n_samples` samples in chunks of
    `chunk_samples` (the last one final) reaches only signatures that
    ``graph_keys(chunk_samples)`` holds (programs and beam blocks skipped:
    the signatures are host arithmetic)."""
    _, _, model = _model("w42", "transformer")
    s2t = Speech2TextStreaming(model=model, beam_size=2, device="cpu")
    chunk = s2t.beam_search.chunk
    reached = set()

    def program(key):
        reached.add(key)
        return lambda carry, ring: None

    chunk._program = program
    s2t.beam_search._decode_one_block = lambda *a, **k: None
    audio = np.zeros(n_samples, np.float32)
    for i in range(0, n_samples, chunk_samples):
        s2t(audio[i:i + chunk_samples],
            is_final=i + chunk_samples >= n_samples)
    assert reached <= _keys(chunk_samples), reached - _keys(chunk_samples)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
def test_chunk_programs_never_sync(encoder_type, dtype):
    """Every program a decode runs (frontend, subsampling, blocks of every
    kind, the normalisation) runs under the host-sync guard."""
    cfg = tiny_config(encoder_type=encoder_type)
    model = ASRModel.random_init(cfg, seed=3, device="cpu")
    s2t = Speech2TextStreaming(model=model, beam_size=2, device="cpu",
                               dtype=dtype)
    chunk = s2t.beam_search.chunk
    make = chunk._program
    ran = []

    def guarded(key):
        program = make(key)

        def run(carry, ring):
            with pytest.MonkeyPatch.context() as mp, no_host_sync(mp):
                program(carry, ring)
            ran.append(key[0] if key[0] != "blocks" else key[1].kind)
        return run

    chunk._program = guarded
    audio = synth_audio(1.2, 9)
    for i in range(0, len(audio), 4096):
        s2t(audio[i:i + 4096], is_final=i + 4096 >= len(audio))
    s2t(audio[:3000], is_final=True)           # an _infer_short final
    s2t(np.random.default_rng(1).standard_normal((60, 80)).astype(
        np.float32), is_final=True)
    assert {"frontend", "normalize", "subsample", "blocks",
            "short"} <= set(ran)


@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
def test_session_through_the_programs_matches_jax(encoder_type):
    """A w42 session decode, 0.5 s chunks, through the chunk programs:
    tokens and positions equal the JAX session's, scores within
    SCORE_RTOL."""
    from speechcatcher_tpu.streaming import Speech2TextStreaming as JaxSession

    cfg = CONFIGS["w42"].replace(encoder_type=encoder_type)
    tree = bias_outputs(random_params(cfg, 8), cfg, 4.0, 3.0)
    sessions = [
        JaxSession(model=jax_model(cfg, copy.deepcopy(tree)), beam_size=3),
        Speech2TextStreaming(
            model=ASRModel.from_numpy(cfg, tree, device="cpu"), beam_size=3,
            device="cpu")]
    audio = synth_audio(3.3, 8)
    chunks = [audio[i:i + 8000] for i in range(0, len(audio), 8000)]
    outs = [_run(s2t, chunks) for s2t in sessions]
    (j_out, j_nbest), (p_out, p_nbest) = outs
    assert p_out == j_out
    assert len(j_nbest[0][0]) > 2
    for (jy, jx, jsc), (py, px, psc) in zip(j_nbest, p_nbest):
        np.testing.assert_array_equal(py, jy)
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_allclose(psc, jsc, rtol=SCORE_RTOL)


def test_cpu_session_captures_nothing():
    """A decode on the CPU captures nothing: the programs run eagerly, and
    ``capture_graphs`` there only counts the signatures."""
    _, _, model = _model("tiny", "transformer")
    s2t = Speech2TextStreaming(model=model, beam_size=2, device="cpu")
    before = len(graphs.CAPTURED)
    assert s2t.capture_graphs(8000) == len(s2t.graph_keys(8000)) > 0
    s2t(synth_audio(0.7, 3), is_final=True)
    assert len(graphs.CAPTURED) == before and not s2t.beam_search.chunk._graphs


def test_websocket_demo_is_the_ports_copy():
    """The port ships its own browser demo page: the JAX package's page,
    its comment, title and heading naming the port, the script the same."""
    from pathlib import Path

    import speechcatcher_tpu
    import speechcatcher_tpu_torch

    def page(pkg):
        return (Path(pkg.__file__).parent / "serve"
                / "websocket_demo.html").read_text()

    jax_page, port_page = page(speechcatcher_tpu), page(speechcatcher_tpu_torch)
    assert "<title>speechcatcher_tpu_torch live demo</title>" in port_page
    assert "speechcatcher_tpu_torch websocket server" in port_page
    script = jax_page[jax_page.index("<body>"):].replace(
        "speechcatcher_tpu —", "speechcatcher_tpu_torch —")
    assert port_page[port_page.index("<body>"):] == script


def test_utterance_past_the_capacity_raises():
    """A chunk whose frames would overflow the encoder ring (max_enc_frames)
    raises the decode state's capacity error before any program runs."""
    _, _, model = _model("tiny", "transformer")
    s2t = Speech2TextStreaming(model=model, beam_size=2, device="cpu")
    frames = model.cfg.max_enc_frames * model.cfg.subsample
    with pytest.raises(RuntimeError, match="too long for decode state"):
        s2t(synth_audio((frames + 400) * 160 / 16000, 5), is_final=True)
    assert s2t.beam_search.chunk.enc_len == 0
