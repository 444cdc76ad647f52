"""The slice as a whole: the port's Speech2TextStreaming against the JAX
package's on the same weights and the same audio, on the CPU.

Every partial and final result must carry the same token ids and token
positions; the final beam must hold the same sequences, with scores within
rtol 1e-4 (float32 on both sides; JAX's CPU path runs the CTC recursion as
an associative scan, the port sequentially). The precision modes of
``dtype=`` are in ``test_torch_precision.py``."""

import copy

import numpy as np
import pytest

from test_torch_common import bias_outputs, jax_model, synth_audio

from speechcatcher_tpu.streaming import Speech2TextStreaming as JaxSession
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

CONFIGS = {
    "tiny": tiny_config(),
    # Real block geometry (W = 42) at small widths.
    "w42": tiny_config(block_size=40, hop_size=16, look_ahead=16,
                       encoder_dim=32, encoder_heads=4, decoder_dim=32,
                       decoder_heads=4, max_enc_frames=384),
}

# (config, input, eos_commit, use_bbd, seed, seconds, (eos, blank) biases)
CASES = [
    ("tiny", "pcm_chunks", "native", True, 0, 2.0, (0.0, 0.0)),
    ("tiny", "pcm_whole", "native", True, 1, 1.5, (4.0, 3.0)),
    ("tiny", "feat_chunks", "espnet", True, 2, 2.0, (0.0, 0.0)),
    ("tiny", "pcm_chunks", "espnet", False, 3, 2.0, (4.0, 3.0)),
    ("w42", "pcm_chunks", "native", True, 4, 4.0, (4.0, 3.0)),
    ("w42", "feat_whole", "espnet", False, 5, 3.0, (0.0, 0.0)),
    ("w42", "pcm_chunks", "native", False, 6, 4.0, (0.0, 0.0)),
]


def _inputs(kind, audio, frontend):
    if kind.startswith("feat"):
        # Unnormalized log-mel features (T, n_mels) computed once in numpy.
        x = np.asarray(frontend(audio))[0]
        step = 37
    else:
        x, step = audio, 8000
    if kind.endswith("whole"):
        return [x]
    return [x[i:i + step] for i in range(0, len(x), step)]


def _run(session, chunks):
    """Per-chunk (token_ids, token_pos) and the final beam before reset."""
    outs = []
    for c in chunks[:-1]:
        outs.append([r[2:] for r in session(c)])
    reset = session.reset
    session.reset = lambda: None
    try:
        outs.append([r[2:] for r in session(chunks[-1], is_final=True)])
        nbest = session.beam_search.nbest_hypotheses()
    finally:
        session.reset = reset
    session.reset()
    return outs, nbest


@pytest.mark.parametrize(
    "cfg_name,kind,eos_commit,use_bbd,seed,seconds,biases", CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}-{'bbd' if c[3] else 'nobbd'}" for c in CASES])
def test_session_matches_jax(cfg_name, kind, eos_commit, use_bbd, seed,
                             seconds, biases):
    cfg = CONFIGS[cfg_name]
    tree = bias_outputs(random_params(cfg, seed), cfg, *biases)
    jm = jax_model(cfg, copy.deepcopy(tree))
    pm = ASRModel.from_numpy(cfg, tree, device="cpu")
    js = JaxSession(model=jm, beam_size=3, use_bbd=use_bbd)
    ps = Speech2TextStreaming(model=pm, beam_size=3, use_bbd=use_bbd,
                              device="cpu")
    js.beam_search.eos_commit = ps.beam_search.eos_commit = eos_commit
    chunks = _inputs(kind, synth_audio(seconds, seed), pm.frontend)

    j_out, j_nbest = _run(js, chunks)
    p_out, p_nbest = _run(ps, chunks)

    assert p_out == j_out
    assert len(j_nbest[0][0]) > 2  # the decode emitted something
    for (jy, jx, jsc), (py, px, psc) in zip(j_nbest, p_nbest):
        np.testing.assert_array_equal(py, jy)
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_allclose(psc, jsc, rtol=1e-4)

