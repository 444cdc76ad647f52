"""Flagship conformer fixtures for the PyTorch port.

``python tests/test_torch_conformer_fixture.py`` (on the CPU) blesses
``fixtures/torch_port_conformer_flagship.json`` by the procedure of
``test_torch_flagship_fixture.py``: ``random_params`` of the flagship
conformer (``flagship_config(encoder_type="conformer")``), the EOS +4 /
blank +10 output biases, one seeded 6 s utterance in 0.5 s chunks decoded by
the JAX ``Speech2TextStreaming``, and the first seed whose smallest gap
between the two best expansions in the port's CPU replay is at least 1e-3.
``chip_smoke.py`` replays it on the card; the tier-1 tests here check its
config and weights checksum.

``python tests/test_torch_conformer_fixture.py tokens`` blesses the
token-rich ``fixtures/torch_port_conformer_tokens.json`` the same way with
EOS +2 / blank +8, keeping the first seed whose decode has at least 20
tokens: the long decode through kernel E. It is replayed here on the CPU
and by ``chip_smoke.py`` on the card.

The JAX package's own self-blessed conformer golden
(``fixtures/flagship_conformer_golden.json``, written by
``scripts/bless_conformer_golden.py``) is replayed through the port here on
the CPU: the same JAX ``random_init(seed=7)`` weights carried over with
``params_from_numpy``, the same features, the port's ``process_block``.
"""

from __future__ import annotations

import contextlib
import json
import signal
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":  # run as a script: find the package and helpers
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                    str(Path(__file__).resolve().parent)]

from speechcatcher_tpu_torch.config import ModelConfig, flagship_config
from speechcatcher_tpu_torch.params import params_checksum, random_params

from test_torch_flagship_fixture import BEAM, MIN_GAP, bless

FIXTURE = (Path(__file__).parent / "fixtures"
           / "torch_port_conformer_flagship.json")
TOKENS_FIXTURE = FIXTURE.with_name("torch_port_conformer_tokens.json")
TOKENS_EOS_BIAS, TOKENS_BLANK_BIAS = 2.0, 8.0
MIN_TOKENS = 20
GOLDEN = Path(__file__).parent / "fixtures" / "flagship_conformer_golden.json"
REPLAY_LIMIT_S = 300


def conformer_flagship():
    return flagship_config(encoder_type="conformer")


def _load():
    return json.loads(FIXTURE.read_text())


def test_fixture_config_is_flagship_conformer():
    fx = _load()
    cfg = ModelConfig(**fx["cfg"])
    assert cfg == conformer_flagship()
    assert (cfg.encoder_dim, cfg.encoder_heads, cfg.encoder_layers,
            cfg.conformer_kernel_size) == (512, 8, 18, 31)
    assert fx["beam_size"] == BEAM and fx["min_gap"] >= MIN_GAP
    assert len(fx["yseq"]) == len(fx["xpos"]) >= 2


def test_fixture_weights_checksum_still_matches():
    fx = _load()
    tree = random_params(conformer_flagship(), fx["seed"])
    assert params_checksum(tree) == fx["weights_sha256"]


def test_tokens_fixture_is_a_token_rich_conformer_decode():
    fx = json.loads(TOKENS_FIXTURE.read_text())
    assert ModelConfig(**fx["cfg"]) == conformer_flagship()
    assert fx["beam_size"] == BEAM and fx["min_gap"] >= MIN_GAP
    assert (fx["eos_bias"], fx["blank_bias"]) == (TOKENS_EOS_BIAS,
                                                  TOKENS_BLANK_BIAS)
    assert len(fx["yseq"]) == len(fx["xpos"]) >= MIN_TOKENS
    tree = random_params(conformer_flagship(), fx["seed"])
    assert params_checksum(tree) == fx["weights_sha256"]


def test_port_replays_tokens_fixture():
    """The JAX-blessed token-rich conformer decode, replayed through the
    port's session on the CPU: tokens and positions exact, score within
    rel. 1e-4 (the bless's own rule)."""
    from test_torch_common import bias_outputs, synth_audio
    from test_torch_flagship_fixture import _chunks, _decode

    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

    fx = json.loads(TOKENS_FIXTURE.read_text())
    cfg = conformer_flagship()
    with _time_limit(REPLAY_LIMIT_S):
        tree = bias_outputs(random_params(cfg, fx["seed"]), cfg,
                            fx["eos_bias"], fx["blank_bias"])
        model = ASRModel.from_numpy(cfg, tree, device="cpu")
        session = Speech2TextStreaming(model=model, beam_size=BEAM,
                                       device="cpu")
        audio = synth_audio(fx["audio_seconds"], fx["audio_seed"],
                            rate=cfg.sample_rate)
        yseq, xpos, score = _decode(session, _chunks(audio,
                                                     cfg.sample_rate))
    assert [int(x) for x in yseq] == fx["yseq"]
    assert [int(x) for x in xpos] == fx["xpos"]
    np.testing.assert_allclose(score, fx["score"], rtol=1e-4)


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Fail the test, rather than the whole run, past `seconds`."""
    def expire(signum, frame):
        raise TimeoutError(f"over its own limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def test_port_replays_jax_conformer_golden():
    """Tokens and positions exact; score within rel. 1e-5 (float32 on both
    sides, sums in another order)."""
    import jax
    import torch
    from bless_conformer_golden import BEAM as G_BEAM, build_model

    from speechcatcher_tpu_torch.decode.beam_search import (
        BlockwiseSynchronousBeamSearch,
    )
    from speechcatcher_tpu_torch.models.asr_model import ASRModel

    golden = json.loads(GOLDEN.read_text())
    with _time_limit(REPLAY_LIMIT_S):
        jmodel = build_model()
        cfg = ModelConfig(**golden["cfg"])
        assert cfg == conformer_flagship()
        tree = jax.tree.map(np.asarray, jmodel.params)
        del jmodel
        model = ASRModel.from_numpy(cfg, tree, device="cpu")
        rng = np.random.RandomState(golden["seed"])
        chunks = [rng.randn(1, golden["chunk_t"], cfg.n_mels)
                  .astype(np.float32) for _ in range(golden["n_chunks"])]
        bsbs = BlockwiseSynchronousBeamSearch(model, beam_size=G_BEAM,
                                              ctc_weight=0.3)
        with torch.no_grad():
            for i, chunk in enumerate(chunks):
                bsbs.process_block(torch.from_numpy(chunk),
                                   is_final=i == len(chunks) - 1)
        yseq, xpos, score = bsbs.nbest_hypotheses()[0]
    assert [int(x) for x in yseq] == golden["yseq"]
    assert [int(x) for x in xpos] == golden["xpos"]
    np.testing.assert_allclose(score, golden["score"], rtol=1e-5)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["tokens"]:
        bless(conformer_flagship(), TOKENS_FIXTURE,
              eos_bias=TOKENS_EOS_BIAS, blank_bias=TOKENS_BLANK_BIAS,
              min_tokens=MIN_TOKENS)
    else:
        bless(conformer_flagship(), FIXTURE)
