"""Flagship fixture for the PyTorch port, blessed by the JAX package.

``python tests/test_torch_flagship_fixture.py`` (on the CPU) draws
``random_params(flagship_config(), seed)``, adds the EOS +4 / blank +10
output biases, decodes one seeded 6 s utterance in 0.5 s chunks with the JAX
``Speech2TextStreaming`` and writes tokens, token positions and the score to
``fixtures/torch_port_flagship.json``. It keeps the first seed whose smallest
gap between the two best expansions over all beam steps is at least 1e-3, so
that float noise on another device cannot flip a token; the gaps come from
the port's own CPU replay, which must first reproduce the JAX decode.
``chip_smoke.py`` replays the fixture on the card.

``python tests/test_torch_flagship_fixture.py tokens`` blesses a second,
token-rich fixture, ``fixtures/torch_port_flagship_tokens.json``, the same
way with smaller biases (EOS +2, blank +8) and keeps the first seed whose
decode also emits at least 15 tokens: a beam step per token, so it is the
decode that runs the CTC recursion kernel most.

The tier-1 tests here check only what is cheap: the fixture's config and
the checksum of the weights it was blessed with.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":  # run as a script: find the package and helpers
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                    str(Path(__file__).resolve().parent)]

from speechcatcher_tpu_torch.config import ModelConfig, flagship_config
from speechcatcher_tpu_torch.params import params_checksum, random_params

FIXTURE = Path(__file__).parent / "fixtures" / "torch_port_flagship.json"
TOKENS_FIXTURE = FIXTURE.with_name("torch_port_flagship_tokens.json")
TOKENS_EOS_BIAS, TOKENS_BLANK_BIAS = 2.0, 8.0
MIN_TOKENS = 15
BEAM = 5
AUDIO_SECONDS = 6.0
CHUNK_SECONDS = 0.5
EOS_BIAS, BLANK_BIAS = 4.0, 10.0
MIN_GAP = 1e-3


def _load(path=FIXTURE):
    return json.loads(path.read_text())


def test_fixture_config_is_flagship():
    fx = _load()
    assert ModelConfig(**fx["cfg"]) == flagship_config()
    assert fx["beam_size"] == BEAM and fx["min_gap"] >= MIN_GAP
    assert len(fx["yseq"]) == len(fx["xpos"]) >= 2


def test_fixture_weights_checksum_still_matches():
    fx = _load()
    tree = random_params(flagship_config(), fx["seed"])
    assert params_checksum(tree) == fx["weights_sha256"]


def test_tokens_fixture_config_is_flagship_and_token_rich():
    fx = _load(TOKENS_FIXTURE)
    assert ModelConfig(**fx["cfg"]) == flagship_config()
    assert fx["beam_size"] == BEAM and fx["min_gap"] >= MIN_GAP
    assert (fx["eos_bias"], fx["blank_bias"]) == (TOKENS_EOS_BIAS,
                                                  TOKENS_BLANK_BIAS)
    assert len(fx["yseq"]) == len(fx["xpos"]) >= MIN_TOKENS
    assert fx["n_steps"] >= MIN_TOKENS   # a beam step per token at least


def test_tokens_fixture_weights_checksum_still_matches():
    fx = _load(TOKENS_FIXTURE)
    tree = random_params(flagship_config(), fx["seed"])
    assert params_checksum(tree) == fx["weights_sha256"]


def _chunks(audio, rate):
    step = int(CHUNK_SECONDS * rate)
    return [audio[i:i + step] for i in range(0, len(audio), step)]


def _decode(session, chunks):
    """Stream the chunks; the best hypothesis before the final reset."""
    for c in chunks[:-1]:
        session(c)
    reset = session.reset
    session.reset = lambda: None
    try:
        session(chunks[-1], is_final=True)
        best = session.beam_search.nbest_hypotheses()[0]
    finally:
        session.reset = reset
    session.reset()
    return best


def _port_decode_with_steps(cfg, tree, chunks, dtype="float32"):
    """The port's CPU decode in the precision mode `dtype`: the best
    hypothesis and, for every beam step, (index of the best candidate of
    the global top-B selection, its lead over the second)."""
    import chip_smoke
    import speechcatcher_tpu_torch.decode.beam_search as bs
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

    model = ASRModel.from_numpy(cfg, tree, device="cpu")
    session = Speech2TextStreaming(model=model, beam_size=BEAM, device="cpu",
                                   dtype=dtype)
    steps = []
    with chip_smoke.beam_step_trace(bs, BEAM, steps):
        best = _decode(session, chunks)
    return best, steps


def bless(cfg=None, fixture=FIXTURE, seeds=range(8), eos_bias=EOS_BIAS,
          blank_bias=BLANK_BIAS, min_tokens=2):
    """Bless `fixture` for `cfg` (default: the flagship transformer) with
    the given output biases, from the first seed whose decode has at least
    `min_tokens` tokens and meets the gap rule."""
    import copy

    from test_torch_common import bias_outputs, jax_model, synth_audio

    from speechcatcher_tpu.streaming import Speech2TextStreaming

    cfg = cfg or flagship_config()
    for seed in seeds:
        tree = random_params(cfg, seed)
        checksum = params_checksum(tree)
        biased = bias_outputs(copy.deepcopy(tree), cfg, eos_bias, blank_bias)
        audio = synth_audio(AUDIO_SECONDS, seed, rate=cfg.sample_rate)
        chunks = _chunks(audio, cfg.sample_rate)
        yseq, xpos, score = _decode(
            Speech2TextStreaming(model=jax_model(cfg, biased),
                                 beam_size=BEAM), chunks)
        (p_yseq, p_xpos, p_score), steps = _port_decode_with_steps(
            cfg, biased, chunks)
        gaps = [gap for _, gap in steps]
        same = (np.array_equal(yseq, p_yseq) and np.array_equal(xpos, p_xpos)
                and abs(p_score - score) <= 1e-4 * max(1.0, abs(score)))
        min_gap = min(gaps) if gaps else float("inf")
        print(f"seed {seed}: {len(yseq)} tokens, score {score:.6f}, "
              f"port equal {same}, min gap {min_gap:.3g} over "
              f"{len(gaps)} steps")
        if same and min_gap >= MIN_GAP and len(yseq) >= min_tokens:
            import dataclasses

            fixture.write_text(json.dumps({
                "cfg": dataclasses.asdict(cfg),
                "seed": seed,
                "weights_sha256": checksum,
                "eos_bias": eos_bias,
                "blank_bias": blank_bias,
                "beam_size": BEAM,
                "audio_seed": seed,
                "audio_seconds": AUDIO_SECONDS,
                "chunk_seconds": CHUNK_SECONDS,
                "yseq": [int(x) for x in yseq],
                "xpos": [int(x) for x in xpos],
                "score": float(score),
                "min_gap": min_gap,
                "n_steps": len(gaps),
            }, indent=1) + "\n")
            print(f"wrote {fixture}")
            return
    raise SystemExit("no seed met the gap criterion")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["tokens"]:
        bless(fixture=TOKENS_FIXTURE, eos_bias=TOKENS_EOS_BIAS,
              blank_bias=TOKENS_BLANK_BIAS, min_tokens=MIN_TOKENS)
    else:
        bless()
