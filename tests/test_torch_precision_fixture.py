"""Flagship precision fixture for the PyTorch port, blessed by the JAX package.

``python tests/test_torch_precision_fixture.py`` (on the CPU) draws
``random_params(flagship_config(), seed)``, adds the output biases of the
token-rich fixture (EOS +2, blank +8, so that tokens are emitted), and
writes ``fixtures/torch_port_precision_flagship.json``:

- the JAX ``Speech2TextStreaming`` in ``dtype="bfloat16"`` and in
  ``dtype="int8-all"`` over one seeded 6 s utterance in 0.5 s chunks: tokens,
  token positions, score, and for every beam step the index of the best
  candidate and its lead over the second (from the port's own CPU replay,
  which must first reproduce the JAX decode). It keeps the first seed whose
  smallest lead in both modes is at least 1e-3, so that a bfloat16 GEMM that
  sums in another order on another device cannot flip a token;
- the JAX ``StreamingEngine`` in the serving default (bfloat16 weights by
  ``cast_params``; decoder cache, CTC log-prob ring and emitted-frame ring in
  bfloat16) serving three seeded streams of 3, 4 and 5 s over the mu-law
  wire with ``chip_smoke.drive_engine``: each stream's final tokens, token
  positions and score. The port's engine must first reproduce them.

``chip_smoke.py`` replays the fixture on the card. The tests here check the
fixture's config and weights checksum and replay all of it through the port
on the CPU, exactly.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":  # run as a script: find the package and helpers
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                    str(Path(__file__).resolve().parent)]

from speechcatcher_tpu_torch.config import ModelConfig, flagship_config
from speechcatcher_tpu_torch.params import params_checksum, random_params

from test_torch_conformer_fixture import _time_limit
from test_torch_flagship_fixture import (
    AUDIO_SECONDS,
    BEAM,
    CHUNK_SECONDS,
    MIN_GAP,
    TOKENS_BLANK_BIAS,
    TOKENS_EOS_BIAS,
    _chunks,
    _decode,
    _port_decode_with_steps,
)

FIXTURE = (Path(__file__).parent / "fixtures"
           / "torch_port_precision_flagship.json")
SESSION_MODES = ("bfloat16", "int8-all")
MIN_TOKENS = 10
SECONDS, STARTS = (3.0, 4.0, 5.0), (0, 1, 2)
N_SLOTS, CHUNK, AUDIO_SEED0 = 3, 8192, 900
SERVING = dict(cache_dtype="bfloat16", ctc_ring_dtype="bfloat16",
               enc_ring_dtype="bfloat16")
REPLAY_LIMIT_S = 600
# Both sides round to bfloat16 at the same places and accumulate in float32,
# in another order: a stored value that lands on the other side of a rounding
# boundary moves by one bfloat16 ulp (0.03 at a log-prob of -8 in the CTC
# ring), so final scores of -20 to -60 agree to 1e-3, not the 1e-5 of
# float32 storage (seen at blessing: up to 3e-5).
SCORE_RTOL = 1e-3


def _load():
    return json.loads(FIXTURE.read_text())


def _biased_tree(fx):
    cfg = ModelConfig(**fx["cfg"])
    tree = random_params(cfg, fx["seed"])
    assert params_checksum(tree) == fx["weights_sha256"]
    tree["decoder"]["output_layer"]["bias"][cfg.eos_id] += np.float32(
        fx["eos_bias"])
    tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += np.float32(
        fx["blank_bias"])
    return cfg, tree


def test_precision_fixture_config_is_flagship():
    fx = _load()
    assert ModelConfig(**fx["cfg"]) == flagship_config()
    assert (fx["eos_bias"], fx["blank_bias"]) == (TOKENS_EOS_BIAS,
                                                  TOKENS_BLANK_BIAS)
    assert fx["beam_size"] == BEAM and set(fx["sessions"]) == set(
        SESSION_MODES)
    for ref in fx["sessions"].values():
        assert len(ref["yseq"]) == len(ref["xpos"]) >= MIN_TOKENS
        assert min(gap for _, gap in ref["steps"]) >= MIN_GAP
    ex = fx["engine"]
    assert (ex["n_slots"], ex["chunk_samples"]) == (N_SLOTS, CHUNK)
    assert len(ex["finals"]) == len(ex["streams"]) == len(SECONDS)
    assert all(len(f["yseq"]) == len(f["xpos"]) >= 2 for f in ex["finals"])


def test_precision_fixture_weights_checksum_still_matches():
    fx = _load()
    assert params_checksum(random_params(flagship_config(), fx["seed"])) \
        == fx["weights_sha256"]


def _engine_streams(cfg):
    import chip_smoke

    return chip_smoke.engine_streams(len(SECONDS), SECONDS, STARTS, 0,
                                     AUDIO_SEED0, rate=cfg.sample_rate,
                                     mulaw=True)


def _port_engine_finals(cfg, tree):
    import chip_smoke
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.ops.layers import cast_params
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    model = ASRModel.from_numpy(cfg.replace(**SERVING), tree, device="cpu")
    model.params = cast_params(model.params)
    engine = StreamingEngine(model, n_slots=N_SLOTS, beam_size=BEAM,
                             chunk_samples=CHUNK, device="cpu")
    return chip_smoke.drive_engine(engine, _engine_streams(cfg), CHUNK)[0]


def test_port_replays_the_precision_fixture_sessions():
    """Tokens, positions and every beam step's best candidate exact; score
    within SCORE_RTOL."""
    import torch

    from speechcatcher_tpu_torch.synth import synth_audio

    fx = _load()
    with _time_limit(REPLAY_LIMIT_S), torch.no_grad():
        cfg, tree = _biased_tree(fx)
        chunks = _chunks(synth_audio(fx["audio_seconds"], fx["audio_seed"],
                                     rate=cfg.sample_rate), cfg.sample_rate)
        for dtype, ref in fx["sessions"].items():
            (yseq, xpos, score), steps = _port_decode_with_steps(
                cfg, tree, chunks, dtype)
            assert [int(x) for x in yseq] == ref["yseq"], dtype
            assert [int(x) for x in xpos] == ref["xpos"], dtype
            np.testing.assert_allclose(score, ref["score"], rtol=SCORE_RTOL)
            assert [b for b, _ in steps] == [b for b, _ in ref["steps"]]


def test_port_replays_the_precision_fixture_engine():
    import torch

    fx = _load()
    with _time_limit(REPLAY_LIMIT_S), torch.no_grad():
        cfg, tree = _biased_tree(fx)
        finals = _port_engine_finals(cfg, tree)
    for k, ref in enumerate(fx["engine"]["finals"]):
        yseq, xpos, score = finals[k]
        assert yseq.tolist() == ref["yseq"], k
        assert xpos.tolist() == ref["xpos"], k
        np.testing.assert_allclose(score, ref["score"], rtol=SCORE_RTOL)


def bless(seeds=range(8)):
    import chip_smoke
    from test_torch_common import bias_outputs, jax_model, synth_audio

    import speechcatcher_tpu.ops.layers as J
    from speechcatcher_tpu.serve.engine import StreamingEngine as JaxEngine
    from speechcatcher_tpu.streaming import Speech2TextStreaming

    cfg = flagship_config()
    for seed in seeds:
        tree = random_params(cfg, seed)
        checksum = params_checksum(tree)
        biased = bias_outputs(copy.deepcopy(tree), cfg, TOKENS_EOS_BIAS,
                              TOKENS_BLANK_BIAS)
        audio = synth_audio(AUDIO_SECONDS, seed, rate=cfg.sample_rate)
        chunks = _chunks(audio, cfg.sample_rate)
        sessions = {}
        for dtype in SESSION_MODES:
            yseq, xpos, score = _decode(
                Speech2TextStreaming(
                    model=jax_model(cfg, copy.deepcopy(biased)),
                    beam_size=BEAM, dtype=dtype), chunks)
            (p_yseq, p_xpos, p_score), steps = _port_decode_with_steps(
                cfg, biased, chunks, dtype)
            tokens_same = (np.array_equal(yseq, p_yseq)
                           and np.array_equal(xpos, p_xpos))
            same = tokens_same and (abs(p_score - score)
                                    <= SCORE_RTOL * max(1.0, abs(score)))
            min_gap = min(g for _, g in steps) if steps else float("inf")
            print(f"seed {seed} {dtype}: {len(yseq)} tokens, score "
                  f"{score:.6f} (port {p_score:.6f}, tokens equal "
                  f"{tokens_same}), min gap {min_gap:.3g} over {len(steps)} "
                  f"steps")
            if not (same and min_gap >= MIN_GAP and len(yseq) >= MIN_TOKENS):
                break
            sessions[dtype] = {
                "yseq": [int(x) for x in yseq], "xpos": [int(x) for x in xpos],
                "score": float(score), "steps": [list(s) for s in steps]}
        if len(sessions) < len(SESSION_MODES):
            continue
        jm = jax_model(cfg.replace(**SERVING), copy.deepcopy(biased))
        jm.params = J.cast_params(jm.params)
        jax_finals, _, _ = chip_smoke.drive_engine(
            JaxEngine(jm, n_slots=N_SLOTS, beam_size=BEAM,
                      chunk_samples=CHUNK), _engine_streams(cfg), CHUNK)
        port_finals = _port_engine_finals(cfg, biased)
        for k in range(len(SECONDS)):
            (jy, jx, js), (py, px, ps) = jax_finals[k], port_finals[k]
            print(f"engine stream {k}: {len(jy)} tokens, score {js:.6f} "
                  f"(port {ps:.6f})")
            assert np.array_equal(jy, py) and np.array_equal(jx, px), k
            assert abs(ps - js) <= SCORE_RTOL * max(1.0, abs(js)), k
        FIXTURE.write_text(json.dumps({
            "cfg": dataclasses.asdict(cfg),
            "seed": seed,
            "weights_sha256": checksum,
            "eos_bias": TOKENS_EOS_BIAS,
            "blank_bias": TOKENS_BLANK_BIAS,
            "beam_size": BEAM,
            "audio_seed": seed,
            "audio_seconds": AUDIO_SECONDS,
            "chunk_seconds": CHUNK_SECONDS,
            "sessions": sessions,
            "engine": {
                "n_slots": N_SLOTS,
                "chunk_samples": CHUNK,
                "audio_seed0": AUDIO_SEED0,
                "wire": "mulaw",
                "streams": [{"seconds": s, "start": t}
                            for s, t in zip(SECONDS, STARTS)],
                "finals": [{"yseq": jax_finals[k][0].tolist(),
                            "xpos": jax_finals[k][1].tolist(),
                            "score": jax_finals[k][2]}
                           for k in range(len(SECONDS))],
            },
        }, indent=1) + "\n")
        print(f"wrote {FIXTURE}")
        return
    raise SystemExit("no seed met the criteria")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    bless()
