"""Flagship engine fixture for the PyTorch port, blessed by the JAX engine.

``python tests/test_torch_engine_fixture.py`` (on the CPU) takes the weights
and EOS/blank output biases of ``fixtures/torch_port_flagship.json``, serves
three seeded streams of 3, 4 and 5 s (staggered by one tick each, the first
in int16) through the JAX ``StreamingEngine`` at flagship width (beam 5,
8192-sample chunks, 3 slots) with ``chip_smoke.drive_engine``, and writes
each stream's final tokens, token positions and score to
``fixtures/torch_port_engine_flagship.json``. The port's engine must first
reproduce the JAX finals on the CPU. ``chip_smoke.py`` replays the fixture
on the card.

The tier-1 tests here check only what is cheap: the fixture's config and
the checksum of the weights it was blessed with.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

if __name__ == "__main__":  # run as a script: find the package and helpers
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                    str(Path(__file__).resolve().parent)]

from speechcatcher_tpu_torch.config import ModelConfig, flagship_config
from speechcatcher_tpu_torch.params import params_checksum, random_params

FIXTURES = Path(__file__).parent / "fixtures"
FIXTURE = FIXTURES / "torch_port_engine_flagship.json"
WEIGHTS = FIXTURES / "torch_port_flagship.json"
SECONDS, STARTS = (3.0, 4.0, 5.0), (0, 1, 2)
N_SLOTS, BEAM, CHUNK, INT16_EVERY, AUDIO_SEED0 = 3, 5, 8192, 2, 900


def _load():
    return json.loads(FIXTURE.read_text())


def test_engine_fixture_config_is_flagship():
    fx = _load()
    assert ModelConfig(**fx["cfg"]) == flagship_config()
    assert (fx["beam_size"], fx["n_slots"], fx["chunk_samples"]) == (
        BEAM, N_SLOTS, CHUNK)
    assert len(fx["finals"]) == len(fx["streams"]) == 3
    for f in fx["finals"]:
        assert len(f["yseq"]) == len(f["xpos"]) >= 2


def test_engine_fixture_weights_checksum_still_matches():
    fx = _load()
    assert fx["weights_sha256"] == json.loads(
        WEIGHTS.read_text())["weights_sha256"]
    assert params_checksum(random_params(flagship_config(), fx["seed"])) \
        == fx["weights_sha256"]


def bless():
    import copy

    import numpy as np
    from test_torch_common import jax_model

    import chip_smoke
    from speechcatcher_tpu.serve.engine import StreamingEngine as JaxEngine
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    w = json.loads(WEIGHTS.read_text())
    cfg = flagship_config()
    tree = random_params(cfg, w["seed"])
    assert params_checksum(tree) == w["weights_sha256"]
    tree["decoder"]["output_layer"]["bias"][cfg.eos_id] += np.float32(
        w["eos_bias"])
    tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += np.float32(w["blank_bias"])
    streams = chip_smoke.engine_streams(3, SECONDS, STARTS, INT16_EVERY,
                                        AUDIO_SEED0, rate=cfg.sample_rate)
    kw = dict(n_slots=N_SLOTS, beam_size=BEAM, chunk_samples=CHUNK)
    jax_finals, _, _ = chip_smoke.drive_engine(
        JaxEngine(jax_model(cfg, copy.deepcopy(tree)), **kw), streams, CHUNK)
    port_finals, _, _ = chip_smoke.drive_engine(
        StreamingEngine(ASRModel.from_numpy(cfg, tree, device="cpu"),
                        device="cpu", **kw), streams, CHUNK)
    for k in range(len(streams)):
        (jy, jx, js), (py, px, ps) = jax_finals[k], port_finals[k]
        print(f"stream {k}: {len(jy)} tokens, score {js:.6f} (port "
              f"{ps:.6f})")
        assert np.array_equal(jy, py) and np.array_equal(jx, px), k
        assert abs(ps - js) <= 1e-5 * max(1.0, abs(js)), k
    import dataclasses

    FIXTURE.write_text(json.dumps({
        "cfg": dataclasses.asdict(cfg),
        "seed": w["seed"],
        "weights_sha256": w["weights_sha256"],
        "eos_bias": w["eos_bias"],
        "blank_bias": w["blank_bias"],
        "beam_size": BEAM,
        "n_slots": N_SLOTS,
        "chunk_samples": CHUNK,
        "int16_every": INT16_EVERY,
        "audio_seed0": AUDIO_SEED0,
        "streams": [{"seconds": s, "start": t}
                    for s, t in zip(SECONDS, STARTS)],
        "finals": [{"yseq": jax_finals[k][0].tolist(),
                    "xpos": jax_finals[k][1].tolist(),
                    "score": jax_finals[k][2]} for k in range(len(streams))],
    }, indent=1) + "\n")
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    bless()
