"""The file pipeline: the port's recognize / recognize_file against the JAX
package's on the same weights and the same audio, on the CPU; the port's
command line against its in-process result.

At tiny width (max_enc_frames 256: spans of at most 0.9 × 256 × 40 ms =
9.2 s) 20 s of audio is split into 3 spans. The tokenizer's pieces end a
sentence every other id, so the paragraph merging both joins and splits.
Text, paragraphs and token timestamps must be equal, timestamps exactly,
serially (num_processes=1) and over the batched engine (3), with
interpolated timestamps and without. With interpolation the JAX package's
serial path ramps the timestamps in seconds and its batched path the
positions, which differ in the last bit; the port ramps positions on both
paths, so its output equals the JAX batched path's on both.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from chip_smoke import write_model_dir
from test_torch_checkpoint import _espnet_config
from test_torch_common import bias_outputs, jax_model, synth_audio

import speechcatcher_tpu.recognize as J
from speechcatcher_tpu.streaming import Speech2TextStreaming as JaxSession
from speechcatcher_tpu.tokenizer import Tokenizer as JaxTokenizer
from speechcatcher_tpu_torch import recognize as P
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
from speechcatcher_tpu_torch.tokenizer import Tokenizer
from speechcatcher_tpu_torch.utils.audio import write_wav

CFG = tiny_config()
TOKENS = (["<blank>", "<unk>"]
          + [f"▁w{i}" + ("." if i % 2 else "") for i in range(CFG.vocab_size - 3)]
          + ["<sos/eos>"])


def pcm(seconds: float, seed: int) -> np.ndarray:
    return (np.clip(synth_audio(seconds, seed), -1, 1) * 32767).astype(
        np.int16)


PCM = pcm(20.0, 5)


def _tree():
    return bias_outputs(random_params(CFG, 8), CFG, eos=3.0, blank=4.0)


@pytest.fixture(scope="module")
def sessions():
    tree = _tree()
    jm = dataclasses.replace(jax_model(CFG, copy.deepcopy(tree)),
                             tokenizer=JaxTokenizer(TOKENS))
    pm = ASRModel.from_numpy(CFG, tree, device="cpu",
                             tokenizer=Tokenizer(TOKENS))
    return (JaxSession(model=jm, beam_size=2),
            Speech2TextStreaming(model=pm, beam_size=2, device="cpu"))


_RUNS = {}


def _recognize(sessions, package: int, n: int, interp: bool):
    """recognize over PCM by the JAX package (0) or the port (1), run
    once."""
    key = package, n, interp
    if key not in _RUNS:
        _RUNS[key] = (J.recognize, P.recognize)[package](
            sessions[package], PCM, 16000, num_processes=n, progress=False,
            quiet=True, interpolate_timestamps=interp)
    return _RUNS[key]


@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("n", [1, 3])
def test_recognize_matches_jax(sessions, n, interp):
    p_text, p_aux = _recognize(sessions, 1, n, interp)
    j_text, j_aux = _recognize(sessions, 0, 3 if interp else n, interp)
    assert p_text == j_text
    assert p_aux == j_aux  # start, end, text, tokens, timestamps: exact
    spans = P._split_overlong_spans([(0.0, 20.0)], 0.9 * 256 * 0.04)
    assert len(spans) == 3
    # Merged paragraphs cover the spans, and some paragraphs split.
    assert 2 <= len(p_aux) <= 3
    assert p_aux[0]["start"] == 0.0 and p_aux[-1]["end"] == 20.0
    assert all(len(a["tokens"]) == len(a["token_timestamps"]) > 0
               for a in p_aux)
    assert p_text == "\n\n".join(a["text"] for a in p_aux) + "\n"


def test_batched_equals_serial(sessions):
    for interp in (False, True):
        assert _recognize(sessions, 1, 3, interp) == \
            _recognize(sessions, 1, 1, interp)
    plain = _recognize(sessions, 1, 1, False)[1]
    ramped = _recognize(sessions, 1, 1, True)[1]
    assert [a["tokens"] for a in ramped] == [a["tokens"] for a in plain]
    for a, b in zip(plain, ramped):
        assert b["token_timestamps"] != a["token_timestamps"]
    # The JAX package's serial path ramps seconds, its batched path
    # positions: the two differ in the last bit.
    seg, frame = 0.0, 0.04
    pos = [1, 2, 2, 2, 2, 2]
    serial = [seg + t for t in
              J.linear_interpolate_positions([p * frame for p in pos])]
    batched = [seg + p * frame for p in J.linear_interpolate_positions(pos)]
    assert serial != batched
    np.testing.assert_allclose(serial, batched, rtol=1e-15)


def test_recognize_file_matches_jax(sessions, tmp_path):
    wav = tmp_path / "utt.wav"
    write_wav(wav, pcm(8.0, 6))
    out = {}
    for name, rec, s2t in zip(("jax", "port"), (J.recognize_file,
                                                P.recognize_file), sessions):
        res = rec(s2t, str(wav), output_file=str(tmp_path / name),
                  quiet=True, progress=False)
        out[name] = ((tmp_path / f"{name}.txt").read_text(),
                     (tmp_path / f"{name}.json").read_text(), res)
    assert out["port"] == out["jax"]
    txt, js, res = out["port"]
    assert json.loads(js) == res and res["complete_text"] == txt
    assert len(res["paragraphs"]) >= 1


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_model_dir(tmp_path_factory.mktemp("model"), CFG, _tree(),
                           config=_espnet_config(CFG))


def test_cli_matches_in_process(model_dir, tmp_path, monkeypatch):
    """The command line writes <wav>.json equal to load_model +
    recognize_file in the process (a config.yaml gives the model ESPnet's
    capacity of 2048 frames, so 6 s is one span)."""
    wav = tmp_path / "utt.wav"
    write_wav(wav, pcm(6.0, 7))
    monkeypatch.chdir(tmp_path)
    P.main(["-m", str(model_dir), "-d", "cpu", "-n", "2", "--quiet",
            "--no-progress", str(wav)])
    cli = json.loads((tmp_path / "utt.wav.json").read_text())
    s2t = P.load_model(str(model_dir), device="cpu", quiet=True)
    assert s2t.model.device.type == "cpu"
    ref = P.recognize_file(s2t, str(wav), output_file=str(tmp_path / "ref"),
                           num_processes=2, progress=False)
    assert cli == json.loads(json.dumps(ref))
    assert cli["paragraphs"][0]["tokens"]


def test_entry_points_run_on_the_card_by_default(model_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.load_model(str(model_dir), quiet=True)
    wav = tmp_path / "utt.wav"
    write_wav(wav, pcm(1.0, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.main(["-m", str(model_dir), "--quiet", str(wav)])


def test_cli_refuses_an_unknown_tag(capsys):
    with pytest.raises(SystemExit) as e:
        P.main(["-m", "no_such_tag", "-d", "cpu", "x.wav"])
    assert e.value.code == -1
    assert "not a valid model" in capsys.readouterr().out


def test_linear_interpolate_positions_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        pos = np.sort(rng.integers(0, 12, size=rng.integers(0, 15)))
        pos = [float(p) for p in pos]
        assert P.linear_interpolate_positions(pos) == \
            J.linear_interpolate_positions(pos)
    assert P.linear_interpolate_positions([6.0, 6.0, 6.0]) == [2.0, 4.0, 6.0]
    for text in ("", "a", "abc.", "Abc?", "x!"):
        assert P.is_completed(text) == J.is_completed(text)
        assert P.upper_case_first_letter(text) == \
            J.upper_case_first_letter(text)
    assert P.tags == J.tags


def test_batched_segments_raise_when_the_engine_quarantines(sessions,
                                                            monkeypatch):
    """A segment whose finalize raises is quarantined by the engine; the
    batched file path then raises, naming it, where the JAX package's
    would fail later on a missing result."""
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    def broken(self, s, last_audio=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(StreamingEngine, "finalize", broken)
    speech = PCM[:12000].astype(np.float32) / 32767.0
    with pytest.raises(RuntimeError, match=r"segments \[0, 1\] failed"):
        P._decode_segments_batched(sessions[1], speech,
                                   [(0, 5000), (5000, 11000)], 8192, 2)
