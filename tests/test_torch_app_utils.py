"""The app's host-side utilities: the port's against the JAX package's on the
same inputs, on the CPU.

Energy segmentation, the staging ring (bit-equal to the JAX package's
native ring, truncation at capacity included), WER, the Kaldi-directory
decoder, the model-zoo resolver (local directory, zip, tar, a URL served by
a patched ``urlretrieve``, a HuggingFace id without ``huggingface_hub``),
the microphone's overflow advice, media conversion with and without ffmpeg
(``have_ffmpeg`` patched), the terminal renderer, serving metrics and the
standalone command lines.
"""

import shutil
import subprocess
import sys
import tarfile
import zipfile

import numpy as np
import pytest

from chip_smoke import write_model_dir
from test_torch_checkpoint import _espnet_config
from test_torch_common import bias_outputs, synth_audio

import speechcatcher_tpu.decode_kaldidir as JK
import speechcatcher_tpu.endpointing as JE
import speechcatcher_tpu.endpointing_cli as JEC
import speechcatcher_tpu.recognize as JR
import speechcatcher_tpu.utils.audio as JA
import speechcatcher_tpu.utils.metrics as JM
import speechcatcher_tpu.utils.term as JT
import speechcatcher_tpu.utils.zoo as JZ
import speechcatcher_tpu.wer as JW
from speechcatcher_tpu.utils.native import StagingRing as NativeRing
from speechcatcher_tpu.utils.native import get_lib
import speechcatcher_tpu_torch.decode_kaldidir as PK
import speechcatcher_tpu_torch.endpointing as PE
import speechcatcher_tpu_torch.endpointing_cli as PEC
import speechcatcher_tpu_torch.recognize as PR
import speechcatcher_tpu_torch.utils.audio as PA
import speechcatcher_tpu_torch.utils.metrics as PM
import speechcatcher_tpu_torch.utils.term as PT
import speechcatcher_tpu_torch.utils.zoo as PZ
import speechcatcher_tpu_torch.wer as PW
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.utils.staging import StagingRing


def pcm(seconds: float, seed: int, rate: int = 16000) -> np.ndarray:
    return (np.clip(synth_audio(seconds, seed, rate=rate), -1, 1)
            * 32767).astype(np.int16)


def speech_with_pauses(seconds: float, seed: int) -> np.ndarray:
    """Tone in noise with 0.5-1 s pauses every 8-12 s (int16)."""
    rng = np.random.default_rng(seed)
    x = pcm(seconds, seed).copy()
    t = rng.uniform(8, 12)
    while t < seconds - 1:
        n = rng.uniform(0.5, 1.0)
        x[int(t * 16000):int((t + n) * 16000)] //= 50
        t += n + rng.uniform(8, 12)
    return x


# ---------------------------------------------------------------------------
# Energy segmentation
# ---------------------------------------------------------------------------

def test_segment_speech_matches_jax():
    x = speech_with_pauses(70.0, 1)
    np.testing.assert_array_equal(PE.log_fbank_energy(x, 16000),
                                  JE.log_fbank_energy(x, 16000))
    cuts = PE.segment_speech(x, 16000)
    assert cuts == JE.segment_speech(x, 16000)
    assert cuts[0][0] == 0 and 2000 < cuts[-1][1] < 7000
    short = PE.segment_speech(x, 16000, average_segment_length=20.0,
                              max_segment_len_sec=25.0)
    assert short == JE.segment_speech(x, 16000, average_segment_length=20.0,
                                      max_segment_len_sec=25.0)
    assert max(e - s for s, e in short) <= 2500


def test_endpointing_cli_matches_jax(tmp_path, monkeypatch, capsys):
    wav = tmp_path / "long.wav"
    PA.write_wav(wav, speech_with_pauses(40.0, 2))
    PEC.main(["-a", "15", str(wav)])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["x", "-a", "15", str(wav)])
    JEC.main()
    assert port == capsys.readouterr().out and port.startswith("[(0, ")


# ---------------------------------------------------------------------------
# The staging ring against the JAX package's native (C++) ring
# ---------------------------------------------------------------------------

def _ring_script(ring, case: str):
    """Every value a ring returns under one script."""
    rng = np.random.default_rng(len(case))
    out = []
    if case == "pcm16_roundtrip":
        x = rng.integers(-32768, 32768, size=5000).astype(np.int16)
        out += [ring.write_pcm16(x.tobytes()), ring.available(),
                ring.read(5000)]
    elif case == "f32_roundtrip":
        x = rng.standard_normal(3000).astype(np.float32)
        out += [ring.write_f32(x), ring.read(3000), ring.drain()]
    elif case == "chunked":
        for _ in range(20):
            x = rng.integers(-1000, 1000, size=300).astype(np.int16)
            out.append(ring.write_pcm16(x.tobytes()))
            while ring.available() >= 256:
                out.append(ring.read(256))
        out.append(ring.drain())
    elif case == "underflow":
        out += [ring.write_f32(np.ones(10, np.float32)), ring.read(11),
                ring.available(), ring.read(10), ring.drain()]
    elif case == "truncation":
        # Fill past capacity, read a little, fill again across the wrap.
        x = rng.integers(-32768, 32768, size=3000).astype(np.int16)
        out += [ring.write_pcm16(x.tobytes()), ring.available(),
                ring.read(700),
                ring.write_f32(rng.standard_normal(900).astype(np.float32)),
                ring.write_pcm16(x[:50].tobytes()), ring.available(),
                ring.drain(), ring.write_pcm16(x[:10].tobytes()),
                ring.drain()]
    return out


@pytest.mark.parametrize("case", ["pcm16_roundtrip", "f32_roundtrip",
                                  "chunked", "underflow", "truncation"])
def test_staging_ring_bit_equal_to_native(case):
    assert get_lib() is not None  # g++ builds csrc/libstaging.so here
    cap = 2048 if case == "truncation" else 1 << 16
    native = _ring_script(NativeRing(capacity=cap), case)
    port = _ring_script(StagingRing(capacity=cap), case)
    assert len(port) == len(native)
    for p, n in zip(port, native):
        if isinstance(n, np.ndarray):
            assert p.dtype == np.float32 and p.tobytes() == n.tobytes()
        else:
            assert p == n
    if case == "truncation":
        assert port[0] == 2048 and port[4] == 0  # writes cut at capacity


def test_server_warns_when_the_ring_truncates(caplog):
    from speechcatcher_tpu_torch.serve.server import Session

    sess = Session(slot=0, staged=StagingRing(capacity=100))
    with caplog.at_level("WARNING"):
        sess.stage_pcm16(np.zeros(150, np.int16).tobytes())
        sess.stage_pcm16(np.zeros(10, np.int16).tobytes())
    assert caplog.text.count("staging ring full") == 1
    assert sess.staged.available() == 100


# ---------------------------------------------------------------------------
# WER
# ---------------------------------------------------------------------------

WORDS = ["Haus", "haus", "Straße", "über", "ÜberSee", "Kaffee,", "„Tee“",
         "ein", "zwei", "drei!", "vier.", "fünf?", "sechs…", "GroßStadt"]


def _sentences(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=rng.integers(0, 12)))
            for _ in range(n)]


def test_wer_matches_jax():
    refs, hyps = _sentences(1, 40), _sentences(2, 40)
    for kw in ({}, dict(ignore_punct=False), dict(lowercase=False)):
        assert PW.word_error_rate(refs, hyps, **kw) == \
            JW.word_error_rate(refs, hyps, **kw)
    for s in refs:
        assert PW.normalize(s) == JW.normalize(s)
        assert PW.tokenize(s) == JW.tokenize(s)
    assert PW.word_error_rate(refs, refs)["wer"] == 0.0


def test_wer_cli_matches_jax(tmp_path, monkeypatch, capsys):
    ref, hyp = tmp_path / "ref", tmp_path / "hyp"
    ref.write_text("".join(f"u{i} {s}\n" for i, s in
                           enumerate(_sentences(3, 10))))
    hyp.write_text("".join(f"u{i} {s}\n" for i, s in
                           enumerate(_sentences(4, 10))))
    PW.main([str(ref), str(hyp)])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["x", str(ref), str(hyp)])
    JW.main()
    assert port == capsys.readouterr().out and port.startswith("WER: ")


# ---------------------------------------------------------------------------
# The Kaldi-directory decoder, over a model directory the test writes
# ---------------------------------------------------------------------------

def test_decode_kaldidir_matches_jax(tmp_path, monkeypatch):
    cfg = tiny_config()
    tree = bias_outputs(random_params(cfg, 8), cfg, eos=3.0, blank=4.0)
    run = write_model_dir(tmp_path / "model", cfg, tree,
                          config=_espnet_config(cfg))
    data = tmp_path / "data"
    data.mkdir()
    # One length for all three (the JAX session compiles per tail length).
    PA.write_wav(data / "a.wav", pcm(2.0, 1))
    PA.write_wav(data / "b.wav", pcm(2.0, 2, rate=8000), rate=8000)
    PA.write_wav(data / "c.wav", pcm(2.0, 3))
    (data / "wav.scp").write_text(
        f"utt_a {data / 'a.wav'}\n"
        f"utt_b {data / 'b.wav'}\n"
        f"utt_c cat {data / 'c.wav'} |\n"
        f"utt_d {data / 'missing.wav'}\n")
    PK.main([str(data), "-m", str(run), "-d", "cpu", "-o",
             str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["x", str(data), "-m", str(run), "-o",
                                      str(tmp_path / "jax")])
    JK.main()
    port = (tmp_path / "port").read_text()
    assert port == (tmp_path / "jax").read_text()
    lines = port.splitlines()
    assert [ln.split(" ")[0] for ln in lines] == ["utt_a", "utt_b", "utt_c",
                                                  "utt_d"]
    assert len(lines[0].split()) > 1 and lines[3] == "utt_d"


# ---------------------------------------------------------------------------
# The model-zoo resolver
# ---------------------------------------------------------------------------

def _package(root):
    """A zoo package: meta.yaml naming the checkpoint, and the files."""
    run = root / "exp" / "asr_train"
    run.mkdir(parents=True)
    (run / "valid.acc.ave_6best.pth").write_bytes(b"x")
    (run / "config.yaml").write_text("encoder: contextual_block_transformer\n")
    (root / "meta.yaml").write_text(
        "files:\n  asr_model_file: exp/asr_train/valid.acc.ave_6best.pth\n"
        "yaml_files:\n  asr_train_config: exp/asr_train/config.yaml\n")
    return root


def _archives(tmp_path):
    src = _package(tmp_path / "src" / "pkg")
    z = tmp_path / "pkg.zip"
    with zipfile.ZipFile(z, "w") as f:
        for p in sorted(src.rglob("*")):
            f.write(p, p.relative_to(src.parent))
    t = tmp_path / "pkg.tar.gz"
    with tarfile.open(t, "w:gz") as f:
        f.add(src, arcname="pkg")
    return src, z, t


@pytest.mark.parametrize("kind", ["dir", "zip", "tar", "url_zip", "url_tar"])
def test_download_and_unpack_matches_jax(tmp_path, monkeypatch, kind):
    import urllib.request

    src, z, t = _archives(tmp_path)
    archive = z if kind.endswith("zip") else t
    tag = {"dir": str(src), "zip": str(z), "tar": str(t)}.get(
        kind, f"https://example.invalid/models/{archive.name}")
    fetched = []

    def urlretrieve(url, dest):   # no network: copy the local archive
        fetched.append(url)
        shutil.copy(archive, dest)

    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    got = {}
    for name, zoo in (("jax", JZ), ("port", PZ)):
        cache = tmp_path / f"cache_{name}"
        d = zoo.download_and_unpack(tag, cache_dir=cache, quiet=True)
        assert (d / "valid.acc.ave_6best.pth").exists()
        got[name] = d.relative_to(cache) if kind != "dir" else d
        assert not list(cache.rglob("*.part"))
        # A second call finds what the first left (no second download).
        assert zoo.download_and_unpack(tag, cache_dir=cache, quiet=True) == d
    assert got["port"] == got["jax"]
    assert len(fetched) == (2 if kind.startswith("url") else 0)


def test_download_and_unpack_without_huggingface_hub(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    errors = []
    for zoo in (JZ, PZ):
        with pytest.raises(RuntimeError) as e:
            zoo.download_and_unpack("org/model", cache_dir=tmp_path)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "huggingface_hub" in errors[0]


# ---------------------------------------------------------------------------
# The microphone path (no pyaudio on either machine)
# ---------------------------------------------------------------------------

class FakeStream:
    def __init__(self, error=None):
        self.error = error

    def read(self, n, exception_on_overflow=True):
        if self.error:
            raise OSError(self.error)
        return b"\x01\x00" * n


@pytest.mark.parametrize("error", [None, "[Errno -9981] Input overflowed",
                                   "[Errno -9999] Unanticipated host error"])
def test_mic_chunk_advice_matches_jax(capsys, error):
    outs = []
    for mod in (JR, PR):
        if error is None:
            outs.append(mod._read_mic_chunk_with_advice(FakeStream(), 4,
                                                        lambda: 3))
        else:
            with pytest.raises(SystemExit) as e:
                mod._read_mic_chunk_with_advice(FakeStream(error), 4,
                                                lambda: 3)
            outs.append(e.value.code)
        outs.append(capsys.readouterr().out)
    assert outs[2:] == outs[:2]
    if error and "overflowed" in error:
        assert "--no-exception-on-overflow" in outs[1]


def test_microphone_without_pyaudio_matches_jax(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "pyaudio", None)
    outs = []
    for mod in (JR, PR):
        mod.list_microphones()
        with pytest.raises(SystemExit) as e:
            mod.recognize_microphone(None, "tag")
        outs.append((e.value.code, capsys.readouterr().out))
    assert outs[1] == outs[0] and outs[0][0] == 1
    assert "pyaudio is not installed" in outs[0][1]


# ---------------------------------------------------------------------------
# Media conversion, with and without ffmpeg
# ---------------------------------------------------------------------------

def test_convert_media_with_ffmpeg(monkeypatch, tmp_path):
    """With ffmpeg both packages run the same command and decode its
    stdout."""
    cmds = []
    x = pcm(0.5, 4)

    class Done:
        stdout = x.tobytes()

    def run(cmd, **kwargs):
        cmds.append((cmd, kwargs.get("stderr")))
        return Done()

    monkeypatch.setattr(subprocess, "run", run)
    for mod in (JA, PA):
        monkeypatch.setattr(mod, "have_ffmpeg", lambda: True)
    for src in (str(tmp_path / "a.mp4"), "https://example.invalid/a.mp3"):
        for show in (False, True):
            outs = [mod.convert_media(src, show_output=show)
                    for mod in (JA, PA)]
            assert cmds[-1] == cmds[-2] and cmds[-1][0][2] == src
            np.testing.assert_array_equal(outs[1][0], outs[0][0])
            assert outs[1][1] == outs[0][1] == 16000


def test_convert_media_without_ffmpeg(monkeypatch, tmp_path):
    for mod in (JA, PA):
        monkeypatch.setattr(mod, "have_ffmpeg", lambda: False)
    wav = tmp_path / "a.wav"
    PA.write_wav(wav, pcm(0.7, 5, rate=22050), rate=22050)
    outs = [mod.convert_media(wav) for mod in (JA, PA)]
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert outs[1][1] == 16000 and len(outs[1][0]) == 11200
    for src in ("https://example.invalid/a.wav", str(tmp_path / "a.mp3")):
        msgs = []
        for mod in (JA, PA):
            with pytest.raises(RuntimeError) as e:
                mod.convert_media(src)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0] and "ffmpeg not found" in msgs[0]


def test_read_wav_widths_match_jax(tmp_path):
    import wave

    rng = np.random.default_rng(6)
    for width, dtype in ((1, np.uint8), (2, np.int16), (4, np.int32)):
        for channels in (1, 2):
            path = tmp_path / f"w{width}c{channels}.wav"
            info = np.iinfo(dtype)
            data = rng.integers(info.min, info.max, size=400 * channels,
                                dtype=dtype)
            with wave.open(str(path), "wb") as w:
                w.setnchannels(channels)
                w.setsampwidth(width)
                w.setframerate(8000)
                w.writeframes(data.tobytes())
            (pj, rj), (pp, rp) = JA.read_wav(path), PA.read_wav(path)
            np.testing.assert_array_equal(pp, pj)
            assert rp == rj == 8000 and pp.dtype == np.int16


# ---------------------------------------------------------------------------
# Terminal renderer and serving metrics
# ---------------------------------------------------------------------------

def test_progress_output_matches_jax(capsys):
    text = " ".join(_sentences(5, 30))
    outs = []
    for mod in (JT, PT):
        prev = 0
        for k in range(0, len(text), 97):
            prev = mod.progress_output(text[:k], prev)
        outs.append((prev, capsys.readouterr().out))
    assert outs[1] == outs[0] and outs[0][0] > 1


def test_serving_metrics_match_jax(monkeypatch, tmp_path):
    import time

    snaps = []
    for mod in (JM, PM):
        ticks = iter(np.cumsum(np.random.default_rng(7).random(600)))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        m = mod.ServingMetrics(chunk_seconds=0.512, window=64)
        snaps.append(m.snapshot())
        for k in range(100):
            m.tick_begin(active_streams=k % 7)
            m.tick_end()
            if k % 9 == 0:
                m.finalized()
        snaps.append(m.snapshot())
    assert snaps[2:] == snaps[:2]
    assert snaps[3]["total_ticks"] == 100 and snaps[3]["total_finals"] == 12
