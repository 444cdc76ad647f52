"""The server's SessionManager: the port's against the JAX package's on the
same weights and the same audio, on the CPU.

Each script of ``tests/test_server.py`` drives both packages'
SessionManager (each over its own StreamingEngine); every value the script
sees (session ids, busy refusals, partial texts, final texts and word
timings) must be equal, word timings exactly. Then the port alone: the
counters of the exceptions the manager catches to keep serving, the engine's
quarantines, the websocket handler's ffmpeg and resampling branches, and
the server's command line.
"""

import asyncio
import copy
import json
import logging

import numpy as np
import pytest
import torch

from test_torch_common import jax_model, synth_audio

from speechcatcher_tpu.serve.engine import StreamingEngine as JaxEngine
from speechcatcher_tpu.serve.server import SessionManager as JaxManager
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.serve import server
from speechcatcher_tpu_torch.serve.engine import StreamingEngine
from speechcatcher_tpu_torch.serve.server import SessionManager

CFG = tiny_config()
CHUNK = 8192
TREE = random_params(CFG, 2)


def pcm16(seconds: float, seed: int) -> bytes:
    a = synth_audio(seconds, seed)
    return (np.clip(a, -1, 1) * 32000).astype(np.int16).tobytes()


def port_engine(n_slots: int = 2) -> StreamingEngine:
    return StreamingEngine(ASRModel.from_numpy(CFG, TREE, device="cpu"),
                           n_slots=n_slots, beam_size=2, chunk_samples=CHUNK,
                           device="cpu")


def jax_engine(n_slots: int = 2) -> JaxEngine:
    return JaxEngine(jax_model(CFG, copy.deepcopy(TREE)), n_slots=n_slots,
                     beam_size=2, chunk_samples=CHUNK)


def lifecycle_and_busy(mgr, log):
    s1, s2 = mgr.open_session(), mgr.open_session()
    log += [s1, s2, mgr.open_session()]  # pool exhausted → busy (None)
    mgr.close_session(s2)
    s3 = mgr.open_session()
    log.append(s3)
    mgr.close_session(s1)
    mgr.close_session(s3)


def _stream_then_final(mgr, log, sid, audio: bytes):
    mgr.feed(sid, audio)
    while mgr.ready():
        log.append(mgr.tick())
        if mgr.sessions[sid].staged.available() < CHUNK:
            break
    mgr.request_final(sid)
    log.append(mgr.tick())
    mgr.close_session(sid)


def partials_and_finalize(mgr, log):
    _stream_then_final(mgr, log, mgr.open_session(), pcm16(2.0, 1))


def mulaw_wire(mgr, log):
    _stream_then_final(mgr, log, mgr.open_session(), pcm16(2.0, 7))


def two_sessions_batched(mgr, log):
    s1, s2 = mgr.open_session(), mgr.open_session()
    mgr.feed(s1, pcm16(1.0, 2))
    mgr.feed(s2, pcm16(1.0, 3))
    log.append(mgr.tick())
    mgr.request_final(s1)
    mgr.request_final(s2)
    log.append(mgr.tick())
    mgr.close_session(s1)
    mgr.close_session(s2)


def eof_with_backlog(mgr, log):
    """Interleaved feeding and a whole backlog staged before eof give the
    same final."""
    audio = pcm16(2.2, 9)
    sid = mgr.open_session()
    for i in range(0, len(audio), CHUNK * 2):
        mgr.feed(sid, audio[i:i + CHUNK * 2])
        while mgr.ready() and mgr.sessions[sid].staged.available() >= CHUNK:
            log.append(mgr.tick())
    mgr.request_final(sid)
    for _ in range(8):
        out = mgr.tick()
        log.append(out)
        if "result" in out.get(sid, {}):
            break
    mgr.close_session(sid)
    sid = mgr.open_session()
    mgr.feed(sid, audio)
    mgr.request_final(sid)
    for _ in range(64):
        out = mgr.tick()
        log.append(out)
        if "result" in out.get(sid, {}):
            break
    mgr.close_session(sid)
    finals = [m for out in log for m in out.values() if "result" in m]
    assert len(finals) == 2 and finals[0] == finals[1]


def capacity_stall(mgr, log):
    """A stream longer than the encoder ring (256 frames, ~19 chunks; 30
    fed) is cut into segment finals, its backlog kept staged."""
    sid = mgr.open_session()
    mgr.feed(sid, pcm16(30 * CHUNK / 16000 + 0.01, 12))
    ticks = 0
    while mgr.ready() and ticks < 200:
        log.append(mgr.tick())
        ticks += 1
        if mgr.sessions[sid].staged.available() < CHUNK:
            break
    mgr.request_final(sid)
    for _ in range(8):
        out = mgr.tick()
        log.append(out)
        if "result" in out.get(sid, {}):
            break
    mgr.close_session(sid)
    finals = [m for out in log for m in out.values() if "result" in m]
    assert len(finals) >= 2 and any(f["text"] for f in finals)


# name: (script, engine slots, manager kwargs)
SCRIPTS = {
    "lifecycle_and_busy": (lifecycle_and_busy, 2, {}),
    "partials_and_finalize": (partials_and_finalize, 2,
                              dict(finalize_update_iters=3,
                                   max_partial_iters=10)),
    "mulaw_wire": (mulaw_wire, 2, dict(finalize_update_iters=3,
                                       max_partial_iters=10, wire="mulaw")),
    "two_sessions_batched": (two_sessions_batched, 2, {}),
    "eof_with_backlog": (eof_with_backlog, 2,
                         dict(finalize_update_iters=3, max_partial_iters=10)),
    "capacity_stall": (capacity_stall, 1,
                       dict(finalize_update_iters=1000,
                            max_partial_iters=10_000)),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_session_manager_matches_jax(name):
    script, n_slots, kw = SCRIPTS[name]
    logs = []
    for mgr in (JaxManager(jax_engine(n_slots), **kw),
                SessionManager(port_engine(n_slots), **kw)):
        log = []
        script(mgr, log)
        logs.append(log)
    jax_log, port_log = logs
    assert port_log == jax_log
    messages = [m for out in port_log if isinstance(out, dict)
                for m in out.values()]
    if name != "lifecycle_and_busy":
        finals = [m for m in messages if "result" in m]
        assert finals and any(m["result"] for m in finals)
        json.dumps(messages)  # the wire format
    if name == "partials_and_finalize":
        assert any(m.get("partial") for m in messages)


# ---------------------------------------------------------------------------
# The port alone: what the manager catches to keep serving, and counts
# ---------------------------------------------------------------------------

def _one_final(mgr, audio):
    sid = mgr.open_session()
    mgr.feed(sid, audio)
    mgr.tick()
    mgr.request_final(sid)
    return sid, mgr.tick()


def test_batched_finalize_failure_falls_back_and_counts(monkeypatch,
                                                        caplog):
    """finalize_batch raising: each session is finalized alone (the same
    final as without the failure), and the catch is counted."""
    audio = pcm16(1.2, 21)
    ref = SessionManager(port_engine())
    sid, want = _one_final(ref, audio)
    mgr = SessionManager(port_engine())

    def broken(tails):
        raise RuntimeError("boom")

    monkeypatch.setattr(mgr.engine, "finalize_batch", broken)
    with caplog.at_level(logging.ERROR):
        sid2, got = _one_final(mgr, audio)
    assert got[sid2] == want[sid] and "result" in got[sid2]
    assert mgr.caught == {"batcher": 0, "finalize_batch": 1, "finalize": 0}
    assert [r.levelno for r in caplog.records] == [logging.ERROR]


def test_session_finalize_failure_closes_and_counts(monkeypatch):
    """finalize_batch and the per-session finalize both raising: an empty
    final, the session closed, both catches counted."""
    mgr = SessionManager(port_engine())

    def broken(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(mgr.engine, "finalize_batch", broken)
    monkeypatch.setattr(mgr.engine, "finalize", broken)
    sid, out = _one_final(mgr, pcm16(1.2, 22))
    assert out[sid] == {"result": [], "text": ""}
    assert sid not in mgr.sessions and not mgr.engine.c.active.any()
    assert mgr.caught == {"batcher": 0, "finalize_batch": 1, "finalize": 1}


def test_engine_quarantine_gives_an_empty_final(monkeypatch):
    """A sub-block session goes through the engine's per-slot fallback;
    its finalize raising quarantines the slot (counted by the engine) and
    the manager closes the session with an empty final, catching
    nothing itself."""
    mgr = SessionManager(port_engine())

    def broken(s, last_audio=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(mgr.engine, "finalize", broken)
    sid = mgr.open_session()
    mgr.feed(sid, pcm16(0.3, 23))
    mgr.request_final(sid)
    out = mgr.tick()
    assert out[sid] == {"result": [], "text": ""}
    assert mgr.engine.quarantined == 1
    assert mgr.caught == {"batcher": 0, "finalize_batch": 0, "finalize": 0}


def test_batcher_survives_and_counts_a_failing_tick(monkeypatch):
    mgr = SessionManager(port_engine())
    calls = []

    def tick():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("boom")
        return {}

    monkeypatch.setattr(mgr, "ready", lambda: True)
    monkeypatch.setattr(mgr, "tick", tick)

    async def run():
        task = asyncio.create_task(server._batcher(mgr, 0.001))
        for _ in range(500):
            await asyncio.sleep(0.002)
            if len(calls) >= 3:
                break
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    asyncio.run(run())
    assert len(calls) >= 3
    assert mgr.caught == {"batcher": 1, "finalize_batch": 0, "finalize": 0}


# ---------------------------------------------------------------------------
# The websocket handler's input branches (no socket: a fake connection)
# ---------------------------------------------------------------------------

class FakeConnection:
    def __init__(self, messages):
        self.messages = messages
        self.sent = []
        self.closed = False

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        for m in self.messages:
            yield m
            await asyncio.sleep(0)

    async def send(self, msg):
        self.sent.append(msg)

    async def close(self):
        self.closed = True


def _serve(mgr, messages, monkeypatch, ffmpeg: bool, audio_format="s16le"):
    """Run recognize_ws over the messages with have_ffmpeg patched and
    Session.start_ffmpeg / feed_compressed recorded; returns (connection,
    staged audio of the session, ffmpeg calls)."""
    import speechcatcher_tpu_torch.utils.audio as audio_mod

    monkeypatch.setattr(audio_mod, "have_ffmpeg", lambda: ffmpeg)
    calls = []
    staged = {}

    def start_ffmpeg(self, fmt, out_rate, in_rate=None):
        calls.append(("start", fmt, out_rate, in_rate))
        self.ffmpeg = object()

    def feed_compressed(self, data):
        calls.append(("feed", len(data)))

    monkeypatch.setattr(server.Session, "start_ffmpeg", start_ffmpeg)
    monkeypatch.setattr(server.Session, "feed_compressed", feed_compressed)
    close = mgr.close_session

    def close_session(sid):
        sess = mgr.sessions[sid]
        staged["audio"] = sess.staged.drain()
        sess.ffmpeg = None
        close(sid)

    monkeypatch.setattr(mgr, "close_session", close_session)
    conn = FakeConnection(messages)
    asyncio.run(server.recognize_ws(conn, mgr, audio_format=audio_format))
    return conn, staged["audio"], calls


@pytest.mark.parametrize("ffmpeg", [True, False])
def test_ws_compressed_format(monkeypatch, ffmpeg, caplog):
    mgr = SessionManager(port_engine())
    payload = b"\x1aE\xdf\xa3" * 100   # webm bytes
    with caplog.at_level(logging.WARNING):
        conn, staged, calls = _serve(
            mgr, [json.dumps({"config": {"sample_rate": 16000}}), payload],
            monkeypatch, ffmpeg, audio_format="webm")
    if ffmpeg:
        assert calls == [("start", "webm", 16000, None),
                         ("feed", len(payload))]
        assert len(staged) == 0
    else:   # no ffmpeg: warned, and the bytes are taken as s16le PCM
        assert calls == []
        assert "ffmpeg is unavailable" in caplog.text
        np.testing.assert_array_equal(
            staged, np.frombuffer(payload, np.int16).astype(np.float32)
            * np.float32(1 / 32767.0))
    assert conn.sent == [json.dumps({"partial": ""})]


@pytest.mark.parametrize("ffmpeg", [True, False])
def test_ws_resampled_pcm(monkeypatch, ffmpeg):
    """An 8 kHz client: ffmpeg's stateful resampler where there is one,
    else scipy per message."""
    from speechcatcher_tpu_torch.utils.audio import resample_int16

    mgr = SessionManager(port_engine())
    pcm = np.frombuffer(pcm16(0.5, 24), np.int16)[:4000]
    conn, staged, calls = _serve(
        mgr, [json.dumps({"config": {"sample_rate": 8000}}), pcm.tobytes()],
        monkeypatch, ffmpeg)
    if ffmpeg:
        assert calls == [("start", "s16le", 16000, 8000),
                         ("feed", pcm.nbytes)]
    else:
        assert calls == []
        np.testing.assert_array_equal(
            staged, resample_int16(pcm, 8000, 16000).astype(np.float32)
            / 32767.0)
        assert len(staged) == 8000


def test_session_start_ffmpeg_pipeline(monkeypatch):
    """Session.start_ffmpeg: the same ffmpeg command as the JAX package's,
    and what its stdout yields is staged."""
    import io
    import subprocess

    from speechcatcher_tpu.serve.server import Session as JaxSession

    pcm = np.frombuffer(pcm16(0.2, 25), np.int16)
    cmds = []

    class FakePopen:
        def __init__(self, cmd, **kwargs):
            cmds.append(cmd)
            self.stdout = io.BytesIO(pcm.tobytes())
            self.stdin = io.BytesIO()

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    for fmt, in_rate in (("webm", None), ("s16le", 8000)):
        staged = []
        for cls in (JaxSession, server.Session):
            sess = cls(slot=0)
            sess.start_ffmpeg(fmt, 16000, in_rate=in_rate)
            sess._drain_thread.join(timeout=10)
            assert not sess._drain_thread.is_alive()
            sess.feed_compressed(b"abc")
            assert sess.ffmpeg.stdin.getvalue() == b"abc"
            staged.append(sess.staged.drain())
        assert cmds[-1] == cmds[-2]
        np.testing.assert_array_equal(staged[1], staged[0])
        assert len(staged[1]) == len(pcm)
    assert cmds[-2][:9] == ["ffmpeg", "-loglevel", "error", "-f", "s16le",
                            "-ar", "8000", "-ac", "1"]


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,message", [
    (["--dp", "2"], "make_mesh: requested 2 devices"),
    (["--coordinator", "localhost:1234"], "--coordinator requires"),
    (["--num-processes", "2"], "only with --coordinator"),
    (["--process-id", "1"], "only with --coordinator")])
def test_server_refuses_multi_gpu_flags(flags, message, capsys):
    """Multi-card flags that cannot take effect stop the server before it
    loads a model: --dp beyond this machine's cards with make_mesh's
    message, --coordinator without its partners, and those without it."""
    with pytest.raises(SystemExit) as e:
        server.main(["--model", "unused"] + flags)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_server_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.main(["--model", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingEngine(ASRModel.from_numpy(CFG, TREE, device="cpu"))
