"""The port's websocket server with real clients on localhost, on the CPU.

The concurrency test of ``tests/test_ws_integration.py`` against the port's
engine: 32 clients against 8 slots with busy refusals and retries, random
disconnects mid-utterance, 8 kHz clients on the resampling path and three
generations of slot reuse; clients that send the same audio through
recycled slots must get the same transcript, and the manager must have
caught nothing. Then the port's Vosk test client against ``start_server``.
"""

import asyncio
import json
import socket
import sys

import numpy as np
import pytest

from test_torch_common import synth_audio

from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.serve.engine import StreamingEngine
from speechcatcher_tpu_torch.serve.server import (
    SessionManager,
    _batcher,
    recognize_ws,
    start_server,
)


def _tone_pcm(seed: int, seconds: float, rate: int) -> np.ndarray:
    """Deterministic int16 audio, distinct per seed."""
    return (np.clip(synth_audio(seconds, seed, rate=rate), -1, 1)
            * 30000).astype(np.int16)


def test_websocket_stress_concurrent_clients():
    websockets = pytest.importorskip("websockets")

    n_slots = 8
    n_clients = 32
    seconds = 2.5   # about 4.9 chunks: every eof final is a batched drain

    async def client(k: int, port: int, results: dict, disconnect: bool,
                     rate: int):
        pcm = _tone_pcm(seed=k % n_slots, seconds=seconds, rate=rate)
        for _ in range(1200):
            try:
                ws = await websockets.connect(f"ws://localhost:{port}")
            except OSError:
                await asyncio.sleep(0.25)
                continue
            msgs: list = []
            busy = False
            dead = False

            async def recv():
                nonlocal busy, dead
                try:
                    async for m in ws:
                        if isinstance(m, str) and m.startswith("Server busy"):
                            busy = True
                            return
                        msgs.append(json.loads(m))
                except Exception:
                    pass
                dead = True

            rt = asyncio.create_task(recv())
            try:
                # The handshake completes before the server decides
                # admission, so a send may land on a connection about to be
                # refused, or raise once the refusal's close arrives: both
                # are busy-path outcomes, and the client retries.
                await ws.send(json.dumps({"config": {"sample_rate": rate}}))
                step = 3200
                n_steps = len(pcm) // step + 1
                cut = (min(rng_cut[k], n_steps - 1) if disconnect
                       else n_steps + 1)
                for i in range(n_steps):
                    if busy:
                        break
                    if i == cut:
                        await ws.close()   # mid-utterance, no eof
                        results[k] = ("disconnected", None)
                        return
                    await ws.send(pcm[i * step:(i + 1) * step].tobytes())
                    await asyncio.sleep(0.01)
                if not busy:
                    await ws.send(json.dumps({"eof": 1}))
                    for _ in range(4800):
                        if busy or dead or any("result" in m for m in msgs):
                            break
                        await asyncio.sleep(0.05)
                    finals = [m for m in msgs if "result" in m]
                    if finals:
                        results[k] = ("final", finals[-1]["text"])
                        return
                    assert busy or dead, f"client {k}: no final"
            except websockets.exceptions.ConnectionClosed:
                pass   # refused while sending: retry
            finally:
                rt.cancel()
                try:
                    await ws.close()
                except Exception:
                    pass
            results.setdefault(k, ("busy_gave_up", None))
            await asyncio.sleep(0.25)
        raise AssertionError(f"client {k}: no slot after retries")

    rng = np.random.RandomState(99)
    disconnecters = set(rng.choice(n_clients, size=5, replace=False).tolist())
    rng_cut = {k: int(rng.randint(1, 8)) for k in range(n_clients)}

    async def main():
        model = ASRModel.random_init(tiny_config(), seed=3, device="cpu")
        engine = StreamingEngine(model, n_slots=n_slots, beam_size=2,
                                 device="cpu")
        # Finals at eof only, so a transcript depends on the audio alone.
        manager = SessionManager(engine, finalize_update_iters=99)
        batch_task = asyncio.create_task(_batcher(manager, 0.01))

        async def handler(conn):
            await recognize_ws(conn, manager)

        async with websockets.serve(handler, "localhost", 0) as srv:
            port = srv.sockets[0].getsockname()[1]
            results: dict = {}
            tasks = []
            for w in range(0, n_clients, n_slots):
                tasks += [
                    asyncio.create_task(client(
                        k, port, results, disconnect=(k in disconnecters),
                        rate=8000 if k % 4 == 3 else 16000))
                    for k in range(w, w + n_slots)
                ]
                await asyncio.sleep(0.5)
            await asyncio.wait_for(asyncio.gather(*tasks), timeout=600)
            batch_task.cancel()

        finals = {k: v[1] for k, v in results.items() if v[0] == "final"}
        expected = set(range(n_clients)) - disconnecters
        assert set(finals) == expected, results
        for seed in range(n_slots):
            group = sorted(finals[k] for k in expected if k % n_slots == seed)
            assert len(set(group)) <= 1, (seed, group)
        snap = manager.metrics.snapshot()
        assert snap["total_finals"] >= len(expected)
        assert snap["tick_p95_ms"] < 30000, snap
        assert manager.caught == {"batcher": 0, "finalize_batch": 0,
                                  "finalize": 0}
        assert engine.quarantined == 0
        # Every slot is free again once the clients have gone.
        for _ in range(100):
            if not engine.c.active.any():
                break
            await asyncio.sleep(0.05)
        assert not engine.c.active.any()

    # Switch threads often, so that the batcher's worker thread and the
    # event loop interleave inside the manager's critical sections.
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        asyncio.run(main())
    finally:
        sys.setswitchinterval(interval)


def test_vosk_client_against_start_server(tmp_path, capsys):
    pytest.importorskip("websockets")
    from speechcatcher_tpu_torch.serve.vosk_test_client import run
    from speechcatcher_tpu_torch.utils.audio import write_wav

    wav = tmp_path / "a.wav"
    write_wav(wav, _tone_pcm(5, 1.3, 16000))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    async def main():
        model = ASRModel.random_init(tiny_config(), seed=3, device="cpu")
        manager = SessionManager(
            StreamingEngine(model, n_slots=2, beam_size=2, device="cpu"),
            finalize_update_iters=99)
        server = asyncio.create_task(start_server("127.0.0.1", port, manager,
                                                  tick_interval=0.01))
        await asyncio.sleep(0.2)
        await run(f"ws://127.0.0.1:{port}", wav)
        server.cancel()
        with pytest.raises(asyncio.CancelledError):
            await server
        return manager

    manager = asyncio.run(main())
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"partial": ""}
    assert "result" in lines[-1] and "text" in lines[-1]
    assert manager.metrics.snapshot()["total_finals"] == 1
