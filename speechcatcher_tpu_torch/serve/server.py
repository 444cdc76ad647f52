"""Vosk-compatible websocket streaming ASR server, batched on one card (port
of ``speechcatcher_tpu/serve/server.py``).

ONE engine with S slots serves all sessions: connections stage audio, a
central batcher ticks the engine with a fixed-size chunk per active session,
and partial/final Vosk JSON flows back per session.

Protocol (Vosk API emulation):
- binary frames: audio (s16le PCM at the configured rate, or any ffmpeg
  format when --format is set and ffmpeg is available)
- text frames: '{"config": {"sample_rate": N}}', '{"eof": 1}', '{"reset": 1}'
- replies: {"partial": "..."} per chunk; {"result": [{conf,start,end,word}],
  "text": "..."} on finalization, with word timings from the tokens' encoder
  frame indices.

A long-lived server must survive a failing session, so three places catch
any exception, log it and go on: the batcher's loop, the batched finalize
(which falls back to finalizing each session alone) and that per-session
finalize (which closes the session with an empty final). Each counts what
it caught in ``SessionManager.caught``; the engine counts the slots it
quarantined in ``StreamingEngine.quarantined``.

The batcher runs ``SessionManager.tick`` on worker threads. The engine reads
no per-thread state of its caller: every tensor names its device, no
parameter requires grad (so the thread's grad mode does not matter), and the
CUDA kernels launch on the current stream of the thread that calls them, the
stream PyTorch's own operators in that thread use.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import subprocess
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from speechcatcher_tpu_torch.serve.engine import StreamingEngine
from speechcatcher_tpu_torch.utils.metrics import TRACER, ServingMetrics
from speechcatcher_tpu_torch.utils.staging import StagingRing

logger = logging.getLogger(__name__)


@dataclass
class Session:
    """Per-connection state: staging ring + endpointing counters."""

    slot: int
    sample_rate: int = 16000
    staged: StagingRing = None  # type: ignore[assignment]
    n_best_lens: List[int] = field(default_factory=list)
    partial_iters: int = 0
    pending_final: bool = False
    # Client sent eof/reset: decode EVERYTHING staged (draining full
    # chunks through normal ticks first), not just the current buffer.
    # Survives intermediate segment finals until the backlog is consumed.
    eof_requested: bool = False
    closed: bool = False
    outbox: Optional[asyncio.Queue] = None
    ffmpeg: Optional[subprocess.Popen] = None

    def __post_init__(self):
        if self.staged is None:
            self.staged = StagingRing()
        self._overflowed = False

    def _check_overflow(self, written: int, requested: int):
        """The staging ring truncates when full (e.g. engine capacity stall
        while the client keeps streaming). Never drop silently."""
        if written < requested:
            if not self._overflowed:
                logger.warning(
                    "session slot=%s staging ring full: dropping audio "
                    "(%d of %d samples written); transcript will be "
                    "incomplete until the engine catches up",
                    self.slot, written, requested,
                )
            self._overflowed = True
        else:
            self._overflowed = False

    def stage_pcm16(self, data: bytes):
        w = self.staged.write_pcm16(data)
        self._check_overflow(w, len(data) // 2)

    def stage_f32(self, x: np.ndarray):
        w = self.staged.write_f32(x)
        self._check_overflow(w, len(x))

    # -- compressed input (webm/mp3/ogg/...) via a per-session ffmpeg
    #    pipeline ------------------------------------------------------------
    def start_ffmpeg(self, audio_format: str, out_rate: int,
                     in_rate: Optional[int] = None):
        """audio_format 's16le' + in_rate: raw-PCM resampling pipeline — a
        STATEFUL resampler, unlike per-message scipy calls whose filter
        edges click at every websocket frame boundary."""
        cmd = ["ffmpeg", "-loglevel", "error"]
        if audio_format == "s16le":
            cmd += ["-f", "s16le", "-ar", str(in_rate or out_rate),
                    "-ac", "1"]
        else:
            cmd += ["-f", audio_format]
        cmd += [
            "-i", "pipe:0",
            "-f", "s16le", "-acodec", "pcm_s16le", "-ac", "1",
            "-ar", str(out_rate), "pipe:1",
        ]
        self.ffmpeg = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, bufsize=10**7,
        )

        def drain():
            try:
                for chunk in iter(lambda: self.ffmpeg.stdout.read(4096), b""):
                    if chunk:
                        self.stage_pcm16(chunk)
            except Exception:
                pass

        self._drain_thread = threading.Thread(target=drain, daemon=True)
        self._drain_thread.start()

    def feed_compressed(self, data: bytes):
        self.ffmpeg.stdin.write(data)
        self.ffmpeg.stdin.flush()


class SessionManager:
    """Engine front: stages audio per session, ticks the batch, applies
    plateau endpointing, assembles Vosk messages. Testable without
    sockets."""

    def __init__(
        self,
        engine: StreamingEngine,
        finalize_update_iters: int = 6,
        max_partial_iters: int = 42,
        wire: str = "int16",
    ):
        self.engine = engine
        self.tokenizer = engine.model.tokenizer
        self.cfg = engine.model.cfg
        self.chunk = engine.A
        self.finalize_update_iters = finalize_update_iters
        self.max_partial_iters = max_partial_iters
        # host->device audio format for the batched tick (serve/wire.py):
        # "int16" (default, bit-exact, half the float32 bytes), "mulaw"
        # (uint8, a quarter; telephone-line quality) or "float32". The
        # staging ring holds float32.
        self.wire = wire
        self.sessions: Dict[int, Session] = {}
        self._next_id = 0
        # Engine state (slot counters, device buffers) is mutated by tick()
        # on a worker thread AND by session open/close on the event loop —
        # serialize every engine-state mutation on one lock, or two threads
        # can acquire the same slot.
        self._lock = threading.RLock()
        self.frame_sec = (
            self.cfg.hop_length * self.cfg.subsample / self.cfg.sample_rate
        )
        # Exceptions caught (and logged) so that serving goes on, by site.
        self.caught = {"batcher": 0, "finalize_batch": 0, "finalize": 0}
        self.metrics = ServingMetrics(
            chunk_seconds=self.chunk / self.cfg.sample_rate
        )

    # -- session lifecycle -------------------------------------------------
    def open_session(self) -> Optional[int]:
        with self._lock:
            slot = self.engine.acquire_slot()
            if slot is None:
                return None  # server busy
            sid = self._next_id
            self._next_id += 1
            self.sessions[sid] = Session(slot=slot)
            return sid

    def close_session(self, sid: int):
        with self._lock:
            sess = self.sessions.pop(sid, None)
        if sess is not None:
            if sess.slot is not None:
                with self._lock:
                    self.engine.release_slot(sess.slot)
                sess.slot = None
            if sess.ffmpeg is not None:
                sess.ffmpeg.terminate()

    # -- data path ----------------------------------------------------------
    def feed(self, sid: int, data: bytes):
        sess = self.sessions.get(sid)
        if sess is not None and not sess.closed:
            sess.stage_pcm16(data)

    def request_final(self, sid: int):
        sess = self.sessions.get(sid)
        if sess is not None:
            sess.pending_final = True
            # eof/reset means "decode EVERYTHING staged": the flag
            # survives segment finals until the backlog is consumed.
            sess.eof_requested = True

    def ready(self) -> bool:
        return any(
            s.staged.available() >= self.chunk or s.pending_final
            for s in list(self.sessions.values())
            if not s.closed
        )

    def tick(self) -> Dict[int, dict]:
        """One engine tick over all sessions with a full chunk staged, then
        finalization for sessions with a pending final. Returns
        sid → Vosk-style message."""
        with self._lock, TRACER.span("serve.tick"):
            return self._tick_locked()

    def _tick_locked(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}

        batch: Dict[int, np.ndarray] = {}
        sid_by_slot: Dict[int, int] = {}
        with TRACER.span("serve.stage"):
            for sid, sess in self.sessions.items():
                if sess.closed or sess.slot is None:
                    continue
                if sess.eof_requested:
                    sess.pending_final = True
                if sess.staged.available() < self.chunk:
                    continue
                if self.engine.slot_would_stall(sess.slot):
                    # Encoder ring at capacity: engine.tick would skip
                    # the chunk, so stop consuming and cut a segment final
                    # instead — the staged backlog continues into the
                    # re-armed slot (no audio lost).
                    sess.pending_final = True
                    continue
                # Backlogs (e.g. a whole file uploaded before {"eof":1})
                # drain through normal full-chunk ticks even when a final
                # is pending; finalize below only ever consumes the
                # sub-chunk remainder.
                chunk = sess.staged.read(self.chunk)
                if self.wire != "float32":
                    from speechcatcher_tpu_torch.serve.wire import (
                        encode_chunk,
                    )

                    chunk = encode_chunk(chunk, self.wire)
                batch[sess.slot] = chunk
                sid_by_slot[sess.slot] = sid

        if batch:
            self.metrics.tick_begin(active_streams=len(batch))
            partials = self.engine.tick(batch)
            self.metrics.tick_end()
            with TRACER.span("serve.partials"):
                for slot, token_ids in partials.items():
                    sid = sid_by_slot[slot]
                    sess = self.sessions[sid]
                    text = self.tokenizer.ids_to_text(token_ids)
                    sess.partial_iters += 1
                    # Plateau endpointing.
                    sess.n_best_lens.append(len(text))
                    n = self.finalize_update_iters
                    if sess.partial_iters > self.max_partial_iters:
                        sess.pending_final = True
                    elif len(sess.n_best_lens) > n and all(
                        x == sess.n_best_lens[-1]
                        for x in sess.n_best_lens[-n:]
                    ) and len(text) > 0:
                        sess.pending_final = True
                    out[sid] = {"partial": text}

        pending = [
            (sid, sess)
            for sid, sess in list(self.sessions.items())
            if sess.pending_final and not sess.closed
            and sess.slot is not None
            and (sess.staged.available() < self.chunk
                 or self.engine.slot_would_stall(sess.slot))
        ]
        if pending:
            # ALL concurrent finals go through ONE batched pass
            # (engine.finalize_batch).
            tails = {}
            for _, sess in pending:
                if (sess.staged.available() >= self.chunk
                        and self.engine.slot_would_stall(sess.slot)):
                    # Segment final at ring capacity: keep the backlog
                    # staged — it continues into the re-armed slot.
                    tails[sess.slot] = np.zeros(0, np.float32)
                else:
                    tails[sess.slot] = sess.staged.drain()
                    sess.eof_requested = False  # backlog fully consumed
            try:
                results = self.engine.finalize_batch(tails)
            except Exception:
                self.caught["finalize_batch"] += 1
                logger.exception("batched finalize failed; per-session "
                                 "fallback")
                results = None
            if results is not None:
                with TRACER.span("serve.finals"):
                    for sid, sess in pending:
                        res = results.get(sess.slot)
                        if res is not None:
                            yseq, xpos, _score = res
                            out[sid] = self._assemble_final(sess, yseq, xpos)
                            self.metrics.finalized()
                        else:
                            # The engine quarantined the slot (its finalize
                            # raised): emit an empty final and close — the
                            # cohort's other results are unaffected.
                            out[sid] = {"result": [], "text": ""}
                            self.close_session(sid)
            else:
                # A failing session must not take the batcher (and every
                # other live session) down with it — finalize each alone,
                # closing the ones that fail. Slots the batched pass
                # already finalized and reset must NOT be re-finalized
                # (that would decode only the tail and emit a truncated
                # transcript).
                for sid, sess in pending:
                    try:
                        if (sess.slot is not None
                                and self.engine.c.active[sess.slot]):
                            out[sid] = self._finalize(sess, tails[sess.slot])
                            self.metrics.finalized()
                        else:
                            out[sid] = {"result": [], "text": ""}
                            self.close_session(sid)
                    except Exception:
                        self.caught["finalize"] += 1
                        logger.exception("finalize failed for session %s",
                                         sid)
                        out[sid] = {"result": [], "text": ""}
                        self.close_session(sid)
        return out

    def _finalize(self, sess: Session, last: Optional[np.ndarray] = None) -> dict:
        if last is None:
            last = sess.staged.drain()
        yseq, xpos, _score = self.engine.finalize(sess.slot, last)
        return self._assemble_final(sess, yseq, xpos)

    def _assemble_final(self, sess: Session, yseq, xpos) -> dict:
        ids = list(map(int, yseq[1:]))
        pos = list(map(int, xpos[1:]))
        if ids and ids[-1] == self.cfg.eos_id:
            ids, pos = ids[:-1], pos[:-1]
        drop = {self.cfg.blank_id, self.tokenizer.unk_id, self.cfg.eos_id}
        words = []
        text_parts = []
        for tid, p in zip(ids, pos):
            if tid in drop:
                continue
            piece = self.tokenizer.token_list[tid]
            start = p * self.frame_sec
            words.append(
                {
                    "conf": 1.0,
                    "start": round(start, 3),
                    "end": round(start + self.frame_sec, 3),
                    "word": piece.replace("▁", " "),
                }
            )
            text_parts.append(piece)
        text = "".join(text_parts).replace("▁", " ").strip()
        # Re-arm the session on the same manager entry with a fresh slot.
        sess.pending_final = False
        sess.n_best_lens = []
        sess.partial_iters = 0
        slot = self.engine.acquire_slot()
        if slot is None:
            # No capacity to re-arm: the session is done. Null the slot so
            # close_session cannot release a slot the session no longer
            # owns, and tick()/feed() skip it from now on.
            sess.closed = True
            sess.slot = None
        else:
            sess.slot = slot
        return {"result": words, "text": text}


# ---------------------------------------------------------------------------
# Websocket layer
# ---------------------------------------------------------------------------

async def _batcher(manager: SessionManager, tick_interval: float):
    """Central loop: tick whenever any session has a full chunk staged.
    The loop must survive any per-tick exception (serving is long-lived)."""
    while True:
        try:
            if manager.ready():
                out = await asyncio.to_thread(manager.tick)
                for sid, msg in out.items():
                    sess = manager.sessions.get(sid)
                    if sess is not None and sess.outbox is not None:
                        await sess.outbox.put(json.dumps(msg))
                        if sess.closed:
                            # Final delivered but no slot left to re-arm:
                            # tell the sender to close the connection.
                            await sess.outbox.put(None)
            else:
                await asyncio.sleep(tick_interval)
        except asyncio.CancelledError:
            raise
        except Exception:
            manager.caught["batcher"] += 1
            logger.exception("tick failed; continuing")
            await asyncio.sleep(tick_interval)


async def recognize_ws(connection, manager: SessionManager,
                       audio_format: str = "s16le"):
    # open/close take manager._lock, which tick() holds for a whole tick
    # on a worker thread — run them off the event loop or every websocket
    # freezes for up to a tick on connect/disconnect.
    sid = await asyncio.to_thread(manager.open_session)
    if sid is None:
        await connection.send("Server busy, please try again later.")
        await connection.close()
        return
    sess = manager.sessions[sid]
    sess.outbox = asyncio.Queue()
    if audio_format not in ("s16le", "pcm"):
        from speechcatcher_tpu_torch.utils.audio import have_ffmpeg

        if have_ffmpeg():
            sess.start_ffmpeg(audio_format, manager.cfg.sample_rate)
        else:
            logger.warning(
                "format %s requested but ffmpeg is unavailable; expecting "
                "s16le PCM", audio_format,
            )

    async def sender():
        while True:
            msg = await sess.outbox.get()
            if msg is None:
                await connection.close()
                return
            await connection.send(msg)

    send_task = asyncio.create_task(sender())
    try:
        async for message in connection:
            if isinstance(message, str):
                try:
                    msg = json.loads(message)
                except json.JSONDecodeError:
                    continue
                if msg.get("eof") == 1 or msg.get("reset") == 1:
                    manager.request_final(sid)
                elif "config" in msg:
                    sess.sample_rate = int(
                        msg["config"].get("sample_rate", 16000)
                    )
                    if (sess.sample_rate != manager.cfg.sample_rate
                            and sess.ffmpeg is None):
                        from speechcatcher_tpu_torch.utils.audio import (
                            have_ffmpeg,
                        )

                        if have_ffmpeg():
                            # Stateful resampling pipeline; the scipy
                            # per-message fallback below clicks at frame
                            # boundaries (stateless filter edges).
                            sess.start_ffmpeg(
                                "s16le", manager.cfg.sample_rate,
                                in_rate=sess.sample_rate,
                            )
                        else:
                            logger.warning(
                                "no ffmpeg: resampling %d->%d Hz "
                                "per-message (filter-edge artifacts at "
                                "frame boundaries)", sess.sample_rate,
                                manager.cfg.sample_rate,
                            )
                    await connection.send(json.dumps({"partial": ""}))
            else:
                if sess.ffmpeg is not None:
                    await asyncio.to_thread(sess.feed_compressed, message)
                elif sess.sample_rate != manager.cfg.sample_rate:
                    pcm = np.frombuffer(message, dtype=np.int16)
                    from speechcatcher_tpu_torch.utils.audio import (
                        resample_int16,
                    )

                    pcm = resample_int16(
                        pcm, sess.sample_rate, manager.cfg.sample_rate
                    )
                    sess.stage_f32(pcm.astype(np.float32) / 32767.0)
                else:
                    manager.feed(sid, message)
    except Exception:
        logger.info("Client disconnected")
    finally:
        send_task.cancel()
        await asyncio.to_thread(manager.close_session, sid)


async def start_server(host: str, port: int, manager: SessionManager,
                       tick_interval: float = 0.02,
                       audio_format: str = "s16le"):
    """Serve until cancelled; the batcher stops with the server."""
    import websockets

    batch_task = asyncio.create_task(_batcher(manager, tick_interval))

    async def handler(connection):
        await recognize_ws(connection, manager, audio_format=audio_format)

    try:
        async with websockets.serve(handler, host, port):
            await asyncio.Future()
    finally:
        batch_task.cancel()


def main(argv=None):
    from speechcatcher_tpu_torch.recognize import load_model

    parser = argparse.ArgumentParser(
        description="speechcatcher_tpu_torch websocket server "
        "(Vosk-compatible)"
    )
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=2700)
    parser.add_argument("--model", type=str,
                        default="de_streaming_transformer_xl")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda (the default) or cpu; cuda raises on a "
                        "machine without it")
    parser.add_argument("--beamsize", type=int, default=3)
    parser.add_argument("--cache-dir", type=str,
                        default="~/.cache/speechcatcher_tpu")
    parser.add_argument("--pool-size", type=int, default=64,
                        help="Concurrent stream slots (one model copy)")
    parser.add_argument("--format", type=str, default="s16le",
                        choices=["s16le", "wav", "mp3", "mp4", "webm", "ogg"],
                        help="Input stream format (non-PCM needs ffmpeg)")
    parser.add_argument("--dp", type=int, default=1,
                        help="Shard stream slots over this many cards (one "
                        "engine replica per card, ticking concurrently; no "
                        "traffic between cards)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of process 0's rendezvous for "
                        "multi-host serving (one process per host, each "
                        "serving its block of the slots on its own cards); "
                        "omit for one host")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="Total number of hosts (with --coordinator)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="This host's rank (with --coordinator)")
    parser.add_argument("--finalize-update-iters", type=int, default=6)
    parser.add_argument("--max_partial_iters", type=int, default=42)
    parser.add_argument("--wire", type=str, default="int16",
                        choices=["float32", "int16", "mulaw"],
                        help="host->device audio format for the batched "
                        "tick: int16 is bit-exact at half the float32 "
                        "bytes; mulaw is uint8 telephone-grade companding "
                        "at a quarter (serve/wire.py)")
    args = parser.parse_args(argv)

    from speechcatcher_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_hybrid_mesh,
        make_mesh,
    )
    from speechcatcher_tpu_torch.parallel.serve_sharding import shard_engine

    # The cards this process serves on: every local card, or the CPU.
    local = None if args.device == "cuda" else ["cpu"]
    mesh = None
    try:
        # Serving exchanges no tensor between processes, only the host
        # names and card counts of the mesh: a gloo group carries them.
        if initialize_distributed(args.coordinator, args.num_processes,
                                  args.process_id, backend="gloo"):
            # Global (dp, tp=1) mesh over every host's cards; each process
            # serves its own block of the slot axis.
            mesh = make_hybrid_mesh(tp=1, local_devices=local)
        elif args.dp > 1:
            mesh = make_mesh(args.dp, tp=1, devices=local)
    except ValueError as e:
        parser.error(str(e))

    s2t = load_model(tag=args.model, device=args.device,
                     beam_size=args.beamsize, cache_dir=args.cache_dir)
    engine = StreamingEngine(
        s2t.model, n_slots=args.pool_size, beam_size=args.beamsize,
        device=args.device,
    )
    if mesh is not None:
        engine = shard_engine(engine, mesh)
    manager = SessionManager(
        engine,
        finalize_update_iters=args.finalize_update_iters,
        max_partial_iters=args.max_partial_iters,
        wire=args.wire,
    )
    print(f"Serving {engine.S} concurrent streams on "
          f"ws://{args.host}:{args.port}")
    asyncio.run(start_server(args.host, args.port, manager,
                             audio_format=args.format))


if __name__ == "__main__":
    main()
