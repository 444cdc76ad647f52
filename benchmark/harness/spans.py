"""The harness's own spans and counters, recorded from outside the program
around its calls (the program has no tracing of its own yet): a wrapper
times a bound method on the host clock, and a wrapper of the beam loop's
``run`` reads the loop's counters before and after each block.

With ``steps`` on (the traced run), the wrapper also logs what each beam
step of a block reads: per stream whether it steps, its prefix length and
its visible CTC frames. The loop's state lies at fixed addresses; on the
card each step's values are copied to pinned host memory on the stream
ahead of the step's replay, so the log adds no host wait, and are read once
the block's last step has been waited for."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

# Steps of one block the pinned log holds; a longer block's later steps
# are read synchronously.
LOG_STEPS = 512


class Spans:
    """Spans by name, as (start, end) host-clock seconds, recorded while
    ``on``; under ``annotate`` each call is also a profiler range of that
    name. ``blocks`` holds one dict a decoded block."""

    def __init__(self):
        self.on = False
        self.annotate = False
        self.steps = False
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.blocks: List[Dict] = []
        self.log_s = 0.0
        self._pinned: Dict = {}

    def reset(self) -> None:
        self.spans.clear()
        self.blocks.clear()
        self.log_s = 0.0

    def wrap(self, name: str, fn: Callable) -> Callable:
        def timed(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            ctx = contextlib.nullcontext()
            if self.annotate:
                import torch

                ctx = torch.profiler.record_function(name)
            t0 = time.perf_counter()
            with ctx:
                out = fn(*args, **kwargs)
            self.spans[name].append((t0, time.perf_counter()))
            return out

        return timed

    def mean_ms(self, name: str) -> float:
        s = self.spans.get(name)
        if not s:
            return float("nan")
        return 1e3 * sum(b - a for a, b in s) / len(s)

    def pin(self, streams: int) -> None:
        """Allocate the pinned step log for loops of up to `streams`
        streams (in set-up: pinned allocations wait on the card)."""
        import torch

        if torch.cuda.is_available():
            self._pinned = {
                name: torch.zeros((LOG_STEPS, streams), dtype=dt).pin_memory()
                for name, dt in zip(FIELDS, (torch.bool, torch.int32,
                                             torch.int32))}

    def watch_block_loops(self, loop_cls) -> Callable[[], None]:
        """Record each block of every beam loop: streams stepping, live
        beam steps, host syncs, mean frames visible to the stepping
        streams; with ``steps``, the step log. Returns the function that
        undoes the wrap."""
        original = loop_cls.run
        spans = self

        def run(loop, vis, n_new, new_vis, stepping, block_final):
            if not spans.on:
                return original(loop, vis, n_new, new_vis, stepping,
                                block_final)
            steps0, syncs0 = loop.steps, loop.syncs
            log = (StepLog(loop, spans._pinned if loop.graphed else {})
                   if spans.steps else None)
            with (log.attached() if log else contextlib.nullcontext()):
                original(loop, vis, n_new, new_vis, stepping, block_final)
            live = [int(v) for v, s in zip(new_vis, stepping) if s]
            block = {"streams": len(live), "steps": loop.steps - steps0,
                     "syncs": loop.syncs - syncs0,
                     "vis": sum(live) / len(live) if live else 0.0}
            if log is not None:
                t = time.perf_counter()
                block.update(log.read(), new_vis=[int(v) for v in new_vis])
                spans.log_s += log.spent + time.perf_counter() - t
            spans.blocks.append(block)

        loop_cls.run = run
        return lambda: setattr(loop_cls, "run", original)


FIELDS = ("stepping", "ylen", "end")


class StepLog:
    """What each beam step of one block of `loop` reads, logged ahead of
    the step: per stream ``stepping``, ``ylen`` (the prefix length with
    SOS) and ``end`` (the visible CTC frames): with ``olen`` = ylen - 1,
    the operands of the CTC recursion (kernel B) that every step launches
    over all S streams."""

    def __init__(self, loop, pinned: Dict):
        self.loop = loop
        self.pinned = pinned
        self.times: List[float] = []
        self.sync: List[Tuple[np.ndarray, ...]] = []
        self.spent = 0.0

    def _fields(self):
        st = self.loop.state
        return st.stepping, st.arrays.ylen, st.arrays.ctc.enc_len

    def _fits(self, fields) -> bool:
        return (bool(self.pinned) and len(self.times) < LOG_STEPS
                and not self.sync
                and all(x.shape[0] <= self.pinned[n].shape[1]
                        and x.dtype == self.pinned[n].dtype
                        for n, x in zip(FIELDS, fields)))

    def snap(self) -> None:
        t = time.perf_counter()
        fields = self._fields()
        if self._fits(fields):
            i = len(self.times)
            for n, x in zip(FIELDS, fields):
                self.pinned[n][i, :x.shape[0]].copy_(x, non_blocking=True)
        else:
            self.sync.append(tuple(x.cpu().numpy().astype(np.int64)
                                   for x in fields))
        self.times.append(t)
        self.spent += time.perf_counter() - t

    @contextlib.contextmanager
    def attached(self):
        """Log each step of the blocks run inside: before each replay of
        the step graph, or each eager step."""
        loop = self.loop
        target, name = ((loop.capture()[1], "replay") if loop.graphed
                        else (loop, "_step"))
        inner = getattr(target, name)

        def logged(*args, **kwargs):
            self.snap()
            return inner(*args, **kwargs)

        setattr(target, name, logged)
        try:
            yield
        finally:
            delattr(target, name)

    def read(self) -> Dict:
        """The block's steps: host time, and per step the streams'
        stepping, olen and end; the recursion's t_cap and beam."""
        st = self.loop.state
        s = st.stepping.shape[0]
        n_pinned = len(self.times) - len(self.sync)
        steps = [tuple(self.pinned[n][i, :s].numpy().astype(np.int64)
                       for n in FIELDS) for i in range(n_pinned)]
        steps.extend(self.sync)
        return {"step_t": list(self.times),
                "stepping": [x[0].tolist() for x in steps],
                "olen": [(x[1] - 1).tolist() for x in steps],
                "end": [x[2].tolist() for x in steps],
                "t_cap": int(st.arrays.ctc.r.shape[-1]),
                "beam": int(st.arrays.ctc.r.shape[1])}
