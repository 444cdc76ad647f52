"""The block beam loop, the session's chunk step and programs of a batch
as CUDA graphs, and what they need to capture work.

The session's chunk step (``ChunkStep``, at the end) is the counterpart of
the JAX package's jit-compiled ``logmel_frontend``, ``_subsample_jit`` and
``_infer_core`` / ``_infer_short``: a graph per static signature over an
encoder carry at fixed addresses. ``SignatureGraphs`` captures a program
of tensors once per signature of its inputs over static buffers: the
trainer's step and its eval programs (``training.py``), the counterparts
of the JAX package's jitted ``train_step``, ``_eval_metrics`` and
``_encode_and_collapse``.

Counterpart of the JAX package's device-resident loops: its
``decode_block_device`` runs a block's beam loop as one ``lax.while_loop``,
and its engine runs a whole tick as one program. Here a block's loop is three
CUDA graphs over state at fixed addresses (``BlockLoop``), captured once per
caller (one static signature: S, beam, Lmax, Tcap, the ring and cache
dtypes, the weights, ``eos_commit``, ``use_bbd``; ``block_final`` is an
input tensor), in one memory pool:

- prologue: the block's new frames through ``block_extend``
  (ctc_log_softmax → ctc_extend, kernel C), then ``project_cross_kv`` into
  buffers the step graph reads;
- step: ``STEPS_PER_REPLAY`` unrolled ``block_step``s (kernel B and the
  decoder's GEMMs in each);
- epilogue: ``block_rewind``.

The host uploads the block's per-stream integers, replays the prologue,
replays the step graph until a pinned readback of ``any(stepping)`` (one per
replay) comes back false, then replays the epilogue: ⌈steps / K⌉ host syncs
a block where the eager loop (``beam_search.decode_block_device``) makes
steps + 1. A step after every stream has stopped is a bit-exact identity,
so the unrolled loop is exact. Each graph ends by copying its results into
the tensors it read (``write_tree``); the CTC log-prob ring, the raw frame
ring and the decoder's and the LM's caches are read and appended where they
lie, never copied per block.

No switch and no fallback: on a CUDA device a capture or replay that fails
raises. The same three programs run eagerly on the CPU and under a tp group
(``parallel.tp``), whose gloo collectives go through host memory and cannot
be captured (that loop is eager by configuration): one beam step at a time
behind a host read of ``any(stepping)``, as ``decode_block_device`` does.

Launch counters: a kernel wrapper that launches during a capture counts
into the capture's record (``ops.kernels._plan.recording``), launches on
the capture stream from autograd's backward thread included, and every
replay adds its graph's record, so the counts are the launches the card
runs.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from speechcatcher_tpu_torch import geometry
from speechcatcher_tpu_torch.decode import beam_search as bs
from speechcatcher_tpu_torch.models import encoder as enc
from speechcatcher_tpu_torch.models.decoder import project_cross_kv
from speechcatcher_tpu_torch.ops.frontend import (
    logmel_of_frames,
    reflect_frames,
)
from speechcatcher_tpu_torch.ops.kernels import _plan
from speechcatcher_tpu_torch.parallel.tp import tp_group
from speechcatcher_tpu_torch.utils.metrics import TRACER

# Beam steps per replay of the step graph (K). A block of n live steps
# costs max(1, ceil(n / K)) host waits and K * max(1, ceil(n / K)) - n
# masked steps past the stop. chip_smoke.py's graph_path measures both
# costs on the card and prices K = 1, 2, 4, 8 over the steps per block of
# the token-rich fixture decodes (PERF.md §6).
STEPS_PER_REPLAY = 1


# ---------------------------------------------------------------------------
# Trees of tensors (NamedTuples, lists, tuples)
# ---------------------------------------------------------------------------

# A tree's None is an absent leaf (the beam's LM fields without an LM): it
# holds nothing, maps to None and copies nothing.

def tree_leaves(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_map(fn: Callable, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, list):
        return [tree_map(fn, x) for x in tree]
    if isinstance(tree, tuple):
        items = [tree_map(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def clone_tree(tree):
    return tree_map(torch.clone, tree)


def write_tree(dst, src) -> None:
    """Copy every tensor of `src` into the tensor at the same place of
    `dst`, in place. A leaf that is its own destination is skipped; one
    that shares memory with a destination is copied out first, so no write
    clobbers a value still to be read."""
    dst_leaves, src_leaves = tree_leaves(dst), tree_leaves(src)
    if len(dst_leaves) != len(src_leaves):
        raise ValueError("write_tree: the trees differ in structure")
    pairs = []
    for d, s in zip(dst_leaves, src_leaves):
        if s.shape != d.shape:
            raise ValueError(f"write_tree: {tuple(s.shape)} into "
                             f"{tuple(d.shape)}")
        if s is not d:
            pairs.append((d, s))
    targets = {d.untyped_storage().data_ptr() for d, _ in pairs if d.numel()}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in targets
              else s) for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


# ---------------------------------------------------------------------------
# Host <-> device without a full sync
# ---------------------------------------------------------------------------

class Upload:
    """A device tensor the host rewrites before each use. On the card the
    values go through pinned memory and an asynchronous copy (a blocking
    copy would wait for the whole queue); the next write waits for that
    copy only."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        self.host = self.done = None
        if self.dev.is_cuda:
            self.host = torch.zeros(shape, dtype=dtype).pin_memory()
            self.done = torch.cuda.Event()

    def put(self, values: np.ndarray) -> torch.Tensor:
        if self.host is None:
            self.dev.copy_(torch.from_numpy(np.ascontiguousarray(values)))
            return self.dev
        self.done.synchronize()
        self.host.numpy()[...] = values
        self.dev.copy_(self.host, non_blocking=True)
        self.done.record()
        return self.dev


class Readback:
    """A small device tensor read on the host through pinned memory: one
    wait for the work queued before it."""

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self.host = torch.zeros(dev.shape, dtype=dev.dtype).pin_memory()
        self.done = torch.cuda.Event()

    def read(self) -> list:
        self.host.copy_(self.dev, non_blocking=True)
        self.done.record()
        self.done.synchronize()
        return self.host.tolist()


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------

class GraphRecord(NamedTuple):
    """A captured graph: its name, the bytes its capture reserved on the
    card (``torch.cuda.memory_stats``) and the kernel launches of one
    replay."""

    name: str
    pool_bytes: int
    launches: Dict[str, int]


# Every graph this process captured, in order.
CAPTURED: List[GraphRecord] = []

# Captures run one at a time: engine replicas share a card and a host.
_CAPTURE_LOCK = threading.Lock()


def _reserved() -> int:
    return torch.cuda.memory_stats().get("reserved_bytes.all.current", 0)


@contextlib.contextmanager
def _no_cyclic_gc():
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class Graph:
    """One captured program; ``replay`` adds its launches to the counters.
    ``pool_bytes`` is what its capture reserved on the card."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: dict,
                 name: str, pool_bytes: int = 0):
        self.graph = graph
        self.launches = launches
        self.name = name
        self.pool_bytes = pool_bytes
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        _plan.add_counts(self.launches)


def capture_graphs(programs: Sequence, warmup: Callable,
                   pool) -> List[Graph]:
    """Capture each (name, fn) of `programs`, in order, into one memory
    pool. `warmup` first runs the same work eagerly on copies of the state
    (on a side stream, its launches not counted), so every plan, handle and
    cache exists before the capture; the captures themselves change
    nothing. Captures run one at a time in the process, and in thread-local
    mode: another thread's work on the card goes on meanwhile. Python's
    cyclic garbage collector is off meanwhile: collected garbage can hold
    graphs (a sharded engine and its counters refer to each other), and a
    graph destroyed during a capture invalidates it."""
    with TRACER.span("graphs.capture"), _CAPTURE_LOCK, _no_cyclic_gc():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), _plan.recording(side):
            warmup()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        # torch.cuda.graph empties the allocator's cache on entry: do it
        # first, so the reserved bytes grow by what the capture keeps.
        torch.cuda.empty_cache()
        out = []
        for name, fn in programs:
            graph = torch.cuda.CUDAGraph()
            before = _reserved()
            capture = torch.cuda.graph(graph, pool=pool,
                                       capture_error_mode="thread_local")
            with _plan.recording(capture.capture_stream) as rec, capture:
                fn()
            launches = {f.__name__: n for (f, attr), n in rec.items()}
            reserved = _reserved() - before
            CAPTURED.append(GraphRecord(name, reserved, launches))
            out.append(Graph(graph, rec, name, reserved))
        return out


class _Signature(NamedTuple):
    graph: Graph
    inputs: List[torch.Tensor]
    outputs: List[torch.Tensor]
    keep: tuple


class SignatureGraphs:
    """A program of tensors as one CUDA graph per static signature (the
    inputs' shapes and dtypes and a caller's key), over static input and
    output buffers: the counterpart of a jit-compiled function, whose cache
    holds one executable per signature. The train step and the eval
    programs run through it (``training.py``).

    ``run`` copies the inputs into their signature's buffers, replays its
    graph and returns copies of the outputs. A signature is captured at
    first use: its buffers are allocated outside the memory pool, the
    program runs once eagerly on them (``warmup``, the program itself
    unless given: it must then change nothing it does not return), which
    also gives the outputs' shapes, and the capture ends by copying the
    program's results into the output buffers. All signatures share one
    pool: each graph's results go to buffers outside it, so no graph holds
    pool memory that another's replay overwrites, and the pool is about
    the largest signature's. No fallback: a capture or replay that fails
    raises."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.entries: Dict[tuple, _Signature] = {}

    def run(self, key, name: str, inputs: Sequence[torch.Tensor],
            program: Callable, warmup: Optional[Callable] = None,
            keep: tuple = (), device=None) -> List[torch.Tensor]:
        """Outputs of ``program(*inputs)`` on static copies of `inputs` (on
        `device`, by default the inputs'). `keep` holds what the graph
        reads that nothing else may (cached constants)."""
        sig = (key, *((tuple(x.shape), x.dtype) for x in inputs))
        entry = self.entries.get(sig)
        if entry is None:
            entry = self.entries[sig] = self._capture(
                name, inputs, program, warmup or program, keep, device)
        for dst, src in zip(entry.inputs, inputs):
            dst.copy_(src)
        entry.graph.replay()
        return [x.clone() for x in entry.outputs]

    def _capture(self, name, inputs, program, warmup, keep, device):
        static = [torch.empty(x.shape, dtype=x.dtype,
                              device=device or x.device) for x in inputs]
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        outputs: List[torch.Tensor] = []

        def warm():
            outputs.extend(torch.empty_like(r) for r in warmup(*static))

        def capture():
            for dst, src in zip(outputs, program(*static)):
                dst.copy_(src)

        graph, = capture_graphs([(name, capture)], warm, self.pool)
        return _Signature(graph, static, outputs, keep)

    def pool_bytes(self) -> int:
        """What the captures reserved on the card, all signatures."""
        return sum(e.graph.pool_bytes for e in self.entries.values())


# ---------------------------------------------------------------------------
# The block loop
# ---------------------------------------------------------------------------

class BlockLoop:
    """The beam loop of one block for S streams whose state lies at fixed
    addresses: ``state`` (a ``BlockDecodeState``, written in place) and the
    raw frame ring ``memory`` (S, Tcap, d), read in place.

    ``frames(ints)`` gives the block's new frames (S, Tnew, d) float32 from
    the uploaded integers (rows [vis, n_new, new_vis, stepping,
    block_final]): the engine gathers them from its ring, a session hands
    its own buffer. Graphed on a CUDA device outside a tp group; the same
    programs run eagerly otherwise (``_run_eager``)."""

    def __init__(self, model, state: "bs.BlockDecodeState",
                 memory: torch.Tensor, settings: "bs.LoopSettings",
                 frames: Callable[[torch.Tensor], torch.Tensor],
                 extcap: int, pool=None):
        self.model = model
        self.state = state
        self.memory = memory
        self.settings = settings
        self.frames = frames
        self.extcap = extcap
        self.graphed = memory.is_cuda and tp_group() is None
        self.ints = Upload((5, memory.shape[0]), torch.int32, memory.device)
        self.stepping0 = torch.zeros_like(state.stepping)
        self._pool = pool
        self._graphs: Optional[List[Graph]] = None
        self._key = None
        self._flag: Optional[Readback] = None
        # What the captured programs hand each other (the prologue's cross
        # K/V), kept so that no later capture in the pool reuses it.
        self._held: dict = {}
        # Live beam steps (some stream stepping), step replays (each one
        # host sync) and the most steps of one block, over the graphed runs;
        # blocks by their live steps.
        self.blocks = self.steps = self.syncs = self.max_steps = 0
        self.step_counts: collections.Counter = collections.Counter()
        # The LM rows a beam step scores (every hypothesis of every stream),
        # for the tracer's ``lm.rows``; 0 without an LM.
        self.lm_rows = (memory.shape[0] * settings.beam
                        if model.cfg.lm_layers else 0)
        # The K/V rows a beam step's cross-attention reads a layer (each
        # stream's visible frames, set by ``run``) and the ring's rows, for
        # the tracer's ``cross.rows`` and ``cross.ring_rows``.
        self.cross_rows = 0
        self.cross_ring_rows = memory.shape[0] * memory.shape[1]

    def run(self, vis, n_new, new_vis, stepping, block_final) -> None:
        """Decode one block: per-stream frames visible so far, frames added,
        frames visible after, whether the stream steps, whether the block
        is its last."""
        with TRACER.span("beam.block"):
            ints = np.stack([np.asarray(x) for x in
                             (vis, n_new, new_vis, stepping,
                              block_final)]).astype(np.int32)
            self.ints.put(ints)
            self.cross_rows = int(np.minimum(ints[2],
                                             self.memory.shape[1]).sum())
            if self.graphed:
                self._run_graphs()
            else:
                self._run_eager()

    # -- programs over any copy of the state --------------------------------
    def _prologue(self, state, stepping0, out: dict) -> None:
        m = self.model
        ints = self.ints.dev
        st = bs.block_extend(m.params, state, self.frames(ints), ints[1],
                             ints[3].bool())
        out["cross_kv"] = project_cross_kv(m.params["decoder"], self.memory,
                                           m.cfg.decoder_heads,
                                           state.dec_cache.h.dtype)
        write_tree(state, st)
        stepping0.copy_(st.stepping)

    def _step(self, state, cross_kv, flag: torch.Tensor,
              steps: Optional[int] = None) -> None:
        """`steps` beam steps (STEPS_PER_REPLAY by default); `flag` gets
        [any stream still stepping, live steps among them]."""
        m = self.model
        ints = self.ints.dev
        st = state
        live = torch.zeros((), dtype=torch.int32, device=flag.device)
        for _ in range(STEPS_PER_REPLAY if steps is None else steps):
            live = live + st.stepping.any()
            st = bs.block_step(m.params, m.dec_pe, cross_kv, st, ints[2],
                               ints[4].bool(), m.cfg, self.settings)
        write_tree(state, st)
        flag.copy_(torch.stack([st.stepping.any().to(torch.int32),
                                live.to(torch.int32)]))

    def _epilogue(self, state, stepping0) -> None:
        write_tree(state, bs.block_rewind(state, stepping0))

    # -- graphs ---------------------------------------------------------------
    def capture(self) -> List[Graph]:
        """The three graphs of this loop (captured on first use, and again
        if the model's weights or the loop's settings were replaced)."""
        key = (self.model.params, self.settings)
        if self._graphs is not None and self._key[0] is key[0] \
                and self._key[1] == key[1]:
            return self._graphs
        flag = torch.zeros(2, dtype=torch.int32, device=self.memory.device)
        held = self._held = {}

        def warmup():
            w_state = clone_tree(self.state)
            w_step0 = self.stepping0.clone()
            w_out: dict = {}
            self._prologue(w_state, w_step0, w_out)
            self._step(w_state, w_out["cross_kv"], flag.clone())
            self._epilogue(w_state, w_step0)

        pool = self._pool if self._pool is not None else \
            torch.cuda.graph_pool_handle()
        s_dim = self.memory.shape[0]
        name = f"block_loop(S={s_dim})"
        self._graphs = capture_graphs(
            [(name + ".prologue",
              lambda: self._prologue(self.state, self.stepping0, held)),
             (name + ".step",
              lambda: self._step(self.state, held["cross_kv"], flag)),
             (name + ".epilogue",
              lambda: self._epilogue(self.state, self.stepping0))],
            warmup, pool)
        self._flag = Readback(flag)
        self._key = key
        return self._graphs

    def _run_graphs(self) -> None:
        prologue, step, epilogue = self.capture()
        prologue.replay()
        steps = 0
        while True:
            step.replay()
            self._count_step(STEPS_PER_REPLAY)
            with TRACER.span("beam.sync"):
                any_stepping, live = self._flag.read()
            self.syncs += 1
            steps += live
            if not any_stepping:
                break
        epilogue.replay()
        self.blocks += 1
        self.steps += steps
        self.max_steps = max(self.max_steps, steps)
        self.step_counts[steps] += 1

    def _run_eager(self) -> None:
        """The block through the same programs without graphs, one beam
        step at a time behind a host read of ``any(stepping)`` (steps + 1
        syncs, as ``decode_block_device``): the CPU and tp route, and the
        reference the graphs are held against."""
        held: dict = {}
        self._prologue(self.state, self.stepping0, held)
        flag = torch.zeros(2, dtype=torch.int32, device=self.memory.device)
        while bool(self.state.stepping.any()):
            self._step(self.state, held["cross_kv"], flag, steps=1)
            self._count_step(1)
        self._epilogue(self.state, self.stepping0)

    def _count_step(self, steps: int) -> None:
        """The tracer's counters of `steps` beam steps."""
        if self.lm_rows:
            TRACER.count("lm.rows", self.lm_rows * steps)
        TRACER.count("cross.rows", self.cross_rows * steps)
        TRACER.count("cross.ring_rows", self.cross_ring_rows * steps)


# ---------------------------------------------------------------------------
# The session's chunk step
# ---------------------------------------------------------------------------

class ChunkInput(NamedTuple):
    """A chunk's input to ``ChunkStep.step``:

    - "wave": float32 samples (numpy) through the frontend, `lo` frames cut
      at the start and `hi` at the end of their 1 + len // hop frames;
    - "features": (T, n_mels) numpy features through the normalisation;
    - "normalized": a (1, T, n_mels) float32 tensor, taken as it is."""

    kind: str
    data: object
    lo: int = 0
    hi: int = 0

    def n_frames(self, hop: int) -> int:
        """The chunk's feature frames."""
        if self.kind == "wave":
            return 1 + len(self.data) // hop - self.lo - self.hi
        return self.data.shape[-2]

    def key(self, hop: int) -> Optional[tuple]:
        """The static signature of the input's program (None: no program,
        the tensor is copied in)."""
        if self.kind == "wave":
            return ("frontend", 1 + len(self.data) // hop, self.lo, self.hi)
        if self.kind == "features":
            return ("normalize", self.data.shape[0])
        return None


def chunk_graph_keys(input_key: Optional[tuple],
                     plan: "geometry.ChunkPlan") -> List[tuple]:
    """The static signatures of a chunk's programs, in order: its input's,
    the subsampling's (the plan's feature lengths; none while buffering or
    when no frame is left to subsample) and the blocks' (the plan's block
    geometry; none unless blocks run). Each is one graph."""
    keys = [] if input_key is None else [input_key]
    if plan.n_sub > 0 and plan.kind != "buffer":
        keys.append(("subsample", plan._replace(
            kind="", first_chunk=False, total=0, n_blocks_in=0, block_num=0,
            y_length=0, n_after=0, npb=0)))
    if plan.kind in ("short", "blocks"):
        keys.append(("blocks", plan._replace(
            n_in=0, n_conv_in=0, n_sub=0, n_before=0, npb=0)))
    return keys


def graph_name(key: tuple) -> str:
    if key[0] == "frontend":
        return f"chunk.frontend(T={key[1]}, lo={key[2]}, hi={key[3]})"
    if key[0] == "normalize":
        return f"chunk.normalize(T={key[1]})"
    p = key[1]
    if key[0] == "subsample":
        return f"chunk.subsample(n_in={p.n_in}, final={p.is_final})"
    return (f"chunk.blocks({p.kind}, total={p.total}, first={p.first_chunk}"
            f", final={p.is_final})")


class ChunkStep:
    """The session's chunk step over an encoder carry at fixed addresses:
    the chunk's input into ``carry.raw`` (the frontend of a waveform or the
    normalisation of features, each read from a pinned upload into a
    static buffer of the input's length), the conv subsampling into
    ``carry.post`` and the blocks, whose emitted frames kernel D appends
    to ``ring`` (1, max_enc_frames, d) float32 at the host's fill
    ``enc_len``.

    Counterpart of the JAX package's jit-compiled ``logmel_frontend``,
    ``_subsample_jit`` and ``_infer_core`` / ``_infer_short``: each of the
    three is one CUDA graph per static signature (``chunk_graph_keys``),
    captured at first use or ahead (``capture``) into the session's pool.
    The host keeps every length (``geometry.plan_chunk``) and uploads the
    stream's offsets as device integers (``CHUNK_INTS``), once a chunk, so
    the stream's position is no part of a signature. The frontend's signature
    is its frame count: a final tail's sample count is a device integer
    (``reflect_frames``). No switch and no fallback: on a CUDA device a
    capture or replay that fails raises. On the CPU and under a tp group
    the same programs run eagerly."""

    def __init__(self, model):
        cfg = self.cfg = model.cfg
        self.frontend = model.frontend
        self.encoder = enc.StreamingEncoder(model.params["encoder"], cfg,
                                            model.enc_pe)
        dev = self.encoder.device
        self.carry = enc.init_carry(cfg, dev)
        self.ring = torch.zeros((1, cfg.max_enc_frames, cfg.encoder_dim),
                                device=dev)
        self.ints = Upload((len(enc.CHUNK_INTS),), torch.int32, dev)
        self.graphed = dev.type == "cuda" and tp_group() is None
        # The session's memory pool, shared with its block loop's graphs.
        self.pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._graphs: Dict[tuple, Graph] = {}
        self._inputs: Dict[tuple, Upload] = {}
        self.reset()

    def reset(self) -> None:
        """A fresh stream: lengths to 0, the carry and the ring zeroed in
        place (graphs and input buffers stay)."""
        self._new_stream()
        self.enc_len = 0
        for t in self.carry:
            t.zero_()
        self.ring.zero_()

    def _new_stream(self) -> None:
        self.n_before = self.n_after = self.npb = 0
        self.has_prev = self.has_past = False

    def load(self, state: "enc.EncoderState",
             frames: Optional[torch.Tensor]) -> None:
        """Take over a stream: its encoder state and the (1, L, d) frames it
        emitted so far (the engine's finalize)."""
        self.reset()
        c = self.carry
        if state.buf_before is not None:
            self.n_before = state.buf_before.shape[1]
            c.raw[:, :self.n_before] = state.buf_before
        if state.buf_after is not None:
            self.n_after = state.buf_after.shape[1]
            c.post[:, :self.n_after] = state.buf_after
        if state.prev_addin is not None:
            c.prev_addin.copy_(state.prev_addin)
            self.has_prev = True
        if state.past_ctx is not None:
            c.past_ctx.copy_(state.past_ctx)
            self.has_past = True
        self.npb = state.n_processed_blocks
        if frames is not None and frames.shape[1]:
            if frames.shape[1] > self.cfg.max_enc_frames:
                raise_too_long(self.cfg, frames.shape[1])
            self.enc_len = frames.shape[1]
            self.ring[:, :self.enc_len] = frames

    def state(self) -> "enc.EncoderState":
        """The carry as the ``EncoderState`` of ``StreamingEncoder.step``
        (views of the buffers)."""
        c = self.carry
        return enc.EncoderState(
            prev_addin=c.prev_addin if self.has_prev else None,
            buf_before=c.raw[:, :self.n_before] if self.n_before else None,
            buf_after=c.post[:, :self.n_after] if self.n_after else None,
            n_processed_blocks=self.npb,
            past_ctx=c.past_ctx if self.has_past else None)

    def plan(self, source: ChunkInput, is_final: bool
             ) -> "geometry.ChunkPlan":
        return geometry.plan_chunk(self.cfg, self.n_before,
                                   source.n_frames(self.cfg.hop_length),
                                   self.n_after, self.npb, is_final)

    def step(self, source: ChunkInput, is_final: bool
             ) -> "geometry.ChunkPlan":
        """One chunk: its frames through the programs, the emitted ones
        appended to the ring. Returns the chunk's plan."""
        cfg = self.cfg
        plan = self.plan(source, is_final)
        rcap, pcap = geometry.carry_capacity(cfg)
        if (plan.n_in > rcap or plan.total > pcap
                or self.enc_len + plan.y_length > cfg.max_enc_frames):
            raise_too_long(cfg, self.enc_len + max(plan.y_length,
                                                   plan.total))
        self.ints.put(np.array(
            [self.n_before, self.n_after, self.npb, self.has_prev,
             self.has_past, self.enc_len,
             len(source.data) if source.kind == "wave" else 0], np.int32))
        input_key = source.key(cfg.hop_length)
        if input_key is None:
            self.carry.raw[:, self.n_before:plan.n_in] = source.data
        else:
            self._input(input_key).put(self._padded(input_key, source.data))
        for key in chunk_graph_keys(input_key, plan):
            if self.graphed:
                (self._graphs.get(key) or self.capture([key])[0]).replay()
            else:
                self._program(key)(self.carry, self.ring)
        self.enc_len += plan.y_length
        if is_final:
            self._new_stream()
            return plan
        self.n_before, self.n_after, self.npb = (plan.n_before, plan.n_after,
                                                 plan.npb)
        if plan.kind == "blocks":
            self.has_prev = self.has_past = True
        return plan

    # -- programs -------------------------------------------------------------
    def _input(self, key: tuple) -> Upload:
        """The static input buffer of an input signature."""
        if key not in self._inputs:
            shape = ((key[1] * self.cfg.hop_length,) if key[0] == "frontend"
                     else (key[1], self.cfg.n_mels))
            self._inputs[key] = Upload(shape, torch.float32,
                                       self.encoder.device)
        return self._inputs[key]

    def _padded(self, key: tuple, data: np.ndarray) -> np.ndarray:
        if key[0] != "frontend":
            return data
        out = np.zeros(key[1] * self.cfg.hop_length, np.float32)
        out[:len(data)] = data
        return out

    def _program(self, key: tuple) -> Callable:
        """The program of a signature, over any (carry, ring)."""
        ints = self.ints.dev
        if key[0] in ("frontend", "normalize"):
            fe = self.frontend
            x = self._input(key).dev

            def program(carry, ring):
                if key[0] == "normalize":
                    feats = (x[None] - fe.mean) * fe.inv_std
                else:
                    _, t, lo, hi = key
                    feats = logmel_of_frames(
                        reflect_frames(x[None], ints[6], t, fe.n_fft,
                                       fe.hop_length),
                        fe.window, fe.mel_fb, fe.mean, fe.inv_std,
                        fe.n_fft)[:, lo:t - hi]
                enc.append_rows(carry.raw, feats, ints[0:1])
            return program
        plan = key[1]
        if key[0] == "subsample":
            return lambda carry, ring: self.encoder.subsample_program(
                plan, carry, ints)
        return lambda carry, ring: self.encoder.blocks_program(
            plan, carry, ints, ring)

    def capture(self, keys) -> List[Graph]:
        """The graphs of `keys` (those not captured yet are captured now, in
        one pass: a warm-up of their programs on copies of the carry and
        the ring, then the captures). None where the programs run
        eagerly."""
        if not self.graphed:
            return []
        new = [k for k in dict.fromkeys(keys) if k not in self._graphs]
        if new:
            def warmup():
                carry, ring = clone_tree(self.carry), self.ring.clone()
                for key in new:
                    self._program(key)(carry, ring)

            graphs = capture_graphs(
                [(graph_name(key), functools.partial(
                    self._program(key), self.carry, self.ring))
                 for key in new], warmup, self.pool)
            self._graphs.update(zip(new, graphs))
        return [self._graphs[k] for k in keys]


def raise_too_long(cfg, n_frames: int) -> None:
    frame_sec = cfg.hop_length * cfg.subsample / cfg.sample_rate
    raise RuntimeError(
        f"utterance too long for decode state: {n_frames} encoder frames > "
        f"capacity {cfg.max_enc_frames} "
        f"(~{cfg.max_enc_frames * frame_sec:.0f} s). Split the audio into "
        "shorter segments or raise cfg.max_enc_frames.")
