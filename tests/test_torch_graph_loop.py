"""The device-resident block loop (``decode.graphs``) on the CPU.

On the card a block's beam loop is three CUDA graphs: the prologue, a step
graph of ``STEPS_PER_REPLAY`` (K) unrolled ``block_step``s replayed until a
readback of ``any(stepping)`` comes back false, and the rewind. Here the
same programs (``BlockLoop._prologue``, ``_step``, ``_epilogue``) run
eagerly:

- K-unrolled with a stop check every K steps, K in {1, 2, 8}, against the
  JAX ``decode_block_device`` (its ``lax.while_loop``) on the same numpy
  state: three streams that stop at different steps, both ``eos_commit``
  modes, ``block_final`` off and mixed, BBD on. yseq, xpos, lane, ylen,
  prev_valid, process_idx and output_index exact; scores within rtol 1e-4
  (the beam-search parity tests' tolerance: JAX's CPU path runs the CTC
  recursion as an associative scan, the port sequentially), the forward
  variables within the CTC scorer tests' 1e-5 + 1e-3 absolute. Against the
  port's eager loop the unrolled one is bit-equal.
- Replays after every stream has stopped leave every leaf bit-equal.
- Under a dispatch mode that raises on every host sync (``.item()``,
  ``nonzero``, ``masked_select``, boolean indexing, ``.tolist()``...), the
  prologue, step and rewind of the engine's and the session's loops and the
  engine's encode run through: nothing a graph captures reads the card.
  The kernels' plain twins (the CPU stand-ins for the CUDA kernels, opaque
  launches on the card) run unguarded.
- finalize_batch at every width of a 6-slot engine runs on compact sets of
  power-of-two widths (and the full width), its finals as ``finalize``'s.
- ``decoder_step``'s fixed-shape cache write against JAX with rows that do
  not write and a row past the cache's capacity.
- The cross-attention's K/V are the projection laid out head-major once a
  block, and a beam step copies none of them (``torch.profiler``'s record
  of the step's ``aten::copy_`` shapes).

The state comes from a tiny engine on the CPU (three streams, seeded
weights and audio), recorded where its rounds enter the block loop.
"""

from __future__ import annotations

import contextlib
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_common import bias_outputs, jax_config, jax_model, n, t
from test_torch_common import synth_audio

from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.decode import beam_search as bs
from speechcatcher_tpu_torch.decode import graphs
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.models.decoder import project_cross_kv
from speechcatcher_tpu_torch.ops.layers import linear
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.serve.engine import StreamingEngine

CFG = tiny_config()
SEED = 0
BEAM = 3
CHUNK = 8192
MAX_LENGTH = 24
SCORE_RTOL = 1e-4
# (recorded round, block_final per stream): round 0 is every stream's first
# block (they stop after 5, 6 and 6 steps); in round 4 stream 1's final
# block runs 16 steps while the others stop after one.
CASES = {"nonfinal": (0, (False, False, False)),
         "final_mixed": (4, (False, True, False))}


@functools.lru_cache(maxsize=1)
def _recorded():
    """The model, its JAX twin and the inputs of the engine's block loops
    over six ticks of three streams: (memory, state, vis_len) per round."""
    tree = bias_outputs(random_params(CFG, SEED), CFG, 0.0, 0.0)
    model = ASRModel.from_numpy(CFG, tree, device="cpu")
    rounds = []
    prologue = graphs.BlockLoop._prologue

    def record(loop, state, stepping0, out):
        prologue(loop, state, stepping0, out)
        rounds.append((loop.memory.clone(), graphs.clone_tree(state),
                       loop.ints.dev[2].clone()))

    engine = StreamingEngine(model, n_slots=3, beam_size=BEAM,
                             chunk_samples=CHUNK, device="cpu")
    audio = [synth_audio(3.5, 10 + k) for k in range(3)]
    slots = [engine.acquire_slot() for _ in audio]
    graphs.BlockLoop._prologue = record
    try:
        for i in range(6):
            engine.tick({s: audio[k][i * CHUNK:(i + 1) * CHUNK]
                         for k, s in enumerate(slots)})
    finally:
        graphs.BlockLoop._prologue = prologue
    return model, jax_model(CFG, tree), rounds


def _settings(eos_commit: str) -> bs.LoopSettings:
    return bs.LoopSettings(BEAM, CFG.pre_beam_size, 0.3, True, MAX_LENGTH,
                           0.0, eos_commit)


def _inputs(case: str):
    model, jmodel, rounds = _recorded()
    idx, final = CASES[case]
    memory, state, vis_len = rounds[idx]
    state = state._replace(stepping=torch.ones(3, dtype=torch.bool))
    return model, jmodel, memory, state, vis_len, torch.tensor(final)


def _loop(model, memory, state, vis_len, block_final, eos_commit):
    """A BlockLoop over a copy of `state`, its integers uploaded (rows 2
    and 4: the visible frames and block_final)."""
    loop = graphs.BlockLoop(model, graphs.clone_tree(state), memory,
                            _settings(eos_commit), frames=None,
                            extcap=CFG.block_size)
    zeros = np.zeros(3, np.int32)
    loop.ints.put(np.stack([zeros, zeros, vis_len.numpy(), zeros,
                            block_final.numpy()]))
    return loop


def _unrolled(loop, memory, k: int, monkeypatch):
    """The graphs' schedule on the CPU: K-step replays of the step program
    until its flag reads no stream stepping, then the rewind. Returns the
    replays."""
    monkeypatch.setattr(graphs, "STEPS_PER_REPLAY", k)
    st = loop.state
    cross_kv = project_cross_kv(loop.model.params["decoder"], memory,
                                CFG.decoder_heads, st.dec_cache.h.dtype)
    stepping0 = st.stepping.clone()
    flag = torch.zeros(2, dtype=torch.int32)
    replays = 0
    while True:
        loop._step(st, cross_kv, flag)
        replays += 1
        if not int(flag[0]):
            break
    loop._epilogue(st, stepping0)
    return replays, cross_kv, flag


def _stop_steps(model, memory, state, vis_len, block_final, eos_commit):
    """The step after which each stream stops, by the eager loop."""
    settings = _settings(eos_commit)
    cross_kv = project_cross_kv(model.params["decoder"], memory,
                                CFG.decoder_heads, state.dec_cache.h.dtype)
    st, stops, step = state, [0, 0, 0], 0
    while bool(st.stepping.any()):
        step += 1
        stops = [step if bool(st.stepping[s]) else stops[s]
                 for s in range(3)]
        st = bs.block_step(model.params, model.dec_pe, cross_kv, st,
                           vis_len, block_final, CFG, settings)
    return stops


@functools.lru_cache(maxsize=None)
def _jax_block(case: str, eos_commit: str):
    """JAX decode_block_device on the case's numpy state."""
    from speechcatcher_tpu.decode import beam_search as jbs
    from speechcatcher_tpu.decode.ctc_prefix import CTCScorerState
    from speechcatcher_tpu.models.decoder import DecoderCache

    _, jmodel, memory, state, vis_len, final = _inputs(case)

    def arrays(a):
        return jbs.BeamArrays(
            *[jnp.asarray(n(x)) for x in a[:7]],
            ctc=CTCScorerState(*[jnp.asarray(n(x)) for x in a.ctc]))

    jstate = jbs.BlockDecodeState(
        arrays=arrays(state.arrays), prev_arrays=arrays(state.prev_arrays),
        dec_cache=DecoderCache(h=jnp.asarray(n(state.dec_cache.h))),
        prev_valid=jnp.asarray(n(state.prev_valid)),
        process_idx=jnp.asarray(n(state.process_idx)),
        output_index=jnp.asarray(n(state.output_index)),
        stepping=jnp.asarray(n(state.stepping)))
    out = jbs.decode_block_device(
        jmodel.params, jmodel.dec_pe, jnp.asarray(n(memory)), jstate,
        jnp.asarray(n(vis_len)), jnp.asarray(n(final)), jax_config(CFG),
        BEAM, CFG.pre_beam_size, 0.3, True, MAX_LENGTH,
        eos_commit=eos_commit)
    return out


def _assert_matches_jax(got: bs.BlockDecodeState, want) -> None:
    for role in ("arrays", "prev_arrays"):
        g, w = getattr(got, role), getattr(want, role)
        for name in ("yseq", "xpos", "lane", "ylen"):
            np.testing.assert_array_equal(n(getattr(g, name)),
                                          n(getattr(w, name)),
                                          err_msg=f"{role}.{name}")
        for name in ("score", "score_dec", "score_ctc"):
            np.testing.assert_allclose(n(getattr(g, name)),
                                       n(getattr(w, name)),
                                       rtol=SCORE_RTOL,
                                       err_msg=f"{role}.{name}")
        np.testing.assert_allclose(n(g.ctc.s), n(w.ctc.s), rtol=SCORE_RTOL,
                                   err_msg=f"{role}.ctc.s")
        np.testing.assert_array_equal(n(g.ctc.enc_len), n(w.ctc.enc_len))
        np.testing.assert_allclose(n(g.ctc.r), n(w.ctc.r), rtol=1e-5,
                                   atol=1e-3, err_msg=f"{role}.ctc.r")
    for name in ("prev_valid", "process_idx", "output_index", "stepping"):
        np.testing.assert_array_equal(n(getattr(got, name)),
                                      n(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(n(got.dec_cache.h), n(want.dec_cache.h),
                               rtol=1e-5, atol=1e-5)


def _assert_bit_equal(got, want) -> None:
    for i, (g, w) in enumerate(zip(graphs.tree_leaves(got),
                                   graphs.tree_leaves(want))):
        assert torch.equal(g, w), f"leaf {i} differs"


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("eos_commit", ["native", "espnet"])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_unrolled_loop_matches_jax_block(k, eos_commit, case, monkeypatch):
    model, _, memory, state, vis_len, final = _inputs(case)
    stops = _stop_steps(model, memory, state, vis_len, final, eos_commit)
    assert len(set(stops)) > 1, stops   # the streams stop apart

    loop = _loop(model, memory, state, vis_len, final, eos_commit)
    replays, _, _ = _unrolled(loop, memory, k, monkeypatch)
    assert replays == -(-max(stops) // k)
    _assert_matches_jax(loop.state, _jax_block(case, eos_commit))

    eager = bs.decode_block_device(
        model.params, model.dec_pe, memory, graphs.clone_tree(state),
        vis_len, final, CFG, BEAM, CFG.pre_beam_size, 0.3, True,
        MAX_LENGTH, eos_commit=eos_commit)
    _assert_bit_equal(loop.state, eager)


def test_steps_after_the_stop_change_nothing(monkeypatch):
    """Four more replays of the step program once no stream steps: every
    leaf bit-equal, and the flag counts no live step."""
    model, _, memory, state, vis_len, final = _inputs("final_mixed")
    loop = _loop(model, memory, state, vis_len, final, "native")
    _, cross_kv, flag = _unrolled(loop, memory, 2, monkeypatch)
    before = graphs.clone_tree(loop.state)
    assert not bool(before.stepping.any())
    for _ in range(4):
        loop._step(loop.state, cross_kv, flag)
        assert flag.tolist() == [0, 0]
    _assert_bit_equal(loop.state, before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_kv_are_the_projection_laid_out_head_major(dtype):
    """``project_cross_kv`` gives each layer's K and V as ``linear``'s
    (S, T, d) rows of the finite frames, cast to the cache dtype and laid
    out as contiguous (S, h, T, dk), bit for bit."""
    model, _, memory, _, _, _ = _inputs("nonfinal")
    dec = model.params["decoder"]
    h = CFG.decoder_heads
    s, tm, d = memory.shape
    mem = torch.where(torch.isfinite(memory), memory, 0.0).to(dtype)
    cross_kv = project_cross_kv(dec, memory, h, dtype)
    assert len(cross_kv) == CFG.decoder_layers
    for p_layer, kv in zip(dec["layers"], cross_kv):
        for name, got in zip(("linear_k", "linear_v"), kv):
            rows = linear(p_layer["src_attn"][name], mem).to(dtype)
            want = rows.reshape(s, tm, h, d // h).transpose(1, 2)
            assert got.dtype == dtype and got.is_contiguous()
            assert torch.equal(got, want)


def test_a_beam_step_copies_no_cross_kv():
    """One run of the step program copies no cross K or V: every
    ``aten::copy_`` it makes moves fewer elements than one layer's K,
    S·T·d (the query and output rows of the cross-attention are re-laid
    out, K and V are read where they lie)."""
    model, _, memory, state, vis_len, final = _inputs("nonfinal")
    loop = _loop(model, memory, state, vis_len, final, "native")
    cross_kv = project_cross_kv(model.params["decoder"], memory,
                                CFG.decoder_heads, state.dec_cache.h.dtype)
    flag = torch.zeros(2, dtype=torch.int32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        loop._step(loop.state, cross_kv, flag)
    assert flag.tolist() == [1, 1]
    copied = [math.prod(e.input_shapes[0]) for e in prof.events()
              if e.name == "aten::copy_" and e.input_shapes
              and e.input_shapes[0]]
    assert len(copied) > 10
    assert max(copied) < memory.numel()


# ---------------------------------------------------------------------------
# No host sync inside what the graphs capture
# ---------------------------------------------------------------------------

class HostSync(AssertionError):
    pass


class _NoHostSync(TorchDispatchMode):
    """Raises on every operator that reads a device value on the host or
    sizes its result by the data."""

    SYNCS = {"_local_scalar_dense", "nonzero", "masked_select", "equal",
             "unique", "_unique2", "unique_dim", "unique_consecutive"}
    INDEXED = {"index", "index_put", "index_put_", "_index_put_impl_"}

    def __init__(self):
        super().__init__()
        self.suspended = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if not self.suspended:
            if name in self.SYNCS or (
                    name == "repeat_interleave"
                    and func._overloadname.startswith("Tensor")
                    and kwargs.get("output_size") is None):
                raise HostSync(f"{func} syncs with the host")
            if name in self.INDEXED and any(
                    i is not None and i.dtype == torch.bool
                    for i in args[1]):
                raise HostSync(f"{func} with a boolean index syncs")
        return func(*args, **kwargs)


_TWINS = (
    ("speechcatcher_tpu_torch.ops.kernels.ring_append",
     "ring_append_cols_plain"),
    ("speechcatcher_tpu_torch.ops.kernels.ring_append",
     "ring_append_rows_plain"),
    ("speechcatcher_tpu_torch.ops.kernels.ctc_recursion",
     "ctc_forward_recursion_streams_plain"),
    ("speechcatcher_tpu_torch.ops.kernels.block_attention",
     "block_attention_plain"),
    ("speechcatcher_tpu_torch.ops.kernels.rel_attention",
     "rel_block_attention_plain"),
)


@contextlib.contextmanager
def no_host_sync(monkeypatch):
    """Raise on any host sync inside, except within the kernels' plain
    twins (on the card each is one launch the host does not wait for)."""
    import importlib

    guard = _NoHostSync()

    def opaque(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            guard.suspended += 1
            try:
                return fn(*args, **kwargs)
            finally:
                guard.suspended -= 1
        return run

    def refuse(method):
        @functools.wraps(method)
        def run(self, *args, **kwargs):
            if not guard.suspended:
                raise HostSync(f"Tensor.{method.__name__} reads the card")
            return method(self, *args, **kwargs)
        return run

    for module, name in _TWINS:
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, name, opaque(getattr(mod, name)))
    for name in ("tolist", "numpy", "cpu", "item"):
        monkeypatch.setattr(torch.Tensor, name,
                            refuse(getattr(torch.Tensor, name)))
    try:
        with guard:
            yield
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("what", ["item", "bool", "mask_index", "nonzero",
                                  "tolist", "mask_write"])
def test_the_guard_catches_host_syncs(what, monkeypatch):
    x = torch.arange(6.0)
    with pytest.raises(HostSync), no_host_sync(monkeypatch):
        if what == "item":
            x.sum().item()
        elif what == "bool":
            bool(x.any())
        elif what == "mask_index":
            x[x > 2]
        elif what == "nonzero":
            torch.nonzero(x)
        elif what == "tolist":
            x.tolist()
        else:
            x[x > 2] = 0.0


def _engine_after_ticks(encoder_type: str = "transformer"):
    cfg = tiny_config(encoder_type=encoder_type)
    model = ASRModel.random_init(cfg, seed=3, device="cpu")
    engine = StreamingEngine(model, n_slots=3, beam_size=BEAM,
                             chunk_samples=CHUNK, device="cpu")
    audio = [synth_audio(1.6, 20 + k) for k in range(3)]
    slots = [engine.acquire_slot() for _ in audio]
    for i in range(2):
        engine.tick({s: audio[k][i * CHUNK:(i + 1) * CHUNK]
                     for k, s in enumerate(slots)})
    return engine


def _programs_never_sync(loop, monkeypatch):
    flag = torch.zeros(2, dtype=torch.int32)
    stepping0 = torch.zeros_like(loop.state.stepping)
    state = graphs.clone_tree(loop.state)
    out = {}
    with no_host_sync(monkeypatch):
        loop._prologue(state, stepping0, out)
        loop._step(state, out["cross_kv"], flag)
        loop._epilogue(state, stepping0)


@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
def test_engine_block_loop_never_syncs(encoder_type, monkeypatch):
    engine = _engine_after_ticks(encoder_type)
    c = engine.c
    engine._loop.ints.put(np.stack([
        c.vis_len, np.full(3, 4), c.vis_len + 4, np.ones(3),
        np.array([0, 1, 0])]).astype(np.int32))
    _programs_never_sync(engine._loop, monkeypatch)


def test_session_block_loop_never_syncs(monkeypatch):
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

    model = ASRModel.random_init(CFG, seed=3, device="cpu")
    s2t = Speech2TextStreaming(model=model, beam_size=BEAM, device="cpu")
    s2t(synth_audio(1.0, 5))
    loop = s2t.beam_search.loop
    vis = s2t.beam_search.state.vis_len
    loop.ints.put(np.array([[vis], [0], [vis], [1], [1]], np.int32))
    _programs_never_sync(loop, monkeypatch)


@pytest.mark.parametrize("wire", ["float32", "int16", "uint8"])
@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
def test_engine_encode_never_syncs(encoder_type, wire, monkeypatch):
    """Every block count the tick can give (0 to MAXB) and wire format."""
    engine = _engine_after_ticks(encoder_type)
    audio = np.zeros((3, CHUNK), wire)
    for maxb in range(engine.MAXB + 1):
        bk = engine._encode_bookkeeping(np.ones(3, bool))
        ints = torch.from_numpy(np.stack(bk["ints"]).astype(np.int32))
        buffers = graphs.clone_tree(engine.buffers)
        with no_host_sync(monkeypatch):
            engine._encode_into(buffers, torch.from_numpy(audio), ints, maxb)


# ---------------------------------------------------------------------------
# finalize_batch's compact sets
# ---------------------------------------------------------------------------

def test_finals_of_every_width_use_power_of_two_sets():
    """finalize_batch of 1 to 6 slots of a 6-slot engine runs on compact
    sets of widths 1, 2, 4 and 6 (padding rows never decoded), and each
    final equals that of ``finalize`` on a twin engine: tokens and
    positions exact, the score within SCORE_RTOL."""
    model = ASRModel.random_init(CFG, seed=3, device="cpu")
    engines = [StreamingEngine(model, n_slots=6, beam_size=BEAM,
                               chunk_samples=CHUNK, device="cpu")
               for _ in range(2)]
    for width in range(1, 7):
        audio = [synth_audio(2.0, 40 + 10 * width + k) for k in range(width)]
        finals = []
        for engine in engines:
            slots = [engine.acquire_slot() for _ in audio]
            for i in range(3):
                engine.tick({s: audio[k][i * CHUNK:(i + 1) * CHUNK]
                             for k, s in enumerate(slots)})
            tails = {s: audio[k][3 * CHUNK:] for k, s in enumerate(slots)}
            if engine is engines[0]:
                out = engine.finalize_batch(tails)
            else:
                out = {s: engine.finalize(s, a) for s, a in tails.items()}
            finals.append([out[s] for s in slots])
        for (gy, gx, gs), (wy, wx, ws) in zip(*finals):
            np.testing.assert_array_equal(gy, wy)
            np.testing.assert_array_equal(gx, wx)
            assert abs(gs - ws) <= SCORE_RTOL * abs(ws)
    assert sorted(engines[0]._compact) == [1, 2, 4, 6]
    assert engines[0]._compact_widths() == [1, 2, 4, 6]
    assert not engines[1]._compact


# ---------------------------------------------------------------------------
# decoder_step's fixed-shape cache write
# ---------------------------------------------------------------------------

def test_decoder_step_drops_rows_that_do_not_write_or_overflow():
    """Two streams of three hypotheses: rows 1 and 3 do not write, row 4
    sits past the cache's capacity (JAX's mode="drop" drops it); logits and
    the cache as JAX's."""
    from speechcatcher_tpu.models.decoder import decoder_step as j_step
    from speechcatcher_tpu.models.decoder import DecoderCache as JCache
    from speechcatcher_tpu_torch.models.decoder import (
        DecoderCache,
        decoder_step,
    )

    cfg = tiny_config(max_tokens=12)
    tree = random_params(cfg, 8)
    model = ASRModel.from_numpy(cfg, tree, device="cpu")
    jmodel = jax_model(cfg, tree)
    rng = np.random.default_rng(8)
    s_dim, lmax, d = 2, cfg.max_tokens, cfg.decoder_dim
    h = rng.standard_normal((cfg.decoder_layers, s_dim * BEAM, lmax, d)
                            ).astype(np.float32)
    memory = rng.standard_normal((s_dim, 40, cfg.encoder_dim)
                                 ).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, s_dim * BEAM).astype(np.int32)
    pos = np.array([3, 5, 11, 7, lmax + 2, 0], np.int32)
    write = np.array([True, False, True, False, True, True])
    lane = rng.integers(0, BEAM, (s_dim, BEAM, lmax)).astype(np.int32)
    enc_len = np.array([17, 40], np.int32)

    jl, jc = j_step(jmodel.params["decoder"], jmodel.dec_pe,
                    JCache(h=jnp.asarray(h)), jnp.asarray(memory),
                    jnp.asarray(tokens), jnp.asarray(pos),
                    jnp.asarray(enc_len), jnp.asarray(lane),
                    jnp.asarray(write), jax_config(cfg), BEAM)
    cache = DecoderCache(h=t(h).clone())
    pl, pc = decoder_step(model.params["decoder"], model.dec_pe, cache,
                          t(memory), t(tokens), t(pos), t(enc_len), t(lane),
                          t(write), cfg, BEAM)
    np.testing.assert_allclose(n(pl), n(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(pc.h), n(jc.h), rtol=1e-5, atol=1e-5)
    # Rows that must not write, and the overflowing row, left the cache
    # bit-equal; the others wrote their position.
    for row in (1, 3, 4):
        assert np.array_equal(n(pc.h[:, row]), h[:, row])
    for row in (0, 2, 5):
        assert not np.array_equal(n(pc.h[:, row, pos[row]]),
                                  h[:, row, pos[row]])
