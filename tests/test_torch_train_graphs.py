"""The train step and ``evaluate`` as graphs (``training.py``,
``decode.graphs.SignatureGraphs``) on the CPU.

On the card, ``train_step`` without a mesh is one CUDA graph per batch
signature over the optimizer state, and ``evaluate`` replays two graphs per
eval bucket; the CPU runs the same programs eagerly. Here:

- the port's CTC loss, a copy of optax's ``ctc_loss_with_forward_probs``,
  against the JAX package's ``ctc_loss`` (optax): loss within 1e-5
  relative, gradients of hs and ``ctc_lo`` within ``GRAD_RTOL`` and
  ``GRAD_ATOL`` (``test_torch_train_modules.py``), for a feasible batch,
  repeated labels, padded frames and labels, and an infeasible row;
- three train steps of each encoder under WarmupLR with a clip that acts,
  alternating two batch signatures, through ``SignatureGraphs`` with its
  captures replayed eagerly (``eager_graphs``: static buffers, the warm-up
  on a copy of the state, the replays): against JAX ``train_step`` within
  ``test_torch_training.py``'s tolerances and against the plain CPU step to
  the last bit; ``evaluate`` through the same route equal to the plain one;
- the train step's and both eval programs under the dispatch guard of
  ``test_torch_graph_loop.py`` that raises on every host sync, both
  encoders, float32;
- a CPU ``train_step`` and ``evaluate`` capture nothing; the eval graphs
  of two trees are apart and die with their tree;
- a launch record of a stream takes the launches other threads make on it
  (the autograd engine's backward thread on the card);
- the device form of the WarmupLR schedule against the host form.
"""

from __future__ import annotations

import gc
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_common import jax_config, n, t
from test_torch_graph_loop import no_host_sync
from test_torch_train_modules import GRAD_ATOL, GRAD_RTOL, _batch, _models
from test_torch_training import PARAM_ATOL, _assert_tree_close

import speechcatcher_tpu.training as JT
import speechcatcher_tpu_torch.training as PT
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.decode import graphs
from speechcatcher_tpu_torch.decode.greedy import _encode_and_collapse
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.ops.kernels import _plan
from speechcatcher_tpu_torch.params import (
    params_to_numpy,
    random_params,
    tree_leaves,
    tree_map,
)


# ---------------------------------------------------------------------------
# The CTC loss against optax
# ---------------------------------------------------------------------------

def _ctc_inputs(case: str):
    """(cfg, hs, hlens, ys, ylens) of a case, from its own seed: 4 rows of
    at most 12 frames, as ``test_torch_train_modules.py``'s case, so that
    the float32 rounding of ``ctc_lo``'s weight gradient (a sum over rows
    and frames) stays below GRAD_ATOL."""
    rng = np.random.default_rng(
        ["feasible", "repeats", "padded", "infeasible"].index(case) + 40)
    cfg = tiny_config()
    b, frames, u = 4, 12, 5
    hs = rng.standard_normal((b, frames, cfg.encoder_dim), dtype=np.float32)
    hlens = np.full(b, frames, np.int32)
    ys = rng.integers(1, cfg.vocab_size, (b, u)).astype(np.int32)
    ylens = np.full(b, u, np.int32)
    if case == "repeats":
        ys[0, :4] = 9                  # a run: blanks between each pair
        ys[1, 1:3] = ys[1, 0]
        ys[2, 2] = ys[2, 3]
    if case in ("padded", "infeasible"):
        hlens = np.array([12, 11, 6, 9], np.int32)
        ylens = np.array([5, 2, 3, 0], np.int32)
        ys[1, 1] = ys[1, 0]            # a repeat inside the labels
    if case == "infeasible":
        hlens[0] = 4                   # 5 labels in 4 frames
        hlens[2] = 3                   # 3 labels, one repeated, in 3 frames
        ys[2, 1] = ys[2, 0]
    ys[np.arange(u)[None, :] >= ylens[:, None]] = 0
    return cfg, hs, hlens, ys, ylens


@pytest.mark.parametrize("case", ["feasible", "repeats", "padded",
                                  "infeasible"])
def test_ctc_loss_matches_optax(case):
    from speechcatcher_tpu.models.ctc import ctc_loss as JL
    from speechcatcher_tpu_torch.models.ctc import ctc_loss as PL

    cfg, hs, hlens, ys, ylens = _ctc_inputs(case)
    tree, model = _models(cfg, seed=11)
    ctc_p = tree_map(lambda a: a.requires_grad_(), model.params["ctc"])
    hs_t = t(hs).requires_grad_()
    loss_p = PL(ctc_p, hs_t, t(hlens), t(ys), t(ylens))
    loss_j, grads_j = jax.value_and_grad(
        lambda p, h: JL(p, h, *map(jnp.asarray, (hlens, ys, ylens))),
        argnums=(0, 1))(jax.tree.map(jnp.asarray, tree["ctc"]),
                        jnp.asarray(hs))
    assert np.isfinite(float(loss_j))
    assert (float(loss_j) > 1e4) == (case == "infeasible")
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5)
    loss_p.backward()
    np.testing.assert_allclose(n(hs_t.grad), n(grads_j[1]), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(n(ctc_p["ctc_lo"][name].grad),
                                   n(grads_j[0]["ctc_lo"][name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# The programs through SignatureGraphs, replayed eagerly
# ---------------------------------------------------------------------------

class _EagerGraph:
    """A captured program that runs at each replay."""

    def __init__(self, fn, name):
        self.fn, self.name = fn, name
        self.pool_bytes = self.replays = 0

    def replay(self):
        self.fn()
        self.replays += 1


@pytest.fixture
def eager_graphs(monkeypatch):
    """The card's route on the CPU: ``training.graphed`` true, and
    ``capture_graphs`` running the warm-up at once and each program at its
    graph's replays only, as a captured graph does. Returns the list of
    graphs captured."""
    captured = []

    def capture(programs, warmup, pool):
        warmup()
        out = [_EagerGraph(fn, name) for name, fn in programs]
        captured.extend(out)
        return out

    monkeypatch.setattr(graphs, "capture_graphs", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(PT, "graphed", lambda device: True)
    return captured


def _two_batches(cfg):
    """Two TrainBatch signatures (numpy): 3 rows of 170 frames and 6
    tokens, and 3 rows of 120 frames and 4 tokens."""
    first = _batch(cfg, np.random.default_rng(13))
    second = _batch(cfg, np.random.default_rng(14), frames=120, u=4)
    return first, second


@pytest.mark.parametrize("enc", ["transformer", "conformer"])
def test_graph_program_train_steps_match_jax(enc, eager_graphs):
    """Steps on batches A, B, A under WarmupLR (2 warmup steps) with a clip
    that acts: the graph route against JAX ``train_step`` (losses within
    1e-5, parameters within PARAM_ATOL) and against the plain CPU step
    (losses, parameters, moments and count to the last bit). Two
    signatures, two captures, one replay each but A's two."""
    cfg = tiny_config(n_mels=20, encoder_type=enc)
    tree = random_params(cfg, 0)
    batches = _two_batches(cfg)
    order = [0, 1, 0]
    clip = 1.0
    jcfg = jax_config(cfg)
    jopt = JT.make_optimizer(lr=1e-3, warmup_steps=2, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, tree)
    grads = jax.grad(lambda p: JT.joint_loss(p, JT.TrainBatch(*map(
        jnp.asarray, batches[0])), jcfg)[0])(jp)
    assert float(optax.global_norm(grads)) > 10 * clip  # the clip acts
    js = jopt.init(jp)
    j_loss = []
    for i in order:
        jp, js, m = JT.train_step(jp, js, JT.TrainBatch(*map(
            jnp.asarray, batches[i])), jcfg, jopt)
        j_loss.append(float(m["loss"]))
        assert float(m["loss"]) > 0

    runs = []
    for route in ("graphs", "plain"):
        model = ASRModel.from_numpy(cfg, tree, "cpu")
        opt = PT.make_optimizer(lr=1e-3, warmup_steps=2, grad_clip=clip)
        state = opt.init(model.params)
        losses = []
        with pytest.MonkeyPatch.context() as mp:
            if route == "plain":
                mp.setattr(PT, "graphed", lambda device: False)
            for i in order:
                params, state, m = PT.train_step(
                    model.params, state, PT.TrainBatch(*map(t, batches[i])),
                    cfg, opt)
                assert params is model.params
                losses.append([m[k].item() for k in PT.METRICS])
        runs.append((losses, model, state))
    (g_loss, g_model, g_state), (p_loss, p_model, p_state) = runs
    assert [g.replays for g in eager_graphs] == [2, 1]
    assert g_state.graphs is not None and p_state.graphs is None
    assert g_state.count.item() == 3 and g_state.count.dtype == torch.int32
    np.testing.assert_allclose([x[0] for x in g_loss], j_loss, rtol=1e-5)
    _assert_tree_close(params_to_numpy(g_model.params), jp, PARAM_ATOL)
    assert g_loss == p_loss
    for a, b in zip(g_state.leaves + g_state.mu + g_state.nu,
                    p_state.leaves + p_state.mu + p_state.nu):
        assert torch.equal(a, b)


def _eval_setup():
    from speechcatcher_tpu_torch.data import BucketBatcher, synthetic_dataset

    cfg = tiny_config(n_mels=20)
    tree = random_params(cfg, 4)
    tree["ctc"]["ctc_lo"]["bias"][2:] += 3.0  # emit tokens
    model = ASRModel.from_numpy(cfg, tree, "cpu")
    utts = synthetic_dataset(7, cfg, model.tokenizer, seed=3)
    batches = list(BucketBatcher(model.frontend, model.tokenizer,
                                 batch_size=4).batches(utts, with_refs=True))
    return cfg, model, batches


def test_evaluate_through_the_graph_route_equals_plain(eager_graphs):
    """Two eval batches (the second flush-padded): losses, WER and CER of
    the graph route equal the plain ones exactly; each batch replays its
    bucket's two programs once."""
    cfg, model, batches = _eval_setup()
    got = PT.evaluate(model.params, cfg, batches, model.tokenizer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PT, "graphed", lambda device: False)
        want = PT.evaluate(model.params, cfg, batches, model.tokenizer)
    assert got == want and set(got) == {*PT.METRICS, "wer", "cer"}
    buckets = len({b.feats.shape for b, _ in batches})
    assert sorted(g.name for g in eager_graphs) == sorted(
        ["eval_metrics", "encode_and_collapse"] * buckets)
    assert sum(g.replays for g in eager_graphs) == 2 * len(batches)


def test_eval_graphs_are_per_tree_and_die_with_it(eager_graphs):
    """Two trees get their own graphs; a tree whose leaf was replaced gets
    new ones; a tree's graphs go when the tree does."""
    cfg, model, batches = _eval_setup()
    other = ASRModel.from_numpy(cfg, random_params(cfg, 5), "cpu")
    PT.evaluate(model.params, cfg, batches[:1])
    first = PT._eval_graphs(model.params)
    PT.evaluate(other.params, cfg, batches[:1])
    assert PT._eval_graphs(other.params) is not first
    assert PT._eval_graphs(model.params) is first
    assert len(eager_graphs) == 2
    model.params["ctc"]["ctc_lo"]["bias"] = \
        model.params["ctc"]["ctc_lo"]["bias"].clone()
    assert PT._eval_graphs(model.params) is not first
    # A captured graph holds no reference to the tree (these eager stand-ins
    # hold the programs), so a tree that only has graphs goes with them.
    third = ASRModel.from_numpy(cfg, random_params(cfg, 6), "cpu").params
    PT._eval_graphs(third)
    key = next(tree_leaves(third))[1]
    refs = PT._EVAL_GRAPHS[key][0]
    n_trees = len(PT._EVAL_GRAPHS)
    del key, third
    gc.collect()
    assert len(PT._EVAL_GRAPHS) == n_trees - 1
    assert all(ref() is None for ref in refs)


def test_cpu_train_step_and_evaluate_capture_nothing(monkeypatch):
    """On the CPU the programs run eagerly: no capture, no graphs kept."""
    def refuse(*args, **kwargs):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(graphs, "capture_graphs", refuse)
    monkeypatch.setattr(graphs, "SignatureGraphs", refuse)
    cfg, model, batches = _eval_setup()
    opt = PT.make_optimizer(warmup_steps=3, grad_clip=1.0)
    state = opt.init(model.params)
    _, state, m = PT.train_step(model.params, state, batches[0][0], cfg, opt)
    assert np.isfinite(m["loss"].item()) and state.graphs is None
    assert state.count.item() == 1
    out = PT.evaluate(model.params, cfg, batches, model.tokenizer)
    assert np.isfinite(out["loss"])
    assert next(tree_leaves(model.params))[1] not in PT._EVAL_GRAPHS


# ---------------------------------------------------------------------------
# Nothing captured syncs the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enc", ["transformer", "conformer"])
def test_train_and_eval_programs_never_sync(enc, monkeypatch):
    """The train step's program (forward, backward, the AdamW update under
    WarmupLR and a clip) and both eval programs, under the guard."""
    cfg = tiny_config(n_mels=20, encoder_type=enc)
    model = ASRModel.random_init(cfg, seed=2, device="cpu")
    batch = PT.TrainBatch(*map(t, _batch(cfg, np.random.default_rng(5))))
    opt = PT.make_optimizer(warmup_steps=2, grad_clip=0.5)
    state = opt.init(model.params)
    with no_host_sync(monkeypatch):
        for _ in range(2):
            stacked = PT._step(model.params, state, batch, cfg, opt)
        with torch.no_grad():
            m = PT.joint_loss(model.params, batch, cfg)[1]
            tokens, counts = _encode_and_collapse(
                model.params, batch.feats, batch.feat_lens, cfg)
    assert state.count.item() == 2 and stacked.shape == (3,)
    assert torch.isfinite(stacked).all() and np.isfinite(m["loss"].item())
    assert tokens.shape[0] == counts.shape[0] == 3


# ---------------------------------------------------------------------------
# Launch records and the schedule
# ---------------------------------------------------------------------------

def test_stream_record_takes_other_threads_launches(monkeypatch):
    """Inside ``recording(stream)``, a launch another thread makes on that
    stream goes to the record; one on another stream, or after the record
    closed, to the counter."""
    class Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

    on = threading.local()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: Stream(getattr(on, "stream", 0)))

    def kernel():
        pass

    kernel.launches = 0

    def launch_on(handle):
        def run():
            on.stream = handle
            _plan.count(kernel)
        worker = threading.Thread(target=run)
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()

    with _plan.recording(Stream(7)) as rec:
        launch_on(7)
        launch_on(7)
        launch_on(8)
        _plan.count(kernel)             # this thread: the record too
    launch_on(7)
    assert rec == {(kernel, "launches"): 3}
    assert kernel.launches == 2
    assert not _plan._STREAM_RECORDS


@pytest.mark.parametrize("warmup", [2, 25])
def test_device_schedule_matches_host(warmup):
    """WarmupLR of a device step (what a graphed update reads) against the
    host float and JAX's within two float32 ulps (rtol 2.4e-7): torch takes
    step^-0.5 as a reciprocal square root, numpy and XLA as a power."""
    sched = PT.warmup_lr_schedule(2e-3, warmup)
    js = JT.warmup_lr_schedule(2e-3, warmup)
    for step in (0, 1, 2, warmup - 1, warmup, warmup + 1, 1000):
        dev = sched(torch.tensor(step, dtype=torch.int32))
        assert dev.dtype == torch.float32
        np.testing.assert_allclose(dev.item(), sched(step), rtol=2.4e-7)
        np.testing.assert_allclose(dev.item(), float(js(jnp.int32(step))),
                                   rtol=2.4e-7)
