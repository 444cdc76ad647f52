"""Tensor- and data-parallel training: the port's ranks (gloo processes on
the CPU, ``parallel.launch.run_ranks``) against the JAX package's GSPMD
programs on conftest's virtual CPU devices, on the same numpy weights and
batch.

Tolerances: the tp=2 forward to atol 2e-4 and rtol 2e-4, as the JAX
package's own tp test holds its sharded forward to the unsharded one (the
row-parallel sums round in another order); the train step's loss to rtol
1e-4 and atol 1e-5 and every parameter leaf after it to atol 1e-4
(``test_torch_training.PARAM_ATOL``, one update of lr 1e-3).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import torch_parallel_ranks as ranks
from test_torch_common import jax_config

from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.parallel.launch import run_ranks
from speechcatcher_tpu_torch.params import random_params, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120
PARAM_ATOL = 1e-4
LR, CLIP = 1e-3, 5.0


def _batch(cfg, b, seed=0):
    """b utterances of 170 frames; 2 to 6 target tokens, 0-padded, so that
    dp ranks hold different token counts."""
    rng = np.random.RandomState(seed)
    lens = np.array([6, 5, 4, 6, 3, 6, 2, 6][:b], np.int32)
    tokens = rng.randint(2, cfg.vocab_size - 1, size=(b, 6)).astype(np.int32)
    tokens[np.arange(6)[None, :] >= lens[:, None]] = 0
    return (rng.randn(b, 170, cfg.n_mels).astype(np.float32),
            np.full((b,), 170, np.int32), tokens, lens)


def test_tp_forward_matches_unsharded(tmp_path):
    from speechcatcher_tpu.models.ctc import ctc_log_softmax
    from speechcatcher_tpu.models.encoder import encoder_forward_train

    cfg = tiny_config(n_mels=20)
    tree = random_params(cfg, seed=12)
    feats, lens = _batch(cfg, 4)[:2]
    jcfg = jax_config(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    enc, ref_lens = encoder_forward_train(params["encoder"], feats, lens,
                                          jcfg)
    ref = np.asarray(ctc_log_softmax(params["ctc"], enc))
    out = run_ranks(ranks.tp_forward, 2, str(tmp_path / "rdv"),
                    timeout=RANK_TIMEOUT,
                    args=(cfg, tree, feats, lens, 2))
    for logp, got_lens in out:
        np.testing.assert_array_equal(got_lens, np.asarray(ref_lens))
        np.testing.assert_allclose(logp, ref, atol=2e-4, rtol=2e-4)


def _jax_step(cfg, tree, batch, mesh_shape):
    """JAX's train_step, GSPMD over a (dp, tp) mesh of the virtual CPU
    devices (None: one device)."""
    from speechcatcher_tpu.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_params,
    )
    from speechcatcher_tpu.training import TrainBatch, make_optimizer
    from speechcatcher_tpu.training import train_step as jax_train_step

    jcfg = jax_config(cfg)
    opt = make_optimizer(lr=LR, grad_clip=CLIP)
    params = jax.tree.map(jnp.asarray, tree)
    jb = TrainBatch(*(jnp.asarray(x) for x in batch))
    if mesh_shape is None:
        params, _, m = jax_train_step(params, opt.init(params), jb, jcfg,
                                      opt)
    else:
        n, tp = mesh_shape
        mesh = make_mesh(n, tp=tp)
        with jax.set_mesh(mesh):
            params = shard_params(params, mesh)
            params, _, m = jax_train_step(
                params, opt.init(params), TrainBatch(*shard_batch(
                    tuple(jb), mesh)), jcfg, opt)
    return float(m["loss"]), jax.tree.map(np.asarray, params)


def _assert_params_close(got, want):
    got = dict(tree_leaves(got))
    want = dict(tree_leaves(want))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=PARAM_ATOL,
                                   rtol=0, err_msg=path)


def test_dp2_tp2_train_step_matches_jax_dp4_tp2(tmp_path):
    """The global batch of 8 over the port's 4 ranks (dp 2 × tp 2) against
    JAX's dp 4 × tp 2 step: one loss and one parameter tree, the same on
    every rank."""
    cfg = tiny_config(n_mels=20)
    tree = random_params(cfg, seed=0)
    batch = _batch(cfg, 8)
    want_loss, want = _jax_step(cfg, tree, batch, (8, 2))
    out = run_ranks(ranks.train_steps, 4, str(tmp_path / "rdv"),
                    timeout=RANK_TIMEOUT,
                    args=(cfg, tree, batch, 2, 1, LR, CLIP))
    for losses, params in out:
        np.testing.assert_allclose(losses[0]["loss"], want_loss, rtol=1e-4,
                                   atol=1e-5)
        _assert_params_close(params, want)


def test_conformer_tp2_train_step_matches_jax(tmp_path):
    """The conformer at tp=2: loss and the position biases, which each rank
    holds whole, equal on both ranks and equal to JAX's; every leaf within
    PARAM_ATOL."""
    cfg = tiny_config(n_mels=20, encoder_type="conformer")
    tree = random_params(cfg, seed=3)
    batch = _batch(cfg, 4)
    want_loss, want = _jax_step(cfg, tree, batch, None)
    out = run_ranks(ranks.train_steps, 2, str(tmp_path / "rdv"),
                    timeout=RANK_TIMEOUT,
                    args=(cfg, tree, batch, 2, 1, LR, CLIP))
    (l0, p0), (l1, p1) = out
    assert l0 == l1
    for key in ("pos_bias_u", "pos_bias_v"):
        a = p0["encoder"]["layers"]["self_attn"][key]
        np.testing.assert_array_equal(
            a, p1["encoder"]["layers"]["self_attn"][key])
        np.testing.assert_allclose(
            a, want["encoder"]["layers"]["self_attn"][key], atol=PARAM_ATOL,
            rtol=0)
    np.testing.assert_allclose(l0[0]["loss"], want_loss, rtol=1e-4,
                               atol=1e-5)
    _assert_params_close(p0, want)


def test_cli_tp2_takes_a_step_on_two_cpu_ranks(tmp_path):
    """``--tp 2`` through the trainer's command line: two processes joined
    by --coordinator (a file:// rendezvous), one step, rank 0 prints it."""
    rdv = (tmp_path / "rdv").as_uri()
    cmd = [sys.executable, "-m", "speechcatcher_tpu_torch.training",
           "--device", "cpu", "--tp", "2", "--steps", "1", "--batch", "4",
           "--eval-frac", "0", "--coordinator", rdv, "--num-processes", "2"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env={**os.environ,
                                              "OMP_NUM_THREADS": "1"})
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert "step 1: loss" in outs[0][0]
    assert outs[1][0] == ""


def test_dryrun_multichip_prints_the_mesh(capsys):
    from speechcatcher_tpu_torch.parallel.dryrun import dryrun_multichip

    loss = dryrun_multichip(4, timeout=RANK_TIMEOUT)
    assert np.isfinite(loss)
    assert "dryrun_multichip(4): mesh=dp2xtp2 loss=" in capsys.readouterr().out
