"""The port's trainer against the JAX package's on the CPU: optimizer steps,
train steps, evaluation, checkpoints and the command line.

Tolerances: losses within 1e-5 relative (float32 sums in another order;
they read 1e-7). Parameters after three adamw steps within 1e-4 absolute,
5% of the largest move (2e-3): adamw divides each element's update by its
own gradient's size, so an element whose gradient is float32 noise moves
by up to the learning rate in either direction in both packages; the worst
element reads 2.7e-5. The optimizer alone, on fixed gradients, within 1e-6
relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_common import jax_config, t
from test_torch_train_modules import _batch

import speechcatcher_tpu.training as JT
import speechcatcher_tpu_torch.training as PT
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import (
    params_checksum,
    params_to_numpy,
    random_params,
    tree_leaves,
)
from speechcatcher_tpu_torch.utils.save import (
    load_checkpoint,
    save_checkpoint,
)

PARAM_ATOL = 1e-4


def _assert_tree_close(got_tree, ref_tree, atol):
    got = dict(tree_leaves(got_tree))
    ref = dict(tree_leaves(jax.tree.map(np.asarray, ref_tree)))
    assert got.keys() == ref.keys()
    for path, want in ref.items():
        np.testing.assert_allclose(got[path], want, rtol=0, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("enc", ["transformer", "conformer"])
def test_train_steps_match_jax(enc):
    """Three steps under WarmupLR (2 warmup steps) with a clip that
    triggers: the loss trajectory and the parameters after them."""
    cfg = tiny_config(n_mels=20, encoder_type=enc)
    tree = random_params(cfg, 0)
    batch = _batch(cfg, np.random.default_rng(13))
    clip = 1.0
    jcfg = jax_config(cfg)
    jb = JT.TrainBatch(*map(jnp.asarray, batch))
    jp = jax.tree.map(jnp.asarray, tree)
    grads = jax.grad(lambda p: JT.joint_loss(p, jb, jcfg)[0])(jp)
    assert float(optax.global_norm(grads)) > 10 * clip  # the clip acts
    jopt = JT.make_optimizer(lr=1e-3, warmup_steps=2, grad_clip=clip)
    js = jopt.init(jp)
    j_loss = []
    for _ in range(3):
        jp, js, m = JT.train_step(jp, js, jb, jcfg, jopt)
        j_loss.append(float(m["loss"]))

    model = ASRModel.from_numpy(cfg, tree, "cpu")
    popt = PT.make_optimizer(lr=1e-3, warmup_steps=2, grad_clip=clip)
    ps = popt.init(model.params)
    pb = PT.TrainBatch(*map(t, batch))
    p_loss = []
    for _ in range(3):
        params, ps, m = PT.train_step(model.params, ps, pb, cfg, popt)
        assert params is model.params
        p_loss.append(float(m["loss"]))
    assert ps.count == 3
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-5)
    assert p_loss[2] < p_loss[0]
    _assert_tree_close(params_to_numpy(model.params), jp, PARAM_ATOL)


@pytest.mark.parametrize("clip,warmup", [(0.0, 0), (100.0, 3), (0.5, 3)])
def test_optimizer_matches_optax_on_fixed_gradients(clip, warmup):
    """adamw (weight decay 1e-6 on every leaf), the clip rule (untouched
    below the limit, scaled by limit / norm above) and the schedule's
    step (the first update at count 0, raised to 1), over four updates."""
    rng = np.random.default_rng(int(clip * 10) + warmup)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.3
              for s in shapes] for _ in range(4)]
    jopt = JT.make_optimizer(lr=1e-2, warmup_steps=warmup, grad_clip=clip)
    jp = [jnp.asarray(p) for p in params]
    js = jopt.init(jp)
    norms = []
    for g in grads:
        norms.append(float(optax.global_norm(g)))
        upd, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
    if clip:
        assert (min(norms) > clip) == (clip < 1.0)

    popt = PT.make_optimizer(lr=1e-2, warmup_steps=warmup, grad_clip=clip)
    tree = {"p": [torch.from_numpy(p.copy()) for p in params]}
    state = popt.init(tree)
    for g in grads:
        popt.update([torch.from_numpy(x) for x in g], state)
    for got, want in zip(tree["p"], jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_warmup_schedule_matches_jax():
    js = JT.warmup_lr_schedule(2e-3, 25)
    ps = PT.warmup_lr_schedule(2e-3, 25)
    for step in (0, 1, 2, 24, 25, 26, 1000):
        np.testing.assert_allclose(ps(step), float(js(jnp.int32(step))),
                                   rtol=1e-7)


def test_evaluate_matches_jax():
    """Mean losses and the greedy WER/CER over two eval batches, the second
    flush-padded (refs trimmed to its real rows)."""
    from speechcatcher_tpu.data import BucketBatcher as JB
    from speechcatcher_tpu.data import synthetic_dataset as js_data
    from speechcatcher_tpu_torch.data import BucketBatcher as PB
    from speechcatcher_tpu_torch.data import synthetic_dataset as ps_data
    from test_torch_common import jax_model

    cfg = tiny_config(n_mels=20)
    tree = random_params(cfg, 4)
    tree["ctc"]["ctc_lo"]["bias"][2:] += 3.0  # emit tokens
    jm = jax_model(cfg, tree)
    pm = ASRModel.from_numpy(cfg, tree, "cpu")
    jutts = js_data(7, jax_config(cfg), jm.tokenizer, seed=3)
    putts = ps_data(7, cfg, pm.tokenizer, seed=3)
    ref = JT.evaluate(jm.params, jax_config(cfg),
                      JB(jm.frontend, jm.tokenizer, batch_size=4).batches(
                          jutts, with_refs=True), jm.tokenizer)
    got = PT.evaluate(pm.params, cfg,
                      PB(pm.frontend, pm.tokenizer, batch_size=4).batches(
                          putts, with_refs=True), pm.tokenizer)
    assert got.keys() == ref.keys() == {"loss", "ctc", "att", "wer", "cer"}
    for key in ("loss", "ctc", "att"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
    assert (got["wer"], got["cer"]) == (ref["wer"], ref["cer"])


def test_checkpoint_round_trip(tmp_path):
    cfg = tiny_config(encoder_type="conformer")
    model = ASRModel.random_init(cfg, seed=9, device="cpu")
    save_checkpoint(tmp_path, model.params, cfg, step=3)
    save_checkpoint(tmp_path, model.params, cfg, step=12)
    meta = json.loads((tmp_path / "config.json").read_text())
    assert meta["step"] == 12 and meta["config"]["encoder_type"] == "conformer"
    params, cfg2, step = load_checkpoint(tmp_path, device="cpu")
    assert (cfg2, step) == (cfg, 12)
    assert isinstance(params["encoder"]["layers"], list)
    assert (params_checksum(params_to_numpy(params))
            == params_checksum(random_params(cfg, 9)))
    assert load_checkpoint(tmp_path, step=3, device="cpu")[2] == 3


def test_main_trains_saves_and_resumes(tmp_path, capsys):
    """``main --steps 2 --device cpu`` on synthetic data, then ``--resume
    --steps 1``: the resumed run starts from the saved parameters."""
    save = tmp_path / "ckpt"
    PT.main(["--steps", "2", "--batch", "4", "--device", "cpu",
             "--save-dir", str(save)])
    out = capsys.readouterr().out
    assert "29 train / 3 eval utterances" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "eval @ step 2: loss" in out and " wer " in out
    assert (save / "params_2.pt").exists()
    saved, _, _ = load_checkpoint(save, device="cpu")

    seen = {}
    orig = PT.train_step

    def spy(params, *a):
        seen.setdefault("first", params_checksum(params_to_numpy(params)))
        return orig(params, *a)

    PT.train_step = spy
    try:
        PT.main(["--steps", "1", "--batch", "4", "--device", "cpu",
                 "--save-dir", str(save), "--resume"])
    finally:
        PT.train_step = orig
    out = capsys.readouterr().out
    assert f"resumed step 2 from {save}" in out and "step 3: loss" in out
    assert seen["first"] == params_checksum(params_to_numpy(saved))
    assert (save / "params_3.pt").exists()


@pytest.mark.parametrize("flags,message", [
    (["--num-processes", "2"], "only with --coordinator"),
    (["--coordinator", "host0:1234"], "--coordinator requires"),
    (["--process-id", "1"], "only with --coordinator"),
    (["--tp", "2"], "--tp 2 runs one process per card")])
def test_main_refuses_multi_gpu_flags(flags, message, capsys):
    """Multi-card flags that cannot take effect in one process stop the
    trainer (test_torch_parallel_training runs --tp 2 on two ranks)."""
    with pytest.raises(SystemExit) as exc:
        PT.main(["--device", "cpu", *flags])
    assert exc.value.code != 0
    assert message in capsys.readouterr().err
