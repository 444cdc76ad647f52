"""Offline greedy decode of the port against the JAX package on the CPU:
``greedy_decode_batch`` (text and token ids, exactly) for both encoders,
over a batch with a short utterance (the plain path's length, padded into a
longer batch) and long ones, and ``ctc_prefix_beam_search_host``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_model

from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.synth import synth_audio


def _tree(cfg, seed, audio):
    """Random weights whose CTC head emits tokens that change from frame to
    frame: its bias cancels the mean logit over `audio`'s frames (random
    encoders give outputs that vary little in time), the blank's lowered."""
    from speechcatcher_tpu_torch.models.ctc import ctc_logits
    from speechcatcher_tpu_torch.models.encoder import encoder_forward_train

    tree = random_params(cfg, seed)
    model = ASRModel.from_numpy(cfg, tree, "cpu")
    feats = model.frontend(audio)
    with torch.no_grad():
        enc, _ = encoder_forward_train(model.params["encoder"], feats,
                                       torch.tensor([feats.shape[1]]), cfg)
        mean = ctc_logits(model.params["ctc"], enc)[0].mean(dim=0)
    tree["ctc"]["ctc_lo"]["bias"] -= mean.numpy()
    tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] -= 1.0
    return tree


@pytest.mark.parametrize("enc", ["transformer", "conformer"])
def test_greedy_decode_batch_matches_jax(enc):
    from speechcatcher_tpu.decode.greedy import greedy_decode_batch as JG
    from speechcatcher_tpu_torch.decode.greedy import (
        greedy_decode_batch as PG,
    )

    cfg = tiny_config(encoder_type=enc)
    waves = [synth_audio(s, seed=i) for i, s in enumerate((2.3, 0.3, 1.1))]
    tree = _tree(cfg, 21, waves[0])
    ref = JG(jax_model(cfg, tree), waves)
    got = PG(ASRModel.from_numpy(cfg, tree, "cpu"), waves)
    assert got == ref
    assert sum(len(ids) for _, ids in got) >= 10


def test_greedy_short_batch_takes_the_plain_path():
    """A batch no longer than one block runs no blocked attention."""
    from speechcatcher_tpu.decode.greedy import greedy_decode_batch as JG
    from speechcatcher_tpu_torch.decode.greedy import (
        greedy_decode_batch as PG,
    )

    cfg = tiny_config()
    waves = [synth_audio(0.3, seed=7), synth_audio(0.2, seed=8)]
    tree = _tree(cfg, 22, waves[0])
    assert PG(ASRModel.from_numpy(cfg, tree, "cpu"), waves) == JG(
        jax_model(cfg, tree), waves)


def test_greedy_runs_without_grad():
    from speechcatcher_tpu_torch.decode.greedy import _encode_and_collapse

    cfg = tiny_config()
    model = ASRModel.random_init(cfg, seed=3, device="cpu")
    for x in model.params["encoder"]["layers"][0]["self_attn"][
            "linear_q"].values():
        x.requires_grad_()
    feats = torch.zeros(2, 90, cfg.n_mels)
    tokens, counts = _encode_and_collapse(
        model.params, feats, torch.tensor([90, 50]), cfg)
    assert not tokens.requires_grad and tokens.shape[0] == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_prefix_beam_search_host_matches_jax(seed):
    from speechcatcher_tpu.decode.greedy import (
        ctc_prefix_beam_search_host as JB,
    )
    from speechcatcher_tpu_torch.decode.greedy import (
        ctc_prefix_beam_search_host as PB,
    )

    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((25, 9)).astype(np.float32) * 2.0
    logits[:, 0] += 1.0
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    for beam in (1, 4, 10):
        assert PB(log_probs, beam_size=beam) == JB(log_probs, beam_size=beam)
