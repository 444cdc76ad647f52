"""Module-level parity of the PyTorch port against the JAX package on the
CPU: the same numpy weights and inputs through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_config, n, t

from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import random_params, unstack_layers

# float32 on both sides; sums run in another order, so outputs of unit scale
# agree to about 1e-6 and we allow 1e-4.
TOL = dict(rtol=1e-4, atol=1e-4)


def _jp(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_building_blocks_match_jax():
    import speechcatcher_tpu.ops.layers as J
    import speechcatcher_tpu_torch.ops.layers as P
    from speechcatcher_tpu.models.encoder import block_attention_mask

    cfg = tiny_config(encoder_dim=32, encoder_heads=4)
    enc = random_params(cfg, 3)["encoder"]
    layer = jax.tree.map(lambda a: a[0], enc["layers"])
    layer_t = unstack_layers(
        {k: v for k, v in _tp(enc["layers"]).items()})[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 10, 32), dtype=np.float32)
    jl, tl = _jp(layer), layer_t

    np.testing.assert_allclose(
        n(P.linear(tl["feed_forward"]["w_1"], t(x))),
        n(J.linear(jl["feed_forward"]["w_1"], jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        n(P.layer_norm(tl["norm1"], t(x) * 3 + 1)),
        n(J.layer_norm(jl["norm1"], jnp.asarray(x) * 3 + 1)), **TOL)
    np.testing.assert_allclose(
        n(P.feed_forward(tl["feed_forward"], t(x))),
        n(J.feed_forward(jl["feed_forward"], jnp.asarray(x))), **TOL)
    masks = [
        None,
        (rng.random((4, 10, 10)) < 0.7).astype(np.float32),   # (B, Tq, Tk)
        (rng.random((4, 1, 10)) < 0.7).astype(np.float32),    # (B, 1, Tk)
        block_attention_mask(8),                              # block kernel
    ]
    for m in masks:
        got = P.multi_head_attention(tl["self_attn"], t(x), t(x), t(x),
                                     None if m is None else t(m), 4)
        ref = J.multi_head_attention(jl["self_attn"], jnp.asarray(x),
                                     jnp.asarray(x), jnp.asarray(x),
                                     None if m is None else jnp.asarray(m), 4)
        np.testing.assert_allclose(n(got), n(ref), **TOL)
    pe = J.sinusoidal_pe_table(32, 50)
    np.testing.assert_array_equal(P.sinusoidal_pe_table(32, 50), pe)
    np.testing.assert_allclose(
        n(P.add_positional_encoding(t(x), t(pe), 7)),
        n(J.add_positional_encoding(jnp.asarray(x), jnp.asarray(pe), 7)),
        **TOL)


def _tp(tree):
    from speechcatcher_tpu_torch.params import params_from_numpy

    return params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("stats", [False, True])
def test_frontend_matches_jax(stats):
    from speechcatcher_tpu.ops.frontend import Frontend as JF
    from speechcatcher_tpu_torch.ops.frontend import Frontend as PF
    from speechcatcher_tpu_torch.synth import synth_audio

    rng = np.random.default_rng(1)
    mean = std = None
    if stats:
        mean = rng.standard_normal(80).astype(np.float32)
        std = (0.5 + rng.random(80)).astype(np.float32)
    audio = synth_audio(0.7, seed=4)
    got = PF(mean=mean, std=std)(audio)
    ref = JF(mean=mean, std=std)(jnp.asarray(audio))
    assert got.shape == ref.shape == (1, 1 + len(audio) // 160, 80)
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-4, atol=1e-4)
    feats = rng.standard_normal((13, 80)).astype(np.float32)
    np.testing.assert_allclose(
        n(PF(mean=mean, std=std).normalize_only(feats)),
        n(JF(mean=mean, std=std).normalize_only(jnp.asarray(feats))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("input_layer",
                         ["conv2d", "conv2d6", "conv2d8", "linear"])
def test_streaming_encoder_step_matches_jax(input_layer):
    cfg = tiny_config(input_layer=input_layer)
    encoder_steps_match_jax(cfg, random_params(cfg, 5))


def encoder_steps_match_jax(cfg, tree):
    """StreamingEncoder.step over chunks of several sizes, then a final
    chunk short enough for the unblocked path, through both packages."""
    from speechcatcher_tpu.models.encoder import StreamingEncoder as JE
    from speechcatcher_tpu_torch.models.encoder import StreamingEncoder as PE

    model = ASRModel.from_numpy(cfg, tree, device="cpu")
    je = JE(_jp(tree["encoder"]), jax_config(cfg))
    pe = PE(model.params["encoder"], cfg, model.enc_pe)
    rng = np.random.default_rng(2)
    sub = cfg.subsample
    sizes = [s * sub for s in (2, 9, 5, 13, 4, 11)] + [7]
    js, ps = je.init_state(), pe.init_state()
    emitted = 0
    for i, size in enumerate(sizes):
        final = i == len(sizes) - 1
        feats = rng.standard_normal((1, size, 80)).astype(np.float32)
        jy, js = je.step(jnp.asarray(feats), js, final)
        py, ps = pe.step(t(feats), ps, final)
        assert py.shape == jy.shape, (i, py.shape, jy.shape)
        np.testing.assert_allclose(n(py), n(jy), **TOL)
        emitted += py.shape[1]
    assert emitted > 0 and ps is None and js is None
    # A final chunk short enough for the unblocked path.
    feats = rng.standard_normal((1, 6 * sub, 80)).astype(np.float32)
    jy, _ = je.step(jnp.asarray(feats), je.init_state(), True)
    py, _ = pe.step(t(feats), pe.init_state(), True)
    assert py.shape[1] > 0
    np.testing.assert_allclose(n(py), n(jy), **TOL)


def test_decoder_step_matches_jax_over_steps_with_reorder():
    from speechcatcher_tpu.models.decoder import (
        decoder_step as j_step,
        init_decoder_cache as j_cache,
    )
    from speechcatcher_tpu_torch.models.decoder import (
        decoder_step as p_step,
        init_decoder_cache as p_cache,
    )

    cfg = tiny_config()
    jcfg = jax_config(cfg)
    beam = 3
    tree = random_params(cfg, 6)
    model = ASRModel.from_numpy(cfg, tree, device="cpu")
    jparams = _jp(tree["decoder"])
    jpe = jnp.asarray(np.asarray(model.dec_pe))
    rng = np.random.default_rng(3)
    memory = rng.standard_normal((1, cfg.max_enc_frames, 16)).astype(np.float32)
    memory[0, 40:] = np.nan  # stale frames past enc_len must not leak
    enc_len = np.array([23], np.int32)
    lane = np.zeros((1, beam, cfg.max_tokens), np.int32)
    jc, pc = j_cache(jcfg, beam), p_cache(cfg, beam, torch.device("cpu"))
    for step in range(5):
        tokens = rng.integers(0, cfg.vocab_size, size=beam).astype(np.int32)
        pos = np.full(beam, step, np.int32)
        write = np.array([True, True, step % 2 == 0])
        jl, jc = j_step(jparams, jpe, jc, jnp.asarray(memory),
                        jnp.asarray(tokens), jnp.asarray(pos),
                        jnp.asarray(enc_len), jnp.asarray(lane),
                        jnp.asarray(write), jcfg, beam)
        pl, pc = p_step(model.params["decoder"], model.dec_pe, pc, t(memory),
                        t(tokens), t(pos), t(enc_len), t(lane), t(write),
                        cfg, beam)
        np.testing.assert_allclose(n(pl), n(jl), **TOL)
        np.testing.assert_allclose(n(pc.h), n(jc.h), **TOL)
        # Beam reorder: each slot inherits a parent's lane lineage, and this
        # step's rows were written at the parent's lane.
        src = rng.integers(0, beam, size=beam)
        lane = lane[:, src]
        lane[0, :, step] = src


def test_ctc_prefix_scorer_matches_jax_over_steps():
    import speechcatcher_tpu.decode.ctc_prefix as J
    import speechcatcher_tpu_torch.decode.ctc_prefix as P

    s_dim, beam, t_cap, vocab, k = 2, 3, 64, 16, 5
    blank, eos = 0, vocab - 1
    rng = np.random.default_rng(4)
    js = J.init_ctc_state(s_dim, beam, t_cap, vocab)
    ps = P.init_ctc_state(s_dim, beam, t_cap, vocab, torch.device("cpu"))
    last = np.full((s_dim, beam), eos, np.int32)
    olen = np.zeros(s_dim, np.int32)

    def compare(a, b, **tol):
        for name in ("logp", "enc_len", "r", "s"):
            np.testing.assert_allclose(n(getattr(a, name)),
                                       n(getattr(b, name)), err_msg=name,
                                       **tol)

    for step in range(4):
        if step in (0, 2):
            logits = rng.standard_normal((s_dim, 6, vocab)).astype(np.float32)
            new = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
            if step == 2:
                new[1, 2, 3] = np.nan  # sanitized to LOGZERO on append
            n_new = np.array([6, 4], np.int32)
            js = J.ctc_extend(js, jnp.asarray(new), jnp.asarray(n_new))
            ps = P.ctc_extend(ps, t(new), t(n_new))
            compare(ps, js, rtol=1e-5, atol=1e-4)
        cand = np.stack([np.stack([rng.permutation(np.arange(1, vocab))[:k]
                                   for _ in range(beam)])
                         for _ in range(s_dim)]).astype(np.int32)
        if last[0, 0] not in cand[0, 0]:  # a candidate equal to the last
            cand[0, 0, 1] = last[0, 0]    # token (candidates stay distinct)
        j_sc, j_psi = J.ctc_score_candidates(js, jnp.asarray(last),
                                             jnp.asarray(olen),
                                             jnp.asarray(cand), blank, eos)
        p_sc, p_psi = P.ctc_score_candidates(ps, t(last), t(olen), t(cand),
                                             blank, eos)
        np.testing.assert_allclose(n(p_sc), n(j_sc), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(n(p_psi), n(j_psi), rtol=1e-5, atol=1e-4)
        src = rng.integers(0, beam, size=(s_dim, beam)).astype(np.int32)
        chosen = np.take_along_axis(cand[:, :, 0], src, axis=1)
        chosen[1, 2] = eos  # outside the candidate set: slot-0 fallback
        js = J.ctc_advance_state(js, j_psi, jnp.asarray(src),
                                 jnp.asarray(chosen), jnp.asarray(cand),
                                 jnp.asarray(last), jnp.asarray(olen))
        ps = P.ctc_advance_state(ps, p_psi, t(src), t(chosen), t(cand),
                                 t(last), t(olen))
        # JAX on the CPU runs the recursion as an associative scan, the port
        # sequentially: same values up to float reassociation.
        compare(ps, js, rtol=1e-5, atol=1e-3)
        last, olen = chosen, olen + 1
