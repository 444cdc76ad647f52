"""The port's training-mode modules against the JAX package on the CPU.

Kernels A and E through their autograd Functions against ``jax.grad``
through the JAX kernels in interpret mode (so their ``custom_vjp`` runs);
the grad refusal of B, C and D; ``encoder_forward_train``,
``decoder_forward_train``, the CTC head's loss and greedy collapse,
``label_smoothing_ce`` and ``joint_loss`` with every gradient leaf, compared
in the JAX layout through ``params_to_numpy``. Same numpy weights and inputs
through both packages.

Tolerances: forward values within 1e-5 relative (float32 sums in another
order). Gradients of the attention kernels and the CTC loss within 1e-4
relative plus 1e-6 absolute. Gradient leaves of a whole loss within 1e-4
relative plus 1e-4 of the leaf's largest magnitude (the worst leaf, a
conformer projection summing thousands of float32 terms, reads 1.4e-5 of
it), and never tighter than 1e-8 absolute: the K-projection biases have a
gradient that is zero in exact arithmetic (the softmax does not see a bias
added to every key) and float32 noise of about 1e-10 in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_config, n, t

from speechcatcher_tpu.models.encoder import block_attention_mask
from speechcatcher_tpu.ops.pallas.block_attention import (
    block_attention as jax_block_attention,
)
from speechcatcher_tpu.ops.pallas.rel_attention import (
    rel_block_attention as jax_rel_block_attention,
)
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.ops.kernels import block_attention as attn_mod
from speechcatcher_tpu_torch.ops.kernels.block_attention import (
    BlockAttentionFn,
    block_attention,
)
from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
    ctc_forward_recursion,
    ctc_forward_recursion_streams,
)
from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
    RelBlockAttentionFn,
    rel_block_attention,
)
from speechcatcher_tpu_torch.ops.kernels.ring_append import (
    ring_append_cols,
    ring_append_rows,
)
from speechcatcher_tpu_torch.params import (
    params_from_numpy,
    params_to_numpy,
    random_params,
    tree_leaves,
    tree_map,
    unstack_layers,
)

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LEAF_ATOL_SCALE, LEAF_ATOL_MIN = 1e-4, 1e-8


def _mask(w, fully_masked_row=None):
    m = block_attention_mask(w - 2)
    if fully_masked_row is not None:
        m[fully_masked_row] = 0.0
    return m


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _leaf_grads(fn, args, n_diff):
    """Port: output of fn on leaf tensors and the grads of its first
    n_diff operands for a fixed random cotangent."""
    xs = [t(a).requires_grad_(i < n_diff) for i, a in enumerate(args)]
    out = fn(*xs)
    cot = np.random.default_rng(99).standard_normal(
        tuple(out.shape)).astype(np.float32)
    (out * t(cot)).sum().backward()
    return out, [xs[i].grad for i in range(n_diff)], cot


@pytest.mark.parametrize("fully_masked_row", [None, 3])
def test_block_attention_fn_grads_match_jax(fully_masked_row):
    rng = np.random.default_rng(3)
    nb, h, w, dk = 5, 2, 10, 8
    q, k, v = (_rand(rng, nb, h, w, dk) for _ in range(3))
    mask = _mask(w, fully_masked_row)
    out, grads, cot = _leaf_grads(block_attention, (q, k, v, mask), 3)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "BlockAttentionFnBackward"

    def loss(q_, k_, v_):
        o = jax_block_attention(q_, k_, v_, jnp.asarray(mask), interpret=True)
        return jnp.sum(o * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(n(got), n(want), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    # Rows 0 (and the extra one) see no key: zero output, zero dq.
    for row in {0, fully_masked_row} - {None}:
        assert np.all(n(out)[:, :, row] == 0.0)
        assert np.all(n(grads[0])[:, :, row] == 0.0)


@pytest.mark.parametrize("fully_masked_row", [None, 4])
def test_rel_block_attention_fn_grads_match_jax(fully_masked_row):
    rng = np.random.default_rng(4)
    nb, h, w, dk = 3, 2, 8, 4
    q, k, v = (_rand(rng, nb, h, w, dk) for _ in range(3))
    pos, bu, bv = _rand(rng, h, w, dk), _rand(rng, h, dk), _rand(rng, h, dk)
    mask = _mask(w, fully_masked_row)
    args = (q, k, v, pos, bu, bv, mask)
    out, grads, cot = _leaf_grads(rel_block_attention, args, 6)
    assert type(out.grad_fn).__name__ == "RelBlockAttentionFnBackward"

    def loss(*xs):
        o = jax_rel_block_attention(*xs, jnp.asarray(mask), interpret=True)
        return jnp.sum(o * cot)

    ref = jax.grad(loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, args[:6]))
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(n(got), n(want), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert all(float(g.abs().max()) > 0 for g in grads)  # pos, u, v train


def test_functions_take_projection_views():
    """The main path's form: q, k, v as transposed views of (N, W, H·dk)
    projections of one trainable input; the result merges back as a view,
    and the gradient reaches the input."""
    rng = np.random.default_rng(5)
    nb, h, w, dk = 4, 2, 6, 4
    x = t(_rand(rng, nb, w, h * dk)).requires_grad_()
    ws = [t(_rand(rng, h * dk, h * dk)) for _ in range(3)]

    def project(wt):
        return (x @ wt).reshape(nb, w, h, dk).transpose(1, 2)

    mask = t(_mask(w))
    out = block_attention(*map(project, ws), mask)
    merged = out.transpose(1, 2).reshape(nb, w, h * dk)
    merged.square().sum().backward()
    ref_x = x.detach().clone().requires_grad_()

    def ref_project(wt):
        return (ref_x @ wt).reshape(nb, w, h, dk).transpose(1, 2)

    ref = attn_mod.block_attention_plain(*map(ref_project, ws), mask)
    ref.transpose(1, 2).reshape(nb, w, h * dk).square().sum().backward()
    np.testing.assert_array_equal(n(x.grad), n(ref_x.grad))


def test_dispatch_leaves_inference_calls_alone(monkeypatch):
    """Without grad mode, or with no operand requiring grad, the wrappers
    take the forward path directly: no Function, no grad_fn, the same
    numbers. With grad, every call goes through the Function."""
    rng = np.random.default_rng(6)
    q, k, v = (t(_rand(rng, 2, 2, 6, 4)) for _ in range(3))
    pos, bu, bv = t(_rand(rng, 2, 6, 4)), t(_rand(rng, 2, 4)), t(
        _rand(rng, 2, 4))
    mask = t(_mask(6))
    calls = []
    for fn in (BlockAttentionFn, RelBlockAttentionFn):
        monkeypatch.setattr(fn, "apply", classmethod(
            lambda cls, *a, _orig=fn.apply: calls.append(cls) or _orig(*a)))
    plain = block_attention(q, k, v, mask)
    rel = rel_block_attention(q, k, v, pos, bu, bv, mask)
    with torch.no_grad():
        block_attention(q.requires_grad_(), k, v, mask)
        rel_block_attention(q, k, v, pos, bu, bv, mask)
    assert calls == [] and plain.grad_fn is None and rel.grad_fn is None
    q.requires_grad_(False)
    bu.requires_grad_()
    rel2 = rel_block_attention(q, k, v, pos, bu, bv, mask)
    assert calls == [RelBlockAttentionFn] and rel2.grad_fn is not None
    np.testing.assert_array_equal(n(rel2), n(rel))
    k.requires_grad_()
    assert block_attention(q, k, v, mask).grad_fn is not None
    assert calls[-1] is BlockAttentionFn


def test_session_never_enters_the_functions(monkeypatch):
    """A streaming decode (and an engine tick) on a tiny model runs no
    attention call through a Function: the serving paths keep the launch
    path and counts they had."""
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    def refuse(*a):
        raise AssertionError("a serving path entered an autograd Function")

    for fn in (BlockAttentionFn, RelBlockAttentionFn):
        monkeypatch.setattr(fn, "apply", refuse)
    for enc in ("transformer", "conformer"):
        cfg = tiny_config(encoder_type=enc)
        model = ASRModel.random_init(cfg, seed=2, device="cpu")
        audio = synth_audio(1.5, seed=3)
        s2t = Speech2TextStreaming(model=model, beam_size=2, device="cpu")
        s2t(audio[:12000])
        s2t(audio[12000:], is_final=True)
        eng = StreamingEngine(model, n_slots=2, beam_size=2,
                              chunk_samples=8192, device="cpu")
        slot = eng.acquire_slot()
        eng.tick({slot: audio[:8192]})


@pytest.mark.parametrize("kernel", ["B", "B_streams", "C", "D"])
def test_kernels_without_backward_refuse_grad(kernel):
    rng = np.random.default_rng(7)
    if kernel == "B":
        rows = [t(_rand(rng, 6, 3)) for _ in range(3)]
        rest = [torch.zeros(3, dtype=torch.int32),
                torch.full((3,), 6, dtype=torch.int32), torch.ones(3)]
        call, grad_operand = ctc_forward_recursion, 0
        operands = rows + rest
    elif kernel == "B_streams":
        operands = [t(_rand(rng, 2, 3, 6)), t(_rand(rng, 2, 1, 6)),
                    t(_rand(rng, 2, 3, 6)),
                    torch.zeros(2, dtype=torch.int32),
                    torch.full((2,), 6, dtype=torch.int32),
                    t(_rand(rng, 2, 3, 2, 6))]
        call, grad_operand = ctc_forward_recursion_streams, 2
    elif kernel == "C":
        operands = [torch.zeros(2, 4, 8), t(_rand(rng, 2, 4, 3)),
                    torch.zeros(2, dtype=torch.int32),
                    torch.full((2,), 3, dtype=torch.int32)]
        call, grad_operand = ring_append_cols, 1
    else:
        operands = [torch.zeros(2, 2, 8, 4), t(_rand(rng, 2, 2, 3, 4)),
                    torch.zeros(2, dtype=torch.int32),
                    torch.full((2,), 3, dtype=torch.int32)]
        call, grad_operand = ring_append_rows, 1
    operands[grad_operand].requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        call(*operands)
    with torch.no_grad():
        call(*operands)  # no grad mode: the call runs
    operands[grad_operand].requires_grad_(False)
    call(*operands)


def _models(cfg, seed=0):
    tree = random_params(cfg, seed)
    return tree, ASRModel.from_numpy(cfg, tree, "cpu")


ENC_CASES = [(layer, enc, "many") for enc in ("transformer", "conformer")
             for layer in ("conv2d", "conv2d6", "conv2d8", "linear")] + [
    ("conv2d", enc, span) for enc in ("transformer", "conformer")
    for span in ("short", "two_blocks")]


def _frames_for(span, cfg):
    """Input frames for a subsampled length: 'short' fits one block (the
    plain path; a blocked run always has two blocks or more), 'two_blocks'
    is one frame longer, 'many' about ten blocks."""
    from speechcatcher_tpu_torch.geometry import subsampled_len

    want = {"short": cfg.block_size, "two_blocks": cfg.block_size + 1,
            "many": 10 * cfg.hop_size + 3}[span]
    frames = 1
    while subsampled_len(frames, cfg.input_layer) < want:
        frames += 1
    return frames


@pytest.mark.parametrize("input_layer,enc,span", ENC_CASES)
def test_encoder_forward_train_matches_jax(input_layer, enc, span):
    from speechcatcher_tpu.models.encoder import encoder_forward_train as JF
    from speechcatcher_tpu_torch.models.encoder import (
        encoder_forward_train as PF,
    )

    cfg = tiny_config(n_mels=20, input_layer=input_layer, encoder_type=enc)
    tree, model = _models(cfg, seed=len(input_layer) + len(span))
    frames = _frames_for(span, cfg)
    rng = np.random.default_rng(frames)
    feats = _rand(rng, 3, frames, cfg.n_mels)
    ilens = np.array([frames, frames - 3, frames - 7], np.int32)
    ys_j, ol_j = JF(jax.tree.map(jnp.asarray, tree["encoder"]),
                    jnp.asarray(feats), jnp.asarray(ilens), jax_config(cfg))
    ys_p, ol_p = PF(model.params["encoder"], t(feats), t(ilens), cfg)
    np.testing.assert_array_equal(n(ol_p), n(ol_j))
    assert ys_p.shape == ys_j.shape
    np.testing.assert_allclose(n(ys_p), n(ys_j), rtol=1e-5, atol=1e-5)


def test_decoder_forward_train_matches_jax():
    from speechcatcher_tpu.models.decoder import decoder_forward_train as JD
    from speechcatcher_tpu_torch.models.decoder import (
        decoder_forward_train as PD,
    )

    cfg = tiny_config()
    tree, model = _models(cfg, seed=5)
    rng = np.random.default_rng(8)
    mem = _rand(rng, 3, 13, cfg.decoder_dim)
    mem_lens = np.array([13, 9, 4], np.int32)
    ys_in = rng.integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    ys_lens = np.array([7, 5, 1], np.int32)
    ref = JD(jax.tree.map(jnp.asarray, tree["decoder"]),
             *map(jnp.asarray, (mem, mem_lens, ys_in, ys_lens)),
             jax_config(cfg))
    got = PD(model.params["decoder"], *map(t, (mem, mem_lens, ys_in,
                                                ys_lens)), cfg)
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=1e-5)


def _ctc_case(feasible: bool):
    rng = np.random.default_rng(9)
    cfg = tiny_config()
    hs = _rand(rng, 3, 12, cfg.encoder_dim)
    hlens = np.array([12, 10, 7], np.int32)
    ys = rng.integers(1, cfg.vocab_size, (3, 5)).astype(np.int32)
    ylens = np.array([5, 3, 4], np.int32)
    ys[np.arange(5)[None, :] >= ylens[:, None]] = 0
    if feasible:
        ys[0, :3] = 7  # repeats: each needs a blank between
    else:
        hlens[2] = 3   # 4 labels in 3 frames
    return cfg, hs, hlens, ys, ylens


@pytest.mark.parametrize("feasible", [True, False])
def test_ctc_loss_against_optax(feasible):
    """Equal loss and gradients, for a feasible batch and for one with an
    infeasible row (more labels than frames), which optax, and the port's
    copy of its formulation, give a large finite value."""
    from speechcatcher_tpu.models.ctc import ctc_loss as JL
    from speechcatcher_tpu_torch.models.ctc import ctc_loss as PL

    cfg, hs, hlens, ys, ylens = _ctc_case(feasible)
    tree, model = _models(cfg, seed=6)
    ctc_p = tree_map(lambda a: a.requires_grad_(), model.params["ctc"])
    hs_t = t(hs).requires_grad_()
    loss_p = PL(ctc_p, hs_t, t(hlens), t(ys), t(ylens))
    loss_j, grads_j = jax.value_and_grad(
        lambda p, h: JL(p, h, *map(jnp.asarray, (hlens, ys, ylens))),
        argnums=(0, 1))(jax.tree.map(jnp.asarray, tree["ctc"]),
                        jnp.asarray(hs))
    if not feasible:
        assert np.isfinite(float(loss_j)) and float(loss_j) > 1e3
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5)
    loss_p.backward()
    np.testing.assert_allclose(n(hs_t.grad), n(grads_j[1]), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(n(ctc_p["ctc_lo"][name].grad),
                                   n(grads_j[0]["ctc_lo"][name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_ctc_greedy_collapse_matches_jax():
    """Repeats, blanks between repeats, all-blank rows, lengths that cut
    inside a run, and argmax ties (the lower id wins in both)."""
    from speechcatcher_tpu.models.ctc import ctc_greedy_collapse as JC
    from speechcatcher_tpu.models.ctc import ctc_argmax as JA
    from speechcatcher_tpu_torch.models.ctc import (
        ctc_argmax as PA,
        ctc_greedy_collapse as PC,
    )

    rng = np.random.default_rng(10)
    preds = rng.integers(0, 4, (6, 17)).astype(np.int32)
    preds[1] = 0
    preds[2, :] = [3, 3, 0, 3, 1, 1, 1, 0, 0, 2, 0, 2, 2, 3, 0, 0, 1]
    lens = np.array([17, 17, 17, 9, 0, 5], np.int32)
    got = PC(t(preds), t(lens))
    ref = JC(jnp.asarray(preds), jnp.asarray(lens))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(n(a), n(b))
    assert n(got[1])[1] == 0 and n(got[1])[4] == 0
    # Ties in the CTC head's argmax: zero weights, equal biases.
    ctc = {"ctc_lo": {"weight": np.zeros((8, 4), np.float32),
                      "bias": np.array([0, 2, 2, 1, 2, 0, 0, 0], np.float32)}}
    hs = _rand(rng, 2, 3, 4)
    np.testing.assert_array_equal(
        n(PA(params_from_numpy(ctc, "cpu"), t(hs))),
        n(JA(jax.tree.map(jnp.asarray, ctc), jnp.asarray(hs))))


def test_label_smoothing_ce_matches_jax():
    from speechcatcher_tpu.training import label_smoothing_ce as JS
    from speechcatcher_tpu_torch.training import label_smoothing_ce as PS

    rng = np.random.default_rng(11)
    logits = _rand(rng, 3, 6, 9)
    targets = rng.integers(0, 9, (3, 6)).astype(np.int32)
    for lens in ([6, 2, 4], [0, 0, 0]):
        lens = np.array(lens, np.int32)
        lt = t(logits).requires_grad_()
        got = PS(lt, t(targets), t(lens))
        ref, gref = jax.value_and_grad(
            lambda x: JS(x, jnp.asarray(targets), jnp.asarray(lens)))(
                jnp.asarray(logits))
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
        got.backward()
        np.testing.assert_allclose(n(lt.grad), n(gref), rtol=1e-5,
                                   atol=1e-7)


def _batch(cfg, rng, b=3, frames=170, u=6):
    """A TrainBatch in numpy: rows of different lengths, 0-padded tokens."""
    feats = _rand(rng, b, frames, cfg.n_mels)
    feat_lens = np.array([frames, frames - 20, frames - 50], np.int32)[:b]
    tokens = rng.integers(2, cfg.vocab_size - 1, (b, u)).astype(np.int32)
    token_lens = np.array([u, u - 2, u - 1], np.int32)[:b]
    tokens[np.arange(u)[None, :] >= token_lens[:, None]] = 0
    return feats, feat_lens, tokens, token_lens


def grads_tree(params):
    """The port tree's gradients, in the JAX layout."""
    return params_to_numpy(tree_map(
        lambda x: x.grad if x.grad is not None else torch.zeros_like(x),
        params))


def assert_grads_close(got_tree, ref_tree):
    got = dict(tree_leaves(got_tree))
    ref = dict(tree_leaves(jax.tree.map(np.asarray, ref_tree)))
    assert got.keys() == ref.keys()
    for path, want in ref.items():
        atol = max(LEAF_ATOL_SCALE * float(np.abs(want).max()),
                   LEAF_ATOL_MIN)
        np.testing.assert_allclose(got[path], want, rtol=GRAD_RTOL,
                                   atol=atol, err_msg=path)


@pytest.mark.parametrize("enc", ["transformer", "conformer"])
def test_joint_loss_and_grads_match_jax(enc):
    """Loss within 1e-5 relative; every gradient leaf, the conformer's
    BatchNorm running statistics included (leaves of the JAX tree)."""
    import speechcatcher_tpu.training as JT
    import speechcatcher_tpu_torch.training as PT

    cfg = tiny_config(n_mels=20, encoder_type=enc)
    tree = random_params(cfg, 0)
    if enc == "conformer":  # non-identity statistics
        bn = tree["encoder"]["layers"]["conv_module"]["batch_norm"]
        rng = np.random.default_rng(12)
        bn["running_mean"] += _rand(rng, *bn["running_mean"].shape) * 0.1
        bn["running_var"] += np.abs(_rand(rng, *bn["running_var"].shape))
    batch = _batch(cfg, np.random.default_rng(13))
    (loss_j, m_j), g_j = jax.value_and_grad(JT.joint_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree),
        JT.TrainBatch(*map(jnp.asarray, batch)), jax_config(cfg))
    params = params_from_numpy(tree, "cpu")
    for part in ("encoder", "decoder"):
        params[part]["layers"] = unstack_layers(params[part]["layers"])
    PT.make_optimizer().init(params)  # marks every float leaf trainable
    loss_p, m_p = PT.joint_loss(params, PT.TrainBatch(*map(t, batch)), cfg)
    for key in ("loss", "ctc", "att"):
        np.testing.assert_allclose(m_p[key].item(), float(m_j[key]),
                                   rtol=1e-5)
    loss_p.backward()
    assert_grads_close(grads_tree(params), g_j)
    if enc == "conformer":
        rm = grads_tree(params)["encoder"]["layers"]["conv_module"][
            "batch_norm"]["running_mean"]
        assert np.abs(rm).max() > 0
