"""The conformer encoder in the PyTorch port against the JAX package on the
CPU: the same numpy weights and inputs through both.

JAX's ``random_init`` sets BatchNorm to identity and every conv bias to
zero, so the weights here get non-trivial running statistics, affine terms
and biases (``_perturb``). Tolerances: modules and the encoder step in
float32 on both sides with sums in another order, outputs of unit scale
within 1e-4; decodes token- and position-exact with final scores within
rel. 1e-5.
"""

import copy
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import bias_outputs, jax_model, n, synth_audio, t
from test_torch_engine import (
    CH,
    Script,
    short_segment,
    staggered_churn,
    two_streams,
)
from test_torch_modules import encoder_steps_match_jax
from test_torch_streaming import _run

from speechcatcher_tpu.models.encoder import block_attention_mask
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import (
    params_from_numpy,
    random_params,
    unstack_layers,
)

TOL = dict(rtol=1e-4, atol=1e-4)
SCORE_RTOL = 1e-5


def conformer_config(**kw):
    return tiny_config(encoder_type="conformer", conformer_kernel_size=7, **kw)


def _perturb(tree, seed: int):
    """Non-identity BatchNorm statistics and non-zero conv, attention and
    FFN biases in a conformer tree (in place)."""
    rng = np.random.default_rng(seed)
    layers = tree["encoder"]["layers"]

    def draw(a, lo, hi):
        a[...] = rng.uniform(lo, hi, size=a.shape).astype(np.float32)

    bn = layers["conv_module"]["batch_norm"]
    draw(bn["running_mean"], -0.3, 0.3)
    draw(bn["running_var"], 0.5, 2.0)
    draw(bn["weight"], 0.5, 1.5)
    draw(bn["bias"], -0.2, 0.2)
    for name in ("pointwise_conv1", "depthwise_conv", "pointwise_conv2"):
        draw(layers["conv_module"][name]["bias"], -0.2, 0.2)
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        draw(layers["self_attn"][name]["bias"], -0.1, 0.1)
    for ffn in ("feed_forward", "feed_forward_macaron"):
        draw(layers[ffn]["w_1"]["bias"], -0.1, 0.1)
    return tree


def _layer0(cfg, seed=3):
    """Layer 0 of a perturbed conformer encoder: (JAX tree, port tree)."""
    enc = _perturb(random_params(cfg, seed), seed)["encoder"]
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), enc["layers"])
    tl = unstack_layers(params_from_numpy(enc["layers"], "cpu"))[0]
    return jl, tl


@pytest.mark.parametrize("inner_norm", [False, True])
def test_conv_module_matches_jax(inner_norm):
    from speechcatcher_tpu.ops.conformer import conv_module as j_conv
    from speechcatcher_tpu_torch.ops.conformer import conv_module as p_conv

    jl, tl = _layer0(conformer_config(encoder_dim=16))
    jp, tp = dict(jl["conv_module"]), dict(tl["conv_module"])
    if inner_norm:
        rng = np.random.default_rng(9)
        ln = {"weight": rng.uniform(0.5, 1.5, 16).astype(np.float32),
              "bias": rng.uniform(-0.2, 0.2, 16).astype(np.float32)}
        jp["layernorm"] = jax.tree.map(jnp.asarray, ln)
        tp["layernorm"] = params_from_numpy(ln, "cpu")
    x = np.random.default_rng(1).standard_normal((3, 12, 16), np.float32)
    ref = j_conv(jp, jnp.asarray(x))
    got = p_conv(tp, t(x))
    np.testing.assert_allclose(n(got), n(ref), **TOL)
    # BatchNorm is live: identity statistics give another output.
    bn_id = dict(tp, batch_norm={k: (v * 0 + (k in ("weight", "running_var")))
                                 for k, v in tp["batch_norm"].items()})
    assert not np.allclose(n(p_conv(bn_id, t(x))), n(got), atol=1e-3)


@pytest.mark.parametrize("route", ["block_mask", "no_mask", "batch_mask"])
def test_rel_position_attention_matches_jax(route):
    """block_mask: the shared 2-D geometry mask and (1, W, d) table, the
    kernel route (its plain version on the CPU); no_mask: the
    short-utterance route; batch_mask: a (B, Tq, Tk) mask."""
    from speechcatcher_tpu.ops.conformer import (
        rel_position_attention as j_attn,
    )
    from speechcatcher_tpu_torch.ops.conformer import (
        rel_position_attention as p_attn,
    )
    import speechcatcher_tpu_torch.ops.kernels.rel_attention as kmod

    d, h, w = 16, 2, 10
    jl, tl = _layer0(conformer_config(encoder_dim=d, encoder_heads=h))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, w, d), np.float32)
    pos = rng.standard_normal((1, w, d), np.float32)
    mask = {"block_mask": block_attention_mask(w - 2), "no_mask": None,
            "batch_mask": (rng.random((4, w, w)) < 0.7).astype(np.float32)
            }[route]
    ref = j_attn(jl["self_attn"], *(jnp.asarray(x),) * 3, jnp.asarray(pos),
                 None if mask is None else jnp.asarray(mask), h)
    calls = []
    real = kmod.rel_block_attention_plain
    kmod.rel_block_attention_plain = lambda *a: calls.append(1) or real(*a)
    try:
        got = p_attn(tl["self_attn"], *(t(x),) * 3, t(pos),
                     None if mask is None else t(mask), h)
    finally:
        kmod.rel_block_attention_plain = real
    np.testing.assert_allclose(n(got), n(ref), **TOL)
    assert len(calls) == (route == "block_mask")


def test_conformer_block_matches_jax():
    from speechcatcher_tpu.models.encoder import _conformer_block as j_block
    from speechcatcher_tpu_torch.models.encoder import (
        _conformer_block as p_block,
    )
    from speechcatcher_tpu_torch.ops.layers import sinusoidal_pe_table

    d, h, w = 16, 2, 10
    jl, tl = _layer0(conformer_config(encoder_dim=d, encoder_heads=h))
    x = np.random.default_rng(4).standard_normal((3, w, d), np.float32)
    pe = sinusoidal_pe_table(d, w)[None]
    mask = block_attention_mask(w - 2)
    ref = j_block(jl, jnp.asarray(x), jnp.asarray(mask), h,
                  pos_emb=jnp.asarray(pe))
    got = p_block(tl, t(x), t(mask), h, pos_emb=t(pe))
    np.testing.assert_allclose(n(got), n(ref), **TOL)


def test_streaming_encoder_step_matches_jax():
    cfg = conformer_config()
    encoder_steps_match_jax(cfg, _perturb(random_params(cfg, 5), 5))


@pytest.mark.parametrize("seed,seconds,biases", [
    (0, 2.0, (0.0, 0.0)),
    (1, 3.0, (4.0, 3.0)),
])
def test_session_matches_jax(seed, seconds, biases):
    from speechcatcher_tpu.streaming import Speech2TextStreaming as JaxSession
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

    cfg = conformer_config()
    tree = bias_outputs(_perturb(random_params(cfg, seed), seed), cfg,
                        *biases)
    js = JaxSession(model=jax_model(cfg, copy.deepcopy(tree)), beam_size=3)
    ps = Speech2TextStreaming(model=ASRModel.from_numpy(cfg, tree, "cpu"),
                              beam_size=3, device="cpu")
    audio = synth_audio(seconds, seed)
    chunks = [audio[i:i + 8000] for i in range(0, len(audio), 8000)]
    j_out, j_nbest = _run(js, chunks)
    p_out, p_nbest = _run(ps, chunks)
    assert p_out == j_out
    assert len(j_nbest[0][0]) > 2  # the decode emitted something
    for (jy, jx, jsc), (py, px, psc) in zip(j_nbest, p_nbest):
        np.testing.assert_array_equal(py, jy)
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_allclose(psc, jsc, rtol=SCORE_RTOL)


# name: (engine kwargs, (eos, blank) biases, script)
ENGINE_CASES = {
    "staggered_churn": (dict(n_slots=3), (0.0, 0.0), staggered_churn),
    "two_streams_espnet": (dict(n_slots=2, use_bbd=False,
                                eos_commit="espnet"), (4.0, 3.0), two_streams),
    "short_segment": (dict(n_slots=3), (0.0, 0.0), short_segment),
}

_RUNS: Dict[str, tuple] = {}


def _run_engine_case(name):
    from speechcatcher_tpu.serve.engine import StreamingEngine as JaxEngine
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    if name not in _RUNS:
        eng_kw, biases, script = ENGINE_CASES[name]
        cfg = conformer_config()
        tree = bias_outputs(_perturb(random_params(cfg, 7), 7), cfg, *biases)
        kw = dict(beam_size=3, chunk_samples=CH, **eng_kw)
        jax_sc = Script(JaxEngine(jax_model(cfg, copy.deepcopy(tree)), **kw))
        script(jax_sc)
        port_sc = Script(StreamingEngine(
            ASRModel.from_numpy(cfg, tree, device="cpu"), device="cpu", **kw))
        script(port_sc)
        _RUNS[name] = (jax_sc, port_sc)
    return _RUNS[name]


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_ticks_match_jax(name):
    jax_sc, port_sc = _run_engine_case(name)
    ticks = [e for e in jax_sc.log if e[0] == "tick"]
    assert any(any(v for v in e[1].values()) for e in ticks) or \
        name == "short_segment"  # partials were not all empty
    assert [e for e in port_sc.log if e[0] != "final"] == \
        [e for e in jax_sc.log if e[0] != "final"]


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_finals_match_jax(name):
    jax_sc, port_sc = _run_engine_case(name)
    j_finals = [e for e in jax_sc.log if e[0] == "final"]
    assert j_finals and all(len(e[2]) > 2 for e in j_finals)
    assert [e for e in port_sc.log if e[0] == "final"] == j_finals
    np.testing.assert_allclose(port_sc.scores, jax_sc.scores,
                               rtol=SCORE_RTOL)
