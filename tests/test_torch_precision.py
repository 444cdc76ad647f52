"""The precision modes of the PyTorch port against the JAX package on the CPU:
bfloat16 weights (``cast_params``), weight-only int8 (``quantize_params_int8``)
and bfloat16 storage (decoder cache, CTC log-prob ring, emitted-frame ring).

The same float32 numpy tree goes to both packages and each applies its own
cast. Tolerances: the transformed trees are equal exactly after widening;
``linear`` within 1e-5 relative (products of two bfloat16 are exact in float32
and accumulate there on both sides, in another order); module outputs within
1e-4; what is stored in a bfloat16 cache within one bfloat16 ulp; decodes
token- and position-exact, partial by partial. The batched engine in these
modes is in ``test_torch_precision_engine.py``.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    bias_outputs,
    jax_config,
    jax_model,
    n,
    synth_audio,
    t,
)
from test_torch_conformer import _perturb, conformer_config
from test_torch_streaming import CONFIGS, _inputs, _run

import speechcatcher_tpu.ops.layers as J
import speechcatcher_tpu_torch.ops.layers as P
from speechcatcher_tpu.streaming import Speech2TextStreaming as JaxSession
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import (
    params_from_numpy,
    random_params,
    tree_leaves,
    unstack_layers,
)
from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

TOL = dict(rtol=1e-4, atol=1e-4)
LINEAR_RTOL = 1e-5
BF16_ULP = 2.0 ** -7   # spacing of bfloat16 relative to the value's binade


def _jp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _f32(x) -> np.ndarray:
    """Any leaf (tensor, JAX or numpy array, bfloat16 included) widened to
    float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _restack(params):
    """The port's tree with each ``layers`` list stacked back into the JAX
    package's layer-stacked leaves."""
    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([layer[k] for layer in layers]) for k in first}
        return torch.stack(list(layers))

    out = {}
    for k, v in params.items():
        if k == "layers" and isinstance(v, list):
            out[k] = stack(v)
        elif isinstance(v, dict):
            out[k] = _restack(v)
        else:
            out[k] = v
    return out


def _assert_trees_equal(port_tree, jax_tree):
    """The same leaves, of the same dtypes, equal exactly after widening."""
    got = dict(tree_leaves(_restack(port_tree)))
    ref = dict(tree_leaves(jax_tree))
    assert sorted(got) == sorted(ref)
    for path, leaf in ref.items():
        assert _dtype_name(got[path]) == _dtype_name(leaf), path
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        np.testing.assert_array_equal(_f32(got[path]), _f32(leaf),
                                      err_msg=path)


TREE_CONFIGS = {
    "transformer": tiny_config(),
    "conformer": conformer_config(),
    "linear_input": tiny_config(input_layer="linear"),
}


def _tree(name: str, seed: int = 3):
    cfg = TREE_CONFIGS[name]
    tree = random_params(cfg, seed)
    if cfg.encoder_type == "conformer":
        _perturb(tree, seed)
    return cfg, tree


# ---------------------------------------------------------------------------
# The transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TREE_CONFIGS))
def test_cast_params_matches_jax(name):
    cfg, tree = _tree(name)
    model = ASRModel.from_numpy(cfg, tree, device="cpu")
    got = P.cast_params(model.params)
    ref = J.cast_params(_jp(tree))
    _assert_trees_equal(got, ref)
    # What the rule catches beyond linears, and what it leaves alone.
    enc, dec = got["encoder"], got["decoder"]
    layer = enc["layers"][0]
    assert layer["self_attn"]["linear_q"]["weight"].dtype == torch.bfloat16
    assert layer["self_attn"]["linear_q"]["bias"].dtype == torch.float32
    assert enc["after_norm"]["weight"].dtype == torch.float32
    assert dec["embed"]["weight"].dtype == torch.float32
    assert dec["output_layer"]["weight"].dtype == torch.bfloat16
    if cfg.input_layer != "linear":
        assert enc["embed"]["convs"][0]["weight"].dtype == torch.bfloat16
    else:
        assert enc["embed"]["norm"]["weight"].dtype == torch.float32
    if cfg.encoder_type == "conformer":
        cm = layer["conv_module"]
        assert cm["pointwise_conv1"]["weight"].dtype == torch.bfloat16
        assert cm["depthwise_conv"]["weight"].dtype == torch.bfloat16
        assert cm["batch_norm"]["weight"].dtype == torch.float32
        assert layer["self_attn"]["pos_bias_u"].dtype == torch.float32
    # The input tree is left as it was.
    assert model.params["encoder"]["layers"][0]["self_attn"]["linear_q"][
        "weight"].dtype == torch.float32


@pytest.mark.parametrize("name", ["transformer", "conformer"])
def test_cast_params_on_a_stacked_tree_agrees_with_its_layers(name):
    """A layer-stacked 3-D weight and the per-layer views cast alike."""
    cfg, tree = _tree(name)
    stacked = P.cast_params(params_from_numpy(tree, "cpu"))
    _assert_trees_equal(stacked, J.cast_params(_jp(tree)))
    per_layer = P.cast_params(
        ASRModel.from_numpy(cfg, tree, device="cpu").params)
    for part in ("encoder", "decoder"):
        views = unstack_layers(stacked[part]["layers"])
        for a, b in zip(views, per_layer[part]["layers"]):
            for (pa, la), (pb, lb) in zip(tree_leaves(a), tree_leaves(b)):
                assert pa == pb and la.dtype == lb.dtype
                assert torch.equal(la, lb), pa


@pytest.mark.parametrize("after_cast", [False, True], ids=["f32", "cast"])
@pytest.mark.parametrize("scope", [("encoder",), None],
                         ids=["encoder", "all"])
@pytest.mark.parametrize("name", ["transformer", "conformer"])
def test_quantize_params_int8_matches_jax(name, scope, after_cast):
    cfg, tree = _tree(name)
    params = ASRModel.from_numpy(cfg, tree, device="cpu").params
    jparams = _jp(tree)
    if after_cast:
        params, jparams = P.cast_params(params), J.cast_params(jparams)
    got = P.quantize_params_int8(params, scope=scope)
    ref = J.quantize_params_int8(jparams, scope=scope)
    _assert_trees_equal(got, ref)
    enc = got["encoder"]["layers"][0]
    w = enc["feed_forward"]["w_1"]
    assert w["weight"].dtype == torch.int8
    assert w["weight_scale"].dtype == torch.float32
    assert w["weight_scale"].shape == w["weight"].shape[:1]
    assert enc["norm_ff" if name == "conformer" else "norm1"][
        "weight"].dtype == torch.float32
    assert got["encoder"]["embed"]["convs"][0]["weight"].dtype != torch.int8
    assert got["encoder"]["embed"]["out"]["weight"].dtype != torch.int8
    assert got["decoder"]["embed"]["weight"].dtype == torch.float32
    if name == "conformer":
        assert enc["conv_module"]["pointwise_conv1"]["weight"].dtype \
            != torch.int8
        assert enc["self_attn"]["linear_pos"]["weight"].dtype == torch.int8
    quantized_all = scope is None
    for leaf in (got["decoder"]["layers"][0]["src_attn"]["linear_k"],
                 got["decoder"]["output_layer"], got["ctc"]["ctc_lo"]):
        assert (leaf["weight"].dtype == torch.int8) == quantized_all
    # The stacked tree quantises to the same per-layer scales.
    stacked = params_from_numpy(tree, "cpu")
    if after_cast:
        stacked = P.cast_params(stacked)
    _assert_trees_equal(P.quantize_params_int8(stacked, scope=scope), ref)


def test_quantize_params_int8_grid_weights_are_lossless():
    rng = np.random.default_rng(0)
    ints = rng.integers(-127, 128, size=(8, 16)).astype(np.float32)
    ints[:, 0] = 127.0
    w = torch.from_numpy(ints * np.float32(0.0123))
    q = P.quantize_params_int8({"enc_x": {"weight": w}},
                               scope=("enc",))["enc_x"]
    assert q["weight"].dtype == torch.int8
    np.testing.assert_array_equal(q["weight"].numpy(), ints)
    # An all-zero row keeps the floor scale and quantises to zeros.
    z = P.quantize_params_int8({"weight": torch.zeros(2, 4)}, scope=None)
    assert float(z["weight_scale"][0]) == pytest.approx(1e-12)
    assert not z["weight"].any()


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

def _linear_params(mode: str, bias: bool, d_in=48, d_out=40, seed=0):
    rng = np.random.default_rng(seed)
    p = {"weight": (rng.standard_normal((d_out, d_in), dtype=np.float32)
                    / np.float32(math.sqrt(d_in)))}
    if bias:
        p["bias"] = rng.standard_normal(d_out, dtype=np.float32)
    jp, pp = {"lin": _jp(p)}, {"lin": params_from_numpy(p, "cpu")}
    if mode != "float32":
        jp, pp = J.cast_params(jp), P.cast_params(pp)
    if mode == "int8":
        jp = J.quantize_params_int8(jp, scope=None)
        pp = P.quantize_params_int8(pp, scope=None)
    return jp["lin"], pp["lin"]


@pytest.mark.parametrize("shape", [(7, 48), (3, 5, 48)], ids=["2d", "3d"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_linear_matches_jax(mode, bias, shape):
    jp, pp = _linear_params(mode, bias)
    assert _dtype_name(pp["weight"]) == _dtype_name(jp["weight"]) == mode
    x = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    got = P.linear(pp, t(x))
    ref = J.linear(jp, jnp.asarray(x))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert got.shape == ref.shape
    scale = float(np.abs(n(ref)).max())
    np.testing.assert_allclose(n(got), n(ref), rtol=LINEAR_RTOL,
                               atol=LINEAR_RTOL * scale)
    if mode != "float32":
        # The input is rounded to bfloat16: a bfloat16 input gives the same.
        assert torch.equal(P.linear(pp, t(x).bfloat16()), got)
        # And the result is not rounded to bfloat16.
        assert not torch.equal(got.bfloat16().float(), got)


def test_gemm_route_and_dense_weight():
    assert P.gemm_route(torch.device("cpu")) == "widened"
    assert P.gemm_route(torch.device("cuda")) == (
        "mm_out_dtype" if P.MM_OUT_DTYPE else "widened")
    _, pp = _linear_params("int8", False)
    w = P.dense_weight(pp)
    assert w.dtype == torch.float32
    assert torch.equal(w, pp["weight"].float() * pp["weight_scale"][:, None])
    _, pb = _linear_params("bfloat16", False)
    assert torch.equal(P.dense_weight(pb), pb["weight"].float())


# ---------------------------------------------------------------------------
# Modules under cast and int8-all weights
# ---------------------------------------------------------------------------

MODES = ("bfloat16", "int8-all")


def _mode_params(tree, mode: str, layers_of=()):
    """(JAX tree, port tree) of a numpy tree in `mode`; the subtrees named
    in `layers_of` are layer-stacked and become per-layer lists in the
    port."""
    jp = J.cast_params(_jp(tree))
    pp = params_from_numpy(tree, "cpu")
    for part in layers_of:
        pp[part]["layers"] = unstack_layers(pp[part]["layers"])
    pp = P.cast_params(pp)
    if mode == "int8-all":
        jp = J.quantize_params_int8(jp, scope=None)
        pp = P.quantize_params_int8(pp, scope=None)
    return jp, pp


def _jax_layer(jtree, i: int = 0):
    return jax.tree.map(lambda a: a[i], jtree)


@pytest.mark.parametrize("input_layer", ["conv2d", "conv2d6", "linear"])
def test_conv2d_subsample_matches_jax_under_cast(input_layer):
    from speechcatcher_tpu.models.encoder import conv2d_subsample as j_sub
    from speechcatcher_tpu_torch.models.encoder import (
        conv2d_subsample as p_sub,
    )

    cfg = tiny_config(input_layer=input_layer)
    tree = random_params(cfg, 4)
    jp, pp = _mode_params(tree, "bfloat16", ("encoder", "decoder"))
    x = np.random.default_rng(2).standard_normal((2, 37, 80), np.float32)
    got = p_sub(pp["encoder"]["embed"], t(x), input_layer)
    ref = j_sub(jp["encoder"]["embed"], jnp.asarray(x), input_layer)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(n(got), n(ref), **TOL)
    # The cast is live: float32 weights give another output.
    f32 = p_sub(params_from_numpy(tree, "cpu")["encoder"]["embed"], t(x),
                input_layer)
    assert not np.allclose(n(f32), n(got), atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_conformer_modules_match_jax(mode):
    """conv_module (float32 activations × widened bfloat16 weights, never
    quantised) and rel_position_attention on the kernel route and the
    plain route."""
    from speechcatcher_tpu.models.encoder import block_attention_mask
    from speechcatcher_tpu.ops.conformer import (
        conv_module as j_conv,
        rel_position_attention as j_attn,
    )
    from speechcatcher_tpu_torch.ops.conformer import (
        conv_module as p_conv,
        rel_position_attention as p_attn,
    )

    d, h, w = 16, 2, 10
    cfg = conformer_config(encoder_dim=d, encoder_heads=h)
    tree = _perturb(random_params(cfg, 3), 3)
    jp, pp = _mode_params(tree, mode, ("encoder", "decoder"))
    jl, tl = _jax_layer(jp["encoder"]["layers"]), pp["encoder"]["layers"][0]
    assert tl["conv_module"]["depthwise_conv"]["weight"].dtype \
        == torch.bfloat16
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, w, d), np.float32)
    np.testing.assert_allclose(n(p_conv(tl["conv_module"], t(x))),
                               n(j_conv(jl["conv_module"], jnp.asarray(x))),
                               **TOL)
    pos = rng.standard_normal((1, w, d), np.float32)
    assert tl["self_attn"]["pos_bias_u"].dtype == torch.float32
    for mask in (block_attention_mask(w - 2), None):
        jm = None if mask is None else jnp.asarray(mask)
        pm = None if mask is None else t(mask)
        got = p_attn(tl["self_attn"], t(x), t(x), t(x), t(pos), pm, h)
        ref = j_attn(jl["self_attn"], jnp.asarray(x), jnp.asarray(x),
                     jnp.asarray(x), jnp.asarray(pos), jm, h)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(n(got), n(ref), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_multi_head_attention_matches_jax_and_feeds_the_kernel_float32(
        mode, monkeypatch):
    from speechcatcher_tpu.models.encoder import block_attention_mask

    cfg = tiny_config(encoder_dim=32, encoder_heads=4)
    jp, pp = _mode_params(random_params(cfg, 3), mode, ("encoder", "decoder"))
    jl, tl = _jax_layer(jp["encoder"]["layers"]), pp["encoder"]["layers"][0]
    seen = []
    kernel = P.block_attention

    def spy(q, k, v, mask):
        seen.append({a.dtype for a in (q, k, v, mask)})
        return kernel(q, k, v, mask)

    monkeypatch.setattr(P, "block_attention", spy)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 10, 32), dtype=np.float32)
    masks = [None, (rng.random((4, 10, 10)) < 0.7).astype(np.float32),
             block_attention_mask(8)]
    for m in masks:
        got = P.multi_head_attention(tl["self_attn"], t(x), t(x), t(x),
                                     None if m is None else t(m), 4)
        ref = J.multi_head_attention(jl["self_attn"], jnp.asarray(x),
                                     jnp.asarray(x), jnp.asarray(x),
                                     None if m is None else jnp.asarray(m), 4)
        np.testing.assert_allclose(n(got), n(ref), **TOL)
    np.testing.assert_allclose(
        n(P.feed_forward(tl["feed_forward"], t(x))),
        n(J.feed_forward(jl["feed_forward"], jnp.asarray(x))), **TOL)
    # Kernel A gets float32 operands in every mode.
    assert seen == [{torch.float32}]


def test_rel_block_attention_gets_float32_operands_in_every_mode(monkeypatch):
    import speechcatcher_tpu_torch.ops.conformer as PC
    from speechcatcher_tpu.models.encoder import block_attention_mask

    d, h, w = 16, 2, 10
    cfg = conformer_config(encoder_dim=d, encoder_heads=h)
    x = np.random.default_rng(5).standard_normal((2, w, d), np.float32)
    seen = []
    kernel = PC.rel_block_attention

    def spy(*args):
        seen.append({a.dtype for a in args})
        return kernel(*args)

    monkeypatch.setattr(PC, "rel_block_attention", spy)
    for mode in MODES:
        _, pp = _mode_params(random_params(cfg, 3), mode,
                             ("encoder", "decoder"))
        PC.rel_position_attention(
            pp["encoder"]["layers"][0]["self_attn"], t(x), t(x), t(x),
            t(x[:1]), t(block_attention_mask(w - 2)), h)
    assert seen == [{torch.float32}] * len(MODES)


def _cross_operands(seed=7, s=2, b=3, tm=11, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s * b, d), dtype=np.float32)
    mk = rng.standard_normal((s, tm, d), dtype=np.float32)
    mv = rng.standard_normal((s, tm, d), dtype=np.float32)
    valid = np.arange(tm)[None, :] < np.array([tm, 6])[:, None]
    return q, mk, mv, valid


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_attend_cross_blocked_matches_jax(kv_dtype):
    """With bfloat16 K/V the query is rounded to bfloat16 before the score
    contraction and the attention weights before the value contraction.
    Unit-scale operands: a float32 query against bfloat16 keys differs from
    the rounded one by about 1e-2, a hundred times the tolerance. The port
    takes its K/V head-major (``head_major``), JAX as (S, T, d) rows."""
    from speechcatcher_tpu.models.decoder import (
        _attend_cross_blocked as j_cross,
    )
    from speechcatcher_tpu_torch.models.decoder import (
        cross_attention as p_cross,
        head_major,
    )

    q, mk, mv, valid = _cross_operands()
    jdt = jnp.bfloat16 if kv_dtype == "bfloat16" else jnp.float32
    pdt = torch.bfloat16 if kv_dtype == "bfloat16" else torch.float32
    ref = j_cross(jnp.asarray(q), jnp.asarray(mk).astype(jdt),
                  jnp.asarray(mv).astype(jdt), jnp.asarray(valid), 2)
    pk, pv = head_major(t(mk), 2, pdt), head_major(t(mv), 2, pdt)
    enc_len = t(valid.sum(axis=1))
    got = p_cross(t(q), pk, pv, enc_len)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(n(got), n(ref), **TOL)
    if kv_dtype == "bfloat16":
        unrounded = p_cross(t(q), pk.float(), pv.float(), enc_len)
        assert float((unrounded - got).abs().max()) > 1e-3


@pytest.mark.parametrize("mode", MODES)
def test_attend_cached_lane_matches_jax_with_a_bfloat16_cache(mode):
    from speechcatcher_tpu.models.decoder import (
        _attend_cached_lane as j_lane,
    )
    from speechcatcher_tpu_torch.models.decoder import (
        _attend_cached_lane as p_lane,
    )

    cfg = tiny_config()
    jp, pp = _mode_params(random_params(cfg, 6), mode, ("encoder", "decoder"))
    ja = _jax_layer(jp["decoder"]["layers"])["self_attn"]
    pa = pp["decoder"]["layers"][0]["self_attn"]
    s, beam, tc, d, h = 2, 3, 9, cfg.decoder_dim, cfg.decoder_heads
    rng = np.random.default_rng(8)
    q = rng.standard_normal((s * beam, d), dtype=np.float32)
    hn = rng.standard_normal((s * beam, d), dtype=np.float32)
    hh = rng.standard_normal((s * beam, tc, d), dtype=np.float32)
    lane = rng.integers(0, beam, size=(s, beam, tc)).astype(np.int32)
    pos = np.array([4, 4, 4, 7, 7, 7])
    hist = np.arange(tc)[None, :] < pos[:, None]
    onehot = jnp.moveaxis(jax.nn.one_hot(jnp.asarray(lane), beam,
                                         dtype=jnp.float32), 3, 2)
    ref = j_lane(jnp.asarray(q), jnp.asarray(hh).astype(jnp.bfloat16),
                 jnp.asarray(hn), ja, onehot, jnp.asarray(hist), beam, h)
    got = p_lane(t(q), t(hh).bfloat16(), t(hn), pa, t(lane), t(pos), h)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(ref), **TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_decoder_step_matches_jax_over_steps(mode, cache_dtype):
    from speechcatcher_tpu.models.decoder import (
        decoder_step as j_step,
        init_decoder_cache as j_cache,
    )
    from speechcatcher_tpu_torch.models.decoder import (
        decoder_step as p_step,
        init_decoder_cache as p_cache,
    )

    cfg = tiny_config(cache_dtype=cache_dtype)
    jcfg = jax_config(cfg)
    beam = 3
    tree = random_params(cfg, 6)
    jp, pp = _mode_params(tree, mode, ("encoder", "decoder"))
    model = ASRModel.from_numpy(cfg, tree, device="cpu")
    jpe = jnp.asarray(np.asarray(model.dec_pe))
    rng = np.random.default_rng(3)
    memory = rng.standard_normal((1, cfg.max_enc_frames, 16)).astype(
        np.float32)
    memory[0, 40:] = np.nan  # stale frames past enc_len must not leak
    enc_len = np.array([23], np.int32)
    lane = np.zeros((1, beam, cfg.max_tokens), np.int32)
    jc, pc = j_cache(jcfg, beam), p_cache(cfg, beam, torch.device("cpu"))
    assert _dtype_name(pc.h) == _dtype_name(jc.h) == cache_dtype
    for step in range(5):
        tokens = rng.integers(0, cfg.vocab_size, size=beam).astype(np.int32)
        pos = np.full(beam, step, np.int32)
        write = np.array([True, True, step % 2 == 0])
        jl, jc = j_step(jp["decoder"], jpe, jc, jnp.asarray(memory),
                        jnp.asarray(tokens), jnp.asarray(pos),
                        jnp.asarray(enc_len), jnp.asarray(lane),
                        jnp.asarray(write), jcfg, beam)
        pl, pc = p_step(pp["decoder"], model.dec_pe, pc, t(memory),
                        t(tokens), t(pos), t(enc_len), t(lane), t(write),
                        cfg, beam)
        assert pl.dtype == torch.float32
        np.testing.assert_allclose(n(pl), n(jl), **TOL)
        # The stored rows: within one ulp of the storage dtype.
        ref_h = _f32(jc.h)
        step_tol = (BF16_ULP * np.abs(ref_h) + 1e-6
                    if cache_dtype == "bfloat16" else 1e-4)
        assert bool((np.abs(_f32(pc.h) - ref_h) <= step_tol).all())
        src = rng.integers(0, beam, size=beam)
        lane = lane[:, src]
        lane[0, :, step] = src


@pytest.mark.parametrize("frames_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_ctc_log_softmax_matches_jax(mode, frames_dtype):
    from speechcatcher_tpu.models.ctc import ctc_log_softmax as j_ctc
    from speechcatcher_tpu_torch.models.ctc import ctc_log_softmax as p_ctc

    cfg = tiny_config()
    jp, pp = _mode_params(random_params(cfg, 2), mode, ("encoder", "decoder"))
    hs = np.random.default_rng(1).standard_normal((2, 9, cfg.encoder_dim),
                                                  dtype=np.float32)
    jhs, phs = jnp.asarray(hs), t(hs)
    if frames_dtype == "bfloat16":   # frames out of a bfloat16 ring
        jhs, phs = jhs.astype(jnp.bfloat16), phs.bfloat16()
    got, ref = p_ctc(pp["ctc"], phs), j_ctc(jp["ctc"], jhs)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(n(got), n(ref), **TOL)


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

# (config, encoder, dtype=, cfg overrides, seed)
SESSION_CASES = [
    (name, "transformer", dtype, {}, seed)
    for name, seed in (("tiny", 3), ("w42", 4))
    for dtype in ("bfloat16", "float16", "int8", "int8-all")
] + [
    (name, "transformer", "float32", {key: "bfloat16"}, seed)
    for name, seed in (("tiny", 3), ("w42", 4))
    for key in ("ctc_ring_dtype", "cache_dtype")
] + [
    ("tiny", "conformer", "bfloat16", {}, 5),
    ("tiny", "conformer", "int8-all", {}, 5),
]


def _session_id(case):
    name, enc, dtype, overrides, _ = case
    return "-".join([name, enc, dtype] + list(overrides))


@pytest.mark.parametrize("case", SESSION_CASES,
                         ids=[_session_id(c) for c in SESSION_CASES])
def test_session_matches_jax_in_every_mode(case):
    """Tokens and positions of every partial and of the final equal the JAX
    session's; the final beam holds the same sequences with scores within
    rel. 1e-4. The dtype= modes change the model they are given."""
    name, enc, dtype, overrides, seed = case
    cfg = CONFIGS[name].replace(encoder_type=enc, **overrides)
    if enc == "conformer":
        cfg = cfg.replace(conformer_kernel_size=7)
    tree = bias_outputs(random_params(cfg, seed), cfg, 4.0, 3.0)
    jm = jax_model(cfg, copy.deepcopy(tree))
    pm = ASRModel.from_numpy(cfg, tree, device="cpu")
    js = JaxSession(model=jm, beam_size=3, dtype=dtype)
    ps = Speech2TextStreaming(model=pm, beam_size=3, device="cpu",
                              dtype=dtype)
    if dtype != "float32":
        assert ps.cfg.cache_dtype == pm.cfg.cache_dtype == "bfloat16"
        assert ps.model is pm
        _assert_trees_equal(pm.params, jm.params)
        assert ps.beam_search.state.dec_cache.h.dtype == torch.bfloat16
    ring = ps.beam_search.state.arrays.ctc.logp
    assert _dtype_name(ring) == cfg.ctc_ring_dtype
    chunks = _inputs("pcm_chunks", synth_audio(3.0, seed), pm.frontend)
    j_out, j_nbest = _run(js, chunks)
    p_out, p_nbest = _run(ps, chunks)
    assert p_out == j_out
    assert len(j_nbest[0][0]) > 2  # the decode emitted something
    for (jy, jx, jsc), (py, px, psc) in zip(j_nbest, p_nbest):
        np.testing.assert_array_equal(py, jy)
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_allclose(psc, jsc, rtol=1e-4)


def test_session_rejects_an_unknown_dtype():
    pm = ASRModel.random_init(tiny_config(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        Speech2TextStreaming(model=pm, dtype="float64", device="cpu")
    assert pm.params["ctc"]["ctc_lo"]["weight"].dtype == torch.float32
