"""Kernels A (block_attention) and E (rel_block_attention) on the CPU: the
launch plans for contiguous, projection-strided and refused signatures, the
plan cache, the CPU route's refusals, and the attention modules, which hand
the kernels the transposed views of their projections, against the JAX
functions with the Pallas kernels in interpret mode.

Tolerance against JAX: 1e-5 absolute at unit-scale inputs (float32 on both
sides, sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import n, t

from speechcatcher_tpu.models.encoder import block_attention_mask
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.ops.kernels import block_attention as a_mod
from speechcatcher_tpu_torch.ops.kernels import rel_attention as e_mod
from speechcatcher_tpu_torch.ops.kernels.block_attention import (
    MAX_W,
    SMEM_LIMIT,
    _smem_floats,
    attention_plan,
    block_attention,
)
from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
    rel_block_attention,
)
from speechcatcher_tpu_torch.params import (
    params_from_numpy,
    random_params,
    unstack_layers,
)


def _projected(lead, w, h, dk):
    """The (lead, H, W, dk) view mha_project makes of a (lead, W, H*dk)
    projection."""
    return torch.zeros(lead, w, h * dk).reshape(
        lead, w, h, dk).transpose(1, 2)


def _operands(rel, n_blk=3, h=8, w=42, dk=64, projected=False):
    make = _projected if projected else (
        lambda lead, w, h, dk: torch.zeros(lead, h, w, dk))
    args = [make(n_blk, w, h, dk) for _ in range(3)]
    args.append(torch.zeros(w, w))
    if rel:
        args += [make(1, w, h, dk)[0], torch.zeros(h, dk), torch.zeros(h, dk)]
    return args


def _plan(rel, *args):
    return attention_plan("rel_block_attention" if rel else "block_attention",
                          *args)


@pytest.mark.parametrize("rel", [False, True], ids=["block", "rel"])
def test_attention_plan_contiguous(rel):
    """Two flagship windows: 6 tiles of 7 rows, 16-byte loads, K rows 68
    floats apart."""
    p = _plan(rel, *_operands(rel, n_blk=2))
    for name in "qkv":
        assert [getattr(p, f"{name}_s{d}") for d in "nhw"] == [
            8 * 42 * 64, 42 * 64, 64]
    assert (p.n, p.h, p.w, p.dk, p.warps, p.rpw, p.tiles, p.vec) == (
        2, 8, 42, 64, 7, 1, 6, 1)
    floats = 42 * 68 + 42 * 64 + 7 * 64
    scalar = 42 * 65 + 42 * 64 + 7 * 64
    if rel:
        floats += 42 * 68 + 8 * 64 + 8 * 42
        scalar += 42 * 65 + 8 * 64 + 8 * 42
        assert (p.pos_sh, p.pos_sw, p.bu_sh, p.bv_sh) == (42 * 64, 64, 64, 64)
    else:
        assert (p.pos_sh, p.pos_sw, p.bu_sh, p.bv_sh) == (0, 0, 0, 0)
    assert (p.smem_vec, p.smem_scalar) == (4 * floats, 4 * scalar)
    assert p.smem_vec == 4 * _smem_floats(rel, True, 42, 64, 7)
    assert p.scale == np.float32(8.0)


@pytest.mark.parametrize("rel", [False, True], ids=["block", "rel"])
def test_attention_plan_projection_strided(rel):
    """The transposed views of (N, W, H*dk) projections: element (n, h, w, c)
    at n*W*d + w*d + h*dk + c, still on the 16-byte route."""
    p = _plan(rel, *_operands(rel, projected=True))
    for name in "qkv":
        assert [getattr(p, f"{name}_s{d}") for d in "nhw"] == [
            42 * 512, 64, 512]
    assert p.vec == 1
    if rel:
        assert (p.pos_sh, p.pos_sw) == (64, 512)


@pytest.mark.parametrize("n_blk,h,w,dk,warps,rpw,tiles,vec", [
    (5, 2, 6, 4, 6, 1, 1, 1),
    (11, 2, 7, 8, 7, 1, 1, 1),
    (7, 2, 10, 16, 5, 1, 2, 1),
    (7, 2, 10, 6, 5, 1, 2, 0),      # dk not a multiple of 4
    (1, 1, 128, 5, 8, 1, 16, 0),    # the widest window; n = h = 1: strides 0
    (2, 8, 42, 64, 7, 1, 6, 1),     # 96 blocks: an SM each
    (3, 8, 42, 64, 7, 2, 3, 1),     # 144 would not have: two rows a warp
    (16, 8, 42, 64, 7, 2, 3, 1),    # the engine: 384 blocks of 14 rows
    (40, 8, 7, 8, 4, 2, 1, 1),      # the last warp has one row
    (66, 2, 7, 8, 7, 1, 1, 1),      # 132 blocks
])
def test_attention_plan_tilings(n_blk, h, w, dk, warps, rpw, tiles, vec):
    p = _plan(True, *_operands(True, n_blk, h, w, dk))
    assert (p.warps, p.rpw, p.tiles, p.vec) == (warps, rpw, tiles, vec)
    rows = warps * rpw
    assert rows * p.tiles >= w > rows * (p.tiles - 1)
    assert p.smem_vec == (4 * _smem_floats(True, True, w, dk, rows)
                          if vec else 0)
    assert p.smem_scalar == 4 * _smem_floats(True, False, w, dk, rows)
    if n_blk == 1:
        assert (p.q_sn, p.q_sh, p.pos_sh, p.bu_sh) == (0, 0, 0, 0)


def test_attention_plan_scalar_route_for_odd_strides():
    """Rows that do not start on multiples of four floats rule 16-byte
    loads out in the plan; the pointers are the C entry point's to check."""
    q, k, v, mask = _operands(False, 2, 2, 6, 8)
    wide = torch.zeros(2, 2, 6, 9)[..., :8]          # row stride 9
    assert _plan(False, wide, k, v, mask).vec == 0
    assert _plan(False, q, k, wide, mask).vec == 0
    args = _operands(True, 2, 2, 6, 8)
    args[4] = torch.zeros(2, 6, 9)[..., :8]          # pos
    assert _plan(True, *args).vec == 0
    args = _operands(True, 2, 2, 6, 8)
    args[5] = torch.zeros(2, 9)[:, :8]               # a bias: scalar reads
    p = _plan(True, *args)
    assert (p.vec, p.bu_sh, p.bv_sh) == (1, 9, 8)


def _zeros(*shape, **kw):
    return lambda: torch.zeros(*shape, **kw)


# name -> (rel, {operand index: maker}, error). Operands: q, k, v, mask,
# pos, bias_u, bias_v at (2, 2, 6, 8). The plans run before the CPU/CUDA
# branch, so both routes refuse alike.
_REFUSALS = {
    "q_inner_stride": (False, {0: lambda: torch.zeros(2, 2, 6, 16)[..., ::2]},
                       ValueError),
    "v_inner_stride": (True, {2: lambda: torch.zeros(2, 2, 8, 6).transpose(
        2, 3)}, ValueError),
    "pos_inner_stride": (True, {4: lambda: torch.zeros(2, 6, 16)[..., ::2]},
                         ValueError),
    "bias_inner_stride": (True, {6: lambda: torch.zeros(2, 16)[:, ::2]},
                          ValueError),
    "mask_not_contiguous": (False, {3: lambda: torch.zeros(6, 12)[:, ::2]},
                            ValueError),
    "q_float64": (False, {0: _zeros(2, 2, 6, 8, dtype=torch.float64)},
                  TypeError),
    "k_bfloat16": (True, {1: _zeros(2, 2, 6, 8, dtype=torch.bfloat16)},
                   TypeError),
    "mask_bool": (False, {3: _zeros(6, 6, dtype=torch.bool)}, TypeError),
    "pos_float16": (True, {4: _zeros(2, 6, 8, dtype=torch.float16)},
                    TypeError),
    "bias_float64": (True, {5: _zeros(2, 8, dtype=torch.float64)}, TypeError),
    "k_shape": (False, {1: _zeros(2, 2, 7, 8)}, ValueError),
    "v_shape": (True, {2: _zeros(3, 2, 6, 8)}, ValueError),
    "q_three_dims": (False, {i: _zeros(2, 6, 8) for i in range(3)},
                     ValueError),
    "mask_shape": (False, {3: _zeros(6, 5)}, ValueError),
    "pos_shape": (True, {4: _zeros(2, 6, 5)}, ValueError),
    "pos_batched": (True, {4: _zeros(1, 2, 6, 8)}, ValueError),
    "bias_u_shape": (True, {5: _zeros(2, 4)}, ValueError),
    "bias_v_shape": (True, {6: _zeros(8)}, ValueError),
    "no_heads": (False, {i: _zeros(2, 0, 6, 8) for i in range(3)},
                 ValueError),
    "mask_on_meta": (False, {3: _zeros(6, 6, device="meta")}, ValueError),
    "pos_on_meta": (True, {4: _zeros(2, 6, 8, device="meta")}, ValueError),
    "all_on_meta": (False, {0: _zeros(2, 2, 6, 8, device="meta"),
                            1: _zeros(2, 2, 6, 8, device="meta"),
                            2: _zeros(2, 2, 6, 8, device="meta"),
                            3: _zeros(6, 6, device="meta")}, ValueError),
    "window_too_wide": (False, {0: _zeros(1, 1, MAX_W + 1, 4),
                                1: _zeros(1, 1, MAX_W + 1, 4),
                                2: _zeros(1, 1, MAX_W + 1, 4),
                                3: _zeros(MAX_W + 1, MAX_W + 1)}, ValueError),
    "too_much_shared_memory": (True, {0: _zeros(1, 1, 128, 400),
                                      1: _zeros(1, 1, 128, 400),
                                      2: _zeros(1, 1, 128, 400),
                                      3: _zeros(128, 128),
                                      4: _zeros(1, 128, 400),
                                      5: _zeros(1, 400), 6: _zeros(1, 400)},
                               ValueError),
}


def _refusal_args(case):
    rel, swaps, error = _REFUSALS[case]
    args = _operands(True, 2, 2, 6, 8)
    for i, make in swaps.items():
        args[i] = make()
    return rel, (args if rel else args[:4]), error


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_attention_plans_refuse(case):
    rel, args, error = _refusal_args(case)
    with pytest.raises(error):
        _plan(rel, *args)


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_attention_cpu_route_refuses(case):
    """The CPU route refuses what the card refuses: the wrapper plans before
    it branches."""
    rel, args, error = _refusal_args(case)
    with pytest.raises(error):
        if rel:
            q, k, v, mask, pos, bias_u, bias_v = args
            rel_block_attention(q, k, v, pos, bias_u, bias_v, mask)
        else:
            block_attention(*args)


def test_shared_memory_limit_is_hoppers():
    """A plan just under the limit passes; the sizes are the kernel's."""
    assert SMEM_LIMIT == 232448
    w, dk = 128, 136
    assert 4 * _smem_floats(True, True, w, dk, 8) <= SMEM_LIMIT
    p = _plan(True, *_operands(True, 1, 1, w, dk))
    assert max(p.smem_vec, p.smem_scalar) <= SMEM_LIMIT


@pytest.mark.parametrize("rel", [False, True], ids=["block", "rel"])
def test_attention_plan_cache(rel):
    """One plan per input signature; on the CPU it carries no entry point;
    other strides plan anew."""
    mod = e_mod if rel else a_mod
    kernel = rel_block_attention if rel else block_attention
    mod._PLANS.clear()

    def call(projected):
        q, k, v, mask, *rest = _operands(rel, 2, 2, 6, 8, projected=projected)
        return kernel(q, k, v, *rest, mask)

    call(False)
    (plan,) = mod._PLANS.values()
    assert plan.fn is None and plan.out_shape == (2, 6, 2, 8)
    call(False)
    assert list(mod._PLANS.values()) == [plan]
    call(True)
    assert len(mod._PLANS) == 2


def _pallas_in_interpret_mode(monkeypatch):
    """Make the JAX attention modules take their Pallas kernels, in
    interpret mode, as on the TPU."""
    import speechcatcher_tpu.ops.pallas.block_attention as ja
    import speechcatcher_tpu.ops.pallas.rel_attention as je

    monkeypatch.setattr(ja, "use_pallas", lambda: True)
    monkeypatch.setattr(ja, "block_attention", functools.partial(
        ja.block_attention, interpret=True))
    monkeypatch.setattr(je, "rel_block_attention", functools.partial(
        je.rel_block_attention, interpret=True))


def _spy(monkeypatch, mod, name):
    """Record the operands the wrapper hands its plain version."""
    seen = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a: seen.append(a) or real(*a))
    return seen


def _layer0(cfg, seed):
    enc = random_params(cfg, seed)["encoder"]
    rng = np.random.default_rng(seed)
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        b = enc["layers"]["self_attn"][name]["bias"]
        b[...] = rng.uniform(-0.1, 0.1, size=b.shape).astype(np.float32)
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), enc["layers"])
    tl = unstack_layers(params_from_numpy(enc["layers"], "cpu"))[0]
    return jl["self_attn"], tl["self_attn"]


@pytest.mark.parametrize("b,w,d,h", [(3, 42, 64, 4), (5, 10, 32, 4),
                                     (2, 7, 24, 4)])
def test_multi_head_attention_strided_matches_jax(monkeypatch, b, w, d, h):
    """The port hands kernel A the projections' transposed views (no copy)
    and equals JAX's multi_head_attention through its Pallas kernel."""
    from speechcatcher_tpu.ops.layers import multi_head_attention as j_mha
    from speechcatcher_tpu_torch.ops.layers import (
        multi_head_attention as p_mha,
    )

    _pallas_in_interpret_mode(monkeypatch)
    seen = _spy(monkeypatch, a_mod, "block_attention_plain")
    jp, tp = _layer0(tiny_config(encoder_dim=d, encoder_heads=h), seed=w)
    x = np.random.default_rng(w).standard_normal((b, w, d), dtype=np.float32)
    mask = block_attention_mask(w - 2)
    ref = j_mha(jp, *(jnp.asarray(x),) * 3, jnp.asarray(mask), h)
    got = p_mha(tp, *(t(x),) * 3, t(mask), h)
    np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-5)
    (args,) = seen
    dk = d // h
    for a in args[:3]:
        assert a.shape == (b, h, w, dk)
        assert a.stride() == (w * d, dk, d, 1) and not a.is_contiguous()


@pytest.mark.parametrize("b,w,d,h", [(3, 42, 64, 4), (5, 10, 32, 4),
                                     (2, 7, 24, 4)])
def test_rel_position_attention_strided_matches_jax(monkeypatch, b, w, d, h):
    """The port hands kernel E the transposed views of q, k, v and of the
    position projection and equals JAX's rel_position_attention through its
    Pallas kernel."""
    from speechcatcher_tpu.ops.conformer import (
        rel_position_attention as j_attn,
    )
    from speechcatcher_tpu_torch.ops.conformer import (
        rel_position_attention as p_attn,
    )

    _pallas_in_interpret_mode(monkeypatch)
    seen = _spy(monkeypatch, e_mod, "rel_block_attention_plain")
    cfg = tiny_config(encoder_type="conformer", conformer_kernel_size=7,
                      encoder_dim=d, encoder_heads=h)
    jp, tp = _layer0(cfg, seed=w + 1)
    rng = np.random.default_rng(w + 1)
    x = rng.standard_normal((b, w, d), dtype=np.float32)
    pos = rng.standard_normal((1, w, d), dtype=np.float32)
    mask = block_attention_mask(w - 2)
    ref = j_attn(jp, *(jnp.asarray(x),) * 3, jnp.asarray(pos),
                 jnp.asarray(mask), h)
    got = p_attn(tp, *(t(x),) * 3, t(pos), t(mask), h)
    np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-5)
    (args,) = seen
    dk = d // h
    for a in args[:3]:
        assert a.stride() == (w * d, dk, d, 1) and not a.is_contiguous()
    assert args[3].shape == (h, w, dk) and args[3].stride() == (dk, d, 1)


@pytest.mark.parametrize("rel", [False, True], ids=["block", "rel"])
def test_card_result_layout_merges_as_a_view(rel):
    """What the card route returns, the transposed view of a contiguous
    (N, W, H, dk) tensor, is merged by the callers' transpose(1, 2).reshape
    without a copy (the same expression on the CPU route's contiguous
    (N, H, W, dk) result copies)."""
    mod = e_mod if rel else a_mod
    mod._PLANS.clear()
    kernel = rel_block_attention if rel else block_attention
    q, k, v, mask, *rest = _operands(rel, 3, 4, 10, 16)
    kernel(q, k, v, *rest, mask)
    (plan,) = mod._PLANS.values()
    out = torch.empty(plan.out_shape)
    x = out.transpose(1, 2)                      # what the wrapper returns
    assert x.shape == q.shape
    merged = x.transpose(1, 2).reshape(3, 10, 64)
    assert merged.data_ptr() == out.data_ptr() and merged.is_contiguous()
    cpu = kernel(q, k, v, *rest, mask)
    assert cpu.transpose(1, 2).reshape(3, 10, 64).data_ptr() != cpu.data_ptr()
