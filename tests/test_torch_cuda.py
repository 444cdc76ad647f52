"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc; elsewhere they skip. On the card
(where JAX, which tests/conftest.py imports, is not installed):
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``.
The tolerances are those of chip_smoke.py: A and E within 1e-5; B within
1e-4 + 1e-5·|ref| (its scan adds the same float32 terms in another order
than the plain version's frame-by-frame loop: about ten ulps where r reaches
a few thousand) and equal to the last bit on every frame outside
[start, end), and B on bfloat16 rows equal to the last bit to B on the same
rows widened to float32; C and D exact; F's normalised rows within 1e-5 of
the largest (only the order of its two float32 sums differs), its residual
sums and cache rows exact; G within 2e-6 of the largest |u| of its twin
evaluated in float64 and blind to rows at t >= pos; H within 1e-5 of the
largest output of its twin evaluated in float64 (with bfloat16 K/V, each
row also admits four weights rounded across a bfloat16 boundary) and blind
to K/V rows at t >= enc_len.
"""

import numpy as np
import pytest
import torch

from chip_smoke import cross_attention_error
from speechcatcher_tpu_torch.models.encoder import block_attention_mask
from speechcatcher_tpu_torch.ops.kernels.add_layer_norm import (
    add_layer_norm,
    add_layer_norm_plain,
)
from speechcatcher_tpu_torch.ops.kernels.block_attention import (
    BlockAttentionFn,
    block_attention,
    block_attention_plain,
)
from speechcatcher_tpu_torch.ops.kernels.ctc_recursion import (
    LOGZERO,
    ctc_forward_recursion,
    ctc_forward_recursion_plain,
    ctc_forward_recursion_streams,
    ctc_forward_recursion_streams_plain,
)
from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
    RelBlockAttentionFn,
    rel_block_attention,
    rel_block_attention_plain,
)
from speechcatcher_tpu_torch.ops.kernels import _build
from speechcatcher_tpu_torch.ops.kernels.cross_attention import (
    cross_attention,
)
from speechcatcher_tpu_torch.ops.kernels.lane_attention import (
    lane_attention,
    lane_attention_plain,
)
from speechcatcher_tpu_torch.ops.kernels.ring_append import (
    ring_append_cols,
    ring_append_cols_plain,
    ring_append_rows,
    ring_append_rows_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("n,h,w,dk", [(3, 8, 42, 64), (7, 2, 10, 16)])
def test_block_attention_kernel(dev, n, h, w, dk):
    rng = np.random.default_rng(w)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, h, w, dk),
                                                    dtype=np.float32)).to(dev)
               for _ in range(3))
    mask = torch.from_numpy(block_attention_mask(w - 2)).to(dev)
    before = block_attention.launches
    got = block_attention(q, k, v, mask)
    ref = block_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert block_attention.launches == before + 1
    assert float((got - ref).abs().max()) <= 1e-5
    assert bool((got[:, :, 0] == 0).all())
    with pytest.raises(ValueError):
        block_attention(q, k, v, mask.cpu())  # no silent fallback


def _recursion_close(got, ref, filled):
    """B's tolerance; `filled` marks the frames outside [start, end)."""
    torch.cuda.synchronize()
    assert bool(((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all())
    assert bool((got == ref)[filled.expand_as(got)].all())


def _reference_operands(dev, t_cap, n, seed=0):
    rng = np.random.default_rng(seed)
    xn, xb, phi = (np.log(rng.random((t_cap, n), dtype=np.float32) + 1e-3)
                   for _ in range(3))
    phi[0] = LOGZERO
    start = rng.integers(0, 10, size=n).astype(np.int32)
    end = rng.integers(5, t_cap + 1, size=n).astype(np.int32)
    end[0] = t_cap                                  # a full range
    end[-1] = start[-1] - 1 if n > 1 else end[-1]   # end before start
    olen0 = (rng.random(n) < 0.5).astype(np.float32)
    return [torch.from_numpy(a).to(dev)
            for a in (xn, xb, phi, start, end, olen0)]


def _stream_operands(dev, t_cap, s_dim, beam, seed=0,
                     ring_dtype=torch.float32):
    """The main path's form: xn gathered from a ring of `ring_dtype`, the
    blank row as an (S, 1, T) view, phi unshifted, int64 olen, int32
    enc_len, r_src."""
    rng = np.random.default_rng(seed)
    vocab = 6

    def logp(*shape):
        return torch.from_numpy(np.log(rng.random(
            shape, dtype=np.float32) + 1e-3)).to(dev)

    ring = logp(s_dim, vocab, t_cap).to(ring_dtype)
    token = torch.from_numpy(rng.integers(1, vocab, size=(s_dim, beam))
                             ).to(dev)
    xn = ring[torch.arange(s_dim, device=dev)[:, None], token, :]
    olen = rng.integers(0, 12, size=s_dim).astype(np.int64)
    enc_len = rng.integers(5, t_cap + 1, size=s_dim).astype(np.int32)
    olen[0], enc_len[0] = 0, t_cap                  # no token yet, full ring
    if s_dim > 1:
        olen[-1], enc_len[-1] = 9, 4                # end before start
    return [xn, ring[:, None, 0, :], logp(s_dim, beam, t_cap) * 3,
            torch.from_numpy(olen).to(dev), torch.from_numpy(enc_len).to(dev),
            logp(s_dim, beam, 2, t_cap) * 50]


def test_ctc_recursion_kernel(dev):
    t_cap, n = 200, 37
    args = _reference_operands(dev, t_cap, n)
    before = ctc_forward_recursion.launches
    got = ctc_forward_recursion(*args)
    ref = ctc_forward_recursion_plain(*args)
    assert ctc_forward_recursion.launches == before + 1
    t_idx = torch.arange(t_cap, device=dev)[:, None]
    _recursion_close(got, ref,
                     ((t_idx < args[3][None]) | (t_idx >= args[4][None]))[None])


@pytest.mark.parametrize("t_cap", [200, 768, 203])
@pytest.mark.parametrize("s_dim,beam", [(1, 1), (1, 5), (37, 1), (32, 5)])
@pytest.mark.parametrize("form", ["reference", "reference_time_minor",
                                  "streams", "streams_expanded",
                                  "streams_offset"])
def test_ctc_recursion_forms(dev, form, s_dim, beam, t_cap):
    """B in both forms at 1, 5, 37 and 160 hypotheses: one launch, within
    the tolerance, fills exact; T = 203 and a row that starts 4 bytes past
    a 16-byte boundary take the scalar loads."""
    n = s_dim * beam
    t_idx = torch.arange(t_cap, device=dev)
    before = ctc_forward_recursion.launches
    if form.startswith("reference"):
        args = _reference_operands(dev, t_cap, n, seed=n + t_cap)
        if form == "reference_time_minor":
            args[:3] = [a.t().contiguous().t() for a in args[:3]]
        got = ctc_forward_recursion(*args)
        ref = ctc_forward_recursion_plain(*args)
        filled = ((t_idx[:, None] < args[3][None])
                  | (t_idx[:, None] >= args[4][None]))[None]
        assert got.shape == (2, t_cap, n)
    else:
        args = _stream_operands(dev, t_cap, s_dim, beam, seed=n + t_cap)
        if form == "streams_expanded":
            args[1] = args[1].expand(s_dim, beam, t_cap)
        elif form == "streams_offset":
            flat = torch.zeros(args[0].numel() + 1, device=dev)
            flat[1:] = args[0].reshape(-1)
            args[0] = flat[1:].reshape(s_dim, beam, t_cap)
        got = ctc_forward_recursion_streams(*args)
        ref = ctc_forward_recursion_streams_plain(*args)
        begin = args[3].clamp(min=1, max=t_cap)
        filled = ((t_idx[None, :] < begin[:, None])
                  | (t_idx[None, :] >= args[4][:, None]))[:, None, None, :]
        assert got.shape == (s_dim, beam, 2, t_cap)
    assert got.is_contiguous()
    assert ctc_forward_recursion.launches == before + 1
    _recursion_close(got, ref, filled)


@pytest.mark.parametrize("t_cap", [200, 768, 203, 204])
@pytest.mark.parametrize("s_dim,beam", [(1, 5), (8, 5), (32, 5), (37, 1)])
@pytest.mark.parametrize("form", ["reference", "reference_time_minor",
                                  "streams", "streams_expanded",
                                  "streams_offset"])
def test_ctc_recursion_bfloat16_rows(dev, form, s_dim, beam, t_cap):
    """B on bfloat16 log-prob rows (gathered from a bfloat16 ring, the blank
    row a view of it) equals B on the same rows widened to float32 to the
    last bit, and is within the tolerance of the plain version. T = 768 and
    200 take eight values a 16-byte load; T = 204 (rows start on four
    values, not eight), T = 203 and a row that starts 2 bytes past a
    16-byte boundary take the scalar loads."""
    n = s_dim * beam
    t_idx = torch.arange(t_cap, device=dev)
    before = ctc_forward_recursion.launches
    if form.startswith("reference"):
        args = _reference_operands(dev, t_cap, n, seed=n + t_cap)
        args[:2] = [a.bfloat16() for a in args[:2]]
        if form == "reference_time_minor":
            args[:3] = [a.t().contiguous().t() for a in args[:3]]
        kernel, plain = ctc_forward_recursion, ctc_forward_recursion_plain
        filled = ((t_idx[:, None] < args[3][None])
                  | (t_idx[:, None] >= args[4][None]))[None]
    else:
        args = _stream_operands(dev, t_cap, s_dim, beam, seed=n + t_cap,
                                ring_dtype=torch.bfloat16)
        if form == "streams_expanded":
            args[1] = args[1].expand(s_dim, beam, t_cap)
        elif form == "streams_offset":
            flat = torch.zeros(args[0].numel() + 1, device=dev,
                               dtype=torch.bfloat16)
            flat[1:] = args[0].reshape(-1)
            args[0] = flat[1:].reshape(s_dim, beam, t_cap)
        kernel = ctc_forward_recursion_streams
        plain = ctc_forward_recursion_streams_plain
        begin = args[3].clamp(min=1, max=t_cap)
        filled = ((t_idx[None, :] < begin[:, None])
                  | (t_idx[None, :] >= args[4][:, None]))[:, None, None, :]
    assert args[0].dtype == args[1].dtype == torch.bfloat16
    got = kernel(*args)
    widened = kernel(args[0].float(), args[1].float(), *args[2:])
    assert ctc_forward_recursion.launches == before + 2
    assert got.dtype == torch.float32 and got.is_contiguous()
    torch.cuda.synchronize()
    assert torch.equal(got, widened)
    _recursion_close(got, plain(*args), filled)


@pytest.mark.parametrize("form", ["reference", "streams"])
def test_ctc_recursion_refuses_on_the_card(dev, form):
    """No silent fallback: what the plan refuses raises on CUDA tensors."""
    if form == "reference":
        args = _reference_operands(dev, 16, 3)
        with pytest.raises(TypeError):      # int64 start
            ctc_forward_recursion(*args[:3], args[3].long(), *args[4:])
        with pytest.raises(TypeError):      # float64 xn
            ctc_forward_recursion(args[0].double(), *args[1:])
        with pytest.raises(TypeError):      # bfloat16 xn beside float32 xb
            ctc_forward_recursion(args[0].bfloat16(), *args[1:])
        with pytest.raises(TypeError):      # float16 rows
            ctc_forward_recursion(args[0].half(), args[1].half(), *args[2:])
        with pytest.raises(ValueError):     # mixed devices
            ctc_forward_recursion(*args[:5], args[5].cpu())
    else:
        args = _stream_operands(dev, 16, 2, 3)
        with pytest.raises(ValueError):     # inner stride 2
            ctc_forward_recursion_streams(
                torch.zeros((2, 3, 32), device=dev)[:, :, ::2], *args[1:])
        with pytest.raises(ValueError):     # a row expanded along time
            ctc_forward_recursion_streams(
                *args[:2], torch.zeros((2, 3, 1), device=dev).expand(2, 3, 16),
                *args[3:])
        with pytest.raises(TypeError):      # bfloat16 phi
            ctc_forward_recursion_streams(*args[:2], args[2].bfloat16(),
                                          *args[3:])
        with pytest.raises(TypeError):      # float olen
            ctc_forward_recursion_streams(*args[:3], args[3].float(),
                                          *args[4:])
        with pytest.raises(ValueError):     # mixed devices
            ctc_forward_recursion_streams(*args[:5], args[5].cpu())


@pytest.mark.parametrize("form", ["reference", "streams"])
def test_ctc_recursion_stream_and_graph(dev, form):
    """The launch goes to PyTorch's current stream (a side stream, a CUDA
    graph's capture stream), so B can be captured and replayed."""
    if form == "reference":
        kernel, plain = ctc_forward_recursion, ctc_forward_recursion_plain
        args = _reference_operands(dev, 768, 5, seed=3)
    else:
        kernel = ctc_forward_recursion_streams
        plain = ctc_forward_recursion_streams_plain
        args = _stream_operands(dev, 768, 2, 5, seed=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert _build.stream_ptr(args[0]) == side.cuda_stream
        warm = kernel(*args)                         # plan and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(*args)
    torch.cuda.synchronize()
    args[0].copy_(args[0] - 0.5)                     # same storage, new data
    graph.replay()
    torch.cuda.synchronize()
    ref = plain(*args)
    assert bool(((out - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all())
    assert float((out - warm).abs().max()) > 1e-3    # the replay recomputed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_append_kernel(dev, dtype):
    rng = np.random.default_rng(1)
    s, v, t_cap, tn = 4, 33, 100, 12
    ring = torch.from_numpy(rng.standard_normal((s, v, t_cap),
                                                dtype=np.float32)).to(dev, dtype)
    new = torch.from_numpy(rng.standard_normal((s, v, tn),
                                               dtype=np.float32)).to(dev, dtype)
    start = torch.tensor([0, t_cap - 5, 50, 120], dtype=torch.int32,
                         device=dev)
    n_new = torch.tensor([tn, tn, 0, tn + 3], dtype=torch.int32, device=dev)
    got = ring_append_cols(ring.clone(), new, start, n_new)
    ref = ring_append_cols_plain(ring.clone(), new, start, n_new)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l_dim,t_cap,d,tn", [
    (1, 832, 512, 40),   # flagship enc_out: 16-byte units
    (2, 70, 80, 54),     # raw carry (80 mels), two layers
    (1, 33, 7, 5),       # odd rows: 4-byte (f32) or 2-byte (bf16) units
])
def test_ring_append_rows_kernel(dev, dtype, l_dim, t_cap, d, tn):
    rng = np.random.default_rng(t_cap)
    s = 6
    cache = torch.from_numpy(rng.standard_normal(
        (l_dim, s, t_cap, d), dtype=np.float32)).to(dev, dtype)
    new = torch.from_numpy(rng.standard_normal(
        (l_dim, s, tn, d), dtype=np.float32)).to(dev, dtype)
    start = torch.tensor([0, t_cap - tn, 3, t_cap - 2, t_cap + 9, 1],
                         dtype=torch.int32, device=dev)
    n_new = torch.tensor([tn, tn, 0, tn, 2, tn + 3], dtype=torch.int32,
                         device=dev)
    before = ring_append_rows.launches
    got = ring_append_rows(cache.clone(), new, start, n_new)
    ref = ring_append_rows_plain(cache.clone(), new, start, n_new)
    torch.cuda.synchronize()
    assert ring_append_rows.launches == before + 1
    assert torch.equal(got, ref)
    with pytest.raises(TypeError):  # only float32 is cast on the way in
        ring_append_rows(cache, new.half() if dtype != torch.float32
                         else new.double(), start, n_new)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,v,t_cap,tn", [
    (1, 1024, 768, 16),   # flagship session: one block's frames
    (8, 1024, 768, 40),   # flagship engine: EXTCAP = block_size
    (3, 37, 50, 7),       # ragged tiles, a narrow TI
])
def test_ring_append_cols_time_major(dev, dtype, s, v, t_cap, tn):
    """The main path's form: the transposed view of time-major (S, TN, V)
    float32 log-probs, into float32 and bfloat16 rings, one launch."""
    rng = np.random.default_rng(v + tn)
    ring = torch.from_numpy(rng.standard_normal((s, v, t_cap),
                                                dtype=np.float32)).to(dev, dtype)
    new = torch.from_numpy(rng.standard_normal((s, tn, v), dtype=np.float32)
                           ).to(dev).transpose(1, 2)
    start = torch.from_numpy(rng.integers(0, t_cap, size=s).astype(np.int32)
                             ).to(dev)
    start[0] = t_cap - tn // 2                           # hangs off the end
    n_new = torch.from_numpy(rng.integers(0, tn + 4, size=s).astype(np.int32)
                             ).to(dev)
    before = ring_append_cols.launches
    got = ring_append_cols(ring.clone(), new, start, n_new)
    ref = ring_append_cols_plain(ring.clone(), new, start, n_new)
    torch.cuda.synchronize()
    assert ring_append_cols.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("form", ["strided", "f32_into_bf16",
                                  "strided_f32_into_bf16", "permuted"])
@pytest.mark.parametrize("l_dim,t_cap,d,tn", [
    (1, 832, 512, 40),   # flagship enc_out: 16-byte units
    (2, 70, 80, 54),     # raw carry (80 mels), two layers
    (1, 33, 7, 5),       # odd rows: 4-byte units, or one float per bf16
])
def test_ring_append_rows_forms(dev, form, l_dim, t_cap, d, tn):
    """The producers' forms: a slice along time, float32 into a bfloat16
    cache, (L, S) stored swapped; one launch, equal to the plain twin."""
    rng = np.random.default_rng(t_cap + d)
    s = 6
    dtype = torch.float32 if form in ("strided", "permuted") else torch.bfloat16
    cache = torch.from_numpy(rng.standard_normal(
        (l_dim, s, t_cap, d), dtype=np.float32)).to(dev, dtype)
    big = torch.from_numpy(rng.standard_normal(
        (l_dim, s, tn + 3, d), dtype=np.float32)).to(dev)
    if form == "permuted":
        new = big[:, :, :tn].transpose(0, 1).contiguous().transpose(0, 1)
    elif form.startswith("strided"):
        new = big[:, :, 1:tn + 1]
    else:
        new = big[:, :, :tn].contiguous()
    start = torch.tensor([0, t_cap - tn, 3, t_cap - 2, t_cap + 9, 1],
                         dtype=torch.int32, device=dev)
    n_new = torch.tensor([tn, tn, 0, tn, 2, tn + 3], dtype=torch.int32,
                         device=dev)
    before = ring_append_rows.launches
    got = ring_append_rows(cache.clone(), new, start, n_new)
    ref = ring_append_rows_plain(cache.clone(), new, start, n_new)
    torch.cuda.synchronize()
    assert ring_append_rows.launches == before + 1
    assert torch.equal(got, ref)


def test_ring_append_stream_and_graph(dev):
    """The launch goes to PyTorch's current stream (a side stream, a CUDA
    graph's capture stream), so the appends can be captured and replayed."""
    ring = torch.zeros((2, 64, 96), device=dev)
    new = torch.randn((2, 8, 64), device=dev).transpose(1, 2)
    start = torch.tensor([0, 50], dtype=torch.int32, device=dev)
    n_new = torch.tensor([8, 5], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.stream_ptr(ring) == side.cuda_stream
        ring_append_cols(ring, new, start, n_new)  # plan and warm up
    torch.cuda.synchronize()
    ring.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ring_append_cols(ring, new, start, n_new)
    torch.cuda.synchronize()
    assert float(ring.abs().sum()) == 0.0            # captured, not run
    start.copy_(torch.tensor([10, 90], dtype=torch.int32))
    graph.replay()
    ref = ring_append_cols_plain(torch.zeros_like(ring), new, start, n_new)
    torch.cuda.synchronize()
    assert torch.equal(ring, ref)


def test_ring_append_rows_stream_and_graph(dev):
    """Kernel D on a side stream, then captured in a CUDA graph and
    replayed with new starts."""
    cache = torch.zeros((1, 3, 64, 32), device=dev)
    new = torch.randn((1, 3, 9, 32), device=dev)[:, :, 1:8]   # a time slice
    start = torch.tensor([0, 20, 50], dtype=torch.int32, device=dev)
    n_new = torch.tensor([7, 3, 0], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.stream_ptr(cache) == side.cuda_stream
        ring_append_rows(cache, new, start, n_new)  # plan and warm up
    torch.cuda.synchronize()
    cache.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ring_append_rows(cache, new, start, n_new)
    torch.cuda.synchronize()
    assert float(cache.abs().sum()) == 0.0           # captured, not run
    start.copy_(torch.tensor([5, 60, 1], dtype=torch.int32))
    n_new.copy_(torch.tensor([2, 7, 4], dtype=torch.int32))
    graph.replay()
    ref = ring_append_rows_plain(torch.zeros_like(cache), new, start, n_new)
    torch.cuda.synchronize()
    assert torch.equal(cache, ref)


def _add_layer_norm_operands(dev, n, d, lmax=12, cache_dtype=None, seed=0):
    rng = np.random.default_rng(seed)

    def rows(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    p = {"weight": 1.0 + 0.1 * rows(d), "bias": 0.1 * rows(d)}
    ops = {"h": 3.0 * rows(n, d) + 1.0, "y": rows(n, d), "bias": rows(d)}
    if cache_dtype is not None:
        ops["cache"] = rows(n, lmax, d).to(cache_dtype)
        ops["pos"] = torch.from_numpy(rng.integers(0, lmax + 3, n)).to(dev)
        ops["write"] = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    return p, ops


def _add_layer_norm_close(p, ops, got_h, got_hn, old_cache=None):
    """F against its twin: h + (y + bias) exact, the normalised rows within
    1e-5 of the largest, each cache row the kernel's own row cast (the old
    one where the row must not write)."""
    ref_h, ref_hn = add_layer_norm_plain(p, ops["h"], ops.get("y"),
                                         ops.get("bias"))
    torch.cuda.synchronize()
    assert torch.equal(got_h, ref_h)
    err = float((got_hn - ref_hn).abs().max() / ref_hn.abs().max())
    assert err <= 1e-5, err
    if old_cache is not None:
        lmax = old_cache.shape[1]
        keep = (ops["write"] & (ops["pos"] < lmax))[:, None]
        rows = torch.arange(got_hn.shape[0], device=got_hn.device)
        at = ops["pos"].clamp(max=lmax - 1)
        want = old_cache.clone()
        want[rows, at] = torch.where(keep, got_hn.to(want.dtype),
                                     want[rows, at])
        assert torch.equal(ops["cache"], want)


@pytest.mark.parametrize("n,d", [(96, 512), (768, 512), (96, 256),
                                 (768, 256), (5, 16), (3, 64), (7, 1024)])
@pytest.mark.parametrize("form", ["h", "h_y", "h_y_bias", "cache_float32",
                                  "cache_bfloat16"])
def test_add_layer_norm_kernel(dev, form, n, d):
    cache_dtype = {"cache_float32": torch.float32,
                   "cache_bfloat16": torch.bfloat16}.get(form)
    p, ops = _add_layer_norm_operands(dev, n, d, cache_dtype=cache_dtype,
                                      seed=n + d)
    if form == "h":
        del ops["y"], ops["bias"]
    elif form == "h_y":
        del ops["bias"]
    old = ops["cache"].clone() if "cache" in ops else None
    before = add_layer_norm.launches
    got_h, got_hn = add_layer_norm(p, **ops)
    assert add_layer_norm.launches == before + 1
    if form == "h":
        assert got_h is ops["h"]
    _add_layer_norm_close(p, ops, got_h, got_hn, old)
    with pytest.raises(ValueError):
        add_layer_norm(p, ops["h"].cpu())                # no silent fallback


def test_add_layer_norm_stream_and_graph(dev):
    """F on a side stream, then captured in a CUDA graph and replayed with
    new positions and write flags."""
    p, ops = _add_layer_norm_operands(dev, 96, 512, cache_dtype=torch.float32)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.stream_ptr(ops["h"]) == side.cuda_stream
        add_layer_norm(p, **{**ops, "cache": ops["cache"].clone()})
    torch.cuda.synchronize()
    old = ops["cache"].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_h, got_hn = add_layer_norm(p, **ops)
    torch.cuda.synchronize()
    assert torch.equal(ops["cache"], old)            # captured, not run
    ops["pos"].copy_(torch.arange(96) % 15)
    ops["write"].copy_(torch.arange(96) % 3 != 0)
    graph.replay()
    _add_layer_norm_close(p, ops, got_h, got_hn, old)


def _lane_attention_operands(dev, n, h, d, lmax, beam, cache_dtype, p,
                             seed=0):
    """G's operands: qk as the transposed view the decoder's einsum
    returns, a lane map that branches after a shared prefix, every
    hypothesis at position p."""
    rng = np.random.default_rng(seed)

    def rows(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    lane = rng.integers(0, beam, (n // beam, beam, lmax)).astype(np.int32)
    lane[:, :, :lmax // 3] = 0
    return {"qk": rows(h, n, d).transpose(0, 1),
            "cache": rows(n, lmax, d).to(cache_dtype),
            "hn_self": rows(n, d), "lane": torch.from_numpy(lane).to(dev),
            "pos": torch.full((n,), p, dtype=torch.int64, device=dev),
            "dk": d // h}


def _lane_attention_close(got, ops):
    """G within 2e-6 of the largest |u| of the twin evaluated in float64
    (the float32 twin's cuBLAS sums are themselves up to 4e-6 off)."""
    ref = lane_attention_plain(**{**ops, "qk": ops["qk"].double(),
                                  "hn_self": ops["hn_self"].double()})
    torch.cuda.synchronize()
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= 2e-6, err


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,d,lmax,p", [
    (96, 8, 512, 192, 32),     # flagship drain step, width 32
    (768, 8, 512, 192, 191),   # flagship backlog round, full history
    (96, 4, 256, 192, 0),      # conformer, the self row alone
    (768, 4, 256, 192, 64),
    (12, 4, 512, 192, 200),    # tp = 2's heads, pos past Lmax
    (6, 2, 16, 160, 7),        # tiny config
    (12, 4, 64, 40, 39),       # small card-test width
    (3, 4, 1024, 64, 17),
    (9, 32, 128, 24, 23),
])
def test_lane_attention_kernel(dev, n, h, d, lmax, p, cache_dtype):
    ops = _lane_attention_operands(dev, n, h, d, lmax, 3, cache_dtype, p,
                                   seed=n + d)
    before = lane_attention.launches
    got = lane_attention(**ops)
    assert lane_attention.launches == before + 1
    _lane_attention_close(got, ops)
    hidden = (torch.arange(lmax, device=dev) >= p)[None, :, None]
    nan = torch.where(hidden, float("nan"), ops["cache"].float())
    again = lane_attention(**{**ops, "cache": nan.to(cache_dtype)})
    torch.cuda.synchronize()
    assert torch.equal(again, got)             # rows at t >= pos unread
    with pytest.raises(ValueError):
        lane_attention(**{**ops, "pos": ops["pos"].cpu()})  # no fallback


def test_lane_attention_stream_and_graph(dev):
    """G on a side stream, then captured in a CUDA graph and replayed with
    new positions and a new lane map."""
    ops = _lane_attention_operands(dev, 96, 8, 512, 192, 3, torch.float32,
                                   20)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.stream_ptr(ops["hn_self"]) == side.cuda_stream
        _lane_attention_close(lane_attention(**ops), ops)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = lane_attention(**ops)
    ops["pos"].copy_(torch.arange(96) % 50)
    ops["lane"].copy_(torch.randint(0, 3, ops["lane"].shape))
    graph.replay()
    _lane_attention_close(got, ops)


def _cross_attention_operands(dev, s, beam, h, t, dk, kv_dtype, seed=0):
    """H's operands: the queries as the decoder's (N, h·dk) rows, K/V as
    ``head_major`` lays them out, and each stream's encoder length: the
    edges 0, 1, T - 1 and T first, the rest drawn from [0, T]."""
    from speechcatcher_tpu_torch.models.decoder import head_major

    rng = np.random.default_rng(seed)

    def rows(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    lens = rng.integers(0, t + 1, s)
    edges = [0, 1, t - 1, t] if s > 1 else [1 + t // 5]
    lens[:min(s, 4)] = edges[:min(s, 4)]
    return {"q": rows(s * beam, h * dk),
            "mk": head_major(rows(s, t, h * dk), h, kv_dtype),
            "mv": head_major(rows(s, t, h * dk), h, kv_dtype),
            "enc_len": torch.from_numpy(lens.astype(np.int32)).to(dev)}


def _cross_attention_close(got, ops):
    """H within the card's bound of its twin evaluated in float64
    (``chip_smoke.cross_attention_error``: 1e-5 of the largest |out|, with
    bfloat16 K/V four weights a row rounded across a bfloat16 boundary),
    and finite."""
    worst, abs_err, scale = cross_attention_error(got, **ops)
    assert worst <= 1.0, (worst, abs_err / scale)
    assert bool(torch.isfinite(got).all())


# Every (h, dk, beam) a configuration runs: the flagship (8 x 64) and the
# conformers (4 x 64) at the serving beam 3, the sessions' 5 and the
# endpointing default 10, tp = 2's 4 x 64, the tiny (2 x 8) configuration,
# a model directory without a config.yaml (4 x 128 over a 2048-frame ring
# at the sessions' beam 5: more than 48 KB of shared memory a block), the
# card tests' 64-wide flagship (4 x 16) and the tiny one with 4 heads (4 x
# 4): each of the kernel's three row splits (one, two or four float4s a
# lane).
CROSS_WIDTHS = [(8, 64, 3, 832), (4, 64, 3, 832), (4, 64, 5, 832),
                (4, 64, 10, 832), (2, 8, 3, 160), (2, 8, 5, 160),
                (4, 128, 5, 2112), (4, 16, 3, 832), (4, 4, 3, 160)]


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 4, 32, 256])
@pytest.mark.parametrize("h,dk,beam,t", CROSS_WIDTHS)
def test_cross_attention_kernel(dev, h, dk, beam, t, s, kv_dtype):
    ops = _cross_attention_operands(dev, s, beam, h, t, dk, kv_dtype,
                                    seed=s + h + beam)
    before = cross_attention.launches
    got = cross_attention(**ops)
    assert cross_attention.launches == before + 1
    _cross_attention_close(got, ops)
    # Rows at t >= enc_len hold NaN: the kernel never reads one (the twin
    # would, as 0 x NaN), so the result is finite and the same.
    hidden = (torch.arange(t, device=dev)[None, :]
              >= ops["enc_len"].long()[:, None])[:, None, :, None]
    poisoned = {k: torch.where(hidden, float("nan"), ops[k].float()).to(
        kv_dtype) for k in ("mk", "mv")}
    again = cross_attention(**{**ops, **poisoned})
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    assert not bool(got.reshape(s, beam, -1)[
        ops["enc_len"] == 0].any())                  # enc_len 0: zeros
    with pytest.raises(ValueError):
        cross_attention(**{**ops, "enc_len": ops["enc_len"].cpu()})


def test_cross_attention_stream_and_graph(dev):
    """H on a side stream, then captured in a CUDA graph and replayed with
    new encoder lengths (int64 ones, as the session's step hands them)."""
    ops = _cross_attention_operands(dev, 32, 3, 8, 832, 64, torch.float32)
    ops["enc_len"] = ops["enc_len"].long()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.stream_ptr(ops["q"]) == side.cuda_stream
        _cross_attention_close(cross_attention(**ops), ops)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cross_attention(**ops)
    ops["enc_len"].copy_(torch.arange(32) * 26)
    graph.replay()
    _cross_attention_close(got, ops)


def test_a_graphed_beam_step_attends_across_through_h(dev):
    """The flagship's decoder (6 layers, T = 832 ring rows) in a graphed
    block loop: the step graph's capture records 6 launches of H, a replay
    runs 6 ``cross_attention_kernel``s, and an eager step makes no product
    over the ring's 832 rows, so none of the old path's two products'
    kernels (which cuBLAS kernel a product takes depends on its shape:
    ``gemmSN`` also serves the decoder's linears at 4 streams)."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.decode import beam_search as bs
    from speechcatcher_tpu_torch.decode.graphs import (
        STEPS_PER_REPLAY,
        BlockLoop,
        clone_tree,
    )
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.serve.engine import _ring_frames

    cfg = flagship_config(encoder_layers=1)
    model = ASRModel.random_init(cfg, seed=3, device=dev)
    s_dim, beam = 4, 3
    ecap = -(-(cfg.max_enc_frames + cfg.block_size) // 64) * 64
    memory = torch.randn((s_dim, ecap, cfg.encoder_dim), device=dev)
    loop = BlockLoop(
        model, bs.fresh_block_state(cfg, s_dim, beam, dev), memory,
        bs.LoopSettings(beam, cfg.pre_beam_size, cfg.ctc_weight, True,
                        cfg.max_tokens),
        frames=functools.partial(_ring_frames, memory, cfg.block_size),
        extcap=cfg.block_size)
    n = cfg.block_size
    loop.run(np.zeros(s_dim), np.full(s_dim, n), np.full(s_dim, n),
             np.ones(s_dim), np.zeros(s_dim))
    step = loop._graphs[1]
    record = {f.__name__: k for (f, _), k in step.launches.items()}
    assert record["cross_attention"] == 6 * STEPS_PER_REPLAY
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step.graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("cross_attention_kernel" in k for k in names) == 6
    state = clone_tree(loop.state)
    flag = torch.zeros(2, dtype=torch.int32, device=dev)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        loop._step(state, loop._held["cross_kv"], flag, steps=1)
    ring = [e.input_shapes for e in prof.events()
            if e.name in ("aten::bmm", "aten::matmul", "aten::mm")
            and any(ecap in shape for shape in e.input_shapes)]
    assert ring == []


@pytest.mark.parametrize("n,h,w,dk", [
    (1, 8, 42, 64),    # flagship session, one block
    (24, 8, 42, 64),   # flagship engine, 8 slots x 3 blocks
    (11, 4, 10, 16),   # small window
])
def test_rel_block_attention_kernel(dev, n, h, w, dk):
    rng = np.random.default_rng(n + w)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev)

    q, k, v = (rand(n, h, w, dk) for _ in range(3))
    pos, bias_u, bias_v = rand(h, w, dk), rand(h, dk), rand(h, dk)
    mask = torch.from_numpy(block_attention_mask(w - 2)).to(dev)
    before = rel_block_attention.launches
    got = rel_block_attention(q, k, v, pos, bias_u, bias_v, mask)
    ref = rel_block_attention_plain(q, k, v, pos, bias_u, bias_v, mask)
    torch.cuda.synchronize()
    assert rel_block_attention.launches == before + 1
    assert float((got - ref).abs().max()) <= 1e-5
    assert bool((got[:, :, 0] == 0).all())
    with pytest.raises(ValueError):  # no silent fallback
        rel_block_attention(q, k, v, pos.cpu(), bias_u, bias_v, mask)


# ---------------------------------------------------------------------------
# Kernels A and E in the forms their callers give them
# ---------------------------------------------------------------------------

def _attention_operands(dev, rel, form, n, h, w, dk, seed):
    """q, k, v (and pos, bias_u, bias_v) for A or E. "projection": the
    transposed views of (N, W, H*dk) projections, as mha_project returns
    them; "offset": contiguous tensors that start 4 bytes past a 16-byte
    boundary (the scalar route); "contiguous": plain (N, H, W, dk)."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev)

    def operand(lead):
        if form == "projection":
            return rand(lead, w, h * dk).reshape(lead, w, h, dk).transpose(1, 2)
        if form == "offset":
            return rand(lead * h * w * dk + 1)[1:].reshape(lead, h, w, dk)
        return rand(lead, h, w, dk)

    args = [operand(n) for _ in range(3)]
    if rel:
        args += [operand(1)[0], rand(h, dk), rand(h, dk)]
    args.append(torch.from_numpy(block_attention_mask(w - 2)).to(dev))
    return args


_ATTENTION = {"block": (block_attention, block_attention_plain, False),
              "rel": (rel_block_attention, rel_block_attention_plain, True)}


@pytest.mark.parametrize("n,h,w,dk", [
    (2, 8, 42, 64),    # flagship session: 96 blocks, one row a warp
    (3, 8, 42, 64),    # three windows: two rows a warp from here on
    (16, 8, 42, 64),   # flagship engine, 8 slots x 2 windows
    (5, 2, 6, 4),      # one tile, one column per lane
    (11, 2, 7, 8),
    (7, 2, 10, 16),    # two tiles of five rows
    (7, 2, 10, 6),     # dk not a multiple of 4: the scalar route
    (2, 3, 33, 5),     # two columns per lane, odd dk
    (2, 2, 70, 8),     # three columns per lane
    (1, 2, 128, 4),    # the widest window
    # More blocks than SMs, so two query rows a warp:
    (40, 8, 7, 8),     # the last warp has one row
    (70, 4, 10, 6),    # the scalar route
    (150, 2, 33, 5),   # two columns per lane, an odd row left over
    (70, 2, 70, 8),    # three columns per lane
])
@pytest.mark.parametrize("form", ["contiguous", "projection", "offset"])
@pytest.mark.parametrize("which", ["block", "rel"])
def test_attention_forms(dev, which, form, n, h, w, dk):
    """A and E within 1e-5 of their plain versions (float32 sums in another
    order), row 0 exactly 0, one launch, and a result that the callers'
    transpose(1, 2).reshape merges without a copy."""
    kernel, plain, rel = _ATTENTION[which]
    args = _attention_operands(dev, rel, form, n, h, w, dk, seed=w * dk + n)
    before = kernel.launches
    got = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (n, h, w, dk)
    assert float((got - ref).abs().max()) <= 1e-5
    assert bool((got[:, :, 0] == 0).all())
    merged = got.transpose(1, 2).reshape(n, w, h * dk)
    assert merged.data_ptr() == got.data_ptr() and merged.is_contiguous()


@pytest.mark.parametrize("which", ["block", "rel"])
def test_attention_refuses_on_the_card(dev, which):
    """No silent fallback: what the plan refuses raises on CUDA tensors."""
    kernel, _, rel = _ATTENTION[which]
    args = _attention_operands(dev, rel, "contiguous", 2, 2, 6, 8, seed=0)
    with pytest.raises(ValueError):   # inner stride 2
        kernel(torch.zeros((2, 2, 6, 16), device=dev)[..., ::2], *args[1:])
    with pytest.raises(TypeError):
        kernel(args[0].double(), *args[1:])
    with pytest.raises(ValueError):   # mixed devices
        kernel(*args[:-1], args[-1].cpu())


@pytest.mark.parametrize("which", ["block", "rel"])
def test_attention_stream_and_graph(dev, which):
    """The launch goes to PyTorch's current stream (a side stream, a CUDA
    graph's capture stream), so A and E can be captured and replayed."""
    kernel, plain, rel = _ATTENTION[which]
    args = _attention_operands(dev, rel, "projection", 2, 8, 42, 64, seed=9)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert _build.stream_ptr(args[0]) == side.cuda_stream
        warm = kernel(*args)                         # plan and warm up
    torch.cuda.synchronize()
    assert float((warm - plain(*args)).abs().max()) <= 1e-5
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(*args)
    torch.cuda.synchronize()
    new_q = torch.randn_like(args[0])
    args[0].copy_(new_q)                             # same storage, new data
    graph.replay()
    torch.cuda.synchronize()
    ref = plain(*args)
    assert float((out - ref).abs().max()) <= 1e-5
    assert float((out - warm).abs().max()) > 1e-3    # the replay recomputed


def _manager_messages(dev, in_threads: bool):
    """Two sessions of a small model on the card through the server's
    SessionManager; every tick from the calling thread or, as the server's
    batcher calls it, from a new worker thread. Returns every message and
    the kernel launches of the run."""
    import threading

    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.serve.server import SessionManager
    from speechcatcher_tpu_torch.synth import synth_audio

    cfg = flagship_config(encoder_dim=64, encoder_heads=4, encoder_layers=2,
                          decoder_dim=64, decoder_heads=4, decoder_layers=2,
                          encoder_linear_units=128, decoder_linear_units=128)
    model = ASRModel.random_init(cfg, seed=1, device=dev)
    mgr = SessionManager(StreamingEngine(model, n_slots=2, beam_size=3,
                                         device=dev),
                         finalize_update_iters=99)
    counters = (block_attention, ctc_forward_recursion, ring_append_cols,
                ring_append_rows)
    before = [c.launches for c in counters]

    def tick():
        if not in_threads:
            return mgr.tick()
        out = []
        t = threading.Thread(target=lambda: out.append(mgr.tick()))
        t.start()
        t.join(timeout=300)
        assert not t.is_alive() and len(out) == 1
        return out[0]

    log = []
    sids = [mgr.open_session() for _ in range(2)]
    for k, sid in enumerate(sids):
        pcm = np.clip(synth_audio(2.3 + 0.4 * k, 40 + k), -1, 1) * 32767
        mgr.feed(sid, pcm.astype(np.int16).tobytes())
    while mgr.ready():
        log.append(tick())
    for sid in sids:
        mgr.request_final(sid)
    log.append(tick())
    assert mgr.caught == {"batcher": 0, "finalize_batch": 0, "finalize": 0}
    return log, [c.launches - b for c, b in zip(counters, before)]


def test_server_tick_from_a_worker_thread(dev):
    """The engine needs none of its caller's per-thread state (current
    stream, grad mode, current device): ticks from worker threads give
    the messages of ticks from the main thread, through the kernels."""
    main_log, main_launches = _manager_messages(dev, in_threads=False)
    thread_log, thread_launches = _manager_messages(dev, in_threads=True)
    assert thread_log == main_log
    assert thread_launches == main_launches and min(main_launches) > 0
    finals = [m for out in main_log for m in out.values() if "result" in m]
    assert len(finals) == 2


@pytest.mark.parametrize("n", [16, 40])
@pytest.mark.parametrize("which", ["block", "rel"])
def test_attention_functions_grad_equal_plain_autograd(dev, which, n):
    """A and E through their autograd Functions on the card: the kernel's
    forward, and gradients equal to plain autograd's on the same inputs
    (the backward is that same plain code), with one backward counted."""
    from speechcatcher_tpu_torch.ops.kernels.block_attention import (
        BlockAttentionFn,
    )
    from speechcatcher_tpu_torch.ops.kernels.rel_attention import (
        RelBlockAttentionFn,
    )

    rel = which == "rel"
    h, w, dk = 8, 42, 64
    gen = torch.Generator(device=dev).manual_seed(n)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    bases = [rand(n, w, h * dk).requires_grad_() for _ in range(3)]
    if rel:
        bases += [rand(1, w, h * dk).requires_grad_(),
                  rand(h, dk).requires_grad_(), rand(h, dk).requires_grad_()]

    def operands():
        views = [b.reshape(n, w, h, dk).transpose(1, 2) for b in bases[:3]]
        if rel:
            views += [bases[3].reshape(1, w, h, dk).transpose(1, 2)[0],
                      bases[4], bases[5]]
        return views

    mask = torch.from_numpy(block_attention_mask(w - 2)).to(dev)
    kernel, plain, fn = ((rel_block_attention, rel_block_attention_plain,
                          RelBlockAttentionFn) if rel else
                         (block_attention, block_attention_plain,
                          BlockAttentionFn))
    launches, backwards = kernel.launches, fn.backward_launches
    cot = rand(n, h, w, dk)
    out = kernel(*operands(), mask)
    got = torch.autograd.grad(out, bases, cot)
    ref_out = plain(*operands(), mask)
    ref = torch.autograd.grad(ref_out, bases, cot)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    assert fn.backward_launches == backwards + 1
    assert float((out - ref_out).detach().abs().max()) <= 1e-5
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_kernels_without_backward_refuse_grad_on_the_card(dev):
    """B, C, D and F raise on an operand that requires grad (no result without
    a gradient), and run under no_grad."""
    i32 = dict(dtype=torch.int32, device=dev)
    calls = [
        (ctc_forward_recursion, [torch.randn(6, 3, device=dev)
                                 for _ in range(3)]
         + [torch.zeros(3, **i32), torch.full((3,), 6, **i32),
            torch.ones(3, device=dev)]),
        (ring_append_cols, [torch.zeros(2, 4, 8, device=dev),
                            torch.randn(2, 4, 3, device=dev),
                            torch.zeros(2, **i32),
                            torch.full((2,), 3, **i32)]),
        (ring_append_rows, [torch.zeros(2, 2, 8, 4, device=dev),
                            torch.randn(2, 2, 3, 4, device=dev),
                            torch.zeros(2, **i32),
                            torch.full((2,), 3, **i32)]),
    ]
    calls.append((add_layer_norm, [
        {"weight": torch.ones(32, device=dev),
         "bias": torch.zeros(32, device=dev)},
        torch.randn(4, 32, device=dev), torch.randn(4, 32, device=dev)]))
    for call, ops in calls:
        ops[1].requires_grad_()
        with pytest.raises(RuntimeError, match="has no backward"):
            call(*ops)
        before = call.launches
        with torch.no_grad():
            call(*ops)
        assert call.launches == before + 1


def test_flagship_width_train_step_matches_cpu(dev):
    """One train_step at the flagship's widths (d 512, 8 heads, FFN 2048,
    vocab 1024; depth cut to 2 + 2 layers) on the card and on the CPU, from
    the same weights and batch: loss within 1e-5 relative, gradients and
    parameters within the tolerances of chip_smoke.train_vs_cpu (atomic-add
    backwards sum in no fixed order)."""
    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.data import (
        BucketBatcher,
        synthetic_dataset,
    )
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.params import (
        params_to_numpy,
        random_params,
        tree_leaves,
    )
    from speechcatcher_tpu_torch.training import (
        TrainBatch,
        joint_loss,
        make_optimizer,
        train_step,
    )

    cfg = flagship_config(encoder_layers=2, decoder_layers=2)
    tree = random_params(cfg, 4)
    cpu = torch.device("cpu")
    model = ASRModel.from_numpy(cfg, tree, cpu)
    utts = synthetic_dataset(16, cfg, model.tokenizer, seed=2)
    batch_cpu = next(iter(BucketBatcher(model.frontend, model.tokenizer,
                                        batch_size=4).batches(utts)))
    out = []
    for d in (cpu, dev):
        model = ASRModel.from_numpy(cfg, tree, d)
        batch = TrainBatch(*(x.to(d) for x in batch_cpu))
        opt = make_optimizer(lr=1e-3, grad_clip=5.0)
        state = opt.init(model.params)
        loss, _ = joint_loss(model.params, batch, cfg)
        grads = torch.autograd.grad(loss, state.leaves)
        train_step(model.params, state, batch, cfg, opt)
        out.append((loss.item(), [g.cpu().numpy() for g in grads],
                    params_to_numpy(model.params)))
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = out
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for gc, gg in zip(g_cpu, g_gpu):
        atol = max(5e-4 * float(np.abs(gc).max()), 1e-8)
        assert np.all(np.abs(gg - gc) <= 1e-3 * np.abs(gc) + atol)
    diffs = np.concatenate([np.abs(pg - pc).ravel() for (_, pc), (_, pg) in
                            zip(tree_leaves(p_cpu), tree_leaves(p_gpu))])
    assert diffs.max() <= 2e-3 and (diffs > 1e-6).mean() <= 0.01


def _small_train_model(dev, encoder_type, seed=4):
    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.params import random_params

    cfg = flagship_config(encoder_type=encoder_type, encoder_layers=2,
                          decoder_layers=1)
    tree = random_params(cfg, seed)
    return cfg, tree, lambda: ASRModel.from_numpy(cfg, tree, dev)


def _train_batches(model, n_utts=24):
    from speechcatcher_tpu_torch.data import BucketBatcher, synthetic_dataset

    utts = synthetic_dataset(n_utts, model.cfg, model.tokenizer, seed=2)
    return list(BucketBatcher(model.frontend, model.tokenizer,
                              batch_size=4).batches(utts, with_refs=True))


@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
def test_train_step_graphs_replay_the_eager_step(dev, encoder_type,
                                                 monkeypatch):
    """Four train steps under WarmupLR and a clip, on two batch signatures
    of one pool (flagship widths, 2 + 1 layers), graphed against the eager
    program twice, under deterministic algorithms: each step's losses and
    the final parameters, moments and count within the eager step's
    difference from itself (0 when it repeats itself); A (E) forward and
    backward counted once a layer per replay, through the capture's record
    (the backward runs on autograd's own thread)."""
    from speechcatcher_tpu_torch import training

    cfg, _, make = _small_train_model(dev, encoder_type)
    batches = [b for b, _ in _train_batches(make())]
    shapes = sorted({b.feats.shape for b in batches})
    steps = [next(b for b in batches if b.feats.shape == shapes[i % 2])
             for i in range(4)]
    kernel, fn = ((rel_block_attention, RelBlockAttentionFn)
                  if encoder_type == "conformer"
                  else (block_attention, BlockAttentionFn))
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for graphed in (False, False, True):
            monkeypatch.setattr(training, "graphed", lambda d, g=graphed: g)
            model = make()
            opt = training.make_optimizer(warmup_steps=2, grad_clip=1.0)
            state = opt.init(model.params)
            before = (kernel.launches, fn.backward_launches)
            losses = []
            for b in steps:
                _, _, m = training.train_step(model.params, state, b, cfg,
                                              opt)
                losses.append([float(m[k]) for k in training.METRICS])
            torch.cuda.synchronize()
            launched = (kernel.launches - before[0],
                        fn.backward_launches - before[1])
            runs.append((losses, state, launched))
    finally:
        torch.use_deterministic_algorithms(False)
    (le, se, _), (l2, s2, _), (lg, sg, launched) = runs
    assert sg.graphs is not None and len(sg.graphs.entries) == 2
    assert launched == (cfg.encoder_layers * 4,) * 2
    yard = max(abs(a - b) for x, y in zip(le, l2) for a, b in zip(x, y))
    assert max(abs(a - b) for x, y in zip(le, lg)
               for a, b in zip(x, y)) <= yard
    for key in ("leaves", "mu", "nu"):
        yard = max(float((a - b).detach().abs().max())
                   for a, b in zip(getattr(se, key), getattr(s2, key)))
        diff = max(float((a - b).detach().abs().max())
                   for a, b in zip(getattr(se, key), getattr(sg, key)))
        assert diff <= yard, (key, diff, yard)
    assert int(sg.count) == int(se.count) == 4


def test_evaluate_graphs_equal_eager(dev, monkeypatch):
    """``evaluate`` with the tokenizer, graphed twice (capture, then
    replays only) and eager: the same losses, WER and CER."""
    from speechcatcher_tpu_torch import training
    from speechcatcher_tpu_torch.decode import graphs

    cfg, _, make = _small_train_model(dev, "transformer")
    model = make()
    batches = _train_batches(model, 12)
    n0 = len(graphs.CAPTURED)
    got = training.evaluate(model.params, cfg, batches, model.tokenizer)
    n1 = len(graphs.CAPTURED)
    again = training.evaluate(model.params, cfg, batches, model.tokenizer)
    monkeypatch.setattr(training, "graphed", lambda d: False)
    want = training.evaluate(model.params, cfg, batches, model.tokenizer)
    assert got == again == want
    assert n1 - n0 == 2 * len({b.feats.shape for b, _ in batches})
    assert len(graphs.CAPTURED) == n1


# ---------------------------------------------------------------------------
# Several engine replicas, and a tp rank's attention, on one card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 392])
@pytest.mark.parametrize("which", ["block", "rel"])
def test_attention_at_tp_heads_in_main_path_form(dev, which, n):
    """A and E at a tp=2 rank's 4 heads of 64 (the flagship's 8 heads
    split), on the transposed views of (N, W, 4*64) projections: the tp
    engine's 8 windows and the training batch's 392."""
    kernel, plain, rel = _ATTENTION[which]
    args = _attention_operands(dev, rel, "projection", n, 4, 42, 64,
                               seed=n + rel)
    before = kernel.launches
    got = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert float((got - ref).abs().max()) <= 1e-5
    assert bool((got[:, :, 0] == 0).all())
    merged = got.transpose(1, 2).reshape(n, 42, 4 * 64)
    assert merged.data_ptr() == got.data_ptr()


def _dp_engine_run(dev, n_replicas: int, threads: bool = True):
    """Four streams of a small model through an engine of 4 slots, sharded
    into `n_replicas` replicas on this card (1: the unsharded engine);
    without `threads` the replicas tick one after another. Returns the
    finals and the launches of the four kernels."""
    from speechcatcher_tpu_torch.config import flagship_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.parallel.mesh import make_mesh
    from speechcatcher_tpu_torch.parallel.serve_sharding import shard_engine
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.synth import synth_audio

    cfg = flagship_config(encoder_dim=64, encoder_heads=4, encoder_layers=2,
                          decoder_dim=64, decoder_heads=4, decoder_layers=2,
                          encoder_linear_units=128, decoder_linear_units=128)
    model = ASRModel.random_init(cfg, seed=1, device=dev)
    engine = StreamingEngine(model, n_slots=4, beam_size=3, device=dev)
    if n_replicas > 1:
        engine = shard_engine(engine, make_mesh(n_replicas,
                                                devices=[dev] * n_replicas))
        if not threads:
            engine._pool = None
    chunk = engine.A
    audios = [synth_audio(2.3 + 0.4 * k, 40 + k) for k in range(4)]
    counters = (block_attention, ctc_forward_recursion, ring_append_cols,
                ring_append_rows)
    before = [c.launches for c in counters]
    slots = [engine.acquire_slot() for _ in audios]
    n_ticks = min(len(a) for a in audios) // chunk
    for i in range(n_ticks):
        engine.tick({s: audios[k][i * chunk:(i + 1) * chunk]
                     for k, s in enumerate(slots)})
    res = engine.finalize_batch({s: audios[k][n_ticks * chunk:]
                                 for k, s in enumerate(slots)})
    torch.cuda.synchronize()
    finals = [(np.asarray(res[s][0]).tolist(), np.asarray(res[s][1]).tolist(),
               float(res[s][2])) for s in slots]
    return finals, [c.launches - b for c, b in zip(counters, before)]


def test_dp_engine_on_one_card_matches_unsharded(dev):
    """Two replicas of 2 slots on one card, ticking on their own threads:
    the unsharded engine's tokens and positions, scores within 1e-5."""
    want, _ = _dp_engine_run(dev, 1)
    got, launches = _dp_engine_run(dev, 2)
    for (gy, gx, gs), (wy, wx, ws) in zip(got, want):
        assert gy == wy and gx == wx
        assert abs(gs - ws) <= 1e-5 * max(1.0, abs(ws))
    assert min(launches) > 0


def test_replica_threads_count_launches_exactly(dev):
    """The launch counts of two replicas ticking concurrently equal those
    of the same run ticking them one after another."""
    serial_finals, serial = _dp_engine_run(dev, 2, threads=False)
    finals, threaded = _dp_engine_run(dev, 2)
    assert threaded == serial and min(serial) > 0
    assert [f[:2] for f in finals] == [f[:2] for f in serial_finals]


@pytest.mark.parametrize("owner", ["engine", "session"])
def test_block_loop_graphs_replay_the_eager_loop(dev, owner):
    """At tiny width, a block loop captured as CUDA graphs (prologue, K
    unrolled beam steps, rewind) and replayed on its state equals the eager
    loop on a copy of the same state on every leaf, to the last bit; B
    launches K times a replay of the step graph."""
    import copy

    from speechcatcher_tpu_torch.config import tiny_config
    from speechcatcher_tpu_torch.decode import graphs
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    model = ASRModel.random_init(tiny_config(), seed=1, device=dev)
    audio = [synth_audio(2.0, 30 + k) for k in range(3)]
    if owner == "engine":
        engine = StreamingEngine(model, n_slots=3, beam_size=3,
                                 chunk_samples=8192, device=dev)
        slots = [engine.acquire_slot() for _ in audio]
        for i in range(2):
            engine.tick({s: audio[k][i * 8192:(i + 1) * 8192]
                         for k, s in enumerate(slots)})
        loop, vis = engine._loop, engine.c.vis_len
        ints = np.stack([vis, np.full(3, 4), vis + 4, np.ones(3),
                         np.array([0, 1, 0])])
    else:
        s2t = Speech2TextStreaming(model=model, beam_size=3, device=dev)
        s2t(audio[0][:16000])
        loop = s2t.beam_search.loop
        vis = s2t.beam_search.state.vis_len
        ints = np.array([[vis], [0], [vis], [1], [1]])
    assert loop.graphed and loop._graphs is not None
    loop.ints.put(ints.astype(np.int32))
    start = graphs.clone_tree(loop.state)
    before = ctc_forward_recursion.launches
    replays = loop._graphs[1].replays
    loop._run_graphs()
    torch.cuda.synchronize()
    assert (ctc_forward_recursion.launches - before
            == graphs.STEPS_PER_REPLAY * (loop._graphs[1].replays - replays))
    ref = copy.copy(loop)
    ref.state, ref.stepping0 = start, torch.zeros_like(loop.stepping0)
    ref._run_eager()
    for got, want in zip(graphs.tree_leaves(loop.state),
                         graphs.tree_leaves(start)):
        assert torch.equal(got.contiguous().view(torch.uint8),
                           want.contiguous().view(torch.uint8))


def test_finals_of_every_width_hold_bounded_memory(dev):
    """At tiny width and 8 slots, finals of every batch width 1 to 8 run
    on the compact sets that capture_graphs made (widths 1, 2, 4, 8): no
    capture after it, and a second sweep of every width leaves the card's
    allocated memory where the first left it."""
    import gc

    from speechcatcher_tpu_torch.config import tiny_config
    from speechcatcher_tpu_torch.decode import graphs
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.synth import synth_audio

    model = ASRModel.random_init(tiny_config(), seed=1, device=dev)
    engine = StreamingEngine(model, n_slots=8, beam_size=3,
                             chunk_samples=8192, device=dev)
    engine.capture_graphs()
    captured = len(graphs.CAPTURED)

    def sweep(seed):
        for width in range(1, 9):
            audio = [synth_audio(2.0, seed + 10 * width + k)
                     for k in range(width)]
            slots = [engine.acquire_slot() for _ in audio]
            for i in range(3):
                engine.tick({s: audio[k][i * 8192:(i + 1) * 8192]
                             for k, s in enumerate(slots)})
            out = engine.finalize_batch({s: audio[k][24576:]
                                         for k, s in enumerate(slots)})
            assert sorted(out) == sorted(slots)
        torch.cuda.synchronize()
        gc.collect()
        return torch.cuda.memory_allocated(dev)

    first = sweep(100)
    assert sweep(200) == first
    assert sorted(engine._compact) == [1, 2, 4, 8]
    assert len(graphs.CAPTURED) == captured


def test_single_finals_after_capture_capture_nothing(dev):
    """At tiny width, finalize() of streams of twelve lengths (so many
    carried fills and tails, the short-segment final included) after
    capture_graphs captures nothing: the finalizer's chunk step runs
    eagerly, its block loop on the graphs capture_graphs made."""
    from speechcatcher_tpu_torch.config import tiny_config
    from speechcatcher_tpu_torch.decode import graphs
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.synth import synth_audio

    model = ASRModel.random_init(tiny_config(), seed=1, device=dev)
    engine = StreamingEngine(model, n_slots=4, beam_size=3,
                             chunk_samples=8192, device=dev)
    engine.capture_graphs()
    captured = len(graphs.CAPTURED)
    for k in range(12):
        audio = synth_audio(0.3 + 0.41 * k, 400 + k)
        s = engine.acquire_slot()
        n_full = (len(audio) - 1) // 8192
        for i in range(n_full):
            engine.tick({s: audio[i * 8192:(i + 1) * 8192]})
        yseq, _, _ = engine.finalize(s, audio[n_full * 8192:])
        assert len(yseq) >= 1
    assert len(graphs.CAPTURED) == captured


@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
def test_session_chunk_graphs_replay_the_eager_step(dev, encoder_type):
    """At tiny width on the card, every chunk of a session runs as graph
    replays (frontend, subsampling, blocks), each bit-equal to the eager
    ``StreamingEncoder.step`` on a copy of its state; after
    ``capture_graphs(8000)`` decoding utterances of other lengths captures
    nothing and leaves the allocated memory where it was."""
    import gc

    from speechcatcher_tpu_torch.config import tiny_config
    from speechcatcher_tpu_torch.decode import graphs
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
    from speechcatcher_tpu_torch.synth import synth_audio

    model = ASRModel.random_init(tiny_config(encoder_type=encoder_type),
                                 seed=1, device=dev)
    s2t = Speech2TextStreaming(model=model, beam_size=3, device=dev)
    chunk = s2t.beam_search.chunk
    assert chunk.graphed
    step = graphs.ChunkStep.step
    checked = []

    def checked_step(self, source, is_final):
        start = self.state()
        start = type(start)(**{
            k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in vars(start).items()})
        enc0 = self.enc_len
        plan = step(self, source, is_final)
        feats = source.data
        if source.kind == "wave":
            feats = self.frontend(feats)
            feats = feats[:, source.lo:feats.shape[1] - source.hi]
        ys, nxt = self.encoder.step(feats, start, is_final)
        assert torch.equal(self.ring[:, enc0:self.enc_len], ys)
        if nxt is not None:
            got = self.state()
            for name in ("buf_before", "buf_after", "prev_addin",
                         "past_ctx"):
                a, b = getattr(got, name), getattr(nxt, name)
                assert (a is None) == (b is None)
                assert a is None or torch.equal(a, b)
        checked.append(plan.kind)
        return plan

    graphs.ChunkStep.step = checked_step
    try:
        audio = synth_audio(2.3, 7)
        for i in range(0, len(audio), 8000):
            s2t(audio[i:i + 8000], is_final=i + 8000 >= len(audio))
    finally:
        graphs.ChunkStep.step = step
    assert "blocks" in checked and chunk._graphs
    assert s2t.capture_graphs(8000) == len(s2t.graph_keys(8000))
    captured = len(graphs.CAPTURED)

    def decode(seconds, seed):
        audio = synth_audio(seconds, seed)
        for i in range(0, len(audio), 8000):
            s2t(audio[i:i + 8000], is_final=i + 8000 >= len(audio))
        torch.cuda.synchronize()
        gc.collect()
        return torch.cuda.memory_allocated(dev)

    first = decode(1.3, 8)
    assert decode(3.1, 9) == first and decode(0.4, 10) == first
    assert len(graphs.CAPTURED) == captured
