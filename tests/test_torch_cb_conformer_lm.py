"""ESPnet's streaming conformer decoded with its Transformer LM by shallow
fusion (``lm_layers`` > 0) in the port, against the benchmark's plain
reference of it (``benchmark/reference/cb_conformer_lm.py``) on the CPU, at
``tiny_config``'s widths, ESPnet's default frontend and a tiny LM (d 16,
2 heads, 2 layers, FFN 32, embedding 8). The weights are the reference's
layout drawn by the benchmark's ``make_tree``, then made non-trivial
(every LayerNorm affine, every bias non-zero). The cases:

- the port's incremental LM step (``models.lm.lm_step``, kernels F and G's
  plain twins) against the reference's full causal forward over 20-token
  prefixes, hypotheses read through a lane map shuffled every step;
- a 4-stream engine with its finals (``finalize_batch`` and the
  ``finalize`` fallback) and the session against the reference's
  ``rescore``: the score gap per token under the cell's limit, every served
  token inside its prefix's top ``beam`` (rank gap 0);
- ``lm_weight`` 0 serves the tokens and scores of the same weights without
  an LM;
- without an LM the beam step is the one before the LM existed: for the
  transformer, the port's conformer and ESPnet's, a block's loop runs the
  same operations in the same order, calls the kernel wrappers as often and
  in the same order, and leaves every leaf of the state bit-equal to the
  record ``fixtures/torch_port_beam_step_no_lm.json`` (blessed on the
  commit before the LM: ``python tests/test_torch_cb_conformer_lm.py``;
  its operations and wrapper calls blessed again when kernel H took the
  cross-attention, whose twin builds the mask a layer: the state digests
  did not move);
- an ESPnet ``TransformerLM`` state dict (``lm.*`` keys, built here from
  the reference's tree), in the ASR checkpoint or a file of its own, loads
  into that tree and decodes as it does;
- the check has teeth: the LM fed its rows at the wrong lane, or left out
  of the joint score, fails it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.harness import weights
from benchmark.reference import cb_conformer_lm as lmr
from speechcatcher_tpu_torch.config import ModelConfig, tiny_config
from speechcatcher_tpu_torch.decode import beam_search as bs
from speechcatcher_tpu_torch.decode import ctc_prefix, graphs
from speechcatcher_tpu_torch.models import decoder as decoder_module
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.models.lm import init_lm_cache, lm_step
from speechcatcher_tpu_torch.params import random_params, tree_leaves, tree_map
from speechcatcher_tpu_torch.serve.engine import StreamingEngine
from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

from test_torch_cb_conformer import SCHEDULE, serve

FIXTURE = (Path(__file__).parent / "fixtures"
           / "torch_port_beam_step_no_lm.json")
BEAM = 3
FRONTEND = dict(n_fft=512, win_length=512, hop_length=128)
LM = dict(lm_layers=2, lm_dim=16, lm_heads=2, lm_linear_units=32,
          lm_embed_dim=8, lm_weight=0.3)
CB = "contextual_block_conformer"

# The LM step's log-probabilities against the full forward's: both float32,
# the port's rows through the fused norm's and the lane attention's plain
# twins (the K projection folded into the query, the V projection after
# the weighted sum), the reference's through whole-sequence products; the
# two sum in another order and read 1e-6 apart (9.5e-7) over 20 positions
# of log-probabilities of about -3.5. The same reference in TF32 reads
# 1e-3 off (``test_the_lm_tolerance_has_teeth``).
LOGP_ATOL = 1e-5
# A served final's score gap per token, the cell's own limit: float32 gaps
# read 1e-7 to 1e-6 a token.
SCORE_GAP = 1e-5


def config(lm: bool = True, **kw) -> ModelConfig:
    return tiny_config(encoder_type=CB, macaron_style=True,
                       conformer_kernel_size=3, **FRONTEND,
                       **((LM if lm else {}) | kw))


# Emission biases under which the tiny models serve varied tokens, 25 to
# 35 a stream (at EOS +2 they commit EOS after a token or two).
BIASES = {"eos": -2.0, "blank": 4.0}


def tree_of(cfg: ModelConfig, seed: int):
    """The reference's layout drawn from `seed`, then no sub-block an
    identity: LayerNorm affines drawn, every bias moved."""
    m = dataclasses.asdict(cfg)
    tree = weights.make_tree(m, BIASES, seed, "cpu", lmr.weight_specs)
    g = torch.Generator().manual_seed(seed)

    def walk(node, path=""):
        for k, v in node.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                walk(v, p)
            elif k in ("bias", "running_mean"):
                v.add_(torch.rand(v.shape, generator=g) * 0.2 - 0.1)
            elif k == "running_var":
                v.copy_(torch.rand(v.shape, generator=g) * 1.5 + 0.5)
            elif k == "weight" and "norm" in path:
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)

    walk(tree)
    return m, tree


def model_of(cfg, tree) -> ASRModel:
    tree = weights.to_numpy(tree)
    if not cfg.lm_layers:
        tree.pop("lm")
    return ASRModel.from_numpy(cfg, tree, device="cpu")


# ---------------------------------------------------------------------------
# The LM step against the full causal forward
# ---------------------------------------------------------------------------

def lm_step_against_forward(reference_ctx=None, steps: int = 20):
    """Run the port's LM step over S = 2 streams of B = 3 hypotheses for
    `steps` positions. At each step row b of a stream stands for the
    hypothesis perm[t][b], so a hypothesis' history lies at lanes that
    change from step to step, as after beam pruning; returns the largest
    gap between a row's log-probabilities and the reference's full forward
    over that hypothesis' prefix (within `reference_ctx`)."""
    cfg = config()
    m, tree = tree_of(cfg, 5)
    model = model_of(cfg, tree)
    s_dim, b_dim = 2, 3
    n = s_dim * b_dim
    rng = np.random.default_rng(3)
    ys = rng.integers(1, cfg.vocab_size - 1, size=(s_dim, b_dim, steps))
    ys[:, :, 0] = cfg.sos_id
    perm = [rng.permutation(b_dim) for _ in range(steps)]
    inv = [np.argsort(p) for p in perm]
    cache = init_lm_cache(cfg, n, torch.device("cpu"))
    lm = lmr.LanguageModel(tree["lm"], cfg.lm_heads)
    with reference_ctx or torch.no_grad():
        want = {(s, h): lm.logp(ys[s, h]).numpy()
                for s in range(s_dim) for h in range(b_dim)}
    worst = 0.0
    for t in range(steps):
        lane = np.zeros((s_dim, b_dim, cfg.max_tokens), np.int32)
        for b in range(b_dim):
            lane[:, b, :t] = [inv[u][perm[t][b]] for u in range(t)]
        tokens = torch.tensor([ys[s, perm[t][b], t] for s in range(s_dim)
                               for b in range(b_dim)])
        with torch.no_grad():
            got = lm_step(model.params["lm"], cache, tokens,
                          torch.full((n,), t), torch.from_numpy(lane),
                          torch.ones(n, dtype=torch.bool), cfg).numpy()
        for s in range(s_dim):
            for b in range(b_dim):
                gap = np.abs(got[s * b_dim + b] - want[s, perm[t][b]][t])
                worst = max(worst, float(gap.max()))
    return worst


def test_lm_step_matches_the_full_causal_forward():
    assert lm_step_against_forward() < LOGP_ATOL


def test_the_lm_tolerance_has_teeth():
    assert lm_step_against_forward(lmr.in_tf32()) > 10 * LOGP_ATOL


# ---------------------------------------------------------------------------
# Served finals against the reference's rescore
# ---------------------------------------------------------------------------

def session_final(cfg, tree, chunks):
    s2t = Speech2TextStreaming(model=model_of(cfg, tree), beam_size=BEAM,
                               device="cpu")
    for c in chunks[:-1]:
        s2t(c)
    s2t.feed(chunks[-1], is_final=True)
    yseq, xpos, score = s2t.beam_search.best_hypothesis()
    return yseq.astype(np.int64), xpos.astype(np.int64), float(score)


def readings(ref, finals, chunks):
    """Largest score gap per token and rank gap of the finals, and their
    tokens."""
    score_gap = rank_gap = 0.0
    tokens = 0
    for k, (yseq, xpos, score) in finals.items():
        enc = ref.encode(chunks[k])
        r = ref.rescore(enc, ref.ctc_logp(enc), yseq, xpos, BEAM)
        n = len(yseq) - 1
        tokens += n
        score_gap = max(score_gap, abs(r.score - score) / max(n, 1))
        if len(r.token_gaps):
            rank_gap = max(rank_gap, float(r.token_gaps.max()))
    return score_gap, rank_gap, tokens


@pytest.fixture(scope="module")
def served():
    cfg = config()
    m, tree = tree_of(cfg, 21)
    finals, _, chunks = serve(cfg, tree)
    finals["session"] = session_final(cfg, tree, chunks["a"])
    chunks["session"] = chunks["a"]
    return cfg, m, tree, finals, chunks


def test_engine_and_session_match_the_reference(served):
    cfg, m, tree, finals, chunks = served
    # The session and the engine serve stream a alike.
    ey, ex, es = finals["a"]
    sy, sx, ss = finals["session"]
    assert np.array_equal(ey, sy) and np.array_equal(ex, sx)
    assert abs(es - ss) < 1e-4
    score_gap, rank_gap, tokens = readings(lmr.Reference(m, tree, "cpu"),
                                           finals, chunks)
    assert tokens >= 80
    assert score_gap < SCORE_GAP
    assert rank_gap == 0.0


def test_the_check_fails_without_the_lm_term(served):
    """The reference without the LM term in the joint score (the program
    left as served): the check refuses the finals."""
    cfg, m, tree, finals, chunks = served
    ref = lmr.Reference(m, tree, "cpu")
    ref.lm_weight = 0.0
    score_gap, _, _ = readings(ref, finals, chunks)
    assert score_gap > 100 * SCORE_GAP


def test_an_lm_fed_at_the_wrong_lane_is_caught(monkeypatch):
    """A planted fault: the LM reads its history rows at the next lane
    over, not at the beam's; the reference's readings refuse its finals."""
    cfg = config()
    m, tree = tree_of(cfg, 21)

    def wrong_lane(params, cache, tokens, pos, lane, write, cfg):
        return lm_step(params, cache, tokens, pos,
                       (lane + 1) % lane.shape[1], write, cfg)

    monkeypatch.setattr(bs, "lm_step", wrong_lane)
    finals, _, chunks = serve(cfg, tree)
    score_gap, rank_gap, _ = readings(lmr.Reference(m, tree, "cpu"),
                                      finals, chunks)
    assert score_gap > 10 * SCORE_GAP or rank_gap > 0.0


def test_lm_weight_zero_serves_the_model_without_an_lm():
    with_lm = config(lm_weight=0.0)
    _, tree = tree_of(with_lm, 21)
    got, _, _ = serve(with_lm, tree)
    want, _, _ = serve(config(lm=False), tree)
    for k in SCHEDULE:
        assert np.array_equal(got[k][0], want[k][0]), k
        assert np.array_equal(got[k][1], want[k][1]), k
        assert got[k][2] == want[k][2], k


# ---------------------------------------------------------------------------
# Without an LM, the beam step of before
# ---------------------------------------------------------------------------

NO_LM_CASES = {
    "transformer": dict(),
    "conformer": dict(encoder_type="conformer"),
    "cb_conformer": dict(encoder_type=CB, macaron_style=True,
                         conformer_kernel_size=3, **FRONTEND),
}
# The kernel wrappers a beam step calls, by the name of the module
# attribute the step reaches them through.
WRAPPERS = ((decoder_module, "add_layer_norm", "F"),
            (decoder_module, "lane_attention", "G"),
            (decoder_module, "cross_attention", "H"),
            (ctc_prefix, "ctc_forward_recursion_streams", "B"),
            (ctc_prefix, "ring_append_cols", "C"))


class _OpLog(TorchDispatchMode):
    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.log.append(str(func))
        return func(*args, **(kwargs or {}))


def no_lm_record(case: str, mp) -> dict:
    """One block of a tiny model's beam loop (two streams, one of them in
    its final block): ``block_extend`` over seeded frames, then
    ``decode_block_device``. Returns digests of the operations it ran (the
    wrappers' calls among them, in order), the wrappers' call counts and a
    digest of every leaf of the state it left."""
    cfg = tiny_config(**NO_LM_CASES[case])
    tree = random_params(cfg, 7)
    tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += 2.0
    model = ASRModel.from_numpy(cfg, tree, device="cpu")
    log: list = []
    for module, name, mark in WRAPPERS:
        def wrapped(*a, _fn=getattr(module, name), _mark=mark, **kw):
            log.append(_mark)
            return _fn(*a, **kw)

        mp.setattr(module, name, wrapped)
    s_dim, n_new = 2, cfg.block_size
    gen = torch.Generator().manual_seed(11)
    frames = torch.randn((s_dim, n_new, cfg.encoder_dim), generator=gen)
    memory = torch.zeros((s_dim, 64, cfg.encoder_dim))
    memory[:, :n_new] = frames
    state = bs.fresh_block_state(cfg, s_dim, BEAM, torch.device("cpu"))
    stepping = torch.ones(s_dim, dtype=torch.bool)
    with torch.no_grad(), _OpLog(log):
        st = bs.block_extend(model.params, state, frames,
                             torch.full((s_dim,), n_new), stepping)
        st = bs.decode_block_device(
            model.params, model.dec_pe, memory, st,
            torch.full((s_dim,), n_new), torch.tensor([False, True]), cfg,
            BEAM, cfg.pre_beam_size, 0.3, True, 12)
    state_hash = hashlib.sha256()
    for leaf in graphs.tree_leaves(st):
        state_hash.update(f"{leaf.dtype} {tuple(leaf.shape)}".encode())
        state_hash.update(leaf.contiguous().numpy().tobytes())
    return {"ops": hashlib.sha256("\n".join(log).encode()).hexdigest(),
            "n_ops": len(log),
            "wrappers": {mark: log.count(mark) for _, _, mark in WRAPPERS},
            "steps": int(st.process_idx.max()),
            "state": state_hash.hexdigest()}


@pytest.mark.parametrize("case", sorted(NO_LM_CASES))
def test_without_an_lm_the_beam_step_is_the_one_before(case, monkeypatch):
    want = json.loads(FIXTURE.read_text())[case]
    got = no_lm_record(case, monkeypatch)
    assert got["wrappers"] == want["wrappers"]
    assert got["n_ops"] == want["n_ops"]
    assert got["ops"] == want["ops"]
    assert got["state"] == want["state"]
    assert got["steps"] >= 2


def test_with_an_lm_the_step_adds_its_layers_kernels(monkeypatch):
    """A step with the LM adds the LM's 2L + 1 norms (kernel F) and its L
    lane attentions (kernel G) to the decoder's 3L + 1 and L."""
    cfg = config()
    _, tree = tree_of(cfg, 5)
    model = model_of(cfg, tree)
    calls = {"F": 0, "G": 0}
    for module, name, mark in WRAPPERS[:2]:
        def wrapped(*a, _fn=getattr(module, name), _mark=mark, **kw):
            calls[_mark] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)
    from speechcatcher_tpu_torch.models import lm as lm_module
    monkeypatch.setattr(lm_module, "add_layer_norm",
                        decoder_module.add_layer_norm)
    state = bs.fresh_block_state(cfg, 1, BEAM, torch.device("cpu"))
    memory = torch.randn((1, 16, cfg.encoder_dim))
    cross_kv = decoder_module.project_cross_kv(
        model.params["decoder"], memory, cfg.decoder_heads, torch.float32)
    with torch.no_grad():
        bs._beam_step_core(
            model.params, model.dec_pe, cross_kv, state.dec_cache,
            state.arrays, torch.tensor([16]), torch.tensor([True]), cfg,
            BEAM, cfg.pre_beam_size, 0.3, True, 0.0, state.lm_cache,
            cfg.lm_weight)
    assert calls == {"F": 3 * cfg.decoder_layers + 1 + 2 * cfg.lm_layers + 1,
                     "G": cfg.decoder_layers + cfg.lm_layers}


# ---------------------------------------------------------------------------
# ESPnet's TransformerLM state dict
# ---------------------------------------------------------------------------

def espnet_lm_state_dict(lm_tree) -> dict:
    """The ``lm.*`` keys ``ESPnetLanguageModel`` saves, from a numpy ``lm``
    subtree (the inverse of ``checkpoint.convert_lm_state_dict``)."""
    sd = {"lm.embed.weight": lm_tree["embed"]["weight"]}
    for path, leaf in tree_leaves(lm_tree["input_layer"]):
        part, key = path.strip("/").split("/")
        sd[f"lm.encoder.embed.{('out', 'norm').index(part)}.{key}"] = leaf
    for path, leaf in tree_leaves(lm_tree["layers"]):
        key = path.strip("/").replace("/", ".")
        for i in range(leaf.shape[0]):
            sd[f"lm.encoder.encoders.{i}.{key}"] = leaf[i]
    for part, prefix in (("after_norm", "lm.encoder.after_norm"),
                         ("output_layer", "lm.decoder")):
        for key, leaf in lm_tree[part].items():
            sd[f"{prefix}.{key}"] = leaf
    return sd


def test_an_espnet_lm_state_dict_loads_and_decodes_as_the_tree(
        tmp_path, served):
    """The LM's keys in the ASR checkpoint, or in ESPnet's LM file beside
    it, load into the reference's tree leaf for leaf, with the LM's widths
    read from the shapes over a configuration that gives its heads and
    weight, and the loaded model serves the tree's finals."""
    from chip_smoke import espnet_state_dict
    from speechcatcher_tpu_torch.checkpoint import load_espnet_checkpoint

    cfg, _, tree, finals, _ = served
    want = weights.to_numpy(tree)
    lm_sd = espnet_lm_state_dict(want["lm"])
    asr_sd = espnet_state_dict(want, cfg)

    def save(name, sd):
        path = tmp_path / name
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   path)
        return path

    widths = ("lm_layers", "lm_dim", "lm_embed_dim", "lm_linear_units")
    given = cfg.replace(**{k: 0 for k in widths})
    loads = [load_espnet_checkpoint(save("asr_lm.pth", asr_sd | lm_sd),
                                    cfg=given),
             load_espnet_checkpoint(save("asr.pth", asr_sd), cfg=given,
                                    lm_checkpoint_path=save("lm.pth", lm_sd))]
    for params, got_cfg, arch in loads:
        assert got_cfg == cfg
        assert {k: arch[k] for k in widths} == {k: getattr(cfg, k)
                                               for k in widths}
        got = dict(tree_leaves(params["lm"]))
        assert got.keys() == dict(tree_leaves(want["lm"])).keys()
        for path, leaf in tree_leaves(want["lm"]):
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    got_finals, _, _ = serve(cfg, tree_map(torch.from_numpy, loads[1][0]))
    for k in SCHEDULE:
        assert np.array_equal(got_finals[k][0], finals[k][0]), k
        assert got_finals[k][2] == finals[k][2], k


def test_a_state_dict_with_an_lm_needs_its_heads(tmp_path, served):
    from chip_smoke import espnet_state_dict
    from speechcatcher_tpu_torch.checkpoint import load_espnet_checkpoint

    cfg, _, tree, _, _ = served
    want = weights.to_numpy(tree)
    path = tmp_path / "asr_lm.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                (espnet_state_dict(want, cfg)
                 | espnet_lm_state_dict(want["lm"])).items()}, path)
    with pytest.raises(ValueError, match="lm_conf"):
        load_espnet_checkpoint(path, cfg=config(lm=False))


def bless() -> None:
    """Write the record of the beam step without an LM, from the tree this
    runs in (the commit before the LM)."""
    with pytest.MonkeyPatch.context() as mp:
        out = {case: no_lm_record(case, mp) for case in sorted(NO_LM_CASES)}
    FIXTURE.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    sys.exit(bless())


# ---------------------------------------------------------------------------
# What the LM does not cover is refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_a_precision_mode_is_refused(dtype):
    cfg = config()
    _, tree = tree_of(cfg, 5)
    with pytest.raises(ValueError, match="float32"):
        Speech2TextStreaming(model=model_of(cfg, tree), dtype=dtype,
                             device="cpu")
    with pytest.raises(ValueError, match="float32"):
        StreamingEngine(model_of(cfg.replace(cache_dtype="bfloat16"), tree),
                        n_slots=2, device="cpu")


def test_tensor_parallelism_is_refused(monkeypatch):
    from speechcatcher_tpu_torch.models import lm as lm_module

    cfg = config()
    _, tree = tree_of(cfg, 5)
    monkeypatch.setattr(lm_module, "tp_size", lambda: 2)
    with pytest.raises(ValueError, match="tp group"):
        StreamingEngine(model_of(cfg, tree), n_slots=2, device="cpu")
