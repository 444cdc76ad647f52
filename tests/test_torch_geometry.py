"""The streaming geometry (``speechcatcher_tpu_torch.geometry``) of an
engine tick, on random counter states, against its reference: the JAX
engine's ``_encode_bookkeeping`` at window 400 / hop 160, and the STFT's
own frame count at ESPnet's window 512 / hop 128, where the JAX engine's
count (``n_frames + 2``, written for 400 / 160) is wrong.

States are drawn where a stream's counters can lie: a waveform carry of at
most a window, a feature residue under three strides, a subsampled carry
of at most a block, any ring fill. Each case draws its states from its own
seed; every integer must be equal.
"""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_common import jax_config

from speechcatcher_tpu.serve.engine import StreamingEngine as JaxEngine
from speechcatcher_tpu_torch import geometry
from speechcatcher_tpu_torch.config import (
    ModelConfig,
    flagship_config,
    tiny_config,
)
from speechcatcher_tpu_torch.ops.frontend import frame_signal

ROOT = Path(__file__).resolve().parents[1]
N_STATES = 200
S = 8


def _config(name: str) -> ModelConfig:
    if name == "tiny":
        return tiny_config()
    if name == "flagship":
        return flagship_config()
    spec = json.loads(
        (ROOT / "benchmark/configs/aishell-cb-conformer.json").read_text())
    return ModelConfig(**spec["model"])


def _jax_engine(cfg: ModelConfig, chunk: int) -> JaxEngine:
    """The JAX engine's host side: its bookkeeping reads the config, the
    counters and the capacities, never the weights."""
    model = types.SimpleNamespace(cfg=jax_config(cfg),
                                  params={"encoder": {}}, enc_pe=None)
    return JaxEngine(model, n_slots=S, beam_size=2, chunk_samples=chunk)


def _states(cfg: ModelConfig, ecap: int, rng: np.random.Generator):
    for _ in range(N_STATES):
        npb = np.where(rng.random(S) < 0.3, 0, rng.integers(1, 40, S))
        yield dict(
            wave_len=rng.integers(0, cfg.win_length + 1, S),
            first_wave=rng.random(S) < 0.3,
            raw_len=rng.integers(0, 3 * cfg.subsample, S),
            post_len=rng.integers(0, cfg.block_size + 1, S),
            npb=npb, has_prev=npb > 0, has_past=npb > 0,
            buf_len=rng.integers(0, ecap + 1, S),
        ), rng.random(S) < 0.8


def _stft_frames(n_process: int, cfg: ModelConfig) -> int:
    x = torch.zeros((1, n_process))
    return frame_signal(x, cfg.n_fft, cfg.hop_length).shape[1]


@pytest.mark.parametrize("name, chunk, reference, seed", [
    ("tiny", 8192, "jax", 1),
    ("tiny", 1000, "jax", 2),
    ("flagship", 8192, "jax", 3),
    ("flagship", 2048, "jax", 4),
    ("aishell-cb-conformer", 8192, "stft", 5),
    ("aishell-cb-conformer", 2000, "stft", 6),
])
def test_the_tick_plan_matches_its_reference(name, chunk, reference, seed):
    cfg = _config(name)
    caps = geometry.engine_capacities(cfg, chunk)
    rng = np.random.default_rng(seed)
    jax_eng = _jax_engine(cfg, chunk) if reference == "jax" else None
    if jax_eng is not None:
        assert tuple(caps) == (
            jax_eng.WCAP, jax_eng.FCAP, jax_eng.RCAP, jax_eng.SUBCAP,
            jax_eng.MAXB, jax_eng.PCAP, jax_eng.ECAP, jax_eng.EXTCAP,
            jax_eng.ECAP_PAD)
    frames_of: dict = {}
    n_run = 0
    for c, do in _states(cfg, caps.ECAP, rng):
        fe, sp, bp = geometry.plan_streams(
            cfg, c["wave_len"], np.where(do, chunk, 0), c["first_wave"],
            c["raw_len"], c["post_len"], c["npb"], False, caps.MAXB)
        n_run += int((fe.n_process > 0).sum())
        if jax_eng is None:
            # The frames kept are the STFT's over the samples processed,
            # whole hops after the window's overlap, less the cuts.
            n = c["wave_len"] + np.where(do, chunk, 0)
            overlap = cfg.win_length - cfg.hop_length
            runs = n > cfg.win_length
            proc_len = np.where(runs, n - (n - overlap) % cfg.hop_length, 0)
            np.testing.assert_array_equal(fe.n_process, proc_len)
            for i in np.flatnonzero(runs):
                p = int(proc_len[i])
                if p not in frames_of:
                    frames_of[p] = _stft_frames(p, cfg)
                assert frames_of[p] == 1 + p // cfg.hop_length
                assert fe.n_frames[i] == max(
                    frames_of[p] - fe.lo[i] - fe.hi[i], 0)
            assert not fe.n_frames[~runs].any()
            continue
        for field, value in c.items():
            setattr(jax_eng.c, field, value)
        bk = jax_eng._encode_bookkeeping(do)
        ours = [c["wave_len"], fe.lo, fe.keep_from, fe.n_keep, c["raw_len"],
                fe.n_frames, sp.n_in - sp.n_keep, c["post_len"], sp.n_sub,
                bp.block_num, c["has_prev"], c["has_past"], c["buf_len"],
                c["npb"]]
        np.testing.assert_array_equal(
            np.stack(ours).astype(np.int32), bk["ints"])
        assert int(bp.block_num.max()) == bk["maxb"]
        for got, key in ((fe.n_keep, "keep_len"), (sp.n_keep, "n_res_raw"),
                         (bp.total, "post_total"), (bp.block_num, "bn"),
                         (bp.y_length, "emitted"),
                         (c["buf_len"] + bp.y_length, "buf_new")):
            np.testing.assert_array_equal(got, bk[key], err_msg=key)
    assert n_run > N_STATES  # the frontend ran in most states
