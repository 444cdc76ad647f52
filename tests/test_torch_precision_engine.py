"""The batched engine of the PyTorch port in the serving precisions against
the JAX package's on the CPU: the serving default of the JAX bench (bfloat16
weights by ``cast_params``; decoder cache, CTC log-prob ring and emitted-frame
ring stored in bfloat16) and the same with every eligible linear in int8,
for the transformer and the conformer encoder, fed over the mu-law wire.

Both engines run the staggered-churn script of ``test_torch_engine.py``;
every tick's partials and every final's tokens and token positions must be
equal, final scores within rel. 1e-4 (bfloat16 storage rounds alike on both
sides; the float32 sums run in another order). Each case runs both engines
once (a module-scoped cache) and two tests read the run.
"""

import copy
from typing import Dict

import numpy as np
import pytest
import torch

from test_torch_common import jax_model
from test_torch_conformer import _perturb
from test_torch_engine import CH, Script, staggered_churn

import speechcatcher_tpu.ops.layers as J
import speechcatcher_tpu_torch.ops.layers as P
from speechcatcher_tpu.serve.engine import StreamingEngine as JaxEngine
from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.serve.engine import StreamingEngine

SERVING_DTYPES = dict(cache_dtype="bfloat16", ctc_ring_dtype="bfloat16",
                      enc_ring_dtype="bfloat16")

# name: (encoder, int8 scope or "none")
ENGINE_CASES = {
    "serving_default-transformer": ("transformer", "none"),
    "serving_default-conformer": ("conformer", "none"),
    "int8_all-transformer": ("transformer", None),
    "int8_all-conformer": ("conformer", None),
}

_RUNS: Dict[str, tuple] = {}


def _serving_models(cfg, tree, scope):
    """Both packages' models as the JAX bench builds its serving model:
    cast weights, optionally int8 over `scope` ("none": no int8)."""
    jm = jax_model(cfg, copy.deepcopy(tree))
    pm = ASRModel.from_numpy(cfg, tree, device="cpu")
    jm.params, pm.params = J.cast_params(jm.params), P.cast_params(pm.params)
    if scope != "none":
        jm.params = J.quantize_params_int8(jm.params, scope=scope)
        pm.params = P.quantize_params_int8(pm.params, scope=scope)
    return jm, pm


def _run_engine_case(name):
    if name not in _RUNS:
        enc, scope = ENGINE_CASES[name]
        cfg = tiny_config(encoder_type=enc, conformer_kernel_size=7,
                          **SERVING_DTYPES)
        tree = random_params(cfg, 7)
        if enc == "conformer":
            _perturb(tree, 7)
        jm, pm = _serving_models(cfg, tree, scope)
        kw = dict(n_slots=3, beam_size=3, chunk_samples=CH, use_bbd=True)
        jax_sc = Script(JaxEngine(jm, **kw))
        staggered_churn(jax_sc, wire="mulaw")
        port_sc = Script(StreamingEngine(pm, device="cpu", **kw))
        staggered_churn(port_sc, wire="mulaw")
        _RUNS[name] = (jax_sc, port_sc)
    return _RUNS[name]


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_ticks_match_jax_in_serving_precision(name):
    jax_sc, port_sc = _run_engine_case(name)
    eng = port_sc.eng
    assert eng.dec_cache.h.dtype == torch.bfloat16
    assert eng.arrays.ctc.logp.dtype == torch.bfloat16
    assert eng.buffers.enc_out.dtype == torch.bfloat16
    ticks = [e for e in jax_sc.log if e[0] == "tick"]
    assert any(any(v for v in e[1].values()) for e in ticks)
    assert [e for e in port_sc.log if e[0] != "final"] == \
        [e for e in jax_sc.log if e[0] != "final"]


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_finals_match_jax_in_serving_precision(name):
    jax_sc, port_sc = _run_engine_case(name)
    j_finals = [e for e in jax_sc.log if e[0] == "final"]
    assert j_finals and all(len(e[2]) > 2 for e in j_finals)
    assert [e for e in port_sc.log if e[0] == "final"] == j_finals
    np.testing.assert_allclose(port_sc.scores, jax_sc.scores, rtol=1e-4)
