"""The sharded serving engine: the port's ``shard_engine`` against the JAX
package's on the same weights and audio, on the CPU.

dp: one process, four engine replicas on ``[cpu] * 4`` ticking on their
own threads, against JAX's engine over a 4-device mesh. dp 2 × tp 2: four
gloo ranks (``parallel.launch.run_ranks``), one engine per tp pair serving
its dp block of the slots, against JAX's dp2×tp2 engine. Finals must be
token- and position-exact, as the JAX package's own sharded engine tests
demand of its sharded engine.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_common import jax_config, jax_model, synth_audio

from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.parallel.launch import run_ranks
from speechcatcher_tpu_torch.parallel.mesh import make_mesh
from speechcatcher_tpu_torch.parallel.serve_sharding import (
    ShardedEngine,
    shard_engine,
)
from speechcatcher_tpu_torch.serve.engine import StreamingEngine

CHUNK = 8192
CPU = torch.device("cpu")


def _jax_tree(seed):
    from speechcatcher_tpu.models.asr_model import ASRModel as JaxModel

    model = JaxModel.random_init(jax_config(tiny_config()), seed=seed)
    return jax.tree.map(np.asarray, model.params)


def _audios(n, n_chunks, seed0):
    return [synth_audio(n_chunks * CHUNK / 16000 + 0.01, seed=seed0 + k)
            for k in range(n)]


def _jax_finals(tree, audios, n_chunks, n_dev, tp):
    """JAX's shard_engine over make_mesh(n_dev, tp): one slot per stream,
    n_chunks - 1 ticks, then finalize."""
    from speechcatcher_tpu.parallel.mesh import make_mesh as jax_mesh
    from speechcatcher_tpu.parallel.serve_sharding import (
        shard_engine as jax_shard,
    )
    from speechcatcher_tpu.serve.engine import StreamingEngine as JaxEngine

    model = jax_model(tiny_config(), tree)
    mesh = jax_mesh(n_dev, tp=tp)
    engine = jax_shard(JaxEngine(model, n_slots=len(audios), beam_size=2,
                                 chunk_samples=CHUNK), mesh)
    with jax.set_mesh(mesh):
        slots = [engine.acquire_slot() for _ in audios]
        for i in range(n_chunks - 1):
            engine.tick({s: audios[k][i * CHUNK:(i + 1) * CHUNK]
                         for k, s in enumerate(slots)})
        out = [engine.finalize(s, audios[k][(n_chunks - 1) * CHUNK:])
               for k, s in enumerate(slots)]
    return {k: (np.asarray(y).tolist(), np.asarray(x).tolist())
            for k, (y, x, _) in enumerate(out)}


def test_dp_engine_matches_jax_shard_engine():
    """4 streams, 3 chunks, tiny config seed 6: four replicas of one slot
    each on [cpu] * 4."""
    tree = _jax_tree(6)
    audios = _audios(4, 3, 30)
    want = _jax_finals(tree, audios, 3, 4, 1)

    model = ASRModel.from_numpy(tiny_config(), tree, device="cpu")
    engine = shard_engine(
        StreamingEngine(model, n_slots=4, beam_size=2, chunk_samples=CHUNK,
                        device="cpu"), make_mesh(4, devices=[CPU] * 4))
    assert isinstance(engine, ShardedEngine)
    assert [r.S for r in engine.replicas] == [1, 1, 1, 1]
    slots = [engine.acquire_slot() for _ in audios]
    assert sorted(slots) == [0, 1, 2, 3]
    assert engine.acquire_slot() is None
    assert engine.c.active.all()
    for i in range(2):
        engine.tick({s: audios[k][i * CHUNK:(i + 1) * CHUNK]
                     for k, s in enumerate(slots)})
    tails = {s: audios[k][2 * CHUNK:] for k, s in enumerate(slots[:3])}
    res = engine.finalize_batch(tails)
    res[slots[3]] = engine.finalize(slots[3], audios[3][2 * CHUNK:])
    got = {k: (np.asarray(res[s][0]).tolist(), np.asarray(res[s][1]).tolist())
           for k, s in enumerate(slots)}
    assert got == want
    assert not engine.c.active.any() and engine.quarantined == 0
    engine.close()


def test_dp2_tp2_engine_matches_jax(tmp_path):
    """2 streams, 2 chunks, seed 13: rank pairs (0, 1) and (2, 3) each serve
    one slot at tp=2; both ranks of a pair return the same finals."""
    tree = _jax_tree(13)
    audios = _audios(2, 2, 50)
    want = _jax_finals(tree, audios, 2, 4, 2)
    out = run_ranks(ranks.engine_finals, 4, str(tmp_path / "rdv"),
                    timeout=120,
                    args=(tiny_config(), tree, audios, 2, CHUNK, 2, 2))
    assert out[0] == out[1] == {0: want[0]}
    assert out[2] == out[3] == {1: want[1]}


def test_replica_threads_count_every_launch():
    """Two threads bump one launch counter 20 000 times each; the lock in
    ``_plan.count`` loses none."""
    from speechcatcher_tpu_torch.ops.kernels import _plan
    from speechcatcher_tpu_torch.ops.kernels.ring_append import (
        ring_append_rows,
    )

    before = ring_append_rows.launches

    def bump():
        for _ in range(20000):
            _plan.count(ring_append_rows)

    threads = [threading.Thread(target=bump) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ring_append_rows.launches - before == 40000
    ring_append_rows.launches = before


def test_shard_engine_needs_dp_to_divide_the_slots():
    model = ASRModel.from_numpy(tiny_config(), _jax_tree(6), device="cpu")
    engine = StreamingEngine(model, n_slots=3, beam_size=2,
                             chunk_samples=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        shard_engine(engine, make_mesh(2, devices=[CPU] * 2))
