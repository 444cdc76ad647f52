"""Multi-card serving: the streaming engine's slot axis over a mesh.

Port of ``speechcatcher_tpu/parallel/serve_sharding.py``. The serving hot
path is pure data parallelism: every per-stream buffer lives with its slot,
weights replicate, and a tick exchanges nothing between cards. JAX
partitions one SPMD program over the mesh; PyTorch has no such program, so
``shard_engine`` gives a ``ShardedEngine`` that holds one
``StreamingEngine`` replica per dp row this process drives, each with S/dp
slots on its own device (a device may repeat: two replicas can share a
card). Global slot s lives on replica s // (S/dp) at local slot
s % (S/dp), the block layout of ``P("dp")`` on the slot axis. The replicas
tick concurrently, one host thread each; the engine keeps no per-thread
state. On the card each replica runs its own CUDA graphs (captured in
thread-local mode); ``shard_engine`` captures them replica after replica
before the first tick.

Under tp > 1 (one process per card, ``parallel.mesh``) every rank of a tp
group calls ``shard_engine``: the engine's model takes the rank's shards,
the process's tp group is set (``parallel.tp``), and each rank runs the
same host bookkeeping on the same audio. The ranks decide alike because the
logits are gathered before any decision. This engine keeps the eager host
loop, by configuration (``StreamingEngine.graphed`` is false under a tp
group): its collectives are gloo through host memory, which a CUDA graph
cannot capture.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import tree_map
from speechcatcher_tpu_torch.parallel.mesh import Mesh, shard_params
from speechcatcher_tpu_torch.parallel.tp import set_tp_group
from speechcatcher_tpu_torch.serve.engine import StreamingEngine


def model_to(model: ASRModel, device: torch.device) -> ASRModel:
    """A copy of the model with every tensor on `device` (the same model
    where it already lies there)."""
    device = torch.device(device)
    if model.device == device:
        return model
    frontend = copy.copy(model.frontend)
    for k, v in vars(frontend).items():
        if isinstance(v, torch.Tensor):
            setattr(frontend, k, v.to(device))
    frontend.device = device
    return ASRModel(
        cfg=model.cfg,
        params=tree_map(lambda x: x.to(device), model.params),
        frontend=frontend, tokenizer=model.tokenizer,
        enc_pe=model.enc_pe.to(device), dec_pe=model.dec_pe.to(device),
        device=device)


def _replica(engine: StreamingEngine, model: ASRModel, n_slots: int,
             device: torch.device) -> StreamingEngine:
    """An engine like `engine` over `model` with `n_slots` slots."""
    return StreamingEngine(
        model, n_slots=n_slots, beam_size=engine.beam,
        ctc_weight=engine.ctc_weight, use_bbd=engine.use_bbd,
        chunk_samples=engine.A, pre_beam_size=engine.pre_beam,
        penalty=engine.penalty, max_length=engine.max_length,
        eos_commit=engine.eos_commit, device=device,
        lm_weight=engine.lm_weight)


class _Counters:
    """``engine.c`` of a ShardedEngine: ``active`` by slot of this process
    (a fresh array, read-only)."""

    def __init__(self, owner: "ShardedEngine"):
        self._owner = owner

    @property
    def active(self) -> np.ndarray:
        return np.concatenate([r.c.active for r in self._owner.replicas])


class ShardedEngine:
    """This process's block of a sharded engine's slot axis.

    Offers what the server and ``recognize.py`` read of a StreamingEngine,
    with the same meaning, over slots 0 .. S-1 of this process; ``slot_base``
    is the global index of its slot 0 (nonzero for a later host or dp
    group)."""

    def __init__(self, model: ASRModel, replicas: List[StreamingEngine],
                 slot_base: int = 0):
        self.model = model
        self.replicas = replicas
        self.per = replicas[0].S
        self.S = self.per * len(replicas)
        self.A = replicas[0].A
        self.cfg = model.cfg
        self.slot_base = slot_base
        self.c = _Counters(self)
        self._pool = (ThreadPoolExecutor(len(replicas),
                                         thread_name_prefix="replica")
                      if len(replicas) > 1 else None)

    def _where(self, s: int):
        return self.replicas[s // self.per], s % self.per

    @staticmethod
    def _on(r: StreamingEngine):
        """The replica's card as the current device of the calling thread
        (kernels launch on the current device)."""
        if r.device.type == "cuda":
            return torch.cuda.device(r.device)
        return contextlib.nullcontext()

    def _call(self, r: StreamingEngine, name: str, *args):
        with self._on(r):
            return getattr(r, name)(*args)

    def _each(self, name: str, by_slot: Dict[int, object]) -> dict:
        """Call `name` on every replica that has slots in `by_slot` with its
        local {slot: value}, concurrently; results keyed by slot."""
        parts: Dict[int, dict] = {}
        for s, v in by_slot.items():
            i, local = s // self.per, s % self.per
            parts.setdefault(i, {})[local] = v
        if self._pool is None or len(parts) == 1:
            done = {i: self._call(self.replicas[i], name, part)
                    for i, part in parts.items()}
        else:
            futures = {i: self._pool.submit(self._call, self.replicas[i],
                                            name, part)
                       for i, part in parts.items()}
            done = {i: f.result() for i, f in futures.items()}
        return {i * self.per + local: v
                for i, out in done.items() for local, v in out.items()}

    # Ticks and finals ---------------------------------------------------
    def tick(self, audio: Dict[int, np.ndarray]) -> Dict[int, List[int]]:
        return self._each("tick", audio)

    def finalize_batch(self, finals: Dict[int, Optional[np.ndarray]]):
        return self._each("finalize_batch", finals)

    def finalize(self, s: int, last_audio: Optional[np.ndarray] = None):
        r, local = self._where(s)
        return self._call(r, "finalize", local, last_audio)

    # Slots --------------------------------------------------------------
    def acquire_slot(self) -> Optional[int]:
        """A free slot on the replica with the most free slots (the first
        of those), or None."""
        free = [int((~r.c.active).sum()) for r in self.replicas]
        i = int(np.argmax(free))
        if free[i] == 0:
            return None
        s = self._call(self.replicas[i], "acquire_slot")
        return i * self.per + s

    def release_slot(self, s: int):
        r, local = self._where(s)
        self._call(r, "release_slot", local)

    def slot_would_stall(self, s: int) -> bool:
        r, local = self._where(s)
        return r.slot_would_stall(local)

    def partial_tokens(self, s: int) -> List[int]:
        r, local = self._where(s)
        return self._call(r, "partial_tokens", local)

    def partial_result(self, s: int):
        r, local = self._where(s)
        return self._call(r, "partial_result", local)

    # Accounting ---------------------------------------------------------
    def hbm_bytes_per_stream(self) -> Dict[str, int]:
        return self.replicas[0].hbm_bytes_per_stream()

    def graph_bytes_per_stream(self) -> Dict[str, int]:
        return self.replicas[0].graph_bytes_per_stream()

    @property
    def quarantined(self) -> int:
        return sum(r.quarantined for r in self.replicas)

    def capture_graphs(self) -> None:
        """Capture every replica's tick graphs, one replica after the
        other, each under its own card."""
        for r in self.replicas:
            self._call(r, "capture_graphs")

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()


def shard_engine(engine: StreamingEngine, mesh: Mesh) -> ShardedEngine:
    """This process's part of `engine` sharded over `mesh`: the slot axis
    over "dp", the weights replicated (tp = 1) or tensor-parallel over "tp"
    (column/row rules of ``parallel.mesh``). dp must divide the engine's
    slots. The engine given is consumed: its model takes the shards under
    tp > 1, and its slots move to the replicas."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    if engine.S % dp:
        raise ValueError(f"dp={dp} does not divide the engine's "
                         f"{engine.S} slots")
    per = engine.S // dp
    model = engine.model
    if tp == 1:
        rows = mesh.local_rows()
        if not rows:
            raise ValueError(f"rank {mesh.rank} drives no row of {mesh}")
        replicas = [_replica(engine, model_to(model, dev), per, dev)
                    for _, dev in rows]
        sharded = ShardedEngine(model, replicas, rows[0][0] * per)
        sharded.capture_graphs()
        return sharded
    model.params = shard_params(model.params, mesh)
    set_tp_group(mesh.tp_group)
    dev = mesh.device
    # A fresh engine: the given one's finalizer holds the whole weights.
    replica = _replica(engine, model_to(model, dev), per, dev)
    return ShardedEngine(model, [replica], mesh.coord[0] * per)
