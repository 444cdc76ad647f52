"""Multi-card dry run on the CPU: one dp × tp training step over n gloo
ranks (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

``python -m speechcatcher_tpu_torch.parallel.dryrun 4`` starts 4 ranks as
fresh processes, builds a (dp, tp) mesh with tp = 2 when n is even, shards a
random tiny model (``tiny_config(n_mels=20)``) and a global batch of 2·dp
utterances of 170 frames, takes one optimizer step and prints
``dryrun_multichip(n): mesh=dpXxtpY loss=...``.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch


def _step(devices, n_devices: int, tp: int):
    from speechcatcher_tpu_torch.config import tiny_config
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_params,
    )
    from speechcatcher_tpu_torch.parallel.tp import set_tp_group
    from speechcatcher_tpu_torch.training import (
        TrainBatch,
        make_optimizer,
        train_step,
    )

    torch.set_num_threads(1)
    mesh = make_mesh(n_devices, tp=tp, devices=devices)
    set_tp_group(mesh.tp_group)
    cfg = tiny_config(n_mels=20)
    model = ASRModel.random_init(cfg, seed=0, device=mesh.device)
    b = mesh.shape["dp"] * 2
    rng = np.random.RandomState(0)
    dev = mesh.device
    batch = TrainBatch(
        feats=torch.from_numpy(
            rng.randn(b, 170, cfg.n_mels).astype(np.float32)).to(dev),
        feat_lens=torch.full((b,), 170, dtype=torch.int32, device=dev),
        tokens=torch.from_numpy(rng.randint(
            2, cfg.vocab_size - 1, size=(b, 6)).astype(np.int32)).to(dev),
        token_lens=torch.full((b,), 6, dtype=torch.int32, device=dev),
    )
    params = shard_params(model.params, mesh)
    opt = make_optimizer()
    state = opt.init(params, mesh)
    _, _, metrics = train_step(params, state, shard_batch(batch, mesh), cfg,
                               opt, mesh)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: loss {loss}")
    return mesh.shape["dp"], mesh.shape["tp"], loss


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> float:
    """One dp × tp training step over `n_devices` gloo ranks on the CPU;
    prints the mesh and the loss and returns the loss. Raises when a rank
    fails or the ranks outlast `timeout` seconds."""
    from speechcatcher_tpu_torch.parallel.launch import run_ranks

    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    with tempfile.TemporaryDirectory() as tmp:
        out = run_ranks(_step, n_devices, str(Path(tmp) / "rendezvous"),
                        backend="gloo", timeout=timeout,
                        args=(n_devices, tp))
    dp, tp, loss = out[0]
    if any(o != out[0] for o in out):
        raise RuntimeError(f"dryrun_multichip: the ranks disagree: {out}")
    print(f"dryrun_multichip({n_devices}): mesh=dp{dp}xtp{tp} "
          f"loss={loss:.4f}", flush=True)
    return loss


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
