"""What the ranks of the port's multi-process tests run (no tests here).

``parallel.launch.run_ranks`` starts each function below in a fresh process
of a gloo group; the module imports neither JAX nor the JAX package, so the
ranks start with torch alone. Each function takes the ranks' devices first
and returns numpy values that the test compares with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
    shard_params,
    unshard_params,
)
from speechcatcher_tpu_torch.parallel.tp import set_tp_group
from speechcatcher_tpu_torch.params import params_to_numpy


def _mesh(devices, tp):
    torch.set_num_threads(1)
    mesh = make_mesh(len(devices), tp=tp, devices=devices)
    set_tp_group(mesh.tp_group)
    return mesh


def _model(cfg, tree, mesh):
    model = ASRModel.from_numpy(cfg, tree, device=mesh.device)
    model.params = shard_params(model.params, mesh)
    return model


def tp_collectives(devices):
    """copy_to_tp, reduce_from_tp, gather_from_tp and vocab_lookup on two
    ranks: forward values and input gradients."""
    from speechcatcher_tpu_torch.parallel.tp import (
        copy_to_tp,
        gather_from_tp,
        reduce_from_tp,
        vocab_lookup,
    )

    mesh = _mesh(devices, tp=2)
    r = mesh.coord[1]
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    y = copy_to_tp(x)
    (y * (r + 1)).sum().backward()
    copy = (y.detach().numpy(), x.grad.numpy())
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    y = reduce_from_tp(x)
    (y * (r + 1)).sum().backward()
    reduce = (y.detach().numpy(), x.grad.numpy())
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    y = gather_from_tp(x)
    (y * torch.arange(6.0)).sum().backward()
    gather = (y.detach().numpy(), x.grad.numpy())
    table = torch.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2]
    rows = vocab_lookup(table, torch.tensor([0, 3, 2, 1])).numpy()
    return copy, reduce, gather, rows


def tp_forward(devices, cfg, tree, feats, feat_lens, tp):
    """encoder_forward_train + ctc_log_softmax on this dp rank's rows."""
    from speechcatcher_tpu_torch.models.ctc import ctc_log_softmax
    from speechcatcher_tpu_torch.models.encoder import encoder_forward_train

    mesh = _mesh(devices, tp)
    model = _model(cfg, tree, mesh)
    feats, feat_lens = shard_batch(
        (torch.from_numpy(feats), torch.from_numpy(feat_lens)), mesh)
    with torch.no_grad():
        enc, lens = encoder_forward_train(model.params["encoder"], feats,
                                          feat_lens, cfg)
        logp = ctc_log_softmax(model.params["ctc"], enc)
    return logp.numpy(), lens.numpy()


def train_steps(devices, cfg, tree, batch, tp, n_steps, lr, grad_clip):
    """`n_steps` of train_step on the global numpy batch; returns the
    global losses and the whole parameter tree after them (numpy, JAX
    layout)."""
    from speechcatcher_tpu_torch.training import (
        TrainBatch,
        make_optimizer,
        train_step,
    )

    mesh = _mesh(devices, tp)
    model = _model(cfg, tree, mesh)
    params = model.params
    local = shard_batch(TrainBatch(*(torch.from_numpy(x) for x in batch)),
                        mesh)
    opt = make_optimizer(lr=lr, grad_clip=grad_clip)
    state = opt.init(params, mesh)
    losses = []
    for _ in range(n_steps):
        _, _, m = train_step(params, state, local, cfg, opt, mesh)
        losses.append({k: float(v) for k, v in m.items()})
    return losses, params_to_numpy(unshard_params(params, mesh))


def engine_finals(devices, cfg, tree, audios, n_chunks, chunk, n_slots,
                  tp):
    """Drive this rank's block of the streams through shard_engine: one
    slot per stream, n_chunks - 1 ticks, then finalize. Returns
    {stream: (yseq, xpos)}."""
    from speechcatcher_tpu_torch.parallel.serve_sharding import shard_engine
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine

    mesh = _mesh(devices, tp)
    model = ASRModel.from_numpy(cfg, tree, device=mesh.device)
    engine = shard_engine(
        StreamingEngine(model, n_slots=n_slots, beam_size=2,
                        chunk_samples=chunk, device=mesh.device), mesh)
    mine = range(engine.slot_base, engine.slot_base + engine.S)
    slots = {k: engine.acquire_slot() for k in mine}
    for i in range(n_chunks - 1):
        engine.tick({s: audios[k][i * chunk:(i + 1) * chunk]
                     for k, s in slots.items()})
    out = {}
    for k, s in slots.items():
        yseq, xpos, _ = engine.finalize(s, audios[k][(n_chunks - 1)
                                                     * chunk:])
        out[k] = (np.asarray(yseq).tolist(), np.asarray(xpos).tolist())
    dist.barrier()
    return out


def hybrid_meshes(devices):
    """make_hybrid_mesh on two ranks: as two hosts of two CPU "cards" each
    (serving), then as one process per card at tp=2."""
    from speechcatcher_tpu_torch.parallel.mesh import make_hybrid_mesh

    torch.set_num_threads(1)
    hosts = make_hybrid_mesh(tp=1, local_devices=["cpu", "cpu"])
    cards = make_hybrid_mesh(tp=2, local_devices=["cpu"])
    return (hosts.shape, [i for i, _ in hosts.local_rows()], hosts.coord,
            cards.shape, cards.coord, cards.per_card)


def fails_on_rank(devices, bad):
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} says no")
    return dist.get_rank()


def sleeps(devices, seconds):
    import time

    time.sleep(seconds)
    return dist.get_rank()
