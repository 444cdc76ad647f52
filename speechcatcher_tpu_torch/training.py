"""Joint CTC + attention training, on one card or over a dp × tp mesh.

Port of ``speechcatcher_tpu/training.py``: the label-smoothed attention
cross entropy plus the CTC loss, weighted ``ctc_weight·L_ctc + (1 -
ctc_weight)·L_att``, and an optimizer that matches the JAX package's optax
chain step for step:

- ``clip_by_global_norm``: the gradients stay as they are where their global
  norm is below the limit and are scaled by ``limit / norm`` otherwise
  (``torch.nn.utils.clip_grad_norm_`` would divide by ``norm + 1e-6``);
- ``adamw`` with b1 0.9, b2 0.999, eps 1e-8 and decoupled weight decay
  (1e-6 here) on every leaf;
- the learning rate, or ESPnet's WarmupLR schedule, evaluated at the number
  of updates made so far (0 for the first), which the schedule raises to 1.

Every floating-point leaf of the parameter tree trains, the conformer's
BatchNorm running statistics included: they are leaves of the JAX tree, and
``jax.value_and_grad`` differentiates the eval-mode affine through them.

Parameters update in place; ``train_step`` returns the same tree and state
objects, as the JAX function returns their successors. On a card, outside
a mesh and a tp group, the step is a CUDA graph per batch signature and
``evaluate`` two per eval bucket (``decode.graphs.SignatureGraphs``): the
counterparts of the JAX package's jit-compiled ``train_step``,
``_eval_metrics`` and ``_encode_and_collapse``. The CPU, and a step under
a mesh, run the same programs eagerly.

Over a mesh (``parallel.mesh``, one process per card) ``train_step`` equals
the JAX package's GSPMD step on the global batch: each dp rank takes its
rows of the batch (``shard_batch``) and divides its loss sums by the global
denominators (batch size, unmasked tokens), the gradients are summed over
the dp group, and the global-norm clip sums the squared norms of
tp-sharded leaves over the tp group and counts replicated leaves once. The
conformer's position biases, which every tp rank holds whole and uses in
part, get their gradients summed over the tp group. The command line,
``python -m speechcatcher_tpu_torch.training``, runs on one card (``--device
cpu`` for the CPU) or, with ``--coordinator``, as one process per card.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from speechcatcher_tpu_torch.config import ModelConfig
from speechcatcher_tpu_torch.models.ctc import ctc_loss
from speechcatcher_tpu_torch.models.decoder import decoder_forward_train
from speechcatcher_tpu_torch.models.encoder import encoder_forward_train
from speechcatcher_tpu_torch.parallel.mesh import Mesh, is_tp_sharded
from speechcatcher_tpu_torch.parallel.tp import tp_group
from speechcatcher_tpu_torch.params import (
    trainable_leaves,
    tree_leaves,
    tree_map,
)

# adamw's constants in optax (its defaults, which the JAX trainer keeps).
B1, B2, EPS = 0.9, 0.999, 1e-8

# Leaves every tp rank holds whole but uses in part (its heads' rows).
TP_SUMMED = ("pos_bias_u", "pos_bias_v")


class TrainBatch(NamedTuple):
    feats: torch.Tensor       # (B, T, n_mels) normalized log-mel
    feat_lens: torch.Tensor   # (B,)
    tokens: torch.Tensor      # (B, U) target ids (0-padded)
    token_lens: torch.Tensor  # (B,)


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot rows of `ids` over n classes. ``F.one_hot`` reads the
    ids' range on the host on the CPU; this reads nothing."""
    return (ids.long()[..., None]
            == torch.arange(n, device=ids.device)).long()


def label_smoothing_ce(logits: torch.Tensor, targets: torch.Tensor,
                       lengths: torch.Tensor, smoothing: float = 0.1,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label-smoothed cross entropy of (B, U, V) logits against (B, U)
    targets; positions at or past `lengths` are masked out, and the sum is
    divided by the count of the rest (at least 1), or by `count` where given
    (the global count of a dp rank's share)."""
    vocab = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = _one_hot(targets, vocab).to(logp.dtype)
    smoothed = onehot * (1.0 - smoothing) + smoothing / vocab
    nll = -(smoothed * logp).sum(dim=-1)
    mask = (torch.arange(targets.shape[1], device=targets.device)[None, :]
            < lengths[:, None]).to(nll.dtype)
    if count is None:
        count = mask.sum()
    return (nll * mask).sum() / count.clamp(min=1.0)


def _global_counts(batch: TrainBatch, mesh: Optional[Mesh]):
    """(global batch size, global count of unmasked decoder targets) summed
    over the dp group, or (None, None) without one."""
    if mesh is None or mesh.dp_group is None:
        return None, None
    with torch.no_grad():
        n = torch.stack([
            torch.tensor(float(batch.token_lens.shape[0]),
                         device=batch.token_lens.device),
            (batch.token_lens + 1).sum().float()])
        dist.all_reduce(n, group=mesh.dp_group)
    return int(n[0]), n[1]


def joint_loss(params: Dict[str, Any], batch: TrainBatch, cfg: ModelConfig,
               smoothing: float = 0.1, mesh: Optional[Mesh] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ctc_weight·L_ctc + (1 - ctc_weight)·L_att; (loss, {"loss", "ctc",
    "att"}). Under a mesh, `batch` is this dp rank's rows: the loss is its
    share of the global batch's (local sums over global denominators) and
    the metrics are the global values."""
    global_b, global_tokens = _global_counts(batch, mesh)
    enc_out, enc_lens = encoder_forward_train(
        params["encoder"], batch.feats, batch.feat_lens, cfg)
    l_ctc = ctc_loss(params["ctc"], enc_out, enc_lens, batch.tokens,
                     batch.token_lens, blank=cfg.blank_id,
                     global_batch=global_b)

    # Teacher forcing: ys_in = [sos] + y; ys_out = y + [eos], the EOS at
    # each row's own length.
    tokens = batch.tokens.long()
    b, u = tokens.shape
    ys_in = torch.cat([torch.full((b, 1), cfg.sos_id, dtype=tokens.dtype,
                                  device=tokens.device), tokens], dim=1)
    eos = _one_hot(batch.token_lens, u + 1) * cfg.eos_id
    ys_out = torch.cat([tokens, tokens.new_zeros((b, 1))], dim=1) + eos
    logits = decoder_forward_train(params["decoder"], enc_out, enc_lens,
                                   ys_in, batch.token_lens + 1, cfg)
    l_att = label_smoothing_ce(logits, ys_out, batch.token_lens + 1,
                               smoothing, count=global_tokens)
    loss = cfg.ctc_weight * l_ctc + (1.0 - cfg.ctc_weight) * l_att
    metrics = {"loss": loss, "ctc": l_ctc, "att": l_att}
    if global_b is not None:
        with torch.no_grad():
            shares = torch.stack([loss, l_ctc, l_att]).detach()
            dist.all_reduce(shares, group=mesh.dp_group)
        metrics = dict(zip(("loss", "ctc", "att"), shares))
    return loss, metrics


def warmup_lr_schedule(peak_lr: float, warmup_steps: int):
    """ESPnet's WarmupLR: lr · warmup^0.5 · min(step^-0.5, step ·
    warmup^-1.5), the step raised to at least 1; computed in float32, of a
    host int or of a device tensor (the step a graphed update reads)."""
    scale = np.float32(peak_lr * warmup_steps ** 0.5)
    ramp = np.float32(warmup_steps ** -1.5)

    def schedule(step):
        if isinstance(step, torch.Tensor):
            s = step.float().clamp(min=1.0)
            return torch.minimum(s.pow(-0.5), s * float(ramp)) * float(scale)
        s = np.maximum(np.float32(step), np.float32(1.0))
        return float(scale * np.minimum(s ** np.float32(-0.5), s * ramp))
    return schedule


@dataclasses.dataclass
class AdamState:
    """The optimizer's state: updates made (an int32 tensor on the leaves'
    device, so that a captured update reads it), the trained leaves and
    their first and second moments."""

    count: torch.Tensor
    leaves: List[torch.Tensor]
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    # Under a mesh: its tp group, which leaves the tp ranks hold parts of
    # and which they hold whole but use in part (TP_SUMMED).
    tp_group: Optional[Any] = None
    sharded: Optional[List[bool]] = None
    tp_summed: Optional[List[bool]] = None
    # The train step's CUDA graphs (``train_step``): they hold the
    # addresses of the leaves, moments and count, so they live and die
    # with this state.
    graphs: Optional[Any] = dataclasses.field(default=None, repr=False,
                                              compare=False)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(lr,
    weight_decay=...))`` on the parameter tree's floating-point leaves,
    updated in place. Everything that changes from step to step (the
    count, the bias corrections, the learning rate, the clip factor) is a
    device tensor, as in optax's jitted update: the host reads nothing."""

    lr: float = 1e-3
    weight_decay: float = 1e-6
    warmup_steps: int = 0
    grad_clip: float = 0.0

    def init(self, params, mesh: Optional[Mesh] = None) -> AdamState:
        """Mark the tree's floating-point leaves trainable; zero moments.
        Under a mesh with tp > 1 the state records which leaves are tp
        shards (``parallel.mesh.shard_params``)."""
        leaves = trainable_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        state = AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            leaves=leaves,
            mu=[torch.zeros_like(x, requires_grad=False) for x in leaves],
            nu=[torch.zeros_like(x, requires_grad=False) for x in leaves])
        if mesh is not None and mesh.shape["tp"] > 1:
            paths = [p for p, x in tree_leaves(params)
                     if x.is_floating_point()]
            state.tp_group = mesh.tp_group
            state.sharded = [is_tp_sharded(p) for p in paths]
            state.tp_summed = [p.endswith(TP_SUMMED) for p in paths]
        return state

    def learning_rate(self, count):
        """The rate after `count` updates: of a host int a float, of a
        device tensor a float32 tensor."""
        if self.warmup_steps > 0:
            return warmup_lr_schedule(self.lr, self.warmup_steps)(count)
        return self.lr

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamState) -> None:
        """One step on ``state.leaves`` with their gradients `grads`."""
        if self.grad_clip > 0:
            norm = _global_norm_sq(grads, state).sqrt()
            keep = norm < self.grad_clip
            torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0, self.grad_clip))
        state.count.add_(1)
        # mu = (1 - b1)·g + b1·mu, nu = (1 - b2)·g² + b2·nu.
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - B2)
        step = state.count.float()
        mu_hat = torch._foreach_div(state.mu, 1.0 - torch.pow(B1, step))
        denom = torch._foreach_div(state.nu, 1.0 - torch.pow(B2, step))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, state.leaves, alpha=self.weight_decay)
        torch._foreach_mul_(upd, self.learning_rate(state.count - 1))
        torch._foreach_sub_(state.leaves, upd)


def _global_norm_sq(grads: List[torch.Tensor], state: AdamState
                    ) -> torch.Tensor:
    """The squared global norm of the whole tree's gradients: the tp shards'
    squares summed over the tp group, replicated leaves counted once."""
    sq = torch.stack(torch._foreach_norm(grads)).square()
    if state.tp_group is None:
        return sq.sum()
    mask = torch.tensor(state.sharded, device=sq.device)
    part = torch.where(mask, sq, 0.0).sum()
    dist.all_reduce(part, group=state.tp_group)
    return part + torch.where(mask, 0.0, sq).sum()


def _all_reduce_flat(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor over `group` in place, in one collective."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-6,
                   warmup_steps: int = 0, grad_clip: float = 0.0) -> AdamW:
    """adamw, optionally under WarmupLR and global-norm clipping (ESPnet
    trains these models with grad_clip 5.0)."""
    return AdamW(lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
                 grad_clip=grad_clip)


# The metrics of a step, in the order of the stacked tensor its program
# returns.
METRICS = ("loss", "ctc", "att")


def graphed(device: torch.device) -> bool:
    """Whether ``train_step`` (without a mesh) and ``evaluate`` run as CUDA
    graphs: on a card, outside a tp group, whose collectives (gloo through
    host memory) a graph cannot hold."""
    return device.type == "cuda" and tp_group() is None


def _step(params, state: AdamState, batch: TrainBatch, cfg: ModelConfig,
          optimizer: AdamW, mesh: Optional[Mesh] = None,
          update: Optional[AdamState] = None) -> torch.Tensor:
    """The train step's program: loss, gradients of ``state.leaves``, the
    optimizer step in place on `update` (by default `state`); returns the
    metrics stacked in ``METRICS`` order.

    The loss reads a view of each trained leaf and the gradients are taken
    at the views: the leaves' own gradient accumulators, which a caller's
    live autograd graph may keep tied to the stream it ran on, take no
    part (a capture would wait on that stream, and fail)."""
    views = {id(x): x.view_as(x) for x in state.leaves}
    tree = tree_map(lambda x: views.get(id(x), x), params)
    loss, metrics = joint_loss(tree, batch, cfg, mesh=mesh)
    # A leaf the loss does not use gets zeros, as under jax.grad.
    grads = list(torch.autograd.grad(
        loss, [views[id(x)] for x in state.leaves], allow_unused=True,
        materialize_grads=True))
    if mesh is not None and mesh.dp_group is not None:
        _all_reduce_flat(grads, mesh.dp_group)
    if state.tp_group is not None:
        _all_reduce_flat([g for g, s in zip(grads, state.tp_summed) if s],
                         state.tp_group)
    optimizer.update(grads, update or state)
    return torch.stack([metrics[k] for k in METRICS]).detach()


def _graph_constants(cfg: ModelConfig, device: torch.device) -> tuple:
    """The cached constant tensors the programs read (the encoder's and
    decoder's position tables, the block mask): a graph holds them, so
    that a cache eviction cannot free what it reads."""
    from speechcatcher_tpu_torch.models import decoder, encoder

    return encoder._constants(cfg, device), decoder._pe_table(cfg, device)


def _graphed_step(params, state: AdamState, batch: TrainBatch,
                  cfg: ModelConfig, optimizer: AdamW) -> torch.Tensor:
    """``_step`` as a CUDA graph of the batch's signature, captured at first
    use into the state's graphs (``graphs.SignatureGraphs``); the warm-up
    updates a copy of the state."""
    from speechcatcher_tpu_torch.decode.graphs import SignatureGraphs

    if state.graphs is None:
        state.graphs = SignatureGraphs()
    device = state.count.device

    def program(*static):
        return [_step(params, state, TrainBatch(*static), cfg, optimizer)]

    def warmup(*static):
        copy = dataclasses.replace(
            state, count=state.count.clone(),
            leaves=[x.detach().clone() for x in state.leaves],
            mu=[x.clone() for x in state.mu],
            nu=[x.clone() for x in state.nu], graphs=None)
        return [_step(params, state, TrainBatch(*static), cfg, optimizer,
                      update=copy)]

    return state.graphs.run(
        (cfg, optimizer), "train_step", batch, program, warmup,
        keep=_graph_constants(cfg, device), device=device)[0]


def train_step(params: Dict[str, Any], opt_state: AdamState,
               batch: TrainBatch, cfg: ModelConfig, optimizer: AdamW,
               mesh: Optional[Mesh] = None):
    """One update: loss, gradients of every trained leaf, the optimizer
    step in place. Returns (params, opt_state, metrics) with detached
    metric tensors. Under a mesh, `params` are this rank's shards
    (``shard_params``), `opt_state` comes from ``optimizer.init(params,
    mesh)`` and `batch` holds this dp rank's rows (``shard_batch``).

    The counterpart of the JAX package's jit-compiled ``train_step``: on a
    card without a mesh, one CUDA graph per signature (batch shapes and
    dtypes, config, optimizer), captured at first use over the state's
    leaves, moments and count and static batch buffers, all of a state's
    signatures in one memory pool (``graphs.SignatureGraphs``). The CPU
    runs the same program eagerly. Under a mesh the step is eager by
    configuration: its dp and tp all-reduces (gloo or NCCL) and the global
    batch size the host reads are no part of a graph here."""
    if mesh is None and graphed(opt_state.count.device):
        stacked = _graphed_step(params, opt_state, batch, cfg, optimizer)
    else:
        stacked = _step(params, opt_state, batch, cfg, optimizer, mesh)
    return params, opt_state, dict(zip(METRICS, stacked.unbind()))


# Eval graphs of each parameter tree, weakly keyed on its first leaf:
# (weak references to every leaf at capture, SignatureGraphs).
_EVAL_GRAPHS = WeakIdKeyDictionary()


def _eval_graphs(params):
    """The eval graphs of a parameter tree; new ones when any leaf was
    replaced since they were captured (two trees never share a graph, and
    a tree's graphs die with it)."""
    from speechcatcher_tpu_torch.decode.graphs import SignatureGraphs

    leaves = [x for _, x in tree_leaves(params)]
    entry = _EVAL_GRAPHS.get(leaves[0])
    if (entry is None or len(entry[0]) != len(leaves)
            or any(ref() is not x for ref, x in zip(entry[0], leaves))):
        entry = _EVAL_GRAPHS[leaves[0]] = (
            [weakref.ref(x) for x in leaves], SignatureGraphs())
    return entry[1]


def evaluate(params, cfg: ModelConfig, batches, tokenizer=None
             ) -> Dict[str, float]:
    """Held-out evaluation: mean joint, CTC and attention loss over the
    batches, plus the greedy-CTC WER and CER when a tokenizer is given.

    `batches` yields (TrainBatch, ref_texts) pairs (``BucketBatcher``
    with_refs=True); a flush-padded batch carries fewer refs than rows and
    only those rows are scored. On a card outside a tp group, each eval
    bucket's two programs (the counterparts of the JAX package's jitted
    ``_eval_metrics`` and ``_encode_and_collapse``: two encoder passes a
    batch, as there) are CUDA graphs of the tree's eval graphs; the host
    reads the metrics and tokens after each replay."""
    from speechcatcher_tpu_torch.decode.greedy import _encode_and_collapse
    from speechcatcher_tpu_torch.wer import word_error_rate

    def metrics(*batch):
        m = joint_loss(params, TrainBatch(*batch), cfg)[1]
        return [torch.stack([m[k] for k in METRICS])]

    def greedy(feats, feat_lens):
        return list(_encode_and_collapse(params, feats, feat_lens, cfg))

    device = next(tree_leaves(params))[1].device
    eval_graphs = _eval_graphs(params) if graphed(device) else None
    keep = _graph_constants(cfg, device) if eval_graphs else ()

    def run(name, program, inputs):
        if eval_graphs is None:
            return program(*inputs)
        return eval_graphs.run((name, cfg), name, inputs, program,
                               keep=keep, device=device)

    sums = {k: 0.0 for k in METRICS}
    refs: list = []
    hyps: list = []
    n = 0
    with torch.no_grad():
        for batch, texts in batches:
            m = run("eval_metrics", metrics, tuple(batch))[0].tolist()
            for k, v in zip(METRICS, m):
                sums[k] += v
            n += 1
            if tokenizer is not None:
                tokens, counts = run("encode_and_collapse", greedy,
                                     (batch.feats, batch.feat_lens))
                tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
                for i, text in enumerate(texts):
                    refs.append(text)
                    hyps.append(tokenizer.ids_to_text(
                        [int(t) for t in tokens[i, : counts[i]]]))
    out = {k: v / max(n, 1) for k, v in sums.items()}
    if refs:
        wer_stats = word_error_rate(refs, hyps)
        out["wer"] = wer_stats["wer"]
        out["cer"] = wer_stats["cer"]
    return out


def main(argv=None):
    """Training / fine-tuning on one card, or one process per card.

    Smoke run: ``python -m speechcatcher_tpu_torch.training --steps 10``
    (synthetic data, a random model of the default config). Real data:
    ``--data-dir <kaldi dir>`` (wav.scp + text). Several cards: start one
    process per card with ``--coordinator host:port --num-processes N
    --process-id i`` (N counts cards; the JAX package counts hosts) and
    ``--tp`` ranks per tensor-parallel group; ``--batch`` is the global
    batch, split over the dp ranks. Rank 0 alone prints and saves; the tp
    group of dp row 0 evaluates. Checkpoints are torch files of the whole
    tree (``utils/save.py``), which the JAX package cannot read, nor the
    port its orbax ones.
    """
    import argparse
    from pathlib import Path

    parser = argparse.ArgumentParser(
        description="speechcatcher_tpu_torch trainer")
    parser.add_argument("--model-dir", type=str, default=None,
                        help="ESPnet model dir to fine-tune (default: "
                        "random-init from the default config)")
    parser.add_argument("--data-dir", type=str, default=None,
                        help="Kaldi-style data dir (wav.scp + text); "
                        "default: synthetic smoke data")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=8,
                        help="GLOBAL batch size (split over the dp ranks)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor parallelism: ranks per tp group (one "
                        "process per card, so tp > 1 needs --coordinator)")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--warmup-steps", type=int, default=0,
                        help="WarmupLR ramp (ESPnet trains with 25-30k)")
    parser.add_argument("--grad-clip", type=float, default=5.0)
    parser.add_argument("--eval-frac", type=float, default=0.1)
    parser.add_argument("--eval-every", type=int, default=0,
                        help="evaluate every N steps (0 = only at end)")
    parser.add_argument("--save-dir", type=str, default=None,
                        help="checkpoint dir (utils/save.py)")
    parser.add_argument("--save-every", type=int, default=0)
    parser.add_argument("--resume", action="store_true",
                        help="resume params from --save-dir's latest step")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of rank 0's rendezvous (or a "
                        "tcp:// or file:// init method) for a run of one "
                        "process per card")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="number of processes, one per card (the JAX "
                        "trainer counts hosts)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda (the default) or cpu; cuda raises on a "
                        "machine without it")
    args = parser.parse_args(argv)

    from speechcatcher_tpu_torch.parallel.mesh import (
        initialize_distributed,
        local_rank,
        make_hybrid_mesh,
        shard_batch,
        shard_params,
        unshard_params,
    )
    from speechcatcher_tpu_torch.parallel.tp import set_tp_group

    try:
        joined = initialize_distributed(
            args.coordinator, args.num_processes, args.process_id,
            backend="nccl" if args.device == "cuda" else "gloo")
    except ValueError as e:
        parser.error(str(e))
    if not joined and args.tp != 1:
        parser.error(f"--tp {args.tp} runs one process per card: start "
                     f"{args.tp} or more processes with --coordinator, "
                     "--num-processes and --process-id")
    device = torch.device(args.device)
    mesh = None
    if joined:
        if device.type == "cuda":
            device = torch.device("cuda", local_rank())
            torch.cuda.set_device(device)
        try:
            mesh = make_hybrid_mesh(tp=args.tp, local_devices=[device])
        except ValueError as e:
            parser.error(str(e))
        if args.batch % mesh.shape["dp"]:
            parser.error(f"--batch {args.batch} does not split over "
                         f"dp={mesh.shape['dp']}")
        set_tp_group(mesh.tp_group)
    rank0 = not joined or dist.get_rank() == 0
    # The tp group of dp row 0 evaluates and gathers the checkpoint.
    lead = mesh is None or mesh.coord[0] == 0

    def say(msg):
        if rank0:
            print(msg, flush=True)

    from speechcatcher_tpu_torch.data import (
        BucketBatcher,
        read_kaldi_dir,
        synthetic_dataset,
        train_eval_split,
    )
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.utils.save import (
        load_checkpoint,
        save_checkpoint,
    )

    if args.model_dir is not None:
        model = ASRModel.from_directory(Path(args.model_dir), device=device)
    else:
        model = ASRModel.random_init(ModelConfig(), seed=0, device=device)
    cfg, tokenizer, frontend = model.cfg, model.tokenizer, model.frontend
    params = model.params
    start_step = 0
    if args.resume and args.save_dir:
        params, cfg, start_step = load_checkpoint(Path(args.save_dir),
                                                  device=model.device)
        say(f"resumed step {start_step} from {args.save_dir}")

    if args.data_dir is not None:
        utts = read_kaldi_dir(Path(args.data_dir))
    else:
        utts = synthetic_dataset(max(4 * args.batch, 32), cfg, tokenizer)
    train_utts, eval_utts = train_eval_split(utts, args.eval_frac)
    batcher = BucketBatcher(frontend, tokenizer, batch_size=args.batch,
                            input_layer=cfg.input_layer)
    say(f"{len(train_utts)} train / {len(eval_utts)} eval utterances")

    if mesh is not None:
        params = shard_params(params, mesh)
    optimizer = make_optimizer(args.lr, warmup_steps=args.warmup_steps,
                               grad_clip=args.grad_clip)
    opt_state = optimizer.init(params, mesh)

    def run_eval(step):
        if not eval_utts or not lead:
            return
        m = evaluate(params, cfg,
                     batcher.batches(eval_utts, with_refs=True), tokenizer)
        wer = f" wer {m['wer']*100:.1f}%" if "wer" in m else ""
        say(f"eval @ step {step}: loss {m['loss']:.4f} "
            f"(ctc {m['ctc']:.4f}, att {m['att']:.4f}){wer}")

    def save(step):
        if not args.save_dir or not lead:
            return
        whole = params if mesh is None else unshard_params(params, mesh)
        if rank0:
            save_checkpoint(Path(args.save_dir), whole, cfg, step=step)
            say(f"saved step {step} -> {args.save_dir}")

    step = start_step
    epoch = 0
    while step < start_step + args.steps:
        epoch_start = step
        for batch in batcher.batches(train_utts, shuffle_seed=epoch):
            if step >= start_step + args.steps:
                break
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            params, opt_state, metrics = train_step(
                params, opt_state, batch, cfg, optimizer, mesh)
            step += 1
            say(f"step {step}: loss {float(metrics['loss']):.4f} "
                f"(ctc {float(metrics['ctc']):.4f}, "
                f"att {float(metrics['att']):.4f})")
            if args.eval_every and step % args.eval_every == 0:
                run_eval(step)
            if args.save_every and step % args.save_every == 0:
                save(step)
        if step == epoch_start:
            raise SystemExit("no training batch: every utterance was "
                             f"dropped ({batcher.n_dropped} so far)")
        epoch += 1
    run_eval(step)
    save(step)
    if joined:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
