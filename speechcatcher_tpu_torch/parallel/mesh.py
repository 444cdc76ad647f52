"""Device mesh (dp × tp) and the sharding rules for parameters and batches.

Port of ``speechcatcher_tpu/parallel/mesh.py``. JAX drives every chip of a
host from one process and lets GSPMD insert the collectives; PyTorch has no
single controller, so the port uses two process models:

- Serving (tp = 1): one process per host drives its local cards. A mesh
  made here without a process group, or one with every host's cards
  (``make_hybrid_mesh``), lists the cards of its dp rows;
  ``serve_sharding.shard_engine`` runs one engine replica per local row.
  The serving hot path exchanges nothing between cards.
- Tensor parallelism and training: one process per card, joined by
  ``torch.distributed``. Rank r of a (dp, tp) mesh sits at the position of
  its card in the grid, ``(r // tp, r % tp)`` when ranks are numbered host
  by host; the tp group is its row (a tp group never spans hosts), the dp
  group its column. ``parallel.tp`` inserts the tp collectives and
  ``training.train_step`` the dp gradient sum. ``--num-processes`` counts
  cards here, where the JAX package counts hosts.

Axes, as in the JAX package: "dp" shards the batch or stream-slot axis,
"tp" the attention heads, the FFN hidden units and the vocabulary
(column-parallel first linear, row-parallel second).
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class MeshDevice:
    """One card of a mesh: the device, the rank of the process that drives
    it and the host it sits on (the grouping key of
    ``hybrid_device_grid``, JAX's ``process_index``)."""

    device: torch.device
    rank: int = 0
    process_index: int = 0


class Mesh:
    """A (dp, tp) grid of ``MeshDevice``s and this process's place in it.

    ``per_card``: every rank drives one card of the grid; then ``coord`` is
    this rank's (dp, tp) position and ``tp_group`` / ``dp_group`` its row and
    column groups. Otherwise this process drives the rows of ``local_rows``
    (tp is 1)."""

    axis_names = ("dp", "tp")

    def __init__(self, grid: np.ndarray, rank: int = 0,
                 per_card: bool = False):
        self.devices = grid
        self.shape = {"dp": grid.shape[0], "tp": grid.shape[1]}
        self.rank = rank
        self.per_card = per_card
        self.coord: Optional[Tuple[int, int]] = None
        self.tp_group = self.dp_group = None
        if not per_card:
            return
        ranks = np.vectorize(lambda d: d.rank, otypes=[int])(grid)
        where = np.argwhere(ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} drives {len(where)} cards of a "
                             "mesh of one process per card")
        self.coord = (int(where[0, 0]), int(where[0, 1]))
        # Every rank makes every group, in one order.
        for row in ranks:
            g = dist.new_group([int(r) for r in row])
            if rank in row:
                self.tp_group = g
        for col in ranks.T:
            g = dist.new_group([int(r) for r in col])
            if rank in col:
                self.dp_group = g
        # ``dist.new_group`` returns before its members have connected: a
        # mesh is ready on every rank once any rank has it.
        dist.barrier(group=_host_group())

    @property
    def device(self) -> torch.device:
        """This rank's card (a mesh of one process per card)."""
        if self.coord is None:
            raise ValueError("only a mesh of one process per card has one "
                             "device per process")
        return self.devices[self.coord].device

    def local_rows(self) -> List[Tuple[int, torch.device]]:
        """(dp index, device) of every row this process drives (tp = 1)."""
        if self.shape["tp"] != 1:
            raise ValueError("local_rows: a tp > 1 mesh runs one process "
                             "per card")
        return [(i, row[0].device) for i, row in enumerate(self.devices)
                if row[0].rank == self.rank]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"rank={self.rank}, coord={self.coord})")


def _grid(records: Sequence[Any], rows: int) -> np.ndarray:
    flat = np.empty(len(records), dtype=object)
    for i, r in enumerate(records):
        flat[i] = r
    return flat.reshape(rows, -1)


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Mesh with shape (dp = n/tp, tp) over `devices` (default: every CUDA
    card of this machine).

    Inside a process group whose world size is n, rank r drives
    ``devices[r]`` (one process per card). Outside one, this process drives
    all n devices, which needs tp = 1. A device may repeat:
    ``[cuda:0, cuda:0]`` puts two replicas, or two ranks, on one card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        kind = devices[0].type if devices else "cuda"
        raise ValueError(
            f"make_mesh: requested {n_devices} devices, only "
            f"{len(devices)} available ({kind}). Pass devices= explicitly, "
            f"for example devices=[torch.device('cuda:0')] * {n_devices} "
            f"for {n_devices} replicas on one card, or "
            f"[torch.device('cpu')] * {n_devices} on the CPU.")
    if tp < 1 or n_devices % tp:
        raise ValueError(f"make_mesh: tp={tp} does not divide "
                         f"{n_devices} devices")
    devices = devices[:n_devices]
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world == n_devices:
        records = [MeshDevice(d, r) for r, d in enumerate(devices)]
        return Mesh(_grid(records, n_devices // tp), dist.get_rank(),
                    per_card=True)
    if tp > 1:
        raise ValueError(
            f"make_mesh: tp={tp} runs one process per card and needs an "
            f"initialized process group of {n_devices} ranks "
            f"(initialize_distributed, or parallel.launch.run_ranks); "
            f"this process has {world or 'none'}")
    rank = dist.get_rank() if world else 0
    return Mesh(_grid([MeshDevice(d, rank) for d in devices], n_devices),
                rank)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "nccl") -> bool:
    """Join the process group of a multi-process run.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous (or a
    full ``tcp://`` or ``file://`` init method). The backend is the
    caller's: NCCL between cards, gloo for CPU tensors. Returns True once
    joined, False when no coordinator was given (one process: a no-op, so
    entry points pass their flags through unconditionally)."""
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("--num-processes and --process-id take effect "
                             "only with --coordinator")
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            "--coordinator requires --num-processes and --process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not in "
                         f"[0, {num_processes})")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


def hybrid_device_grid(devices, tp: int = 1) -> np.ndarray:
    """Arrange a (possibly multi-host) device list as a (dp, tp) grid.

    Layout rule: a tp group must never span hosts (its all-reduces run on
    every row-parallel linear), while the dp axis carries no per-tick
    traffic and may. Devices are grouped by ``process_index`` (host) first,
    tp partners drawn within a host, and the dp axis enumerates host-major.
    A pure function of the device list."""
    by_proc: Dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(int(getattr(d, "process_index", 0)), []).append(d)
    n_local = {len(v) for v in by_proc.values()}
    if len(n_local) != 1:
        raise ValueError(
            f"hosts expose unequal local device counts: "
            f"{ {k: len(v) for k, v in by_proc.items()} }"
        )
    n_local = n_local.pop()
    if n_local % tp != 0:
        raise ValueError(
            f"tp={tp} does not divide the per-host device count {n_local}; "
            "a tp group must not span hosts (its all-reduces would cross "
            "the network)"
        )
    rows = []
    for p in sorted(by_proc):
        local = by_proc[p]
        for i in range(0, n_local, tp):
            rows.append(local[i: i + tp])
    grid = np.empty((len(rows), tp), dtype=object)
    for i, row in enumerate(rows):
        for j, d in enumerate(row):
            grid[i, j] = d
    return grid


_HOST_GROUP = None


def _host_group():
    """A gloo group of the whole world, made once: host-side collectives
    (object gathers, barriers) need no card chosen first, even under NCCL."""
    global _HOST_GROUP
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    return _HOST_GROUP


def _gather_hosts(local_devices) -> list:
    """(host name, device names) of every rank, in rank order, through
    the host group: under NCCL an object collective would need each rank's
    card chosen first, which is what the host names decide."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (socket.gethostname(),
                                 [str(d) for d in local_devices]),
                           group=_host_group())
    return out


def local_rank() -> int:
    """This rank's index among the ranks on its host (0 without a group):
    the card a process of one-per-card takes."""
    if not dist.is_initialized():
        return 0
    hosts = [h for h, _ in _gather_hosts([])]
    me = dist.get_rank()
    return sum(1 for h in hosts[:me] if h == hosts[me])


def make_hybrid_mesh(tp: int = 1, local_devices=None) -> Mesh:
    """Global (dp, tp) mesh over every process's devices.

    Each rank names the devices it drives (`local_devices`, default every
    local CUDA card); ``all_gather_object`` collects the ranks' host names
    and devices. Where every rank drives one device the mesh is one process
    per card and a host's ranks are its tp partners; otherwise every process
    is a host serving its own cards (tp = 1). Without a process group it is
    ``make_mesh(tp=tp)`` over the local devices."""
    if local_devices is None:
        local_devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    local_devices = [torch.device(d) for d in local_devices]
    if not dist.is_initialized():
        return make_mesh(tp=tp, devices=local_devices)
    gathered = _gather_hosts(local_devices)
    rank = dist.get_rank()
    if all(len(devs) == 1 for _, devs in gathered):
        hosts = list(dict.fromkeys(h for h, _ in gathered))
        records = [MeshDevice(torch.device(devs[0]), r, hosts.index(h))
                   for r, (h, devs) in enumerate(gathered)]
        return Mesh(hybrid_device_grid(records, tp), rank, per_card=True)
    if tp != 1:
        raise ValueError(f"make_hybrid_mesh: tp={tp} runs one process per "
                         "card; this run has a process with several")
    records = [MeshDevice(torch.device(d), r, r)
               for r, (_, devs) in enumerate(gathered) for d in devs]
    return Mesh(hybrid_device_grid(records, 1), rank)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

def is_tp_sharded(path: str) -> bool:
    """Whether the tp ranks hold parts of the leaf at `path`."""
    return "tp" in _param_spec(path)


def _param_spec(path: str) -> Spec:
    """Spec of one parameter, keyed by its tree path; a tuple with "tp" on
    the sharded dimension.

    torch-layout Linear weights are (out, in):
    - q/k/v projections + FFN w_1: column-parallel → shard OUT over tp
    - attention out-projection + FFN w_2: row-parallel → shard IN over tp
    - output_layer / ctc_lo: shard OUT (vocab) over tp
    - embeddings: shard vocab rows over tp
    - everything else (norms, convs, biases of row-parallel layers):
      replicated
    An int8 ``weight_scale`` does not end in "weight": it takes the bias's
    spec, sharded with a column-parallel output, whole for a row-parallel
    one."""
    is_weight = path.endswith("weight")
    if "linear_q" in path or "linear_k" in path or "linear_v" in path:
        return ("tp", None) if is_weight else ("tp",)
    if "linear_out" in path:
        return (None, "tp") if is_weight else ()
    if "w_1" in path:
        return ("tp", None) if is_weight else ("tp",)
    if "w_2" in path:
        return (None, "tp") if is_weight else ()
    if "linear_pos" in path:
        return ("tp", None) if is_weight else ("tp",)
    if "output_layer" in path or "ctc_lo" in path:
        return ("tp", None) if is_weight else ("tp",)
    if path.endswith("embed/weight"):  # token embedding (vocab, d)
        return ("tp", None)
    return ()


def param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """Spec tree matching a parameter tree. Leaves of a layer-stacked
    ``layers`` dict (the JAX layout) carry a leading layer axis and get a
    leading None; the per-layer dicts of the port's ``layers`` lists do
    not."""

    def walk(node, path, stacked):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}",
                            stacked or (k == "layers" and isinstance(v, dict)))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}", stacked)
                              for i, v in enumerate(node))
        spec = _param_spec(path)
        return (None, *spec) if stacked else spec

    return walk(params, "", False)


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def _tp_dim(spec: Spec) -> Optional[int]:
    return spec.index("tp") if "tp" in spec else None


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's shards of a parameter tree: each leaf's block along its
    "tp" dimension, as a new contiguous tensor. tp = 1 returns the tree."""
    tp = mesh.shape["tp"]
    if tp == 1:
        return params
    if mesh.coord is None:
        raise ValueError("tensor parallelism needs a mesh of one process "
                         "per card")
    j = mesh.coord[1]

    def shard(x, spec):
        dim = _tp_dim(spec)
        if dim is None:
            return x
        if x.shape[dim] % tp:
            raise ValueError(f"tp={tp} does not divide dimension {dim} of "
                             f"a leaf of shape {tuple(x.shape)}")
        return x.chunk(tp, dim=dim)[j].contiguous()

    return _map2(shard, params, param_specs(params))


def unshard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The whole tree from the tp ranks' shards (a collective of the tp
    group: every rank of it calls this). tp = 1 returns the tree."""
    if mesh.shape["tp"] == 1:
        return params

    def gather(x, spec):
        dim = _tp_dim(spec)
        if dim is None:
            return x
        parts = [torch.empty_like(x) for _ in range(mesh.shape["tp"])]
        dist.all_gather(parts, x.detach().contiguous(), group=mesh.tp_group)
        return torch.cat(parts, dim=dim)

    return _map2(gather, params, param_specs(params))


def shard_batch(tree: Any, mesh: Mesh) -> Any:
    """This dp rank's contiguous rows of a global batch (every leaf's
    leading axis), as JAX's ``P("dp")`` places them. dp = 1 returns the
    tree."""
    dp = mesh.shape["dp"]
    if dp == 1:
        return tree
    if mesh.coord is None:
        raise ValueError("shard_batch needs a mesh of one process per card")
    i = mesh.coord[0]

    def rows(x):
        if x.shape[0] % dp:
            raise ValueError(f"dp={dp} does not divide a batch of "
                             f"{x.shape[0]}")
        n = x.shape[0] // dp
        return x[i * n:(i + 1) * n]

    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(rows(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(rows(x) for x in tree)
    return rows(tree)
