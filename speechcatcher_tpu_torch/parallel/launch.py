"""Start a function on n ranks of a fresh process group and collect what
each returns.

``run_ranks`` starts one process per rank with the ``spawn`` start method
(CUDA cannot be used in a forked child once the parent has touched the
card), joins them through a ``file://`` rendezvous that the caller names
(no port to collide on when several runs share a machine), enforces a wall
time limit and raises with the failing rank's traceback. The kernel library
is shared safely: it is built in a temporary directory and renamed
(``ops.kernels._build``), so a parent that built it first lets the ranks
load it.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch


def _rank_main(fn, rank, world, backend, init_method, devices, args,
               results):
    import torch.distributed as dist

    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        out = fn(devices, *args)
        # No rank tears the group down while another still uses it: a
        # group made last (``dist.new_group`` does not wait for its
        # members) may still be connecting on a slower rank.
        dist.barrier()
    except BaseException:
        # The parent raises it with this traceback; the rank exits non-zero.
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))
    dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, rendezvous: str,
              backend: str = "gloo",
              devices: Optional[Sequence[Any]] = None,
              timeout: float = 120.0, args: tuple = ()) -> List[Any]:
    """Run ``fn(devices, *args)`` in `world` fresh processes, joined in a
    process group (`backend`) through the file `rendezvous`, which must not
    exist yet; return each rank's result in rank order.

    `devices` (one per rank, default the CPU for each) is what the ranks pass
    to ``parallel.mesh.make_mesh``. `fn` must be importable by name (a
    module-level function) and its results picklable. Raises RuntimeError
    with the traceback of the first rank that failed, TimeoutError when the
    ranks have not all returned within `timeout` seconds; either way every
    rank is killed."""
    path = Path(rendezvous).resolve()
    if path.exists():
        raise ValueError(f"run_ranks: the rendezvous file {path} exists")
    if devices is None:
        devices = [torch.device("cpu")] * world
    devices = [torch.device(d) for d in devices]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, path.as_uri(), devices,
                               args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: ranks {sorted(set(range(world)) - set(out))}"
                    f" of {world} did not return within {timeout} s")
            dead = [r for r, p in enumerate(procs)
                    if r not in out and p.exitcode not in (None, 0)]
            try:
                # A rank that died has flushed its report before exiting.
                rank, ok, value = results.get(
                    timeout=5.0 if dead else min(left, 1.0))
            except queue_mod.Empty:
                if dead:
                    raise RuntimeError(
                        f"run_ranks: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} of {world} "
                                   f"failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world)]
