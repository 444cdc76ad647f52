"""Cached launch plans: what the kernel wrappers share.

A wrapper plans each input signature (shapes, strides, dtypes, devices of
all operands) once: a pure-Python function does every check and returns the
launch's integers as a ``ctypes.Structure``, which is cached under the
signature and passed to the C entry point by address. A call is then one key
tuple and dict lookup, the operands' ``data_ptr()``s, the raw current stream
and one foreign call. The checks run before the CPU/CUDA branch, so the CPU
route refuses what the card refuses. What depends on the pointers
(alignment, vector width) is integer arithmetic in the C entry point, which
returns ``BAD_PLAN`` for what does not fit.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple

import torch

from speechcatcher_tpu_torch.ops.kernels import _build

BAD_PLAN = -1  # kBadPlan in csrc/*.cu

_COUNT_LOCK = threading.Lock()
_RECORD = threading.local()
# Records that also take the launches made on a CUDA stream, by any thread:
# {raw stream: record}.
_STREAM_RECORDS: dict = {}


def count(fn, attr: str = "launches") -> None:
    """Add one to a wrapper's launch counter. Engine replicas launch from
    several threads at once (``parallel.serve_sharding``), where ``+=`` on
    an attribute could lose a count. Inside ``recording()`` the launch goes
    to the record instead: a launch captured into a CUDA graph runs when
    the graph replays. Only a launch on the card counts."""
    record = getattr(_RECORD, "launches", None)
    if record is None and _STREAM_RECORDS:
        record = _STREAM_RECORDS.get(torch.cuda.current_stream().cuda_stream)
    with _COUNT_LOCK:
        if record is not None:
            record[(fn, attr)] = record.get((fn, attr), 0) + 1
        else:
            setattr(fn, attr, getattr(fn, attr) + 1)


@contextlib.contextmanager
def recording(stream=None):
    """Count this thread's launches into a fresh dict {(fn, attr): n}
    instead of the counters (a graph's capture, work not to be counted).
    With `stream`, a CUDA stream that only this work uses (a capture's or
    a warm-up's), also the launches any other thread makes on it: on the
    card the autograd engine runs a backward on a thread of its own, on
    the stream of its forward."""
    outer = getattr(_RECORD, "launches", None)
    record = _RECORD.launches = {}
    key = None if stream is None else stream.cuda_stream
    if key is not None:
        with _COUNT_LOCK:
            _STREAM_RECORDS[key] = record
    try:
        yield record
    finally:
        _RECORD.launches = outer
        if key is not None:
            with _COUNT_LOCK:
                del _STREAM_RECORDS[key]


def add_counts(record: dict) -> None:
    """Add a record of launches to the counters (a graph's replay)."""
    with _COUNT_LOCK:
        for (fn, attr), n in record.items():
            setattr(fn, attr, getattr(fn, attr) + n)


class Launch(NamedTuple):
    """A cached plan: its arguments, their address, the bound entry point
    (None on the CPU, where the plain twin runs) and, for a kernel that
    allocates its result, the shape to allocate."""

    args: ctypes.Structure
    address: int
    fn: object
    out_shape: tuple = ()


def strides(t: torch.Tensor) -> list:
    """t's strides in elements, 0 on dims of extent 1 (never stepped)."""
    return [0 if n == 1 else st for n, st in zip(t.shape, t.stride())]


def check_devices(name: str, *tensors) -> None:
    """Every operand on one device, the CPU or a CUDA card."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(a.device != dev
                                              for a in tensors):
        raise ValueError(f"{name}: operands must share one CPU or CUDA "
                         f"device, got "
                         + ", ".join(str(a.device) for a in tensors))


def needs_grad(*tensors) -> bool:
    """Whether autograd must follow a call on these operands: grad mode on
    and one of them requiring grad."""
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would have to follow a kernel that has no
    backward (B, C, D; their JAX counterparts have no VJP either). A result
    without a gradient would otherwise pass unnoticed."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{name} has no backward: call it under "
                           "torch.no_grad() or on operands that do not "
                           "require grad")


def launch(plans: dict, key: tuple, args: ctypes.Structure, entry: str,
           device: torch.device, out_shape: tuple = ()) -> Launch:
    """Bind a planned signature's entry point on CUDA and cache it."""
    fn = _build.library().fns[entry] if device.type == "cuda" else None
    plan = plans[key] = Launch(args, ctypes.addressof(args), fn, out_shape)
    return plan


def raise_launch_error(name: str, err: int) -> None:
    """Raise for a nonzero return of an entry point."""
    if err == BAD_PLAN:
        raise ValueError(f"{name}: the operands' addresses or strides do not "
                         "fit the kernel")
    raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
