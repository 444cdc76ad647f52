"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into an
object (all sources in parallel, one ``nvcc`` each) and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
lands in ``speechcatcher_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources, their ``*.cuh`` headers and the flags, so a second process reuses
it. Nothing is built when the package is imported: the first kernel launch
builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
# name -> argtypes; every function returns the launch's cudaError_t as int
# (those that take a plan also -1 when the plan or the pointers do not fit).
_SIGNATURES = {
    # q, k, v, mask, out, plan (a struct, by address), stream
    "sc_block_attention": [_P, _P, _P, _P, _P, _P, _P],
    # q, k, v, pos, bias_u, bias_v, mask, out, plan, stream
    "sc_rel_block_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # xn, xb, phi_shift, start, end, olen0, r, plan, stream
    "sc_ctc_forward_recursion": [_P, _P, _P, _P, _P, _P, _P, _P, _P],
    # xn, xb, phi, olen, enc_len, r_src, r, plan, stream
    "sc_ctc_forward_recursion_streams": [_P, _P, _P, _P, _P, _P, _P, _P, _P],
    # ring, new, start, n_new, plan (a struct, by address), stream
    "sc_ring_append_cols": [_P, _P, _P, _P, _P, _P],
    "sc_ring_append_rows": [_P, _P, _P, _P, _P, _P],
    # h, y, bias, weight, beta, h_out, hn, cache, pos, write, plan, stream
    "sc_add_layer_norm": [_P] * 12,
    # qk, cache, hn_self, lane, pos, out, plan, stream
    "sc_lane_attention": [_P] * 8,
    # q, mk, mv, enc_len, out, plan, stream
    "sc_cross_attention": [_P] * 7,
}


class KernelLibrary:
    """The loaded shared library and how long it took to get it. ``fns``
    holds each entry point's ctypes function object, bound once at load."""

    def __init__(self, path: Path, build_seconds: float, built: bool):
        self.path = path
        self.build_seconds = build_seconds
        self.built = built
        self.lib = ctypes.CDLL(str(path))
        self.fns = {}
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self.fns[name] = fn


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> Path:
    nvcc = _nvcc()
    procs = []
    objs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out.decode(errors='replace')}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib = out_dir / "libsc_kernels.so"
    res = subprocess.run(
        [nvcc, "-shared", "-o", str(lib), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout.decode(errors="replace"))
    return lib


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library. Once it is
    loaded, a call takes no lock."""
    global _library
    if _library is not None:
        return _library
    with _lock:
        if _library is not None:
            return _library
        t0 = time.perf_counter()
        final = BUILD_ROOT / _source_hash()
        lib_path = final / "libsc_kernels.so"
        built = False
        if not lib_path.exists():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
            try:
                _compile(tmp)
                try:
                    tmp.rename(final)
                except OSError:
                    if not lib_path.exists():  # lost a race to nothing
                        raise
            finally:
                if tmp.exists():
                    shutil.rmtree(tmp, ignore_errors=True)
            built = True
        _library = KernelLibrary(lib_path, time.perf_counter() - t0, built)
        return _library


def stream_ptr(t) -> int:
    """The raw handle of PyTorch's current stream on t's device: the
    capture stream while a CUDA graph is being captured."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())

