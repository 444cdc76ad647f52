"""Per-session audio staging for the server: int16 frames in, fixed float32
chunks out (port of ``StagingRing`` in ``speechcatcher_tpu/utils/native.py``).

A preallocated numpy ring with the semantics of the JAX package's native
ring (``csrc/staging.cpp``): a fixed capacity, writes past the free space
truncated (the write returns the count actually written, so the server can
warn that it drops audio), ``read(n)`` only in whole n-sample pieces, and
int16 → float32 as ``pcm * scale`` in float32, bit-equal to the native
ring's conversion.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class StagingRing:
    """Single-producer/single-consumer float32 ring of fixed capacity."""

    def __init__(self, capacity: int = 16000 * 120,
                 scale: float = 1 / 32767.0):
        self.capacity = int(capacity)
        self.scale = np.float32(scale)
        self._data = np.empty(self.capacity, np.float32)
        self._head = 0  # samples written in all
        self._tail = 0  # samples read in all

    def available(self) -> int:
        return self._head - self._tail

    def _write(self, x: np.ndarray) -> int:
        """Append as much of float32 `x` as fits; returns the count."""
        n = min(len(x), self.capacity - self.available())
        start = self._head % self.capacity
        first = min(n, self.capacity - start)
        self._data[start:start + first] = x[:first]
        self._data[:n - first] = x[first:n]
        self._head += n
        return n

    def write_pcm16(self, data: bytes) -> int:
        pcm = np.frombuffer(data, dtype=np.int16)
        n = min(len(pcm), self.capacity - self.available())
        return self._write(pcm[:n].astype(np.float32) * self.scale)

    def write_f32(self, x: np.ndarray) -> int:
        return self._write(np.ascontiguousarray(x, dtype=np.float32))

    def read(self, n: int) -> Optional[np.ndarray]:
        """Pop exactly n samples, or None (and nothing popped) below n."""
        if self.available() < n:
            return None
        start = self._tail % self.capacity
        first = min(n, self.capacity - start)
        out = np.concatenate([self._data[start:start + first],
                              self._data[:n - first]])
        self._tail += n
        return out

    def drain(self) -> np.ndarray:
        return self.read(self.available())
