"""Operations and bytes of the port's five hand-written kernels, by call
shape (the arithmetic ``chip_smoke.py`` prints beside its kernel timings,
frozen here). Each returns ``(n_bytes, n_ops)``: every input byte read once,
every output byte written once; where the work depends on the data (the CTC
recursion's frame ranges, the rows a ring append writes), what these inputs
need.

- A ``block_attention``: softmax attention inside N windows of W frames,
  q, k, v (N, H, W, dk) float32, a (W, W) float32 mask, out (N, H, W, dk).
  Two products (scores, weighted values) of 2·W·W·dk operations per head.
- E ``rel_block_attention``: A plus the relative-position scores (a third
  product) against pos (H, W, dk) and two (H, dk) biases.
- B ``ctc_forward_recursion_streams``: per stream, B hypotheses recursed
  over the frames [max(olen, 1), end): two log-add-exps (7 operations
  each) and two adds a frame; reads the label rows and phi over those
  frames, the blank row once, frame 0 of the label row where the stream has
  no token yet, r_src from `end` on and the (olen, enc_len) integers; writes
  the new forward variables (2 × t_cap a hypothesis).
- C ``ring_append_cols``: n_new[s] columns of V log-probs appended to a
  (S, V, t_cap) ring: read n·V values, write n·V values, and two integers a
  stream.
- D ``ring_append_rows``: n_new[s] rows of width w appended to a
  (S, cap, w) buffer, likewise.
"""

from __future__ import annotations

from typing import Sequence, Tuple

F32 = 4


def block_attention(n: int, h: int, w: int, dk: int) -> Tuple[float, float]:
    n_bytes = (4 * n * h * w * dk + w * w) * F32
    n_ops = 2 * (2 * n * h * w * w * dk)
    return float(n_bytes), float(n_ops)


def rel_block_attention(n: int, h: int, w: int, dk: int
                        ) -> Tuple[float, float]:
    extra = h * w * dk + 2 * h * dk
    n_bytes = (4 * n * h * w * dk + extra + w * w) * F32
    n_ops = 3 * (2 * n * h * w * w * dk)
    return float(n_bytes), float(n_ops)


def ctc_recursion(beam: int, t_cap: int, olen: Sequence[int],
                  end: Sequence[int], row_bytes: int = F32
                  ) -> Tuple[float, float]:
    """One call over len(olen) streams of `beam` hypotheses each."""
    n_bytes = n_ops = 0
    for o, e in zip(olen, end):
        begin = min(max(o, 1), t_cap)
        frames = max(e - begin, 0)
        n_bytes += (((beam + 1) * frames + beam * (o == 0)) * row_bytes
                    + (beam * frames + 2 * beam * (t_cap - e)
                       + 2 * beam * t_cap) * F32 + 12)
        n_ops += 16 * frames * beam
    return float(n_bytes), float(n_ops)


def ring_append_cols(vocab: int, n_new: Sequence[int], in_bytes: int = F32,
                     out_bytes: int = F32) -> Tuple[float, float]:
    rows = sum(n_new)
    return float(rows * vocab * (in_bytes + out_bytes)
                 + 8 * len(n_new)), 0.0


def ring_append_rows(width: int, n_new: Sequence[int], in_bytes: int = F32,
                     out_bytes: int = F32) -> Tuple[float, float]:
    rows = sum(n_new)
    return float(rows * width * (in_bytes + out_bytes)
                 + 8 * len(n_new)), 0.0
