"""Wire codecs for the audio a client sends the engine (the port's own copy
of ``speechcatcher_tpu/serve/wire.py``; numpy only).

The engine accepts three wire formats, narrowest first:

- ``uint8``: mu-law companded PCM, 1 byte per sample (the continuous form
  of ITU-T G.711 mu-law, mu=255; about 38 dB SNR on speech-level signals,
  telephone quality). The engine expands it through a 256-entry table made
  by ``mulaw_decode`` itself, so a uint8 chunk decodes exactly like the
  float32 result of ``mulaw_decode`` of the same chunk.
- ``int16``: linear PCM, 2 bytes per sample, normalised by /32767 in the
  engine.
- ``float32``: 4 bytes per sample, the reference's native format.
"""
from __future__ import annotations

import numpy as np

MU = 255.0
_LN_MU1 = float(np.log1p(MU))  # ln(256)

__all__ = [
    "MU",
    "mulaw_encode_f32",
    "mulaw_encode_i16",
    "mulaw_decode",
    "encode_chunk",
]


def mulaw_encode_f32(x: np.ndarray) -> np.ndarray:
    """float32 in [-1, 1] -> uint8 mu-law code.

    code = round((sign(x) * ln(1 + mu|x|) / ln(1 + mu) + 1) * 127.5)
    """
    x = np.clip(np.asarray(x, np.float64), -1.0, 1.0)
    m = np.log1p(MU * np.abs(x)) / _LN_MU1
    return np.round((np.sign(x) * m + 1.0) * 127.5).astype(np.uint8)


# int16 -> uint8 via a one-time 65536-entry table: one lookup per sample
# on the host instead of a transcendental.
_ENC_LUT: np.ndarray | None = None


def _enc_lut() -> np.ndarray:
    global _ENC_LUT
    if _ENC_LUT is None:
        all_i16 = np.arange(-32768, 32768, dtype=np.int64)
        _ENC_LUT = mulaw_encode_f32(all_i16.astype(np.float64) / 32767.0)
    return _ENC_LUT


def mulaw_encode_i16(x: np.ndarray) -> np.ndarray:
    """int16 PCM -> uint8 mu-law code (table lookup, vectorized)."""
    x = np.asarray(x)
    assert x.dtype == np.int16, x.dtype
    return _enc_lut()[x.astype(np.int32) + 32768]


def mulaw_decode(u: np.ndarray) -> np.ndarray:
    """uint8 mu-law code -> float32 in [-1, 1].

    The engine's uint8 ingest table is this function over all 256 codes,
    so host-decoded float and uint8 wire give identical feature streams:
        v = u / 127.5 - 1;  x = sign(v) * expm1(|v| * ln(1+mu)) / mu
    """
    v = np.asarray(u, np.float32) / np.float32(127.5) - np.float32(1.0)
    return np.sign(v) * np.expm1(np.abs(v) * np.float32(_LN_MU1)) / np.float32(MU)


def encode_chunk(a: np.ndarray, wire: str) -> np.ndarray:
    """Encode one chunk for the requested wire format.

    wire: "mulaw" (uint8), "int16", or "float32"; int16 input is assumed
    (the websocket/CLI payload format).
    """
    a = np.asarray(a)
    if wire == "mulaw":
        return mulaw_encode_i16(a) if a.dtype == np.int16 else mulaw_encode_f32(a)
    if wire == "int16":
        if a.dtype == np.int16:
            return a
        # round, don't truncate: float that came from int16 PCM (x/32767)
        # must map back to the exact same int16 value
        return np.round(np.clip(a, -1.0, 1.0) * 32767.0).astype(np.int16)
    if wire == "float32":
        if a.dtype == np.int16:
            return a.astype(np.float32) / 32767.0
        return a.astype(np.float32)
    raise ValueError(f"unknown wire format: {wire!r}")
