"""Audio I/O: WAV reading/writing and optional ffmpeg media conversion (port
of ``speechcatcher_tpu/utils/audio.py``).

ffmpeg stays a host-side subprocess; plain WAVs are read with the stdlib and
resampled with scipy, so a machine without ffmpeg still decodes WAV files.
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from pathlib import Path
from typing import Tuple

import numpy as np

TARGET_RATE = 16000


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def read_wav(path: Path) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file → (int16 mono samples, rate)."""
    with wave.open(str(path), "rb") as w:
        channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        frames = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(frames, dtype=np.int16)
    elif width == 1:
        data = (np.frombuffer(frames, dtype=np.uint8).astype(np.int16) - 128) << 8
    elif width == 4:
        data = (np.frombuffer(frames, dtype=np.int32) >> 16).astype(np.int16)
    else:
        raise ValueError(f"Unsupported WAV sample width: {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1).astype(np.int16)
    return data, rate


def write_wav(path: Path, data: np.ndarray, rate: int = TARGET_RATE):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(data, dtype=np.int16).tobytes())


def resample_int16(data: np.ndarray, rate: int,
                   target: int = TARGET_RATE) -> np.ndarray:
    """Polyphase resample via scipy (fallback when ffmpeg is unavailable)."""
    if rate == target:
        return data
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(rate, target)
    out = resample_poly(data.astype(np.float32), target // g, rate // g)
    return np.clip(out, -32768, 32767).astype(np.int16)


def convert_media(path, show_output: bool = False) -> Tuple[np.ndarray, int]:
    """Any media file or URL → (16 kHz mono int16, 16000).

    Uses ffmpeg when present (any container/codec); otherwise falls back to
    stdlib WAV + scipy resampling.
    """
    # URLs must reach ffmpeg verbatim; Path() would collapse "https://" into
    # "https:/".
    src = str(path)
    is_url = src.startswith(("http://", "https://"))
    path = Path(src) if not is_url else None
    if have_ffmpeg():
        cmd = [
            "ffmpeg", "-i", src, "-f", "s16le", "-acodec", "pcm_s16le",
            "-ac", "1", "-ar", str(TARGET_RATE), "pipe:1",
        ]
        proc = subprocess.run(
            cmd,
            stdout=subprocess.PIPE,
            stderr=None if show_output else subprocess.DEVNULL,
            check=True,
        )
        return np.frombuffer(proc.stdout, dtype=np.int16), TARGET_RATE
    if is_url:
        raise RuntimeError(
            "ffmpeg not found; cannot stream from a URL — download the file "
            "first or install ffmpeg"
        )
    if path.suffix.lower() != ".wav":
        raise RuntimeError(
            f"ffmpeg not found; cannot decode {path.suffix} — provide a 16 kHz"
            " mono WAV or install ffmpeg"
        )
    data, rate = read_wav(path)
    return resample_int16(data, rate), TARGET_RATE
