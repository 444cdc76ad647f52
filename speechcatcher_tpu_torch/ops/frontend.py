"""STFT → power → mel → log → MVN frontend.

Port of ``speechcatcher_tpu/ops/frontend.py``: ``torch.stft``-equivalent
framing (n_fft 512, hop 160, win 400, periodic Hann window centred in
n_fft, center=True with reflect padding, onesided), power spectrum, a full
float32 mel projection, ``log(clip 1e-10)`` and per-dimension global MVN.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from speechcatcher_tpu_torch.ops.mel import melscale_fbanks


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def make_frontend_constants(
    n_fft: int = 512,
    win_length: int = 400,
    n_mels: int = 80,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(padded window (n_fft,), mel matrix (n_fft//2+1, n_mels))."""
    if f_max is None:
        f_max = sample_rate / 2.0
    win = hann_window(win_length)
    left = (n_fft - win_length) // 2
    window = np.zeros(n_fft, dtype=np.float32)
    window[left : left + win_length] = win
    mel_fb = melscale_fbanks(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate)
    return window, mel_fb


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, S) waveform → (B, frames, n_fft), reflect-padded by n_fft//2 on
    both sides; frames = 1 + S // hop."""
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    return x.unfold(1, n_fft, hop)


def reflect_frames(x: torch.Tensor, n: torch.Tensor, n_frames: int,
                   n_fft: int, hop: int) -> torch.Tensor:
    """``frame_signal`` of ``x[:, :n]`` for a device sample count `n` (0-d
    integer, n_fft//2 < n <= x.shape[1]) and its ``n_frames`` = 1 + n //
    hop: the reflect padding is an index map, read without the host, so one
    program serves every length of a frame count (a captured chunk step's
    final tail). The same frames as ``frame_signal``, to the last bit."""
    pad = n_fft // 2
    j = (torch.arange((n_frames - 1) * hop + n_fft, device=x.device)
         - pad).abs()
    last = n.long() - 1
    j = torch.where(j > last, 2 * last - j, j).clamp(0, x.shape[1] - 1)
    return x[:, j].unfold(1, n_fft, hop)


def logmel_frontend(waveform: torch.Tensor, window: torch.Tensor,
                    mel_fb: torch.Tensor, mean: torch.Tensor,
                    inv_std: torch.Tensor, n_fft: int = 512,
                    hop: int = 160) -> torch.Tensor:
    """(B, S) float32 waveform → (B, frames, n_mels) normalized log-mel."""
    return logmel_of_frames(frame_signal(waveform, n_fft, hop), window,
                            mel_fb, mean, inv_std, n_fft)


def logmel_of_frames(frames: torch.Tensor, window: torch.Tensor,
                     mel_fb: torch.Tensor, mean: torch.Tensor,
                     inv_std: torch.Tensor, n_fft: int = 512) -> torch.Tensor:
    """(B, frames, n_fft) unwindowed frames → (B, frames, n_mels)
    normalized log-mel."""
    frames = frames * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    # Full-f32 mel projection (TF32 is off in every entry point).
    mel = torch.matmul(power, mel_fb)
    logmel = torch.log(torch.clamp(mel, min=1e-10))
    return (logmel - mean) * inv_std


class Frontend:
    """Stateless frontend op bundle with its constants on `device`."""

    def __init__(
        self,
        n_fft: int = 512,
        hop_length: int = 160,
        win_length: int = 400,
        n_mels: int = 80,
        sample_rate: int = 16000,
        mean: Optional[np.ndarray] = None,
        std: Optional[np.ndarray] = None,
        device: torch.device = torch.device("cpu"),
    ):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mels = n_mels
        self.device = torch.device(device)
        window, mel_fb = make_frontend_constants(
            n_fft, win_length, n_mels, sample_rate
        )
        self.window = torch.from_numpy(window).to(self.device)
        self.mel_fb = torch.from_numpy(mel_fb).to(self.device)
        if mean is None:
            mean = np.zeros(n_mels, dtype=np.float32)
        if std is None:
            std = np.ones(n_mels, dtype=np.float32)
        self.mean = torch.from_numpy(
            np.asarray(mean, dtype=np.float32)).to(self.device)
        self.inv_std = torch.from_numpy(
            (1.0 / np.asarray(std, dtype=np.float32)).astype(np.float32)
        ).to(self.device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def __call__(self, waveform) -> torch.Tensor:
        """(B, S) or (S,) waveform → (B, frames, n_mels) normalized log-mel."""
        waveform = self._tensor(waveform)
        if waveform.dim() == 1:
            waveform = waveform[None, :]
        return logmel_frontend(waveform, self.window, self.mel_fb, self.mean,
                               self.inv_std, n_fft=self.n_fft,
                               hop=self.hop_length)

    def normalize_only(self, feats) -> torch.Tensor:
        """MVN for pre-computed features (T, n_mels) → (1, T, n_mels)."""
        feats = self._tensor(feats)
        if feats.dim() == 2:
            feats = feats[None, :, :]
        return (feats - self.mean) * self.inv_std

    def n_frames(self, n_samples: int) -> int:
        return 1 + n_samples // self.hop_length
