"""Energy-based endpointing: segment long audio at low-energy cut points
(port of ``speechcatcher_tpu/endpointing.py``).

Log-filterbank energy, Gaussian-smoothed (σ=20) and negated, then a beam
search over candidate cut points that balances a segment-length reward
(ideal ~60 s) against the energy at the cut; segments are capped at 180 s.
Host-side numpy/scipy: it decides which spans the decoder gets.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from speechcatcher_tpu_torch.ops.mel import melscale_fbanks

FRAMES_PER_SEC = 100  # 10 ms hop


def log_fbank_energy(data: np.ndarray, samplerate: int,
                     n_filt: int = 26) -> np.ndarray:
    """Per-frame summed log mel-filterbank energy (25 ms window, 10 ms hop)."""
    data = np.asarray(data, dtype=np.float32)
    win = int(0.025 * samplerate)
    hop = int(0.01 * samplerate)
    n_fft = 512
    n_frames = max(1 + (len(data) - win) // hop, 1)
    idx = (np.arange(n_frames) * hop)[:, None] + np.arange(win)[None, :]
    idx = np.minimum(idx, len(data) - 1)
    frames = data[idx]
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    power = (spec.real**2 + spec.imag**2) / n_fft
    fb = melscale_fbanks(n_fft // 2 + 1, 0.0, samplerate / 2.0, n_filt,
                         samplerate)
    feat = np.maximum(power @ fb, np.finfo(np.float32).eps)
    return np.log(feat).sum(axis=-1) / 10.0


class SegmentSearch:
    """Beam search over cut positions."""

    def __init__(
        self,
        beam_size: int = 10,
        ideal_segment_len: int = 6000,
        max_lookahead: int = 18000,
        min_len: int = 2000,
        step: int = 10,
        len_reward_weight: float = 1.0,
        energy_weight: float = 1.0,
    ):
        self.beam_size = beam_size
        self.ideal = ideal_segment_len
        self.max_lookahead = max_lookahead
        self.min_len = min_len
        self.step = step
        self.len_w = len_reward_weight
        self.energy_w = energy_weight
        self.len_factor = len_reward_weight / float(ideal_segment_len)

    def _cost(self, seg_len: int, energy_at_cut: float) -> float:
        length_reward = self.len_factor * (
            self.ideal - abs(self.ideal - float(seg_len))
        )
        return self.len_w * length_reward + self.energy_w * energy_at_cut

    def search(self, smoothed_energy: np.ndarray,
               n_frames: int) -> List[Tuple[int, int]]:
        beams = [([0], 0.0)]
        while True:
            candidates = []
            expanded = False
            for cuts, score in beams:
                last = cuts[-1]
                best_so_far = beams[-1][1]
                upper = min(self.max_lookahead, n_frames - last - 1)
                for j in range(self.min_len, upper, self.step):
                    new_score = score + self._cost(
                        j, float(smoothed_energy[last + j])
                    )
                    if new_score > score:
                        candidates.append((cuts + [last + j + 1], new_score))
                    if new_score > best_so_far:
                        expanded = True
            if not candidates or not expanded:
                break
            candidates.sort(key=lambda c: c[1], reverse=True)
            beams = candidates[: self.beam_size]

        cuts = beams[0][0] if beams[0][0] != [0] else [0, n_frames]
        return list(zip(cuts[:-1], cuts[1:]))


def segment_speech(
    data: np.ndarray,
    samplerate: int,
    average_segment_length: float = 60.0,
    max_segment_len_sec: float = 180,
    beam_size: int = 10,
    step: int = 10,
    len_reward_weight: float = 12.0,
    energy_weight: float = 1.0,
) -> List[Tuple[int, int]]:
    """Segment audio; returns (start, end) in 10 ms frames."""
    from scipy.ndimage import gaussian_filter1d

    energy = log_fbank_energy(data, samplerate)
    smoothed = gaussian_filter1d(energy, sigma=20) * -1.0
    n_frames = len(energy)

    search = SegmentSearch(
        beam_size=beam_size,
        ideal_segment_len=int(average_segment_length * FRAMES_PER_SEC),
        step=step,
        len_reward_weight=len_reward_weight,
        energy_weight=energy_weight,
    )
    segments = search.search(smoothed, n_frames)

    max_frames = int(max_segment_len_sec * FRAMES_PER_SEC)
    constrained: List[Tuple[int, int]] = []
    for start, end in segments:
        while end - start > max_frames:
            constrained.append((start, start + max_frames))
            start += max_frames
        constrained.append((start, end))
    return constrained
