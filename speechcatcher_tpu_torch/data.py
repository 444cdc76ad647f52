"""Training data: datasets and bucketed fixed-shape batches (port of
``speechcatcher_tpu/data.py``).

Every batch is padded to one of a fixed, small set of (wave samples, target
tokens) bucket shapes; features come from the port's ``Frontend`` on its
device, batched over the whole bucket. Buckets grow geometrically, so
padding wastes less than half a batch. Utterances beyond the largest bucket,
or too short in encoder frames for their targets, are dropped and counted.

Data sources: Kaldi-style directories (wav.scp + text, the format
``decode_kaldidir.py`` reads) and a synthetic dataset whose draws equal the
JAX package's, utterance for utterance.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from speechcatcher_tpu_torch.config import ModelConfig
from speechcatcher_tpu_torch.ops.frontend import Frontend
from speechcatcher_tpu_torch.geometry import subsampled_len
from speechcatcher_tpu_torch.tokenizer import Tokenizer

logger = logging.getLogger(__name__)


class Utterance(NamedTuple):
    uttid: str
    wave: np.ndarray  # float32 in [-1, 1] at cfg.sample_rate
    text: str


def read_kaldi_dir(data_dir: Path, limit: Optional[int] = None
                   ) -> List[Utterance]:
    """Load a Kaldi-style data dir (wav.scp + text) into memory. wav.scp
    entries are plain paths or trailing-pipe commands; an utterance without
    a transcript is skipped with a log line."""
    from speechcatcher_tpu_torch.decode_kaldidir import (
        load_entry,
        read_wav_scp,
    )
    from speechcatcher_tpu_torch.wer import read_kaldi_text

    data_dir = Path(data_dir)
    texts = read_kaldi_text(str(data_dir / "text"))
    utts: List[Utterance] = []
    for uttid, spec in read_wav_scp(data_dir / "wav.scp"):
        if uttid not in texts:
            logger.warning("No transcript for %s; skipped", uttid)
            continue
        pcm, _ = load_entry(spec)
        utts.append(Utterance(uttid, pcm.astype(np.float32) / 32768.0,
                              texts[uttid]))
        if limit is not None and len(utts) >= limit:
            break
    return utts


def synthetic_dataset(n_utts: int, cfg: ModelConfig, tokenizer: Tokenizer,
                      seed: int = 0, min_sec: float = 0.5,
                      max_sec: float = 4.0) -> List[Utterance]:
    """Deterministic random utterances whose texts round-trip through
    ``tokenizer.text_to_ids``: the stand-in for a corpus in smoke runs."""
    rng = np.random.RandomState(seed)
    words = [p.lstrip("▁") for p in tokenizer.token_list[2:-1]
             if p.startswith("▁") and len(p) > 1]
    if not words:
        words = ["t0", "t1", "t2"]
    utts = []
    for i in range(n_utts):
        n_samp = int(cfg.sample_rate * rng.uniform(min_sec, max_sec))
        wave = (rng.randn(n_samp) * 0.1).astype(np.float32)
        text = " ".join(rng.choice(words, size=rng.randint(2, 9)))
        utts.append(Utterance(f"synth{i:05d}", wave, text))
    return utts


def train_eval_split(utts: Sequence[Utterance], eval_frac: float = 0.1,
                     seed: int = 0
                     ) -> Tuple[List[Utterance], List[Utterance]]:
    order = np.random.RandomState(seed).permutation(len(utts))
    n_eval = max(1, int(len(utts) * eval_frac)) if eval_frac > 0 else 0
    eval_idx = set(order[:n_eval].tolist())
    train = [u for i, u in enumerate(utts) if i not in eval_idx]
    evals = [u for i, u in enumerate(utts) if i in eval_idx]
    return train, evals


def _bucket_for(value: int, buckets: Sequence[int]) -> Optional[int]:
    for b in buckets:
        if value <= b:
            return b
    return None


class BucketBatcher:
    """Groups utterances into fixed-shape, feature-ready TrainBatches.

    Each batch has its waves padded to a sample bucket and its targets to a
    token bucket. An utterance beyond the largest bucket on either axis, or
    with fewer encoder frames than the 2U+1 its U targets need under CTC, is
    dropped loudly (``n_dropped``); none is truncated."""

    def __init__(
        self,
        frontend: Frontend,
        tokenizer: Tokenizer,
        batch_size: int = 8,
        sample_buckets: Optional[Sequence[int]] = None,
        token_buckets: Sequence[int] = (16, 32, 64, 128),
        sample_rate: int = 16000,
        input_layer: str = "conv2d",
    ):
        if sample_buckets is None:
            # 2 s .. 32 s, geometric: segmented ASR utterances.
            sample_buckets = [sample_rate * s for s in (2, 4, 8, 16, 32)]
        self.frontend = frontend
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.sample_buckets = sorted(sample_buckets)
        self.token_buckets = sorted(token_buckets)
        self.input_layer = input_layer
        self.n_dropped = 0

    def _subsampled_frames(self, n_samples: int) -> int:
        """Encoder frames after the model's subsampling."""
        return subsampled_len(self.frontend.n_frames(n_samples),
                              self.input_layer)

    def _encode_targets(self, utt: Utterance) -> Optional[List[int]]:
        ids = self.tokenizer.text_to_ids(utt.text)
        # CTC needs a frame per label and a blank between repeats: 2U+1
        # frames always suffice, and the guard asks for them.
        if not ids or 2 * len(ids) + 1 > self._subsampled_frames(
                len(utt.wave)):
            return None
        return ids

    def batches(self, utts: Sequence[Utterance],
                shuffle_seed: Optional[int] = None,
                with_refs: bool = False) -> Iterator:
        """Yield TrainBatch (or (TrainBatch, ref_texts) when with_refs).

        Groups by (sample bucket, token bucket); partial groups flush at the
        end of the pass, padded by repeating their last row so the batch
        shape stays fixed."""
        order = list(range(len(utts)))
        if shuffle_seed is not None:
            np.random.RandomState(shuffle_seed).shuffle(order)

        groups: dict = {}
        for idx in order:
            utt = utts[idx]
            ids = self._encode_targets(utt)
            sb = _bucket_for(len(utt.wave), self.sample_buckets)
            tb = _bucket_for(len(ids), self.token_buckets) if ids else None
            if ids is None or sb is None or tb is None:
                self.n_dropped += 1
                logger.warning(
                    "Dropped %s (%.1fs, %s tokens): exceeds buckets or "
                    "too short for its targets", utt.uttid,
                    len(utt.wave) / 16000.0, ids and len(ids))
                continue
            groups.setdefault((sb, tb), []).append((utt, ids))
            if len(groups[(sb, tb)]) == self.batch_size:
                yield self._emit(groups.pop((sb, tb)), sb, tb, with_refs)
        for (sb, tb), group in sorted(groups.items()):
            n_real = len(group)
            while len(group) < self.batch_size:
                group.append(group[-1])
            yield self._emit(group, sb, tb, with_refs, n_real)

    def _emit(self, group, sb: int, tb: int, with_refs: bool,
              n_real: Optional[int] = None):
        from speechcatcher_tpu_torch.training import TrainBatch

        b = len(group)
        waves = np.zeros((b, sb), np.float32)
        tokens = np.zeros((b, tb), np.int32)
        feat_lens = np.zeros((b,), np.int32)
        token_lens = np.zeros((b,), np.int32)
        for i, (utt, ids) in enumerate(group):
            waves[i, : len(utt.wave)] = utt.wave
            tokens[i, : len(ids)] = ids
            feat_lens[i] = self.frontend.n_frames(len(utt.wave))
            token_lens[i] = len(ids)
        dev = self.frontend.device
        with torch.no_grad():
            feats = self.frontend(waves)
        batch = TrainBatch(
            feats=feats,
            feat_lens=torch.from_numpy(feat_lens).to(dev),
            tokens=torch.from_numpy(tokens).to(dev),
            token_lens=torch.from_numpy(token_lens).to(dev),
        )
        if with_refs:
            # Only the real rows' refs: the flush pads repeat the last row.
            return batch, [utt.text for utt, _ in group[: n_real or b]]
        return batch
