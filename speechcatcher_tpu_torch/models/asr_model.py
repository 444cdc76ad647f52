"""ASR model assembly: frontend + encoder + decoder + CTC (port of
``speechcatcher_tpu/models/asr_model.py``).

``params`` keeps the JAX package's tree except that each ``layers`` entry
is a list of per-layer dicts (views into the layer-stacked tensors).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from speechcatcher_tpu_torch.config import ModelConfig
from speechcatcher_tpu_torch.device import resolve_device
from speechcatcher_tpu_torch.models.decoder import decoder_pe_table
from speechcatcher_tpu_torch.models.encoder import encoder_pe_table
from speechcatcher_tpu_torch.ops.frontend import Frontend
from speechcatcher_tpu_torch.params import (
    params_from_numpy,
    random_params,
    unstack_layers,
)
from speechcatcher_tpu_torch.tokenizer import Tokenizer, find_bpe_model

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ASRModel:
    """Bundle of everything a decoding session needs."""

    cfg: ModelConfig
    params: Dict[str, Any]   # {"encoder", "decoder", "ctc"[, "lm"]}
    frontend: Frontend
    tokenizer: Tokenizer
    enc_pe: torch.Tensor
    dec_pe: torch.Tensor
    device: torch.device

    @classmethod
    def from_numpy(cls, cfg: ModelConfig, tree: Dict[str, Any],
                   device: Union[str, torch.device] = "cuda",
                   mean: Optional[np.ndarray] = None,
                   std: Optional[np.ndarray] = None,
                   tokenizer: Optional[Tokenizer] = None) -> "ASRModel":
        """Model from a numpy parameter tree in the JAX package's layout
        (float32; the precision modes cast it afterwards). Without a
        tokenizer it gets the dummy one."""
        dev = resolve_device(device)
        params = params_from_numpy(tree, dev)
        for part in ("encoder", "decoder", "lm"):
            if part in params:
                params[part]["layers"] = unstack_layers(
                    params[part]["layers"])
        frontend = Frontend(
            n_fft=cfg.n_fft, hop_length=cfg.hop_length,
            win_length=cfg.win_length, n_mels=cfg.n_mels,
            sample_rate=cfg.sample_rate, mean=mean, std=std, device=dev,
        )
        return cls(
            cfg=cfg,
            params=params,
            frontend=frontend,
            tokenizer=tokenizer or Tokenizer.dummy(cfg.vocab_size),
            enc_pe=torch.from_numpy(encoder_pe_table(cfg)).to(dev),
            dec_pe=torch.from_numpy(decoder_pe_table(cfg)).to(dev),
            device=dev,
        )

    @classmethod
    def random_init(cls, cfg: ModelConfig, seed: int = 0,
                    device: Union[str, torch.device] = "cuda",
                    mean: Optional[np.ndarray] = None,
                    std: Optional[np.ndarray] = None) -> "ASRModel":
        """Random-weight model from ``params.random_params(cfg, seed)``."""
        resolve_device(device)
        return cls.from_numpy(cfg, random_params(cfg, seed), device,
                              mean=mean, std=std)

    @classmethod
    def from_directory(cls, model_dir: Union[str, Path],
                       device: Union[str, torch.device] = "cuda"
                       ) -> "ASRModel":
        """Load an unpacked ESPnet model directory (config.yaml + *.pth +
        feats_stats.npz + bpe.model) onto `device`, the card by default.
        Without a config.yaml the architecture is inferred from the
        checkpoint's shapes over the default config; without a bpe.model the
        model gets the dummy tokenizer."""
        from speechcatcher_tpu_torch.checkpoint import (
            find_checkpoint,
            find_stats,
            load_espnet_checkpoint,
            load_normalization_stats,
        )

        resolve_device(device)
        model_dir = Path(model_dir)
        config_path = model_dir / "config.yaml"
        ckpt = find_checkpoint(model_dir)
        if ckpt is None:
            raise FileNotFoundError(f"No checkpoint found in {model_dir}")
        tree, cfg, arch = load_espnet_checkpoint(
            ckpt, config_path=config_path if config_path.exists() else None)
        logger.info("Loaded %s with arch %s", ckpt, arch)

        mean = std = None
        stats_path = find_stats(model_dir)
        if stats_path is not None:
            mean, std = load_normalization_stats(stats_path)

        tokenizer = None
        bpe_path = find_bpe_model(model_dir)
        if bpe_path is not None:
            tokenizer = Tokenizer.from_sentencepiece(bpe_path)
        else:
            logger.warning("No bpe.model found in %s; using dummy tokenizer",
                           model_dir)
        return cls.from_numpy(cfg, tree, device, mean=mean, std=std,
                              tokenizer=tokenizer)
