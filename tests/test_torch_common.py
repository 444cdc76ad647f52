"""Shared builders for the PyTorch-port parity tests (no tests here).

The same numpy inputs and the same numpy weights go through the JAX package
and through speechcatcher_tpu_torch on the CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speechcatcher_tpu.config import ModelConfig as JaxConfig
from speechcatcher_tpu_torch.config import ModelConfig
from speechcatcher_tpu_torch.synth import synth_audio  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")


# Fields the port's config has and the JAX package's has not: the keys of
# ESPnet's contextual-block conformer, a kind the JAX package lacks, and
# those of the fused language model, which it lacks too.
PORT_ONLY = ("macaron_style", "activation_type", "lm_layers", "lm_dim",
             "lm_heads", "lm_linear_units", "lm_embed_dim", "lm_weight")


def shared_fields(cfg) -> dict:
    """A config of either package as a dict of the fields both have."""
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in PORT_ONLY}


def jax_config(cfg: ModelConfig) -> JaxConfig:
    """The JAX package's config of a port config of a kind both packages
    have (the port-only fields at their defaults)."""
    assert cfg.encoder_type in ("transformer", "conformer"), cfg.encoder_type
    for k in PORT_ONLY:
        assert getattr(cfg, k) == getattr(ModelConfig, k), k
    return JaxConfig(**shared_fields(cfg))


def jax_model(cfg: ModelConfig, tree, mean=None, std=None):
    """A JAX ASRModel around a numpy parameter tree, through the
    dataclass constructor."""
    from speechcatcher_tpu.models.asr_model import ASRModel
    from speechcatcher_tpu.models.decoder import decoder_pe_table
    from speechcatcher_tpu.models.encoder import encoder_pe_table
    from speechcatcher_tpu.ops.frontend import Frontend
    from speechcatcher_tpu.tokenizer import Tokenizer

    jcfg = jax_config(cfg)
    return ASRModel(
        cfg=jcfg,
        params=jax.tree.map(jnp.asarray, tree),
        frontend=Frontend(n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                          win_length=cfg.win_length, n_mels=cfg.n_mels,
                          sample_rate=cfg.sample_rate, mean=mean, std=std),
        tokenizer=Tokenizer.dummy(cfg.vocab_size),
        enc_pe=encoder_pe_table(jcfg),
        dec_pe=decoder_pe_table(jcfg),
    )


def bias_outputs(tree, cfg: ModelConfig, eos: float = 4.0,
                 blank: float = 10.0):
    """EOS +4 on the decoder output bias and blank +10 on the CTC bias, the
    emission profile of the JAX bench's random model."""
    tree["decoder"]["output_layer"]["bias"][cfg.eos_id] += np.float32(eos)
    tree["ctc"]["ctc_lo"]["bias"][cfg.blank_id] += np.float32(blank)
    return tree


def t(x) -> torch.Tensor:
    """numpy / JAX array → CPU tensor."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """tensor / JAX array → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
