"""Model/architecture configuration (PyTorch port).

The port's own copy of ``speechcatcher_tpu/config.py``: one frozen dataclass
holds every architecture constant. The storage-dtype properties return torch
dtypes instead of JAX ones. ``flagship_config()`` is the de_streaming_
transformer_xl-class architecture the port is measured at.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

CB_CONFORMER = "contextual_block_conformer"
ENCODER_TYPES = ("transformer", "conformer", CB_CONFORMER)
# The activations of ``contextual_block_conformer`` layers the port computes.
ACTIVATIONS = ("swish",)
# The language models the port fuses into its beam search (ESPnet's ``lm``).
LM_TYPES = ("transformer",)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Complete architecture description of one streaming ASR model."""

    # Vocabulary (ESPnet layout: [<blank>, <unk>=sp0, sp3.., <sos/eos>]).
    vocab_size: int = 1024
    blank_id: int = 0

    # Frontend.
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    n_mels: int = 80

    # Encoder.
    encoder_dim: int = 256
    encoder_heads: int = 4
    encoder_linear_units: int = 2048
    encoder_layers: int = 12
    input_layer: str = "conv2d"  # conv2d | conv2d6 | conv2d8 | linear
    normalize_before: bool = True
    block_size: int = 40
    hop_size: int = 16
    look_ahead: int = 16
    init_average: bool = True
    ctx_pos_enc: bool = True
    pos_enc_max_len: int = 5000
    encoder_type: str = "transformer"  # see ENCODER_TYPES

    conformer_kernel_size: int = 31
    # ``contextual_block_conformer`` only: ESPnet's ``macaron_style`` (a
    # half-step feed-forward before the attention, both halved) and
    # ``activation_type`` of the feed-forwards and the convolution module.
    # The port's ``conformer`` is always macaron with ReLU feed-forwards.
    macaron_style: bool = True
    activation_type: str = "swish"

    # Decoder.
    decoder_dim: int = 256
    decoder_heads: int = 4
    decoder_linear_units: int = 2048
    decoder_layers: int = 6

    # Joint scoring.
    ctc_weight: float = 0.3
    pre_beam_size: int = 40

    # External language model, fused by shallow fusion (ESPnet's
    # ``TransformerLM`` with ``pos_enc: null``): a token embedding of
    # lm_embed_dim, a linear input layer to lm_dim, lm_layers pre-norm
    # self-attention layers, an output layer over the vocabulary. 0 layers:
    # no LM. lm_weight is the weight of its log-probabilities in the joint
    # score.
    lm_layers: int = 0
    lm_dim: int = 0
    lm_heads: int = 0
    lm_linear_units: int = 0
    lm_embed_dim: int = 0
    lm_weight: float = 0.0

    # Streaming capacity limits (fixed shapes of the device state).
    max_enc_frames: int = 2048
    max_tokens: int = 500

    # Storage dtypes ("float32" | "bfloat16") of the decoder activation
    # cache, the CTC log-prob ring and the emitted-frame ring.
    cache_dtype: str = "float32"
    ctc_ring_dtype: str = "float32"
    enc_ring_dtype: str = "float32"

    def __post_init__(self):
        if self.encoder_type not in ENCODER_TYPES:
            raise ValueError(f"encoder_type {self.encoder_type!r} is not one "
                             f"of {ENCODER_TYPES}")
        if (self.encoder_type == CB_CONFORMER
                and self.activation_type not in ACTIVATIONS):
            raise ValueError(f"activation_type {self.activation_type!r}: the "
                             f"port computes {ACTIVATIONS} alone")
        if self.lm_layers and (
                min(self.lm_dim, self.lm_heads, self.lm_linear_units,
                    self.lm_embed_dim) <= 0
                or self.lm_dim % self.lm_heads):
            raise ValueError("an LM needs positive lm_dim, lm_heads, "
                             "lm_linear_units and lm_embed_dim, lm_dim a "
                             "multiple of lm_heads")

    @property
    def cache_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.cache_dtype]

    @property
    def ctc_ring_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.ctc_ring_dtype]

    @property
    def enc_ring_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.enc_ring_dtype]

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def subsample(self) -> int:
        return {"conv2d": 4, "conv2d6": 6, "conv2d8": 8, "linear": 1}[
            self.input_layer
        ]

    @property
    def head_dim(self) -> int:
        return self.encoder_dim // self.encoder_heads

    @classmethod
    def from_yaml(cls, config_path: Path, vocab_size: Optional[int] = None,
                  **overrides: Any) -> "ModelConfig":
        """Build from an ESPnet config.yaml."""
        import yaml

        with open(config_path) as f:
            cfg = yaml.safe_load(f) or {}
        return cls.from_espnet_dict(cfg, vocab_size=vocab_size, **overrides)

    @classmethod
    def from_espnet_dict(cls, cfg: Dict[str, Any],
                         vocab_size: Optional[int] = None,
                         **overrides: Any) -> "ModelConfig":
        enc = cfg.get("encoder_conf", {}) or {}
        dec = cfg.get("decoder_conf", {}) or {}
        fr = cfg.get("frontend_conf", {}) or {}
        if vocab_size is None:
            token_list = cfg.get("token_list")
            vocab_size = len(token_list) if token_list else 1024
        # The yaml's name gives the kind unless the caller settled it: the
        # port's conformer and ESPnet's both go by contextual_block_conformer,
        # and only a checkpoint's keys tell them apart.
        encoder = str(cfg.get("encoder", "contextual_block_transformer"))
        if "encoder_type" in overrides:
            encoder_type = overrides["encoder_type"]
        elif encoder == CB_CONFORMER:
            encoder_type = CB_CONFORMER
        elif "conformer" in encoder:
            encoder_type = "conformer"
        else:
            encoder_type = "transformer"
        kwargs: Dict[str, Any] = dict(
            vocab_size=vocab_size,
            n_fft=fr.get("n_fft", 512),
            hop_length=fr.get("hop_length", 160),
            win_length=fr.get("win_length", 400) or fr.get("n_fft", 512),
            encoder_dim=enc.get("output_size", 256),
            encoder_heads=enc.get("attention_heads", 4),
            encoder_linear_units=enc.get("linear_units", 2048),
            encoder_layers=enc.get("num_blocks", 12),
            input_layer=enc.get("input_layer", "conv2d"),
            block_size=enc.get("block_size", 40),
            hop_size=enc.get("hop_size", 16),
            look_ahead=enc.get("look_ahead", 16),
            init_average=enc.get("init_average", True),
            ctx_pos_enc=enc.get("ctx_pos_enc", True),
            encoder_type=encoder_type,
            decoder_dim=enc.get("output_size", 256),
            decoder_heads=dec.get("attention_heads", 4),
            decoder_linear_units=dec.get("linear_units", 2048),
            decoder_layers=dec.get("num_blocks", 6),
        )
        if encoder_type == CB_CONFORMER:
            kwargs.update(_cb_conformer_keys(enc, fr))
        if "lm_conf" in cfg or "lm" in cfg:
            kwargs.update(_lm_keys(cfg))
        kwargs.update(overrides)
        return cls(**kwargs)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _cb_conformer_keys(enc: Dict[str, Any], fr: Dict[str, Any]
                       ) -> Dict[str, Any]:
    """The ``contextual_block_conformer`` keys of an ESPnet encoder_conf, at
    ESPnet's defaults where absent (no macaron, 31 taps, swish), and the
    frontend's, at the defaults of ESPnet's ``DefaultFrontend`` (n_fft 512,
    win_length n_fft, hop_length 128, 80 mels) that its recipes get without
    a frontend_conf. Refuses, naming the key, what the port does not
    compute."""
    if not enc.get("use_cnn_module", True):
        raise ValueError("use_cnn_module: false: the port's "
                         "contextual_block_conformer always has the "
                         "convolution module")
    act = enc.get("activation_type", "swish")
    if act not in ACTIVATIONS:
        raise ValueError(f"activation_type {act!r}: the port's "
                         f"contextual_block_conformer computes "
                         f"{ACTIVATIONS} alone")
    return dict(macaron_style=bool(enc.get("macaron_style", False)),
                conformer_kernel_size=int(enc.get("cnn_module_kernel", 31)),
                activation_type=act,
                n_fft=fr.get("n_fft", 512),
                win_length=fr.get("win_length") or fr.get("n_fft", 512),
                hop_length=fr.get("hop_length", 128),
                n_mels=fr.get("n_mels", 80))


def _lm_keys(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The LM keys of an ESPnet language-model config (``lm`` and its
    ``lm_conf``, at ``TransformerLM``'s defaults where absent) and a decode
    config's ``lm_weight``. Refuses, naming the key, what the port does not
    compute."""
    lm = str(cfg.get("lm", "transformer"))
    if lm not in LM_TYPES:
        raise ValueError(f"lm {lm!r}: the port fuses {LM_TYPES} alone")
    conf = cfg.get("lm_conf", {}) or {}
    if conf.get("pos_enc") is not None:
        raise ValueError(f"lm_conf.pos_enc {conf['pos_enc']!r}: the port's "
                         f"transformer LM has no positional encoding "
                         f"(pos_enc: null)")
    return dict(lm_embed_dim=int(conf.get("embed_unit", 128)),
                lm_dim=int(conf.get("att_unit", 256)),
                lm_heads=int(conf.get("head", 2)),
                lm_linear_units=int(conf.get("unit", 1024)),
                lm_layers=int(conf.get("layer", 4)),
                lm_weight=float(cfg.get("lm_weight", 0.0)))


def tiny_config(**overrides: Any) -> ModelConfig:
    """A miniature config for fast unit tests (no model download)."""
    kwargs: Dict[str, Any] = dict(
        vocab_size=32,
        encoder_dim=16,
        encoder_heads=2,
        encoder_linear_units=32,
        encoder_layers=2,
        decoder_dim=16,
        decoder_heads=2,
        decoder_linear_units=32,
        decoder_layers=2,
        block_size=8,
        hop_size=4,
        look_ahead=2,
        max_enc_frames=256,
        max_tokens=160,
    )
    kwargs.update(overrides)
    return ModelConfig(**kwargs)


def flagship_config(**overrides: Any) -> ModelConfig:
    """The flagship streaming transformer: d=512, 8 heads, 18 encoder and
    6 decoder layers, FFN 2048, vocab 1024, block 40 / hop 16 / look-ahead
    16, with serving capacities of 768 encoder frames and 192 tokens."""
    kwargs: Dict[str, Any] = dict(
        vocab_size=1024,
        encoder_dim=512,
        encoder_heads=8,
        encoder_layers=18,
        encoder_linear_units=2048,
        decoder_dim=512,
        decoder_heads=8,
        decoder_layers=6,
        decoder_linear_units=2048,
        max_enc_frames=768,
        max_tokens=192,
    )
    kwargs.update(overrides)
    return ModelConfig(**kwargs)
