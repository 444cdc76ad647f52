"""ESPnet .pth checkpoint → numpy parameter tree (port of
``speechcatcher_tpu/checkpoint.py``).

A one-time conversion on the CPU: the state dict is deserialized with
``torch.load``, its arrays are renamed into the nested tree that
``params.params_from_numpy`` takes (layer-stacked ``layers`` leaves, torch
layouts kept), and the model then moves it to its device. Kept from the
reference loader:
- shape-based architecture inference, and the encoder layer decided from
  the keys (``encoder_layer_kind``),
- a name mapping that keeps encoder./decoder./ctc. keys and drops
  frontend./normalize_ keys, and ESPnet's ``TransformerLM`` (``lm.*``, as
  ``ESPnetLanguageModel`` saves it, from the ASR checkpoint or a file of
  its own) into the ``lm`` subtree,
- MVN stats from feats_stats.npz stored as mean/std or
  sum/sum_square/count.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from speechcatcher_tpu_torch.config import CB_CONFORMER, ModelConfig

logger = logging.getLogger(__name__)


def _load_state_dict(checkpoint_path: Path) -> Dict[str, np.ndarray]:
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        sd = ckpt["model"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    else:
        sd = ckpt
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def infer_architecture(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Shape-based architecture inference from a state dict's keys and
    shapes."""
    arch: Dict[str, Any] = {}

    def count_layers(prefix: str) -> int:
        idx = set()
        pat = re.compile(rf"{prefix}\.(\d+)\.")
        for k in sd:
            m = pat.search(k)
            if m:
                idx.add(int(m.group(1)))
        return max(idx) + 1 if idx else 0

    arch["encoder_layers"] = count_layers("encoder.encoders")
    arch["decoder_layers"] = count_layers("decoder.decoders")

    for k, v in sd.items():
        if k.startswith("encoder.") and "self_attn.linear_q.weight" in k:
            arch["encoder_dim"] = int(v.shape[1])
            break
    for k, v in sd.items():
        if k.startswith("encoder.") and "feed_forward.w_1.weight" in k:
            arch["encoder_linear_units"] = int(v.shape[0])
            break
    for k, v in sd.items():
        if k.startswith("decoder.") and "feed_forward.w_1.weight" in k:
            arch["decoder_linear_units"] = int(v.shape[0])
            break
    if "decoder.output_layer.weight" in sd:
        arch["vocab_size"] = int(sd["decoder.output_layer.weight"].shape[0])
    elif "decoder.embed.0.weight" in sd:
        arch["vocab_size"] = int(sd["decoder.embed.0.weight"].shape[0])
    if "ctc.ctc_lo.weight" in sd:
        arch["ctc_vocab_size"] = int(sd["ctc.ctc_lo.weight"].shape[0])
    if _LM_IN in sd:
        # The LM's widths; its heads are not in the shapes (lm_conf).
        arch["lm_layers"] = count_layers("lm.encoder.encoders")
        arch["lm_dim"], arch["lm_embed_dim"] = (int(n) for n in
                                                sd[_LM_IN].shape)
        arch["lm_linear_units"] = int(
            sd["lm.encoder.encoders.0.feed_forward.w_1.weight"].shape[0])
    # Mel dim from first conv input feature width is not recoverable from
    # shapes alone (kernel only); frontend dims come from config.yaml.
    return arch


def _get(sd: Dict[str, np.ndarray], *names: str) -> Optional[np.ndarray]:
    for n in names:
        if n in sd:
            return sd[n]
    return None


def _linear(sd, prefix: str) -> Dict[str, np.ndarray]:
    w = _get(sd, f"{prefix}.weight")
    out = {"weight": np.asarray(w, dtype=np.float32)}
    b = _get(sd, f"{prefix}.bias")
    if b is not None:
        out["bias"] = np.asarray(b, dtype=np.float32)
    return out


def _norm(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {
        "weight": np.asarray(_get(sd, f"{prefix}.weight"), dtype=np.float32),
        "bias": np.asarray(_get(sd, f"{prefix}.bias"), dtype=np.float32),
    }


def _mha(sd, prefix: str) -> Dict[str, Any]:
    return {
        "linear_q": _linear(sd, f"{prefix}.linear_q"),
        "linear_k": _linear(sd, f"{prefix}.linear_k"),
        "linear_v": _linear(sd, f"{prefix}.linear_v"),
        "linear_out": _linear(sd, f"{prefix}.linear_out"),
    }


def _ffn(sd, prefix: str) -> Dict[str, Any]:
    return {
        "w_1": _linear(sd, f"{prefix}.w_1"),
        "w_2": _linear(sd, f"{prefix}.w_2"),
    }


def _stack(layers) -> Any:
    """Per-layer trees → one tree whose leaves carry a leading layer axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return np.stack([np.asarray(x) for x in layers])


def _conv_module(sd, cm: str) -> Dict[str, Any]:
    """A conformer convolution module; its BatchNorm is ``norm`` (ESPnet)
    or ``batch_norm``."""
    bn = f"{cm}.norm" if f"{cm}.norm.weight" in sd else f"{cm}.batch_norm"
    return {
        "pointwise_conv1": _linear(sd, f"{cm}.pointwise_conv1"),
        "depthwise_conv": _linear(sd, f"{cm}.depthwise_conv"),
        "pointwise_conv2": _linear(sd, f"{cm}.pointwise_conv2"),
        "batch_norm": {
            name: np.asarray(_get(sd, f"{bn}.{name}"), dtype=np.float32)
            for name in ("weight", "bias", "running_mean", "running_var")
        },
    }


_LAYER0 = "encoder.encoders.0."
_LM_IN = "lm.encoder.embed.0.weight"


def _has_macaron(sd: Dict[str, np.ndarray]) -> bool:
    return any(k.startswith(_LAYER0 + "feed_forward_macaron.") for k in sd)


def encoder_layer_kind(sd: Dict[str, np.ndarray]) -> Optional[str]:
    """The conformer layer a state dict holds, decided from its keys: a
    ``self_attn.linear_pos`` is the port's relative-attention conformer
    (``conformer``); ``norm_mha`` without it ESPnet's contextual-block
    conformer (``contextual_block_conformer``); neither, None."""
    if not any(k.startswith(_LAYER0 + "norm_mha") for k in sd):
        return None
    if _LAYER0 + "self_attn.linear_pos.weight" in sd:
        return "conformer"
    return CB_CONFORMER


def convert_state_dict(
    sd: Dict[str, np.ndarray], cfg: ModelConfig
) -> Dict[str, Any]:
    """Numpy state_dict → {encoder, decoder, ctc} numpy parameter tree."""
    if cfg.input_layer == "linear":
        # Sequential: Linear at 0, LayerNorm at 1 (Dropout/ReLU hold no
        # params).
        embed_tree: Dict[str, Any] = {
            "out": {
                "weight": np.asarray(_get(sd, "encoder.embed.0.weight")),
                "bias": np.asarray(_get(sd, "encoder.embed.0.bias")),
            },
            "norm": {
                "weight": np.asarray(_get(sd, "encoder.embed.1.weight")),
                "bias": np.asarray(_get(sd, "encoder.embed.1.bias")),
            },
        }
    else:
        n_convs = {"conv2d": 2, "conv2d6": 2, "conv2d8": 3}[cfg.input_layer]
        convs = []
        for i in range(n_convs):
            # Sequential indices: Conv2d at 0, 2, 4 (ReLU between).
            # Checkpoints may name the stack embed.conv.N (ESPnet) or
            # embed.N.
            w = _get(sd, f"encoder.embed.conv.{2*i}.weight",
                     f"encoder.embed.{2*i}.weight")
            b = _get(sd, f"encoder.embed.conv.{2*i}.bias",
                     f"encoder.embed.{2*i}.bias")
            convs.append({"weight": np.asarray(w), "bias": np.asarray(b)})
        embed_out = _get(sd, "encoder.embed.out.weight",
                         "encoder.embed.out.0.weight")
        embed_out_b = _get(sd, "encoder.embed.out.bias",
                           "encoder.embed.out.0.bias")
        embed_tree = {
            "convs": convs,
            "out": {"weight": np.asarray(embed_out),
                    "bias": np.asarray(embed_out_b)},
        }

    kind = encoder_layer_kind(sd) or cfg.encoder_type
    enc_layers = []
    for i in range(cfg.encoder_layers):
        p = f"encoder.encoders.{i}"
        if kind == "transformer":
            enc_layers.append(
                {
                    "self_attn": _mha(sd, f"{p}.self_attn"),
                    "feed_forward": _ffn(sd, f"{p}.feed_forward"),
                    "norm1": _norm(sd, f"{p}.norm1"),
                    "norm2": _norm(sd, f"{p}.norm2"),
                }
            )
            continue
        attn = _mha(sd, f"{p}.self_attn")
        if kind == "conformer":
            attn["linear_pos"] = _linear(sd, f"{p}.self_attn.linear_pos")
            attn["pos_bias_u"] = np.asarray(
                _get(sd, f"{p}.self_attn.pos_bias_u"), dtype=np.float32
            )
            attn["pos_bias_v"] = np.asarray(
                _get(sd, f"{p}.self_attn.pos_bias_v"), dtype=np.float32
            )
        layer = {
            "self_attn": attn,
            "feed_forward": _ffn(sd, f"{p}.feed_forward"),
            "conv_module": _conv_module(sd, f"{p}.conv_module"),
            "norm_ff": _norm(sd, f"{p}.norm_ff"),
            "norm_mha": _norm(sd, f"{p}.norm_mha"),
            "norm_conv": _norm(sd, f"{p}.norm_conv"),
            "norm_final": _norm(sd, f"{p}.norm_final"),
        }
        # The port's conformer is always macaron; ESPnet's layer where the
        # checkpoint has the macaron feed-forward.
        if kind == "conformer" or _has_macaron(sd):
            layer["feed_forward_macaron"] = _ffn(
                sd, f"{p}.feed_forward_macaron")
            layer["norm_ff_macaron"] = _norm(sd, f"{p}.norm_ff_macaron")
        enc_layers.append(layer)

    encoder = {
        "embed": embed_tree,
        "layers": _stack(enc_layers),
        "after_norm": {
            "weight": np.asarray(_get(sd, "encoder.after_norm.weight")),
            "bias": np.asarray(_get(sd, "encoder.after_norm.bias")),
        },
    }

    dec_layers = []
    for i in range(cfg.decoder_layers):
        p = f"decoder.decoders.{i}"
        dec_layers.append(
            {
                "self_attn": _mha(sd, f"{p}.self_attn"),
                "src_attn": _mha(sd, f"{p}.src_attn"),
                "feed_forward": _ffn(sd, f"{p}.feed_forward"),
                "norm1": _norm(sd, f"{p}.norm1"),
                "norm2": _norm(sd, f"{p}.norm2"),
                "norm3": _norm(sd, f"{p}.norm3"),
            }
        )
    decoder = {
        "embed": {"weight": np.asarray(_get(sd, "decoder.embed.0.weight"))},
        "layers": _stack(dec_layers),
        "after_norm": {
            "weight": np.asarray(_get(sd, "decoder.after_norm.weight")),
            "bias": np.asarray(_get(sd, "decoder.after_norm.bias")),
        },
        "output_layer": {
            "weight": np.asarray(_get(sd, "decoder.output_layer.weight")),
            "bias": np.asarray(_get(sd, "decoder.output_layer.bias")),
        },
    }

    ctc = {
        "ctc_lo": {
            "weight": np.asarray(_get(sd, "ctc.ctc_lo.weight")),
            "bias": np.asarray(_get(sd, "ctc.ctc_lo.bias")),
        }
    }

    tree = {"encoder": encoder, "decoder": decoder, "ctc": ctc}
    if cfg.lm_layers:
        tree["lm"] = convert_lm_state_dict(sd, cfg)
    return tree


def convert_lm_state_dict(sd: Dict[str, np.ndarray], cfg: ModelConfig
                          ) -> Dict[str, Any]:
    """ESPnet's ``TransformerLM`` keys (``lm.embed``, ``lm.encoder.embed``:
    its linear input layer, Linear at 0 and LayerNorm at 1, Dropout and
    ReLU holding none; ``lm.encoder.encoders.{i}``, ``lm.encoder.after_norm``
    and the output layer ``lm.decoder``) → the ``lm`` subtree."""
    if _LM_IN not in sd:
        raise ValueError(f"the configuration has an LM of {cfg.lm_layers} "
                         f"layers and the state dict no lm.* keys")
    layers = []
    for i in range(cfg.lm_layers):
        p = f"lm.encoder.encoders.{i}"
        layers.append({"self_attn": _mha(sd, f"{p}.self_attn"),
                       "feed_forward": _ffn(sd, f"{p}.feed_forward"),
                       "norm1": _norm(sd, f"{p}.norm1"),
                       "norm2": _norm(sd, f"{p}.norm2")})
    return {
        "embed": {"weight": np.asarray(_get(sd, "lm.embed.weight"),
                                       dtype=np.float32)},
        "input_layer": {"out": _linear(sd, "lm.encoder.embed.0"),
                        "norm": _norm(sd, "lm.encoder.embed.1")},
        "layers": _stack(layers),
        "after_norm": _norm(sd, "lm.encoder.after_norm"),
        "output_layer": _linear(sd, "lm.decoder"),
    }


def load_espnet_checkpoint(
    checkpoint_path: Path, cfg: Optional[ModelConfig] = None,
    config_path: Optional[Path] = None,
    lm_checkpoint_path: Optional[Path] = None,
) -> Tuple[Dict[str, Any], ModelConfig, Dict[str, Any]]:
    """Load + convert. Returns (params, possibly-updated cfg, arch info).
    With `config_path` in place of `cfg`, the config is that ESPnet
    config.yaml's, built for the conformer kind the keys hold. An LM's
    ``lm.*`` keys come from the checkpoint or from `lm_checkpoint_path`,
    ESPnet's LM file (its heads and weight from the config's ``lm_conf``
    and ``lm_weight``)."""
    sd = _load_state_dict(Path(checkpoint_path))
    if lm_checkpoint_path is not None:
        sd.update(_load_state_dict(Path(lm_checkpoint_path)))
    arch = infer_architecture(sd)
    kind = encoder_layer_kind(sd)
    if config_path is not None:
        cfg = ModelConfig.from_yaml(
            config_path, **({"encoder_type": kind} if kind else {}))
    if cfg is None:
        cfg = ModelConfig()
    updates = {}
    if arch.get("lm_layers") and not cfg.lm_heads:
        raise ValueError("the state dict holds an LM and the configuration "
                         "no lm_conf: its heads are not in the shapes")
    for field in ("vocab_size", "encoder_layers", "decoder_layers",
                  "encoder_dim", "encoder_linear_units",
                  "decoder_linear_units", "lm_layers", "lm_dim",
                  "lm_embed_dim", "lm_linear_units"):
        if arch.get(field) and getattr(cfg, field) != arch[field]:
            updates[field] = arch[field]
    if "encoder_dim" in updates:
        updates.setdefault("decoder_dim", updates["encoder_dim"])
    kind = kind or cfg.encoder_type
    if kind != cfg.encoder_type:
        updates["encoder_type"] = kind
    if kind == CB_CONFORMER:
        # The macaron flag and the depthwise taps, as the weights hold them.
        found = {"macaron_style": _has_macaron(sd),
                 "conformer_kernel_size": int(
                     sd[_LAYER0 + "conv_module.depthwise_conv.weight"]
                     .shape[-1])}
        updates.update({k: v for k, v in found.items()
                        if getattr(cfg, k) != v})
    if updates:
        logger.info("Checkpoint shape inference overrides config: %s", updates)
        cfg = cfg.replace(**updates)
    params = convert_state_dict(sd, cfg)
    return params, cfg, arch


def load_normalization_stats(stats_path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """feats_stats.npz → (mean, std), from either stats format."""
    stats = np.load(stats_path)
    if "mean" in stats:
        return stats["mean"], stats["std"]
    if "sum" in stats and "sum_square" in stats and "count" in stats:
        count = stats["count"]
        mean = stats["sum"] / count
        mean_square = stats["sum_square"] / count
        std = np.sqrt(np.maximum(mean_square - mean**2, 1e-10))
        return mean, std
    raise ValueError(f"Unknown stats format. Keys: {list(stats.keys())}")


def find_checkpoint(model_dir: Path) -> Optional[Path]:
    """The checkpoint of a model directory: a priority list of names,
    looked for in the directory and then in each exp/* run."""
    names = [
        "valid.acc.best.pth",
        "valid.acc.ave_6best.pth",
        "valid.acc.ave.pth",
        "model.pth",
        "checkpoint.pth",
    ]
    dirs = [model_dir] + sorted(model_dir.glob("exp/*/"))
    for d in dirs:
        for n in names:
            p = Path(d) / n
            if p.exists():
                return p
    return None


def find_stats(model_dir: Path) -> Optional[Path]:
    """The MVN stats file of a model directory: beside the checkpoint, in a
    sibling asr_stats_*/train, or anywhere below."""
    candidates = [
        model_dir / "feats_stats.npz",
        *sorted(model_dir.parent.glob("asr_stats_*/train/feats_stats.npz")),
        *sorted(model_dir.glob("**/feats_stats.npz")),
    ]
    for p in candidates:
        if p.exists():
            return p
    return None
