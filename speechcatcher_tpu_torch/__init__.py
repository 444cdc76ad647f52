"""speechcatcher_tpu_torch — the PyTorch/CUDA port of speechcatcher_tpu.

Streaming contextual-block transformer ASR with blockwise synchronous beam
search, on PyTorch, with hand-written CUDA kernels for Hopper (``csrc/``).
It imports neither JAX nor the JAX package.

Public API (lazy: importing the package loads only the config):

    load_model(tag, ...)            -> Speech2TextStreaming
    recognize(s2t, pcm, rate, ...)  -> (text, aux_info)
    recognize_file(s2t, path, ...)  -> dict
    Speech2TextStreaming(...)(speech, is_final) -> [(text, tokens, ids, pos)]
    tags                            -> model-zoo tag registry
"""

from speechcatcher_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    flagship_config,
    tiny_config,
)

_LAZY = {
    "Speech2TextStreaming": "speechcatcher_tpu_torch.streaming",
    "load_model": "speechcatcher_tpu_torch.recognize",
    "recognize": "speechcatcher_tpu_torch.recognize",
    "recognize_file": "speechcatcher_tpu_torch.recognize",
    "tags": "speechcatcher_tpu_torch.recognize",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
