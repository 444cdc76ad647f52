"""Checkpoints of the trainer (port of ``speechcatcher_tpu/utils/save.py``).

``params_<step>.pt`` holds ``torch.save`` of the parameter tree in the JAX
package's layout (``params.params_to_numpy``: layers stacked), as CPU
tensors, beside the same ``config.json`` the JAX function writes (step and
config). The JAX package's checkpoints are orbax directories: neither
package reads the other's.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from speechcatcher_tpu_torch.config import ModelConfig
from speechcatcher_tpu_torch.params import (
    params_from_numpy,
    params_to_numpy,
    tree_map,
    unstack_layers,
)


def save_checkpoint(path: Path, params: Dict[str, Any], cfg: ModelConfig,
                    step: int = 0) -> None:
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tree = tree_map(torch.from_numpy, params_to_numpy(params))
    torch.save(tree, path / f"params_{step}.pt")
    meta = {"step": step, "config": dataclasses.asdict(cfg)}
    (path / "config.json").write_text(json.dumps(meta, indent=2))


def load_checkpoint(path: Path, step: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Tuple[Dict[str, Any], ModelConfig, int]:
    """(the port's parameter tree on `device`, config, step) of `step`, the
    latest saved step by default."""
    path = Path(path).absolute()
    meta = json.loads((path / "config.json").read_text())
    cfg = ModelConfig(**meta["config"])
    if step is None:
        steps = sorted(int(p.stem.split("_")[1])
                       for p in path.glob("params_*.pt")
                       if p.stem.split("_")[1].isdigit())
        step = steps[-1]
    tree = torch.load(path / f"params_{step}.pt", weights_only=True)
    params = params_from_numpy(tree_map(lambda t: t.numpy(), tree), device)
    for part in ("encoder", "decoder"):
        params[part]["layers"] = unstack_layers(params[part]["layers"])
    return params, cfg, step
