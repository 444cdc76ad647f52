"""Model distribution: unpack ESPnet model-zoo packages (port of the
local half of ``speechcatcher_tpu/utils/zoo.py``).

``_unpack`` extracts a packed archive (zip or tar) once into a directory;
``_find_model_dir`` locates the model inside an unpacked tree: meta.yaml
inside the package names the config/checkpoint files; otherwise they are
searched for. Resolving a URL or a HuggingFace repo id is not ported yet.
"""

from __future__ import annotations

import logging
import tarfile
import zipfile
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

def _find_model_dir(root: Path) -> Optional[Path]:
    """Locate the directory holding the checkpoint inside an unpacked tree."""
    names = [
        "valid.acc.best.pth", "valid.acc.ave_6best.pth", "valid.acc.ave.pth",
        "model.pth", "checkpoint.pth",
    ]
    meta = list(root.glob("**/meta.yaml"))
    if meta:
        import yaml

        try:
            with open(meta[0]) as f:
                m = yaml.safe_load(f) or {}
            files = m.get("files", {}) or {}
            yaml_files = m.get("yaml_files", {}) or {}
            model_file = files.get("asr_model_file") or files.get("model_file")
            if model_file:
                p = meta[0].parent / model_file
                if p.exists():
                    return p.parent
            cfg = yaml_files.get("asr_train_config") or yaml_files.get(
                "train_config"
            )
            if cfg and (meta[0].parent / cfg).exists():
                return (meta[0].parent / cfg).parent
        except Exception as e:  # malformed meta — fall through to search
            logger.warning("meta.yaml parse failed: %s", e)
    for n in names:
        hits = sorted(root.glob(f"**/{n}"))
        if hits:
            return hits[0].parent
    return None


def _unpack(archive: Path, dest: Path) -> Path:
    dest.mkdir(parents=True, exist_ok=True)
    marker = dest / ".unpacked"
    if not marker.exists():
        if zipfile.is_zipfile(archive):
            with zipfile.ZipFile(archive) as z:
                z.extractall(dest)
        elif tarfile.is_tarfile(archive):
            with tarfile.open(archive) as t:
                try:
                    # Guard against tar-slip (../ or absolute members) in
                    # archives fetched from URLs/HF repos.
                    t.extractall(dest, filter="data")
                except TypeError:  # Python without the filter= argument
                    base = dest.resolve()
                    for m in t.getmembers():
                        target = (dest / m.name).resolve()
                        if not str(target).startswith(str(base)):
                            raise ValueError(
                                f"unsafe tar member path: {m.name}"
                            )
                    t.extractall(dest)
        else:
            raise ValueError(f"Unknown archive format: {archive}")
        marker.touch()
    return dest
