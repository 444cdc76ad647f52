"""Model distribution: download + cache ESPnet model-zoo packages (port of
``speechcatcher_tpu/utils/zoo.py``).

``download_and_unpack`` accepts a local model directory, a local packed
archive, a URL to a packed archive, or a HuggingFace repo id, and returns
the unpacked model directory. ``_unpack`` extracts an archive (zip or tar)
once into a directory; ``_find_model_dir`` locates the model inside an
unpacked tree: meta.yaml inside the package names the config/checkpoint
files; otherwise they are searched for.
"""

from __future__ import annotations

import logging
import tarfile
import zipfile
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

DEFAULT_CACHE = Path("~/.cache/speechcatcher_tpu").expanduser()


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


def download_and_unpack(tag: str, cache_dir: Optional[Path] = None,
                        quiet: bool = False) -> Path:
    """Resolve `tag` to an unpacked model directory.

    tag may be: a local model directory, a local packed archive, an
    https:// URL to an archive, or a HuggingFace repo id.
    """
    cache_dir = Path(cache_dir or DEFAULT_CACHE).expanduser()
    local = Path(tag).expanduser()
    if local.is_dir():
        d = _find_model_dir(local) or local
        return d
    if local.is_file():
        dest = cache_dir / "local" / local.stem
        root = _unpack(local, dest)
        return _find_model_dir(root) or root

    if tag.startswith(("http://", "https://")):
        import urllib.request

        dest = cache_dir / "url" / Path(tag).name
        dest.parent.mkdir(parents=True, exist_ok=True)
        archive = dest.with_suffix(".pack")
        if not archive.exists():
            if not quiet:
                logger.info("Downloading %s", tag)
            # Download to a temp name and rename into place: an
            # interrupted urlretrieve would otherwise leave a partial
            # archive that the exists() guard treats as complete forever.
            part = archive.with_suffix(".pack.part")
            urllib.request.urlretrieve(tag, part)
            part.replace(archive)
        root = _unpack(archive, dest)
        return _find_model_dir(root) or root

    # HuggingFace repo id.
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError(
            f"'{tag}' looks like a HuggingFace repo id but huggingface_hub "
            "is not installed; pass a local model directory instead"
        ) from e
    snap = snapshot_download(repo_id=tag, cache_dir=str(cache_dir / "hf"))
    root = Path(snap)
    # Zoo packages may ship as an archive inside the repo.
    archives = sorted(root.glob("**/*.zip")) + sorted(root.glob("**/*.tar.gz"))
    if archives and _find_model_dir(root) is None:
        root = _unpack(archives[0],
                       cache_dir / "hf-unpacked" / tag.replace("/", "__"))
    d = _find_model_dir(root)
    if d is None:
        raise FileNotFoundError(f"No ESPnet checkpoint found under {root}")
    return d
