"""Checkpoints: a directory holding `state.pt` and `meta.json`.

Counterpart of contouring_uncertainty_tpu/train/checkpoint.py. `state.pt`
is `torch.save` of a tree of state dicts (the model's `state_dict` under
"params", the optimizer's under "opt_state" in resumable checkpoints);
`meta.json` says which task wrote it and when, so a checkpoint restores
without knowing its task.

`resolve_checkpoint` takes a local path or a Comet model-registry query
(`workspace/registry[/version-or-stage]`) as the JAX package does: the
latest version by parsed semver, a stage always refreshed, the download
cached under `cache_home()` and the cache kept when a refresh fails. A
registry model holds one port checkpoint directory (`state.pt`).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

import torch


def save_checkpoint(path: str | Path, tree: Any, meta: Optional[Dict] = None) -> Path:
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save(tree, path / "state.pt")
    if meta is not None:
        (path / "meta.json").write_text(json.dumps(meta, indent=2, default=str))
    return path


def restore_checkpoint(path: str | Path, map_location=None) -> Any:
    """The saved tree, its tensors on `map_location` (where they were saved
    by default). Loads tensors and plain containers only."""
    return torch.load(Path(path) / "state.pt", map_location=map_location, weights_only=True)


def load_meta(path: str | Path) -> Dict:
    meta_file = Path(path) / "meta.json"
    return json.loads(meta_file.read_text()) if meta_file.exists() else {}


def cache_home() -> Path:
    """Local cache root of downloaded registry checkpoints: $CUTPU_HOME, else
    ~/.cache/cutpu (the JAX package's)."""
    return Path(os.environ.get("CUTPU_HOME", Path.home() / ".cache" / "cutpu"))


def _version_key(version) -> tuple:
    return tuple(int(x) if x.isdigit() else 0 for x in str(version).split("."))


def resolve_checkpoint(checkpoint: str | Path) -> Path:
    """A local checkpoint path, or a Comet model-registry query resolved to
    its local cached copy:

        'workspace/registry_name'         -> the latest version
        'workspace/registry_name/1.2.0'   -> that version
        'workspace/registry_name/prod'    -> that stage (always refreshed:
                                             stages move)

    Anything that exists on disk is local (a checkpoint directory, or a
    directory of `*.ckpt` ensemble members). A suffixed or absolute path, or
    one of another number of parts, that does not exist raises
    FileNotFoundError; a query needs comet_ml (RuntimeError without it)."""
    path = Path(checkpoint)
    if path.exists():
        return path
    parts = path.parts
    if path.suffix or path.is_absolute() or not (2 <= len(parts) <= 3):
        raise FileNotFoundError(
            f"checkpoint '{checkpoint}' does not exist locally and is not a "
            "'workspace/registry[/version-or-stage]' registry query")
    try:
        import comet_ml
    except ImportError as exc:
        raise RuntimeError(
            f"checkpoint '{checkpoint}' looks like a Comet model-registry "
            "query but comet_ml is not installed in this environment") from exc

    comet_api = comet_ml.api.API()
    workspace, registry_name = parts[0], parts[1]
    version_or_stage = parts[2] if len(parts) == 3 else None
    version = stage = None
    if version_or_stage:
        # A version is digits and dots; anything else is a stage tag.
        if version_or_stage.replace(".", "").isdigit():
            version = version_or_stage
        else:
            stage = version_or_stage
    else:
        # The latest by parsed version ('1.10.0' beats '1.9.0'), whatever
        # order the API lists them in.
        versions = comet_api.get_registry_model_versions(workspace, registry_name)
        if not versions:
            raise RuntimeError(
                f"Comet registry model '{workspace}/{registry_name}' has no "
                "versions; nothing to download")
        version = version_or_stage = max(versions, key=_version_key)

    cached = cache_home() / workspace / registry_name / version_or_stage
    if stage or not cached.exists():
        # The cache is replaced only after a download succeeded.
        cached.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=cached.parent) as tmp:
            staging = Path(tmp) / "download"
            comet_api.download_registry_model(
                workspace, registry_name, version=version, stage=stage,
                output_path=str(staging))
            if not staging.exists():
                raise RuntimeError(f"Comet download of '{checkpoint}' produced no files")
            shutil.rmtree(cached, ignore_errors=True)
            shutil.move(str(staging), str(cached))
    candidates = ([p for p in cached.iterdir() if (p / "state.pt").exists()]
                  if cached.exists() else [])
    if len(candidates) == 1:
        return candidates[0]
    if cached.exists() and (cached / "state.pt").exists():
        return cached
    raise RuntimeError(
        f"registry model at {cached} does not contain exactly one port "
        f"checkpoint directory (state.pt; found {len(candidates)})")
