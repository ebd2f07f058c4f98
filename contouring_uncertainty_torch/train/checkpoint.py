"""Checkpoints: a directory holding `state.pt` and `meta.json`.

Counterpart of contouring_uncertainty_tpu/train/checkpoint.py. `state.pt`
is `torch.save` of a tree of state dicts (the model's `state_dict` under
"params", the optimizer's under "opt_state" in resumable checkpoints);
`meta.json` says which task wrote it and when, so a checkpoint restores
without knowing its task. Only local paths resolve: the Comet model
registry query is not ported (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import json
import shutil
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


def resolve_checkpoint(checkpoint: str | Path) -> Path:
    """A local checkpoint directory. Anything else raises: registry queries
    ('workspace/registry[/version-or-stage]') are not ported."""
    path = Path(checkpoint)
    if not (path / "state.pt").exists():
        raise FileNotFoundError(
            f"checkpoint '{checkpoint}' is not a local checkpoint directory (no state.pt); "
            "Comet model-registry queries are not ported yet (ROADMAP.md Queue 1, item 5)")
    return path
