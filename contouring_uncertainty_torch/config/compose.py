"""JSON config groups + dotted overrides (the Hydra-style CLI surface).

Counterpart of contouring_uncertainty_tpu/config/compose.py: the same
groups, composition order and override grammar, over JSON files under
`config/json/` (the machine with the card has no PyYAML). The files hold
the same trees as the JAX package's YAML files of the same names.

Override values are parsed as YAML 1.1's `safe_load` parses the scalars and
flow sequences that a command line sends: booleans (true/yes/on and
false/no/off, in the three spellings YAML knows), null and ~, decimal
integers, floats (with Hydra's reading of `3e-4` as a float), quoted and
plain strings, `[a, b, [c, d]]` lists of these and `{key: value, ...}`
mappings of them (`data.transform.transforms=[{name: normalizesample}]`).
YAML's other integer bases, underscores and .inf/.nan are not read: they
stay strings.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

CONFIG_DIR = Path(__file__).parent / "json"

_ENV_RE = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)(?:,([^}]*))?\}")


def _resolve_env(value: Any) -> Any:
    if isinstance(value, str):
        return _ENV_RE.sub(lambda m: os.environ.get(m.group(1), m.group(2) or ""), value)
    return value


def deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def _load_json(path: Path) -> Dict:
    return json.loads(path.read_text()) or {}


def _set_dotted(cfg: Dict, dotted: str, value: Any):
    keys = dotted.split(".")
    node = cfg
    for key in keys[:-1]:
        node = node.setdefault(key, {})
        if not isinstance(node, dict):
            raise ValueError(f"Cannot override through non-dict at {key} in {dotted}")
    node[keys[-1]] = value


# YAML 1.1 scalar forms (PyYAML's resolver), and Hydra's float form.
_BOOL = {**{s: True for s in ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")},
         **{s: False for s in ("false", "False", "FALSE", "no", "No", "NO", "off", "Off",
                               "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_INT_RE = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT_RE = re.compile(r"[-+]?((\d+\.\d*|\.\d+)([eE][-+]?\d+)?|\d+[eE][-+]?\d+)")


def _parse_scalar(raw: str) -> Any:
    text = raw.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.fullmatch(text):
        return int(text)
    if _FLOAT_RE.fullmatch(text):
        return float(text)
    return text


def _split_top_level(body: str) -> List[str]:
    items, depth, start = [], 0, 0
    for i, ch in enumerate(body):
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    return items


def _parse_value(raw: str) -> Any:
    text = raw.strip()
    if text.startswith("[") and text.endswith("]"):
        body = text[1:-1]
        if not body.strip():
            return []
        return [_parse_value(item) for item in _split_top_level(body)]
    if text.startswith("{") and text.endswith("}"):
        body = text[1:-1]
        if not body.strip():
            return {}
        pairs = [item.split(":", 1) for item in _split_top_level(body)]
        if any(len(pair) != 2 for pair in pairs):
            raise ValueError(f"Cannot parse the mapping {text!r}: each item must be key: value")
        return {str(_parse_scalar(k)): _parse_value(v) for k, v in pairs}
    return _parse_scalar(text)


def compose(overrides: Optional[List[str]] = None, config_dir: Path = CONFIG_DIR) -> Dict:
    """Compose the full config from default.json + group selections + overrides.

    `group=option` picks `config_dir/group/option.json` when that file exists
    (groups: data, task, task/model, task/optim); anything else is a dotted
    override.
    """
    overrides = list(overrides or [])
    cfg = _load_json(config_dir / "default.json")

    # Group selections first (they provide defaults), then dotted overrides
    # (they win).
    group_sel: Dict[str, str] = {}
    dotted: List[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' must look like key=value")
        # Hydra's force-add prefixes `+key=` / `++key=` mean nothing here.
        ov = ov.lstrip("+")
        key, value = ov.split("=", 1)
        group_dir = config_dir / key
        if (group_dir / f"{value}.json").exists():
            group_sel[key] = value
        elif group_dir.is_dir() and "." not in key:
            options = sorted(p.stem for p in group_dir.glob("*.json"))
            raise ValueError(f"Unknown option '{value}' for config group '{key}'. "
                             f"Available: {options}")
        else:
            dotted.append(ov)

    for entry in cfg.pop("defaults", []):
        for group, option in entry.items():
            group_sel.setdefault(group, option)

    for group in sorted(group_sel, key=lambda g: g.count("/")):
        option = group_sel[group]
        node = _load_json(config_dir / group / f"{option}.json")
        node.setdefault("name", option)
        target = cfg
        *parents, leaf = group.split("/")
        for p in parents:
            target = target.setdefault(p, {})
        target[leaf] = deep_merge(target.get(leaf, {}), node)

    for ov in dotted:
        key, value = ov.split("=", 1)
        _set_dotted(cfg, key, _parse_value(value))

    cfg = _resolve_tree(cfg)
    cfg["choices"] = group_sel
    return cfg


def _resolve_tree(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tree(v) for v in node]
    return _resolve_env(node)
