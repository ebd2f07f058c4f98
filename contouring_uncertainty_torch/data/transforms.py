"""Configurable image transforms (the `data/transform` config group).

The port's own copy of contouring_uncertainty_tpu/data/transforms.py, with
the same options and error messages: statically configured normalization
applied once to each view's image stack when the data source is built
(`factory.build_data`), not per training step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np


def normalize(mean: float, std: float) -> Callable[[np.ndarray], np.ndarray]:
    """Fixed-statistics normalization (torchvision.transforms.Normalize)."""
    mean_, std_ = float(mean), float(std)

    def fn(img: np.ndarray) -> np.ndarray:
        return (img - mean_) / std_

    return fn


def normalize_sample(eps: float = 1e-8) -> Callable[[np.ndarray], np.ndarray]:
    """Per-sample z-score (vital.data.transforms.NormalizeSample): each
    leading-axis item is normalized by its own mean/std."""

    def fn(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img, np.float32)
        axes = tuple(range(1, img.ndim))
        mu = img.mean(axis=axes, keepdims=True)
        sd = img.std(axis=axes, keepdims=True)
        return (img - mu) / (sd + eps)

    return fn


def compose(fns: Sequence[Callable]) -> Callable[[np.ndarray], np.ndarray]:
    """Sequential application (torchvision.transforms.Compose)."""

    def fn(img: np.ndarray) -> np.ndarray:
        for f in fns:
            img = f(img)
        return img

    return fn


def build_transform(cfg: Optional[Dict]) -> Optional[Callable]:
    """`data.transform` config node -> callable (or None).

    Accepted shapes (the options of the config group):
      {name: normalize, mean: M, std: S}
      {name: normalizesample}
      {name: compose, transforms: [<node>, ...]}
    """
    if not cfg:
        return None
    name = str(cfg.get("name", "")).lower()
    if name == "normalize":
        if cfg.get("mean") is None or cfg.get("std") is None:
            raise ValueError(
                "data/transform=normalize requires data.transform.mean and "
                "data.transform.std (the reference yaml leaves them '???')"
            )
        return normalize(cfg["mean"], cfg["std"])
    if name in ("normalizesample", "normalize_sample"):
        return normalize_sample()
    if name == "compose":
        subs = [build_transform(sub) for sub in cfg.get("transforms") or []]
        subs = [s for s in subs if s is not None]
        if not subs:
            raise ValueError("data/transform=compose requires data.transform."
                             "transforms, a list of transform nodes")
        return compose(subs)
    raise ValueError(f"Unknown transform '{name}'")
