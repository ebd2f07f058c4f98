"""Data contracts: labels, tags, DataParams and the BatchResult interchange type.

The port's own copy of contouring_uncertainty_tpu/data/config.py (the port
imports nothing of the JAX package). Capability parity with the reference's
vital/data/camus/config.py:10-21 (Label), vital/data/config.py (Tags) and
contour_uncertainty/data/config.py:37-107 (BatchResult, the contract between
predict steps and results processors).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class Label(IntEnum):
    """Anatomical structures in CAMUS segmentation masks."""

    BG = 0
    LV = 1
    MYO = 2
    ATRIUM = 3


class LungLabel(IntEnum):
    """Anatomical structures in JSRT chest X-ray masks (reference
    contour_uncertainty/data/lung/config.py:9-19: BG/LUNG/HEART — both
    lungs share one label)."""

    BG = 0
    LUNG = 1
    HEART = 2


class Tags:
    """String keys used in batch dictionaries."""

    id = "id"
    group = "group"
    neighbors = "neighbors"
    img = "img"
    gt = "gt"
    pred = "pred"
    contour = "contour"
    metadata = "metadata"
    voxelspacing = "voxelspacing"
    instants = "instants"
    image_quality = "image_quality"


@dataclass
class DataParams:
    """Shapes/labels a datamodule exposes to tasks (vital/data/config.py:96-109)."""

    in_shape: Tuple[int, ...]  # (C, H, W)
    out_shape: Tuple[int, ...]  # (K, 2) for contour tasks, (C, H, W) for seg
    labels: Sequence[Label] = (Label.BG, Label.LV)


@dataclass
class BatchResult:
    """Inter-layer contract carried from predict steps to results processors.

    Mirrors reference data/config.py:37-107 (field names and shapes), with
    the same __post_init__ shape assertions.
    """

    id: str
    img: np.ndarray  # [N, (C,) H, W]
    gt: Optional[np.ndarray]  # [N, H, W]
    pred: np.ndarray  # [N, H, W]
    labels: Sequence[Label]
    uncertainty_map: np.ndarray  # [N, H, W]

    instants: Optional[Dict[str, int]] = None
    voxelspacing: Optional[Tuple] = None
    # View acquisition quality attr (Good/Medium/Poor), carried from the
    # CAMUS metadata for quality-vs-uncertainty correlation analyses
    # (reference data/camus/dataset.py:81-98).
    image_quality: Optional[str] = None

    contour: Optional[np.ndarray] = None  # GT contour [N, K, 2]
    mu: Optional[np.ndarray] = None  # [N, K, 2]
    mode: Optional[np.ndarray] = None  # [N, K, 2]
    cov: Optional[np.ndarray] = None  # [N, K, 2, 2]
    alpha: Optional[np.ndarray] = None  # [N, K, 2]
    pca_cov: Optional[np.ndarray] = None
    post_mu: Optional[np.ndarray] = None  # [N, K, 2]
    post_cov: Optional[np.ndarray] = None  # [N, K, 2, 2]

    contour_samples: Optional[np.ndarray] = None  # [N, T_e, T_a, K, 2]
    pred_samples: Optional[np.ndarray] = None  # [N, T_e, T_a, H, W]
    entropy_map: Optional[np.ndarray] = None  # [N, H, W]
    sample_weights: Optional[np.ndarray] = None

    view_metrics: Optional[dict] = None
    instant_metrics: Optional[dict] = None
    view_uncertainty: Optional[dict] = None
    instant_uncertainty: Optional[dict] = None
    point_uncertainty: Optional[dict] = None

    contour_validity: Optional[np.ndarray] = None
    sample_validity: Optional[np.ndarray] = None

    def __post_init__(self):
        assert self.img.ndim in (3, 4)
        n = self.img.shape[0]
        h, w = self.img.shape[-2], self.img.shape[-1]

        if self.gt is not None:
            assert self.gt.shape == (n, h, w), f"gt shape {self.gt.shape}"
        assert self.pred.shape == (n, h, w), f"pred shape {self.pred.shape}"
        assert self.uncertainty_map.shape == (n, h, w), (
            f"uncertainty_map shape {self.uncertainty_map.shape}"
        )
        if self.entropy_map is not None:
            assert self.entropy_map.shape == (n, h, w)
        if self.instant_uncertainty is not None:
            for key, item in self.instant_uncertainty.items():
                assert item.ndim == 1 and len(item) == n, f"instant_uncertainty {key}"
        if self.mu is not None:
            assert self.mu.ndim == 3 and self.mu.shape[0] == n and self.mu.shape[-1] == 2
            k = self.mu.shape[1]
            assert self.cov.shape == (n, k, 2, 2)
            assert self.mode.shape == (n, k, 2)
            assert self.alpha is None or self.alpha.shape == (n, k, 2)
