"""Host-side extraction of K landmark points from label masks.

The port's own copy of contouring_uncertainty_tpu/data/contour_extraction.py,
operation for operation (numpy and `scipy.ndimage`): apex and base detection
on the LV mask, a breadth-first walk along the 8-connected edge from the
apex to each base corner, uniform index resampling into `points_per_side`
landmarks per wall; with MYO, the same on the convex hull of the
myocardium.

Difference from the JAX module: `_convex_hull_mask` fills the hull with
`data/lung.py inside_polygon` (matplotlib's crossing predicate in f64, the
same pixels as `matplotlib.path.Path.contains_points`) instead of
matplotlib, which the machine with the card does not have.
"""

from __future__ import annotations

import sys
from collections import deque
from typing import Tuple

import numpy as np
from scipy import ndimage

from contouring_uncertainty_torch.data.config import Label
from contouring_uncertainty_torch.data.lung import inside_polygon


def structure_edge(segmentation: np.ndarray, label) -> np.ndarray:
    """Binary edge of a labeled structure: mask minus its 3x3 erosion."""
    mask = np.isin(segmentation, label).astype(int)
    eroded = ndimage.binary_erosion(mask, structure=np.ones((3, 3))).astype(int)
    return mask ^ eroded


def endo_base(
    segmentation: np.ndarray, lv_label=Label.LV, myo_label=Label.MYO
) -> Tuple[np.ndarray, np.ndarray]:
    """Left/right markers at the base of the endocardium, in (y, x)."""
    struct = ndimage.generate_binary_structure(2, 2)
    lv = np.isin(segmentation, lv_label)
    myo = np.isin(segmentation, myo_label)
    others = ~(lv + myo)
    dil_myo = ndimage.binary_dilation(myo, structure=struct)
    dil_others = ndimage.binary_dilation(others, structure=struct)
    ys, xs = np.nonzero(lv * dil_myo * dil_others)
    if len(ys) < 2:
        raise RuntimeError(
            f"Found {len(ys)} LV/MYO frontier markers; need at least 2 for the base."
        )
    if np.all(xs == xs.mean()):
        mask = ys > ys.mean()
        li = ys[mask].argmin()
        ri = ys[~mask].argmax()
    else:
        mask = xs < xs.mean()
        li = ys[mask].argmax()
        ri = ys[~mask].argmax()
    return (
        np.array([ys[mask][li], xs[mask][li]]),
        np.array([ys[~mask][ri], xs[~mask][ri]]),
    )


def lv_apex(segmentation: np.ndarray, lv_label=Label.LV, myo_label=Label.MYO) -> np.ndarray:
    """LV apex: the structure point furthest from the base midpoint, (y, x)."""
    base = endo_base(segmentation, lv_label, myo_label)
    mid = (base[0] + base[1]) / 2.0
    edge = structure_edge(segmentation, lv_label)
    ys, xs = np.nonzero(edge)
    pts = np.stack([ys, xs], axis=-1)
    d = np.linalg.norm(pts - mid, axis=-1)
    return pts[d.argmax()]


def bfs_path(edge: np.ndarray, start: Tuple[int, int], end: Tuple[int, int]) -> np.ndarray:
    """Shortest 8-connected path between two pixels of a binary edge map,
    ordered from `start` to `end` (both included), as an (L, 2) array of
    (y, x)."""
    height, width = edge.shape
    delta = [(-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)]
    dist = np.full((height, width), sys.maxsize, dtype=np.int64)
    dist[start[0], start[1]] = 0
    queue = deque([tuple(start)])
    found = False
    while queue:
        y, x = queue.popleft()
        if (y, x) == tuple(end):
            found = True
            break
        for dy, dx in delta:
            yy, xx = y + dy, x + dx
            if (0 <= yy < height and 0 <= xx < width and dist[y, x] + 1 < dist[yy, xx]
                    and edge[yy, xx]):
                dist[yy, xx] = dist[y, x] + 1
                queue.append((yy, xx))
    if not found:
        raise RuntimeError(f"No path found from {start} to {end} along the edge")
    # Backtrack end -> start.
    path = []
    y, x = end
    while dist[y, x] != 0:
        for dy, dx in delta:
            yy, xx = y + dy, x + dx
            if 0 <= yy < height and 0 <= xx < width and dist[yy, xx] == dist[y, x] - 1:
                path.append((yy, xx))
                y, x = yy, xx
                break
    # path runs from just before `end` back to `start`; reverse it.
    return np.array(path[::-1] + [tuple(end)])


def lv_contour(segmentation: np.ndarray, nb_points: int = 21) -> np.ndarray:
    """K LV endocardium landmarks base1 -> apex -> base2, in (y, x)."""
    edge = structure_edge(segmentation, Label.LV)
    base = endo_base(segmentation)
    apex = lv_apex(segmentation)

    path1 = bfs_path(edge, tuple(apex), tuple(base[0]))
    path2 = bfs_path(edge, tuple(apex), tuple(base[1]))

    pps = (nb_points + 1) // 2
    idx1 = np.linspace(0, len(path1) - 1, pps).astype(int)
    idx2 = np.linspace(0, len(path2) - 1, pps).astype(int)

    return np.concatenate(
        [
            base[0][None],
            path1[idx1[1:-1]][::-1],  # wall 1, base-adjacent first
            apex[None],
            path2[idx2[1:-1]],
            base[1][None],
        ],
        axis=0,
    )


def get_contour_points(segmentation: np.ndarray, nb_points: int = 21,
                       include_myo: bool = False) -> np.ndarray:
    """Landmarks in (x, y) ordering, (K or 2K, 2) float32; with
    `include_myo` the epicardium landmarks follow the LV's."""
    pts = lv_contour(segmentation, nb_points)
    if include_myo:
        pts = np.concatenate([pts, myo_contour(segmentation, nb_points)])
    return np.flip(pts, axis=-1).astype(np.float32)


def _convex_hull_mask(mask: np.ndarray) -> np.ndarray:
    """Filled convex hull of a binary mask (uint8)."""
    from scipy.spatial import ConvexHull

    ys, xs = np.nonzero(mask)
    pts = np.stack([xs, ys], -1)
    hull = ConvexHull(pts)
    return inside_polygon(pts[hull.vertices], mask.shape).astype(np.uint8)


def myo_contour(segmentation: np.ndarray, nb_points: int = 21) -> np.ndarray:
    """K epicardium landmarks base1 -> apex -> base2, in (y, x): the corners
    are the hull-edge points reached by rays from the LV centroid through
    the endocardium's base corners, the apex the hull-edge point farthest
    from their midpoint."""
    hull = _convex_hull_mask(np.isin(segmentation, Label.MYO))
    edge = structure_edge(hull, 1)
    edge_pts = np.stack(np.nonzero(edge), -1)  # (M, 2) (y, x)

    endo_b = endo_base(segmentation)
    lv_ys, lv_xs = np.nonzero(np.isin(segmentation, Label.LV))
    center = np.array([lv_ys.mean(), lv_xs.mean()])

    def ray_corner(base_pt):
        d = base_pt - center
        d = d / (np.linalg.norm(d) + 1e-9)
        # Edge point maximizing projection along the ray while staying close
        # to the ray's direction.
        rel = edge_pts - center
        proj = rel @ d
        dist_to_ray = np.abs(rel[:, 0] * d[1] - rel[:, 1] * d[0])
        score = proj - 2.0 * dist_to_ray
        return edge_pts[np.argmax(score)]

    base = (ray_corner(endo_b[0]), ray_corner(endo_b[1]))
    mid = (base[0] + base[1]) / 2.0
    apex = edge_pts[np.argmax(np.linalg.norm(edge_pts - mid, axis=-1))]

    path1 = bfs_path(edge, tuple(apex), tuple(base[0]))
    path2 = bfs_path(edge, tuple(apex), tuple(base[1]))
    pps = (nb_points + 1) // 2
    idx1 = np.linspace(0, len(path1) - 1, pps).astype(int)
    idx2 = np.linspace(0, len(path2) - 1, pps).astype(int)
    return np.concatenate([
        base[0][None], path1[idx1[1:-1]][::-1], apex[None],
        path2[idx2[1:-1]], base[1][None],
    ], axis=0)
