"""Plain landmark extraction: the published CAMUS rule that turns a frame's
label mask into K LV endocardium landmarks, in numpy alone, and the
training frames of a fold read from the films with their landmarks.

For one label mask (H, W), pixels as (y, x):

1. the LV's edge: its pixels with a pixel outside the LV, or outside the
   image, in their 3x3 window;
2. the base markers: LV pixels with a myocardium pixel and a background
   pixel (inside the image) in their 3x3 window. They are split at their
   mean x; on each side the marker of largest y is taken, the first in
   row-major order on a tie. Where every marker has one x, they are split
   at their mean y: the lowest y of those below it, the largest of the
   rest;
3. the apex: the edge pixel farthest from the midpoint of the two
   markers (the first in row-major order on a tie);
4. a walk along the edge from the apex to each marker: the shortest
   8-connected path, by a breadth-first search that looks at the
   neighbours in the order NW, N, NE, E, SE, S, SW, W, traced back from
   the marker through the first neighbour in that order one step nearer;
5. (K + 1) // 2 indices a wall, floor(linspace(0, len - 1)), into each
   walk; the landmarks are the first marker, the first walk's inner
   points reversed, the apex, the second walk's inner points and the
   second marker, as (x, y).
"""

from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

LV, MYO = 1, 2
STEPS = ((-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1))


def _window(mask: np.ndarray, reduce) -> np.ndarray:
    """`reduce` (np.logical_and or np.logical_or) over each pixel's 3x3
    window, with False outside the image."""
    h, w = mask.shape
    padded = np.zeros((h + 2, w + 2), bool)
    padded[1:-1, 1:-1] = mask
    out = padded[1:-1, 1:-1].copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = reduce(out, padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return out


def _base(labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lv, myo = labels == LV, labels == MYO
    background = ~(lv | myo)
    ys, xs = np.nonzero(lv & _window(myo, np.logical_or) & _window(background, np.logical_or))
    if len(ys) < 2:
        raise ValueError(f"{len(ys)} base markers; the rule needs 2")
    if np.all(xs == xs.mean()):
        side = ys > ys.mean()
        a, b = np.argmin(ys[side]), np.argmax(ys[~side])
    else:
        side = xs < xs.mean()
        a, b = np.argmax(ys[side]), np.argmax(ys[~side])
    return (np.array([ys[side][a], xs[side][a]]), np.array([ys[~side][b], xs[~side][b]]))


def _walk(edge: np.ndarray, start, end) -> np.ndarray:
    h, w = edge.shape
    dist = np.full((h, w), -1, np.int64)
    dist[start] = 0
    queue = deque([start])
    while queue:
        y, x = queue.popleft()
        if (y, x) == end:
            break
        for dy, dx in STEPS:
            v, u = y + dy, x + dx
            if 0 <= v < h and 0 <= u < w and edge[v, u] and dist[v, u] < 0:
                dist[v, u] = dist[y, x] + 1
                queue.append((v, u))
    if dist[end] < 0:
        raise ValueError(f"no path along the edge from {start} to {end}")
    path = [end]
    y, x = end
    while dist[y, x] > 0:
        y, x = next((y + dy, x + dx) for dy, dx in STEPS
                    if 0 <= y + dy < h and 0 <= x + dx < w
                    and dist[y + dy, x + dx] == dist[y, x] - 1)
        path.append((y, x))
    return np.array(path[::-1])


def landmarks(labels: np.ndarray, k: int) -> np.ndarray:
    """(K, 2) f32 landmarks (x, y) of one label mask."""
    lv = labels == LV
    edge = lv & ~_window(lv, np.logical_and)
    b0, b1 = _base(labels)
    mid = (b0 + b1) / 2.0
    ys, xs = np.nonzero(edge)
    apex_at = np.argmax(np.sqrt((ys - mid[0]) ** 2 + (xs - mid[1]) ** 2))
    apex = (int(ys[apex_at]), int(xs[apex_at]))
    walk0 = _walk(edge, apex, (int(b0[0]), int(b0[1])))
    walk1 = _walk(edge, apex, (int(b1[0]), int(b1[1])))
    n = (k + 1) // 2
    at0 = np.linspace(0, len(walk0) - 1, n).astype(int)
    at1 = np.linspace(0, len(walk1) - 1, n).astype(int)
    yx = np.concatenate([b0[None], walk0[at0[1:-1]][::-1], np.array(apex)[None],
                         walk1[at1[1:-1]], b1[None]])
    return yx[:, ::-1].astype(np.float32)


def training_frames(tree, fold: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every training frame of the fold, read from the films (`Node`s of a
    CAMUS-layout tree): images (F, 1, H, W) f32 and their landmarks
    (F, K, 2), the key instants (the view's instant attributes) of each
    view of each training patient."""
    split = tree.members["cross_validation"].members[f"fold_{fold}"].members["train"]
    images: List[np.ndarray] = []
    points: List[np.ndarray] = []
    for pid in split:
        for node in tree.members[pid.decode()].members.values():
            keys = [i.decode() for i in node.attrs["instants"]]
            for f in sorted({int(node.attrs[key]) for key in keys}):
                images.append(np.asarray(node.members["img_proc"][f], np.float32)[None])
                points.append(landmarks(np.asarray(node.members["gt_proc"][f]), k))
    return np.stack(images), np.stack(points)
