"""Clinical metric formulas on the device: area, perimeter, FAC, GLS, Simpson volumes.

Counterpart of contouring_uncertainty_tpu/utils/clinical.py, all of it but
the JSRT lung functions (ROADMAP.md Queue 1, item 10):

- area, perimeter, FAC and GLS from masks (pixel counts) or contours
  (dense-spline arc length and shoelace area, through ops/spline.py);
- mask-space GLS from a marching-squares perimeter minus the base chord;
- Simpson biplane volumes from the mask's principal axis: 20 disk
  diameters measured by nearest-pixel sampling along chords normal to it.

Every function takes (..., H, W) masks or (..., K, 2) contours and is
batched over the leading axes (the JAX package vmaps a single-item
version), so a view's whole Monte-Carlo sample population reduces in one
call, on the device of its input.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from contouring_uncertainty_torch.ops.spline import contour_spline, linspace

# --------------------------------------------------------------------- masks


def lv_area(mask: torch.Tensor, voxelarea=None) -> torch.Tensor:
    """Structure area in pixels (or physical units when voxelarea given)."""
    area = (mask != 0).sum(dim=(-2, -1)).to(torch.float32)
    if voxelarea is not None:
        area = area * voxelarea
    return area


def lv_fac(ed_mask: torch.Tensor, es_mask: torch.Tensor) -> torch.Tensor:
    """Fractional area change (ED - ES) / ED."""
    ed = lv_area(ed_mask)
    es = lv_area(es_mask)
    return (ed - es) / ed


# ------------------------------------------------------------------ contours


def contour_perimeter(contour: torch.Tensor, n_dense: int = 1000) -> torch.Tensor:
    """Spline arc length of (..., K, 2) landmarks -> (...)."""
    dense = contour_spline(contour, n=n_dense)
    d = dense[..., 1:, :] - dense[..., :-1, :]
    return torch.sqrt((d * d).sum(-1)).sum(-1)


def contour_area(contour: torch.Tensor, n_dense: int = 1000) -> torch.Tensor:
    """Shoelace area of the spline polygon (closed by the straight base edge)."""
    dense = contour_spline(contour, n=n_dense)
    x, y = dense[..., 0], dense[..., 1]
    return 0.5 * torch.abs(
        (x * torch.roll(y, -1, dims=-1) - torch.roll(x, -1, dims=-1) * y).sum(-1))


def gls(ed_contour: torch.Tensor, es_contour: torch.Tensor) -> torch.Tensor:
    """Global longitudinal strain between two contours."""
    ed_len = contour_perimeter(ed_contour)
    es_len = contour_perimeter(es_contour)
    return (ed_len - es_len) / ed_len


def gls_sequence(contours: torch.Tensor) -> torch.Tensor:
    """GLS over a frame sequence (..., T, K, 2), in % vs frame 0."""
    lengths = contour_perimeter(contours)
    return (lengths - lengths[..., :1]) / lengths[..., :1] * 100.0


def fac_sequence(masks: torch.Tensor) -> torch.Tensor:
    """FAC over a frame sequence (..., T, H, W), in % vs frame 0."""
    areas = lv_area(masks)
    return (areas - areas[..., :1]) / areas[..., :1] * 100.0


def metric_error(pred, gt, relative: bool = False):
    err = torch.abs(pred - gt)
    return err / gt if relative else err


# --------------------------------------------------------- mask-space GLS

# Marching-squares segment length per 2x2 cell code at the 0.5 iso-level
# (vertices at edge midpoints): single-corner cuts are sqrt(2)/2, adjacent
# pairs 1, diagonal (saddle) pairs 2*sqrt(2)/2.
_MS_D = 0.7071067811865476
_MS_LUT = (0.0, _MS_D, _MS_D, 1.0, _MS_D, 1.0, 2 * _MS_D, _MS_D,
           _MS_D, 2 * _MS_D, 1.0, _MS_D, 1.0, _MS_D, _MS_D, 0.0)


def mask_perimeter(mask: torch.Tensor) -> torch.Tensor:
    """Marching-squares perimeter of binary (..., H, W) masks at the 0.5
    level: the count of each of the 16 2x2-cell codes (exact in f32) times
    the code's segment length, in f32."""
    lead = mask.shape[:-2]
    m = F.pad((mask != 0).to(torch.float32), (1, 1, 1, 1))
    code = (m[..., :-1, :-1] + 2 * m[..., :-1, 1:] + 4 * m[..., 1:, :-1]
            + 8 * m[..., 1:, 1:]).to(torch.int64)
    code = code.reshape(-1, code.shape[-2] * code.shape[-1])
    n = code.shape[0]
    offset = 16 * torch.arange(n, device=mask.device)[:, None]
    counts = torch.bincount((code + offset).reshape(-1), minlength=16 * n)
    lut = torch.tensor(_MS_LUT, dtype=torch.float32, device=mask.device)
    return (counts.reshape(n, 16).to(torch.float32) @ lut).reshape(lead)


def _dilate3(m: torch.Tensor) -> torch.Tensor:
    """3x3 binary dilation of (..., H, W) float 0/1 maps (the JAX package's
    reduce_window max with SAME padding and init 0; on 0/1 maps the same as
    max pooling, whose padding never wins)."""
    h, w = m.shape[-2:]
    out = F.max_pool2d(m.reshape(-1, 1, h, w), 3, stride=1, padding=1)
    return out.reshape(m.shape)


def _first_argmax(key: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum over the last axis, as `jnp.argmax`."""
    top = key.max(dim=-1, keepdim=True).values
    idx = torch.arange(key.shape[-1], device=key.device)
    return torch.where(key == top, idx, key.shape[-1]).min(dim=-1).values


def mask_endo_base(seg: torch.Tensor, lv_label: int = 1, myo_label: int = 2,
                   use_myo: bool = True):
    """Left/right base markers of the endocardium from (..., H, W) label maps.

    Base = the LV pixels on the frontier of a dilated myocardium AND dilated
    background (with `use_myo=False`, the whole LV edge), split into
    left/right halves by the frontier's mean x, taking the bottom-most (then
    left-most) pixel of each half. Returns ((y_l, x_l), (y_r, x_r), valid),
    each (...)."""
    lv = (seg == lv_label).to(torch.float32)
    if use_myo:
        myo = (seg == myo_label).to(torch.float32)
        others = 1.0 - torch.maximum(lv, myo)
        frontier = lv * _dilate3(myo) * _dilate3(others)
    else:
        frontier = lv * _dilate3(1.0 - lv)
    h, w = frontier.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=seg.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=seg.device)[None, :].expand(h, w)
    cnt = frontier.sum(dim=(-2, -1))
    valid = cnt >= 2
    mean_x = (frontier * xs).sum(dim=(-2, -1)) / torch.clamp(cnt, min=1.0)
    f = frontier.reshape(*frontier.shape[:-2], h * w)
    y, x = ys.reshape(-1), xs.reshape(-1)
    left = f * (x < mean_x[..., None])
    right = f * (x >= mean_x[..., None])

    def bottom(sel):
        i = _first_argmax(torch.where(sel > 0, y, -1.0))
        return y[i], x[i]

    return bottom(left), bottom(right), valid


def mask_longitudinal_length(seg: torch.Tensor, lv_label: int = 1,
                             myo_label: int = 2,
                             use_myo: bool = True) -> torch.Tensor:
    """Longitudinal (base-excluded) endocardial length of (..., H, W) label
    maps: the marching-squares perimeter of the LV minus the base chord,
    floored at 1e-3; NaN when the base cannot be identified."""
    per = mask_perimeter(seg == lv_label)
    (yl, xl), (yr, xr), valid = mask_endo_base(seg, lv_label, myo_label, use_myo)
    chord = torch.sqrt((yl - yr) ** 2 + (xl - xr) ** 2)
    length = torch.clamp(per - chord, min=1e-3)
    return torch.where(valid, length, float("nan"))


def gls_mask_sequence(segs: torch.Tensor, lv_label: int = 1, myo_label: int = 2,
                      use_myo: bool = True) -> torch.Tensor:
    """GLS curve (%) over a (..., T, H, W) label-map sequence vs frame 0."""
    lengths = mask_longitudinal_length(segs, lv_label, myo_label, use_myo)
    return (lengths - lengths[..., :1]) / lengths[..., :1] * 100.0


# ----------------------------------------------------- Simpson biplane volume


def _principal_axis(mask: torch.Tensor):
    """Centroid and unit long-axis direction (toward the apex, up the
    image) from image moments of binary (..., H, W) masks: (cy, cx, vy, vx).

    The moments are exact: pixel counts and coordinate sums are integers,
    summed per row and column in f32 (exact below 2^24) and then in f64, so
    no summation order (CPU or GPU) changes them. The centroid is their f32
    quotient, as the JAX package computes it; the central second moments
    come from the raw ones in f64 and are rounded to f32 once, where the
    JAX package sums them in f32."""
    h, w = mask.shape[-2:]
    m = mask.to(torch.float32)
    f64 = torch.float64
    y = torch.arange(h, dtype=f64, device=mask.device)
    x = torch.arange(w, dtype=f64, device=mask.device)
    rows = m.sum(-1).to(f64)  # (..., H) pixels per row
    cols = m.sum(-2).to(f64)  # (..., W) pixels per column
    row_x = (m * x.to(torch.float32)).sum(-1).to(f64)  # (..., H) sum of x per row
    n = rows.sum(-1)
    sy, sx = (rows * y).sum(-1), (cols * x).sum(-1)
    syy, sxx, sxy = (rows * y * y).sum(-1), (cols * x * x).sum(-1), (row_x * y).sum(-1)
    total = torch.clamp(n, min=1.0)
    cy = sy.to(torch.float32) / total.to(torch.float32)
    cx = sx.to(torch.float32) / total.to(torch.float32)
    cy64, cx64 = cy.to(f64), cx.to(f64)
    myy = ((syy - 2.0 * cy64 * sy + cy64 * cy64 * n) / total).to(torch.float32)
    mxx = ((sxx - 2.0 * cx64 * sx + cx64 * cx64 * n) / total).to(torch.float32)
    mxy = ((sxy - cy64 * sx - cx64 * sy + cy64 * cx64 * n) / total).to(torch.float32)
    # Leading eigenvector of [[myy, mxy], [mxy, mxx]] in (y, x) coords.
    half = 0.5 * (myy + mxx)
    rad = torch.sqrt(torch.clamp(0.25 * (myy - mxx) ** 2 + mxy * mxy, min=1e-12))
    lam = half + rad
    tilted = torch.abs(mxy) > 1e-9
    vy = torch.where(tilted, mxy, 1.0)
    vx = torch.where(tilted, lam - myy, torch.where(myy >= mxx, 0.0, 1.0))
    norm = torch.sqrt(vy * vy + vx * vx)
    vy, vx = vy / norm, vx / norm
    flip = torch.where(vy > 0, -1.0, 1.0)
    return cy, cx, vy * flip, vx * flip


def _round_half_away(c: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (`jax.scipy.ndimage.map_coordinates`'
    nearest-neighbour rule; torch.round rounds half to even)."""
    t = torch.trunc(c)
    return torch.where((c - t).abs() >= 0.5, t + torch.sign(c), t)


def lv_disk_diameters(mask: torch.Tensor, voxelspacing, n_disks: int = 20,
                      n_steps: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simpson disk diameters (mm) and step size (mm) of binary (..., H, W)
    LV masks, with (2,) or (..., 2) voxel spacings (row, column).

    The long axis runs from the basal extreme to the apical extreme of the
    mask along its principal axis (NaN for an empty mask); each diameter is
    the covered length of n_steps nearest-pixel samples along a chord
    perpendicular to it (out-of-image samples read 0). Returns (..., n_disks)
    and (...)."""
    h, w = mask.shape[-2:]
    dev = mask.device
    m = (mask != 0).to(torch.float32)
    vs = torch.as_tensor(voxelspacing, dtype=torch.float32, device=dev)
    vs = vs.expand(*m.shape[:-2], 2)
    vs0, vs1 = vs[..., 0], vs[..., 1]
    cy, cx, vy, vx = _principal_axis(m)
    # Physical-space axis direction.
    py, px = vy * vs0, vx * vs1
    pn = torch.sqrt(py * py + px * px)
    py, px = py / pn, px / pn

    def grid(v):  # (...) -> (..., 1, 1)
        return v[..., None, None]

    # Project mask pixels onto the axis to find the basal and apical ends.
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] * grid(vs0)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] * grid(vs1)
    proj = (yy - grid(cy * vs0)) * grid(py) + (xx - grid(cx * vs1)) * grid(px)
    fg = m > 0
    nonempty = fg.any(dim=-1).any(dim=-1)
    t_min = torch.where(fg, proj, math.inf).amin(dim=(-2, -1))
    t_max = torch.where(fg, proj, -math.inf).amax(dim=(-2, -1))
    t_min = torch.where(nonempty, t_min, float("nan"))
    t_max = torch.where(nonempty, t_max, float("nan"))
    length = t_max - t_min

    ny, nx = -px, py
    fractions = linspace(0.0, 1.0, n_disks, device=dev, endpoint=False)  # (D,)
    max_half = 0.5 * torch.sqrt((h * vs0) ** 2 + (w * vs1) ** 2)
    s = linspace(-1.0, 1.0, n_steps, device=dev) * max_half[..., None]  # (..., S)

    base_y = cy * vs0 + t_min * py
    base_x = cx * vs1 + t_min * px

    def disk(v):  # (...) -> (..., 1, 1), broadcast over (disks, steps)
        return v[..., None, None]

    oy = disk(base_y) + fractions[:, None] * disk(length) * disk(py)  # (..., D, 1)
    ox = disk(base_x) + fractions[:, None] * disk(length) * disk(px)
    sy = (oy + s[..., None, :] * disk(ny)) / disk(vs0)  # (..., D, S)
    sx = (ox + s[..., None, :] * disk(nx)) / disk(vs1)
    iy, ix = _round_half_away(sy), _round_half_away(sx)
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)  # NaN: outside
    flat = torch.where(inside, iy * w + ix, 0.0).to(torch.int64)
    lead = m.shape[:-2]
    vals = torch.gather(m.reshape(*lead, h * w), -1, flat.reshape(*lead, -1))
    vals = torch.where(inside, vals.reshape(flat.shape), 0.0)
    step_len = s[..., 1] - s[..., 0]
    diameters = vals.sum(-1) * step_len[..., None]
    step_size = length * _reciprocal(n_disks)
    return diameters, step_size


def _reciprocal(d: float) -> float:
    """1/d rounded to f32. A division by a constant is a multiplication by
    it, here as in XLA's compiled code and PyTorch's CUDA division by a
    scalar, so a result is the same on the CPU and the GPU."""
    return float(np.float32(1) / np.float32(d))


def lv_volume(a2c_diameters, a4c_diameters, step_size) -> torch.Tensor:
    """Biplane Simpson volume in ml: mm -> m -> ml, over the last axis. The
    20 products are summed in f64 and rounded once, so the sum does not
    depend on the device's order."""
    milli = _reciprocal(1000.0)
    d2 = a2c_diameters * milli
    d4 = a4c_diameters * milli
    step = step_size * milli
    disks = (d2.to(torch.float64) * d4.to(torch.float64)).sum(-1).to(torch.float32)
    return disks * step * math.pi / 4.0 * 1e6


def compute_left_ventricle_volumes(a2c_ed, a2c_es, a2c_voxelspacing,
                                   a4c_ed, a4c_es, a4c_voxelspacing):
    """ED/ES Simpson-biplane LV volumes from binary (..., H, W) masks of
    both views, with (2,) or (..., 2) voxel spacings. The four mask sets
    go through one batched diameter call."""
    shape = torch.broadcast_shapes(a2c_ed.shape, a2c_es.shape, a4c_ed.shape, a4c_es.shape)
    masks = torch.stack([t.expand(shape) for t in (a2c_ed, a2c_es, a4c_ed, a4c_es)])
    dev = masks.device
    vs2 = torch.as_tensor(a2c_voxelspacing, dtype=torch.float32, device=dev)
    vs4 = torch.as_tensor(a4c_voxelspacing, dtype=torch.float32, device=dev)
    lead = shape[:-2]
    vs = torch.stack([vs2.expand(*lead, 2), vs2.expand(*lead, 2),
                      vs4.expand(*lead, 2), vs4.expand(*lead, 2)])
    d, s = lv_disk_diameters(masks, vs)
    d2_ed, d2_es, d4_ed, d4_es = d
    step = torch.maximum(torch.maximum(s[0], s[1]), torch.maximum(s[2], s[3]))
    return lv_volume(d2_ed, d4_ed, step), lv_volume(d2_es, d4_es, step)


def ejection_fraction(edv, esv):
    return (edv - esv) / edv
