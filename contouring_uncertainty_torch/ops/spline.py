"""Interpolating parametric cubic splines, batched over leading axes.

Counterpart of contouring_uncertainty_tpu/ops/spline.py: a chord-length-
parameterized, not-a-knot C^2 cubic through the K landmarks (what scipy's
`splprep(k=3, s=0)` produces), solved by banded (Thomas) elimination and
evaluated at S parameters. Every function takes points (..., K, 2); the
JAX package vmaps a (K, 2) version instead.
"""

from __future__ import annotations

import numpy as np
import torch


def linspace(start: float, stop: float, num: int, dtype=torch.float32,
             device=None, endpoint: bool = True) -> torch.Tensor:
    """`jnp.linspace`'s formula: start*(1-s) + stop*s with s = i * (1/div)
    in f32, where div = num-1 and the endpoint is appended exactly, or
    (endpoint=False) div = num and no endpoint.

    s multiplies by the f32 reciprocal, as XLA compiles jnp.linspace's
    division by a constant, and as PyTorch's CUDA division by a scalar
    does: the values are the same on the CPU and the GPU, and equal to
    JAX's from 0 to 1. (XLA on the CPU also fuses the last multiply-add,
    which moves some values of other ranges by one ulp.)"""
    div = num - 1 if endpoint else num
    step = torch.arange(div, dtype=dtype, device=device) * float(np.float32(1) / np.float32(div))
    out = start * (1 - step) + stop * step
    if not endpoint:
        return out
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])


def chord_length_params(points: torch.Tensor) -> torch.Tensor:
    """Normalized cumulative chord-length parameter u in [0, 1]: (..., K, 2) -> (..., K)."""
    d = points[..., 1:, :] - points[..., :-1, :]
    seg = torch.sqrt((d * d).sum(-1))
    u = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, dim=-1)], dim=-1)
    return u / u[..., -1:]


def _banded_spline_solve(u: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Second derivatives M (..., K, 2) of the not-a-knot spline through
    y (..., K, 2) at knots u (..., K).

    The K x K system is tridiagonal except for one extra entry in rows 0
    and K-1 (third-derivative continuity at the second and second-to-last
    knots); folding those into rows 1 and K-2 leaves the strictly
    diagonally dominant spline tridiagonal, solved without pivoting by an
    unrolled Thomas elimination (K is small and static)."""
    k = u.shape[-1]
    h = u[..., 1:] - u[..., :-1]  # (..., K-1)
    d = (y[..., 1:, :] - y[..., :-1, :]) / h[..., None]  # slopes (..., K-1, 2)

    lower = h[..., :-1] / 6.0  # coeff of M[i-1] in row i, i = 1..K-2
    diag = (h[..., :-1] + h[..., 1:]) / 3.0
    upper = h[..., 1:] / 6.0
    rhs = d[..., 1:, :] - d[..., :-1, :]  # (..., K-2, 2)

    # Eliminate M0 from row 1:  M0 = (1 + h0/h1) M1 - (h0/h1) M2.
    r01 = h[..., 0] / h[..., 1]
    diag1 = diag[..., 0] + lower[..., 0] * (1.0 + r01)
    upper1 = upper[..., 0] - lower[..., 0] * r01
    # Eliminate M[K-1] from row K-2 with the symmetric far-end condition.
    rkk = h[..., -1] / h[..., -2]
    diag_l = diag[..., -1] + upper[..., -1] * (1.0 + rkk)
    lower_l = lower[..., -1] - upper[..., -1] * rkk

    n = k - 2  # interior unknowns M1..M[K-2]
    dia = [diag[..., i] for i in range(n)]
    upp = [upper[..., i] if i < n - 1 else None for i in range(n)]
    low = [lower[..., i] if i > 0 else None for i in range(n)]
    dia[0], dia[-1] = diag1, diag_l
    if n > 1:
        upp[0] = upper1
        low[-1] = lower_l

    # Forward elimination.
    cp = [None] * n
    dp = [None] * n
    cp[0] = (upp[0] / dia[0]) if n > 1 else None
    dp[0] = rhs[..., 0, :] / dia[0][..., None]
    for i in range(1, n):
        denom = dia[i] - low[i] * cp[i - 1]
        if i < n - 1:
            cp[i] = upp[i] / denom
        dp[i] = (rhs[..., i, :] - low[i][..., None] * dp[i - 1]) / denom[..., None]
    # Back substitution.
    m_int = [None] * n
    m_int[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        m_int[i] = dp[i] - m_int[i + 1] * cp[i][..., None]
    m0 = (1.0 + r01)[..., None] * m_int[0] - r01[..., None] * m_int[1]
    mk1 = (1.0 + rkk)[..., None] * m_int[-1] - rkk[..., None] * m_int[-2]
    return torch.stack([m0] + m_int + [mk1], dim=-2)


def spline_fit(points: torch.Tensor):
    """Fit x(u), y(u) not-a-knot cubics through (..., K, 2) landmarks (K >= 5).

    Returns (u_knots (..., K), points (..., K, 2), second_derivs (..., K, 2))."""
    if points.shape[-2] < 5:
        raise ValueError("the banded not-a-knot solve needs K >= 5 landmarks")
    u = chord_length_params(points)
    return u, points, _banded_spline_solve(u, points)


def spline_eval(u_knots, points, m, t, derivative: int = 0):
    """Evaluate the fitted spline (or its first derivative) at parameters
    t (S,) or (..., S). Returns (..., S, 2).

    Segment i is the one with u_i <= t < u_{i+1} (t clamped into
    [u_0, u_{K-1}) for the lookup only), found by `searchsorted` and read
    with exact gathers — the same selection as the JAX one-hot matmul."""
    lead = u_knots.shape[:-1]
    t = t.expand(*lead, t.shape[-1]) if t.dim() == 1 else t
    t_cl = torch.minimum(torch.maximum(t, u_knots[..., :1]), u_knots[..., -1:] - 1e-6)
    idx = torch.searchsorted(u_knots[..., :-1].contiguous(), t_cl.contiguous(), right=True) - 1
    idx = idx.clamp(0, u_knots.shape[-1] - 2)
    u0 = torch.gather(u_knots, -1, idx)
    u1 = torch.gather(u_knots, -1, idx + 1)
    idx2 = idx[..., None].expand(*idx.shape, 2)
    y0 = torch.gather(points, -2, idx2)
    y1 = torch.gather(points, -2, idx2 + 1)
    m0 = torch.gather(m, -2, idx2)
    m1 = torch.gather(m, -2, idx2 + 1)
    h = (u1 - u0)[..., None]
    a = ((u1 - t) / (u1 - u0))[..., None]
    b = ((t - u0) / (u1 - u0))[..., None]
    if derivative == 0:
        return a * y0 + b * y1 + ((a * a * a - a) * m0 + (b * b * b - b) * m1) * (h * h) / 6.0
    if derivative == 1:
        return (y1 - y0) / h + (-(3.0 * (a * a) - 1.0) * m0 + (3.0 * (b * b) - 1.0) * m1) * h / 6.0
    raise ValueError(f"derivative={derivative} not supported")


def contour_spline(points: torch.Tensor, n: int = 1001, close: bool = False) -> torch.Tensor:
    """Dense resampling of the interpolating spline at n uniform parameters.
    points (..., K, 2) -> (..., n [+1], 2) (`close` appends the first point)."""
    u, p, m = spline_fit(points)
    t = linspace(0.0, 1.0, n, dtype=points.dtype, device=points.device)
    dense = spline_eval(u, p, m, t)
    if close:
        dense = torch.cat([dense, dense[..., :1, :]], dim=-2)
    return dense


def contour_tangents(points: torch.Tensor) -> torch.Tensor:
    """Unit tangent of the spline at each landmark's parameter: (..., K, 2)."""
    u, p, m = spline_fit(points)
    der = spline_eval(u, p, m, u, derivative=1)
    return der / torch.sqrt((der * der).sum(-1, keepdim=True))
