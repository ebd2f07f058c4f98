"""Closed-form 2x2 symmetric-matrix helpers, batched over leading axes.

Counterpart of contouring_uncertainty_tpu/distributions/linalg.py. Every
function is written out elementwise: nothing goes through `torch.linalg`
or a matmul, so the tiny contractions are exact f32 arithmetic on any
device and any precision setting.
"""

from __future__ import annotations

import torch


def eigh2x2(mat: torch.Tensor):
    """Closed-form eigendecomposition of symmetric (..., 2, 2) matrices.

    Returns (eigvals (..., 2) ascending, eigvecs (..., 2, 2) with columns as
    eigenvectors)."""
    a = mat[..., 0, 0]
    b = mat[..., 0, 1]
    d = mat[..., 1, 1]
    half_tr = 0.5 * (a + d)
    rad = torch.sqrt(torch.clamp(0.25 * (a - d) ** 2 + b * b, min=0.0))
    lam1 = half_tr - rad
    lam2 = half_tr + rad
    # Eigenvector for lam2: (b, lam2 - a), falling back to e_x when b == 0.
    safe = b.abs() > 1e-30
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    v2x = torch.where(safe, b, torch.where(a >= d, one, zero))
    v2y = torch.where(safe, lam2 - a, torch.where(a >= d, zero, one))
    norm = torch.sqrt(v2x * v2x + v2y * v2y)
    v2x, v2y = v2x / norm, v2y / norm
    v1x, v1y = -v2y, v2x  # lam1's eigenvector is the orthogonal complement
    vals = torch.stack([lam1, lam2], dim=-1)
    vecs = torch.stack(
        [torch.stack([v1x, v2x], dim=-1), torch.stack([v1y, v2y], dim=-1)], dim=-2
    )
    return vals, vecs


def mat2_vec(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) @ (..., 2) as explicit elementwise ops."""
    x = mat[..., 0, 0] * vec[..., 0] + mat[..., 0, 1] * vec[..., 1]
    y = mat[..., 1, 0] * vec[..., 0] + mat[..., 1, 1] * vec[..., 1]
    return torch.stack([x, y], dim=-1)


def mat2_mat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) @ (..., 2, 2) as explicit elementwise ops."""
    return torch.stack([
        torch.stack([a[..., 0, 0] * b[..., 0, 0] + a[..., 0, 1] * b[..., 1, 0],
                     a[..., 0, 0] * b[..., 0, 1] + a[..., 0, 1] * b[..., 1, 1]], dim=-1),
        torch.stack([a[..., 1, 0] * b[..., 0, 0] + a[..., 1, 1] * b[..., 1, 0],
                     a[..., 1, 0] * b[..., 0, 1] + a[..., 1, 1] * b[..., 1, 1]], dim=-1),
    ], dim=-2)


def sym_matrix_pow(mat: torch.Tensor, p: float, eps: float = 0.0) -> torch.Tensor:
    """Real power of symmetric PSD (..., 2, 2) matrices via closed-form eigh."""
    vals, vecs = eigh2x2(mat)
    powed = torch.pow(torch.clamp(vals, min=eps), p)
    v1 = vecs[..., :, 0]
    v2 = vecs[..., :, 1]
    out1 = v1[..., :, None] * v1[..., None, :] * powed[..., 0, None, None]
    out2 = v2[..., :, None] * v2[..., None, :] * powed[..., 1, None, None]
    return out1 + out2


def cov2corr(cov: torch.Tensor):
    """Covariance -> (correlation matrix, per-axis std). Batched over (..., 2, 2)."""
    std = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
    corr = cov / (std[..., :, None] * std[..., None, :])
    return corr, std


def rotation_matrix(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def rotate_cov(cov: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """R(theta) @ cov @ R(theta)^T, batched."""
    rot = rotation_matrix(theta.to(cov.dtype))
    return mat2_mat(mat2_mat(rot, cov), rot.transpose(-1, -2))


def rotate_alpha(alpha: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """R(theta) @ alpha for (..., 2) vectors."""
    return mat2_vec(rotation_matrix(theta.to(alpha.dtype)), alpha)


def inv2x2(mat: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) matrices."""
    a = mat[..., 0, 0]
    b = mat[..., 0, 1]
    c = mat[..., 1, 0]
    d = mat[..., 1, 1]
    det = a * d - b * c
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) / det[..., None, None]


def det2x2(mat: torch.Tensor) -> torch.Tensor:
    return mat[..., 0, 0] * mat[..., 1, 1] - mat[..., 0, 1] * mat[..., 1, 0]


def chol2x2(mat: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form Cholesky factor (lower) of PSD (..., 2, 2) matrices."""
    a = torch.clamp(mat[..., 0, 0], min=eps)
    b = mat[..., 1, 0]
    d = mat[..., 1, 1]
    l00 = torch.sqrt(a)
    l10 = b / l00
    l11 = torch.sqrt(torch.clamp(d - l10 * l10, min=eps))
    zero = torch.zeros_like(l00)
    row0 = torch.stack([l00, zero], dim=-1)
    row1 = torch.stack([l10, l11], dim=-1)
    return torch.stack([row0, row1], dim=-2)
