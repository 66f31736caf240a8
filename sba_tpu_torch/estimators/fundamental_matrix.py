"""Fundamental matrix solvers: 7-point and normalized 8-point.

Port of ``sba_tpu/estimators/fundamental_matrix.py`` (ref: src/
estimators/fundamental_matrix.{h,cc}), batched over leading dims for
the batched RANSAC. The 7-point cubic is solved by the same
Durand-Kerner iteration (``ops/polynomial.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sba_tpu_torch.estimators import _linalg
from sba_tpu_torch.ops.polynomial import real_roots

# det(f2 + lam (f1 - f2)) sampled at these lam, then the cubic's
# coefficients [c3, c2, c1, c0] by the inverse Vandermonde matrix.
_LAMS = (0.0, 1.0, -1.0, 2.0)
_VM_INV = np.linalg.inv(np.stack([np.asarray(_LAMS) ** 3,
                                  np.asarray(_LAMS) ** 2,
                                  np.asarray(_LAMS),
                                  np.ones(4)], -1))


def _normalize_points(xy, eps=1e-12):
    """Hartley normalization: centroid 0, mean distance sqrt(2).
    Returns (xy_norm [..., M, 2], T [..., 3, 3]) with x_n = T x."""
    c = torch.mean(xy, dim=-2, keepdim=True)
    d = torch.sqrt(torch.sum((xy - c) ** 2, -1))
    scale = math.sqrt(2.0) / torch.clamp(torch.mean(d, -1), min=eps)
    xy_n = (xy - c) * scale[..., None, None]
    z = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, z, -scale * c[..., 0, 0]], -1),
        torch.stack([z, scale, -scale * c[..., 0, 1]], -1),
        torch.stack([z, z, one], -1),
    ], -2)
    return xy_n, T


def _epipolar_rows(xy1, xy2):
    """Rows of x2^T F x1 = 0: [..., M, 9]."""
    x1, y1 = xy1[..., 0], xy1[..., 1]
    x2, y2 = xy2[..., 0], xy2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], -1)


def fundamental_8pt(xy1, xy2):
    """Normalized 8-point with rank-2 enforcement; xy* [..., M >= 8, 2]
    -> F [..., 3, 3], unit Frobenius norm."""
    n1, T1 = _normalize_points(xy1)
    n2, T2 = _normalize_points(xy2)
    A = _epipolar_rows(n1, n2)
    V = _linalg.eigh_vectors(torch.einsum("...mi,...mj->...ij", A, A))
    F = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    U, S, Vt = _linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    F = torch.einsum("...ik,...k,...kj->...ij", U, S, Vt)
    F = torch.einsum("...ji,...jk,...kl->...il", T2, F, T1)
    return _linalg.frob_normalize(F)


def fundamental_7pt(xy1, xy2):
    """7-point: up to 3 solutions. xy* [..., 7, 2] ->
    (F [..., 3, 3, 3], valid [..., 3])."""
    A = _epipolar_rows(xy1, xy2)
    V = _linalg.eigh_vectors(torch.einsum("...mi,...mj->...ij", A, A))
    f1 = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    f2 = V[..., :, 1].reshape(V.shape[:-2] + (3, 3))
    D = f1 - f2
    vals = torch.stack([_linalg.det3(f2 + lam * D) for lam in _LAMS], -1)
    coeffs = vals @ torch.as_tensor(_VM_INV.T, dtype=vals.dtype,
                                    device=vals.device)
    lam, ok = real_roots(coeffs)
    F = f2[..., None, :, :] + lam[..., :, None, None] * D[..., None, :, :]
    return _linalg.frob_normalize(F), ok & torch.isfinite(lam)


def sampson_error_f(F, xy1, xy2, eps=1e-12):
    """Squared Sampson distance; F [..., 3, 3], xy* [..., M, 2] -> [..., M]
    (ref: src/estimators/utils.cc ComputeSquaredSampsonError)."""
    x1 = torch.cat([xy1, torch.ones_like(xy1[..., :1])], -1)
    x2 = torch.cat([xy2, torch.ones_like(xy2[..., :1])], -1)
    Fx1 = torch.einsum("...ij,...mj->...mi", F, x1)
    Ftx2 = torch.einsum("...ji,...mj->...mi", F, x2)
    num = torch.sum(x2 * Fx1, -1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
           + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return num / torch.clamp(den, min=eps)
