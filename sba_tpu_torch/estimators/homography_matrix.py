"""Homography estimation: normalized 4-point DLT, transfer error, and
pose from a homography.

Port of ``sba_tpu/estimators/homography_matrix.py`` (ref: src/
estimators/homography_matrix.{h,cc}, src/base/homography_matrix.cc).
The DLT and the transfer error are batched tensor code; the
decomposition and the cheirality vote run once per image pair on the
host in numpy, as in sba_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from sba_tpu_torch.estimators import _linalg
from sba_tpu_torch.estimators.fundamental_matrix import _normalize_points


def homography_dlt(xy1, xy2):
    """DLT homography from >= 4 correspondences, Hartley-normalized.
    xy* [..., M, 2] -> H [..., 3, 3] with x2 ~ H x1, H[2, 2] = 1."""
    n1, T1 = _normalize_points(xy1)
    n2, T2 = _normalize_points(xy2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    one = torch.ones_like(x1)
    zero = torch.zeros_like(x1)
    r1 = torch.stack([-x1, -y1, -one, zero, zero, zero, x2 * x1, x2 * y1,
                      x2], -1)
    r2 = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1,
                      y2], -1)
    A = torch.cat([r1, r2], -2)
    V = _linalg.eigh_vectors(torch.einsum("...mi,...mj->...ij", A, A))
    H = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    T2inv = torch.linalg.inv_ex(T2).inverse
    H = torch.einsum("...ij,...jk,...kl->...il", T2inv, H, T1)
    scale = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(scale) > 1e-12, scale,
                           torch.ones_like(scale))


def homography_transfer_error(H, xy1, xy2, eps=1e-12):
    """Squared one-sided transfer error |x2 - H x1|^2; 1e12 where the
    point maps to infinity."""
    x1 = torch.cat([xy1, torch.ones_like(xy1[..., :1])], -1)
    Hx = torch.einsum("...ij,...mj->...mi", H, x1)
    z = Hx[..., 2]
    far = torch.abs(z) > eps
    proj = Hx[..., :2] / torch.where(far, z, torch.full_like(z, eps))[..., None]
    err = torch.sum((proj - xy2) ** 2, -1)
    return torch.where(far, err, torch.full_like(err, 1e12))


# ---------------------------------------------------------------------------
# Homography -> pose decomposition (Malis & Vargas 2007).
#
# Host-side numpy: this runs ONCE per image pair after RANSAC has picked
# a winning H — a handful of 3x3 eigen/SVD ops, not a batched hot path.
# Capability parity with ref: src/base/homography_matrix.cc:65-186
# (DecomposeHomographyMatrix, PoseFromHomographyMatrix).
# ---------------------------------------------------------------------------


def _opposite_of_minor(m, row, col):
    col1 = 1 if col == 0 else 0
    col2 = 1 if col == 2 else 2
    row1 = 1 if row == 0 else 0
    row2 = 1 if row == 2 else 2
    return m[row1, col2] * m[row2, col1] - m[row1, col1] * m[row2, col2]


def decompose_homography(H, K1, K2):
    """All candidate (R, t, n) for a calibrated homography.

    Returns (Rs, ts, ns): lists of length 4 for a plane-induced H, or
    length 1 with t = n = 0 for a pure rotation. The first camera is
    P1 = [I | 0]; x2 ~ K2 (R - t n^T / d) K1^-1 x1. Math follows the
    Malis/Vargas analytic decomposition used by the reference
    (ref: src/base/homography_matrix.cc:65-186)."""
    H = np.asarray(H, np.float64)
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    Hn = np.linalg.inv(K2) @ H @ K1
    # Remove scale: divide by the middle singular value.
    sv = np.linalg.svd(Hn, compute_uv=False)
    Hn = Hn / sv[1]
    # Rotations, never reflections: det(R) has the sign of det(Hn).
    if np.linalg.det(Hn) < 0:
        Hn = -Hn

    S = Hn.T @ Hn - np.eye(3)
    if np.abs(S).max() < 1e-3:
        # Pure rotation (panoramic pair).
        return [Hn], [np.zeros(3)], [np.zeros(3)]

    M00 = _opposite_of_minor(S, 0, 0)
    M11 = _opposite_of_minor(S, 1, 1)
    M22 = _opposite_of_minor(S, 2, 2)
    rtM00 = np.sqrt(max(M00, 0.0))
    rtM11 = np.sqrt(max(M11, 0.0))
    rtM22 = np.sqrt(max(M22, 0.0))
    M01 = _opposite_of_minor(S, 0, 1)
    M12 = _opposite_of_minor(S, 1, 2)
    M02 = _opposite_of_minor(S, 0, 2)
    e12 = 1.0 if M12 >= 0 else -1.0
    e02 = 1.0 if M02 >= 0 else -1.0
    e01 = 1.0 if M01 >= 0 else -1.0

    idx = int(np.argmax([abs(S[0, 0]), abs(S[1, 1]), abs(S[2, 2])]))
    np1 = np.zeros(3)
    np2 = np.zeros(3)
    if idx == 0:
        np1[0] = np2[0] = S[0, 0]
        np1[1] = S[0, 1] + rtM22
        np2[1] = S[0, 1] - rtM22
        np1[2] = S[0, 2] + e12 * rtM11
        np2[2] = S[0, 2] - e12 * rtM11
    elif idx == 1:
        np1[0] = S[0, 1] + rtM22
        np2[0] = S[0, 1] - rtM22
        np1[1] = np2[1] = S[1, 1]
        np1[2] = S[1, 2] - e02 * rtM00
        np2[2] = S[1, 2] + e02 * rtM00
    else:
        np1[0] = S[0, 2] + e01 * rtM11
        np2[0] = S[0, 2] - e01 * rtM11
        np1[1] = S[1, 2] + rtM00
        np2[1] = S[1, 2] - rtM00
        np1[2] = np2[2] = S[2, 2]

    traceS = np.trace(S)
    v = 2.0 * np.sqrt(max(1.0 + traceS - M00 - M11 - M22, 0.0))
    ESii = 1.0 if S[idx, idx] >= 0 else -1.0
    r = np.sqrt(max(2.0 + traceS + v, 0.0))
    n_t = np.sqrt(max(2.0 + traceS - v, 0.0))

    n1 = np1 / max(np.linalg.norm(np1), 1e-12)
    n2 = np2 / max(np.linalg.norm(np2), 1e-12)
    half_nt = 0.5 * n_t
    esii_t_r = ESii * r
    t1_star = half_nt * (esii_t_r * n2 - n_t * n1)
    t2_star = half_nt * (esii_t_r * n1 - n_t * n2)

    def rot(tstar, n):
        return Hn @ (np.eye(3) - (2.0 / v) * np.outer(tstar, n))

    R1 = rot(t1_star, n1)
    t1 = R1 @ t1_star
    R2 = rot(t2_star, n2)
    t2 = R2 @ t2_star
    return ([R1, R1, R2, R2], [t1, -t1, t2, -t2], [-n1, n1, -n2, n2])


def _check_cheirality(R, t, p1, p2):
    """Triangulate normalized correspondences under P1=[I|0], P2=[R|t];
    return the boolean mask of points with valid positive bounded depth
    in BOTH views (ref: src/base/pose.cc:225-247)."""
    n = p1.shape[0]
    if n == 0:
        return np.zeros(0, bool), np.zeros((0, 3))
    P2 = np.concatenate([R, t[:, None]], axis=1)
    # Batched DLT mid-point triangulation (4x4 eigenproblem per point).
    A = np.zeros((n, 4, 4))
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    A[:, 0] = p1[:, 0, None] * P1[2] - P1[0]
    A[:, 1] = p1[:, 1, None] * P1[2] - P1[1]
    A[:, 2] = p2[:, 0, None] * P2[2] - P2[0]
    A[:, 3] = p2[:, 1, None] * P2[2] - P2[1]
    _, _, Vt = np.linalg.svd(A)
    X = Vt[:, 3, :]
    w = X[:, 3]
    safe_w = np.where(np.abs(w) > 1e-15, w, 1e-15)
    X3 = X[:, :3] / safe_w[:, None]
    d1 = X3[:, 2]
    d2 = (X3 @ R.T + t)[:, 2]
    kmin = np.finfo(np.float64).eps
    max_depth = 1000.0 * np.linalg.norm(R.T @ t)
    ok = (d1 > kmin) & (d1 < max_depth) & (d2 > kmin) & (d2 < max_depth)
    return ok, X3


def pose_from_homography(H, K1, K2, xy1, xy2, inlier_mask=None):
    """Most probable (R, t, n, points3D) from H by cheirality voting over
    the candidate decompositions (ref: src/base/homography_matrix.cc:186
    PoseFromHomographyMatrix). xy1/xy2 are PIXEL keypoints; only
    inlier-masked rows vote. For a pure-rotation H returns t = 0 (the
    panoramic case the essential matrix cannot represent)."""
    xy1 = np.asarray(xy1, np.float64)
    xy2 = np.asarray(xy2, np.float64)
    if inlier_mask is not None:
        keep = np.asarray(inlier_mask, bool)
        xy1, xy2 = xy1[keep], xy2[keep]
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    p1 = (xy1 - K1[:2, 2]) / np.array([K1[0, 0], K1[1, 1]])
    p2 = (xy2 - K2[:2, 2]) / np.array([K2[0, 0], K2[1, 1]])

    Rs, ts, ns = decompose_homography(H, K1, K2)
    best = (-1, None)
    for R, t, n in zip(Rs, ts, ns):
        if np.linalg.norm(t) < 1e-12:
            # Pure rotation: every correspondence is consistent.
            return R, t, n, np.zeros((0, 3))
        ok, X3 = _check_cheirality(R, t, p1, p2)
        score = int(ok.sum())
        # ">=": later candidates win ties, matching the reference's
        # tie-break across the two-fold planar ambiguity (both (R1, t1)
        # and (R2, t2) can pass cheirality with every point;
        # ref: homography_matrix.cc:205 `>=`).
        if score >= best[0]:
            best = (score, (R, t, n, X3[ok]))
    return best[1]
