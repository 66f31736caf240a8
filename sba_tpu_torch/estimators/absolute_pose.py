"""Absolute pose minimal solvers: P3P (Grunert) and EPnP.

Port of ``sba_tpu/estimators/absolute_pose.py`` (ref: src/estimators/
absolute_pose.{h,cc}, `P3PEstimator` :52, `EPNPEstimator` :97), batched
over leading dims (the RANSAC hypotheses). P3P's quartic is sba_tpu's
sympy-derived one, its roots the port's Durand-Kerner iteration
(`ops/polynomial.real_roots`). EPnP's eigen-decompositions and 4x4
inverse go through `estimators/_linalg` (no raise on a degenerate
sample; the model is masked or dropped either way).
"""

from __future__ import annotations

import torch

from sba_tpu_torch.estimators import _linalg
from sba_tpu_torch.geometry.similarity import rigid_from_points
from sba_tpu_torch.ops.polynomial import real_roots


def _bearings(xy):
    """Normalized image points [..., M, 2] -> unit bearing vectors."""
    f = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def p3p_solve(points3d, points2d):
    """Grunert P3P: up to 4 poses from 3 correspondences.

    points3d: [..., 3, 3] world; points2d: [..., 3, 2] NORMALIZED image
    coords. Returns (qvec [..., 4, 4], tvec [..., 4, 3], valid [..., 4])
    with x_cam = R x_world + t.
    """
    f = _bearings(points2d)
    A, B, C = points3d[..., 0, :], points3d[..., 1, :], points3d[..., 2, :]
    fa, fb, fc = f[..., 0, :], f[..., 1, :], f[..., 2, :]

    a2 = torch.sum((B - C) ** 2, -1)
    b2 = torch.sum((A - C) ** 2, -1)
    c2 = torch.sum((A - B) ** 2, -1)
    ca = torch.sum(fb * fc, -1)  # cos(alpha): rays to B, C
    cb = torch.sum(fa * fc, -1)  # cos(beta):  rays to A, C
    cg = torch.sum(fa * fb, -1)  # cos(gamma): rays to A, B

    # Quartic in v = |PC|/|PA| (sba_tpu's coefficients, b2^2 dropped).
    A4 = (a2 ** 2 - 2 * a2 * b2 - 2 * a2 * c2 + b2 ** 2
          - 4 * b2 * c2 * ca ** 2 + 2 * b2 * c2 + c2 ** 2)
    A3 = 4 * (-a2 ** 2 * cb + a2 * b2 * ca * cg + a2 * b2 * cb
              + 2 * a2 * c2 * cb - b2 ** 2 * ca * cg
              + 2 * b2 * c2 * ca ** 2 * cb + b2 * c2 * ca * cg
              - b2 * c2 * cb - c2 ** 2 * cb)
    A2 = 2 * (2 * a2 ** 2 * cb ** 2 + a2 ** 2 - 4 * a2 * b2 * ca * cb * cg
              - 2 * a2 * b2 * cg ** 2 - 4 * a2 * c2 * cb ** 2 - 2 * a2 * c2
              + 2 * b2 ** 2 * ca ** 2 + 2 * b2 ** 2 * cg ** 2 - b2 ** 2
              - 2 * b2 * c2 * ca ** 2 - 4 * b2 * c2 * ca * cb * cg
              + 2 * c2 ** 2 * cb ** 2 + c2 ** 2)
    A1 = 4 * (-a2 ** 2 * cb + a2 * b2 * ca * cg + 2 * a2 * b2 * cb * cg ** 2
              - a2 * b2 * cb + 2 * a2 * c2 * cb - b2 ** 2 * ca * cg
              + b2 * c2 * ca * cg + b2 * c2 * cb - c2 ** 2 * cb)
    A0 = (a2 ** 2 - 4 * a2 * b2 * cg ** 2 + 2 * a2 * b2 - 2 * a2 * c2
          + b2 ** 2 - 2 * b2 * c2 + c2 ** 2)

    coeffs = torch.stack([A4, A3, A2, A1, A0], dim=-1)
    v, v_ok = real_roots(coeffs)  # [..., 4]

    # Back-substitute: u linear in v (from e1 + e2).
    one = torch.ones_like(v)
    f2v = one + v * v - 2.0 * v * cb[..., None]
    num_u = (b2[..., None] * (one - v * v)
             + (a2 - c2)[..., None] * f2v)
    den_u = 2.0 * b2[..., None] * (cg[..., None] - v * ca[..., None])
    u = num_u / torch.where(torch.abs(den_u) > 1e-12, den_u,
                            torch.full_like(den_u, 1e-12))

    s1 = torch.sqrt(torch.clamp(b2[..., None] / torch.clamp(f2v, min=1e-12),
                                min=0.0))
    s2 = u * s1
    s3 = v * s1
    valid = v_ok & (s1 > 0) & (s2 > 0) & (s3 > 0) & (f2v > 1e-12)

    # Camera-frame points, then 3-point rigid alignment world -> camera.
    pc = torch.stack([
        s1[..., None] * fa[..., None, :],
        s2[..., None] * fb[..., None, :],
        s3[..., None] * fc[..., None, :],
    ], dim=-2)  # [..., 4 (solutions), 3 (points), 3]
    src = points3d[..., None, :, :].expand(pc.shape)
    qvec, _R, t = rigid_from_points(src, pc)
    return qvec, t, valid


def _pdists(p, eps):
    d = p[..., :, None, :] - p[..., None, :, :]
    return torch.sqrt(torch.clamp(torch.sum(d * d, -1), min=eps))


def epnp_solve(points3d, points2d, eps=1e-12):
    """EPnP (N=1 kernel case): pose from >= 4 correspondences.

    points3d: [..., M, 3]; points2d: [..., M, 2] normalized coords.
    Returns (qvec [..., 4], tvec [..., 3], valid [...]).
    The LO-RANSAC non-minimal refitter (ref: absolute_pose.h:97).
    """
    M = points3d.shape[-2]
    # Control points: centroid + principal axes.
    centroid = torch.mean(points3d, dim=-2, keepdim=True)
    centered = points3d - centroid
    cov = torch.einsum("...mi,...mj->...ij", centered, centered) / M
    w, V = _linalg.eigh(cov)
    scale = torch.sqrt(torch.clamp(w, min=eps))
    ctrl = torch.cat([
        centroid,
        centroid + scale[..., 2, None, None] * V[..., :, 2][..., None, :],
        centroid + scale[..., 1, None, None] * V[..., :, 1][..., None, :],
        centroid + scale[..., 0, None, None] * V[..., :, 0][..., None, :],
    ], dim=-2)  # [..., 4, 3]

    # Barycentric coordinates of each point wrt control points.
    Cmat = torch.cat([ctrl.mT, torch.ones_like(ctrl[..., :1]).mT],
                     dim=-2)  # [..., 4, 4]
    Ph = torch.cat([points3d, torch.ones_like(points3d[..., :1])], dim=-1)
    eye = torch.eye(4, dtype=Cmat.dtype, device=Cmat.device).expand(
        Cmat.shape)
    Cinv = _linalg.solve(_linalg.finite(Cmat), eye)
    alphas = torch.einsum("...ij,...mj->...mi", Cinv, Ph)  # [..., M, 4]

    # M matrix [..., 2M, 12]: rows (a (x) | 0 (y) | -u a (z)) and
    # (0 | a | -v a); a consistent layout is all the null space needs.
    u = points2d[..., 0]
    v = points2d[..., 1]
    zeros = torch.zeros_like(alphas)
    row_u = torch.cat([alphas, zeros, -u[..., None] * alphas], dim=-1)
    row_v = torch.cat([zeros, alphas, -v[..., None] * alphas], dim=-1)
    Mm = torch.cat([row_u, row_v], dim=-2)
    MtM = torch.einsum("...mi,...mj->...ij", Mm, Mm)
    null = _linalg.eigh_vectors(MtM)[..., :, 0]  # [..., 12]
    cc = torch.stack([null[..., 0:4], null[..., 4:8], null[..., 8:12]],
                     dim=-1)  # [..., 4, 3]

    # Fix scale: camera control-point distances match the world's.
    dw = _pdists(ctrl, eps)
    dc = _pdists(cc, eps)
    beta = torch.sum(dw * dc, dim=(-2, -1)) / torch.clamp(
        torch.sum(dc * dc, dim=(-2, -1)), min=eps)
    cc = cc * beta[..., None, None]
    # Fix sign: points must be in front of the camera.
    pts_cam = torch.einsum("...mi,...ij->...mj", alphas, cc)
    neg = torch.sum(pts_cam[..., 2] < 0, dim=-1) > (M // 2)
    cc = torch.where(neg[..., None, None], -cc, cc)
    pts_cam = torch.einsum("...mi,...ij->...mj", alphas, cc)

    qvec, _R, t = rigid_from_points(points3d, pts_cam)
    valid = torch.all(torch.isfinite(t), dim=-1)
    return qvec, t, valid
