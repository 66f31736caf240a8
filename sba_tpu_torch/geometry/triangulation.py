"""Triangulation: DLT two- and multi-view, midpoint, angle checks.

Port of ``sba_tpu/geometry/triangulation.py`` (ref: src/base/
triangulation.{h,cc}), batched over whole arrays of tracks.
"""

from __future__ import annotations

import math

import torch

from sba_tpu_torch.geometry.projection import pose_matrix
from sba_tpu_torch.geometry.quaternions import pose_inverse, quat_rotate


def _dehomogenize(h):
    w = h[..., 3:]
    return h[..., :3] / torch.where(torch.abs(w) > 1e-12, w,
                                    torch.full_like(w, 1e-12))


def triangulate_point(proj1, proj2, xy1, xy2):
    """Two-view DLT: proj* [..., 3, 4], xy* [..., 2] -> [..., 3]."""
    rows = torch.stack([
        xy1[..., 0, None] * proj1[..., 2, :] - proj1[..., 0, :],
        xy1[..., 1, None] * proj1[..., 2, :] - proj1[..., 1, :],
        xy2[..., 0, None] * proj2[..., 2, :] - proj2[..., 0, :],
        xy2[..., 1, None] * proj2[..., 2, :] - proj2[..., 1, :],
    ], dim=-2)
    vt = torch.linalg.svd(rows).Vh
    return _dehomogenize(vt[..., -1, :])


def triangulate_multiview(proj, xy, mask):
    """N-view DLT via the smallest eigenvector of A^T A; proj [..., M, 3,
    4], xy [..., M, 2], mask [..., M] (padded views give zero rows)."""
    r0 = xy[..., 0, None] * proj[..., 2, :] - proj[..., 0, :]
    r1 = xy[..., 1, None] * proj[..., 2, :] - proj[..., 1, :]
    rows = torch.stack([r0, r1], dim=-2).reshape(xy.shape[:-2] + (-1, 4))
    rows = rows * torch.repeat_interleave(mask, 2, dim=-1)[..., None] \
        .to(rows.dtype)
    ata = torch.einsum("...ma,...mb->...ab", rows, rows)
    v = torch.linalg.eigh(ata).eigenvectors
    return _dehomogenize(v[..., :, 0])


def triangulate_points_batch(qvec1, tvec1, qvec2, tvec2, xy1, xy2):
    """Two-view triangulation from poses and normalized image coords."""
    return triangulate_point(pose_matrix(qvec1, tvec1),
                             pose_matrix(qvec2, tvec2), xy1, xy2)


def triangulate_midpoint(qvec1, tvec1, qvec2, tvec2, xy1, xy2):
    """Midpoint of the closest points of two bearing rays (normalized
    coords xy*)."""
    q1i, c1 = pose_inverse(qvec1, tvec1)
    q2i, c2 = pose_inverse(qvec2, tvec2)
    d1 = quat_rotate(q1i, torch.cat([xy1, torch.ones_like(xy1[..., :1])],
                                    dim=-1))
    d2 = quat_rotate(q2i, torch.cat([xy2, torch.ones_like(xy2[..., :1])],
                                    dim=-1))
    d1 = d1 / torch.linalg.norm(d1, dim=-1, keepdim=True)
    d2 = d2 / torch.linalg.norm(d2, dim=-1, keepdim=True)
    b = c2 - c1
    d1d2 = torch.sum(d1 * d2, dim=-1)
    denom = 1.0 - d1d2 * d1d2
    safe = torch.where(torch.abs(denom) > 1e-12, denom,
                       torch.full_like(denom, 1e-12))
    bd1 = torch.sum(b * d1, dim=-1)
    bd2 = torch.sum(b * d2, dim=-1)
    s = (bd1 - d1d2 * bd2) / safe
    t = (d1d2 * bd1 - bd2) / safe
    return 0.5 * ((c1 + s[..., None] * d1) + (c2 + t[..., None] * d2))


def triangulation_angle(center1, center2, points3d):
    """Angle at the point between the two centers, min(a, pi - a)."""
    base2 = torch.sum((center1 - center2) ** 2, dim=-1)
    r1 = torch.sum((points3d - center1) ** 2, dim=-1)
    r2 = torch.sum((points3d - center2) ** 2, dim=-1)
    denom = 2.0 * torch.sqrt(torch.clamp(r1 * r2, min=1e-20))
    angle = torch.arccos(torch.clamp((r1 + r2 - base2) / denom, -1.0, 1.0))
    return torch.minimum(angle, math.pi - angle)
