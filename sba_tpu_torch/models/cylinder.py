"""Cylinder primitives (tree trunks) for geometric-semantic BA.

Port of ``sba_tpu/models/cylinder.py``, the reference's ``Cylinder``
(tangent edge points, projected quadrilateral, semantic IoU) and
``CylinderBy2Points``:

- default parametrization: ``qvec [.,4], tvec [.,3], radius [.],
  height [.]`` (cylinder frame: base circle centre at tvec, axis = +z of
  the frame);
- 2-point parametrization: ``tvec1 [.,3], tvec2 [.,3], radius [.]``.

The host half (`Cylinder`, the text format, the two-point conversions)
is numpy. The batched half is plain functions on torch tensors that
broadcast over leading dimensions: the silhouette is the convex
quadrilateral between the two tangent lines, rasterized softly
(a sigmoid of each edge's signed pixel distance, so the IoU is
differentiable) or hard (the reference's 0/1 mask, for parity metrics).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from sba_tpu_torch.geometry.quaternions import (
    np_angle_axis_to_quat,
    np_quat_rotate,
    pose_inverse,
    pose_transform,
)


# ---------------------------------------------------------------------------
# Host container + text IO (ref: src/util/cylinder.h:287-330).
# ---------------------------------------------------------------------------

class Cylinder:
    """Host-side cylinder record. qvec w-first; radius and height clamped
    to 1e-4 as the reference's Check() does (ref: cylinder.h:246-280)."""

    MIN_SIZE = 1e-4

    def __init__(self, qvec=(1.0, 0.0, 0.0, 0.0), tvec=(0.0, 0.0, 0.0),
                 radius=1.0, height=1.0):
        self.qvec = np.asarray(qvec, dtype=np.float64)
        self.tvec = np.asarray(tvec, dtype=np.float64)
        self.radius = max(float(radius), self.MIN_SIZE)
        self.height = max(float(height), self.MIN_SIZE)

    def upper_tvec(self) -> np.ndarray:
        """Centre of the upper circle = tvec + R(q) @ (0, 0, h)."""
        return self.tvec + np_quat_rotate(
            self.qvec, np.array([0.0, 0.0, self.height]))

    def __repr__(self):
        return (f"Cylinder(q={self.qvec}, t={self.tvec}, r={self.radius}, "
                f"h={self.height})")


def cylinder_to_string(c: Cylinder) -> str:
    """Serialize: `q w x y z t x y z r R h H` (ref: cylinder.h:287-297)."""
    q = " ".join(repr(float(v)) for v in c.qvec)
    t = " ".join(repr(float(v)) for v in c.tvec)
    return f"q {q} t {t} r {repr(c.radius)} h {repr(c.height)}"


def cylinder_from_string(s: str) -> Cylinder:
    tok = s.split()
    if tok[0] != "q" or tok[5] != "t" or tok[9] != "r" or tok[11] != "h":
        raise ValueError(f"bad cylinder string: {s!r}")
    return Cylinder(qvec=[float(x) for x in tok[1:5]],
                    tvec=[float(x) for x in tok[6:9]],
                    radius=float(tok[10]), height=float(tok[12]))


def read_cylinders_text(path) -> List[Cylinder]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(cylinder_from_string(line))
    return out


def write_cylinders_text(cylinders, path) -> None:
    with open(path, "w") as f:
        for c in cylinders:
            f.write(cylinder_to_string(c) + "\n")


def cylinder_from_two_points(tvec1, tvec2, radius) -> Cylinder:
    """CylinderBy2Points -> Cylinder (ref: cylinder_by_2_points.h:84-108):
    the axis turns from +z to (t2 - t1) about their cross product."""
    t1 = np.asarray(tvec1, dtype=np.float64)
    t2 = np.asarray(tvec2, dtype=np.float64)
    d = t2 - t1
    h = float(np.linalg.norm(d))
    d = d / max(h, 1e-12)
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(z, d)
    n = np.linalg.norm(axis)
    axis = np.array([1.0, 0.0, 0.0]) if n < 1e-10 else axis / n
    angle = float(np.arccos(np.clip(np.dot(z, d), -1.0, 1.0)))
    q = np_angle_axis_to_quat(angle * axis)
    return Cylinder(qvec=q, tvec=t1, radius=radius, height=h)


def two_points_from_cylinder(c: Cylinder):
    return c.tvec.copy(), c.upper_tvec(), c.radius


# ---------------------------------------------------------------------------
# Batched tensor math.
# ---------------------------------------------------------------------------

def stack_cylinders(cylinders: List[Cylinder], dtype=torch.float64,
                    device="cuda"):
    """-> {qvec [K,4], tvec [K,3], radius [K], height [K]} on `device`."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return {"qvec": t(np.stack([c.qvec for c in cylinders])),
            "tvec": t(np.stack([c.tvec for c in cylinders])),
            "radius": t([c.radius for c in cylinders]),
            "height": t([c.height for c in cylinders])}


def cylinder_edge_points(cyl_qvec, cyl_tvec, radius, height, cam_qvec,
                         cam_tvec):
    """Tangent ('edge') points of the cylinder's silhouette seen from a
    camera (ref: src/util/cylinder.h:352-425 GetEdgePoints): the camera
    centre in the cylinder frame, its z dropped, the radial direction
    turned by +/- beta = acos(r / dist) about the axis, lifted by the
    height, and taken back to the world. Returns p1, p2, p3, p4
    ``[..., 3]`` (p1, p2 on the base circle, p3 above p2, p4 above p1)
    and ``valid`` (the camera lies outside the infinite cylinder); the
    reference throws where valid is false."""
    _, cam_center = pose_inverse(cam_qvec, cam_tvec)
    cyl_q_inv, cyl_t_inv = pose_inverse(cyl_qvec, cyl_tvec)
    c_in_cyl = pose_transform(cyl_q_inv, cyl_t_inv, cam_center)
    cxy = c_in_cyl[..., :2]
    dist = torch.linalg.norm(cxy, dim=-1)
    valid = dist > radius

    safe_dist = torch.clamp(dist, min=1e-12)
    dir_xy = cxy / safe_dist[..., None] * radius[..., None]
    beta = torch.arccos(torch.clamp(radius / safe_dist, -1.0, 1.0))
    cos_b = torch.cos(beta)
    sin_b = torch.sin(beta)

    def rot_z(v, c, s):
        x, y = v[..., 0], v[..., 1]
        return torch.stack([c * x - s * y, s * x + c * y], dim=-1)

    p1_xy = rot_z(dir_xy, cos_b, sin_b)    # +beta
    p2_xy = rot_z(dir_xy, cos_b, -sin_b)   # -beta
    zeros = torch.zeros_like(p1_xy[..., :1])
    h = height[..., None]
    p1 = torch.cat([p1_xy, zeros], dim=-1)
    p2 = torch.cat([p2_xy, zeros], dim=-1)
    p3 = torch.cat([p2_xy, zeros + h], dim=-1)
    p4 = torch.cat([p1_xy, zeros + h], dim=-1)

    def to_world(p):
        return pose_transform(cyl_qvec, cyl_tvec, p)

    return to_world(p1), to_world(p2), to_world(p3), to_world(p4), valid


def project_quadrilateral(cyl_qvec, cyl_tvec, radius, height, cam_qvec,
                          cam_tvec, cam_params):
    """Project the 4 edge points with a SIMPLE_PINHOLE camera and orient
    them counter-clockwise in image coordinates
    (ref: src/util/cylinder.h:429-474 ProjectToQuadrilateral).

    Returns (p [..., 4, 2], valid [...]); valid also requires all four
    points in front of the camera."""
    p1, p2, p3, p4, valid = cylinder_edge_points(
        cyl_qvec, cyl_tvec, radius, height, cam_qvec, cam_tvec)
    pts = torch.stack([p1, p2, p3, p4], dim=-2)  # [..., 4, 3]
    p_cam = pose_transform(cam_qvec[..., None, :], cam_tvec[..., None, :],
                           pts)
    z = p_cam[..., 2]
    valid = valid & torch.all(z > 0, dim=-1)
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    uv = p_cam[..., :2] / safe_z[..., None]
    f = cam_params[..., None, 0:1]
    c = cam_params[..., None, 1:3]
    xy = f * uv + c  # [..., 4, 2]

    # Orientation: if (p2 - p1) x (p3 - p1) < 0, swap p2 and p4.
    v0 = xy[..., 1, :] - xy[..., 0, :]
    v1 = xy[..., 2, :] - xy[..., 0, :]
    cross = v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0]
    swap = (cross < 0)[..., None]
    p2n = torch.where(swap, xy[..., 3, :], xy[..., 1, :])
    p4n = torch.where(swap, xy[..., 1, :], xy[..., 3, :])
    xy = torch.stack([xy[..., 0, :], p2n, xy[..., 2, :], p4n], dim=-2)
    return xy, valid


def edge_cross(quad_xy, e, px, py):
    """Edge e's cross product (px - ax)(by - ay) - (py - ay)(bx - ax) per
    pixel, ``[..., H, W]``, with (a, b) = (quad[e], quad[e+1]); px [W],
    py [H]. Non-positive inside the CCW quad. Also returns the edge's
    (ex, ey) = b - a, ``[...]``."""
    a = quad_xy[..., e, :]
    b = quad_xy[..., (e + 1) % 4, :]
    ax, ay = a[..., 0, None, None], a[..., 1, None, None]
    ex, ey = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    cross = ((px[None, :] - ax) * ey[..., None, None]
             - (py[:, None] - ay) * ex[..., None, None])
    return cross, ex, ey


def quadrilateral_mask(quad_xy, height: int, width: int, soft_tau=1.0,
                       hard=False):
    """Rasterize a convex CCW quadrilateral into an [H, W] mask
    (ref: src/util/cylinder.h:29-121 drawQuadrilateral: a pixel is inside
    iff it lies on the non-positive side of every directed edge).
    ``soft_tau`` is the sigmoid's width in pixels of signed distance;
    ``hard=True`` gives the reference's 0/1 mask.

    quad_xy: [..., 4, 2]; returns [..., H, W] in [0, 1]."""
    px = torch.arange(width, dtype=quad_xy.dtype, device=quad_xy.device)
    py = torch.arange(height, dtype=quad_xy.dtype, device=quad_xy.device)
    mask = None
    for e in range(4):
        cross, ex, ey = edge_cross(quad_xy, e, px, py)
        if hard:
            inside = (cross <= 0).to(quad_xy.dtype)
        else:
            el = torch.sqrt(ex * ex + ey * ey)
            d = cross / torch.clamp(el, min=1e-12)[..., None, None]
            inside = torch.sigmoid(-d / soft_tau)
        mask = inside if mask is None else mask * inside
    return mask


def semantic_iou(mask, semantic_bool, eps=1e-9):
    """IoU tp / (tp + fp + fn) of a (soft or hard) mask against a boolean
    semantic map over the whole image, batched over leading dimensions
    (ref: src/util/cylinder.h:497-540 ComputeSemanticIoU, which counts
    inside the bounding box only; the totals are the same)."""
    sem = semantic_bool.to(mask.dtype)
    tp = torch.sum(mask * sem, dim=(-2, -1))
    fp = torch.sum(mask * (1.0 - sem), dim=(-2, -1))
    fn = torch.sum((1.0 - mask) * sem, dim=(-2, -1))
    return tp / torch.clamp(tp + fp + fn, min=eps)
