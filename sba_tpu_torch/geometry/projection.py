"""Projection math: world -> image, reprojection errors, cheirality.

Port of ``sba_tpu/geometry/projection.py`` (ref: src/base/projection.
{h,cc}): batched tensor ops over pose arrays ``[..., 4]/[..., 3]`` and
point arrays ``[..., 3]``.
"""

from __future__ import annotations

import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.geometry.quaternions import pose_transform, \
    quat_to_rotmat


def pose_matrix(qvec, tvec):
    """[..., 3, 4] world->camera matrix [R | t]."""
    R = quat_to_rotmat(qvec)
    return torch.cat([R, tvec[..., :, None]], dim=-1)


def _safe_depth(z, eps):
    return torch.where(torch.abs(z) > eps, z, torch.full_like(z, eps))


def project_simple_pinhole(qvec, tvec, cam_params, points3d, eps=1e-12):
    """SIMPLE_PINHOLE projection: (xy [..., 2], depth [...]); the caller
    masks on ``depth > 0``."""
    p_cam = pose_transform(qvec, tvec, points3d)
    z = p_cam[..., 2]
    uv = p_cam[..., :2] / _safe_depth(z, eps)[..., None]
    return cam_params[..., 0:1] * uv + cam_params[..., 1:3], z


def project_points(qvec, tvec, points3d, model_id: int, cam_params,
                   eps=1e-12):
    """Project world points through a camera model: (xy [..., 2], depth)."""
    p_cam = pose_transform(qvec, tvec, points3d)
    z = p_cam[..., 2]
    uv = p_cam[..., :2] / _safe_depth(z, eps)[..., None]
    return camera_models.world_to_image(model_id, cam_params, uv), z


def reprojection_error(qvec, tvec, points3d, observed_xy, model_id: int,
                       cam_params):
    """Squared reprojection error per observation; +inf behind the camera."""
    xy, z = project_points(qvec, tvec, points3d, model_id, cam_params)
    err = torch.sum((xy - observed_xy) ** 2, dim=-1)
    return torch.where(z > 0, err, torch.full_like(err, float("inf")))


def calculate_depth(qvec, tvec, points3d):
    """Depth of world points in the camera frame."""
    return pose_transform(qvec, tvec, points3d)[..., 2]


def has_point_positive_depth(qvec, tvec, points3d):
    return calculate_depth(qvec, tvec, points3d) > 0
