"""Generalized (multi-camera rig) absolute pose.

Port of ``sba_tpu/estimators/generalized_pose.py`` (the reference's GP3P
capability, ref: src/estimators/generalized_absolute_pose.{h,cc}
`GP3PEstimator`): a hypothesis is a P3P solve on 3 correspondences of
ONE rig camera (samples mixing cameras are invalid), lifted to the rig
frame through that camera's extrinsic; every hypothesis is scored
against all correspondences of all rig cameras by the generalized
reprojection error, in one batched RANSAC (`optim/ransac.ransac`) on
the data's device. The LO refit is a weighted EPnP in the dominant
camera followed by damped Gauss-Newton on the 6-DoF rig pose, whose
Jacobian comes from one forward-mode pass (``torch.func.jvp`` vmapped
over the 6 tangents), as sba_tpu's ``jax.jacfwd``.

The RANSAC model packs (qvec, tvec) in 7 numbers; the report splits it.
Draws come from a ``torch.Generator``; `samples=` hands in fixed draws
(a test passes sba_tpu's).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from sba_tpu_torch.estimators.absolute_pose import p3p_solve
from sba_tpu_torch.estimators.pose import (AbsolutePoseReport,
                                           _epnp_ransac_refit)
from sba_tpu_torch.geometry.quaternions import (pose_inverse, pose_product,
                                                quat_retract, quat_rotate)
from sba_tpu_torch.optim.ransac import RANSACOptions, ransac


@dataclass(frozen=True)
class GeneralizedAbsolutePoseOptions:
    ransac: RANSACOptions = field(
        default_factory=lambda: RANSACOptions(max_error=0.01))  # normalized
    refine_iterations: int = 15


def _project_rig(q, t, points3d, corr_cam, rig_qvecs, rig_tvecs):
    """Normalized projections and depths of world points through the rig
    pose (q, t) (broadcast against the points) and each point's camera."""
    p_rig = quat_rotate(q, points3d) + t
    p_cam = quat_rotate(rig_qvecs[corr_cam], p_rig) + rig_tvecs[corr_cam]
    z = p_cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    return p_cam[..., :2] / safe_z[..., None], z


def _rig_reproj_sq_error(models, points3d, points2d, corr_cam, rig_qvecs,
                         rig_tvecs):
    """models [B, K, 7]; data [B, 1, N, .] -> squared errors [B, K, N]
    (1e12 behind the camera)."""
    uv, z = _project_rig(models[..., None, :4], models[..., None, 4:],
                         points3d, corr_cam, rig_qvecs, rig_tvecs)
    err = torch.sum((uv - points2d) ** 2, dim=-1)
    return torch.where(z > 0, err, torch.full_like(err, 1e12))


def _refine_generalized_weighted(weights, points3d, points2d, corr_cam,
                                 rig_qvecs, rig_tvecs, iters=15,
                                 model=None):
    """Damped Gauss-Newton on the rig pose, batched over a leading axis
    (weights [B, N], data [B, N, .]); seeded by the weighted EPnP of the
    camera with the most weight, or by `model` ([B, 7]). Returns the
    packed poses [B, 7]."""
    dtype = points3d.dtype
    if model is None:
        cam_w = weights.new_zeros((weights.shape[0], rig_qvecs.shape[0]))
        cam_w.scatter_add_(1, corr_cam, weights)
        dom = torch.argmax(cam_w, dim=-1)
        in_dom = (corr_cam == dom[:, None]).to(dtype) * weights
        qt = _epnp_ransac_refit(in_dom, points3d, points2d)
        iq, it = pose_inverse(rig_qvecs[dom], rig_tvecs[dom])
        rq, rt = pose_product(iq, it, qt[:, :4], qt[:, 4:])
    else:
        rq, rt = model[:, :4], model[:, 4:]
    B = points3d.shape[0]
    zeros = points3d.new_zeros((B, 6))
    tangents = torch.eye(6, dtype=dtype, device=points3d.device)[
        :, None, :].expand(6, B, 6)
    eye = 1e-8 * torch.eye(6, dtype=dtype, device=points3d.device)
    for _ in range(iters):
        def residuals(delta):
            uv, _ = _project_rig(
                quat_retract(rq, delta[:, :3])[:, None],
                (rt + delta[:, 3:])[:, None], points3d, corr_cam,
                rig_qvecs, rig_tvecs)
            return ((uv - points2d) * weights[..., None]).reshape(B, -1)

        r = residuals(zeros)
        J = torch.func.vmap(lambda v: torch.func.jvp(
            residuals, (zeros,), (v,))[1])(tangents).permute(1, 2, 0)
        H = J.transpose(1, 2) @ J + eye
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        delta = -torch.linalg.solve(H, g)
        rq, rt = quat_retract(rq, delta[:, :3]), rt + delta[:, 3:]
    return torch.cat([rq, rt], dim=-1)


def estimate_generalized_absolute_pose(
        points3d, points2d, corr_cam, rig_qvecs, rig_tvecs,
        options: Optional[GeneralizedAbsolutePoseOptions] = None,
        mask=None, generator=None, samples=None) -> AbsolutePoseReport:
    """Rig pose (world -> rig) from 2D-3D correspondences across the rig
    cameras: points3d [N, 3] world, points2d [N, 2] NORMALIZED in the
    correspondence's camera, corr_cam [N] its rig-camera index,
    rig_qvecs/rig_tvecs [C, 4]/[C, 3] the fixed rig -> camera extrinsics
    (tensors on one device). `samples` [T, 3] replaces the draws from
    `generator`."""
    opt = options or GeneralizedAbsolutePoseOptions()
    corr_cam = corr_cam.long()

    def solve(p3d, p2d, cams):
        same = (cams[..., 0] == cams[..., 1]) & (cams[..., 0] == cams[..., 2])
        q_cam, t_cam, valid = p3p_solve(p3d, p2d)        # [B, T, 4, .]
        iq, it = pose_inverse(rig_qvecs[cams[..., 0]],
                              rig_tvecs[cams[..., 0]])
        rq, rt = pose_product(iq[..., None, :], it[..., None, :], q_cam,
                              t_cam)
        return torch.cat([rq, rt], dim=-1), valid & same[..., None]

    def residual(models, p3d, p2d, cams):
        return _rig_reproj_sq_error(models, p3d, p2d, cams, rig_qvecs,
                                    rig_tvecs)

    def refit(weights, p3d, p2d, cams):
        return _refine_generalized_weighted(
            weights, p3d, p2d, cams, rig_qvecs, rig_tvecs,
            iters=opt.refine_iterations)

    rep = ransac((points3d, points2d, corr_cam), solve, residual, 3,
                 opt.ransac, mask=mask, refit_fn=refit, generator=generator,
                 samples=samples)
    return AbsolutePoseReport(rep.model[:4], rep.model[4:], rep.num_inliers,
                              rep.inlier_mask, rep.support_trace)


def refine_generalized_absolute_pose(rq, rt, points3d, points2d, corr_cam,
                                     rig_qvecs, rig_tvecs, weights=None,
                                     iters: int = 20):
    """Gauss-Newton refinement of a rig pose against all rig
    correspondences (ref: the Ceres refinement after GP3P). Returns
    (qvec, tvec)."""
    if weights is None:
        weights = torch.ones(points3d.shape[0], dtype=points3d.dtype,
                             device=points3d.device)
    out = _refine_generalized_weighted(
        weights[None], points3d[None], points2d[None],
        corr_cam.long()[None], rig_qvecs, rig_tvecs, iters=iters,
        model=torch.cat([rq, rt])[None])
    return out[0, :4], out[0, 4:]
