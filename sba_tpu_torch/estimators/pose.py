"""High-level robust pose estimation (the mapper's workhorses).

Port of ``sba_tpu/estimators/pose.py`` (ref: src/estimators/pose.{h,cc}):

- `estimate_absolute_pose` (ref :79): P3P LO-RANSAC with an EPnP refit
  on the inliers, through the port's `optim/ransac.ransac`.
- `refine_absolute_pose`: pose-only LM against fixed points, a one-image
  `BAProblem` through the port's `optim/ba._bundle_adjust_impl`.
- `estimate_relative_pose`: 5-point LO-RANSAC + cheirality pose recovery.

The port's RANSAC carries one model tensor per hypothesis, so a pose is
packed as (qvec, tvec) in 7 numbers; the reports split it again. Draws
come from a ``torch.Generator`` on the data's device; `samples=` hands
in fixed draws (a test passes sba_tpu's).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from sba_tpu_torch.estimators import _linalg
from sba_tpu_torch.estimators.absolute_pose import epnp_solve, p3p_solve
from sba_tpu_torch.estimators.essential_matrix import (
    essential_5pt, pose_from_essential, sampson_error_e)
from sba_tpu_torch.estimators.fundamental_matrix import _epipolar_rows
from sba_tpu_torch.geometry.quaternions import quat_rotate
from sba_tpu_torch.optim.ransac import RANSACOptions, ransac


@dataclass(frozen=True)
class AbsolutePoseOptions:
    ransac: RANSACOptions = field(
        default_factory=lambda: RANSACOptions(max_error=0.01))  # normalized
    estimate_focal_length: bool = False


class AbsolutePoseReport(NamedTuple):
    """`RANSACReport` with the packed model split: qvec [4], tvec [3]."""

    qvec: torch.Tensor
    tvec: torch.Tensor
    num_inliers: torch.Tensor
    inlier_mask: torch.Tensor
    support_trace: torch.Tensor


def _reproj_sq_error(models, points3d, points2d):
    """models [B, K, 7] (qvec, tvec); points [B, 1, N, .] -> [B, K, N]."""
    q = models[..., None, :4]
    t = models[..., None, 4:]
    p_cam = quat_rotate(q, points3d) + t
    z = p_cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    uv = p_cam[..., :2] / safe_z[..., None]
    err = torch.sum((uv - points2d) ** 2, dim=-1)
    return torch.where(z > 0, err, torch.full_like(err, 1e12))


def _p3p_ransac_solve(p3d, p2d):
    q, t, valid = p3p_solve(p3d, p2d)      # [B, T, 4, .]
    return torch.cat([q, t], dim=-1), valid


def _epnp_ransac_refit(weights, p3d, p2d):
    """EPnP on the inliers with static shapes: outlier rows are replaced
    by a copy of the strongest inlier correspondence (a duplicated TRUE
    correspondence only reweights the LS system)."""
    anchor = torch.argmax(weights, dim=-1)
    rows = torch.arange(weights.shape[0], device=weights.device)
    keep = (weights > 0.5)[..., None]
    p3 = torch.where(keep, p3d, p3d[rows, anchor][:, None, :])
    p2 = torch.where(keep, p2d, p2d[rows, anchor][:, None, :])
    q, t, _ = epnp_solve(p3, p2)
    return torch.cat([q, t], dim=-1)


def estimate_absolute_pose(points3d, points2d,
                           options: Optional[AbsolutePoseOptions] = None,
                           mask=None, generator=None, samples=None
                           ) -> AbsolutePoseReport:
    """P3P LO-RANSAC absolute pose from 2D-3D correspondences.

    points2d: NORMALIZED image coordinates [N, 2]; points3d: [N, 3];
    mask: [N] validity (padding rows 0). `samples` [T, 3] replaces the
    draws from `generator`."""
    opt = options or AbsolutePoseOptions()
    rep = ransac((points3d, points2d), _p3p_ransac_solve, _reproj_sq_error,
                 3, opt.ransac, mask=mask, refit_fn=_epnp_ransac_refit,
                 generator=generator, samples=samples)
    return AbsolutePoseReport(rep.model[:4], rep.model[4:], rep.num_inliers,
                              rep.inlier_mask, rep.support_trace)


def refine_absolute_pose(qvec, tvec, points3d, points2d, weights=None,
                         max_iterations: int = 30):
    """Pose-only LM refinement against fixed 3D points (ref: pose.cc
    RefineAbsolutePose): normalized coords, an identity pinhole, Cauchy
    loss at 0.01, the dense Schur step. Returns (qvec, tvec, summary)."""
    from sba_tpu_torch.optim.ba import (MAXP, BAOptions, BAProblem,
                                        _bundle_adjust_impl)

    n = points3d.shape[0]
    dtype, device = points3d.dtype, points3d.device
    if weights is None:
        weights = torch.ones(n, dtype=dtype, device=device)
    cam = torch.zeros((1, MAXP), dtype=dtype, device=device)
    cam[0, 0] = 1.0                                  # identity pinhole
    zeros_i = torch.zeros(n, dtype=torch.int32, device=device)
    problem = BAProblem(
        qvecs=qvec[None, :], tvecs=tvec[None, :], points=points3d,
        cam_params=cam, obs_image=zeros_i,
        obs_point=torch.arange(n, dtype=torch.int32, device=device),
        obs_cam=zeros_i, obs_xy=points2d, obs_mask=weights.to(dtype),
        free_rot=torch.ones(1, dtype=dtype, device=device),
        free_trans=torch.ones((1, 3), dtype=dtype, device=device),
        free_points=torch.zeros(n, dtype=dtype, device=device),
        free_cam=torch.zeros((1, MAXP), dtype=dtype, device=device),
        image_cam=torch.zeros(1, dtype=torch.int32, device=device))
    opt = BAOptions(model_id=0, max_iterations=max_iterations,
                    loss="cauchy", loss_scale=0.01, solver="dense_schur")
    out, summary = _bundle_adjust_impl(problem, opt)
    return out.qvecs[0], out.tvecs[0], summary


@dataclass(frozen=True)
class RelativePoseOptions:
    ransac: RANSACOptions = field(
        default_factory=lambda: RANSACOptions(max_error=0.004))


def _weighted_essential(weights, xy1, xy2):
    """Weighted 8-point-style refit (rows scaled by sqrt(w)); batched
    over a leading axis."""
    A = _epipolar_rows(xy1, xy2) * torch.sqrt(
        torch.clamp(weights, min=0.0))[..., None]
    Vt = _linalg.svd(A, full_matrices=True).Vh
    E = Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 3))
    U, S, Vt2 = _linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) / 2.0
    S2 = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    E = (U * S2[..., None, :]) @ Vt2
    n = torch.linalg.norm(E.reshape(E.shape[:-2] + (9,)), dim=-1)
    return E / torch.clamp(n, min=1e-12)[..., None, None]


def estimate_relative_pose(xy1, xy2,
                           options: Optional[RelativePoseOptions] = None,
                           mask=None, generator=None, samples=None):
    """5-point LO-RANSAC relative pose (normalized coords).

    Returns (R, t, E, report) with cheirality-consistent (R, t)
    (ref: estimators/pose.cc EstimateRelativePose)."""
    opt = options or RelativePoseOptions()
    report = ransac((xy1, xy2), essential_5pt, sampson_error_e, 5,
                    opt.ransac, mask=mask, refit_fn=_weighted_essential,
                    generator=generator, samples=samples)
    E = report.model
    R, t, _n_front = pose_from_essential(
        E, xy1, xy2, mask=report.inlier_mask.to(xy1.dtype))
    return R, t, E, report
