"""Camera rigs: multi-camera platforms with fixed relative poses.

Port of ``sba_tpu/models/camera_rig.py`` (ref: src/base/camera_rig.{h,cc}
`CameraRig`: per-camera poses relative to a reference camera, snapshot
grouping, `ComputeRigFromReconstruction`; and the rig-constrained BA of
src/optim/bundle_adjustment.h:270 `RigBundleAdjuster`: one free pose
per snapshot, image poses = cam_from_rig o rig pose).

`rig_bundle_adjust` runs sba_tpu's damped Newton loop on the snapshot
poses on the problem's device: the exact Hessian of the reprojection
cost (points and intrinsics held), damped by lam * clip(diag(H), 1e-8),
accepted when the cost falls. Each residual depends on one image's pose
and so on one snapshot, so every off-diagonal 6 x 6 block of that
Hessian is exactly zero. sba_tpu forms the dense [6S, 6S] Hessian with
``jax.hessian`` (6S forward passes over the gradient) and solves it
densely; the port forms only the S diagonal blocks, from 6 forward-mode
passes over the gradient (one per tangent, each snapshot's tangent set
at once), and solves S 6 x 6 systems: the same step up to rounding.

`refine_relative_poses` is accepted and not read, as in sba_tpu (the
rig's relative poses stay those of `compute_rig_from_reconstruction`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sba_tpu_torch.geometry.quaternions import (np_quat_to_rotmat,
                                                pose_inverse, pose_product,
                                                quat_normalize, quat_retract,
                                                quat_slerp)


@dataclass
class CameraRig:
    """Host container (ref: camera_rig.h:44)."""

    ref_camera_id: int
    # camera_id -> (qvec, tvec): transform REF-cam frame -> this cam frame.
    cams_from_rig: Dict[int, Tuple[np.ndarray, np.ndarray]] = \
        field(default_factory=dict)
    # Snapshots: lists of image ids captured at the same time.
    snapshots: List[List[int]] = field(default_factory=list)

    def add_camera(self, camera_id: int, qvec=None, tvec=None):
        q = np.array([1.0, 0, 0, 0]) if qvec is None else np.asarray(qvec)
        t = np.zeros(3) if tvec is None else np.asarray(tvec)
        self.cams_from_rig[camera_id] = (q, t)

    def add_snapshot(self, image_ids: Sequence[int]):
        self.snapshots.append(list(image_ids))

    def num_cameras(self) -> int:
        return len(self.cams_from_rig)

    def compute_rig_from_reconstruction(self, reconstruction) -> None:
        """Each camera's pose relative to the reference camera, averaged
        over the snapshots (a slerp chain and the mean translation; ref:
        camera_rig.cc ComputeRigFromReconstruction). Host float64."""
        def T(a):
            return torch.as_tensor(np.asarray(a, np.float64))

        rel_q: Dict[int, List[torch.Tensor]] = {c: [] for c in
                                                 self.cams_from_rig}
        rel_t: Dict[int, List[torch.Tensor]] = {c: [] for c in
                                                 self.cams_from_rig}
        for snap in self.snapshots:
            ref_img = None
            for iid in snap:
                img = reconstruction.images.get(iid)
                if img is not None and img.camera_id == self.ref_camera_id \
                        and reconstruction.is_registered(iid):
                    ref_img = img
                    break
            if ref_img is None:
                continue
            q_ref_inv, t_ref_inv = pose_inverse(T(ref_img.qvec),
                                                T(ref_img.tvec))
            for iid in snap:
                img = reconstruction.images.get(iid)
                if img is None or not reconstruction.is_registered(iid):
                    continue
                q, t = pose_product(T(img.qvec), T(img.tvec), q_ref_inv,
                                    t_ref_inv)
                rel_q[img.camera_id].append(q)
                rel_t[img.camera_id].append(t)
        for cid in self.cams_from_rig:
            if not rel_q[cid]:
                continue
            qs = rel_q[cid]
            q_avg = qs[0]
            for k, qk in enumerate(qs[1:], start=2):
                q_avg = quat_slerp(q_avg, qk, 1.0 / k)
            self.cams_from_rig[cid] = (
                quat_normalize(q_avg).numpy(),
                np.mean(np.stack([t.numpy() for t in rel_t[cid]]), axis=0))


def estimate_snapshot_relative_pose(rig: CameraRig, cameras, obs1, obs2,
                                    options=None, seed=0, device="cuda",
                                    generator=None, draw_fn=None):
    """Rig-to-rig relative pose between two snapshots by GR6P RANSAC
    (ref: src/estimators/generalized_relative_pose.h:55).

    obs1/obs2: per-correspondence (camera_id, xy pixels) in snapshot 1
    and 2; `cameras`: camera_id -> (fx, fy, cx, cy). Returns the
    GeneralizedRelativePoseReport (rig1 -> rig2 and the inliers); the
    scoring runs on `device`, the draws as in
    `estimate_generalized_relative_pose`."""
    from sba_tpu_torch.estimators.generalized_relative_pose import \
        estimate_generalized_relative_pose

    def unpack(obs):
        cam_R, cam_t, xy = [], [], []
        for camera_id, xy_px in obs:
            q, t = rig.cams_from_rig[camera_id]
            fx, fy, cx, cy = cameras[camera_id]
            cam_R.append(np_quat_to_rotmat(np.asarray(q)))
            cam_t.append(np.asarray(t))
            xy.append([(xy_px[0] - cx) / fx, (xy_px[1] - cy) / fy])
        return np.stack(cam_R), np.stack(cam_t), np.asarray(xy)

    R1, t1, xy1 = unpack(obs1)
    R2, t2, xy2 = unpack(obs2)
    return estimate_generalized_relative_pose(
        R1, t1, xy1, R2, t2, xy2, options=options, seed=seed,
        device=device, generator=generator, draw_fn=draw_fn)


def compose_rig_poses(snap_qvec, snap_tvec, cam_qvec, cam_tvec):
    """Batched composition: image pose = cam_from_rig o rig pose.
    snap_*: [S, 4/3] rig poses; cam_*: [S, 4/3] the images' relative
    poses (gathered). Returns the image poses [S, 4/3]."""
    return pose_product(cam_qvec, cam_tvec, snap_qvec, snap_tvec)


def rig_cost_fn(problem, opt, snap_q, snap_t, snap_ids, cam_q, cam_t
                ) -> Callable:
    """The rig BA's cost as a function of the snapshot tangents delta
    [S, 6]: 0.5 sum of masked squared pixel residuals (no loss) of the
    composed image poses, points and intrinsics held."""
    from sba_tpu_torch.optim.ba import _residuals_only

    def cost_of(delta):
        sq = quat_retract(snap_q, delta[:, :3])
        st = snap_t + delta[:, 3:]
        iq, it = compose_rig_poses(sq[snap_ids], st[snap_ids], cam_q, cam_t)
        r = _residuals_only(iq, it, problem.points, problem.cam_params,
                            problem, opt)
        return 0.5 * torch.sum(problem.obs_mask * torch.sum(r * r, -1))

    return cost_of


def newton_blocks(cost_of, delta):
    """The gradient [S, 6] and the diagonal 6 x 6 blocks [S, 6, 6] of the
    cost's exact Hessian at delta: block column k is the forward-mode
    derivative of the gradient along tangent k of every snapshot at once
    (exact because the off-diagonal blocks are zero)."""
    grad = torch.func.grad(cost_of)
    g = grad(delta)
    tangents = torch.eye(6, dtype=delta.dtype, device=delta.device)[
        :, None, :].expand((6,) + delta.shape)
    cols = torch.func.vmap(
        lambda v: torch.func.jvp(grad, (delta,), (v,))[1])(tangents)
    return g, cols.permute(1, 2, 0)                     # H[s, :, k]


def damped_step(g, H, lam):
    """sba_tpu's step -(H + lam diag(clip(diag H, 1e-8)))^-1 g, solved
    block by block."""
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-8)
    return torch.linalg.solve(H + lam * torch.diag_embed(d), -g)


def rig_bundle_adjust(problem, rig_image_snapshot, rig_image_cam_q,
                      rig_image_cam_t, options=None,
                      refine_relative_poses: bool = False):
    """Rig-constrained BA (ref: bundle_adjustment.h:270 RigBundleAdjuster).

    problem: a `BAProblem` whose N images are grouped into snapshots by
    rig_image_snapshot [N] (snapshot rows), with the images' rig-relative
    poses rig_image_cam_q/t [N, 4/3]. The unknowns are one pose per
    snapshot, each initialised from its first image; the loop runs
    `options.max_iterations` damped Newton iterations on the problem's
    device without a host sync. Returns sba_tpu's dict (snapshot and
    image poses, final_cost) with the port's `initial_cost`,
    `num_iterations` and `num_accepted` (a device tensor)."""
    from sba_tpu_torch.optim.ba import BAOptions

    opt = options or BAOptions()
    dtype, device = problem.tvecs.dtype, problem.tvecs.device
    snap_ids = np.asarray(rig_image_snapshot, np.int64)
    S = int(snap_ids.max()) + 1

    # Initial snapshot poses from the first image of each snapshot:
    # x_img = cam(rig(x)) => rig = cam_from_rig^-1 o image (float64).
    _, rows = np.unique(snap_ids, return_index=True)

    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return torch.as_tensor(np.asarray(a, np.float64))

    cq_all, ct_all = host(rig_image_cam_q), host(rig_image_cam_t)
    qc_inv, tc_inv = pose_inverse(cq_all[rows], ct_all[rows])
    q0, t0 = pose_product(qc_inv, tc_inv, host(problem.qvecs)[rows],
                          host(problem.tvecs)[rows])
    snap_q = quat_normalize(q0).to(dtype=dtype, device=device)
    snap_t = t0.to(dtype=dtype, device=device)
    cam_q = cq_all.to(dtype=dtype, device=device)
    cam_t = ct_all.to(dtype=dtype, device=device)
    sid = torch.as_tensor(snap_ids, device=device)

    cost_of = rig_cost_fn(problem, opt, snap_q, snap_t, sid, cam_q, cam_t)
    delta = torch.zeros((S, 6), dtype=dtype, device=device)
    cost = cost_of(delta)
    cost0 = cost
    lam = torch.full_like(cost, 1e-6)
    accepted = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(opt.max_iterations):
        g, H = newton_blocks(cost_of, delta)
        new = delta + damped_step(g, H, lam)
        c_new = cost_of(new)
        improved = c_new < cost
        delta = torch.where(improved, new, delta)
        cost = torch.where(improved, c_new, cost)
        lam = torch.where(improved, lam * 0.3, lam * 10.0)
        accepted = accepted + improved.to(accepted.dtype)

    sq = quat_retract(snap_q, delta[:, :3])
    st = snap_t + delta[:, 3:]
    iq, it = compose_rig_poses(sq[sid], st[sid], cam_q, cam_t)
    return dict(snapshot_qvecs=sq, snapshot_tvecs=st, image_qvecs=iq,
                image_tvecs=it, final_cost=cost, initial_cost=cost0,
                num_iterations=opt.max_iterations, num_accepted=accepted)
