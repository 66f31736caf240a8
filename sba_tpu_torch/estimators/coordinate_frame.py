"""Coordinate frame estimation + model orientation alignment.

Port of ``sba_tpu/estimators/coordinate_frame.py`` (ref:
src/estimators/coordinate_frame.{h,cc}): gravity from image orientation
consensus, Manhattan-world frame from per-image vanishing points (LSD
lines -> 2-line RANSAC), principal-plane and ENU-plane alignment. Each
image's undistortion, line field and vanishing-point RANSAC (all
hypotheses scored at once, through the port's ``optim/ransac.py``) run
on the device; the rest is host numpy in float64. The RANSAC draws come
from a CPU ``torch.Generator`` seeded by the segment count (sba_tpu
seeds its key the same way), or from `draw_fn`, which is how a test
hands in sba_tpu's draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

import torch

from sba_tpu_torch.features.lines import (
    HORIZONTAL,
    VERTICAL,
    classify_line_segment_orientations,
    detect_line_segments,
)


@dataclass(frozen=True)
class ManhattanWorldFrameOptions:
    """Mirrors ref: coordinate_frame.h:43-55
    ManhattanWorldFrameEstimationOptions."""

    max_image_size: int = 1024
    min_line_length: float = 3.0
    line_orientation_tolerance: float = 0.2
    max_line_vp_distance: float = 0.5
    max_axis_distance: float = 0.05


def find_best_consensus_axis(axes, max_distance: float = 0.05) -> np.ndarray:
    """Exhaustive consensus axis (ref: coordinate_frame.cc:91-139
    FindBestConsensusAxis) — vectorized: all pairwise cosine distances at
    once, best reference row by (inliers, distance sum)."""
    axes = np.asarray(axes, np.float64)
    if len(axes) == 0:
        return np.zeros(3)
    d = 1.0 - axes @ axes.T                       # [n, n]
    np.fill_diagonal(d, 0.0)
    inl = d <= max_distance
    np.fill_diagonal(inl, True)                   # self always counted
    counts = inl.sum(axis=1)
    sums = np.where(inl, d, 0.0).sum(axis=1)
    best = np.lexsort((sums, -counts))[0]
    sel = axes[inl[best]]
    return sel.sum(axis=0) / len(sel)


def estimate_gravity_vector_from_image_orientation(
        reconstruction, max_axis_distance: float = 0.05) -> np.ndarray:
    """Consensus downward axis from upright image assumption
    (ref: coordinate_frame.cc:144-153): row 1 of each registered image's
    rotation matrix."""
    from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat

    axes = []
    for iid, img in reconstruction.images.items():
        if not reconstruction.is_registered(iid):
            continue
        R = np_quat_to_rotmat(img.qvec)
        axes.append(R[1])
    if not axes:
        return np.zeros(3)
    return find_best_consensus_axis(np.stack(axes), max_axis_distance)


def _segments_to_lines(segments: np.ndarray) -> np.ndarray:
    """Homogeneous line through each segment's endpoints
    (start_h x end_h)."""
    s = np.concatenate([segments[:, 0], np.ones((len(segments), 1))], -1)
    e = np.concatenate([segments[:, 1], np.ones((len(segments), 1))], -1)
    return np.cross(s, e)


def _vp_solve(s2, l2):
    """models [B, T, 1, 3]: the cross product of the two sampled lines."""
    vp = torch.linalg.cross(l2[..., 0, :], l2[..., 1, :])
    return vp[..., None, :], torch.ones(vp.shape[:-1] + (1,), dtype=torch.bool,
                                        device=vp.device)


def _vp_residual(vp, s, l):
    """Squared distance of each segment's end to the line through the
    vanishing point and the segment's midpoint; inf for a vanishing
    point at infinity. vp [B, K, 3], s [B, 1, N, 2, 2] -> [B, K, N]."""
    ones = torch.ones(s.shape[:-2] + (1,), dtype=s.dtype, device=s.device)
    mid_h = torch.cat([0.5 * (s[..., 0, :] + s[..., 1, :]), ones], -1)
    conn = torch.linalg.cross(mid_h, vp[:, :, None, :].expand(
        -1, -1, mid_h.shape[2], -1))
    end_h = torch.cat([s[..., 1, :], ones], -1)
    dist = torch.sum(conn * end_h, -1) / (
        torch.linalg.norm(conn[..., :2], dim=-1) + 1e-300)
    r = dist * dist
    return torch.where(torch.abs(vp[..., 2:3]) > 0, r,
                       torch.full_like(r, math.inf))


def estimate_vanishing_point(segments, lines, max_error: float = 0.5,
                             device="cuda", draw_fn=None):
    """RANSAC vanishing point from line segments
    (ref: coordinate_frame.cc:45-89 VanishingPointEstimator): minimal
    sample = 2 lines, model = their cross product; residual = squared
    distance of the segment end to the line joining the VP and the
    segment midpoint; inlier-count scoring. Float64 on `device`.
    `draw_fn(num_points, num_trials, sample_size)` gives the samples
    [num_trials, sample_size]; else they are drawn from a CPU generator
    seeded by the segment count. Returns (vp [3], num_inliers) or (None,
    0)."""
    from sba_tpu_torch.optim.ransac import (RANSACOptions, draw_samples,
                                            num_required_trials, ransac)

    n = len(segments)
    if n < 2:
        return None, 0
    opt = RANSACOptions(max_error=max_error, min_inlier_ratio=0.25,
                        scoring="inlier_count")
    trials = num_required_trials(2, opt)
    if draw_fn is not None:
        samples = draw_fn(n, trials, 2)
    else:
        samples = draw_samples(n, trials, 2, generator=torch.Generator(
            device="cpu").manual_seed(n))
    segs = torch.as_tensor(np.asarray(segments, np.float64), device=device)
    lns = torch.as_tensor(np.asarray(lines, np.float64), device=device)
    report = ransac((segs, lns), _vp_solve, _vp_residual, sample_size=2,
                    options=opt, samples=samples)
    n_inl = int(report.num_inliers)
    if n_inl < 2:
        return None, 0
    return report.model.cpu().numpy(), n_inl


def estimate_manhattan_world_frame(options: ManhattanWorldFrameOptions,
                                   reconstruction, image_path: str,
                                   verbose: bool = True, device="cuda",
                                   draw_fn=None) -> np.ndarray:
    """Manhattan frame from per-image horizontal/vertical vanishing points
    (ref: coordinate_frame.cc:156-295 EstimateManhattanWorldFrame).
    Columns = rightward, downward, forward axes in world coordinates;
    a zero column means that axis could not be determined. Each image is
    undistorted, its line field computed and its vanishing points
    estimated on `device` (`draw_fn` as in `estimate_vanishing_point`)."""
    import os

    from PIL import Image as PILImage

    from sba_tpu_torch.geometry.camera_models import model_by_id
    from sba_tpu_torch.geometry.quaternions import (np_quat_conjugate,
                                                    np_quat_rotate)
    from sba_tpu_torch.geometry.undistortion import (
        UndistortCameraOptions, undistort_image)

    rightward_axes, downward_axes = [], []
    reg = [i for i in reconstruction.images
           if reconstruction.is_registered(i)]
    for n_done, iid in enumerate(reg):
        img = reconstruction.images[iid]
        cam = reconstruction.cameras[img.camera_id]
        if verbose:
            print(f"Processing image {img.name} "
                  f"({n_done + 1} / {len(reg)})")
        path = os.path.join(image_path, img.name)
        with PILImage.open(path) as im:
            gray = np.asarray(im.convert("L"), np.float32)
        und_opt = UndistortCameraOptions(
            max_image_size=options.max_image_size)
        und_img, und_cam = undistort_image(
            torch.as_tensor(gray, device=device), cam, und_opt)
        und_img = und_img.cpu().numpy()

        segments = detect_line_segments(und_img, options.min_line_length,
                                        device=device)
        orient = classify_line_segment_orientations(
            segments, options.line_orientation_tolerance)
        if verbose:
            print(f"  {len(segments)} lines "
                  f"({int((orient == HORIZONTAL).sum())} horizontal, "
                  f"{int((orient == VERTICAL).sum())} vertical)")

        spec = model_by_id(und_cam.model_id)
        fx = und_cam.params[spec.focal_idxs[0]]
        fy = und_cam.params[spec.focal_idxs[-1]]
        cx, cy = (und_cam.params[i] for i in spec.principal_idxs)
        Kinv = np.array([[1.0 / fx, 0, -cx / fx],
                         [0, 1.0 / fy, -cy / fy],
                         [0, 0, 1.0]])
        inv_q = np_quat_conjugate(img.qvec)

        for tag, flag, store in (("horizontal", HORIZONTAL, rightward_axes),
                                 ("vertical", VERTICAL, downward_axes)):
            sel = segments[orient == flag]
            if len(sel) < 2:
                continue
            vp, n_inl = estimate_vanishing_point(
                sel, _segments_to_lines(sel), options.max_line_vp_distance,
                device=device, draw_fn=draw_fn)
            if vp is None:
                continue
            cam_axis = Kinv @ vp
            cam_axis = cam_axis / (np.linalg.norm(cam_axis) + 1e-300)
            axis = np_quat_rotate(inv_q, cam_axis)
            axis = axis / (np.linalg.norm(axis) + 1e-300)
            if flag == HORIZONTAL:
                # Consistent hemisphere with the first found axis.
                if store and store[0] @ axis < 0:
                    axis = -axis
            else:
                # Downward in the image (upright assumption).
                if cam_axis[1] < 0:
                    axis = -axis
            store.append(axis)
            if verbose:
                print(f"  {tag}: {axis} ({n_inl} inliers)")

    frame = np.zeros((3, 3))
    if rightward_axes:
        frame[:, 0] = find_best_consensus_axis(
            np.stack(rightward_axes), options.max_axis_distance)
    if downward_axes:
        frame[:, 1] = find_best_consensus_axis(
            np.stack(downward_axes), options.max_axis_distance)
    if rightward_axes and downward_axes:
        frame[:, 2] = np.cross(frame[:, 0], frame[:, 1])
        # Nearest orthonormal frame via SVD (ref :276-283).
        u, _, vt = np.linalg.svd(frame)
        frame = u @ vt
    return frame


def rotation_from_unit_vectors(a, b) -> np.ndarray:
    """Rotation R with R a = b for unit vectors (Rodrigues;
    ref: base/pose.cc RotationFromUnitVectors)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    v = np.cross(a, b)
    c = float(a @ b)
    if c < -1.0 + 1e-12:
        # Opposite vectors: rotate pi around any orthogonal axis.
        axis = np.cross(a, [1.0, 0, 0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0, 1.0, 0])
        axis = axis / np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))


def transform_reconstruction(rec, s: float, R: np.ndarray,
                             t: np.ndarray) -> None:
    """Apply world' = s R world + t to all poses + points in place
    (ref: base/reconstruction.cc Reconstruction::Transform)."""
    from sba_tpu_torch.geometry.quaternions import (np_quat_to_rotmat,
                                                    np_rotmat_to_quat)

    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    for iid in rec.images:
        img = rec.images[iid]
        Rc = np_quat_to_rotmat(img.qvec)
        Rc_new = Rc @ R.T
        img.qvec = np_rotmat_to_quat(Rc_new)
        img.tvec = s * img.tvec - Rc_new @ t
    for pid in rec.points3D:
        p = rec.points3D[pid]
        p.xyz = s * (R @ p.xyz) + t


def align_to_principal_plane(rec) -> tuple:
    """PCA ground-plane alignment (ref: coordinate_frame.cc:298-327
    AlignToPrincipalPlane). Returns (s, R, t) of the applied transform."""
    from sba_tpu_torch.geometry.quaternions import (np_quat_conjugate,
                                                    np_quat_rotate)

    pts = np.stack([p.xyz for p in rec.points3D.values()])
    centroid = pts.mean(axis=0)
    u, _, _ = np.linalg.svd((pts - centroid).T, full_matrices=False)
    basis = u  # columns = principal components

    def make(b0, b1):
        Rm = np.stack([b0, b1, np.cross(b0, b1)], axis=0)
        return Rm, -Rm @ centroid

    R, t = make(basis[:, 0], basis[:, 1])
    # Flip if the first camera center lands below the ground plane.
    img = next(iter(rec.images.values()))
    center = -np_quat_rotate(np_quat_conjugate(img.qvec), img.tvec)
    if (R @ center + t)[2] < 0.0:
        R, t = make(basis[:, 0], -basis[:, 1])
    transform_reconstruction(rec, 1.0, R, t)
    return 1.0, R, t


def align_to_enu_plane(rec, unscaled: bool = False,
                       prior_scale: float = 1.0) -> tuple:
    """ENU tangent-plane alignment at the point centroid
    (ref: coordinate_frame.cc:329-356 AlignToENUPlane)."""
    from sba_tpu_torch.geometry.gps import xyz_to_ell

    pts = np.stack([p.xyz for p in rec.points3D.values()])
    centroid = pts.mean(axis=0)
    lat, lon, _ = xyz_to_ell(centroid[None, :])[0]
    sin_lat, cos_lat = np.sin(np.deg2rad(lat)), np.cos(np.deg2rad(lat))
    sin_lon, cos_lon = np.sin(np.deg2rad(lon)), np.cos(np.deg2rad(lon))
    R = np.array([
        [-sin_lon, cos_lon, 0],
        [-cos_lon * sin_lat, -sin_lon * sin_lat, cos_lat],
        [cos_lon * cos_lat, sin_lon * cos_lat, sin_lat]])
    s = 1.0 / prior_scale if unscaled else 1.0
    t = -(s * R) @ centroid
    transform_reconstruction(rec, s, R, t)
    return s, R, t
