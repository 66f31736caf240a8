"""Synthetic scenes for tests and benchmarks, built with numpy only.

Port of `make_ba_problem` and `make_synthetic_reconstruction` from
``sba_tpu/utils/synthetic.py``: the same arc-of-cameras geometry and the
same sequence of draws from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import numpy as np
import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.geometry.quaternions import np_quat_rotate
from sba_tpu_torch.io.colmap_models import Camera, Image
from sba_tpu_torch.models.reconstruction import Reconstruction
from sba_tpu_torch.optim.ba import MAXP, problem_from_numpy


def make_ba_problem_numpy(
    num_images: int = 6,
    num_points: int = 100,
    model_id: int = 0,
    pixel_noise: float = 0.0,
    pose_noise: float = 0.0,
    point_noise: float = 0.0,
    seed: int = 0,
    image_size=(640, 480),
    focal: float = 500.0,
    observations_per_point: int | None = None,
):
    """Synthetic BA problem with known ground truth, as numpy arrays.

    Cameras on an arc looking at a point cloud in front of them. Gauge:
    pose 0 constant, tvec x of image 1 constant. Returns (fields, truth):
    `fields` maps `BAProblem` field names to float64 / int32 arrays.
    """
    rng = np.random.default_rng(seed)
    w, h = image_size
    pts = rng.uniform([-3, -2, 6], [3, 2, 12], size=(num_points, 3))

    qvecs = np.zeros((num_images, 4))
    tvecs = np.zeros((num_images, 3))
    for i in range(num_images):
        aa = rng.normal(scale=0.03, size=3)
        angle = np.linalg.norm(aa)
        axis = aa / max(angle, 1e-12)
        qvecs[i] = np.concatenate([[np.cos(angle / 2)],
                                   np.sin(angle / 2) * axis])
        centers = np.array([-2.0 + 4.0 * i / max(num_images - 1, 1),
                            0.2 * rng.normal(), 0.1 * rng.normal()])
        tvecs[i] = -np_quat_rotate(qvecs[i], centers)

    spec = camera_models.model_by_id(model_id)
    params = np.array(spec.init_params(focal, w, h), np.float64)
    cam_params = np.zeros((1, MAXP))
    cam_params[0, : len(params)] = params

    obs_image, obs_point, obs_xy = [], [], []
    for i in range(num_images):
        p_cam = np_quat_rotate(qvecs[i], pts) + tvecs[i]
        uv = p_cam[:, :2] / p_cam[:, 2:3]
        xy = spec.world_to_image(torch.from_numpy(params),
                                 torch.from_numpy(uv)).numpy()
        vis = ((p_cam[:, 2] > 0.1) & (xy[:, 0] >= 0) & (xy[:, 0] < w)
               & (xy[:, 1] >= 0) & (xy[:, 1] < h))
        idx = np.nonzero(vis)[0]
        if observations_per_point is not None:
            idx = idx[rng.random(len(idx))
                      < observations_per_point / num_images]
        obs_image.append(np.full(len(idx), i))
        obs_point.append(idx)
        noisy = (xy[idx] + rng.normal(scale=pixel_noise, size=(len(idx), 2))
                 if pixel_noise else xy[idx])
        obs_xy.append(noisy)
    obs_image = np.concatenate(obs_image).astype(np.int32)
    obs_point = np.concatenate(obs_point).astype(np.int32)
    obs_xy = np.concatenate(obs_xy)

    truth = dict(qvecs=qvecs.copy(), tvecs=tvecs.copy(), points=pts.copy(),
                 cam_params=cam_params.copy())

    q0 = qvecs + rng.normal(scale=pose_noise, size=qvecs.shape)
    q0 = q0 / np.maximum(np.linalg.norm(q0, axis=-1, keepdims=True), 1e-12)
    t0 = tvecs + rng.normal(scale=pose_noise, size=tvecs.shape)
    x0 = pts + rng.normal(scale=point_noise, size=pts.shape)
    q0[0], t0[0] = qvecs[0], tvecs[0]
    if num_images > 1:
        t0[1, 0] = tvecs[1, 0]

    free_rot = np.ones(num_images)
    free_trans = np.ones((num_images, 3))
    free_rot[0] = 0.0
    free_trans[0] = 0.0
    if num_images > 1:
        free_trans[1, 0] = 0.0
    image_cam = np.zeros(num_images, np.int32)

    fields = dict(
        qvecs=q0, tvecs=t0, points=x0, cam_params=cam_params,
        obs_image=obs_image, obs_point=obs_point,
        obs_cam=np.zeros_like(obs_image), obs_xy=obs_xy,
        obs_mask=np.ones(len(obs_image)), free_rot=free_rot,
        free_trans=free_trans, free_points=np.ones(num_points),
        free_cam=np.zeros((1, MAXP)),  # intrinsics constant by default
        image_cam=image_cam)
    return fields, truth


def make_ba_problem(*args, dtype=torch.float64, device="cuda", **kwargs):
    """`make_ba_problem_numpy` as a `BAProblem` on `device`.
    Returns (problem, truth)."""
    fields, truth = make_ba_problem_numpy(*args, **kwargs)
    return problem_from_numpy(fields, device=device, dtype=dtype), truth


def make_synthetic_reconstruction(num_images: int = 8, num_points: int = 120,
                                  seed: int = 0, image_size=(640, 480),
                                  focal: float = 500.0) -> Reconstruction:
    """Exact synthetic `Reconstruction` from the `make_ba_problem`
    geometry (SIMPLE_PINHOLE camera, points seen by >= 2 images)."""
    fields, truth = make_ba_problem_numpy(
        num_images=num_images, num_points=num_points, seed=seed,
        image_size=image_size, focal=focal)
    qvecs, tvecs, pts = truth["qvecs"], truth["tvecs"], truth["points"]
    spec = camera_models.model_by_id(0)
    w, h = image_size

    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model_id=0, width=w, height=h,
                          params=np.asarray(
                              truth["cam_params"][0, :spec.num_params],
                              np.float64)))
    obs_image = fields["obs_image"]
    obs_point = fields["obs_point"]
    obs_xy = fields["obs_xy"]

    kp_rows = {i: np.nonzero(obs_image == i)[0] for i in range(num_images)}
    for i in range(num_images):
        rows = kp_rows[i]
        rec.add_image(Image(
            image_id=i + 1, qvec=qvecs[i].copy(), tvec=tvecs[i].copy(),
            camera_id=1, name=f"image{i:04d}.png",
            xys=obs_xy[rows].astype(np.float64),
            point3D_ids=np.full(len(rows), -1, np.int64)), registered=True)

    for p in range(num_points):
        rows = np.nonzero(obs_point == p)[0]
        if len(rows) < 2:
            continue
        track = []
        for r in rows:
            img = int(obs_image[r])
            track.append((img + 1, int(np.searchsorted(kp_rows[img], r))))
        rec.add_point3d(pts[p], track)
    return rec
