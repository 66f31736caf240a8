"""Synthetic scenes for tests and benchmarks, built with numpy only.

Port of `make_ba_problem`, `make_sequential_ba_problem`,
`make_synthetic_reconstruction`, `make_sba_scene`, `make_gsba_scene`,
`make_gsba_forest_scene` and `_lookat_pose` (used by
``utils/render.py``) from ``sba_tpu/utils/synthetic.py``: the
same geometry and the same sequence of draws from
``numpy.random.default_rng(seed)``, so one seed gives the same arrays.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.geometry.quaternions import np_quat_rotate, rotmat_to_quat
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
    params=None,
):
    """Synthetic BA problem with known ground truth, as numpy arrays.

    Cameras on an arc looking at a point cloud in front of them. Gauge:
    pose 0 constant, tvec x of image 1 constant. `params` replaces the
    camera model's initial parameters (its `init_params` at `focal`),
    for instance to observe through a distortion. Returns (fields,
    truth): `fields` maps `BAProblem` field names to float64 / int32
    arrays.
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
    params = np.array(spec.init_params(focal, w, h) if params is None
                      else params, np.float64)
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


def make_sequential_ba_problem_numpy(
    num_images: int = 1024,
    num_points: int = 100_000,
    track_len: int = 6,
    pose_noise: float = 0.003,
    point_noise: float = 0.02,
    pixel_noise: float = 0.5,
    seed: int = 0,
    image_size=(640, 480),
    focal: float = 500.0,
    model_id: int = 0,
    params=None,
):
    """Large sequential-capture scene, vectorized numpy.

    Cameras travel along a corridor; each point is observed by a
    contiguous window of `track_len` nearby images (the track locality
    of ordered capture). Out-of-view observations are masked, not
    dropped, so every track has exactly `track_len` slots and the fused
    path needs a single bucket. Gauge: pose 0 constant, tvec x of image
    1 constant. The camera is SIMPLE_PINHOLE (focal, w/2, h/2) unless
    `params` gives the parameters of camera model `model_id`, through
    which the points are then observed. Returns (fields, truth) like
    `make_ba_problem_numpy`.
    """
    rng = np.random.default_rng(seed)
    w, h = image_size
    spacing = 0.5

    centers = np.stack([
        np.arange(num_images) * spacing,
        0.2 * rng.normal(size=num_images),
        0.1 * rng.normal(size=num_images)], axis=1)
    aa = rng.normal(scale=0.02, size=(num_images, 3))
    angle = np.linalg.norm(aa, axis=1, keepdims=True)
    axis = aa / np.maximum(angle, 1e-12)
    qvecs = np.concatenate(
        [np.cos(angle / 2), np.sin(angle / 2) * axis], axis=1)
    tvecs = -np_quat_rotate(qvecs, centers)

    # Each point sits in the shared frustum of its window of images.
    s0 = rng.integers(0, num_images - track_len + 1, size=num_points)
    mid = centers[np.minimum(s0 + track_len // 2, num_images - 1)]
    depth = rng.uniform(6.0, 12.0, size=num_points)
    lat = rng.uniform(-2.0, 2.0, size=num_points)
    vert = rng.uniform(-1.5, 1.5, size=num_points)
    pts = mid + np.stack([lat, vert, depth], axis=1)

    obs_point = np.repeat(np.arange(num_points, dtype=np.int64), track_len)
    obs_image = (s0[:, None] + np.arange(track_len)[None, :]) \
        .reshape(-1).astype(np.int64)
    p_cam = np_quat_rotate(qvecs[obs_image], pts[obs_point]) \
        + tvecs[obs_image]
    z = np.maximum(p_cam[:, 2], 1e-6)
    uv = p_cam[:, :2] / z[:, None]
    if params is None:
        params = np.array([focal, w / 2.0, h / 2.0])
        xy = focal * uv + np.array([w / 2.0, h / 2.0])
    else:
        params = np.asarray(params, np.float64)
        xy = camera_models.model_by_id(model_id).world_to_image(
            torch.from_numpy(params), torch.from_numpy(uv)).numpy()
    if pixel_noise:
        xy = xy + rng.normal(scale=pixel_noise, size=xy.shape)
    mask = ((p_cam[:, 2] > 0.1) & (xy[:, 0] >= -50) & (xy[:, 0] < w + 50)
            & (xy[:, 1] >= -50) & (xy[:, 1] < h + 50)).astype(np.float64)

    cam_params = np.zeros((1, MAXP))
    cam_params[0, :len(params)] = params
    truth = dict(qvecs=qvecs.copy(), tvecs=tvecs.copy(), points=pts.copy(),
                 cam_params=cam_params.copy())

    # Perturb rotation and camera centre (not tvec), so the perturbation
    # does not grow with the corridor's length.
    q0 = qvecs + rng.normal(scale=pose_noise, size=qvecs.shape)
    q0 = q0 / np.linalg.norm(q0, axis=1, keepdims=True)
    c0 = centers + rng.normal(scale=pose_noise, size=centers.shape)
    t0 = -np_quat_rotate(q0, c0)
    x0 = pts + rng.normal(scale=point_noise, size=pts.shape)
    q0[0], t0[0] = qvecs[0], tvecs[0]
    t0[1, 0] = tvecs[1, 0]

    free_rot = np.ones(num_images)
    free_trans = np.ones((num_images, 3))
    free_rot[0] = 0.0
    free_trans[0] = 0.0
    free_trans[1, 0] = 0.0
    fields = dict(
        qvecs=q0, tvecs=t0, points=x0, cam_params=cam_params,
        obs_image=obs_image.astype(np.int32),
        obs_point=obs_point.astype(np.int32),
        obs_cam=np.zeros(len(obs_image), np.int32), obs_xy=xy,
        obs_mask=mask, free_rot=free_rot, free_trans=free_trans,
        free_points=np.ones(num_points), free_cam=np.zeros((1, MAXP)),
        image_cam=np.zeros(num_images, np.int32))
    return fields, truth


def make_sequential_ba_problem(*args, dtype=torch.float32, device="cuda",
                               **kwargs):
    """`make_sequential_ba_problem_numpy` as a `BAProblem` on `device`
    (float32 by default, as the reference's). Returns (problem, truth)."""
    fields, truth = make_sequential_ba_problem_numpy(*args, **kwargs)
    return problem_from_numpy(fields, device=device, dtype=dtype), truth


def spread_image_ids(num_images: int) -> np.ndarray:
    """A permutation of image ids that sends neighbouring images far
    apart: image i gets id i*m mod n, with m the first integer from
    0.45 n up that is coprime with n. Mapped through it, a sequential
    scene's points, each seen by a few consecutive images, have no image
    locality left (K3's wide-window case)."""
    n = int(num_images)
    m = int(np.ceil(0.45 * n))
    while np.gcd(m, n) != 1:
        m += 1
    return (np.arange(n, dtype=np.int64) * m % n).astype(np.int32)


def rename_images(static, par, perm):
    """The same kernel bucket (`ops.ba_kernels.KernelStatic`, its packed
    parameters `par`) with image n renamed perm[n] (perm [N] int): the
    lanes' image ids, the per-image columns of `par` and `free_sta`, and
    `image_cam`. Kernels compute the same function on it, with image rows
    moved to their new ids. Returns (static, par)."""
    perm = torch.as_tensor(perm).long().to(par.device)
    n = perm.shape[0]

    def cols(a):
        out = a.clone()
        out[..., perm] = a[..., :n]
        return out

    st = static._replace(obs_img=perm[static.obs_img.long()].int(),
                         free_sta=cols(static.free_sta),
                         image_cam=cols(static.image_cam), tiles=None)
    return st, cols(par)


def make_synthetic_reconstruction(num_images: int = 8, num_points: int = 120,
                                  seed: int = 0, image_size=(640, 480),
                                  focal: float = 500.0, model_id: int = 0,
                                  params=None,
                                  observations_per_point: int | None = None
                                  ) -> Reconstruction:
    """Exact synthetic `Reconstruction` from the `make_ba_problem`
    geometry (points seen by >= 2 images). The camera is SIMPLE_PINHOLE
    at `focal`, or camera model `model_id` with its `params`."""
    fields, truth = make_ba_problem_numpy(
        num_images=num_images, num_points=num_points, seed=seed,
        image_size=image_size, focal=focal, model_id=model_id,
        params=params, observations_per_point=observations_per_point)
    qvecs, tvecs, pts = truth["qvecs"], truth["tvecs"], truth["points"]
    spec = camera_models.model_by_id(model_id)
    w, h = image_size

    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model_id=model_id, width=w, height=h,
                          params=np.asarray(
                              truth["cam_params"][0, :spec.num_params],
                              np.float64)))
    obs_image = fields["obs_image"]
    obs_point = fields["obs_point"]
    obs_xy = fields["obs_xy"]

    # Keypoint index of each observation within its image (rows in order).
    by_image = np.argsort(obs_image, kind="stable")
    starts = np.searchsorted(obs_image[by_image], np.arange(num_images))
    kp = np.empty(len(obs_image), np.int64)
    kp[by_image] = np.arange(len(obs_image)) - starts[obs_image[by_image]]
    for i in range(num_images):
        rows = by_image[obs_image[by_image] == i]
        rec.add_image(Image(
            image_id=i + 1, qvec=qvecs[i].copy(), tvec=tvecs[i].copy(),
            camera_id=1, name=f"image{i:04d}.png",
            xys=obs_xy[rows].astype(np.float64),
            point3D_ids=np.full(len(rows), -1, np.int64)), registered=True)

    by_point = np.argsort(obs_point, kind="stable")
    bounds = np.searchsorted(obs_point[by_point], np.arange(num_points + 1))
    for p in range(num_points):
        rows = by_point[bounds[p]:bounds[p + 1]]
        if len(rows) < 2:
            continue
        rec.add_point3d(pts[p], list(zip((obs_image[rows] + 1).tolist(),
                                         kp[rows].tolist())))
    return rec


def _lookat_pose(center, target, up=(0.0, 0.0, 1.0)):
    """World->camera pose (qvec, tvec) for a camera at `center` looking at
    `target` (camera z forward, y down-ish)."""
    c = np.asarray(center, np.float64)
    z = np.asarray(target, np.float64) - c
    z /= np.linalg.norm(z)
    upv = np.asarray(up, np.float64)
    x = np.cross(z, upv)
    if np.linalg.norm(x) < 1e-8:
        x = np.cross(z, np.array([0.0, 1.0, 0.0]))
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])  # rows = camera axes in world
    q = rotmat_to_quat(torch.from_numpy(R)).numpy()
    t = -R @ c
    return q, t


def _np_quat_rotate_raw(q, v):
    """q [N, 4] w-first (NOT normalized), v [N, 3]: sba_tpu's scene
    generators rotate so, and the port keeps their arithmetic."""
    w = q[:, 0:1]
    u = q[:, 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _sba_scene_cameras(rng, num_images, image_size, focal):
    """The draws of make_sba_scene's cameras, in its order."""
    w, h = image_size
    cam = np.array([focal, w / 2.0, h / 2.0])
    qvecs = np.zeros((num_images, 4))
    tvecs = np.zeros((num_images, 3))
    centers = np.zeros((num_images, 3))
    for i in range(num_images):
        aa = rng.normal(scale=0.05, size=3)
        angle = np.linalg.norm(aa)
        axis = aa / max(angle, 1e-12)
        qvecs[i] = np.concatenate([[np.cos(angle / 2)],
                                   np.sin(angle / 2) * axis])
        centers[i] = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                               rng.uniform(-0.3, 0.3)])
        tvecs[i] = -_np_quat_rotate_raw(qvecs[i][None], centers[i][None])[0]
    return cam, qvecs, tvecs, centers


def _sba_scene_noise(rng, qvecs, tvecs, pose_noise):
    """make_sba_scene's initial poses: noise on all but the gauge."""
    q0 = qvecs.copy()
    t0 = tvecs.copy()
    if pose_noise > 0:
        q0 = q0 + rng.normal(scale=pose_noise, size=q0.shape)
        q0 = q0 / np.maximum(np.linalg.norm(q0, axis=-1, keepdims=True),
                             1e-12)
        t0 = t0 + rng.normal(scale=pose_noise, size=t0.shape)
        q0[0], t0[0] = qvecs[0], tvecs[0]
        if len(qvecs) > 1:
            t0[1, 0] = tvecs[1, 0]
    return q0, t0


def make_sba_scene(
    num_images: int = 4,
    image_size=(64, 48),
    focal: float = 60.0,
    plane_z: float = 5.0,
    cell: float = 1.0,
    num_labels: int = 5,
    pose_noise: float = 0.0,
    seed: int = 0,
    relief: float = 0.6,
):
    """Synthetic scene for semantic BA, port of sba_tpu's (numpy, the
    same draws): cameras above a labeled relief surface z = plane_z +
    relief * sin(1.3 x) sin(1.7 y), with ray-marched depth and aperiodic
    semantic maps (a random label per `cell` from a 97x89 lookup tile).
    A flat plane would leave the pairwise cost degenerate (the
    plane-induced homography ambiguity). Returns (qvecs_gt [N,4],
    tvecs_gt [N,3], cam_params [N,3], depth [N,H,W], semantic [N,H,W],
    qvecs_init, tvecs_init), float64."""
    rng = np.random.default_rng(seed)
    w, h = image_size
    cam, qvecs, tvecs, centers = _sba_scene_cameras(rng, num_images,
                                                    image_size, focal)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    dir_cam = np.stack([(xs - cam[1]) / cam[0], (ys - cam[2]) / cam[0],
                        np.ones_like(xs)], axis=-1)  # [H, W, 3]

    def surface_z(x, y):
        return plane_z + relief * np.sin(1.3 * x) * np.sin(1.7 * y)

    depth = np.zeros((num_images, h, w))
    semantic = np.zeros((num_images, h, w))
    lut = np.random.default_rng(seed + 1000).integers(0, num_labels,
                                                      size=(97, 89))

    def render(i):
        qc = qvecs[i] * np.array([1.0, -1.0, -1.0, -1.0])
        dirs = dir_cam.reshape(-1, 3)
        d_world = _np_quat_rotate_raw(
            np.broadcast_to(qc, (len(dirs), 4)), dirs).reshape(h, w, 3)
        # Fixed-point ray march on the ray parameter.
        s = (plane_z - centers[i, 2]) / d_world[..., 2]
        for _ in range(25):
            hit = centers[i][None, None, :] + s[..., None] * d_world
            s = (surface_z(hit[..., 0], hit[..., 1])
                 - centers[i, 2]) / d_world[..., 2]
        hit = centers[i][None, None, :] + s[..., None] * d_world
        depth[i] = s
        ix = np.floor(hit[..., 0] / cell).astype(np.int64) % 97
        iy = np.floor(hit[..., 1] / cell).astype(np.int64) % 89
        semantic[i] = lut[ix, iy].astype(np.float64)

    # The views draw nothing and numpy's ufuncs release the GIL, so the
    # views march in threads, each with the same arithmetic as in turn.
    with ThreadPoolExecutor(min(num_images, os.cpu_count() or 1, 8)) as ex:
        list(ex.map(render, range(num_images)))

    q0, t0 = _sba_scene_noise(rng, qvecs, tvecs, pose_noise)
    cam_params = np.tile(cam, (num_images, 1))
    return qvecs, tvecs, cam_params, depth, semantic, q0, t0


def _hard_silhouettes(cyl, qvecs, tvecs, cam, h, w):
    """[N, H, W] float64 hard masks of one cylinder in every image (the
    cylinder module's hard rasterizer on the CPU), and valid [N]."""
    from sba_tpu_torch.models.cylinder import (project_quadrilateral,
                                               quadrilateral_mask)

    n = len(qvecs)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float64))

    quad, valid = project_quadrilateral(
        t(np.tile(cyl.qvec, (n, 1))), t(np.tile(cyl.tvec, (n, 1))),
        t(np.full(n, cyl.radius)), t(np.full(n, cyl.height)),
        t(qvecs), t(tvecs), t(np.tile(cam, (n, 1))))
    return (quadrilateral_mask(quad, h, w, hard=True).numpy(),
            valid.numpy())


def make_gsba_scene(
    num_images: int = 4,
    image_size=(64, 48),
    focal: float = 55.0,
    radius: float = 0.4,
    height: float = 3.0,
    cam_dist: float = 8.0,
    trunk_class: float = 250.0,
    pose_noise: float = 0.0,
    cylinder_noise: float = 0.0,
    seed: int = 0,
):
    """Synthetic scene for geometric-semantic BA: one vertical cylinder at
    the origin, cameras on a circle looking at it; the semantic maps are
    the hard ground-truth silhouettes (trunk_class inside).

    Returns (qvecs_gt, tvecs_gt, cam_params [N,3], semantic_maps [N,H,W],
    cylinder_gt, qvecs_init, tvecs_init, cylinder_init)."""
    from sba_tpu_torch.models.cylinder import Cylinder

    rng = np.random.default_rng(seed)
    w, h = image_size
    cam = np.array([focal, w / 2.0, h / 2.0])
    cyl = Cylinder(qvec=[1.0, 0, 0, 0], tvec=[0.0, 0.0, -height / 2],
                   radius=radius, height=height)

    qvecs = np.zeros((num_images, 4))
    tvecs = np.zeros((num_images, 3))
    for i in range(num_images):
        ang = 2 * np.pi * i / num_images + rng.uniform(-0.1, 0.1)
        center = np.array([cam_dist * np.cos(ang), cam_dist * np.sin(ang),
                           rng.uniform(-0.5, 0.5)])
        qvecs[i], tvecs[i] = _lookat_pose(center, [0.0, 0.0, 0.0])

    masks, valid = _hard_silhouettes(cyl, qvecs, tvecs, cam, h, w)
    if not valid.all():
        raise ValueError("cameras must see the cylinder")
    semantic = np.where(masks > 0.5, trunk_class, 0.0)

    q0, t0 = _sba_scene_noise(rng, qvecs, tvecs, pose_noise)
    if cylinder_noise:
        cyl0 = Cylinder(
            qvec=cyl.qvec + rng.normal(scale=cylinder_noise, size=4),
            tvec=cyl.tvec + rng.normal(scale=cylinder_noise, size=3),
            radius=cyl.radius * float(np.exp(rng.normal(
                scale=cylinder_noise))),
            height=cyl.height * float(np.exp(rng.normal(
                scale=cylinder_noise))))
    else:
        cyl0 = Cylinder(qvec=cyl.qvec, tvec=cyl.tvec, radius=cyl.radius,
                        height=cyl.height)
    cam_params = np.tile(cam, (num_images, 1))
    return qvecs, tvecs, cam_params, semantic, cyl, q0, t0, cyl0


def make_gsba_forest_scene(
    num_cylinders: int = 16,
    cameras_per_cylinder: int = 2,
    image_size=(96, 72),
    focal: float = 100.0,
    radius: float = 0.35,
    height: float = 4.0,
    spacing: float = 4.0,
    cam_dist_factor: float = 0.6,
    trunk_class: float = 250.0,
    pose_noise: float = 0.0,
    cylinder_noise: float = 0.0,
    seed: int = 0,
):
    """Forest of trunks for K-cylinder GSBA: vertical cylinders on a
    jittered line, `cameras_per_cylinder` close-up cameras per trunk,
    each mask the UNION of all silhouettes (as the reference reads one
    boolean trunk mask per image against a cylinder list). The cameras
    look at their trunk from one side of the line, from a fixed palette
    of azimuths (+-35 degrees about the perpendicular, the first two 70
    degrees apart), so that no other trunk enters a view: the cost
    1 - IoU against the union is degenerate for whole-forest views (one
    fat quad over every trunk scores against the whole union).

    Returns (qvecs_gt, tvecs_gt, cam_params, semantic, cylinders_gt, q0,
    t0, cylinders_init)."""
    from sba_tpu_torch.models.cylinder import Cylinder

    rng = np.random.default_rng(seed)
    w, h = image_size
    cam = np.array([focal, w / 2.0, h / 2.0])

    cyls = []
    for k in range(num_cylinders):
        cx = (k - (num_cylinders - 1) / 2.0) * spacing
        cy = rng.uniform(-0.1, 0.1) * spacing
        cyls.append(Cylinder(
            qvec=[1.0, 0, 0, 0], tvec=[cx, cy, -height / 2],
            radius=radius * float(np.exp(rng.uniform(-0.2, 0.2))),
            height=height))

    num_images = num_cylinders * cameras_per_cylinder
    cam_dist = cam_dist_factor * spacing
    palette = [55.0, 125.0, 235.0, 305.0, 90.0, 270.0]
    qvecs = np.zeros((num_images, 4))
    tvecs = np.zeros((num_images, 3))
    i = 0
    for c in cyls:
        for j in range(cameras_per_cylinder):
            ang = palette[j % len(palette)] / 180.0 * np.pi \
                + rng.uniform(-0.03, 0.03)
            center = np.array([c.tvec[0] + cam_dist * np.cos(ang),
                               c.tvec[1] + cam_dist * np.sin(ang),
                               rng.uniform(-0.2, 0.2)])
            qvecs[i], tvecs[i] = _lookat_pose(
                center, [c.tvec[0], c.tvec[1], 0.0])
            i += 1

    union = np.zeros((num_images, h, w))
    for c in cyls:
        m, valid = _hard_silhouettes(c, qvecs, tvecs, cam, h, w)
        union = np.maximum(union, m * valid.astype(np.float64)[:, None,
                                                               None])
    semantic = np.where(union > 0.5, trunk_class, 0.0)

    q0, t0 = _sba_scene_noise(rng, qvecs, tvecs, pose_noise)
    cyls0 = []
    for c in cyls:
        if cylinder_noise > 0:
            q = np.asarray(c.qvec) + rng.normal(scale=cylinder_noise, size=4)
            cyls0.append(Cylinder(
                qvec=q / np.linalg.norm(q),
                tvec=np.asarray(c.tvec) + rng.normal(scale=cylinder_noise,
                                                     size=3),
                radius=c.radius * float(np.exp(rng.normal(
                    scale=cylinder_noise))),
                height=c.height * float(np.exp(rng.normal(
                    scale=cylinder_noise)))))
        else:
            cyls0.append(c)
    cam_params = np.tile(cam, (num_images, 1))
    return qvecs, tvecs, cam_params, semantic, cyls, q0, t0, cyls0
