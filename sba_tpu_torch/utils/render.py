"""Photographic-texture scene renderer for end-to-end pipeline validation.

Port of ``sba_tpu/utils/render.py``: perspective views of a
fractal-textured heightfield from known camera poses, through a camera
model's lens (so SIMPLE_RADIAL views carry true distortion). The
texture, the poses and the noise are drawn with numpy from sba_tpu's
seeds in sba_tpu's order, so one seed gives the same scene; the ray
march and the shading run in torch on the given device (float64).
The analytic heightfield (`_Heightfield`) is the truth that dense
reconstructions are checked against.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat, quat_rotate
from sba_tpu_torch.io.colmap_models import Camera, Image
from sba_tpu_torch.models.reconstruction import Reconstruction
from sba_tpu_torch.utils.synthetic import _lookat_pose

__all__ = [
    "fractal_texture",
    "render_scene",
    "write_scene_images",
    "gt_reconstruction",
    "gt_sparse_reconstruction",
]


def _value_noise(size, persistence, seed, ridged=False):
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float64)
    amp = 1.0
    cells = 4
    while cells <= size:
        grid = rng.standard_normal((cells, cells))
        # Periodic bilinear upsample of the coarse grid to full resolution.
        idx = np.arange(size) * cells / size
        i0 = np.floor(idx).astype(np.int64)
        frac = idx - i0
        i1 = (i0 + 1) % cells
        g = (grid[np.ix_(i0, i0)] * np.outer(1 - frac, 1 - frac)
             + grid[np.ix_(i0, i1)] * np.outer(1 - frac, frac)
             + grid[np.ix_(i1, i0)] * np.outer(frac, 1 - frac)
             + grid[np.ix_(i1, i1)] * np.outer(frac, frac))
        if ridged:
            g = 1.0 - np.abs(g)  # sharp creases at the zero crossings
        tex += amp * g
        amp *= persistence
        cells *= 2
    tex -= tex.min()
    tex /= max(tex.max(), 1e-12)
    return tex


def fractal_texture(size: int = 1024, persistence: float = 0.75,
                    seed: int = 0) -> np.ndarray:
    """Photographic-like texture in [0,1]: high-persistence value noise
    blended with ridged noise (multi-scale contrast)."""
    smooth = _value_noise(size, persistence, seed)
    ridge = _value_noise(size, persistence, seed + 9001, ridged=True)
    tex = 0.45 * smooth + 0.55 * ridge
    # Mild S-curve for local contrast.
    tex = np.clip(1.5 * (tex - 0.5) + 0.5, 0.0, 1.0)
    tex -= tex.min()
    tex /= max(tex.max(), 1e-12)
    return tex


def _bilinear_wrap(tex, u, v):
    """Sample tex [n, n] at continuous (u, v) in texel units, wrapping."""
    n = tex.shape[0]
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    fu = u - u0
    fv = v - v0
    u0 = torch.remainder(u0, n)
    v0 = torch.remainder(v0, n)
    u1 = torch.remainder(u0 + 1, n)
    v1 = torch.remainder(v0 + 1, n)
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
            + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)


class _Heightfield:
    """Aperiodic smooth relief z(x, y) = plane_z + sum_k a_k sin(.) sin(.),
    with analytic gradient for shading (torch tensors)."""

    def __init__(self, plane_z: float, relief: float, seed: int,
                 num_waves: int = 6):
        rng = np.random.default_rng(seed + 77)
        self.plane_z = plane_z
        self.wx = rng.uniform(0.5, 1.9, num_waves)
        self.wy = rng.uniform(0.5, 1.9, num_waves)
        self.px = rng.uniform(0, 2 * np.pi, num_waves)
        self.py = rng.uniform(0, 2 * np.pi, num_waves)
        amp = rng.uniform(0.5, 1.0, num_waves)
        self.amp = amp * relief / amp.sum()

    def z(self, x, y):
        out = torch.full_like(x, self.plane_z)
        for k in range(len(self.amp)):
            out = out + self.amp[k] * torch.sin(self.wx[k] * x + self.px[k]) \
                * torch.sin(self.wy[k] * y + self.py[k])
        return out

    def grad(self, x, y):
        gx = torch.zeros_like(x)
        gy = torch.zeros_like(y)
        for k in range(len(self.amp)):
            sx = torch.sin(self.wx[k] * x + self.px[k])
            cx = torch.cos(self.wx[k] * x + self.px[k])
            sy = torch.sin(self.wy[k] * y + self.py[k])
            cy = torch.cos(self.wy[k] * y + self.py[k])
            gx = gx + self.amp[k] * self.wx[k] * cx * sy
            gy = gy + self.amp[k] * self.wy[k] * sx * cy
        return gx, gy


def _ring_poses(num_images, plane_z, ring_radius, ring_height, jitter, seed):
    """Cameras on a jittered ring above the surface, converging on the
    scene center."""
    rng = np.random.default_rng(seed + 31)
    qvecs = np.zeros((num_images, 4))
    tvecs = np.zeros((num_images, 3))
    centers = np.zeros((num_images, 3))
    for i in range(num_images):
        # ~200 degrees of arc: substantial viewpoint change end to end.
        ang = 2 * np.pi * (i / num_images) * 0.55
        c = np.array([ring_radius * np.cos(ang),
                      ring_radius * np.sin(ang),
                      ring_height])
        c += rng.normal(scale=jitter, size=3)
        target = np.array([0.0, 0.0, plane_z]) + rng.normal(
            scale=0.05 * ring_radius, size=3)
        q, t = _lookat_pose(c, target)
        qvecs[i], tvecs[i], centers[i] = q, t, c
    return qvecs, tvecs, centers


def _march(field: _Heightfield, center, d_world):
    """Ray parameter s of the first hit of center + s d_world with the
    heightfield, by fixed-point iteration (converges: |grad z| *
    |d_xy/d_z| < 1 for gentle relief and converging views)."""
    s = (field.plane_z - center[2]) / d_world[:, 2]
    for _ in range(30):
        hit = center[None, :] + s[:, None] * d_world
        s = (field.z(hit[:, 0], hit[:, 1]) - center[2]) / d_world[:, 2]
    return s


def _camera_params(model_name, focal, w, h, extra_params):
    spec = camera_models.model_by_name(model_name)
    if model_name == "SIMPLE_PINHOLE":
        return np.array([focal, w / 2.0, h / 2.0], np.float64)
    if model_name == "PINHOLE":
        return np.array([focal, focal, w / 2.0, h / 2.0], np.float64)
    # f-first models with trailing distortion coefficients.
    params = np.asarray(spec.init_params(focal, w, h), np.float64)
    extra = np.asarray(extra_params, np.float64)
    if extra.size:
        params[-extra.size:] = extra
    return params


def render_scene(
    num_images: int = 8,
    image_size=(320, 240),
    focal: float | None = None,
    model_name: str = "SIMPLE_PINHOLE",
    extra_params=(),
    plane_z: float = 5.0,
    relief: float = 0.55,
    ring_radius: float = 1.6,
    ring_height: float = 0.0,
    jitter: float = 0.12,
    texture_scale: float = 0.55,
    noise_std: float = 0.008,
    seed: int = 0,
    device="cuda",
):
    """Render `num_images` grayscale views of a textured heightfield.

    Rays go through the camera model's image_to_world, so the images of
    SIMPLE_RADIAL / OPENCV etc. carry true distortion. Returns a dict with
    images (uint8 [N,H,W]), depths (float32 [N,H,W], the camera-frame z
    of each pixel's hit), qvecs [N,4], tvecs [N,3] (world->cam, COLMAP
    convention), camera dict(model, width, height, params), centers
    [N,3]; all numpy.
    """
    w, h = image_size
    if focal is None:
        focal = 1.1 * max(w, h)
    spec = camera_models.model_by_name(model_name)
    params = _camera_params(model_name, focal, w, h, extra_params)

    f64 = dict(dtype=torch.float64, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, **f64) + 0.5,
                            torch.arange(w, **f64) + 0.5, indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2)
    uv = spec.image_to_world(torch.as_tensor(params, **f64), xy)
    dirs_cam = torch.cat([uv, torch.ones_like(uv[:, :1])], -1)

    field = _Heightfield(plane_z, relief, seed)
    tex_np = fractal_texture(seed=seed)
    texn = tex_np.shape[0]
    tex = torch.as_tensor(tex_np, **f64)
    qvecs, tvecs, centers = _ring_poses(
        num_images, plane_z, ring_radius, ring_height, jitter, seed)

    rng = np.random.default_rng(seed + 5)
    images = np.zeros((num_images, h, w), np.uint8)
    depths = np.zeros((num_images, h, w), np.float32)
    light = np.array([0.4, 0.25, -0.88])
    light = torch.as_tensor(light / np.linalg.norm(light), **f64)
    for i in range(num_images):
        qc = torch.as_tensor(qvecs[i] * np.array([1.0, -1.0, -1.0, -1.0]),
                             **f64)
        d_world = quat_rotate(qc, dirs_cam)
        center = torch.as_tensor(centers[i], **f64)
        s = _march(field, center, d_world)
        hit = center[None, :] + s[:, None] * d_world
        u = hit[:, 0] / texture_scale * (texn / 16.0)
        v = hit[:, 1] / texture_scale * (texn / 16.0)
        albedo = _bilinear_wrap(tex, u, v)
        gx, gy = field.grad(hit[:, 0], hit[:, 1])
        normal = torch.stack([-gx, -gy, torch.ones_like(gx)], -1)
        normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
        shade = torch.clamp(-(normal @ light), 0.0, 1.0)
        img = albedo * (0.55 + 0.45 * shade)
        noise = rng.normal(scale=noise_std, size=img.shape)
        img = img + torch.as_tensor(noise, **f64)
        images[i] = torch.clamp(img.reshape(h, w) * 255.0, 0, 255).to(
            torch.uint8).cpu().numpy()
        # Ground-truth depth: p_cam = s * (u, v, 1), so z_cam == s.
        depths[i] = s.reshape(h, w).to(torch.float32).cpu().numpy()

    camera = dict(model=model_name, width=w, height=h, params=params)
    return dict(images=images, depths=depths, qvecs=qvecs, tvecs=tvecs,
                camera=camera, centers=centers)


def write_scene_images(scene: dict, image_dir: str, prefix: str = "view"):
    """Save rendered views as PNGs named <prefix><k>.png; returns names."""
    from PIL import Image as PILImage

    os.makedirs(image_dir, exist_ok=True)
    names = []
    for k in range(len(scene["images"])):
        name = f"{prefix}{k:03d}.png"
        PILImage.fromarray(scene["images"][k]).save(
            os.path.join(image_dir, name))
        names.append(name)
    return names


def gt_reconstruction(scene: dict, names):
    """Ground-truth Reconstruction (poses only)."""
    rec = Reconstruction()
    cam = scene["camera"]
    rec.add_camera(Camera(
        camera_id=1, model_id=camera_models.model_by_name(
            cam["model"]).model_id,
        width=cam["width"], height=cam["height"],
        params=np.asarray(cam["params"], np.float64)))
    for k, name in enumerate(names):
        img = Image(image_id=k + 1, name=name, camera_id=1,
                    qvec=scene["qvecs"][k].copy(),
                    tvec=scene["tvecs"][k].copy(),
                    xys=np.zeros((0, 2)),
                    point3D_ids=np.zeros(0, np.int64))
        rec.add_image(img, registered=True)
    return rec


def gt_sparse_reconstruction(scene: dict, names, stride: int,
                             max_depth_error: float = 0.01):
    """`gt_reconstruction` plus a sparse point cloud, as a mapper would
    leave it for the dense path: every view's pixels on a `stride` grid
    are back-projected from the true depths, and each point is observed,
    through the camera model, in every view whose image it falls in and
    whose own true depth there agrees within `max_depth_error`
    (relative). Points seen by fewer than two views are dropped.
    (A test fixture of the port; sba_tpu's tests build it inline.)"""
    rec = gt_reconstruction(scene, names)
    cam = scene["camera"]
    model = camera_models.model_by_name(cam["model"]).model_id
    params = torch.as_tensor(np.asarray(cam["params"], np.float64))
    w, h = cam["width"], cam["height"]
    depths = scene["depths"]
    N = len(names)
    Rs = [np_quat_to_rotmat(q) for q in scene["qvecs"]]
    pts = []
    for i in range(N):
        ys, xs = np.meshgrid(np.arange(stride // 2, h, stride),
                             np.arange(stride // 2, w, stride),
                             indexing="ij")
        ys, xs = ys.reshape(-1), xs.reshape(-1)
        xy = np.stack([xs + 0.5, ys + 0.5], -1)
        uv = camera_models.image_to_world(model, params,
                                          torch.as_tensor(xy)).numpy()
        p_cam = np.concatenate([uv, np.ones((len(uv), 1))], -1) \
            * depths[i][ys, xs, None].astype(np.float64)
        pts.append((p_cam - scene["tvecs"][i]) @ Rs[i])
    pts = np.concatenate(pts)
    obs = []      # per view: (visible mask, pixel positions)
    for j in range(N):
        pc = pts @ Rs[j].T + scene["tvecs"][j]
        z = pc[:, 2]
        safe = np.where(z > 1e-9, z, 1.0)
        xy = camera_models.world_to_image(
            model, params, torch.as_tensor(pc[:, :2] / safe[:, None])
        ).numpy()
        inb = (z > 1e-9) & (xy[:, 0] >= 0) & (xy[:, 0] < w) \
            & (xy[:, 1] >= 0) & (xy[:, 1] < h)
        xi = np.clip(xy[:, 0].astype(int), 0, w - 1)
        yi = np.clip(xy[:, 1].astype(int), 0, h - 1)
        dj = depths[j][yi, xi]
        vis = inb & (np.abs(dj - z) < max_depth_error * np.abs(z))
        obs.append((vis, xy))
    seen = np.stack([v for v, _ in obs])          # [N, P]
    keep = np.nonzero(seen.sum(0) >= 2)[0]
    rows = {}
    for j in range(N):
        sel = keep[seen[j, keep]]
        image = rec.images[j + 1]
        image.xys = obs[j][1][sel]
        image.point3D_ids = np.full(len(sel), -1, np.int64)
        rows[j] = {int(p): k for k, p in enumerate(sel)}
    for p in keep:
        track = [(j + 1, rows[j][int(p)]) for j in range(N) if seen[j, p]]
        rec.add_point3d(pts[p], track)
    return rec

