"""Image/camera undistortion + bitmap warping.

Port of the COLMAP-output half of ``sba_tpu/geometry/undistortion.py``
(ref: src/base/undistortion.{h,cc} `UndistortCamera`, `UndistortImage`,
`COLMAPUndistorter`, and src/base/warp.cc `WarpImageBetweenCameras`): a
warp is one batched image_to_world/world_to_image round trip through the
camera models plus a bilinear sample, on the image's device. The
PMVS/CMP-MVS writers and stereo rectification come with the CLI slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.io.colmap_models import Camera
from sba_tpu_torch.ops.interpolation import bilinear_sample2d


@dataclass(frozen=True)
class UndistortCameraOptions:
    """Mirrors ref: undistortion.h:44 UndistortCameraOptions."""

    blank_pixels: float = 0.0   # 0 = no blank pixels, 1 = keep all source
    min_scale: float = 0.2
    max_scale: float = 2.0
    max_image_size: int = -1
    roi_min_x: float = 0.0
    roi_min_y: float = 0.0
    roi_max_x: float = 1.0
    roi_max_y: float = 1.0


def _f64(a, device="cpu"):
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def undistort_camera(camera: Camera,
                     options: Optional[UndistortCameraOptions] = None
                     ) -> Camera:
    """Derive the undistorted PINHOLE camera (ref: undistortion.cc
    UndistortCamera): same focal; principal point/size chosen from the
    undistorted positions of the source border so that `blank_pixels`
    interpolates between the largest inscribed (0) and smallest
    circumscribed (1) pinhole viewport. Host-side (float64 on the CPU)."""
    opt = options or UndistortCameraOptions()
    spec = camera_models.model_by_id(camera.model_id)
    fidx = spec.focal_idxs
    fx = float(camera.params[fidx[0]])
    fy = float(camera.params[fidx[-1]])
    w, h = camera.width, camera.height

    # Undistort the border (pixel EDGES, so an identity camera maps back
    # to exactly the same viewport) into the normalized plane.
    n = 256
    xs = np.linspace(0.0, float(w), n)
    ys = np.linspace(0.0, float(h), n)
    border = np.concatenate([
        np.stack([xs, np.zeros(n)], -1),
        np.stack([xs, np.full(n, float(h))], -1),
        np.stack([np.zeros(n), ys], -1),
        np.stack([np.full(n, float(w)), ys], -1)])
    uv = camera_models.image_to_world(
        camera.model_id, _f64(camera.params), _f64(border)).numpy()

    left = uv[2 * n:3 * n, 0]
    right = uv[3 * n:4 * n, 0]
    top = uv[:n, 1]
    bottom = uv[n:2 * n, 1]

    # Inscribed box (no blank pixels): tightest interior bounds.
    in_l, in_r = left.max(), right.min()
    in_t, in_b = top.max(), bottom.min()
    # Circumscribed box (all source pixels): loosest bounds.
    out_l, out_r = left.min(), right.max()
    out_t, out_b = top.min(), bottom.max()

    a = np.clip(opt.blank_pixels, 0.0, 1.0)
    l = in_l + a * (out_l - in_l)
    r = in_r + a * (out_r - in_r)
    t = in_t + a * (out_t - in_t)
    b = in_b + a * (out_b - in_b)

    new_w = max(1, int(np.ceil((r - l) * fx)))
    new_h = max(1, int(np.ceil((b - t) * fy)))
    scale_x = np.clip(new_w / w, opt.min_scale, opt.max_scale)
    scale_y = np.clip(new_h / h, opt.min_scale, opt.max_scale)
    new_w = max(1, int(w * scale_x)) if new_w / w != scale_x else new_w
    new_h = max(1, int(h * scale_y)) if new_h / h != scale_y else new_h
    if opt.max_image_size > 0:
        s = opt.max_image_size / max(new_w, new_h)
        if s < 1.0:
            new_w = max(1, int(new_w * s))
            new_h = max(1, int(new_h * s))
            fx *= s
            fy *= s
    cx = -l * fx
    cy = -t * fy

    # ROI crop (ref: undistortion.cc roi handling).
    if (opt.roi_min_x, opt.roi_min_y, opt.roi_max_x, opt.roi_max_y) != (
            0.0, 0.0, 1.0, 1.0):
        x0 = int(opt.roi_min_x * new_w)
        y0 = int(opt.roi_min_y * new_h)
        new_w = max(1, int((opt.roi_max_x - opt.roi_min_x) * new_w))
        new_h = max(1, int((opt.roi_max_y - opt.roi_min_y) * new_h))
        cx -= x0
        cy -= y0

    pinhole = camera_models.model_by_name("PINHOLE")
    return Camera(camera_id=camera.camera_id, model_id=pinhole.model_id,
                  width=new_w, height=new_h,
                  params=np.array([fx, fy, cx, cy], np.float64))


def warp_image_between_cameras(src_camera: Camera, dst_camera: Camera,
                               image) -> torch.Tensor:
    """Resample `image` (tensor [H, W] or [H, W, C], src geometry) into
    the dst camera's geometry on the image's device (ref: base/warp.cc
    WarpImageBetweenCameras). Pixel positions are float64; the result
    has the promoted type of the image and float64."""
    dev = image.device
    dh, dw = dst_camera.height, dst_camera.width
    yy, xx = torch.meshgrid(
        torch.arange(dh, dtype=torch.float64, device=dev) + 0.5,
        torch.arange(dw, dtype=torch.float64, device=dev) + 0.5,
        indexing="ij")
    dst_xy = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)
    uv = camera_models.image_to_world(
        dst_camera.model_id, _f64(dst_camera.params, dev), dst_xy)
    src_xy = camera_models.world_to_image(
        src_camera.model_id, _f64(src_camera.params, dev), uv)
    if image.ndim == 2:
        return bilinear_sample2d(image, src_xy - 0.5).reshape(dh, dw)
    chans = [bilinear_sample2d(image[..., c], src_xy - 0.5).reshape(dh, dw)
             for c in range(image.shape[-1])]
    return torch.stack(chans, -1)


def undistort_image(image, camera: Camera,
                    options: Optional[UndistortCameraOptions] = None
                    ) -> Tuple[torch.Tensor, Camera]:
    """Undistort one image; returns (undistorted image, pinhole camera)
    (ref: undistortion.cc UndistortImage)."""
    new_cam = undistort_camera(camera, options)
    return warp_image_between_cameras(camera, new_cam, image), new_cam


def undistort_reconstruction(reconstruction,
                             options: Optional[UndistortCameraOptions] = None):
    """Undistort all cameras + keypoint coordinates of a reconstruction
    in place (ref: COLMAPUndistorter::Run model part). Returns the map
    {camera_id: undistorted Camera}."""
    new_cams = {}
    for cid, cam in reconstruction.cameras.items():
        new_cams[cid] = undistort_camera(cam, options)
    for image in reconstruction.images.values():
        src = reconstruction.cameras[image.camera_id]
        dst = new_cams[image.camera_id]
        if len(image.xys) == 0:
            continue
        uv = camera_models.image_to_world(
            src.model_id, _f64(src.params), _f64(image.xys))
        xy = camera_models.world_to_image(dst.model_id, _f64(dst.params), uv)
        image.xys = xy.numpy()
    reconstruction.cameras.update(new_cams)
    return new_cams


def write_colmap_workspace_configs(output_path: str, image_names,
                                   num_patch_match_src_images: int = 20):
    """stereo/patch-match.cfg + stereo/fusion.cfg + run-colmap-*.sh
    (ref: undistortion.cc:271-300)."""
    stereo = os.path.join(output_path, "stereo")
    for sub in ("depth_maps", "normal_maps", "consistency_graphs"):
        os.makedirs(os.path.join(stereo, sub), exist_ok=True)
    with open(os.path.join(stereo, "patch-match.cfg"), "w") as f:
        for name in image_names:
            f.write(f"{name}\n__auto__, {num_patch_match_src_images}\n")
    with open(os.path.join(stereo, "fusion.cfg"), "w") as f:
        for name in image_names:
            f.write(f"{name}\n")
    for geometric in (False, True):
        kind = "geometric" if geometric else "photometric"
        script = os.path.join(output_path, f"run-colmap-{kind}.sh")
        with open(script, "w") as f:
            f.write(
                "# You must set $COLMAP_EXE_PATH to\n"
                "# the directory containing the COLMAP executables.\n"
                "$COLMAP_EXE_PATH/colmap patch_match_stereo \\\n"
                "  --workspace_path . \\\n"
                "  --workspace_format COLMAP \\\n"
                "  --pmvs_option_name option-all \\\n"
                f"  --PatchMatchStereo.geom_consistency "
                f"{'true' if geometric else 'false'}\n"
                "$COLMAP_EXE_PATH/colmap stereo_fusion \\\n"
                "  --workspace_path . \\\n"
                "  --workspace_format COLMAP \\\n"
                "  --pmvs_option_name option-all \\\n"
                f"  --input_type {kind} \\\n"
                f"  --output_path ./fused.ply\n")
