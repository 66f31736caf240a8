"""Image/camera undistortion + bitmap warping.

Port of the COLMAP-output half of ``sba_tpu/geometry/undistortion.py``
(ref: src/base/undistortion.{h,cc} `UndistortCamera`, `UndistortImage`,
`COLMAPUndistorter`, and src/base/warp.cc `WarpImageBetweenCameras`): a
warp is one batched image_to_world/world_to_image round trip through the
camera models plus a bilinear sample, on the image's device; stereo
rectification (ref: undistortion.cc:978-1089) is host float64 for the
homographies and the same float64 warp on the device for the images; the
COLMAP, PMVS and CMP-MVS workspace writers are host code.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.geometry.quaternions import (np_angle_axis_to_quat,
                                                np_quat_to_angle_axis,
                                                np_quat_to_rotmat)
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


def rectify_stereo_cameras(camera1: Camera, camera2: Camera, qvec, tvec):
    """Planar stereo rectification homographies (pinhole cameras)
    (ref: base/undistortion.cc:978-1040 RectifyStereoCameras). Host
    float64.

    qvec/tvec: relative pose x2 = R x1 + t between the two (undistorted)
    cameras. Returns (H1 [3,3], H2 [3,3], Q [4,4]) with H* acting on
    homogeneous pixel coordinates and Q the disparity-to-depth matrix.
    """
    aa = np_quat_to_angle_axis(np.asarray(qvec, np.float64))
    R2 = np_quat_to_rotmat(np_angle_axis_to_quat(-0.5 * aa))
    R1 = R2.T
    t = R2 @ np.asarray(tvec, np.float64)

    x_unit = np.array([1.0, 0, 0]) if t[0] >= 0 else np.array([-1.0, 0, 0])
    axis = np.cross(t, x_unit)
    if np.linalg.norm(axis) < 1e-15:
        R_x = np.eye(3)
    else:
        angle = np.arccos(np.clip(abs(float(t @ x_unit))
                                  / np.linalg.norm(t), -1, 1))
        R_x = np_quat_to_rotmat(np_angle_axis_to_quat(
            angle * axis / np.linalg.norm(axis)))
    R1 = R_x @ R1
    R2 = R_x @ R2
    t = R_x @ t

    def K_of(cam):
        spec = camera_models.model_by_id(cam.model_id)
        p = cam.params
        fi = spec.focal_idxs
        cx, cy = (p[i] for i in spec.principal_idxs)
        return np.array([[p[fi[0]], 0, cx], [0, p[fi[-1]], cy],
                         [0, 0, 1.0]])

    K1, K2 = K_of(camera1), K_of(camera2)
    K = np.eye(3)
    K[0, 0] = K[1, 1] = min(camera1.mean_focal_length(),
                            camera2.mean_focal_length())
    K[0, 2] = K1[0, 2]
    K[1, 2] = 0.5 * (K1[1, 2] + K2[1, 2])
    H1 = K @ R1 @ np.linalg.inv(K1)
    H2 = K @ R2 @ np.linalg.inv(K2)
    Q = np.eye(4)
    Q[3, 0] = -K[1, 2]
    Q[3, 1] = -K[0, 2]
    Q[3, 2] = K[0, 0]
    Q[2, 3] = -1.0 / t[0]
    Q[3, 3] = 0.0
    return H1, H2, Q


def rectify_and_undistort_stereo_pair(image1, image2, camera1: Camera,
                                      camera2: Camera, qvec, tvec,
                                      options=None):
    """Undistort + rectify a stereo pair (ref:
    base/undistortion.cc:1042-1089). `image1`, `image2`: tensors [H, W]
    or [H, W, C] on the device the warps run on. Returns (img1, img2,
    undistorted Camera, Q); both outputs share camera1's undistorted
    geometry, as in the reference. Pixel positions are float64."""
    und_cam = undistort_camera(camera1, options)
    H1, H2, Q = rectify_stereo_cameras(und_cam, und_cam, qvec, tvec)

    def warp(img, src_cam, H):
        # dst rectified pixel -> undistorted pixel (H^-1) -> source.
        dev = img.device
        dh, dw = und_cam.height, und_cam.width
        yy, xx = torch.meshgrid(
            torch.arange(dh, dtype=torch.float64, device=dev) + 0.5,
            torch.arange(dw, dtype=torch.float64, device=dev) + 0.5,
            indexing="ij")
        ph = torch.stack([xx.reshape(-1), yy.reshape(-1),
                          torch.ones(dh * dw, dtype=torch.float64,
                                     device=dev)], -1)
        pu = ph @ _f64(np.linalg.inv(H), dev).T
        den = pu[:, 2:]
        pu = pu[:, :2] / torch.where(den.abs() > 1e-12, den,
                                     den.new_tensor(1e-12))
        uv = camera_models.image_to_world(
            und_cam.model_id, _f64(und_cam.params, dev), pu)
        src_xy = camera_models.world_to_image(
            src_cam.model_id, _f64(src_cam.params, dev), uv)
        if img.ndim == 2:
            return bilinear_sample2d(img, src_xy - 0.5).reshape(dh, dw)
        return torch.stack(
            [bilinear_sample2d(img[..., c], src_xy - 0.5).reshape(dh, dw)
             for c in range(img.shape[-1])], -1)

    return warp(image1, camera1, H1), warp(image2, camera2, H2), und_cam, Q


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


def _projection_matrix_text(camera: Camera, qvec, tvec,
                            header: str = "CONTOUR") -> str:
    """K [R|t] for a pinhole camera (ref: undistortion.cc:57-77
    WriteProjectionMatrix)."""
    spec = camera_models.model_by_id(camera.model_id)
    p = np.asarray(camera.params, np.float64)
    if spec.name == "PINHOLE":
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    elif spec.name == "SIMPLE_PINHOLE":
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    else:
        raise ValueError("projection matrix export needs a pinhole camera")
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    R = np_quat_to_rotmat(np.asarray(qvec, np.float64))
    P = K @ np.concatenate([R, np.asarray(tvec, np.float64)[:, None]], 1)
    lines = [header] if header else []
    for row in P:
        lines.append(" ".join(f"{v:.12g}" for v in row))
    return "\n".join(lines) + "\n"


def write_pmvs_workspace(output_path: str, reconstruction,
                         undistorted_images: dict):
    """PMVS workspace: visualize/%08d.jpg + txt/%08d.txt + bundle.rd.out +
    vis.dat + option-all + runner scripts
    (ref: undistortion.cc PMVSUndistorter::Run :314-366)."""
    import multiprocessing

    from PIL import Image as PILImage

    pmvs = os.path.join(output_path, "pmvs")
    for sub in ("txt", "visualize", "models"):
        os.makedirs(os.path.join(pmvs, sub), exist_ok=True)
    reg_ids = list(reconstruction.registered_image_ids)
    for idx, iid in enumerate(reg_ids):
        image = reconstruction.images[iid]
        cam = reconstruction.cameras[image.camera_id]
        arr = undistorted_images.get(iid)
        if arr is not None:
            PILImage.fromarray(arr).convert("RGB").save(
                os.path.join(pmvs, "visualize", f"{idx:08d}.jpg"))
        with open(os.path.join(pmvs, "txt", f"{idx:08d}.txt"), "w") as f:
            f.write(_projection_matrix_text(cam, image.qvec, image.tvec))

    bundle_path = os.path.join(pmvs, "bundle.rd.out")
    reconstruction.export_bundler(bundle_path, bundle_path + ".list.txt",
                                  skip_distortion=True)

    # vis.dat: per reg image, indices of images sharing a 3D point
    # (ref: undistortion.cc:396-434 WriteVisibilityData).
    id_to_idx = {iid: i for i, iid in enumerate(reg_ids)}
    vis = {i: set() for i in range(len(reg_ids))}
    for p in reconstruction.points3D.values():
        track_idx = [id_to_idx[iid] for iid in np.asarray(p.image_ids)
                     if iid in id_to_idx]
        for a in track_idx:
            for b in track_idx:
                if a != b:
                    vis[a].add(b)
    with open(os.path.join(pmvs, "vis.dat"), "w") as f:
        f.write("VISDATA\n")
        f.write(f"{len(reg_ids)}\n")
        for i in range(len(reg_ids)):
            neigh = sorted(vis[i])
            f.write(f"{i} {len(neigh)}" +
                    "".join(f" {j}" for j in neigh) + "\n")

    # option-all (ref: undistortion.cc:556 WriteOptionFile).
    with open(os.path.join(pmvs, "option-all"), "w") as f:
        f.write("# Generated by COLMAP - all images, no clustering.\n")
        f.write("level 1\ncsize 2\nthreshold 0.7\nwsize 7\n"
                "minImageNum 3\n")
        f.write(f"CPU {multiprocessing.cpu_count()}\n")
        f.write("setEdge 0\nuseBound 0\nuseVisData 1\nsequence -1\n"
                "maxAngle 10\nquad 2.0\n")
        f.write(f"timages {len(reg_ids)}" +
                "".join(f" {i}" for i in range(len(reg_ids))) + "\n")
        f.write("oimages 0\n")

    with open(os.path.join(output_path, "run-pmvs.sh"), "w") as f:
        f.write("# You must set $PMVS_EXE_PATH to\n"
                "# the directory containing the CMVS-PMVS executables.\n"
                "$PMVS_EXE_PATH/pmvs2 pmvs/ option-all\n")
    with open(os.path.join(output_path, "run-cmvs-pmvs.sh"), "w") as f:
        f.write("# You must set $PMVS_EXE_PATH to\n"
                "# the directory containing the CMVS-PMVS executables.\n"
                "$PMVS_EXE_PATH/cmvs pmvs/\n"
                "$PMVS_EXE_PATH/genOption pmvs/\n")


def write_cmpmvs_workspace(output_path: str, reconstruction,
                           undistorted_images: dict):
    """CMP-MVS workspace: %05d.jpg + %05d_P.txt per registered image
    (ref: undistortion.cc CMPMVSUndistorter::Undistort :569-596)."""
    from PIL import Image as PILImage

    os.makedirs(output_path, exist_ok=True)
    for idx, iid in enumerate(reconstruction.registered_image_ids):
        image = reconstruction.images[iid]
        cam = reconstruction.cameras[image.camera_id]
        arr = undistorted_images.get(iid)
        if arr is not None:
            PILImage.fromarray(arr).convert("RGB").save(
                os.path.join(output_path, f"{idx + 1:05d}.jpg"))
        with open(os.path.join(output_path, f"{idx + 1:05d}_P.txt"),
                  "w") as f:
            f.write(_projection_matrix_text(cam, image.qvec, image.tvec))
