"""Scene model: host `Reconstruction` container + dense `SceneArrays` view.

Port of ``sba_tpu/models/reconstruction.py``: construction,
registration and deregistration, the observation and track edits (add,
delete, merge), the statistics, reprojection errors, the point and image
filters, the bounding box and crop, color extraction (the pixels are
sampled and averaged on the device), COLMAP IO, the PLY, NVM, Bundler,
CAM, Recon3D and VRML exporters (the same files as sba_tpu's, byte for
byte) and the dense view.
`Reconstruction` is a host-side dict container; `SceneArrays` is the
dense struct-of-arrays numpy view the solvers consume.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.geometry.quaternions import (np_quat_rotate,
                                                np_quat_to_rotmat)
from sba_tpu_torch.io import colmap_models as cm
from sba_tpu_torch.io.colmap_models import Camera, Image, Point3D


@dataclass
class SceneArrays:
    """Dense SoA view of a reconstruction (numpy, host).

    Images 0..N-1, cameras 0..C-1 and points 0..P-1 are dense
    re-indexings of the sparse COLMAP ids (mapping kept alongside).
    """

    image_ids: np.ndarray        # [N] original ids
    qvecs: np.ndarray            # [N, 4] w-first, world->camera
    tvecs: np.ndarray            # [N, 3]
    image_camera_idx: np.ndarray  # [N] -> camera row
    camera_ids: np.ndarray       # [C]
    camera_model_ids: np.ndarray  # [C]
    camera_params: np.ndarray    # [C, MAX_NUM_PARAMS]
    point_ids: np.ndarray        # [P]
    points: np.ndarray           # [P, 3]
    obs_image: np.ndarray        # [O] image row index
    obs_point: np.ndarray        # [O] point row index
    obs_xy: np.ndarray           # [O, 2]
    image_names: List[str] = field(default_factory=list)

    @property
    def num_images(self):
        return len(self.image_ids)

    @property
    def num_points(self):
        return len(self.point_ids)

    @property
    def num_observations(self):
        return len(self.obs_image)

    def obs_camera_idx(self):
        return self.image_camera_idx[self.obs_image]


class Reconstruction:
    """Host scene container with COLMAP-compatible IO."""

    def __init__(self):
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, Image] = {}
        self.points3D: Dict[int, Point3D] = {}
        self.registered_image_ids: List[int] = []
        self._next_point3D_id = 1

    # -- construction ------------------------------------------------------

    def add_camera(self, camera: Camera):
        if camera.camera_id in self.cameras:
            raise ValueError(f"duplicate camera id {camera.camera_id}")
        self.cameras[camera.camera_id] = camera

    def add_image(self, image: Image, registered: bool = False):
        if image.image_id in self.images:
            raise ValueError(f"duplicate image id {image.image_id}")
        self.images[image.image_id] = image
        if registered:
            self.register_image(image.image_id)

    def register_image(self, image_id: int):
        if image_id not in self.registered_image_ids:
            self.registered_image_ids.append(image_id)

    def deregister_image(self, image_id: int):
        """Remove all observations of an image and unregister it
        (ref: reconstruction.cc DeRegisterImage)."""
        im = self.images[image_id]
        for idx, pid in enumerate(im.point3D_ids):
            if pid != -1:
                self._remove_observation(int(pid), image_id, idx)
        im.point3D_ids = np.full_like(im.point3D_ids, -1)
        if image_id in self.registered_image_ids:
            self.registered_image_ids.remove(image_id)

    def is_registered(self, image_id: int) -> bool:
        return image_id in self.registered_image_ids

    def add_point3d(self, xyz, track: Sequence[Tuple[int, int]],
                    rgb=(0, 0, 0), error=-1.0) -> int:
        pid = self._next_point3D_id
        self._next_point3D_id += 1
        image_ids = np.array([t[0] for t in track], dtype=np.int32)
        p2d = np.array([t[1] for t in track], dtype=np.int32)
        self.points3D[pid] = Point3D(
            pid, np.asarray(xyz, dtype=np.float64),
            np.asarray(rgb, dtype=np.uint8), error, image_ids, p2d)
        for image_id, idx in track:
            self.images[image_id].point3D_ids[idx] = pid
        return pid

    # -- observation edits ------------------------------------------------

    def add_observation(self, point3D_id: int, image_id: int,
                        point2D_idx: int):
        p = self.points3D[point3D_id]
        p.image_ids = np.append(p.image_ids, np.int32(image_id))
        p.point2D_idxs = np.append(p.point2D_idxs, np.int32(point2D_idx))
        self.images[image_id].point3D_ids[point2D_idx] = point3D_id

    def _remove_observation(self, point3D_id: int, image_id: int,
                            point2D_idx: int):
        p = self.points3D.get(point3D_id)
        if p is None:
            return
        keep = ~((p.image_ids == image_id) & (p.point2D_idxs == point2D_idx))
        p.image_ids = p.image_ids[keep]
        p.point2D_idxs = p.point2D_idxs[keep]
        if len(p.image_ids) == 0:
            del self.points3D[point3D_id]

    def delete_observation(self, image_id: int, point2D_idx: int):
        """Unlink one observation; a track left shorter than 2 goes."""
        pid = int(self.images[image_id].point3D_ids[point2D_idx])
        if pid == -1:
            return
        self.images[image_id].point3D_ids[point2D_idx] = -1
        self._remove_observation(pid, image_id, point2D_idx)
        p = self.points3D.get(pid)
        if p is not None and len(p.image_ids) < 2:
            self.delete_point3d(pid)

    def delete_point3d(self, point3D_id: int):
        p = self.points3D.pop(point3D_id, None)
        if p is None:
            return
        for image_id, idx in zip(p.image_ids, p.point2D_idxs):
            self.images[int(image_id)].point3D_ids[int(idx)] = -1

    def merge_points(self, pid1: int, pid2: int) -> Optional[int]:
        """Merge two 3D points at their track-length-weighted mean
        position into a new point (ref: reconstruction.cc MergePoints3D)."""
        p1 = self.points3D.get(pid1)
        p2 = self.points3D.get(pid2)
        if p1 is None or p2 is None:
            return None
        n1, n2 = len(p1.image_ids), len(p2.image_ids)
        xyz = (n1 * p1.xyz + n2 * p2.xyz) / (n1 + n2)
        rgb = ((n1 * p1.rgb + n2 * p2.rgb) / (n1 + n2)).astype(np.uint8)
        track = [(int(i), int(j))
                 for i, j in zip(p1.image_ids, p1.point2D_idxs)]
        track += [(int(i), int(j))
                  for i, j in zip(p2.image_ids, p2.point2D_idxs)]
        self.delete_point3d(pid1)
        self.delete_point3d(pid2)
        return self.add_point3d(xyz, track, rgb=rgb)

    # -- statistics (ref: reconstruction.cc ComputeMean*) -----------------

    def num_points3d(self) -> int:
        return len(self.points3D)

    def num_registered_images(self) -> int:
        return len(self.registered_image_ids)

    def compute_num_observations(self) -> int:
        return sum(len(p.image_ids) for p in self.points3D.values())

    def compute_mean_track_length(self) -> float:
        if not self.points3D:
            return 0.0
        return self.compute_num_observations() / len(self.points3D)

    def compute_mean_observations_per_reg_image(self) -> float:
        n = self.num_registered_images()
        return self.compute_num_observations() / n if n else 0.0

    # -- filters (ref: reconstruction.cc FilterPoints3D*, FilterImages) ---

    def filter_points_large_reprojection_error(self,
                                               max_error_px: float) -> int:
        """Delete observations with reprojection error above the threshold
        or behind the camera; short tracks go with them (ref:
        reconstruction.cc FilterPoints3DWithLargeReprojectionError)."""
        max_sq = max_error_px * max_error_px
        _pids, iids, idxs, err_sq, z = self._all_observation_errors()
        bad = (z <= 0) | (err_sq > max_sq)
        for image_id, idx in zip(iids[bad], idxs[bad]):
            self.delete_observation(int(image_id), int(idx))
        return int(bad.sum())

    def filter_points_min_tri_angle(self, min_tri_angle_deg: float) -> int:
        """Delete points whose largest pairwise triangulation angle over
        the track is below the threshold; returns the observations
        removed (ref: reconstruction.cc
        FilterPoints3DWithSmallTriangulationAngle)."""
        centers = {}
        for iid in self.registered_image_ids:
            im = self.images[iid]
            q_inv = np.array([im.qvec[0], -im.qvec[1], -im.qvec[2],
                              -im.qvec[3]])
            centers[iid] = -np_quat_rotate(q_inv, im.tvec)
        min_cos = np.cos(np.deg2rad(min_tri_angle_deg))
        num_filtered = 0
        for pid in list(self.points3D.keys()):
            p = self.points3D.get(pid)
            if p is None:
                continue
            rays = []
            for image_id in p.image_ids:
                c = centers.get(int(image_id))
                if c is None:
                    continue
                r = p.xyz - c
                n = np.linalg.norm(r)
                if n > 1e-12:
                    rays.append(r / n)
            ok = any(abs(float(rays[i] @ rays[j])) < min_cos
                     for i in range(len(rays))
                     for j in range(i + 1, len(rays)))
            if not ok:
                num_filtered += len(p.image_ids)
                self.delete_point3d(pid)
        return num_filtered

    def filter_images(self, min_focal_length_ratio: float = 0.1,
                      max_focal_length_ratio: float = 10.0,
                      max_extra_param: float = 100.0) -> list:
        """Deregister images with degenerate intrinsics
        (ref: reconstruction.cc FilterImages / camera HasBogusParams)."""
        filtered = []
        for iid in list(self.registered_image_ids):
            im = self.images[iid]
            cam = self.cameras[im.camera_id]
            spec = camera_models.model_by_id(cam.model_id)
            ratio_ok = True
            for fi in spec.focal_idxs:
                ratio = cam.params[fi] / max(cam.width, cam.height)
                if not (min_focal_length_ratio < ratio
                        < max_focal_length_ratio):
                    ratio_ok = False
            extra_ok = all(abs(cam.params[i]) <= max_extra_param
                           for i in spec.extra_idxs)
            if not (ratio_ok and extra_ok):
                self.deregister_image(iid)
                filtered.append(iid)
        return filtered

    def filter_observations_with_negative_depth(self) -> int:
        """Delete observations whose point lies behind its camera; returns
        how many (ref: src/controllers/semantic_bundle_adjustment.cc:
        96-101)."""
        num_filtered = 0
        for image_id in list(self.registered_image_ids):
            im = self.images[image_id]
            tri = np.nonzero(im.point3D_ids != -1)[0]
            if len(tri) == 0:
                continue
            xyz = np.stack([self.points3D[int(im.point3D_ids[i])].xyz
                            for i in tri])
            p_cam = np_quat_rotate(im.qvec, xyz) + im.tvec
            for idx in tri[p_cam[:, 2] <= 0]:
                self.delete_observation(image_id, int(idx))
                num_filtered += 1
        return num_filtered

    # -- reprojection errors ----------------------------------------------

    def _all_observation_errors(self):
        """One batched reprojection pass over every observation.

        Returns (pids [O], image_ids [O], kp_idx [O], err_sq [O], z [O])
        numpy arrays; projection runs through the port's camera models
        on the CPU, one call per camera model.
        """
        pts = list(self.points3D.values())
        lens = np.fromiter((len(p.image_ids) for p in pts), np.int64,
                           len(pts))
        if not lens.sum():
            z = np.zeros(0)
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int64), z, z)
        # Every observation in the order of the points, then of each
        # track (sba_tpu's loop), gathered in bulk.
        pids = np.repeat(np.fromiter(self.points3D.keys(), np.int64,
                                     len(pts)), lens)
        iids = np.concatenate([p.image_ids for p in pts]).astype(np.int64)
        idxs = np.concatenate([p.point2D_idxs for p in pts]).astype(np.int64)
        xyzs = np.repeat(np.stack([p.xyz for p in pts]), lens, axis=0)
        xys = np.empty((len(iids), 2))
        for i in np.unique(iids):
            sel = iids == i
            xys[sel] = self.images[int(i)].xys[idxs[sel]]

        img_arr = np.unique(iids)
        img_list = [int(i) for i in img_arr]
        rows = np.searchsorted(img_arr, iids)
        Rts = np.stack([np_quat_to_rotmat(self.images[i].qvec)
                        for i in img_list])
        ts = np.stack([self.images[i].tvec for i in img_list])
        p_cam = np.einsum("oij,oj->oi", Rts[rows], xyzs) + ts[rows]
        z = p_cam[:, 2]
        safe_z = np.where(np.abs(z) > 1e-12, z, 1e-12)
        uv = p_cam[:, :2] / safe_z[:, None]

        xy = np.empty_like(uv)
        cams = [self.cameras[self.images[i].camera_id] for i in img_list]
        img_model = np.asarray([c.model_id for c in cams])
        model_of = img_model[rows]
        for mid in np.unique(model_of):
            sel = model_of == mid
            grp = np.nonzero(img_model == mid)[0]
            table = np.stack([np.asarray(cams[g].params) for g in grp])
            prm = table[np.searchsorted(grp, rows[sel])]
            xy[sel] = camera_models.world_to_image(
                int(mid), torch.from_numpy(prm),
                torch.from_numpy(uv[sel])).numpy()
        err_sq = np.sum((xy - xys) ** 2, axis=1)
        return pids, iids, idxs, err_sq, z

    def update_point_errors(self) -> None:
        """Set every Point3D.error to its track's mean reprojection error."""
        pids, _, _, err_sq, _ = self._all_observation_errors()
        err = np.sqrt(err_sq)
        sums: Dict[int, float] = {}
        counts: Dict[int, int] = {}
        for pid, e in zip(pids, err):
            sums[int(pid)] = sums.get(int(pid), 0.0) + float(e)
            counts[int(pid)] = counts.get(int(pid), 0) + 1
        for pid, p in self.points3D.items():
            c = counts.get(pid, 0)
            p.error = sums[pid] / c if c else -1.0

    def compute_mean_reprojection_error(self) -> float:
        if any(p.error < 0 for p in self.points3D.values()):
            self.update_point_errors()
        errs = [p.error for p in self.points3D.values() if p.error >= 0]
        return float(np.mean(errs)) if errs else 0.0

    # -- IO ----------------------------------------------------------------

    @classmethod
    def read(cls, path, ext: Optional[str] = None) -> "Reconstruction":
        rec = cls()
        cameras, images, points = cm.read_model(path, ext)
        rec.cameras = cameras
        rec.images = images
        rec.points3D = points
        # All images with a pose in the model are considered registered.
        rec.registered_image_ids = list(images.keys())
        rec._next_point3D_id = (max(points.keys()) + 1) if points else 1
        return rec

    def write(self, path, ext=".bin") -> None:
        # Only registered images are serialized.
        reg = set(self.registered_image_ids)
        images = {iid: im for iid, im in self.images.items() if iid in reg}
        cm.write_model(self.cameras, images, self.points3D, path, ext)

    def compute_bounding_box(self, p0: float = 0.0, p1: float = 1.0):
        """Percentile bounding box over the 3D points
        (ref: reconstruction.cc ComputeBoundingBox)."""
        if not self.points3D:
            return np.zeros(3), np.zeros(3)
        pts = np.stack([p.xyz for p in self.points3D.values()])
        lo = np.quantile(pts, p0, axis=0)
        hi = np.quantile(pts, p1, axis=0)
        return lo, hi

    def crop(self, bbox) -> "Reconstruction":
        """New reconstruction containing the points inside bbox
        = (lo [3], hi [3]) and the images observing them; images keep
        their pose, registration limited to images with >= 1 surviving
        point (ref: reconstruction.cc Crop)."""
        import copy

        lo, hi = np.asarray(bbox[0]), np.asarray(bbox[1])
        out = Reconstruction()
        out.cameras = copy.deepcopy(self.cameras)
        for iid, im in self.images.items():
            im2 = copy.deepcopy(im)
            im2.point3D_ids = np.full_like(im.point3D_ids, -1)
            out.images[iid] = im2
        reg = set()
        for pid, p in self.points3D.items():
            if np.all(p.xyz >= lo) and np.all(p.xyz <= hi):
                track = [(int(i), int(ix))
                         for i, ix in zip(p.image_ids, p.point2D_idxs)]
                new_pid = out.add_point3d(p.xyz.copy(), track,
                                          rgb=tuple(p.rgb),
                                          error=p.error)
                del new_pid
                reg.update(int(i) for i in p.image_ids)
        out.registered_image_ids = [i for i in self.registered_image_ids
                                    if i in reg]
        return out

    def extract_colors(self, image_path: str, device="cuda") -> int:
        """Mean RGB over the track's observations for every 3D point
        (ref: reconstruction.cc ExtractColorsForAllImages): each
        registered image's pixels at its triangulated keypoints (nearest
        pixel) are gathered on `device` and summed per point there in
        float64 (exact for 8-bit values, so the means equal sba_tpu's).
        Returns the number of colored points."""
        import os

        from PIL import Image as PILImage

        pids = list(self.points3D)
        row_of = {pid: i for i, pid in enumerate(pids)}
        sums = torch.zeros((len(pids), 3), dtype=torch.float64,
                           device=device)
        counts = torch.zeros(len(pids), dtype=torch.float64, device=device)
        for iid in self.registered_image_ids:
            im = self.images[iid]
            path = os.path.join(image_path, im.name)
            if not os.path.exists(path):
                continue
            with PILImage.open(path) as f:
                rgb = torch.as_tensor(np.array(f.convert("RGB")),
                                      device=device)
            h, w = rgb.shape[:2]
            tri = np.nonzero(im.point3D_ids != -1)[0]
            rows = [row_of.get(int(im.point3D_ids[i]), -1) for i in tri]
            keep = np.array([r >= 0 for r in rows], bool)
            if not keep.any():
                continue
            xy = torch.as_tensor(im.xys[tri[keep]], dtype=torch.float64,
                                 device=device)
            xi = torch.clamp(torch.round(xy[:, 0] - 0.5), 0, w - 1).long()
            yi = torch.clamp(torch.round(xy[:, 1] - 0.5), 0, h - 1).long()
            r = torch.as_tensor(np.asarray(rows)[keep], device=device)
            sums.index_add_(0, r, rgb[yi, xi].to(torch.float64))
            counts.index_add_(0, r, torch.ones_like(r, dtype=torch.float64))
        has = counts > 0
        mean = torch.clamp(sums / torch.clamp(counts, min=1)[:, None], 0, 255)
        mean = mean.to(torch.uint8).cpu().numpy()
        has = has.cpu().numpy()
        for i, pid in enumerate(pids):
            if has[i]:
                self.points3D[pid].rgb = mean[i]
        return int(has.sum())

    # -- export formats (ref: reconstruction.cc ExportNVM/Bundler/Cam/
    #    Recon3D/VRML; consumed by VisualSfM / Bundler / MVE / CMVS /
    #    Capturing Reality / VRML viewers) ---------------------------------

    def _distortion_k(self, camera, skip_distortion, negate=False,
                      allow_k2=True):
        """(k1, k2) for the Bundler-family exporters; None if model
        unsupported."""
        spec = camera_models.model_by_id(camera.model_id)
        if skip_distortion or spec.name in ("SIMPLE_PINHOLE", "PINHOLE"):
            return 0.0, 0.0
        if spec.name == "SIMPLE_RADIAL":
            k1 = float(camera.params[spec.extra_idxs[0]])
            return (-k1 if negate else k1), 0.0
        if allow_k2 and spec.name == "RADIAL":
            k1 = float(camera.params[spec.extra_idxs[0]])
            k2 = float(camera.params[spec.extra_idxs[1]])
            return ((-k1, -k2) if negate else (k1, k2))
        return None

    def _reg_images_and_centers(self):
        out = []
        for iid in self.registered_image_ids:
            im = self.images[iid]
            q_inv = np.array([im.qvec[0], -im.qvec[1], -im.qvec[2],
                              -im.qvec[3]])
            center = -np_quat_rotate(q_inv, im.tvec)
            R = np_quat_to_rotmat(im.qvec)
            out.append((iid, im, center, R))
        return out

    def export_nvm(self, path, skip_distortion=False) -> bool:
        """VisualSfM NVM_V3 (ref: reconstruction.cc:813-899 ExportNVM)."""
        rows = self._reg_images_and_centers()
        idx_of = {}
        lines = ["NVM_V3 ", " ", f"{len(rows)}  "]
        for i, (iid, im, center, _R) in enumerate(rows):
            cam = self.cameras[im.camera_id]
            k = self._distortion_k(cam, skip_distortion, negate=True,
                                   allow_k2=False)
            if k is None:
                print("WARNING: NVM only supports `SIMPLE_RADIAL` and "
                      "pinhole camera models.")
                return False
            q = im.qvec
            lines.append(
                f"{im.name} {cam.mean_focal_length():.17g} "
                f"{q[0]:.17g} {q[1]:.17g} {q[2]:.17g} {q[3]:.17g} "
                f"{center[0]:.17g} {center[1]:.17g} {center[2]:.17g} "
                f"{k[0]:.17g} 0")
            idx_of[iid] = i
        lines.append("")
        lines.append(str(len(self.points3D)))
        for p in self.points3D.values():
            obs = []
            seen = set()
            for img_id, p2d in zip(p.image_ids, p.point2D_idxs):
                img_id = int(img_id)
                if img_id in seen or img_id not in idx_of:
                    continue
                seen.add(img_id)
                xy = self.images[img_id].xys[int(p2d)]
                obs.append(f"{idx_of[img_id]} {int(p2d)} "
                           f"{xy[0]:.17g} {xy[1]:.17g}")
            lines.append(
                f"{p.xyz[0]:.17g} {p.xyz[1]:.17g} {p.xyz[2]:.17g} "
                f"{int(p.rgb[0])} {int(p.rgb[1])} {int(p.rgb[2])} "
                f"{len(obs)} " + " ".join(obs))
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return True

    def export_bundler(self, path, list_path, skip_distortion=False) -> bool:
        """Bundler v0.3 .out + image list (ref: reconstruction.cc:1087
        ExportBundler). Bundler's camera looks down -z; rows 2/3 of R and
        ty/tz are negated; 2D coords are principal-point-centered with +y
        up."""
        rows = [(iid, self.images[iid], np_quat_to_rotmat(
            self.images[iid].qvec)) for iid in self.registered_image_ids]
        idx_of = {iid: i for i, (iid, *_rest) in enumerate(rows)}
        lines = ["# Bundle file v0.3",
                 f"{len(rows)} {len(self.points3D)}"]
        names = []
        for iid, im, R in rows:
            cam = self.cameras[im.camera_id]
            k = self._distortion_k(cam, skip_distortion)
            if k is None:
                print("WARNING: Bundler only supports `SIMPLE_RADIAL`, "
                      "`RADIAL`, and pinhole camera models.")
                return False
            lines.append(f"{cam.mean_focal_length():.17g} "
                         f"{k[0]:.17g} {k[1]:.17g}")
            lines.append(f"{R[0,0]:.17g} {R[0,1]:.17g} {R[0,2]:.17g}")
            lines.append(f"{-R[1,0]:.17g} {-R[1,1]:.17g} {-R[1,2]:.17g}")
            lines.append(f"{-R[2,0]:.17g} {-R[2,1]:.17g} {-R[2,2]:.17g}")
            t = im.tvec
            lines.append(f"{t[0]:.17g} {-t[1]:.17g} {-t[2]:.17g}")
            names.append(im.name)
        for p in self.points3D.values():
            lines.append(f"{p.xyz[0]:.17g} {p.xyz[1]:.17g} {p.xyz[2]:.17g}")
            lines.append(f"{int(p.rgb[0])} {int(p.rgb[1])} {int(p.rgb[2])}")
            obs = [str(len(p.image_ids))]
            for img_id, p2d in zip(p.image_ids, p.point2D_idxs):
                img_id = int(img_id)
                if img_id not in idx_of:
                    continue
                im = self.images[img_id]
                cam = self.cameras[im.camera_id]
                spec = camera_models.model_by_id(cam.model_id)
                cx, cy = (cam.params[i] for i in spec.principal_idxs)
                xy = im.xys[int(p2d)]
                obs.append(f"{idx_of[img_id]} {int(p2d)} "
                           f"{xy[0] - cx:.17g} {cy - xy[1]:.17g}")
            lines.append(" ".join(obs))
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(list_path, "w") as f:
            f.write("\n".join(names) + "\n")
        return True

    def export_cam(self, path, skip_distortion=False) -> bool:
        """Per-image MVE .cam files (ref: reconstruction.cc:901
        ExportCam)."""
        import os

        for iid, im, _c, R in self._reg_images_and_centers():
            cam = self.cameras[im.camera_id]
            k = self._distortion_k(cam, skip_distortion)
            if k is None:
                print("WARNING: CAM only supports `SIMPLE_RADIAL`, "
                      "`RADIAL`, and pinhole camera models.")
                return False
            k1, k2 = k
            if k1 != 0.0 and k2 == 0.0:
                k2 = 1e-10
            spec = camera_models.model_by_id(cam.model_id)
            fi = spec.focal_idxs
            fx = float(cam.params[fi[0]])
            fy = float(cam.params[fi[-1]])
            if cam.width * fy < cam.height * fx:
                focal = fy / cam.height
            else:
                focal = fx / cam.width
            cx, cy = (float(cam.params[i]) for i in spec.principal_idxs)
            name = os.path.join(path,
                                os.path.splitext(im.name)[0] + ".cam")
            os.makedirs(os.path.dirname(name) or path, exist_ok=True)
            t = im.tvec
            with open(name, "w") as f:
                f.write(f"{t[0]:.17g} {t[1]:.17g} {t[2]:.17g} "
                        + " ".join(f"{R[i,j]:.17g}" for i in range(3)
                                   for j in range(3)) + "\n")
                f.write(f"{focal:.17g} {k1:.17g} {k2:.17g} "
                        f"{fy / fx:.17g} {cx / cam.width:.17g} "
                        f"{cy / cam.height:.17g}\n")
        return True

    def export_recon3d(self, path, skip_distortion=False) -> bool:
        """Recon3D directory (ref: reconstruction.cc:974 ExportRecon3D)."""
        import os

        base = os.path.join(path, "Recon")
        os.makedirs(base, exist_ok=True)
        rows = self._reg_images_and_centers()
        idx_of = {iid: i for i, (iid, *_r) in enumerate(rows)}
        synth = ["colmap 1.0", f"{len(rows)} {len(self.points3D)}"]
        img_list, img_map = [], []
        for i, (iid, im, _c, R) in enumerate(rows):
            cam = self.cameras[im.camera_id]
            k = self._distortion_k(cam, skip_distortion, negate=True)
            if k is None:
                print("WARNING: Recon3D only supports `SIMPLE_RADIAL`, "
                      "`RADIAL`, and pinhole camera models.")
                return False
            scale = 1.0 / max(cam.width, cam.height)
            synth.append(f"{scale * cam.mean_focal_length():.17g} "
                         f"{k[0]:.17g} {k[1]:.17g}")
            for r in range(3):
                synth.append(" ".join(f"{R[r,j]:.17g}" for j in range(3)))
            t = im.tvec
            synth.append(f"{t[0]:.17g} {t[1]:.17g} {t[2]:.17g}")
            img_list.append(im.name)
            img_list.append(f"{cam.width} {cam.height}")
            img_map.append(str(i))
        for p in self.points3D.values():
            synth.append(f"{p.xyz[0]:.17g} {p.xyz[1]:.17g} "
                         f"{p.xyz[2]:.17g}")
            synth.append(f"{int(p.rgb[0])} {int(p.rgb[1])} "
                         f"{int(p.rgb[2])}")
            obs = []
            seen = set()
            for img_id, p2d in zip(p.image_ids, p.point2D_idxs):
                img_id = int(img_id)
                if img_id in seen or img_id not in idx_of:
                    continue
                seen.add(img_id)
                im = self.images[img_id]
                cam = self.cameras[im.camera_id]
                spec = camera_models.model_by_id(cam.model_id)
                cx, cy = (cam.params[i] for i in spec.principal_idxs)
                scale = 1.0 / max(cam.width, cam.height)
                xy = im.xys[int(p2d)]
                obs.append(f"{idx_of[img_id]} {int(p2d)} -1.0 "
                           f"{(xy[0] - cx) * scale:.17g} "
                           f"{(xy[1] - cy) * scale:.17g}")
            synth.append(f"{len(obs)} " + " ".join(obs))
        with open(os.path.join(base, "synth_0.out"), "w") as f:
            f.write("\n".join(synth) + "\n")
        with open(os.path.join(base, "urd-images.txt"), "w") as f:
            f.write("\n".join(img_list) + "\n")
        with open(os.path.join(base, "imagemap_0.txt"), "w") as f:
            f.write("\n".join(img_map) + "\n")
        return True

    def export_vrml(self, images_path, points_path, image_scale=1.0,
                    image_rgb=(1.0, 0.0, 0.0)) -> None:
        """VRML camera frusta + colored point cloud
        (ref: reconstruction.cc:1194 ExportVRML)."""
        six = image_scale * 0.15
        siy = image_scale * 0.1
        frustum = np.array([
            [-six, -siy, 2 * six], [six, -siy, 2 * six],
            [six, siy, 2 * six], [-six, siy, 2 * six], [0, 0, 0],
            [-six / 3, -siy / 3, 2 * six], [six / 3, -siy / 3, 2 * six],
            [six / 3, siy / 3, 2 * six], [-six / 3, siy / 3, 2 * six]])
        with open(images_path, "w") as f:
            for _iid, im, center, R in self._reg_images_and_centers():
                pts = frustum @ R + center  # camera->world: R^T x + c
                f.write("Shape{\n appearance Appearance {\n"
                        "  material DEF Default-ffRffGffB Material {\n"
                        "  ambientIntensity 0\n"
                        f"  diffuseColor  {image_rgb[0]} {image_rgb[1]}"
                        f" {image_rgb[2]}\n"
                        "  emissiveColor 0.1 0.1 0.1 } }\n"
                        " geometry IndexedFaceSet {\n solid FALSE \n"
                        " colorPerVertex TRUE \n ccw TRUE \n"
                        " coord Coordinate {\n point [\n")
                for p in pts:
                    f.write(f" {p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n")
                f.write(" ]\n }\n coordIndex [\n"
                        " 0, 1, 2, 3, -1\n 5, 6, 4, -1\n"
                        " 6, 7, 4, -1\n 7, 8, 4, -1\n 8, 5, 4, -1\n"
                        " ]\n }\n}\n")
        with open(points_path, "w") as f:
            f.write("#VRML V2.0 utf8\n"
                    "Background { skyColor [1.0 1.0 1.0] }\n"
                    "Shape{ appearance Appearance {\n"
                    " material Material { emissiveColor 1 1 1} }\n"
                    " geometry PointSet {\n coord Coordinate {\n"
                    "  point [\n")
            for p in self.points3D.values():
                f.write(f"{p.xyz[0]:.6g} {p.xyz[1]:.6g} {p.xyz[2]:.6g}\n")
            f.write("  ] }\n color Color { color [\n")
            for p in self.points3D.values():
                f.write(f"{p.rgb[0]/255:.3g} {p.rgb[1]/255:.3g} "
                        f"{p.rgb[2]/255:.3g}\n")
            f.write(" ] } } }\n")

    def export_ply(self, path) -> None:
        cm.export_ply(self.points3D, path)

    # -- dense view --------------------------------------------------------

    def to_arrays(self, image_ids: Optional[Sequence[int]] = None
                  ) -> SceneArrays:
        """Dense SoA view over the given (default: registered) images and
        every 3D point they observe."""
        if image_ids is None:
            image_ids = list(self.registered_image_ids)
        image_ids = list(image_ids)

        cam_ids = sorted({self.images[i].camera_id for i in image_ids})
        cam_row = {cid: i for i, cid in enumerate(cam_ids)}

        qvecs = (np.stack([self.images[i].qvec for i in image_ids])
                 if image_ids else np.zeros((0, 4)))
        tvecs = (np.stack([self.images[i].tvec for i in image_ids])
                 if image_ids else np.zeros((0, 3)))
        image_cam = np.array([cam_row[self.images[i].camera_id]
                              for i in image_ids], dtype=np.int32)

        cam_model_ids = np.array([self.cameras[c].model_id for c in cam_ids],
                                 dtype=np.int32)
        cam_params = np.zeros((len(cam_ids), camera_models.MAX_NUM_PARAMS))
        for c in cam_ids:
            p = self.cameras[c].params
            cam_params[cam_row[c], : len(p)] = p

        # Every observed point, then every observation image by image in
        # keypoint order (sba_tpu's loops), gathered in bulk.
        tri = [np.nonzero(self.images[iid].point3D_ids != -1)[0]
               for iid in image_ids]
        obs_pid = (np.concatenate([self.images[iid].point3D_ids[t]
                                   for iid, t in zip(image_ids, tri)])
                   .astype(np.int64) if image_ids else np.zeros(0, np.int64))
        point_ids = np.unique(obs_pid)
        points = (np.stack([self.points3D[int(p)].xyz for p in point_ids])
                  if len(point_ids) else np.zeros((0, 3)))
        obs_image = np.repeat(np.arange(len(image_ids)),
                              [len(t) for t in tri])
        obs_point = np.searchsorted(point_ids, obs_pid)
        obs_xy = (np.concatenate([np.asarray(self.images[iid].xys,
                                             np.float64)[t]
                                  for iid, t in zip(image_ids, tri)])
                  if len(obs_pid) else np.zeros((0, 2)))

        return SceneArrays(
            image_ids=np.array(image_ids, dtype=np.int64),
            qvecs=np.asarray(qvecs, dtype=np.float64),
            tvecs=np.asarray(tvecs, dtype=np.float64),
            image_camera_idx=image_cam,
            camera_ids=np.array(cam_ids, dtype=np.int64),
            camera_model_ids=cam_model_ids,
            camera_params=cam_params,
            point_ids=point_ids,
            points=np.asarray(points, dtype=np.float64),
            obs_image=np.array(obs_image, dtype=np.int32),
            obs_point=np.array(obs_point, dtype=np.int32),
            obs_xy=obs_xy,
            image_names=[self.images[i].name for i in image_ids],
        )

    def update_from_arrays(self, arrays: SceneArrays, qvecs=None, tvecs=None,
                           points=None, camera_params=None) -> None:
        """Write optimized values back into the sparse containers."""
        if qvecs is not None:
            for row, iid in enumerate(arrays.image_ids):
                self.images[int(iid)].qvec = np.asarray(qvecs[row],
                                                        dtype=np.float64)
        if tvecs is not None:
            for row, iid in enumerate(arrays.image_ids):
                self.images[int(iid)].tvec = np.asarray(tvecs[row],
                                                        dtype=np.float64)
        if points is not None:
            for row, pid in enumerate(arrays.point_ids):
                self.points3D[int(pid)].xyz = np.asarray(points[row],
                                                         dtype=np.float64)
        if camera_params is not None:
            for row, cid in enumerate(arrays.camera_ids):
                k = len(self.cameras[int(cid)].params)
                self.cameras[int(cid)].params = np.asarray(
                    camera_params[row][:k], dtype=np.float64)
