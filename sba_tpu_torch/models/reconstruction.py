"""Scene model: host `Reconstruction` container + dense `SceneArrays` view.

Port of the part of ``sba_tpu/models/reconstruction.py`` that global
bundle adjustment needs: construction and registration, reprojection
errors, COLMAP IO and the dense view. `Reconstruction` is a host-side
dict container; `SceneArrays` is the dense struct-of-arrays numpy view
the solvers consume.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat
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

    # -- reprojection errors ----------------------------------------------

    def _all_observation_errors(self):
        """One batched reprojection pass over every observation.

        Returns (pids [O], image_ids [O], kp_idx [O], err_sq [O], z [O])
        numpy arrays; projection runs through the port's camera models
        on the CPU, one call per camera model.
        """
        pids, iids, idxs, xyzs, xys = [], [], [], [], []
        for pid, p in self.points3D.items():
            for image_id, idx in zip(p.image_ids, p.point2D_idxs):
                pids.append(pid)
                iids.append(int(image_id))
                idxs.append(int(idx))
                xyzs.append(p.xyz)
                xys.append(self.images[int(image_id)].xys[int(idx)])
        if not pids:
            z = np.zeros(0)
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int64), z, z)
        pids = np.asarray(pids, np.int64)
        iids = np.asarray(iids, np.int64)
        idxs = np.asarray(idxs, np.int64)
        xyzs = np.stack(xyzs)
        xys = np.stack(xys)

        img_list = sorted({int(i) for i in iids})
        row_of = {iid: k for k, iid in enumerate(img_list)}
        rows = np.asarray([row_of[int(i)] for i in iids])
        Rts = np.stack([np_quat_to_rotmat(self.images[i].qvec)
                        for i in img_list])
        ts = np.stack([self.images[i].tvec for i in img_list])
        p_cam = np.einsum("oij,oj->oi", Rts[rows], xyzs) + ts[rows]
        z = p_cam[:, 2]
        safe_z = np.where(np.abs(z) > 1e-12, z, 1e-12)
        uv = p_cam[:, :2] / safe_z[:, None]

        xy = np.empty_like(uv)
        cam_of_img = {i: self.images[i].camera_id for i in img_list}
        model_of = np.asarray(
            [self.cameras[cam_of_img[int(i)]].model_id for i in iids])
        for mid in np.unique(model_of):
            sel = model_of == mid
            prm = np.stack([self.cameras[cam_of_img[int(i)]].params
                            for i in iids[sel]])
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

    # -- dense view --------------------------------------------------------

    def to_arrays(self, image_ids: Optional[Sequence[int]] = None
                  ) -> SceneArrays:
        """Dense SoA view over the given (default: registered) images and
        every 3D point they observe."""
        if image_ids is None:
            image_ids = list(self.registered_image_ids)
        image_ids = list(image_ids)
        image_row = {iid: i for i, iid in enumerate(image_ids)}

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

        pid_set = set()
        for iid in image_ids:
            for pid in self.images[iid].point3D_ids:
                if pid != -1:
                    pid_set.add(int(pid))
        point_ids = sorted(pid_set)
        point_row = {pid: i for i, pid in enumerate(point_ids)}
        points = (np.stack([self.points3D[p].xyz for p in point_ids])
                  if point_ids else np.zeros((0, 3)))

        obs_image, obs_point, obs_xy = [], [], []
        for iid in image_ids:
            im = self.images[iid]
            for idx in np.nonzero(im.point3D_ids != -1)[0]:
                pid = int(im.point3D_ids[idx])
                if pid in point_row:
                    obs_image.append(image_row[iid])
                    obs_point.append(point_row[pid])
                    obs_xy.append(im.xys[idx])

        return SceneArrays(
            image_ids=np.array(image_ids, dtype=np.int64),
            qvecs=np.asarray(qvecs, dtype=np.float64),
            tvecs=np.asarray(tvecs, dtype=np.float64),
            image_camera_idx=image_cam,
            camera_ids=np.array(cam_ids, dtype=np.int64),
            camera_model_ids=cam_model_ids,
            camera_params=cam_params,
            point_ids=np.array(point_ids, dtype=np.int64),
            points=np.asarray(points, dtype=np.float64),
            obs_image=np.array(obs_image, dtype=np.int32),
            obs_point=np.array(obs_point, dtype=np.int32),
            obs_xy=(np.stack(obs_xy) if obs_xy
                    else np.zeros((0, 2))).astype(np.float64),
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
