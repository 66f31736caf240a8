"""COLMAP sparse-model IO: cameras/images/points3D in binary and text.

Port of ``sba_tpu/io/colmap_models.py``; it reads the model registry of
the port's own ``geometry.camera_models``.

Format parity with the reference's `Reconstruction::Read/Write{Binary,Text}`
(ref: src/base/reconstruction.cc:733-767 and
scripts/python/read_write_model.py), so models interchange directly with
COLMAP tooling. Host-side numpy only — device code never touches files.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from sba_tpu_torch.geometry import camera_models


@dataclass
class Camera:
    camera_id: int
    model_id: int
    width: int
    height: int
    params: np.ndarray  # [num_params] float64

    @property
    def model_name(self) -> str:
        return camera_models.model_by_id(self.model_id).name


@dataclass
class Image:
    image_id: int
    qvec: np.ndarray  # [4] (w, x, y, z), world->camera
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray  # [N, 2] keypoint coords
    point3D_ids: np.ndarray  # [N] int64, -1 = not triangulated

    def num_points3d(self) -> int:
        return int(np.sum(self.point3D_ids != -1))


@dataclass
class Point3D:
    point3D_id: int
    xyz: np.ndarray  # [3]
    rgb: np.ndarray  # [3] uint8
    error: float
    image_ids: np.ndarray  # [track_len]
    point2D_idxs: np.ndarray  # [track_len]


Cameras = Dict[int, Camera]
Images = Dict[int, Image]
Points3D = Dict[int, Point3D]

INVALID_POINT3D = -1  # kInvalidPoint3DId is uint64 max in C++; -1 as int64.


def _read_bytes(f, fmt):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise IOError("unexpected EOF in COLMAP binary file")
    return struct.unpack(fmt, data)


# ---------------------------------------------------------------------------
# Binary format
# ---------------------------------------------------------------------------

def read_cameras_binary(path) -> Cameras:
    cameras: Cameras = {}
    with open(path, "rb") as f:
        (num,) = _read_bytes(f, "<Q")
        for _ in range(num):
            camera_id, model_id = _read_bytes(f, "<ii")
            width, height = _read_bytes(f, "<QQ")
            k = camera_models.model_by_id(model_id).num_params
            params = np.array(_read_bytes(f, f"<{k}d"), dtype=np.float64)
            cameras[camera_id] = Camera(camera_id, model_id, width, height, params)
    return cameras


def write_cameras_binary(cameras: Cameras, path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            f.write(struct.pack("<ii", cam.camera_id, cam.model_id))
            f.write(struct.pack("<QQ", cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params.tolist()))


def read_images_binary(path) -> Images:
    images: Images = {}
    with open(path, "rb") as f:
        (num,) = _read_bytes(f, "<Q")
        for _ in range(num):
            (image_id,) = _read_bytes(f, "<i")
            qvec = np.array(_read_bytes(f, "<4d"))
            tvec = np.array(_read_bytes(f, "<3d"))
            (camera_id,) = _read_bytes(f, "<i")
            name_chars = []
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_chars.append(c)
            name = b"".join(name_chars).decode("utf-8")
            (num_pts,) = _read_bytes(f, "<Q")
            if num_pts > 0:
                data = np.frombuffer(f.read(24 * num_pts), dtype=np.float64).reshape(num_pts, 3)
                xys = data[:, :2].copy()
                ids = data[:, 2].view(np.int64).copy()
            else:
                xys = np.zeros((0, 2))
                ids = np.zeros((0,), dtype=np.int64)
            images[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def write_images_binary(images: Images, path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *im.qvec.tolist()))
            f.write(struct.pack("<3d", *im.tvec.tolist()))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = im.xys.shape[0]
            f.write(struct.pack("<Q", n))
            if n > 0:
                data = np.empty((n, 3), dtype=np.float64)
                data[:, :2] = im.xys
                data[:, 2] = np.asarray(im.point3D_ids, dtype=np.int64).view(np.float64)
                f.write(data.tobytes())


def read_points3d_binary(path) -> Points3D:
    points: Points3D = {}
    with open(path, "rb") as f:
        (num,) = _read_bytes(f, "<Q")
        for _ in range(num):
            (pid,) = _read_bytes(f, "<Q")
            xyz = np.array(_read_bytes(f, "<3d"))
            rgb = np.array(_read_bytes(f, "<3B"), dtype=np.uint8)
            (error,) = _read_bytes(f, "<d")
            (track_len,) = _read_bytes(f, "<Q")
            if track_len > 0:
                t = np.frombuffer(f.read(8 * track_len), dtype=np.int32).reshape(track_len, 2)
                image_ids = t[:, 0].copy()
                p2d = t[:, 1].copy()
            else:
                image_ids = np.zeros((0,), dtype=np.int32)
                p2d = np.zeros((0,), dtype=np.int32)
            points[pid] = Point3D(pid, xyz, rgb, error, image_ids, p2d)
    return points


def write_points3d_binary(points: Points3D, path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.point3D_id))
            f.write(struct.pack("<3d", *p.xyz.tolist()))
            f.write(struct.pack("<3B", *np.asarray(p.rgb, dtype=np.uint8).tolist()))
            f.write(struct.pack("<d", float(p.error)))
            n = len(p.image_ids)
            f.write(struct.pack("<Q", n))
            if n > 0:
                t = np.empty((n, 2), dtype=np.int32)
                t[:, 0] = p.image_ids
                t[:, 1] = p.point2D_idxs
                f.write(t.tobytes())


# ---------------------------------------------------------------------------
# Text format
# ---------------------------------------------------------------------------

def read_cameras_text(path) -> Cameras:
    cameras: Cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            camera_id = int(elems[0])
            model_id = camera_models.model_by_name(elems[1]).model_id
            width, height = int(elems[2]), int(elems[3])
            params = np.array([float(x) for x in elems[4:]])
            cameras[camera_id] = Camera(camera_id, model_id, width, height, params)
    return cameras


def write_cameras_text(cameras: Cameras, path) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(x)) for x in cam.params)
            f.write(f"{cam.camera_id} {cam.model_name} {cam.width} {cam.height} {params}\n")


def read_images_text(path) -> Images:
    images: Images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        elems = lines[i].split()
        image_id = int(elems[0])
        qvec = np.array([float(x) for x in elems[1:5]])
        tvec = np.array([float(x) for x in elems[5:8]])
        camera_id = int(elems[8])
        name = elems[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        if pts:
            arr = np.array(pts, dtype=np.float64).reshape(-1, 3)
            xys = arr[:, :2]
            ids = arr[:, 2].astype(np.int64)
        else:
            xys = np.zeros((0, 2))
            ids = np.zeros((0,), dtype=np.int64)
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def write_images_text(images: Images, path) -> None:
    mean_obs = np.mean([im.num_points3d() for im in images.values()]) if images else 0
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {len(images)}, mean observations per image: {mean_obs}\n")
        for im in images.values():
            pose = " ".join(repr(float(x)) for x in np.concatenate([im.qvec, im.tvec]))
            f.write(f"{im.image_id} {pose} {im.camera_id} {im.name}\n")
            parts = []
            for xy, pid in zip(im.xys, im.point3D_ids):
                parts.append(f"{repr(float(xy[0]))} {repr(float(xy[1]))} {int(pid)}")
            f.write(" ".join(parts) + "\n")


def read_points3d_text(path) -> Points3D:
    points: Points3D = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            pid = int(elems[0])
            xyz = np.array([float(x) for x in elems[1:4]])
            rgb = np.array([int(x) for x in elems[4:7]], dtype=np.uint8)
            error = float(elems[7])
            track = np.array(elems[8:], dtype=np.int64).reshape(-1, 2)
            points[pid] = Point3D(pid, xyz, rgb, error,
                                  track[:, 0].astype(np.int32), track[:, 1].astype(np.int32))
    return points


def write_points3d_text(points: Points3D, path) -> None:
    mean_track = np.mean([len(p.image_ids) for p in points.values()]) if points else 0
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        f.write(f"# Number of points: {len(points)}, mean track length: {mean_track}\n")
        for p in points.values():
            xyz = " ".join(repr(float(x)) for x in p.xyz)
            rgb = " ".join(str(int(x)) for x in p.rgb)
            track = " ".join(f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs))
            f.write(f"{p.point3D_id} {xyz} {rgb} {repr(float(p.error))} {track}\n")


# ---------------------------------------------------------------------------
# Top-level model IO
# ---------------------------------------------------------------------------

def detect_model_format(path) -> str:
    if os.path.isfile(os.path.join(path, "cameras.bin")):
        return ".bin"
    if os.path.isfile(os.path.join(path, "cameras.txt")):
        return ".txt"
    raise FileNotFoundError(f"no COLMAP model found under {path}")


def read_model(path, ext: str | None = None) -> Tuple[Cameras, Images, Points3D]:
    ext = ext or detect_model_format(path)
    if ext == ".bin":
        return (read_cameras_binary(os.path.join(path, "cameras.bin")),
                read_images_binary(os.path.join(path, "images.bin")),
                read_points3d_binary(os.path.join(path, "points3D.bin")))
    return (read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            read_points3d_text(os.path.join(path, "points3D.txt")))


def write_model(cameras: Cameras, images: Images, points: Points3D, path, ext=".bin") -> None:
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3d_binary(points, os.path.join(path, "points3D.bin"))
    else:
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
        write_points3d_text(points, os.path.join(path, "points3D.txt"))
