"""COLMAP-compatible SQLite database. Port of ``sba_tpu/io/database.py``.

On-disk-format parity with the reference (ref: src/base/database.{h,cc},
`Database` database.h:50, and the schema SQL of database.cc): a database
written by this module opens in stock COLMAP, in sba_tpu, and the other
way round:

- tables: cameras, images, keypoints, descriptors, matches,
  two_view_geometries;
- pair_id packing: pair_id = image_id1 * 2147483647 + image_id2 with
  image_id1 < image_id2 (ref: database.h:123-126);
- keypoints stored as float32 row-major [N, 4] or [N, 6] blobs,
  descriptors as uint8 [N, 128] blobs, matches as uint32 [N, 2] blobs,
  camera parameters and two-view matrices as float64 blobs.

Host-only by design (sqlite3 and numpy): persistence is IO-bound
bookkeeping, and no tensor crosses here.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

MAX_IMAGE_ID = 2147483647  # ref: database.h kMaxNumImages


def image_pair_to_pair_id(image_id1: int, image_id2: int) -> int:
    """Ref: database.cc ImagePairToPairId (swaps so id1 < id2)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_pair(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return image_id1, image_id2


def swap_matches(matches: np.ndarray) -> np.ndarray:
    return matches[:, ::-1].copy()


_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB,
    qvec BLOB, tvec BLOB);
"""


def _array_to_blob(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _blob_to_array(blob, dtype, shape) -> np.ndarray:
    if blob is None:
        return np.zeros(shape, dtype)
    return np.frombuffer(blob, dtype).reshape(shape).copy()


class Database:
    """COLMAP-format SQLite database (ref: base/database.h:50)."""

    def __init__(self, path: str = ":memory:"):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def close(self):
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- cameras -----------------------------------------------------------

    def write_camera(self, model_id: int, width: int, height: int,
                     params: Sequence[float],
                     prior_focal_length: bool = False,
                     camera_id: Optional[int] = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras (camera_id, model, width, height, params, "
            "prior_focal_length) VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model_id, width, height,
             _array_to_blob(np.asarray(params, np.float64)),
             int(prior_focal_length)))
        return cur.lastrowid

    def read_camera(self, camera_id: int):
        row = self.conn.execute(
            "SELECT camera_id, model, width, height, params, "
            "prior_focal_length FROM cameras WHERE camera_id=?",
            (camera_id,)).fetchone()
        if row is None:
            raise KeyError(f"camera {camera_id} not found")
        params = np.frombuffer(row[4], np.float64) if row[4] else np.zeros(0)
        return dict(camera_id=row[0], model_id=row[1], width=row[2],
                    height=row[3], params=params.copy(),
                    prior_focal_length=bool(row[5]))

    def read_cameras(self) -> Dict[int, dict]:
        return {r[0]: self.read_camera(r[0]) for r in
                self.conn.execute("SELECT camera_id FROM cameras")}

    # --- images ------------------------------------------------------------

    def write_image(self, name: str, camera_id: int,
                    prior_q=(None,) * 4, prior_t=(None,) * 3,
                    image_id: Optional[int] = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO images (image_id, name, camera_id, prior_qw, "
            "prior_qx, prior_qy, prior_qz, prior_tx, prior_ty, prior_tz) "
            "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *prior_q, *prior_t))
        return cur.lastrowid

    def read_images(self) -> Dict[int, dict]:
        out = {}
        for r in self.conn.execute(
                "SELECT image_id, name, camera_id, prior_qw, prior_qx, "
                "prior_qy, prior_qz, prior_tx, prior_ty, prior_tz "
                "FROM images"):
            out[r[0]] = dict(image_id=r[0], name=r[1], camera_id=r[2],
                             prior_qvec=r[3:7], prior_tvec=r[7:10])
        return out

    def image_id_from_name(self, name: str) -> int:
        row = self.conn.execute(
            "SELECT image_id FROM images WHERE name=?", (name,)).fetchone()
        if row is None:
            raise KeyError(f"image {name!r} not found")
        return row[0]

    # --- keypoints / descriptors ------------------------------------------

    def write_keypoints(self, image_id: int, keypoints: np.ndarray):
        """keypoints: [N, 4] (x, y, scale, orientation) f32 — COLMAP's
        4-column affine-reduced format (ref: feature/types.h:43)."""
        kp = np.asarray(keypoints, np.float32)
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], kp.shape[1], _array_to_blob(kp)))

    def read_keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,)).fetchone()
        if row is None:
            return np.zeros((0, 4), np.float32)
        return _blob_to_array(row[2], np.float32, (row[0], row[1]))

    def write_descriptors(self, image_id: int, descriptors: np.ndarray):
        d = np.asarray(descriptors, np.uint8)
        self.conn.execute(
            "INSERT OR REPLACE INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, d.shape[0], d.shape[1], _array_to_blob(d)))

    def read_descriptors(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id=?",
            (image_id,)).fetchone()
        if row is None:
            return np.zeros((0, 128), np.uint8)
        return _blob_to_array(row[2], np.uint8, (row[0], row[1]))

    # --- matches -----------------------------------------------------------

    def write_matches(self, image_id1: int, image_id2: int,
                      matches: np.ndarray):
        """matches: [M, 2] uint32 feature index pairs."""
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = swap_matches(m)
        pid = image_pair_to_pair_id(image_id1, image_id2)
        self.conn.execute(
            "INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
            (pid, m.shape[0], m.shape[1], _array_to_blob(m)))

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        pid = image_pair_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (pid,)).fetchone()
        if row is None or row[0] == 0:
            return np.zeros((0, 2), np.uint32)
        m = _blob_to_array(row[2], np.uint32, (row[0], row[1]))
        if image_id1 > image_id2:
            m = swap_matches(m)
        return m

    def read_all_matches(self):
        out = {}
        for pid, rows, cols, data in self.conn.execute(
                "SELECT pair_id, rows, cols, data FROM matches"):
            if rows:
                out[pair_id_to_image_pair(pid)] = _blob_to_array(
                    data, np.uint32, (rows, cols))
        return out

    # --- two-view geometries ----------------------------------------------

    def write_two_view_geometry(self, image_id1: int, image_id2: int,
                                inlier_matches: np.ndarray,
                                config: int = 2,
                                F=None, E=None, H=None,
                                qvec=None, tvec=None):
        m = np.asarray(inlier_matches, np.uint32)
        if image_id1 > image_id2:
            m = swap_matches(m)
        pid = image_pair_to_pair_id(image_id1, image_id2)

        def b(x, shape):
            if x is None:
                x = np.eye(shape[0])[:, :shape[1]] if len(shape) == 2 \
                    else np.zeros(shape)
            return _array_to_blob(np.asarray(x, np.float64))

        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries "
            "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (pid, m.shape[0], m.shape[1], _array_to_blob(m), int(config),
             b(F, (3, 3)), b(E, (3, 3)), b(H, (3, 3)),
             b(qvec if qvec is not None else [1.0, 0, 0, 0], (4,)),
             b(tvec, (3,))))

    def read_two_view_geometry(self, image_id1: int, image_id2: int) -> dict:
        pid = image_pair_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data, config, F, E, H, qvec, tvec "
            "FROM two_view_geometries WHERE pair_id=?", (pid,)).fetchone()
        if row is None:
            raise KeyError(f"two_view_geometry ({image_id1},{image_id2})")
        m = (_blob_to_array(row[2], np.uint32, (row[0], row[1]))
             if row[0] else np.zeros((0, 2), np.uint32))
        if image_id1 > image_id2:
            m = swap_matches(m)
        return dict(
            inlier_matches=m, config=row[3],
            F=_blob_to_array(row[4], np.float64, (3, 3)),
            E=_blob_to_array(row[5], np.float64, (3, 3)),
            H=_blob_to_array(row[6], np.float64, (3, 3)),
            qvec=_blob_to_array(row[7], np.float64, (4,)),
            tvec=_blob_to_array(row[8], np.float64, (3,)))

    def read_all_two_view_geometries(self):
        out = {}
        for (pid,) in self.conn.execute(
                "SELECT pair_id FROM two_view_geometries"):
            i, j = pair_id_to_image_pair(pid)
            out[(i, j)] = self.read_two_view_geometry(i, j)
        return out

    # --- stats -------------------------------------------------------------

    def num_cameras(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM cameras").fetchone()[0]

    def num_images(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]

    def num_keypoints(self) -> int:
        r = self.conn.execute(
            "SELECT SUM(rows) FROM keypoints").fetchone()[0]
        return int(r or 0)

    def num_keypoints_for_image(self, image_id: int) -> int:
        r = self.conn.execute(
            "SELECT rows FROM keypoints WHERE image_id = ?",
            (int(image_id),)).fetchone()
        return int(r[0]) if r and r[0] else 0

    def num_matches(self) -> int:
        r = self.conn.execute("SELECT SUM(rows) FROM matches").fetchone()[0]
        return int(r or 0)

    def commit(self):
        self.conn.commit()
