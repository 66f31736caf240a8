"""DatabaseCache + CorrespondenceGraph: one-shot DB load into RAM.

Port of ``sba_tpu/io/database_cache.py`` (host only, numpy); it reads
the port's `io/database.Database`. Capability parity with ref:
src/base/database_cache.{h,cc}
(`DatabaseCache::Create` database_cache.h:54) and
src/base/correspondence_graph.{h,cc} (`CorrespondenceGraph`
correspondence_graph.h:45).

Host-side by design (the mapper's registration order is inherently
sequential/data-dependent); storage is flat CSR numpy arrays instead of the
reference's per-feature `std::vector<Correspondence>` — so per-image
2D-3D gathering slices contiguous arrays that upload to device in one copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


class CorrespondenceGraph:
    """Feature-level correspondence adjacency across images.

    CSR layout per image: `offsets[i][f] .. offsets[i][f+1]` indexes into
    `corr_images[i]` / `corr_features[i]` — all correspondences of feature
    f of image i. Built once by `finalize()` after all pairs are added
    (mirrors ref correspondence_graph.h:45 Finalize()).
    """

    def __init__(self):
        self._pairs: Dict[Tuple[int, int], np.ndarray] = {}
        self._num_features: Dict[int, int] = {}
        self.offsets: Dict[int, np.ndarray] = {}
        self.corr_images: Dict[int, np.ndarray] = {}
        self.corr_features: Dict[int, np.ndarray] = {}
        self._finalized = False

    def add_image(self, image_id: int, num_features: int):
        self._num_features[image_id] = int(num_features)

    def add_correspondences(self, image_id1: int, image_id2: int,
                            matches: np.ndarray):
        """matches: [M, 2] feature index pairs (idx1, idx2)."""
        if image_id1 == image_id2:
            return
        key = (min(image_id1, image_id2), max(image_id1, image_id2))
        m = np.asarray(matches, np.int64).reshape(-1, 2)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        if key in self._pairs:
            m = np.concatenate([self._pairs[key], m])
            m = np.unique(m, axis=0)
        self._pairs[key] = m
        self._finalized = False

    def exists_image(self, image_id: int) -> bool:
        return image_id in self._num_features

    @property
    def image_ids(self):
        return sorted(self._num_features)

    def num_correspondences_between_images(self, id1: int, id2: int) -> int:
        key = (min(id1, id2), max(id1, id2))
        return len(self._pairs.get(key, ()))

    def correspondences_between_images(self, id1: int, id2: int) -> np.ndarray:
        key = (min(id1, id2), max(id1, id2))
        m = self._pairs.get(key)
        if m is None:
            return np.zeros((0, 2), np.int64)
        return m if id1 < id2 else m[:, ::-1]

    @property
    def image_pairs(self):
        return dict(self._pairs)

    def finalize(self):
        """Build CSR adjacency (ref: correspondence_graph Finalize)."""
        buckets: Dict[int, List[np.ndarray]] = {
            i: [] for i in self._num_features}
        for (i1, i2), m in self._pairs.items():
            if i1 not in buckets or i2 not in buckets:
                continue
            # rows for image1: (feature1 -> (image2, feature2))
            buckets[i1].append(
                np.stack([m[:, 0], np.full(len(m), i2), m[:, 1]], -1))
            buckets[i2].append(
                np.stack([m[:, 1], np.full(len(m), i1), m[:, 0]], -1))
        for i, nf in self._num_features.items():
            rows = (np.concatenate(buckets[i])
                    if buckets[i] else np.zeros((0, 3), np.int64))
            order = np.argsort(rows[:, 0], kind="stable")
            rows = rows[order]
            counts = np.bincount(rows[:, 0], minlength=nf)
            self.offsets[i] = np.concatenate(
                [[0], np.cumsum(counts)]).astype(np.int64)
            self.corr_images[i] = rows[:, 1].astype(np.int32)
            self.corr_features[i] = rows[:, 2].astype(np.int32)
        self._finalized = True

    def _check_final(self):
        if not self._finalized:
            self.finalize()

    def num_correspondences_for_image(self, image_id: int) -> int:
        self._check_final()
        return int(len(self.corr_images.get(image_id, ())))

    def num_observations_for_image(self, image_id: int) -> int:
        """Features with >= 1 correspondence (ref:
        correspondence_graph NumObservationsForImage)."""
        self._check_final()
        off = self.offsets.get(image_id)
        if off is None:
            return 0
        return int(np.sum(np.diff(off) > 0))

    def find_correspondences(self, image_id: int, feature_idx: int
                             ) -> np.ndarray:
        """-> [K, 2] (other_image_id, other_feature_idx)."""
        self._check_final()
        off = self.offsets[image_id]
        a, b = off[feature_idx], off[feature_idx + 1]
        return np.stack([self.corr_images[image_id][a:b],
                         self.corr_features[image_id][a:b]], -1)

    def find_transitive_correspondences(self, image_id: int,
                                        feature_idx: int,
                                        transitivity: int = 1) -> np.ndarray:
        """BFS over the correspondence graph up to `transitivity` hops
        (ref: correspondence_graph.h FindTransitiveCorrespondences)."""
        self._check_final()
        seen: Set[Tuple[int, int]] = {(image_id, feature_idx)}
        frontier = [(image_id, feature_idx)]
        out = []
        for _ in range(transitivity):
            nxt = []
            for (im, ft) in frontier:
                if im not in self.offsets:
                    continue
                for oim, oft in self.find_correspondences(im, ft):
                    kk = (int(oim), int(oft))
                    if kk not in seen:
                        seen.add(kk)
                        out.append(kk)
                        nxt.append(kk)
            frontier = nxt
            if not frontier:
                break
        return (np.asarray(out, np.int64).reshape(-1, 2)
                if out else np.zeros((0, 2), np.int64))


@dataclass
class CachedImage:
    image_id: int
    name: str
    camera_id: int
    keypoints: np.ndarray      # [N, >=2] f32 (x, y, ...)
    num_observations: int = 0
    num_correspondences: int = 0


@dataclass
class CachedCamera:
    camera_id: int
    model_id: int
    width: int
    height: int
    params: np.ndarray
    prior_focal_length: bool = False


class DatabaseCache:
    """RAM snapshot of the database for mapping
    (ref: base/database_cache.h:54)."""

    def __init__(self):
        self.cameras: Dict[int, CachedCamera] = {}
        self.images: Dict[int, CachedImage] = {}
        self.correspondence_graph = CorrespondenceGraph()

    @classmethod
    def create(cls, database, min_num_matches: int = 15,
               ignore_watermarks: bool = True,
               image_names: Optional[Set[str]] = None) -> "DatabaseCache":
        """Load + filter the DB (ref: database_cache.cc Create: load
        cameras/images/keypoints, keep two-view geometries with
        >= min_num_matches inliers, skip WATERMARK configs)."""
        from sba_tpu_torch.estimators.two_view_geometry import \
            TwoViewConfig

        cache = cls()
        for cid, cam in database.read_cameras().items():
            cache.cameras[cid] = CachedCamera(
                camera_id=cid, model_id=cam["model_id"], width=cam["width"],
                height=cam["height"], params=cam["params"],
                prior_focal_length=cam["prior_focal_length"])
        for iid, img in database.read_images().items():
            if image_names is not None and img["name"] not in image_names:
                continue
            kp = database.read_keypoints(iid)
            cache.images[iid] = CachedImage(
                image_id=iid, name=img["name"], camera_id=img["camera_id"],
                keypoints=kp)
            cache.correspondence_graph.add_image(iid, len(kp))
        for (i1, i2), g in database.read_all_two_view_geometries().items():
            if i1 not in cache.images or i2 not in cache.images:
                continue
            if len(g["inlier_matches"]) < min_num_matches:
                continue
            if ignore_watermarks and g["config"] == int(TwoViewConfig.WATERMARK):
                continue
            cache.correspondence_graph.add_correspondences(
                i1, i2, g["inlier_matches"])
        cache.correspondence_graph.finalize()
        for iid, img in cache.images.items():
            img.num_observations = \
                cache.correspondence_graph.num_observations_for_image(iid)
            img.num_correspondences = \
                cache.correspondence_graph.num_correspondences_for_image(iid)
        return cache

    def num_cameras(self) -> int:
        return len(self.cameras)

    def num_images(self) -> int:
        return len(self.images)
