"""Incremental track triangulation: create / continue / merge / complete.

Port of ``sba_tpu/sfm/incremental_triangulator.py`` (ref: src/sfm/
incremental_triangulator.{h,cc}: TriangulateImage :61, CompleteImage
:232, CompleteTracks :261, MergeTracks :290, Retriangulate :421).

The bookkeeping (which feature belongs to which track) stays in the
host `Reconstruction` dicts, in sba_tpu's order: features ascending,
correspondences in graph order, the same tie-breaks. The camera-model
calls run on the host in float64 on purpose, as sba_tpu runs them under
`on_host()`: they are tiny per-track batches, and a round trip to the
card for each would cost more than the math. This is sba_tpu's own
design, not a fallback from the card.

Where sba_tpu calls the camera model once per keypoint or per
projection, the port batches the same elementwise calls (the results
are those of the per-call form, `tests/test_torch_mapper.py` holds it):

- each image's normalized keypoints are computed once for all its
  keypoints, and again, with every other stale image in the same call,
  when its camera's parameters change;
- the projections a step needs are gathered and evaluated in one call
  per step (a `triangulate_image`'s continuation candidates, a track
  creation's partners, a merge's observations), with the poses applied
  row by row in numpy as the per-call form does;
- `complete_tracks` and `merge_tracks` first find, over the CSR graph in
  bulk, the points that have anything to complete or merge, and walk
  only those (the others leave every result as it is).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.io.colmap_models import INVALID_POINT3D


@dataclass
class TriangulatorOptions:
    """Mirrors ref: sfm/incremental_triangulator.h Options."""

    max_transitivity: int = 1
    create_max_angle_error: float = 2.0     # deg
    continue_max_angle_error: float = 2.0   # deg
    merge_max_reproj_error: float = 4.0     # px
    complete_max_reproj_error: float = 4.0  # px
    re_max_angle_error: float = 5.0         # deg (retriangulation)
    re_min_ratio: float = 0.2
    re_max_trials: int = 1
    min_angle: float = 1.5                  # deg, min triangulation angle
    ignore_two_view_tracks: bool = True
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0


def _rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y]])


def _projection_center(qvec, tvec):
    return -_rotmat(qvec).T @ tvec


def _image_to_normalized(camera, xy):
    """Pixel [N, 2] -> normalized camera coords through the camera model
    (host float64): sba_tpu's per-call form, the tests' reference for
    `IncrementalTriangulator.normalized`."""
    uv = camera_models.image_to_world(
        camera.model_id, torch.as_tensor(np.asarray(camera.params,
                                                    np.float64)),
        torch.as_tensor(np.atleast_2d(np.asarray(xy, np.float64))))
    return uv.numpy()


def _to_uv(qvec, tvec, xyz):
    """World point(s) [N, 3] -> (normalized uv [N, 2], depth [N]); the
    pose is applied row by row, so a batch gives each row's bits."""
    R = _rotmat(qvec)
    pc = (np.atleast_2d(xyz)[:, None, :] * R[None, :, :]).sum(-1) + tvec
    z = pc[:, 2]
    uv = pc[:, :2] / np.where(np.abs(z) > 1e-12, z, 1e-12)[:, None]
    return uv, z


def _world_to_image_rows(model_ids, params, uv):
    """world_to_image of rows with their own camera (model id [N],
    params [N] arrays, uv [N, 2]): one call per camera model."""
    model_ids = np.asarray(model_ids)
    out = np.empty((len(uv), 2))
    for mid in np.unique(model_ids):
        sel = np.nonzero(model_ids == mid)[0]
        prm = np.stack([np.asarray(params[i], np.float64) for i in sel])
        out[sel] = camera_models.world_to_image(
            int(mid), torch.as_tensor(prm),
            torch.as_tensor(np.ascontiguousarray(uv[sel]))).numpy()
    return out


def _project(camera, qvec, tvec, xyz):
    """World point(s) -> pixel + depth (host float64): sba_tpu's per-call
    form, the tests' reference for the batched projections."""
    uv, z = _to_uv(qvec, tvec, xyz)
    xy = camera_models.world_to_image(
        camera.model_id, torch.as_tensor(np.asarray(camera.params,
                                                    np.float64)),
        torch.as_tensor(uv)).numpy()
    return xy, z


def _triangulate_dlt(proj_mats, norm_xys):
    """Multi-view DLT from [M, 3, 4] projection matrices and [M, 2]
    normalized coords (ref: base/triangulation.cc
    TriangulateMultiViewPoint)."""
    A = np.zeros((2 * len(proj_mats), 4))
    for i, (P, xy) in enumerate(zip(proj_mats, norm_xys)):
        A[2 * i] = xy[0] * P[2] - P[0]
        A[2 * i + 1] = xy[1] * P[2] - P[1]
    _, _, Vt = np.linalg.svd(A)
    X = Vt[-1]
    if abs(X[3]) < 1e-12:
        return None
    return X[:3] / X[3]


def _tri_angle(center1, center2, xyz):
    b1 = xyz - center1
    b2 = xyz - center2
    c = np.dot(b1, b2) / (np.linalg.norm(b1) * np.linalg.norm(b2) + 1e-18)
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


class IncrementalTriangulator:
    """Ref: sfm/incremental_triangulator.h:55."""

    def __init__(self, correspondence_graph, reconstruction):
        self.graph = correspondence_graph
        self.rec = reconstruction
        self._re_num_trials: Dict = {}
        self._camera_ok_cache: Dict[int, bool] = {}
        self._norm_cache: Dict[int, Tuple[tuple, np.ndarray]] = {}
        self._feat_cache: Dict[int, np.ndarray] = {}
        # (image_id, point3D_id) -> (pixel [2], depth) of the running
        # entry point; poses, cameras and existing points do not move
        # inside one.
        self._proj: Dict[Tuple[int, int], Tuple[np.ndarray, float]] = {}

    # -- helpers ------------------------------------------------------------

    def _camera(self, image):
        return self.rec.cameras[image.camera_id]

    def _has_good_camera(self, image) -> bool:
        """Bogus-intrinsics gate (ref: incremental_triangulator.cc
        HasCameraBogusParams)."""
        cam = self._camera(image)
        cid = cam.camera_id
        if cid in self._camera_ok_cache:
            return self._camera_ok_cache[cid]
        spec = camera_models.model_by_id(cam.model_id)
        ok = True
        for i in spec.focal_idxs:
            r = cam.params[i] / max(cam.width, cam.height)
            if not (0.1 <= r <= 10.0):
                ok = False
        self._camera_ok_cache[cid] = ok
        return ok

    def _proj_matrix(self, image):
        R = _rotmat(image.qvec)
        return np.hstack([R, image.tvec.reshape(3, 1)])

    def _norm_key(self, image_id):
        image = self.rec.images[image_id]
        cam = self._camera(image)
        return (cam.camera_id, cam.model_id,
                np.asarray(cam.params, np.float64).tobytes(), len(image.xys))

    def normalized(self, image_id: int) -> np.ndarray:
        """Normalized coords of all of an image's keypoints, cached while
        its camera's model and parameters stay the same. A miss
        recomputes every stale registered image with it, in one
        camera-model call per model (a bundle adjustment moves every
        camera at once)."""
        hit = self._norm_cache.get(image_id)
        if hit is None or hit[0] != self._norm_key(image_id):
            stale = [image_id] + [
                i for i in self.rec.registered_image_ids if i != image_id
                and (i not in self._norm_cache
                     or self._norm_cache[i][0] != self._norm_key(i))]
            self._normalize_images(stale)
        return self._norm_cache[image_id][1]

    def _normalize_images(self, image_ids):
        by_model: Dict[int, list] = {}
        for iid in image_ids:
            cam = self._camera(self.rec.images[iid])
            by_model.setdefault(cam.model_id, []).append(iid)
        for mid, ids in by_model.items():
            xys = [np.asarray(self.rec.images[i].xys, np.float64).reshape(
                -1, 2) for i in ids]
            prm = np.concatenate([np.repeat(np.asarray(
                self._camera(self.rec.images[i]).params, np.float64)[None],
                len(x), axis=0) for i, x in zip(ids, xys)])
            uv = camera_models.image_to_world(
                mid, torch.as_tensor(prm),
                torch.as_tensor(np.concatenate(xys))).numpy()
            ofs = np.cumsum([0] + [len(x) for x in xys])
            for k, i in enumerate(ids):
                self._norm_cache[i] = (self._norm_key(i),
                                       uv[ofs[k]:ofs[k + 1]])

    def _project_points(self, pairs):
        """Fill the projection cache for (image_id, point3D_id) pairs in
        one camera-model call per model."""
        todo = [k for k in dict.fromkeys(pairs) if k not in self._proj]
        if not todo:
            return
        uvs, zs, mids, prms = [], [], [], []
        for iid, pid in todo:
            im = self.rec.images[iid]
            cam = self._camera(im)
            uv, z = _to_uv(im.qvec, im.tvec, self.rec.points3D[pid].xyz)
            uvs.append(uv[0])
            zs.append(z[0])
            mids.append(cam.model_id)
            prms.append(cam.params)
        xy = _world_to_image_rows(mids, prms, np.stack(uvs))
        for k, key in enumerate(todo):
            self._proj[key] = (xy[k], zs[k])

    def _projection(self, image_id, point3D_id):
        key = (image_id, point3D_id)
        if key not in self._proj:
            self._project_points([key])
        return self._proj[key]

    def _linked_points(self, mode: str) -> Set[int]:
        """Points with a direct correspondence of their track that leads
        to an untracked feature of a registered image (mode "complete")
        or to a feature of another point (mode "merge"), evaluated over
        the CSR graph in bulk. `complete_tracks` and `merge_tracks` act on
        no other point, and no step of theirs adds one to the set: the
        rest are skipped without changing a result."""
        g = self.graph
        ids = list(self.rec.images)
        if not ids:
            return set()
        size = max(max(ids), max(g.offsets, default=0)) + 1
        base = np.zeros(size, np.int64)
        lens = [len(self.rec.images[i].point3D_ids) for i in ids]
        base[ids] = np.cumsum([0] + lens[:-1])
        flat = np.concatenate([self.rec.images[i].point3D_ids
                               for i in ids]).astype(np.int64)
        in_rec = np.zeros(size, bool)
        in_rec[ids] = True
        reg = np.zeros(size, bool)
        reg[[i for i in self.rec.registered_image_ids if i < size]] = True
        out = []
        for i in ids:
            off = g.offsets.get(i)
            if off is None or not len(g.corr_images[i]):
                continue
            feat = self._feat_of(i)
            src = self.rec.images[i].point3D_ids[feat]
            ci = g.corr_images[i].astype(np.int64)
            ok = (src != INVALID_POINT3D) & (ci < size)
            ok[ok] = in_rec[ci[ok]]
            tgt = np.full(len(ci), -2, np.int64)
            tgt[ok] = flat[base[ci[ok]] + g.corr_features[i][ok]]
            if mode == "complete":
                ok &= reg[np.minimum(ci, size - 1)] & (tgt == INVALID_POINT3D)
            else:
                ok &= (tgt != INVALID_POINT3D) & (tgt != src)
            out.append(np.unique(src[ok]))
        return set(np.concatenate(out).tolist()) if out else set()

    def _feat_of(self, image_id):
        """Source feature of each CSR correspondence of an image."""
        hit = self._feat_cache.get(image_id)
        if hit is None:
            off = self.graph.offsets[image_id]
            hit = np.repeat(np.arange(len(off) - 1), np.diff(off))
            self._feat_cache[image_id] = hit
        return hit

    # -- main entry points --------------------------------------------------

    def triangulate_image(self, image_id: int,
                          options: Optional[TriangulatorOptions] = None
                          ) -> int:
        """Create/continue tracks from all features of a registered image.
        Returns number of observations added
        (ref: incremental_triangulator.cc:61 TriangulateImage)."""
        opt = options or TriangulatorOptions()
        image = self.rec.images[image_id]
        if not self.rec.is_registered(image_id) or \
                not self._has_good_camera(image):
            return 0
        self._proj = {}
        self._prefetch_continuations(image_id)
        num_tris = 0
        for f in range(len(image.xys)):
            num_tris += self._triangulate_feature(image_id, f, opt)
        self._proj = {}
        return num_tris

    def _prefetch_continuations(self, image_id):
        """Project, in one call, every existing point that a correspondence
        of this image's untracked features reaches in a registered image
        (the continuation candidates of `_triangulate_feature`)."""
        g = self.graph
        off = g.offsets.get(image_id)
        image = self.rec.images[image_id]
        if off is None or not len(image.xys):
            return
        untracked = image.point3D_ids == INVALID_POINT3D
        ci = g.corr_images[image_id]
        cf = g.corr_features[image_id]
        feat = np.repeat(np.arange(len(off) - 1), np.diff(off))
        pids = np.full(len(ci), INVALID_POINT3D, np.int64)
        for oim in np.unique(ci):
            oim = int(oim)
            if oim in self.rec.images and self.rec.is_registered(oim):
                sel = ci == oim
                pids[sel] = self.rec.images[oim].point3D_ids[cf[sel]]
        cand = np.unique(pids[untracked[feat] & (pids != INVALID_POINT3D)])
        self._project_points([(image_id, int(p)) for p in cand
                              if int(p) in self.rec.points3D])

    def _triangulate_feature(self, image_id: int, feature_idx: int,
                             opt: TriangulatorOptions) -> int:
        image = self.rec.images[image_id]
        if image.point3D_ids[feature_idx] != INVALID_POINT3D:
            return 0  # already in a track

        corrs = self.graph.find_transitive_correspondences(
            image_id, feature_idx, opt.max_transitivity)
        if len(corrs) == 0:
            return 0

        # Continuation candidates (tracked features in registered images)
        # and creation partners.
        cont_points: List[int] = []
        create_partners: List[Tuple[int, int]] = []
        for oim, oft in corrs:
            oim, oft = int(oim), int(oft)
            if oim not in self.rec.images or \
                    not self.rec.is_registered(oim):
                continue
            other = self.rec.images[oim]
            if not self._has_good_camera(other):
                continue
            pid = int(other.point3D_ids[oft])
            if pid != INVALID_POINT3D:
                cont_points.append(pid)
            else:
                create_partners.append((oim, oft))

        # ContinueTrack: the most common existing point, if its
        # reprojection is consistent (ref: ContinueTrack).
        if cont_points:
            pid = int(np.bincount(np.asarray(cont_points)).argmax()) \
                if len(set(cont_points)) > 1 else cont_points[0]
            if self._try_add_observation(
                    image_id, feature_idx, pid,
                    opt.continue_max_angle_error):
                return 1

        # CreateTrack: two-view triangulation against the best partner.
        added = 0
        if create_partners:
            added = self._create_track(image_id, feature_idx,
                                       create_partners, opt)
        return added

    def _try_add_observation(self, image_id, feature_idx, point3D_id,
                             max_angle_error_deg) -> bool:
        """Angle-based consistency: the reprojection error in pixels
        against an angular threshold scaled by the focal length."""
        if point3D_id not in self.rec.points3D:
            return False
        image = self.rec.images[image_id]
        cam = self._camera(image)
        xy_proj, z = self._projection(image_id, point3D_id)
        if z <= 0:
            return False
        err = np.linalg.norm(xy_proj - image.xys[feature_idx])
        focal = cam.mean_focal_length()
        max_err_px = np.tan(np.radians(max_angle_error_deg)) * focal
        if err > max_err_px:
            return False
        self.rec.add_observation(point3D_id, image_id, feature_idx)
        return True

    def _create_track(self, image_id, feature_idx, partners, opt) -> int:
        image = self.rec.images[image_id]
        cam = self._camera(image)
        center0 = _projection_center(image.qvec, image.tvec)
        P0 = self._proj_matrix(image)
        xy0n = self.normalized(image_id)[feature_idx]
        R0 = _rotmat(image.qvec)
        tan_err = np.tan(np.radians(opt.create_max_angle_error))

        # Every partner's triangulation and its cheirality / angle gates;
        # then both reprojections of the survivors in one call.
        cands = []   # (angle, xyz, (oim, oft))
        for (oim, oft) in partners:
            other = self.rec.images[oim]
            P1 = self._proj_matrix(other)
            xy1n = self.normalized(oim)[oft]
            xyz = _triangulate_dlt([P0, P1], [xy0n, xy1n])
            if xyz is None:
                continue
            z0 = (R0 @ xyz + image.tvec)[2]
            z1 = (_rotmat(other.qvec) @ xyz + other.tvec)[2]
            if z0 <= 0 or z1 <= 0:
                continue
            center1 = _projection_center(other.qvec, other.tvec)
            ang = _tri_angle(center0, center1, xyz)
            if ang < opt.min_angle:
                continue
            cands.append((ang, xyz, (oim, oft)))
        if not cands:
            return 0
        rows = []    # (image, feature, camera, xyz) per reprojection
        for ang, xyz, (oim, oft) in cands:
            other = self.rec.images[oim]
            rows.append((image, feature_idx, cam, xyz))
            rows.append((other, oft, self._camera(other), xyz))
        err = self._reproj_errors(rows)[0]
        best = None
        for k, (ang, xyz, pk) in enumerate(cands):
            if err[2 * k] > tan_err * cam.mean_focal_length():
                continue
            ocam = rows[2 * k + 1][2]
            if err[2 * k + 1] > tan_err * ocam.mean_focal_length():
                continue
            if best is None or ang > best[0]:
                best = (ang, xyz, pk)

        if best is None:
            return 0
        ang, xyz, (oim, oft) = best
        track = [(image_id, feature_idx), (oim, int(oft))]
        # Pull in the remaining partners that agree with the new point.
        rest = [(pim, pft) for (pim, pft) in partners
                if (pim, pft) != (oim, oft)]
        if rest:
            rows = [(self.rec.images[pim], pft,
                     self._camera(self.rec.images[pim]), xyz)
                    for pim, pft in rest]
            err, z = self._reproj_errors(rows)
            for k, (pim, pft) in enumerate(rest):
                if z[k] <= 0:
                    continue
                other = self.rec.images[pim]
                max_err = tan_err * rows[k][2].mean_focal_length()
                if err[k] <= max_err and \
                        other.point3D_ids[pft] == INVALID_POINT3D:
                    track.append((pim, int(pft)))
        if opt.ignore_two_view_tracks and len(track) < 2:
            return 0
        self.rec.add_point3d(xyz, track)
        return len(track)

    def _reproj_errors(self, rows):
        """rows of (image, feature index, camera, xyz) -> (pixel error
        [n], depth [n]) in one camera-model call per model."""
        uvs, zs = [], []
        for im, _ft, _cm, xyz in rows:
            uv, z = _to_uv(im.qvec, im.tvec, xyz)
            uvs.append(uv[0])
            zs.append(z[0])
        xy = _world_to_image_rows([r[2].model_id for r in rows],
                                  [r[2].params for r in rows], np.stack(uvs))
        d = xy - np.stack([r[0].xys[r[1]] for r in rows])
        # Row by row: a 2-vector's norm, as the per-call form takes it.
        return np.array([np.linalg.norm(v) for v in d]), np.asarray(zs)

    # -- track maintenance --------------------------------------------------

    def complete_image(self, image_id: int,
                       options: Optional[TriangulatorOptions] = None) -> int:
        """Attach untracked features of a registered image to existing
        tracks (ref: CompleteImage .cc:232)."""
        opt = options or TriangulatorOptions()
        if not self.rec.is_registered(image_id):
            return 0
        image = self.rec.images[image_id]
        self._proj = {}
        n = 0
        for f in range(len(image.xys)):
            if image.point3D_ids[f] != INVALID_POINT3D:
                continue
            corrs = self.graph.find_transitive_correspondences(
                image_id, f, opt.max_transitivity)
            pids = []
            for oim, oft in corrs:
                oim = int(oim)
                if oim in self.rec.images and self.rec.is_registered(oim):
                    pid = int(self.rec.images[oim].point3D_ids[int(oft)])
                    if pid != INVALID_POINT3D:
                        pids.append(pid)
            for pid in sorted(set(pids)):
                if self._try_add_observation(
                        image_id, f, pid, opt.continue_max_angle_error):
                    n += 1
                    break
        self._proj = {}
        return n

    def complete_tracks(self, point3D_ids: Sequence[int],
                        options: Optional[TriangulatorOptions] = None) -> int:
        """Grow given tracks transitively (ref: CompleteTracks .cc:261)."""
        opt = options or TriangulatorOptions()
        linked = self._linked_points("complete")
        todo = [pid for pid in point3D_ids if pid in linked]
        self._proj = {}
        self._prefetch_completions(todo)
        n = 0
        for pid in todo:
            if pid not in self.rec.points3D:
                continue
            n += self._complete_track(pid, opt)
        self._proj = {}
        return n

    def _prefetch_completions(self, point3D_ids):
        """Project, in one call, each listed point into the registered
        images where a direct correspondence of its track is untracked
        (the first candidates of `_complete_track`)."""
        g = self.graph
        reg = set(self.rec.registered_image_ids)
        pairs = []
        for pid in point3D_ids:
            pt = self.rec.points3D.get(pid)
            if pt is None:
                continue
            for im, ft in zip(pt.image_ids, pt.point2D_idxs):
                off = g.offsets.get(int(im))
                if off is None:
                    continue
                a, b = off[int(ft)], off[int(ft) + 1]
                for oim, oft in zip(g.corr_images[int(im)][a:b],
                                    g.corr_features[int(im)][a:b]):
                    oim = int(oim)
                    if oim in reg and self.rec.images[oim].point3D_ids[
                            int(oft)] == INVALID_POINT3D:
                        pairs.append((oim, pid))
        self._project_points(pairs)

    def _complete_track(self, point3D_id: int,
                        opt: TriangulatorOptions) -> int:
        pt = self.rec.points3D[point3D_id]
        n = 0
        queue = list(zip(pt.image_ids, pt.point2D_idxs))
        seen: Set[Tuple[int, int]] = set(
            (int(a), int(b)) for a, b in queue)
        while queue:
            im, ft = queue.pop()
            for oim, oft in self.graph.find_correspondences(int(im), int(ft)):
                kk = (int(oim), int(oft))
                if kk in seen:
                    continue
                seen.add(kk)
                oim, oft = kk
                if oim not in self.rec.images or \
                        not self.rec.is_registered(oim):
                    continue
                other = self.rec.images[oim]
                if other.point3D_ids[oft] != INVALID_POINT3D:
                    continue
                if self._try_add_observation(
                        oim, oft, point3D_id,
                        np.degrees(np.arctan(
                            opt.complete_max_reproj_error /
                            self._camera(other).mean_focal_length()))):
                    n += 1
                    queue.append((oim, oft))
        return n

    def merge_tracks(self, point3D_ids: Sequence[int],
                     options: Optional[TriangulatorOptions] = None) -> int:
        """Merge tracks linked by correspondences when the merged point
        keeps all reprojections small (ref: MergeTracks .cc:290)."""
        opt = options or TriangulatorOptions()
        linked = self._linked_points("merge")
        n = 0
        for pid in list(point3D_ids):
            if pid not in self.rec.points3D or pid not in linked:
                continue
            n += self._merge_track(pid, opt)
        return n

    def _merge_track(self, point3D_id: int, opt: TriangulatorOptions) -> int:
        pt = self.rec.points3D.get(point3D_id)
        if pt is None:
            return 0
        # Candidate partner tracks via correspondences.
        g = self.graph
        partners: Dict[int, int] = {}
        for im, ft in zip(pt.image_ids, pt.point2D_idxs):
            off = g.offsets[int(im)]
            a, b = off[int(ft)], off[int(ft) + 1]
            for oim, oft in zip(g.corr_images[int(im)][a:b],
                                g.corr_features[int(im)][a:b]):
                oim = int(oim)
                if oim not in self.rec.images:
                    continue
                pid2 = int(self.rec.images[oim].point3D_ids[int(oft)])
                if pid2 != INVALID_POINT3D and pid2 != point3D_id:
                    partners[pid2] = partners.get(pid2, 0) + 1
        merged = 0
        for pid2, _cnt in sorted(partners.items(), key=lambda kv: -kv[1]):
            if pid2 not in self.rec.points3D or \
                    point3D_id not in self.rec.points3D:
                break
            p1 = self.rec.points3D[point3D_id]
            p2 = self.rec.points3D[pid2]
            w1, w2 = len(p1.image_ids), len(p2.image_ids)
            xyz = (w1 * p1.xyz + w2 * p2.xyz) / (w1 + w2)
            rows = []
            for p in (p1, p2):
                for im, ft in zip(p.image_ids, p.point2D_idxs):
                    image = self.rec.images[int(im)]
                    rows.append((image, int(ft), self._camera(image), xyz))
            err, z = self._reproj_errors(rows)
            if not np.any((z <= 0) | (err > opt.merge_max_reproj_error)):
                self.rec.merge_points(point3D_id, pid2)
                merged += 1
                if point3D_id not in self.rec.points3D:
                    break
        return merged

    def retriangulate(self,
                      options: Optional[TriangulatorOptions] = None) -> int:
        """Re-triangulate under-reconstructed image pairs
        (ref: Retriangulate .cc:421). Returns new observations."""
        opt = options or TriangulatorOptions()
        n = 0
        relaxed = TriangulatorOptions(
            **{**opt.__dict__,
               "create_max_angle_error": opt.re_max_angle_error})
        self._proj = {}
        for (i1, i2), m in self.graph.image_pairs.items():
            if i1 not in self.rec.images or i2 not in self.rec.images:
                continue
            if not (self.rec.is_registered(i1) and self.rec.is_registered(i2)):
                continue
            im1, im2 = self.rec.images[i1], self.rec.images[i2]
            p1 = im1.point3D_ids[m[:, 0]]
            tri = int(np.sum((p1 != INVALID_POINT3D)
                             & (p1 == im2.point3D_ids[m[:, 1]])))
            ratio = tri / max(len(m), 1)
            if ratio >= opt.re_min_ratio:
                continue
            trials = self._re_num_trials.get((i1, i2), 0)
            if trials >= opt.re_max_trials:
                continue
            self._re_num_trials[(i1, i2)] = trials + 1
            for a in m[:, 0]:
                a = int(a)
                if im1.point3D_ids[a] == INVALID_POINT3D:
                    n += self._triangulate_feature(i1, a, relaxed)
        self._proj = {}
        return n
