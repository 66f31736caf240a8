"""Incremental mapper core: init pair, register next, local/global BA.

Port of ``sba_tpu/sfm/incremental_mapper.py`` (ref: src/sfm/
incremental_mapper.{h,cc}: FindInitialImagePair :146,
EstimateInitialTwoViewGeometry :1142, RegisterInitialImagePair :258,
FindNextImages :202, RegisterNextImage :344, FindLocalBundle :942,
AdjustLocalBundle, AdjustGlobalBundle :668, FilterImages/FilterPoints
:749-783).

The registration order is sequential and data dependent, a host loop as
in sba_tpu; each step's batched inner work runs on `device`: the
two-view and P3P RANSAC hypotheses, the EPnP refits, the pose refinement
and the bundle adjustments (float64, the plain path, as sba_tpu's
float64 problems never reach its kernels). The mapper's seed counter
seeds one ``torch.Generator`` per RANSAC call on the device; `draw_fn`
replaces those draws (a test hands in sba_tpu's).

sba_tpu loops in Python over every feature and correspondence of a
candidate image in `find_next_images` and the 2D-3D gather; the port
evaluates the same tests over the correspondence graph's CSR arrays in
numpy, with the same order and tie-breaks (`tests/test_torch_mapper.py`
holds both forms equal). `stats` sums the seconds spent in bundle
adjustment and in RANSAC (pose refinement included), and the counts of
local and global BAs and of their LM iterations.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from sba_tpu_torch.estimators.pose import (AbsolutePoseOptions,
                                           estimate_absolute_pose,
                                           refine_absolute_pose)
from sba_tpu_torch.estimators.two_view_geometry import (
    _KINDS, TwoViewConfig, TwoViewGeometryOptions,
    estimate_two_view_geometries)
from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat
from sba_tpu_torch.io.colmap_models import INVALID_POINT3D, Camera, Image
from sba_tpu_torch.models.reconstruction import Reconstruction
from sba_tpu_torch.optim.ba import (BAOptions, build_problem, bundle_adjust,
                                    pad_problem_pow2)
from sba_tpu_torch.optim.ransac import RANSACOptions, num_required_trials
from sba_tpu_torch.sfm.incremental_triangulator import (
    IncrementalTriangulator, TriangulatorOptions, _projection_center,
    _tri_angle)
from sba_tpu_torch.sfm.visibility_pyramid import VisibilityPyramid


@dataclass
class IncrementalMapperOptions:
    """Mirrors ref: sfm/incremental_mapper.h:66-134 Options."""

    init_min_num_inliers: int = 100
    init_max_error: float = 4.0
    init_max_forward_motion: float = 0.95
    init_min_tri_angle: float = 16.0       # deg
    init_max_reg_trials: int = 2
    abs_pose_max_error: float = 12.0       # px
    abs_pose_min_num_inliers: int = 30
    abs_pose_min_inlier_ratio: float = 0.25
    abs_pose_refine_focal_length: bool = True
    abs_pose_refine_extra_params: bool = True
    local_ba_num_images: int = 6
    local_ba_min_tri_angle: float = 6.0    # deg
    min_tri_angle: float = 1.5             # deg (point filtering)
    filter_max_reproj_error: float = 4.0   # px
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0
    max_reg_trials: int = 3
    num_threads: int = -1                  # kept for flag parity


# Ranked pairs of one bucket whose two-view RANSACs the initial-pair
# search runs in one batch.
INIT_PAIR_BATCH = 8


def _bucket(n):
    """The power-of-two RANSAC bucket (at least 32) of n rows."""
    return 1 << int(np.ceil(np.log2(max(n, 32))))


class IncrementalMapper:
    """Host loop over device solves (ref: incremental_mapper.h:64).

    draw_fn(kind, seed, num_points, num_trials, sample_size, mask) ->
    [num_trials, sample_size] indices replaces the draws of one RANSAC
    (kind "E", "F" or "H" of the initial pair, "P3P" of a registration;
    mask the [num_points] validity of the bucket)."""

    def __init__(self, database_cache, device="cuda",
                 draw_fn: Optional[Callable] = None):
        self.cache = database_cache
        self.device = device
        self.draw_fn = draw_fn
        self.rec: Optional[Reconstruction] = None
        self.triangulator: Optional[IncrementalTriangulator] = None
        self._num_reg_trials: Dict[int, int] = {}
        self._init_pair_tested: Set[Tuple[int, int]] = set()
        self._seed_counter = 0
        self._last_pair_seed = 0
        # (image_id1, image_id2, seed of its two-view RANSAC) once set.
        self.init_pair: Optional[Tuple[int, int, int]] = None
        self.stats = dict(ba_s=0.0, ransac_s=0.0, local_ba=0, global_ba=0,
                          local_lm_it=0, global_lm_it=0)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def begin_reconstruction(self, reconstruction: Reconstruction):
        """Attach to a (possibly pre-seeded) reconstruction
        (ref: IncrementalMapper::BeginReconstruction)."""
        self.rec = reconstruction
        for cid, cam in self.cache.cameras.items():
            if cid not in reconstruction.cameras:
                reconstruction.add_camera(Camera(
                    camera_id=cid, model_id=cam.model_id, width=cam.width,
                    height=cam.height,
                    params=np.asarray(cam.params, np.float64)))
        for iid, img in self.cache.images.items():
            if iid not in reconstruction.images:
                reconstruction.add_image(Image(
                    image_id=iid, qvec=np.array([1.0, 0, 0, 0]),
                    tvec=np.zeros(3), camera_id=img.camera_id,
                    name=img.name,
                    xys=np.asarray(img.keypoints[:, :2], np.float64),
                    point3D_ids=np.full(len(img.keypoints),
                                        INVALID_POINT3D, np.int64)))
        self.triangulator = IncrementalTriangulator(
            self.cache.correspondence_graph, reconstruction)

    def _next_seed(self) -> int:
        self._seed_counter += 1
        return self._seed_counter

    def _draws(self, kind, seed, n, trials, sample_size, mask):
        if self.draw_fn is None:
            return None
        return torch.as_tensor(np.asarray(self.draw_fn(
            kind, seed, n, trials, sample_size, mask)), device=self.device
        ).to(torch.int64)

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def find_initial_image_pair(self, options: IncrementalMapperOptions
                                ) -> Optional[Tuple[int, int, dict]]:
        """Rank image pairs by correspondence count; verify two-view
        geometry with cheirality + triangulation-angle gates
        (ref: FindInitialImagePair :146 + EstimateInitialTwoViewGeometry
        :1142). The untested pairs' two-view RANSACs run ahead in
        batches of up to INIT_PAIR_BATCH pairs of one bucket, each pair at
        the seed it takes in the sequential search; the gates then run
        in rank order, and the seeds and the tested set advance only to
        the pair that passes, as one pair at a time would leave them."""
        g = self.cache.correspondence_graph
        ranked = sorted(g.image_pairs.items(), key=lambda kv: -len(kv[1]))
        todo = [(key, m) for key, m in ranked
                if key not in self._init_pair_tested]
        k = 0
        while k < len(todo):
            bucket = _bucket(len(todo[k][1]))
            run = todo[k:k + INIT_PAIR_BATCH]
            run = run[:next((j for j, (_key, m) in enumerate(run)
                             if _bucket(len(m)) != bucket), len(run))]
            base = self._seed_counter
            results = self._two_view_batch(run, options, base)
            for j, (((i1, i2), matches), res) in enumerate(zip(run, results)):
                self._init_pair_tested.add((i1, i2))
                self._seed_counter = self._last_pair_seed = base + j + 1
                info = self._initial_pair_gates(i1, i2, matches, res,
                                                options)
                if info is not None:
                    return i1, i2, info
            k += len(run)
        return None

    def _camera_fxycxy(self, image_id):
        cam = self.rec.cameras[self.rec.images[image_id].camera_id]
        spec = camera_models.model_by_id(cam.model_id)
        f_idx = spec.focal_idxs
        return (cam.params[f_idx[0]], cam.params[f_idx[-1]],
                cam.params[spec.principal_idxs[0]],
                cam.params[spec.principal_idxs[1]])

    def _two_view_batch(self, run, options, base):
        """The two-view geometries of the pairs of `run` ((i1, i2),
        matches), all of one bucket, pair j at seed base + j + 1: sba_tpu's
        power-of-two bucket and mask, so that its draws for a seed can be
        substituted sample for sample."""
        tv_opt = TwoViewGeometryOptions(
            max_error=options.init_max_error,
            min_num_inliers=options.init_min_num_inliers)
        ropt = RANSACOptions(
            max_error=tv_opt.max_error,
            min_inlier_ratio=tv_opt.min_inlier_ratio,
            confidence=tv_opt.confidence,
            max_num_trials=tv_opt.max_num_trials)
        problems = []
        for j, ((i1, i2), matches) in enumerate(run):
            im1, im2 = self.rec.images[i1], self.rec.images[i2]
            cam1 = self.rec.cameras[im1.camera_id]
            cam2 = self.rec.cameras[im2.camera_id]
            n_real = len(matches)
            bucket = _bucket(n_real)
            pad = np.zeros((bucket - n_real, 2))
            vmask = np.arange(bucket) < n_real
            seed = base + j + 1
            samples = None
            if self.draw_fn is not None:
                samples = {k: self.draw_fn(
                    k, seed, bucket, num_required_trials(ssz, ropt), ssz,
                    vmask) for k, (ssz, _m) in _KINDS.items()}
            problems.append(dict(
                xy1=np.concatenate([im1.xys[matches[:, 0]], pad]),
                xy2=np.concatenate([im2.xys[matches[:, 1]], pad]),
                cam1=self._camera_fxycxy(i1), cam2=self._camera_fxycxy(i2),
                size1=(cam1.width, cam1.height),
                size2=(cam2.width, cam2.height), seed=seed, mask=vmask,
                samples=samples))
        t = time.perf_counter()
        res = estimate_two_view_geometries(problems, tv_opt,
                                           device=self.device)
        self.stats["ransac_s"] += time.perf_counter() - t
        return res

    def _estimate_initial_two_view(self, i1, i2, matches, options
                                   ) -> Optional[dict]:
        """One pair of the initial-pair search at the next seed."""
        base = self._seed_counter
        self._seed_counter = self._last_pair_seed = base + 1
        res = self._two_view_batch([((i1, i2), matches)], options, base)[0]
        return self._initial_pair_gates(i1, i2, matches, res, options)

    def _initial_pair_gates(self, i1, i2, matches, res, options
                            ) -> Optional[dict]:
        """CALIBRATED pairs take the pose from E, PLANAR pairs from H;
        PANORAMIC (pure rotation) cannot initialize (ref:
        sfm/incremental_mapper.cc:1188-1190). Then cheirality, the median
        triangulation angle and the forward-motion gate."""
        if res.config not in (int(TwoViewConfig.CALIBRATED),
                              int(TwoViewConfig.PLANAR)) or \
                res.num_inliers < options.init_min_num_inliers:
            return None
        R = np_quat_to_rotmat(res.qvec)
        t = res.tvec
        m_in = matches[res.inlier_mask[:len(matches)]]
        n1 = self.triangulator.normalized(i1)[m_in[:, 0]]
        n2 = self.triangulator.normalized(i2)[m_in[:, 1]]
        pts = _triangulate_two_view(np.eye(3), np.zeros(3), R, t, n1, n2)
        z1 = pts[:, 2]
        z2 = (pts @ R.T + t)[:, 2]
        ok = (z1 > 0) & (z2 > 0)
        if ok.sum() < options.init_min_num_inliers:
            return None
        c1 = np.zeros(3)
        c2 = -R.T @ t
        angles = np.array([_tri_angle(c1, c2, p) for p in pts[ok]])
        if np.median(angles) < options.init_min_tri_angle:
            return None
        # Forward-motion degeneracy gate (ref: init_max_forward_motion).
        baseline = c2 / (np.linalg.norm(c2) + 1e-12)
        if abs(baseline[2]) > options.init_max_forward_motion:
            return None
        return dict(qvec=res.qvec, tvec=t, inlier_matches=m_in)

    def register_initial_image_pair(self, i1: int, i2: int, info: dict,
                                    options: IncrementalMapperOptions) -> bool:
        """Ref: RegisterInitialImagePair :258."""
        im1, im2 = self.rec.images[i1], self.rec.images[i2]
        im1.qvec = np.array([1.0, 0, 0, 0])
        im1.tvec = np.zeros(3)
        im2.qvec = np.asarray(info["qvec"], np.float64)
        im2.tvec = np.asarray(info["tvec"], np.float64)
        self.rec.register_image(i1)
        self.rec.register_image(i2)
        self.init_pair = (i1, i2, self._last_pair_seed)
        topt = TriangulatorOptions(min_angle=options.init_min_tri_angle / 8)
        self.triangulator.triangulate_image(i1, topt)
        self.triangulator.triangulate_image(i2, topt)
        return self.rec.num_points3d() >= options.init_min_num_inliers // 2

    # ------------------------------------------------------------------
    # next-view selection + registration
    # ------------------------------------------------------------------

    def _corr_points(self, image_id):
        """(feature [K], point3D id [K]) of each correspondence of an
        image in graph order: the point of the corresponding feature in a
        registered image, INVALID_POINT3D elsewhere."""
        g = self.cache.correspondence_graph
        off = g.offsets[image_id]
        ci = g.corr_images[image_id]
        cf = g.corr_features[image_id]
        feat = np.repeat(np.arange(len(off) - 1), np.diff(off))
        pids = np.full(len(ci), INVALID_POINT3D, np.int64)
        for oim in np.unique(ci):
            oim = int(oim)
            if oim in self.rec.images and self.rec.is_registered(oim):
                sel = ci == oim
                pids[sel] = self.rec.images[oim].point3D_ids[cf[sel]]
        return feat, pids

    def find_next_images(self, options: IncrementalMapperOptions
                         ) -> List[int]:
        """Rank unregistered images by visible-point count + spatial
        spread (ref: FindNextImages :202)."""
        g = self.cache.correspondence_graph
        scores = []
        for iid, image in self.rec.images.items():
            if self.rec.is_registered(iid):
                continue
            if self._num_reg_trials.get(iid, 0) >= options.max_reg_trials:
                continue
            cam = self.rec.cameras[image.camera_id]
            pyr = VisibilityPyramid(6, cam.width, cam.height)
            if not g.exists_image(iid):
                continue
            g._check_final()
            feat, pids = self._corr_points(iid)
            vis = np.zeros(len(image.xys), bool)
            vis[feat[pids != INVALID_POINT3D]] = True
            num_vis = int(vis.sum())
            pyr.set_points(image.xys[vis])
            if num_vis > 0:
                scores.append((pyr.score, num_vis, iid))
        scores.sort(key=lambda s: (-s[0], -s[1], s[2]))
        return [iid for _, _, iid in scores]

    def register_next_image(self, image_id: int,
                            options: IncrementalMapperOptions) -> bool:
        """2D-3D gather -> P3P LORANSAC -> pose refinement -> continue
        tracks (ref: RegisterNextImage :344)."""
        self._num_reg_trials[image_id] = \
            self._num_reg_trials.get(image_id, 0) + 1
        image = self.rec.images[image_id]
        cam = self.rec.cameras[image.camera_id]
        g = self.cache.correspondence_graph
        if g.offsets.get(image_id) is None:
            return False

        # 2D-3D correspondences in graph order, each (feature, point)
        # once (ref: :368-416).
        feat, pids = self._corr_points(image_id)
        ok = pids != INVALID_POINT3D
        feat, pids = feat[ok], pids[ok]
        _, first = np.unique((feat.astype(np.int64) << 32) | pids,
                             return_index=True)
        first = np.sort(first)
        p2d_idx = feat[first]
        p3d_ids = pids[first]
        if len(p3d_ids) < options.abs_pose_min_num_inliers:
            return False

        xyzs = np.stack([self.rec.points3D[int(p)].xyz for p in p3d_ids])
        xyn = self.triangulator.normalized(image_id)[p2d_idx]
        # sba_tpu's power-of-two bucket and mask (see the initial pair).
        n_real = len(p3d_ids)
        bucket = _bucket(n_real)
        pad = bucket - n_real
        dev = self.device
        xyzs_p = torch.as_tensor(np.concatenate(
            [xyzs, np.zeros((pad, 3))]), device=dev)
        xyn_p = torch.as_tensor(np.concatenate(
            [np.asarray(xyn), np.zeros((pad, 2))]), device=dev)
        valid = np.concatenate([np.ones(n_real), np.zeros(pad)])
        popt = AbsolutePoseOptions(ransac=RANSACOptions(
            max_error=options.abs_pose_max_error / cam.mean_focal_length(),
            min_inlier_ratio=options.abs_pose_min_inlier_ratio))
        seed = self._next_seed()
        samples = self._draws("P3P", seed, bucket,
                              num_required_trials(3, popt.ransac), 3, valid)
        t = time.perf_counter()
        report = estimate_absolute_pose(
            xyzs_p, xyn_p, options=popt,
            mask=torch.as_tensor(valid, device=dev),
            generator=torch.Generator(device=dev).manual_seed(seed),
            samples=samples)
        num_inliers = int(report.num_inliers)
        if num_inliers < options.abs_pose_min_num_inliers:
            self.stats["ransac_s"] += time.perf_counter() - t
            return False
        inlier_mask = report.inlier_mask.cpu().numpy()[:n_real]
        # Refine the pose on the inliers (ref: RefineAbsolutePose
        # :502-506); padded rows carry weight 0.
        q_r, t_r, _ = refine_absolute_pose(
            report.qvec, report.tvec, xyzs_p, xyn_p,
            weights=report.inlier_mask.to(xyzs_p.dtype))
        image.qvec = q_r.cpu().numpy().astype(np.float64)
        image.tvec = t_r.cpu().numpy().astype(np.float64)
        self.stats["ransac_s"] += time.perf_counter() - t
        self.rec.register_image(image_id)

        # Continue tracks with verified 2D-3D inliers (ref: :512-526).
        for k in np.nonzero(inlier_mask)[0]:
            f, pid = int(p2d_idx[k]), int(p3d_ids[k])
            if image.point3D_ids[f] == INVALID_POINT3D and \
                    pid in self.rec.points3D:
                if image_id not in self.rec.points3D[pid].image_ids:
                    self.rec.add_observation(pid, image_id, f)
        return True

    def triangulate_image(self, image_id: int,
                          tri_options: Optional[TriangulatorOptions] = None
                          ) -> int:
        return self.triangulator.triangulate_image(
            image_id, tri_options or TriangulatorOptions())

    # ------------------------------------------------------------------
    # bundle adjustment
    # ------------------------------------------------------------------

    def find_local_bundle(self, image_id: int,
                          options: IncrementalMapperOptions) -> List[int]:
        """Most-connected registered images by shared 3D points
        (ref: FindLocalBundle :942), ranked stably from first sight."""
        image = self.rec.images[image_id]
        tracks = []
        for pid in image.point3D_ids[image.point3D_ids != INVALID_POINT3D]:
            pt = self.rec.points3D.get(int(pid))
            if pt is not None:
                tracks.append(pt.image_ids)
        ids = (np.concatenate(tracks).astype(np.int64) if tracks
               else np.zeros(0, np.int64))
        ids = ids[ids != image_id]
        uniq, first, counts = np.unique(ids, return_index=True,
                                        return_counts=True)
        order = np.argsort(first, kind="stable")
        shared = [(int(uniq[k]), int(counts[k])) for k in order]
        ranked = sorted(shared, key=lambda kv: -kv[1])
        return [image_id] + [i for i, _ in
                             ranked[:options.local_ba_num_images - 1]]

    def _ba_options_with_model(self, base: BAOptions) -> BAOptions:
        """Pin BAOptions.model_id to the scene's camera model (the most
        common one): the residual evaluates one static camera head, and
        the default SIMPLE_PINHOLE would ignore a SIMPLE_RADIAL scene's
        distortion (ref: incremental_mapper.cc:435-506)."""
        ids = [cam.model_id for cam in self.rec.cameras.values()]
        if not ids:
            return base
        mid = max(set(ids), key=ids.count)
        if mid == base.model_id:
            return base
        return dataclasses.replace(base, model_id=int(mid))

    def _solve(self, arrays, problem, opt, kind):
        """Bundle-adjust a padded problem on the device and write poses,
        points and intrinsics back (the mapper's BA refines the cameras,
        unlike `adjust_bundle`)."""
        t = time.perf_counter()
        out, summary = bundle_adjust(pad_problem_pow2(problem), opt)
        self.rec.update_from_arrays(
            arrays, qvecs=out.qvecs.cpu().numpy(),
            tvecs=out.tvecs.cpu().numpy(),
            points=out.points.cpu().numpy(),
            camera_params=out.cam_params.cpu().numpy())
        self.stats["ba_s"] += time.perf_counter() - t
        self.stats[f"{kind}_ba"] += 1
        self.stats[f"{kind}_lm_it"] += int(summary.num_iterations)
        return summary

    def adjust_local_bundle(self, image_id: int,
                            options: IncrementalMapperOptions,
                            ba_options: Optional[BAOptions] = None) -> dict:
        """Local BA over the connected set; other poses fixed
        (ref: AdjustLocalBundle :1000-1109)."""
        local = self.find_local_bundle(image_id, options)
        reg = [i for i in self.rec.images if self.rec.is_registered(i)]
        arrays = self.rec.to_arrays(image_ids=reg)
        row_of = {iid: r for r, iid in enumerate(arrays.image_ids)}
        local_set = set(local)
        const_rows = [row_of[i] for i in reg if i not in local_set]
        # Gauge: if everything is local, fix the two first registered.
        if len(const_rows) == 0:
            const_rows = [row_of[i] for i in sorted(local)[:2]]
        # Cameras stay free: BAOptions.refine_* picks which intrinsics
        # move (ref: sfm/incremental_mapper.cc:435-506).
        opt = self._ba_options_with_model(
            ba_options or BAOptions(
                max_iterations=25, loss="cauchy", loss_scale=1.0))
        problem = build_problem(arrays, constant_pose_rows=const_rows,
                                device=self.device)
        summary = self._solve(arrays, problem, opt, "local")
        return dict(summary=summary, local_images=local)

    def adjust_global_bundle(self, options: IncrementalMapperOptions,
                             ba_options: Optional[BAOptions] = None) -> dict:
        """Ref: AdjustGlobalBundle :668 (gauge: the first pose and one
        tvec component of the second)."""
        reg = [i for i in self.rec.images if self.rec.is_registered(i)]
        if len(reg) < 2:
            raise ValueError("need >= 2 registered images for global BA")
        arrays = self.rec.to_arrays(image_ids=reg)
        problem = build_problem(arrays, constant_pose_rows=[0],
                                constant_tvec_rows={1: [0]},
                                device=self.device)
        opt = self._ba_options_with_model(
            ba_options or BAOptions(max_iterations=50))
        summary = self._solve(arrays, problem, opt, "global")
        return dict(summary=summary)

    # ------------------------------------------------------------------
    # filtering
    # ------------------------------------------------------------------

    def filter_points(self, options: IncrementalMapperOptions) -> int:
        """Reprojection error + triangulation angle filters
        (ref: FilterPoints :749 -> Reconstruction::FilterPoints3D)."""
        n = self.rec.filter_points_large_reprojection_error(
            options.filter_max_reproj_error)
        n += self._filter_small_angle_points(options.min_tri_angle)
        return n

    def _filter_small_angle_points(self, min_angle_deg: float) -> int:
        """Delete points whose largest pairwise triangulation angle over
        the registered views of their track is below the threshold
        (sba_tpu's [P, K] layout, K the longest track)."""
        pids = list(self.rec.points3D)
        if not pids:
            return 0
        reg = [iid for iid in self.rec.images if self.rec.is_registered(iid)]
        centers = np.stack([_projection_center(self.rec.images[i].qvec,
                                               self.rec.images[i].tvec)
                            for i in reg]) if reg else np.zeros((0, 3))
        pts = [self.rec.points3D[p] for p in pids]
        lens = np.fromiter((len(p.image_ids) for p in pts), np.int64,
                           len(pts))
        K = int(lens.max())
        P = len(pids)
        ims = np.concatenate([p.image_ids for p in pts]).astype(np.int64)
        r = np.repeat(np.arange(P), lens)
        c = np.arange(len(ims)) - np.repeat(np.cumsum(lens) - lens, lens)
        lut = np.full(max(max(reg, default=0), int(ims.max())) + 1, -1,
                      np.int64)
        lut[reg] = np.arange(len(reg))
        crow = lut[ims]
        ok = crow >= 0
        dirs = np.zeros((P, K, 3))
        valid = np.zeros((P, K), bool)
        dirs[r[ok], c[ok]] = centers[crow[ok]]
        valid[r[ok], c[ok]] = True
        xyz = np.stack([p.xyz for p in pts])
        d = dirs - xyz[:, None, :]
        n = np.linalg.norm(d, axis=-1)
        d = d / np.maximum(n, 1e-12)[..., None]
        cosang = np.einsum("pkc,plc->pkl", d, d)
        pair_ok = valid[:, :, None] & valid[:, None, :]
        cosang = np.where(pair_ok, np.clip(cosang, -1.0, 1.0), 1.0)
        max_ang = np.degrees(np.arccos(cosang.min(axis=(1, 2))))
        removed = 0
        for k, pid in enumerate(pids):
            if max_ang[k] < min_angle_deg:
                self.rec.delete_point3d(pid)
                removed += 1
        return removed

    def filter_images(self, options: IncrementalMapperOptions) -> List[int]:
        """Deregister images with bogus intrinsics or too few points
        (ref: FilterImages :764 -> Reconstruction::FilterImages)."""
        bad = []
        for iid in [i for i in self.rec.images
                    if self.rec.is_registered(i)]:
            image = self.rec.images[iid]
            cam = self.rec.cameras[image.camera_id]
            spec = camera_models.model_by_id(cam.model_id)
            ok = True
            for i in spec.focal_idxs:
                r = cam.params[i] / max(cam.width, cam.height)
                if not (options.min_focal_length_ratio <= r
                        <= options.max_focal_length_ratio):
                    ok = False
            for i in spec.extra_idxs:
                if abs(cam.params[i]) > options.max_extra_param:
                    ok = False
            if image.num_points3d() == 0:
                ok = False
            if not ok:
                self.rec.deregister_image(iid)
                bad.append(iid)
        return bad

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def num_registered_images(self) -> int:
        return self.rec.num_registered_images()


def _triangulate_two_view(R1, t1, R2, t2, n1, n2) -> np.ndarray:
    """Batch DLT for calibrated two-view (host numpy; one 4x4 SVD per
    point, stacked)."""
    P1 = np.hstack([R1, np.reshape(t1, (3, 1))])
    P2 = np.hstack([R2, np.reshape(t2, (3, 1))])
    n1 = np.asarray(n1).reshape(-1, 2)
    n2 = np.asarray(n2).reshape(-1, 2)
    A = np.stack([n1[:, 0:1] * P1[2] - P1[0],
                  n1[:, 1:2] * P1[2] - P1[1],
                  n2[:, 0:1] * P2[2] - P2[0],
                  n2[:, 1:2] * P2[2] - P2[1]], axis=1)
    if not len(A):
        return np.zeros((0, 3))
    X = np.linalg.svd(A)[2][:, -1]
    w = X[:, 3]
    return X[:, :3] / np.where(np.abs(w) > 1e-12, w, 1e-12)[:, None]
