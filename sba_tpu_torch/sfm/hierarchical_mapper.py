"""Hierarchical mapper: cluster the scene, map the leaves, merge models.

Port of ``sba_tpu/sfm/hierarchical_mapper.py`` (ref: src/controllers/
hierarchical_mapper.{h,cc} `HierarchicalMapperController`:
SceneClustering partition -> an incremental mapper per leaf -> merge by
common-image similarity alignment), with sba_tpu's extension: a
pose-graph relaxation of the merged model's seams (float64, on the
device).

The leaves are mapped one after another on one device (each mapper's
RANSACs and bundle adjustments run there); merging is host code. The
covisible pairs of the relaxation are counted in bulk over all tracks
(`optim.pose_graph.covisible_pairs`), in the order of sba_tpu's
``Counter``, so the graph's edges and their order are sba_tpu's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from sba_tpu_torch.geometry.quaternions import np_rotmat_to_quat
from sba_tpu_torch.geometry.similarity import umeyama
from sba_tpu_torch.io.colmap_models import Image
from sba_tpu_torch.io.database_cache import CorrespondenceGraph, DatabaseCache
from sba_tpu_torch.models.reconstruction import Reconstruction
from sba_tpu_torch.optim.pose_graph import (PoseGraphOptions,
                                            covisible_pairs, make_problem,
                                            optimize_pose_graph,
                                            relative_pose)
from sba_tpu_torch.sfm.controllers import (MapperControllerOptions,
                                           reconstruct_incremental)
from sba_tpu_torch.sfm.incremental_triangulator import (_projection_center,
                                                        _rotmat)
from sba_tpu_torch.sfm.scene_clustering import (SceneClustering,
                                                SceneClusteringOptions)


@dataclass
class HierarchicalMapperOptions:
    """Mirrors ref: hierarchical_mapper.h Options."""

    clustering: SceneClusteringOptions = field(
        default_factory=SceneClusteringOptions)
    mapper: MapperControllerOptions = field(
        default_factory=MapperControllerOptions)
    # Post-merge pose-graph relaxation of the seams (sba_tpu's extension
    # over the reference, which stops at similarity alignment).
    relax_poses: bool = True


def merge_reconstructions(rec1: Reconstruction, rec2: Reconstruction,
                          max_reproj_error: float = 8.0) -> bool:
    """Align rec2 onto rec1 by their common registered images (Umeyama on
    the projection centres) and merge it in (ref: reconstruction.cc
    Merge): rec2's new images are added, common images keep rec1's pose,
    rec2's tracks are re-added over free observations. rec2 is moved
    into rec1's frame in place. False (nothing changed) below 3 common
    images."""
    by_name1 = {rec1.images[i].name: i for i in rec1.images
                if rec1.is_registered(i)}
    by_name2 = {rec2.images[i].name: i for i in rec2.images
                if rec2.is_registered(i)}
    common = sorted(set(by_name1) & set(by_name2))
    if len(common) < 3:
        return False
    src = np.stack([_projection_center(rec2.images[by_name2[n]].qvec,
                                       rec2.images[by_name2[n]].tvec)
                    for n in common])
    dst = np.stack([_projection_center(rec1.images[by_name1[n]].qvec,
                                       rec1.images[by_name1[n]].tvec)
                    for n in common])
    s, R, t = umeyama(torch.as_tensor(src), torch.as_tensor(dst))
    s = float(s)
    R = R.numpy()
    t = t.numpy()

    for img in rec2.images.values():
        Rc_new = _rotmat(img.qvec) @ R.T
        img.qvec = np_rotmat_to_quat(Rc_new)
        img.tvec = s * img.tvec - Rc_new @ t
    for p in rec2.points3D.values():
        p.xyz = s * (R @ p.xyz) + t

    for iid, img in rec2.images.items():
        if img.name not in by_name1 and rec2.is_registered(iid):
            new_id = max(rec1.images, default=0) + 1
            rec1.add_image(Image(
                image_id=new_id, qvec=img.qvec.copy(), tvec=img.tvec.copy(),
                camera_id=img.camera_id, name=img.name, xys=img.xys.copy(),
                point3D_ids=np.full(len(img.xys), -1, np.int64)),
                registered=True)
            if img.camera_id not in rec1.cameras:
                rec1.add_camera(rec2.cameras[img.camera_id])
            by_name1[img.name] = new_id
    for p in rec2.points3D.values():
        track = []
        for im2, f2 in zip(p.image_ids, p.point2D_idxs):
            name = rec2.images[int(im2)].name
            if name in by_name1:
                i1 = by_name1[name]
                f2 = int(f2)
                if f2 < len(rec1.images[i1].point3D_ids) and \
                        rec1.images[i1].point3D_ids[f2] == -1:
                    track.append((i1, f2))
        if len(track) >= 2:
            rec1.add_point3d(p.xyz, track)
    rec1.filter_points_large_reprojection_error(max_reproj_error)
    return True


def relax_merged_model(base: Reconstruction,
                       partials: List[Reconstruction],
                       min_common_points: int = 10,
                       pg_options: Optional[PoseGraphOptions] = None,
                       device="cuda") -> bool:
    """Pose-graph relaxation of a merged model (float64 on `device`).

    Each partial's relative poses (already in the base frame, as
    `merge_reconstructions` leaves them) between registered images that
    share >= min_common_points points become SE(3) edges weighted by
    sqrt(#shared); the base's most connected image is the anchor.
    Conflicting measurements across the cluster seams spread in the
    least-squares sense. False when the graph has no edges."""
    name2base = {base.images[i].name: i for i in base.registered_image_ids}
    img_ids = list(base.registered_image_ids)
    id2row = {iid: k for k, iid in enumerate(img_ids)}

    ei, ej, wts, poses = [], [], [], []
    for part in partials:
        num_ids = max(part.images, default=0) + 1
        reg = np.zeros(num_ids, bool)
        reg[list(part.registered_image_ids)] = True
        tracks = [np.where(reg[ids], ids, -1) for ids in (
            np.asarray(pt.image_ids, np.int64)
            for pt in part.points3D.values())]
        pi, pj, cnt = covisible_pairs(tracks, num_ids)
        for i2, j2, c in zip(pi.tolist(), pj.tolist(), cnt.tolist()):
            if c < min_common_points:
                continue
            ni, nj = part.images[i2].name, part.images[j2].name
            if ni not in name2base or nj not in name2base:
                continue
            ri, rj = id2row[name2base[ni]], id2row[name2base[nj]]
            if ri == rj:
                continue
            ei.append(ri)
            ej.append(rj)
            wts.append(c)
            poses.append(np.concatenate(
                [part.images[i2].qvec, part.images[i2].tvec,
                 part.images[j2].qvec, part.images[j2].tvec]))
    if not ei:
        return False
    pz = torch.as_tensor(np.stack(poses).astype(np.float64))
    rq, rt = relative_pose(pz[:, 0:4], pz[:, 4:7], pz[:, 7:11], pz[:, 11:14])

    qvecs = np.stack([base.images[i].qvec for i in img_ids])
    tvecs = np.stack([base.images[i].tvec for i in img_ids])
    sqrt_info = np.sqrt(np.asarray(wts, np.float64))[:, None, None] \
        * np.eye(6)[None]
    deg = np.bincount(np.array(ei + ej), minlength=len(img_ids))
    fixed = np.zeros(len(img_ids))
    fixed[int(np.argmax(deg))] = 1.0
    problem = make_problem(qvecs, tvecs, np.asarray(ei), np.asarray(ej),
                           rq.numpy(), rt.numpy(), sqrt_info=sqrt_info,
                           pose_fixed=fixed, dtype=torch.float64,
                           device=device)
    opt = pg_options or PoseGraphOptions(max_iterations=50, loss="huber",
                                         loss_scale=1.0)
    out, _ = optimize_pose_graph(problem, opt)
    q = out.qvecs.cpu().numpy()
    t = out.tvecs.cpu().numpy()
    for k, iid in enumerate(img_ids):
        base.images[iid].qvec = q[k]
        base.images[iid].tvec = t[k]
    return True


def reconstruct_hierarchical(
    database_cache,
    options: Optional[HierarchicalMapperOptions] = None,
    device="cuda",
    draw_fn: Optional[Callable] = None,
    stats: Optional[dict] = None,
    leaf_models: Optional[list] = None,
) -> List[Reconstruction]:
    """Cluster, map each leaf, merge greedily into the largest model,
    relax the seams (ref: HierarchicalMapperController::Run). A scene
    that fits one leaf is mapped by one incremental mapper.

    `device` and `draw_fn` go to every leaf's `reconstruct_incremental`.
    When given, `stats` receives the leaves (images, models, seconds),
    the merges, the seconds of mapping, merging and relaxing and the
    leaves' mappers; `leaf_models` receives each leaf's models as they
    came from its mapper (copies, before any merge moves them)."""
    import copy

    opt = options or HierarchicalMapperOptions()
    st = stats if stats is not None else {}
    st.update(leaves=[], merges=0, relaxed=False, map_s=0.0, merge_s=0.0,
              relax_s=0.0, mappers=[])
    pairs = {k: len(v) for k, v in
             database_cache.correspondence_graph.image_pairs.items()}
    if not pairs:
        return []
    clustering = SceneClustering(opt.clustering)
    clustering.partition(pairs)
    leaves = clustering.leaf_clusters()
    if len(leaves) <= 1:
        t = time.perf_counter()
        models = reconstruct_incremental(database_cache, opt.mapper,
                                         device=device, draw_fn=draw_fn,
                                         mappers=st["mappers"])
        st["map_s"] = time.perf_counter() - t
        st["leaves"].append((database_cache.num_images(), len(models),
                             st["map_s"]))
        return models

    partials: List[Reconstruction] = []
    for leaf in leaves:
        t = time.perf_counter()
        sub = _subset_cache(database_cache, set(leaf.image_ids))
        models = reconstruct_incremental(sub, opt.mapper, device=device,
                                         draw_fn=draw_fn,
                                         mappers=st["mappers"])
        dt = time.perf_counter() - t
        st["map_s"] += dt
        st["leaves"].append((len(leaf.image_ids), len(models), dt))
        if leaf_models is not None:
            leaf_models.extend(copy.deepcopy(m) for m in models)
        partials.extend(models)
    if not partials:
        return []

    t = time.perf_counter()
    partials.sort(key=lambda r: -r.num_registered_images())
    base = partials[0]
    pending = partials[1:]
    merged = [base]
    progress = True
    while pending and progress:
        progress = False
        for k, rec in enumerate(pending):
            if merge_reconstructions(base, rec):
                merged.append(pending.pop(k))
                progress = True
                break
    st["merges"] = len(merged) - 1
    st["merge_s"] = time.perf_counter() - t
    if opt.relax_poses and len(merged) > 1:
        t = time.perf_counter()
        st["relaxed"] = relax_merged_model(base, merged, device=device)
        st["relax_s"] = time.perf_counter() - t
    return [base] + pending


def _subset_cache(cache, image_ids):
    """View of a DatabaseCache restricted to `image_ids` (the images are
    shared with `cache`, their observation counts those of the whole
    graph, as in sba_tpu)."""
    sub = DatabaseCache()
    sub.cameras = cache.cameras
    sub.images = {i: img for i, img in cache.images.items()
                  if i in image_ids}
    g = CorrespondenceGraph()
    for i, img in sub.images.items():
        g.add_image(i, len(img.keypoints))
    for (a, b), m in cache.correspondence_graph.image_pairs.items():
        if a in image_ids and b in image_ids:
            g.add_correspondences(a, b, m)
    g.finalize()
    sub.correspondence_graph = g
    return sub
