"""`colmap`-style command line of the port: the database commands,
the front end (features, matching, verification), the incremental and
hierarchical mappers and their commands, the pose graph, model merging,
global and rig BA, semantic and geometric-semantic BA, and the dense
chain.

    python -m sba_tpu_torch.cli database_creator --database_path db.db
    python -m sba_tpu_torch.cli database_cleaner --database_path db.db \
        --type matches
    python -m sba_tpu_torch.cli database_merger --database_path1 a.db \
        --database_path2 b.db --merged_database_path m.db
    python -m sba_tpu_torch.cli feature_extractor --database_path db.db \
        --image_path imgs/ [--SiftExtraction.use_gpu 0]
    python -m sba_tpu_torch.cli exhaustive_matcher --database_path db.db
    python -m sba_tpu_torch.cli sequential_matcher --database_path db.db
    python -m sba_tpu_torch.cli mapper --database_path db.db \
        --output_path sparse/ [--input_path sparse/0] [--Mapper.* v]
    python -m sba_tpu_torch.cli point_triangulator --database_path db.db \
        --input_path model/ --output_path tri/
    python -m sba_tpu_torch.cli image_registrator --database_path db.db \
        --input_path sparse/0 --output_path reg/
    python -m sba_tpu_torch.cli automatic_reconstructor \
        --workspace_path ws/ --image_path imgs/ [--dense 0]
    python -m sba_tpu_torch.cli hierarchical_mapper --database_path db.db \
        --output_path sparse/ [--SceneClustering.leaf_max_num_images 500] \
        [--SceneClustering.image_overlap 50] [--leaf_output_path leaves/]
    python -m sba_tpu_torch.cli model_merger --input_path1 sparse/0 \
        --input_path2 other/0 --output_path merged/
    python -m sba_tpu_torch.cli pose_graph_optimizer --input_path sparse/0 \
        --output_path relaxed/ [--PoseGraph.sim3 0] [--PoseGraph.loss huber]
    python -m sba_tpu_torch.cli rig_bundle_adjuster --input_path sparse/0 \
        --output_path rig/ --rig_config_path rig.json \
        [--BundleAdjustment.model_id 2]
    python -m sba_tpu_torch.cli bundle_adjuster --input_path sparse/0 \
        --output_path ba/ [--device cuda] [--BundleAdjustment.dtype float32]
    python -m sba_tpu_torch.cli semantic_bundle_adjuster \
        --input_path sparse/0 --output_path sba/ --data_path maps/ \
        [--run_path run/] [--SemanticBundleAdjustment.mode hard_numeric]
    python -m sba_tpu_torch.cli geometric_semantic_bundle_adjuster \
        --input_path sparse/0 --output_path gsba/ --data_path maps/ \
        --input_geometry cylinders.txt [--output_geometry out.txt] \
        [--GeometricSemanticBundleAdjustment.max_iterations 40]
    python -m sba_tpu_torch.cli image_undistorter --image_path images \
        --input_path sparse/0 --output_path ws [--device cuda]
    python -m sba_tpu_torch.cli patch_match_stereo --workspace_path ws
    python -m sba_tpu_torch.cli stereo_fuser --workspace_path ws \
        --output_path ws/fused.ply

Flags, file layout and printed lines follow sba_tpu's CLI. ``--device``
(default "cuda") selects where a command runs; the database commands
run on the host. On CUDA, bundle_adjuster
with ``--BundleAdjustment.dtype float32`` goes through the BA kernels,
semantic_bundle_adjuster samples every map through the map-gather
kernels and patch_match_stereo scores through the NCC kernel, and those
commands print the launch counts of their kernels; feature_extractor
samples SIFT's gradients through the map_gather kernel and prints its
launches, and the matchers print their match / verify / host seconds.
``--SiftExtraction.use_gpu 0`` and ``--SiftMatching.use_gpu 0`` ask for
the CPU, as ``--device cpu`` does. The mapper commands run their RANSACs
and bundle adjustments (float64) on the device and print, besides
sba_tpu's lines, their seconds in BA, in RANSAC and on the host;
hierarchical_mapper also splits its wall into the leaves' mappers,
merging and the seam relaxation (a float64 pose graph on the device).
pose_graph_optimizer solves in float32 and rig_bundle_adjuster in
float64 on the device; model_merger is host work.
``automatic_reconstructor --dense 1`` raises: its chain ends in the
meshers, which are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from sba_tpu_torch.options import apply_flags, parse_flags


def _require(flags, *names):
    missing = [n for n in names if n not in flags]
    if missing:
        raise SystemExit(
            "missing required flags: " + " ".join(f"--{m}" for m in missing))
    return [flags[n] for n in names]


# ---------------------------------------------------------------------------
# database commands (ref: exe/database.cc)
# ---------------------------------------------------------------------------


def run_database_creator(flags):
    from sba_tpu_torch.io.database import Database

    (path,) = _require(flags, "database_path")
    Database(path).close()
    print(f"created database {path}")


def run_database_cleaner(flags):
    """Drop matches and two-view geometries, features, or everything
    (ref: exe/database.cc RunDatabaseCleaner, --type all|matches|features)."""
    from sba_tpu_torch.io.database import Database

    path, clean_type = _require(flags, "database_path", "type")
    db = Database(path)
    t = clean_type.lower()
    if t in ("all", "matches"):
        db.conn.execute("DELETE FROM matches")
        db.conn.execute("DELETE FROM two_view_geometries")
    if t in ("all", "features"):
        db.conn.execute("DELETE FROM keypoints")
        db.conn.execute("DELETE FROM descriptors")
    if t == "all":
        db.conn.execute("DELETE FROM images")
        db.conn.execute("DELETE FROM cameras")
    db.commit()
    db.close()
    print(f"cleaned ({t}) {path}")


def run_database_merger(flags):
    """Merge two databases into one (ref: exe/database.cc
    RunDatabaseMerger); image and camera ids are remapped, image names
    must be disjoint."""
    from sba_tpu_torch.io.database import Database

    p1, p2, out = _require(flags, "database_path1", "database_path2",
                           "merged_database_path")
    dbo = Database(out)
    for src_path in (p1, p2):
        src = Database(src_path)
        cam_map = {}
        for cid, cam in src.read_cameras().items():
            cam_map[cid] = dbo.write_camera(
                cam["model_id"], cam["width"], cam["height"],
                cam["params"], cam["prior_focal_length"])
        img_map = {}
        for iid, img in src.read_images().items():
            img_map[iid] = dbo.write_image(
                img["name"], cam_map[img["camera_id"]])
            kp = src.read_keypoints(iid)
            if len(kp):
                dbo.write_keypoints(img_map[iid], kp)
            d = src.read_descriptors(iid)
            if len(d):
                dbo.write_descriptors(img_map[iid], d)
        for (a, b), m in src.read_all_matches().items():
            dbo.write_matches(img_map[a], img_map[b], m)
        for (a, b), g in src.read_all_two_view_geometries().items():
            dbo.write_two_view_geometry(
                img_map[a], img_map[b], g["inlier_matches"],
                config=g["config"], F=g["F"], E=g["E"], H=g["H"],
                qvec=g["qvec"], tvec=g["tvec"])
        src.close()
    dbo.close()
    print(f"merged {p1} + {p2} -> {out}")



# ---------------------------------------------------------------------------
# feature commands (ref: exe/feature.cc)
# ---------------------------------------------------------------------------


_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")
_FALSE = ("0", "false", "False")


def _list_images(image_path, image_list_path=None) -> List[str]:
    if image_list_path:
        with open(image_list_path) as f:
            return [l.strip() for l in f if l.strip()]
    names = []
    for root, _dirs, files in os.walk(image_path):
        for fn in sorted(files):
            if fn.lower().endswith(_IMAGE_EXTS):
                names.append(os.path.relpath(os.path.join(root, fn),
                                             image_path))
    return sorted(names)


def _frontend_device(flags, section: str) -> str:
    """`--<section>.use_gpu 0` asks for the CPU, as `--device cpu` does;
    otherwise `_device` (a missing card fails). The two flags of the
    section that are not options of its dataclass (use_gpu, batch_size)
    are taken out of `flags`."""
    use_gpu = flags.pop(f"{section}.use_gpu", "1") not in _FALSE
    return _device(flags) if use_gpu else "cpu"


def run_feature_extractor(flags):
    """Ref: exe/feature.cc:104 RunFeatureExtractor: load on the host,
    register cameras (EXIF focal prior, else the default factor) and
    images, then extract in fixed-size batches of same-shape images on
    the device (the last batch padded by repetition) and write the
    keypoints and uint8 descriptors."""
    from sba_tpu_torch.features.sift import (
        SiftExtractionOptions, extract_sift_batch, load_image_gray)
    from sba_tpu_torch.geometry import camera_models
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.io.image_reader import (
        ImageReaderOptions, camera_params_for_image)
    from sba_tpu_torch.ops import map_gather

    db_path, image_path = _require(flags, "database_path", "image_path")
    flags = dict(flags)
    device = _frontend_device(flags, "SiftExtraction")
    batch_size = int(flags.pop("SiftExtraction.batch_size", "8"))
    opt = apply_flags(SiftExtractionOptions(), "SiftExtraction", flags)
    camera_model = flags.get("ImageReader.camera_model", "SIMPLE_RADIAL")
    single_camera = flags.get("ImageReader.single_camera", "0") in (
        "1", "true", "True")
    names = _list_images(image_path, flags.get("image_list_path"))
    if not names:
        raise SystemExit(f"no images found under {image_path}")

    db = Database(db_path)
    spec = camera_models.model_by_name(camera_model)
    reader_opt = ImageReaderOptions(camera_model=camera_model,
                                    single_camera=single_camera)
    shared_camera_id = None
    by_shape = {}
    for name in names:
        full = os.path.join(image_path, name)
        img = load_image_gray(full, max_size=opt.max_image_size)
        h, w = img.shape
        if shared_camera_id is None or not single_camera:
            _model, params, has_prior = camera_params_for_image(
                full, w, h, reader_opt)
            cam_id = db.write_camera(spec.model_id, w, h, params,
                                     prior_focal_length=has_prior)
            if single_camera:
                shared_camera_id = cam_id
        else:
            cam_id = shared_camera_id
        image_id = db.write_image(name, cam_id)
        by_shape.setdefault(img.shape, []).append((image_id, name, img))

    map_gather.reset_launches()
    total = 0
    t_dev = 0.0
    for _shape, items in by_shape.items():
        for i0 in range(0, len(items), batch_size):
            chunk = items[i0:i0 + batch_size]
            stack = np.stack([c[2] for c in chunk])
            if len(chunk) < batch_size:
                stack = np.concatenate([stack, np.repeat(
                    stack[-1:], batch_size - len(chunk), axis=0)])
            t = time.perf_counter()
            kps, desc_u8, mask = extract_sift_batch(stack, opt, device=device)
            t_dev += time.perf_counter() - t
            for j, (image_id, name, _img) in enumerate(chunk):
                m = mask[j]
                db.write_keypoints(image_id, kps[j][m])
                db.write_descriptors(image_id, desc_u8[j][m])
                total += 1
                print(f"  {name}: {int(m.sum())} features")
    db.commit()
    db.close()
    print(f"extracted features for {total} images -> {db_path} [{device}]")
    print(f"extraction: {t_dev:.3f} s for {total} images "
          f"({total / max(t_dev, 1e-9):.3f} images/s)")
    if device != "cpu":
        print("kernel launches: " + json.dumps(
            {"map_gather": map_gather.LAUNCHES["map_gather"]}))


def _match_and_verify(db, pairs_idx, image_ids, flags):
    """Matching and geometric verification shared by the matcher commands
    (ref: feature/matching.cc SiftFeatureMatcher + verifier): the
    descriptors go to the device once as an [I, npad, 128] uint8 stack;
    each batch of `SiftMatching.batch_size` pairs is matched in one call,
    and its non-empty pairs are verified (E/F/H) in one call at the
    batch's power-of-two match bucket; the host writes the database.
    Prints the seconds spent matching, verifying and on the host."""
    import torch

    from sba_tpu_torch.estimators.two_view_geometry import (
        TwoViewGeometryOptions, estimate_two_view_geometry_batch,
        pack_matches)
    from sba_tpu_torch.features.matching import (
        SiftMatchingOptions, match_pairs_batched)
    from sba_tpu_torch.geometry import camera_models

    flags = dict(flags)
    device = _frontend_device(flags, "SiftMatching")
    Bp = int(flags.pop("SiftMatching.batch_size", "32"))
    mopt = apply_flags(SiftMatchingOptions(), "SiftMatching", flags)
    vopt = apply_flags(TwoViewGeometryOptions(), "TwoViewGeometry", flags)

    cams = db.read_cameras()
    images = db.read_images()
    max_n = 1
    for iid in image_ids:
        max_n = max(max_n, db.num_keypoints_for_image(iid))
    npad = max(256, -(-max_n // 256) * 256)

    I = len(image_ids)
    stack = np.zeros((I, npad, 128), np.uint8)
    nvalid = np.zeros(I, np.int32)
    kp_cache = {}
    for ii, iid in enumerate(image_ids):
        d = db.read_descriptors(iid)
        nvalid[ii] = len(d)
        stack[ii, :len(d)] = d
        kp_cache[ii] = db.read_keypoints(iid)
    stack_dev = torch.as_tensor(stack, device=device)
    nvalid_dev = torch.as_tensor(nvalid, device=device)

    def fxycxy(iid):
        cam = cams[images[iid]["camera_id"]]
        spec = camera_models.model_by_id(cam["model_id"])
        p = cam["params"]
        fi = spec.focal_idxs
        return (p[fi[0]], p[fi[-1]], p[spec.principal_idxs[0]],
                p[spec.principal_idxs[1]])

    def imsize(iid):
        cam = cams[images[iid]["camera_id"]]
        return (cam["width"], cam["height"])

    t_match = t_verify = t_host = 0.0
    num_verified = 0
    pairs_list = [tuple(int(v) for v in p) for p in pairs_idx]
    for b0 in range(0, len(pairs_list), Bp):
        batch = pairs_list[b0:b0 + Bp]
        t0 = time.perf_counter()
        pidx = np.array(batch + [batch[-1]] * (Bp - len(batch)), np.int64)
        m_dev, _n = match_pairs_batched(stack_dev, nvalid_dev, pidx, mopt)
        m_all = m_dev.cpu().numpy()
        t_match += time.perf_counter() - t0

        t0 = time.perf_counter()
        verify = []
        for j, (a, b) in enumerate(batch):
            row = m_all[j]
            i1f = np.nonzero(row >= 0)[0]
            m = np.stack([i1f, row[i1f]], axis=-1).astype(np.int32)
            if len(m) == 0:
                continue
            db.write_matches(image_ids[a], image_ids[b], m.astype(np.uint32))
            verify.append((a, b, m))
        t_host += time.perf_counter() - t0
        if not verify:
            continue
        xy1, xy2, vmask = pack_matches(kp_cache, verify)
        Bv = len(verify)
        c1 = np.zeros((Bv, 4))
        c2 = np.zeros((Bv, 4))
        sz1, sz2 = [], []
        for j, (a, b, _) in enumerate(verify):
            i1, i2 = image_ids[a], image_ids[b]
            c1[j] = fxycxy(i1)
            c2[j] = fxycxy(i2)
            sz1.append(imsize(i1))
            sz2.append(imsize(i2))
        t0 = time.perf_counter()
        tvs = estimate_two_view_geometry_batch(
            xy1, xy2, vmask, c1, c2, sz1, sz2, options=vopt, seed=b0,
            dtype=torch.float32, device=device)
        t_verify += time.perf_counter() - t0
        t0 = time.perf_counter()
        for (a, b, m), tv in zip(verify, tvs):
            i1, i2 = image_ids[a], image_ids[b]
            inl = m[tv.inlier_mask[:len(m)]] if tv.num_inliers else m[:0]
            db.write_two_view_geometry(
                i1, i2, inl.astype(np.uint32), config=tv.config, F=tv.F,
                E=tv.E, H=tv.H, qvec=tv.qvec, tvec=tv.tvec)
            if tv.num_inliers >= vopt.min_num_inliers:
                num_verified += 1
            print(f"  pair ({images[i1]['name']}, {images[i2]['name']}): "
                  f"{len(m)} matches, {tv.num_inliers} inliers")
        t_host += time.perf_counter() - t0
    db.commit()
    n = len(pairs_list)
    print(f"match {t_match:.3f} s, verify {t_verify:.3f} s, host/db "
          f"{t_host:.3f} s for {n} pairs "
          f"({n / max(t_match + t_verify, 1e-9):.3f} pairs/s matched and "
          f"verified) [{device}]")
    return num_verified


def run_exhaustive_matcher(flags):
    """Ref: exe/feature.cc:221."""
    from sba_tpu_torch.features.pairing import exhaustive_pairs
    from sba_tpu_torch.io.database import Database

    (db_path,) = _require(flags, "database_path")
    db = Database(db_path)
    image_ids = sorted(db.read_images())
    block = int(flags.get("ExhaustiveMatching.block_size", "50"))
    pairs = exhaustive_pairs(len(image_ids), block_size=block)
    n = _match_and_verify(db, pairs, image_ids, flags)
    db.close()
    print(f"verified {n}/{len(pairs)} pairs")


def run_sequential_matcher(flags):
    """Ref: exe/feature.cc:298: image i against i+1..i+overlap and the
    quadratic jumps i+2^k. `SequentialMatching.loop_detection 1` needs
    the vocabulary tree, which is not ported yet, and fails."""
    from sba_tpu_torch.features.pairing import sequential_pairs
    from sba_tpu_torch.io.database import Database

    (db_path,) = _require(flags, "database_path")
    if flags.get("SequentialMatching.loop_detection", "0") not in _FALSE:
        raise SystemExit("--SequentialMatching.loop_detection needs the "
                         "vocabulary tree, which is not ported yet")
    db = Database(db_path)
    image_ids = sorted(db.read_images())
    overlap = int(flags.get("SequentialMatching.overlap", "10"))
    quad = flags.get("SequentialMatching.quadratic_overlap", "1") in (
        "1", "true", "True")
    pairs = list(sequential_pairs(len(image_ids), overlap=overlap,
                                  quadratic_overlap=quad))
    n = _match_and_verify(db, pairs, image_ids, flags)
    db.close()
    print(f"verified {n}/{len(pairs)} pairs")


# ---------------------------------------------------------------------------
# sfm commands (ref: exe/sfm.cc)
# ---------------------------------------------------------------------------


def _load_cache(db_path, min_num_matches=15):
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.io.database_cache import DatabaseCache

    db = Database(db_path)
    cache = DatabaseCache.create(db, min_num_matches=min_num_matches)
    db.close()
    return cache


def _print_mapper_stats(mappers, wall, device):
    st = {k: sum(m.stats[k] for m in mappers)
          for k in ("ba_s", "ransac_s", "local_ba", "global_ba",
                    "local_lm_it", "global_lm_it")}
    nreg = sum(m.rec.num_registered_images() for m in mappers)
    host = wall - st["ba_s"] - st["ransac_s"]
    for k, m in enumerate(mappers):
        if m.init_pair is not None:
            print(f"mapper {k}: initial pair {m.init_pair[:2]}, two-view "
                  f"seed {m.init_pair[2]}")
    print(f"mapper: {wall:.3f} s, {nreg} registrations "
          f"({nreg / max(wall, 1e-9):.4f} registrations/s); BA "
          f"{st['ba_s']:.3f} s (local {st['local_ba']} BAs, "
          f"{st['local_lm_it']} LM it; global {st['global_ba']} BAs, "
          f"{st['global_lm_it']} LM it), RANSAC {st['ransac_s']:.3f} s, "
          f"host {host:.3f} s [{device}]")


def run_mapper(flags):
    """Ref: exe/sfm.cc:249 RunMapper."""
    from sba_tpu_torch.sfm.controllers import (MapperControllerOptions,
                                               reconstruct_incremental)

    db_path, output_path = _require(flags, "database_path", "output_path")
    device = _device(flags)
    opt = MapperControllerOptions()
    opt.mapper = apply_flags(opt.mapper, "Mapper", flags)
    opt.min_num_matches = int(flags.get("Mapper.min_num_matches", "15"))
    opt.snapshot_path = flags.get("Mapper.snapshot_path") or None
    opt.snapshot_images_freq = int(
        flags.get("Mapper.snapshot_images_freq", "0"))
    opt.live_viewer_path = flags.get("Mapper.live_viewer_path") or None

    t0 = time.perf_counter()
    cache = _load_cache(db_path, opt.min_num_matches)
    print(f"loaded {cache.num_images()} images, "
          f"{len(cache.correspondence_graph.image_pairs)} pairs")

    # Resume from an existing model (ref: exe/sfm.cc RunMapper
    # input_path, controllers/incremental_mapper.cc:394-399).
    initial = None
    input_path = flags.get("input_path", "")
    if input_path:
        from sba_tpu_torch.models.reconstruction import Reconstruction

        initial = Reconstruction.read(input_path)
        print(f"resuming from {input_path}: "
              f"{initial.num_registered_images()} registered images")

    mappers = []
    models = reconstruct_incremental(
        cache, opt, initial_reconstruction=initial,
        callback=lambda ev, info: (print(f"  [{ev}] {info}"), True)[1],
        device=device, mappers=mappers)
    wall = time.perf_counter() - t0
    _write_models(models, output_path)
    _print_mapper_stats(mappers, wall, device)
    if not models:
        print("reconstruction failed: no model")
        raise SystemExit(1)


def _write_models(models, output_path):
    os.makedirs(output_path, exist_ok=True)
    for k, rec in enumerate(models):
        out = os.path.join(output_path, str(k))
        os.makedirs(out, exist_ok=True)
        rec.write(out)
        print(f"model {k}: {rec.num_registered_images()} images, "
              f"{rec.num_points3d()} points -> {out}")


def run_hierarchical_mapper(flags):
    """Cluster -> per-leaf mapping -> merge -> seam relaxation
    (ref: exe/sfm.cc:326 RunHierarchicalMapper). Prints sba_tpu's model
    lines, then the leaves, the mappers' account (as `mapper`) and the
    wall split into the leaves' mappers, merging and relaxing.
    `--leaf_output_path DIR` also writes each leaf's models, as its
    mapper left them, to DIR/0, DIR/1, ..."""
    from sba_tpu_torch.sfm.hierarchical_mapper import (
        HierarchicalMapperOptions, reconstruct_hierarchical)

    db_path, output_path = _require(flags, "database_path", "output_path")
    device = _device(flags)
    opt = HierarchicalMapperOptions()
    opt.clustering = apply_flags(opt.clustering, "SceneClustering", flags)
    opt.mapper.mapper = apply_flags(opt.mapper.mapper, "Mapper", flags)
    leaf_path = flags.get("leaf_output_path") or None
    t0 = time.perf_counter()
    cache = _load_cache(db_path)
    stats = {}
    leaf_models = [] if leaf_path else None
    models = reconstruct_hierarchical(cache, opt, device=device, stats=stats,
                                      leaf_models=leaf_models)
    wall = time.perf_counter() - t0
    _write_models(models, output_path)
    if leaf_path:
        for k, rec in enumerate(leaf_models):
            out = os.path.join(leaf_path, str(k))
            os.makedirs(out, exist_ok=True)
            rec.write(out)
    for k, (n_img, n_models, sec) in enumerate(stats["leaves"]):
        print(f"leaf {k}: {n_img} images -> {n_models} models in "
              f"{sec:.3f} s")
    _print_mapper_stats(stats["mappers"], stats["map_s"], device)
    print(f"hierarchical mapper: {wall:.3f} s; leaves' mappers "
          f"{stats['map_s']:.3f} s, merging {stats['merge_s']:.3f} s "
          f"({stats['merges']} merges), relaxing {stats['relax_s']:.3f} s "
          f"(relaxed: {stats['relaxed']}) [{device}]")
    if not models:
        raise SystemExit(1)


def run_pose_graph_optimizer(flags):
    """SE(3)/Sim(3) pose-graph relaxation over the covisibility graph of
    a model (sba_tpu's extension; COLMAP has no pose-graph command).
    Flags: --input_path --output_path [--PoseGraph.min_common_points 15]
    [--PoseGraph.max_iterations 50] [--PoseGraph.sim3 0]
    [--PoseGraph.loss huber] [--PoseGraph.loss_scale 1.0]. The problem
    is float32 (sba_tpu's `make_problem` default), solved on the device;
    besides sba_tpu's line the command prints its wall seconds and the
    PCG iterations of each LM iteration."""
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.optim.pose_graph import (
        PoseGraphOptions, apply_pose_graph_result, optimize_pose_graph,
        pose_graph_from_reconstruction)

    input_path, output_path = _require(flags, "input_path", "output_path")
    device = _device(flags)
    rec = Reconstruction.read(input_path)
    min_common = int(flags.get("PoseGraph.min_common_points", "15"))
    sim3 = flags.get("PoseGraph.sim3", "0") in ("1", "true", "True")
    opt = PoseGraphOptions(
        max_iterations=int(flags.get("PoseGraph.max_iterations", "50")),
        sim3=sim3,
        loss=flags.get("PoseGraph.loss", "huber"),
        loss_scale=float(flags.get("PoseGraph.loss_scale", "1.0")))
    t0 = time.perf_counter()
    problem, img_ids = pose_graph_from_reconstruction(
        rec, min_common_points=min_common, sim3=sim3, device=device)
    out, s = optimize_pose_graph(problem, opt)
    apply_pose_graph_result(rec, out, img_ids)
    wall = time.perf_counter() - t0
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"pose graph: {len(img_ids)} nodes, "
          f"{int(s.num_residuals)} edges, cost "
          f"{float(s.initial_cost):.6g} -> {float(s.final_cost):.6g} "
          f"in {int(s.num_iterations)} iters")
    print(f"pose graph: {wall:.3f} s, CG iterations per LM iteration "
          f"{s.cg_iterations[:s.num_iterations].tolist()} [{device}]")


def run_model_merger(flags):
    """Merge two models sharing common images (ref: exe/model.cc
    RunModelMerger). The alignment and the merge are host work; the
    command takes --device as the others do."""
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.sfm.hierarchical_mapper import merge_reconstructions

    input_path1, input_path2, output_path = _require(
        flags, "input_path1", "input_path2", "output_path")
    _device(flags)
    rec1 = Reconstruction.read(input_path1)
    rec2 = Reconstruction.read(input_path2)
    if not merge_reconstructions(rec1, rec2):
        raise SystemExit("merge failed: < 3 common registered images")
    os.makedirs(output_path, exist_ok=True)
    rec1.write(output_path)
    print(f"merged: {rec1.num_registered_images()} images, "
          f"{rec1.num_points3d()} points -> {output_path}")


def run_rig_bundle_adjuster(flags):
    """Rig-constrained bundle adjustment (ref: exe/sfm.cc:728
    RunRigBundleAdjuster; --rig_config_path a JSON list of rigs, each
    with ref_camera_id and cameras of camera_id and image_prefix; images
    are grouped into snapshots by their names with the prefix
    stripped). The solve runs in float64 on the device; besides
    sba_tpu's lines the command prints its cost, iterations and wall
    seconds."""
    from sba_tpu_torch.models.camera_rig import (CameraRig,
                                                 rig_bundle_adjust)
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.optim.ba import BAOptions, build_problem

    input_path, output_path, rig_config_path = _require(
        flags, "input_path", "output_path", "rig_config_path")
    device = _device(flags)
    rec = Reconstruction.read(input_path)
    with open(rig_config_path) as f:
        config = json.load(f)

    arrays = rec.to_arrays()
    row_of = {int(iid): r for r, iid in enumerate(arrays.image_ids)}
    n_img = arrays.num_images
    snap_ids = np.full(n_img, -1, np.int64)
    cam_qs = np.tile(np.array([1.0, 0, 0, 0]), (n_img, 1))
    cam_ts = np.zeros((n_img, 3))
    n_snaps = 0
    for rig_cfg in config:
        rig = CameraRig(ref_camera_id=int(rig_cfg["ref_camera_id"]))
        prefix_of = {}
        for cam_cfg in rig_cfg["cameras"]:
            rig.add_camera(int(cam_cfg["camera_id"]))
            prefix_of[int(cam_cfg["camera_id"])] = \
                cam_cfg.get("image_prefix", "")
        groups = {}
        for iid, im in rec.images.items():
            if not rec.is_registered(iid) or \
                    im.camera_id not in prefix_of:
                continue
            suffix = im.name[len(prefix_of[im.camera_id]):]
            groups.setdefault(suffix, []).append(iid)
        for suffix in sorted(groups):
            rig.add_snapshot(groups[suffix])
        rig.compute_rig_from_reconstruction(rec)
        for snap in rig.snapshots:
            for iid in snap:
                row = row_of.get(int(iid))
                if row is None:
                    continue
                snap_ids[row] = n_snaps
                q, t = rig.cams_from_rig[rec.images[iid].camera_id]
                cam_qs[row] = q
                cam_ts[row] = t
            n_snaps += 1
        print(f"Camera Rig: {rig.num_cameras()} cameras, "
              f"{len(rig.snapshots)} snapshots")
    # Images outside every rig get a snapshot of their own.
    for row in range(n_img):
        if snap_ids[row] < 0:
            snap_ids[row] = n_snaps
            n_snaps += 1

    t0 = time.perf_counter()
    problem = build_problem(arrays, constant_pose_rows=(0,), device=device)
    opt = apply_flags(BAOptions(), "BundleAdjustment", flags)
    refine_rel = flags.get("RigBundleAdjustment.refine_relative_poses",
                           "0") in ("1", "true", "True")
    out = rig_bundle_adjust(problem, snap_ids, cam_qs, cam_ts, options=opt,
                            refine_relative_poses=refine_rel)
    _sync(device)
    wall = time.perf_counter() - t0
    rec.update_from_arrays(arrays,
                           qvecs=out["image_qvecs"].cpu().numpy(),
                           tvecs=out["image_tvecs"].cpu().numpy())
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"rig BA final cost: {float(out['final_cost']):.6g}")
    print(f"rig BA: {n_snaps} snapshots, cost "
          f"{float(out['initial_cost']):.6g} -> "
          f"{float(out['final_cost']):.6g} in {out['num_iterations']} "
          f"iterations ({int(out['num_accepted'])} accepted), "
          f"{wall:.3f} s [{device}]")


def run_point_triangulator(flags):
    """Triangulate points against FIXED known poses
    (ref: exe/sfm.cc:403 RunPointTriangulator)."""
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.sfm.incremental_mapper import IncrementalMapper
    from sba_tpu_torch.sfm.incremental_triangulator import \
        TriangulatorOptions

    db_path, input_path, output_path = _require(
        flags, "database_path", "input_path", "output_path")
    device = _device(flags)
    rec = Reconstruction.read(input_path)
    mapper = IncrementalMapper(_load_cache(db_path), device=device)
    mapper.begin_reconstruction(rec)
    topt = apply_flags(TriangulatorOptions(), "Mapper", flags)
    total = 0
    for iid in list(rec.images):
        if rec.is_registered(iid):
            total += mapper.triangulate_image(iid, topt)
    mapper.triangulator.complete_tracks(list(rec.points3D), topt)
    mapper.triangulator.merge_tracks(list(rec.points3D), topt)
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"triangulated {total} observations, "
          f"{rec.num_points3d()} points -> {output_path}")


def run_image_registrator(flags):
    """Register NEW images into an existing model without modifying it
    (ref: exe/sfm.cc RunImageRegistrator)."""
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.sfm.incremental_mapper import (
        IncrementalMapper, IncrementalMapperOptions)

    db_path, input_path, output_path = _require(
        flags, "database_path", "input_path", "output_path")
    device = _device(flags)
    rec = Reconstruction.read(input_path)
    mapper = IncrementalMapper(_load_cache(db_path), device=device)
    mapper.begin_reconstruction(rec)
    opt = apply_flags(IncrementalMapperOptions(), "Mapper", flags)
    n = 0
    for iid in mapper.find_next_images(opt):
        if mapper.register_next_image(iid, opt):
            n += 1
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"registered {n} additional images -> {output_path}")


def run_automatic_reconstructor(flags):
    """One command from images to a sparse model: database_creator,
    feature_extractor, exhaustive_matcher, mapper (ref: exe/sfm.cc:50
    RunAutomaticReconstructor). `--dense 1` would go on through the
    dense chain to the Poisson or Delaunay mesher, which are not ported
    yet: it raises before any work."""
    workspace, image_path = _require(flags, "workspace_path", "image_path")
    if flags.get("dense", "0") in ("1", "true", "True"):
        raise SystemExit(
            "--dense 1 ends in the Poisson and Delaunay meshers, which are "
            "not ported yet (ROADMAP Queue 1, item 2); run --dense 0, "
            "then image_undistorter, patch_match_stereo and stereo_fuser")
    _device(flags)
    quality = flags.get("quality", "high")
    db_path = os.path.join(workspace, "database.db")
    sparse = os.path.join(workspace, "sparse")
    os.makedirs(workspace, exist_ok=True)

    base = dict(flags)
    base.pop("dense", None)
    base.pop("quality", None)
    base["database_path"] = db_path
    run_database_creator({"database_path": db_path})
    fe = dict(base)
    fe["image_path"] = image_path
    if quality == "low":
        fe.setdefault("SiftExtraction.max_num_features", "2048")
    run_feature_extractor(fe)
    run_exhaustive_matcher(base)
    mp = dict(base)
    mp["output_path"] = sparse
    run_mapper(mp)
    print(f"automatic reconstruction complete -> {workspace}")


def run_bundle_adjuster(flags):
    """Global bundle adjustment of a COLMAP model."""
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.ops import ba_kernels
    from sba_tpu_torch.optim.ba import BAOptions
    from sba_tpu_torch.sfm.controllers import adjust_bundle

    input_path, output_path = _require(flags, "input_path", "output_path")
    device = flags.get("device", "cuda")
    rec = Reconstruction.read(input_path)
    opt = apply_flags(BAOptions(), "BundleAdjustment", flags)
    out = adjust_bundle(rec, opt, device=device)
    s = out["summary"]
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"BA: cost {float(s.initial_cost):.6g} -> "
          f"{float(s.final_cost):.6g} in {int(s.num_iterations)} iters")
    if device != "cpu":
        print("kernel launches: " + json.dumps(ba_kernels.LAUNCHES))


def run_semantic_bundle_adjuster(flags):
    """Semantic bundle adjustment of a COLMAP model against per-image
    depth and semantic TIFF maps (ref: exe/sfm.cc:169
    RunSemanticBundleAdjuster)."""
    from sba_tpu_torch.controllers.semantic_ba import (
        SemanticBAControllerOptions,
        run_semantic_bundle_adjustment,
    )
    from sba_tpu_torch.ops import map_gather

    input_path, output_path, data_path = _require(
        flags, "input_path", "output_path", "data_path")
    device = _device(flags)
    opt = SemanticBAControllerOptions(
        input_path=input_path, output_path=output_path, data_path=data_path,
        run_path=flags.get("run_path"))
    opt.sba = apply_flags(opt.sba, "SemanticBundleAdjustment", flags)
    rec = run_semantic_bundle_adjustment(opt, device=device)
    s = rec._last_sba_summary
    print(f"SBA: cost {float(s.initial_cost):.6g} -> "
          f"{float(s.final_cost):.6g} in {int(s.num_iterations)} iters")
    if device != "cpu":
        print("kernel launches: " + json.dumps(map_gather.LAUNCHES))


def run_geometric_semantic_bundle_adjuster(flags):
    """Joint refinement of a COLMAP model's poses and a list of cylinders
    against per-image semantic TIFF maps (ref: exe/sfm.cc:200
    RunGeometricSemanticBundleAdjuster)."""
    from sba_tpu_torch.controllers.geometric_semantic_ba import (
        GeometricSemanticBAControllerOptions,
        run_geometric_semantic_bundle_adjustment,
    )

    input_path, output_path, data_path, input_geometry = _require(
        flags, "input_path", "output_path", "data_path", "input_geometry")
    device = _device(flags)
    opt = GeometricSemanticBAControllerOptions(
        input_path=input_path, output_path=output_path, data_path=data_path,
        input_geometry=input_geometry,
        output_geometry=flags.get("output_geometry"),
        run_path=flags.get("run_path"))
    opt.gsba = apply_flags(
        opt.gsba, "GeometricSemanticBundleAdjustment", flags)
    _, _, summary = run_geometric_semantic_bundle_adjustment(
        opt, device=device)
    print(f"GSBA: cost {float(summary.initial_cost):.6g} -> "
          f"{float(summary.final_cost):.6g}, "
          f"mean IoU {float(summary.mean_iou):.4f}")


def _device(flags) -> str:
    """--device (default "cuda"); a CUDA device that is absent fails."""
    import torch

    device = flags.get("device", "cuda")
    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device available")
    return device


def _sync(device):
    import torch

    if device != "cpu":
        torch.cuda.synchronize(device)


def _print_ncc_launches(device):
    from sba_tpu_torch.ops import patch_match_kernels

    if device != "cpu":
        print("kernel launches: " + json.dumps(patch_match_kernels.LAUNCHES))


def _rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y]])


def _pinhole_K(rec, iid):
    """3x3 intrinsics of an image's (undistorted, pinhole) camera."""
    from sba_tpu_torch.geometry import camera_models

    cam = rec.cameras[rec.images[iid].camera_id]
    spec = camera_models.model_by_id(cam.model_id)
    p = cam.params
    fi = spec.focal_idxs
    return np.array([[p[fi[0]], 0, p[spec.principal_idxs[0]]],
                     [0, p[fi[-1]], p[spec.principal_idxs[1]]],
                     [0, 0, 1.0]])


def run_image_undistorter(flags):
    """Undistort images + model for MVS (ref: exe/image.cc:305
    RunImageUndistorter). --output_type COLMAP writes
    <out>/{images,sparse,stereo} + patch-match.cfg / fusion.cfg / run
    scripts (undistortion.cc:271-300); the PMVS and CMP-MVS outputs are
    not ported yet."""
    import copy

    import torch
    from PIL import Image as PILImage

    from sba_tpu_torch.geometry.undistortion import (
        UndistortCameraOptions,
        undistort_reconstruction,
        warp_image_between_cameras,
        write_colmap_workspace_configs,
    )
    from sba_tpu_torch.models.reconstruction import Reconstruction

    image_path, input_path, output_path = _require(
        flags, "image_path", "input_path", "output_path")
    output_type = flags.get("output_type", "COLMAP")
    if output_type not in ("COLMAP", "PMVS", "CMP-MVS"):
        raise SystemExit("ERROR: Invalid `output_type` - supported values "
                         "are {'COLMAP', 'PMVS', 'CMP-MVS'}.")
    if output_type != "COLMAP":
        raise NotImplementedError(
            f"--output_type {output_type} is not ported yet (COLMAP only)")
    device = _device(flags)
    num_src = int(flags.get("num_patch_match_src_images", "20"))
    opt = apply_flags(UndistortCameraOptions(), "UndistortCamera", flags)
    rec = Reconstruction.read(input_path)
    src_cams = copy.deepcopy(rec.cameras)
    new_cams = undistort_reconstruction(rec, opt)

    undistorted = {}
    for iid, image in rec.images.items():
        src_file = os.path.join(image_path, image.name)
        if not os.path.exists(src_file):
            continue
        arr = np.asarray(PILImage.open(src_file).convert("RGB"),
                         np.float32) / 255.0
        warped = warp_image_between_cameras(
            src_cams[image.camera_id], new_cams[image.camera_id],
            torch.as_tensor(arr, device=device))
        undistorted[iid] = torch.clamp(warped * 255, 0, 255).to(
            torch.uint8).cpu().numpy()

    img_out = os.path.join(output_path, "images")
    os.makedirs(img_out, exist_ok=True)
    names = []
    for iid, image in rec.images.items():
        if iid not in undistorted:
            continue
        dst = os.path.join(img_out, image.name)
        os.makedirs(os.path.dirname(dst) or img_out, exist_ok=True)
        PILImage.fromarray(undistorted[iid]).save(dst)
        names.append(image.name)
    sparse_out = os.path.join(output_path, "sparse")
    os.makedirs(sparse_out, exist_ok=True)
    rec.write(sparse_out)
    write_colmap_workspace_configs(output_path, sorted(names),
                                   num_patch_match_src_images=num_src)
    print(f"undistorted {len(undistorted)} images "
          f"({output_type}) -> {output_path}")
    _print_ncc_launches(device)


def run_patch_match_stereo(flags):
    """Dense stereo over an undistorted workspace
    (ref: exe/mvs.cc:81 RunPatchMatchStereo; workspace layout =
    images/ + sparse/ + stereo/{depth_maps,normal_maps}). On CUDA every
    hypothesis cost goes through the NCC kernel; the command then also
    prints the wall seconds of each view's solve, per pass."""
    import torch

    from sba_tpu_torch.features.sift import load_image_gray
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.mvs import PatchMatchOptions, patch_match_stereo, \
        write_colmap_map
    from sba_tpu_torch.mvs.patch_match import relative_pose

    (workspace,) = _require(flags, "workspace_path")
    device = _device(flags)
    opt = apply_flags(PatchMatchOptions(), "PatchMatchStereo", flags)
    max_src = int(flags.get("PatchMatchStereo.max_num_src_images", "4"))
    rec = Reconstruction.read(os.path.join(workspace, "sparse"))
    img_dir = os.path.join(workspace, "images")
    stereo = os.path.join(workspace, "stereo")
    os.makedirs(os.path.join(stereo, "depth_maps"), exist_ok=True)
    os.makedirs(os.path.join(stereo, "normal_maps"), exist_ok=True)

    reg = sorted(i for i in rec.images if rec.is_registered(i))
    imgs = {}
    for iid in reg:
        imgs[iid] = load_image_gray(
            os.path.join(img_dir, rec.images[iid].name))

    # Source selection: most shared 3D points (ref: Workspace/model
    # source-image ranking).
    shared = {a: {} for a in reg}
    for p in rec.points3D.values():
        track = [int(i) for i in p.image_ids]
        for a in track:
            for b in track:
                if a != b and a in shared:
                    shared[a][b] = shared[a].get(b, 0) + 1

    src_of = {iid: sorted(shared[iid], key=lambda b: -shared[iid][b])
              [:max_src] for iid in reg}

    def depth_range(iid):
        image = rec.images[iid]
        pids = [int(p) for p in image.point3D_ids if p != -1]
        if pids:
            R0 = _rotmat(image.qvec)
            zs = np.array([
                (R0 @ rec.points3D[p].xyz + image.tvec)[2]
                for p in pids if p in rec.points3D])
            zs = zs[zs > 0]
            dmin = float(np.percentile(zs, 2) * 0.5) if len(zs) else 0.1
            dmax = float(np.percentile(zs, 98) * 2.0) if len(zs) else 100.0
        else:
            dmin, dmax = opt.depth_min, opt.depth_max
        return max(dmin, 1e-3), max(dmax, dmin * 2)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    def solve_one(iid, o, src_depths=None, init_depth=None):
        srcs = src_of[iid]
        image = rec.images[iid]
        Rs, ts = [], []
        for s in srcs:
            R, t = relative_pose(image.qvec, image.tvec,
                                 rec.images[s].qvec, rec.images[s].tvec)
            Rs.append(R)
            ts.append(t)
        return patch_match_stereo(
            f32(imgs[iid]), f32(np.stack([imgs[s] for s in srcs])),
            f32(_pinhole_K(rec, iid)),
            f32(np.stack([_pinhole_K(rec, s) for s in srcs])),
            f32(np.stack(Rs)), f32(np.stack(ts)),
            generator=torch.Generator(device).manual_seed(iid), options=o,
            src_depths=None if src_depths is None else f32(src_depths),
            init_depth=None if init_depth is None else f32(init_depth))

    def write_maps(iid, res, tag):
        name = rec.images[iid].name
        write_colmap_map(res.depth.cpu().numpy(), os.path.join(
            stereo, "depth_maps", f"{name}.{tag}.bin"))
        write_colmap_map(res.normal.cpu().numpy(), os.path.join(
            stereo, "normal_maps", f"{name}.{tag}.bin"))

    seconds = {"photometric": {}, "geometric": {}}
    # Pass 1: photometric (ref: PatchMatchController first-phase
    # problems; maps named *.photometric.bin).
    photo_depth = {}
    opts_of = {}
    for iid in reg:
        if not src_of[iid]:
            continue
        dmin, dmax = depth_range(iid)
        o = dataclasses.replace(opt, depth_min=dmin, depth_max=dmax,
                                geom_consistency=False)
        opts_of[iid] = o
        t = time.perf_counter()
        res = solve_one(iid, o)
        _sync(device)
        seconds["photometric"][rec.images[iid].name] = \
            time.perf_counter() - t
        photo_depth[iid] = res.depth.cpu().numpy()
        write_maps(iid, res, "photometric")
        print(f"  {rec.images[iid].name} [photometric]: depth "
              f"[{o.depth_min:.2f}, {o.depth_max:.2f}], "
              f"{len(src_of[iid])} sources, mean cost "
              f"{float(res.cost.mean()):.3f}")

    # Pass 2: geometric consistency against the photometric depths of
    # the source views, warm-started from the photometric result
    # (ref: second-phase problems; *.geometric.bin).
    if opt.geom_consistency:
        for iid in photo_depth:
            srcs = src_of[iid]
            if any(s not in photo_depth for s in srcs):
                continue
            o = dataclasses.replace(opts_of[iid], geom_consistency=True)
            t = time.perf_counter()
            res = solve_one(iid, o, src_depths=np.stack(
                [photo_depth[s] for s in srcs]),
                init_depth=photo_depth[iid])
            _sync(device)
            seconds["geometric"][rec.images[iid].name] = \
                time.perf_counter() - t
            write_maps(iid, res, "geometric")
            print(f"  {rec.images[iid].name} [geometric]: mean cost "
                  f"{float(res.cost.mean()):.3f}")
    print(f"stereo maps -> {stereo}")
    if device != "cpu":
        print("wall seconds per view: " + json.dumps(seconds))
    _print_ncc_launches(device)


def run_stereo_fuser(flags):
    """Fuse stereo depth maps into a dense cloud
    (ref: exe/mvs.cc:138 RunStereoFuser)."""
    from sba_tpu_torch.features.sift import load_image_gray
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.mvs import StereoFusionOptions, fuse_depth_maps, \
        read_colmap_map
    from sba_tpu_torch.mvs.fusion import write_fused_ply, write_fused_vis

    workspace, output_path = _require(flags, "workspace_path", "output_path")
    device = _device(flags)
    opt = apply_flags(StereoFusionOptions(), "StereoFusion", flags)
    rec = Reconstruction.read(os.path.join(workspace, "sparse"))
    stereo = os.path.join(workspace, "stereo")
    reg = sorted(i for i in rec.images if rec.is_registered(i))

    depths, normals, images_g, Ks, qs, tvs = [], [], [], [], [], []
    for iid in reg:
        name = rec.images[iid].name
        dp = os.path.join(stereo, "depth_maps", f"{name}.geometric.bin")
        npth = os.path.join(stereo, "normal_maps", f"{name}.geometric.bin")
        if not os.path.exists(dp):   # fall back to photometric maps
            dp = os.path.join(stereo, "depth_maps",
                              f"{name}.photometric.bin")
            npth = os.path.join(stereo, "normal_maps",
                                f"{name}.photometric.bin")
        if not os.path.exists(dp):
            continue
        depths.append(read_colmap_map(dp))
        normals.append(read_colmap_map(npth))
        images_g.append(load_image_gray(
            os.path.join(workspace, "images", name)))
        Ks.append(_pinhole_K(rec, iid))
        qs.append(rec.images[iid].qvec)
        tvs.append(rec.images[iid].tvec)
    if not depths:
        raise SystemExit("no depth maps in workspace; run "
                         "patch_match_stereo first")
    cloud = fuse_depth_maps(
        np.stack(depths), np.stack(normals), np.stack(images_g),
        np.stack(Ks), np.stack(qs), np.stack(tvs), opt, device=device)
    write_fused_ply(cloud, output_path)
    # Visibility sidecar (ref: fusion.cc writes fused.ply.vis).
    write_fused_vis(cloud, output_path + ".vis")
    print(f"fused {len(cloud.xyz)} points -> {output_path} (+.vis)")
    _print_ncc_launches(device)


COMMANDS = {"database_creator": run_database_creator,
            "database_cleaner": run_database_cleaner,
            "database_merger": run_database_merger,
            "feature_extractor": run_feature_extractor,
            "exhaustive_matcher": run_exhaustive_matcher,
            "sequential_matcher": run_sequential_matcher,
            "mapper": run_mapper,
            "point_triangulator": run_point_triangulator,
            "image_registrator": run_image_registrator,
            "automatic_reconstructor": run_automatic_reconstructor,
            "hierarchical_mapper": run_hierarchical_mapper,
            "pose_graph_optimizer": run_pose_graph_optimizer,
            "model_merger": run_model_merger,
            "rig_bundle_adjuster": run_rig_bundle_adjuster,
            "bundle_adjuster": run_bundle_adjuster,
            "semantic_bundle_adjuster": run_semantic_bundle_adjuster,
            "geometric_semantic_bundle_adjuster":
                run_geometric_semantic_bundle_adjuster,
            "image_undistorter": run_image_undistorter,
            "patch_match_stereo": run_patch_match_stereo,
            "stereo_fuser": run_stereo_fuser}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("usage: python -m sba_tpu_torch.cli <command> [--flags]\n")
        print("commands:")
        for name in sorted(COMMANDS):
            print(f"  {name}")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; run with --help for the list")
        return 1
    flags, _ = parse_flags(argv[1:])
    COMMANDS[cmd](flags)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
