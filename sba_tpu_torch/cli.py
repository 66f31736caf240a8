"""`colmap`-style command line of the port, sba_tpu's 46 commands: the
database commands, the front end (features, matching, verification, the
spatial, transitive and file-list matchers, feature import), retrieval
(the vocabulary tree and loop detection), the incremental and
hierarchical mappers and their commands, the pose graph, model merging,
global and rig BA, semantic and geometric-semantic BA, the dense chain
from undistortion and rectification to meshing, and the model and image
tools (conversion, analysis, alignment, orientation, comparison,
cropping, splitting, transforms, colors, filtering, the HTML viewer,
project files).

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
        --workspace_path ws/ --image_path imgs/ [--dense 1] \
        [--mesher poisson|delaunay]
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
    python -m sba_tpu_torch.cli poisson_mesher --input_path ws \
        --output_path ws/meshed-poisson.ply [--Meshing.voxel_size 0.05]
    python -m sba_tpu_torch.cli image_undistorter --image_path images \
        --input_path sparse/0 --output_path pmvs_ws --output_type PMVS
    python -m sba_tpu_torch.cli image_rectifier --image_path images \
        --input_path sparse/0 --output_path rect --stereo_pairs_list p.txt
    python -m sba_tpu_torch.cli vocab_tree_builder --database_path db.db \
        --vocab_tree_path tree.npz [--VocabTree.branching 16]
    python -m sba_tpu_torch.cli vocab_tree_matcher --database_path db.db \
        --vocab_tree_path tree.npz [--VocabTreeMatching.num_images 10]
    python -m sba_tpu_torch.cli vocab_tree_retriever --database_path db.db \
        --vocab_tree_path tree.npz [--num_images 10]
    python -m sba_tpu_torch.cli spatial_matcher --database_path db.db \
        [--SpatialMatching.max_num_neighbors 50]
    python -m sba_tpu_torch.cli matches_importer --database_path db.db \
        --match_list_path pairs.txt
    python -m sba_tpu_torch.cli transitive_matcher --database_path db.db
    python -m sba_tpu_torch.cli feature_importer --database_path db.db \
        --image_path imgs/ --import_path feats/
    python -m sba_tpu_torch.cli model_converter --input_path sparse/0 \
        --output_path out --output_type BIN|TXT|PLY|NVM|BUNDLER|CAM|R3D|VRML
    python -m sba_tpu_torch.cli model_analyzer --input_path sparse/0
    python -m sba_tpu_torch.cli model_aligner --input_path sparse/0 \
        --ref_model_path ref/ --output_path aligned/
    python -m sba_tpu_torch.cli model_comparer --input_path1 a/ \
        --input_path2 b/
    python -m sba_tpu_torch.cli model_orientation_aligner \
        --input_path sparse/0 --output_path up/ --image_path imgs/ \
        [--method MANHATTAN-WORLD|IMAGE-ORIENTATION]
    python -m sba_tpu_torch.cli model_transformer --input_path sparse/0 \
        --output_path out/ --transform_path T.txt [--is_inverse 1]
    python -m sba_tpu_torch.cli model_cropper --input_path sparse/0 \
        --output_path crop/ --boundary 0.1,0.9
    python -m sba_tpu_torch.cli model_splitter --input_path sparse/0 \
        --output_path parts/ --split_type tiles|extent|parts \
        --split_params 10
    python -m sba_tpu_torch.cli model_viewer --input_path sparse/0 \
        --output_path model.html [--follow live_dir/]
    python -m sba_tpu_torch.cli color_extractor --input_path sparse/0 \
        --image_path imgs/ --output_path colored/
    python -m sba_tpu_torch.cli point_filtering --input_path sparse/0 \
        --output_path filtered/
    python -m sba_tpu_torch.cli image_deleter --input_path sparse/0 \
        --output_path out/ --image_names_path names.txt
    python -m sba_tpu_torch.cli image_filterer --input_path sparse/0 \
        --output_path out/
    python -m sba_tpu_torch.cli image_undistorter_standalone \
        --input_file cams.txt --image_path imgs/ --output_path und/
    python -m sba_tpu_torch.cli project_generator --output_path p.ini

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
float64 on the device; model_merger is host work. The meshers fuse a
TSDF of the depth maps on the device and extract the surface on the
host; image_rectifier warps on the device; the vocab-tree commands and
``sequential_matcher --SequentialMatching.loop_detection 1`` train and
quantize on the device and keep the index on the host.
``automatic_reconstructor --dense 1`` goes on from the sparse model
through image_undistorter, patch_match_stereo (K6), stereo_fuser and a
mesher. spatial_matcher, matches_importer and transitive_matcher match
and verify on the device as the other matchers do;
image_undistorter_standalone and color_extractor sample images on the
device, and model_orientation_aligner's MANHATTAN-WORLD method computes
each image's undistortion, line field and vanishing points there; the
other model and image tools and feature_importer are host work.
``--project_path p.ini`` reads a command's flags from a project file
(flags on the command line win), and ``<command> --help`` prints a
command's description, required flags and option sections.
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


def _unit_descriptors(db, iid):
    d = db.read_descriptors(iid).astype(np.float32)
    return d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)


def run_sequential_matcher(flags):
    """Ref: exe/feature.cc:298: image i against i+1..i+overlap and the
    quadratic jumps i+2^k. With `SequentialMatching.loop_detection` every
    `loop_detection_period`-th image also queries a vocab-tree index of
    all images and is matched against its top
    `loop_detection_num_images` retrievals (ref: feature/matching.h:63-85,
    matching.cc SequentialFeatureMatcher::RunLoopDetection). Without
    `SequentialMatching.vocab_tree_path` an 8x8 tree is built on the
    device from the run's own descriptors, as in sba_tpu."""
    from sba_tpu_torch.features.pairing import sequential_pairs
    from sba_tpu_torch.io.database import Database

    (db_path,) = _require(flags, "database_path")
    loop = flags.get("SequentialMatching.loop_detection", "0") in (
        "1", "true", "True")
    if loop:
        device = _frontend_device(dict(flags), "SiftMatching")
    db = Database(db_path)
    image_ids = sorted(db.read_images())
    overlap = int(flags.get("SequentialMatching.overlap", "10"))
    quad = flags.get("SequentialMatching.quadratic_overlap", "1") in (
        "1", "true", "True")
    pairs = list(sequential_pairs(len(image_ids), overlap=overlap,
                                  quadratic_overlap=quad))
    if loop and len(image_ids) > 2:
        t0 = time.perf_counter()
        index, descs = _loop_detection_index(db, image_ids, flags, device)
        added = _loop_detection_pairs(index, descs, image_ids, pairs, flags)
        pairs.extend(added)
        print(f"loop detection added {len(added)} retrieved pairs")
        print(f"loop detection: {time.perf_counter() - t0:.3f} s "
              f"[{device}]")
    n = _match_and_verify(db, pairs, image_ids, flags)
    db.close()
    print(f"verified {n}/{len(pairs)} pairs")


def _loop_detection_index(db, image_ids, flags, device):
    """(The loop-detection index of all images, their unit descriptors):
    over `SequentialMatching.vocab_tree_path`'s tree, else over an 8x8
    tree built on `device` from up to 256 descriptors an image (20,000
    in all), as in sba_tpu."""
    from sba_tpu_torch.retrieval.visual_index import VisualIndex
    from sba_tpu_torch.retrieval.vocab_tree import (build_vocab_tree,
                                                    load_any_vocab_tree)

    descs = {iid: _unit_descriptors(db, iid) for iid in image_ids}
    tree_path = flags.get("SequentialMatching.vocab_tree_path")
    if tree_path:
        tree = load_any_vocab_tree(tree_path, device=device)
    else:
        sample = np.concatenate([d[:256] for d in descs.values()])[:20000]
        tree = build_vocab_tree(sample, branching=8, depth=2, device=device)
    index = VisualIndex(tree)
    for iid in image_ids:
        index.add_image(iid, descs[iid])
    index.prepare()
    return index, descs


def _loop_detection_pairs(index, descs, image_ids, pairs, flags):
    """The pairs (positions in image_ids, a < b, in the order found) of
    every `loop_detection_period`-th image and each of its top
    `loop_detection_num_images` retrievals (itself among them) that are
    not in `pairs`."""
    period = int(flags.get("SequentialMatching.loop_detection_period", "10"))
    num_imgs = int(flags.get(
        "SequentialMatching.loop_detection_num_images", "50"))
    pos = {iid: k for k, iid in enumerate(image_ids)}
    have = set(map(tuple, pairs))
    added = []
    for k, iid in enumerate(image_ids):
        if k % max(period, 1) != 0:
            continue
        for jid, _score in index.query(descs[iid], num_images=num_imgs):
            if jid == iid:
                continue
            a, b = sorted((pos[iid], pos[jid]))
            if (a, b) not in have:
                have.add((a, b))
                added.append((a, b))
    return added


# ---------------------------------------------------------------------------
# vocabulary tree commands (ref: exe/vocab_tree.cc, exe/feature.cc)
# ---------------------------------------------------------------------------


def run_vocab_tree_builder(flags):
    """Train a vocabulary tree on the device from database descriptors
    (ref: exe/vocab_tree.cc RunVocabTreeBuilder)."""
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.retrieval.vocab_tree import (build_vocab_tree,
                                                    save_vocab_tree)

    db_path, out = _require(flags, "database_path", "vocab_tree_path")
    device = _device(flags)
    branching = int(flags.get("VocabTree.branching", "16"))
    depth = int(flags.get("VocabTree.depth", "2"))
    max_train = int(flags.get("VocabTree.max_num_descriptors", "100000"))
    db = Database(db_path)
    descs = []
    for iid in sorted(db.read_images()):
        d = _unit_descriptors(db, iid)
        if len(d):
            descs.append(d)
    db.close()
    if not descs:
        raise SystemExit("no descriptors in database")
    d = np.concatenate(descs)
    if len(d) > max_train:
        d = d[np.random.default_rng(0).choice(len(d), max_train,
                                              replace=False)]
    t = time.perf_counter()
    tree = build_vocab_tree(d, branching=branching, depth=depth,
                            device=device)
    _sync(device)
    t = time.perf_counter() - t
    save_vocab_tree(tree, out)
    print(f"trained {tree.num_words}-word tree on {len(d)} descriptors "
          f"-> {out}")
    print(f"vocab tree: {t:.3f} s of k-means [{device}]")


def run_vocab_tree_matcher(flags):
    """Retrieval-based matching (ref: exe/feature.cc:385
    RunVocabTreeMatcher): each image's top `VocabTreeMatching.num_images`
    retrievals are matched and verified."""
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.retrieval.visual_index import (VisualIndex,
                                                      vocab_tree_pairs)
    from sba_tpu_torch.retrieval.vocab_tree import load_any_vocab_tree

    db_path, tree_path = _require(flags, "database_path", "vocab_tree_path")
    device = _frontend_device(dict(flags), "SiftMatching")
    num_imgs = int(flags.get("VocabTreeMatching.num_images", "10"))
    tree = load_any_vocab_tree(tree_path, device=device)
    db = Database(db_path)
    image_ids = sorted(db.read_images())
    t = time.perf_counter()
    index = VisualIndex(tree)
    queries = {}
    for iid in image_ids:
        d = _unit_descriptors(db, iid)
        index.add_image(iid, d)
        queries[iid] = d
    index.prepare()
    id_pairs = vocab_tree_pairs(index, queries, num_images=num_imgs)
    print(f"retrieval: {len(id_pairs)} pairs in "
          f"{time.perf_counter() - t:.3f} s [{device}]")
    # vocab_tree_pairs returns IMAGE-ID pairs; _match_and_verify takes
    # positional indices into image_ids.
    pos = {iid: k for k, iid in enumerate(image_ids)}
    pairs = np.asarray([[pos[a], pos[b]] for a, b in id_pairs], np.int64)
    n = _match_and_verify(db, pairs, image_ids, flags)
    db.close()
    print(f"verified {n}/{len(pairs)} retrieved pairs")


def run_vocab_tree_retriever(flags):
    """Rank database images for query images via the vocab tree
    (ref: exe/vocab_tree.cc:155 RunVocabTreeRetriever); the descriptors
    go in as stored (uint8), as in sba_tpu."""
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.retrieval.visual_index import VisualIndex
    from sba_tpu_torch.retrieval.vocab_tree import load_any_vocab_tree

    db_path, tree_path = _require(flags, "database_path",
                                  "vocab_tree_path")
    device = _device(flags)
    num_images = int(flags.get("num_images", 10))
    tree = load_any_vocab_tree(tree_path, device=device)
    db = Database(db_path)
    names = {iid: img["name"] for iid, img in db.read_images().items()}

    def id_list(path_key):
        p = flags.get(path_key)
        if not p:
            return sorted(names)
        with open(p) as f:
            wanted = {l.strip() for l in f if l.strip()}
        return sorted(i for i, n in names.items() if n in wanted)

    t = time.perf_counter()
    index = VisualIndex(tree)
    db_ids = id_list("database_image_list_path")
    descs = {}
    for iid in db_ids:
        d = db.read_descriptors(iid)
        if len(d):
            index.add_image(iid, d)
            descs[iid] = d
    index.prepare()
    n_q = 0
    for iid in id_list("query_image_list_path"):
        d = descs.get(iid)
        if d is None:
            d = db.read_descriptors(iid)
        if not len(d):
            continue
        ranked = index.query(d, num_images=num_images)
        n_q += 1
        print(f"{names[iid]}:")
        for other, score in ranked:
            if other == iid:
                continue
            print(f"  {names[other]}  score={score:.4f}")
    db.close()
    print(f"retrieval: {n_q} queries against {index.num_images()} images "
          f"in {time.perf_counter() - t:.3f} s [{device}]")


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


_CONTROLLER_FLAGS = ("Mapper.min_num_matches", "Mapper.snapshot_path",
                     "Mapper.snapshot_images_freq", "Mapper.live_viewer_path")


def run_mapper(flags):
    """Ref: exe/sfm.cc:249 RunMapper. `--Mapper.live_viewer_path <dir>`
    writes the live viewer's page and its state after every registration
    (`model_viewer --follow <dir>` serves it)."""
    from sba_tpu_torch.sfm.controllers import (MapperControllerOptions,
                                               reconstruct_incremental)

    db_path, output_path = _require(flags, "database_path", "output_path")
    device = _device(flags)
    opt = MapperControllerOptions()
    # The controller's own Mapper.* flags are not IncrementalMapperOptions
    # fields (sba_tpu's command rejects them as unknown options).
    opt.mapper = apply_flags(opt.mapper, "Mapper", {
        k: v for k, v in flags.items() if k not in _CONTROLLER_FLAGS})
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
    """One command from images to a model: database_creator,
    feature_extractor, exhaustive_matcher, mapper and, with `--dense 1`,
    image_undistorter, patch_match_stereo, stereo_fuser and the Poisson
    or Delaunay mesher (`--mesher`) (ref: exe/sfm.cc:50
    RunAutomaticReconstructor -> controllers/automatic_reconstruction.cc:139)."""
    workspace, image_path = _require(flags, "workspace_path", "image_path")
    device = _device(flags)
    quality = flags.get("quality", "high")
    dense = flags.get("dense", "0") in ("1", "true", "True")
    mesher = flags.get("mesher", "poisson")
    if dense and mesher not in ("poisson", "delaunay"):
        raise SystemExit("ERROR: Invalid `mesher` - supported values "
                         "are {'poisson', 'delaunay'}.")
    db_path = os.path.join(workspace, "database.db")
    sparse = os.path.join(workspace, "sparse")
    os.makedirs(workspace, exist_ok=True)

    base = {k: v for k, v in flags.items()
            if k not in ("dense", "quality", "mesher")}
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
    if dense:
        und = os.path.join(workspace, "dense")
        dev = {"device": device}
        run_image_undistorter({"image_path": image_path,
                               "input_path": os.path.join(sparse, "0"),
                               "output_path": und, **dev})
        run_patch_match_stereo({"workspace_path": und, **dev, **{
            k: v for k, v in flags.items()
            if k.startswith("PatchMatchStereo.")}})
        run_stereo_fuser({"workspace_path": und, **dev,
                          "output_path": os.path.join(und, "fused.ply")})
        # Meshing step (ref: automatic_reconstruction.cc:244-251,324-330).
        mesh_flags = {k: v for k, v in flags.items()
                      if k.startswith("PoissonMeshing.")
                      or k.startswith("DelaunayMeshing.")}
        mesh_flags.update(dev, input_path=und, output_path=os.path.join(
            und, f"meshed-{mesher}.ply"))
        run_mesher(mesh_flags)
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
    RunImageUndistorter). --output_type {COLMAP, PMVS, CMP-MVS}:
    COLMAP writes <out>/{images,sparse,stereo} + patch-match.cfg /
    fusion.cfg / run scripts (undistortion.cc:271-300); PMVS writes the
    pmvs/ workspace (bundle.rd.out, vis.dat, option-all,
    undistortion.cc:314-366); CMP-MVS writes %05d.jpg + %05d_P.txt
    (undistortion.cc:540-596). The warps run on the device."""
    import copy

    import torch
    from PIL import Image as PILImage

    from sba_tpu_torch.geometry.undistortion import (
        UndistortCameraOptions,
        undistort_reconstruction,
        warp_image_between_cameras,
        write_cmpmvs_workspace,
        write_colmap_workspace_configs,
        write_pmvs_workspace,
    )
    from sba_tpu_torch.models.reconstruction import Reconstruction

    image_path, input_path, output_path = _require(
        flags, "image_path", "input_path", "output_path")
    output_type = flags.get("output_type", "COLMAP")
    if output_type not in ("COLMAP", "PMVS", "CMP-MVS"):
        raise SystemExit("ERROR: Invalid `output_type` - supported values "
                         "are {'COLMAP', 'PMVS', 'CMP-MVS'}.")
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

    if output_type == "COLMAP":
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
    elif output_type == "PMVS":
        write_pmvs_workspace(output_path, rec, undistorted)
    else:
        write_cmpmvs_workspace(output_path, rec, undistorted)
    print(f"undistorted {len(undistorted)} images "
          f"({output_type}) -> {output_path}")
    _print_ncc_launches(device)


def run_image_rectifier(flags):
    """Undistort + planar-rectify stereo pairs (ref: exe/image.cc:204
    RunImageRectifier; stereo_pairs_list = two image names per line).
    Each pair's relative pose comes from the model's poses; the warps run
    on the device in float64 pixel positions. Writes <pair>/left.png,
    right.png and Q.txt."""
    import torch
    from PIL import Image as PILImage

    from sba_tpu_torch.geometry.quaternions import (pose_inverse,
                                                    pose_product)
    from sba_tpu_torch.geometry.undistortion import (
        UndistortCameraOptions, rectify_and_undistort_stereo_pair)
    from sba_tpu_torch.models.reconstruction import Reconstruction

    input_path, output_path, pairs_list = _require(
        flags, "input_path", "output_path", "stereo_pairs_list")
    device = _device(flags)
    image_path = flags.get("image_path", "")
    opt = apply_flags(UndistortCameraOptions(), "UndistortCamera", flags)
    rec = Reconstruction.read(input_path)
    by_name = {im.name: iid for iid, im in rec.images.items()}
    os.makedirs(output_path, exist_ok=True)
    with open(pairs_list) as f:
        pairs = [l.split() for l in f if l.strip()]
    t_warp = 0.0
    for n1, n2 in pairs:
        if n1 not in by_name or n2 not in by_name:
            print(f"WARNING: skipping pair {n1} {n2} (not in model)")
            continue
        im1 = rec.images[by_name[n1]]
        im2 = rec.images[by_name[n2]]
        cam1 = rec.cameras[im1.camera_id]
        cam2 = rec.cameras[im2.camera_id]
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
        q1_inv, t1_inv = pose_inverse(f64(im1.qvec), f64(im1.tvec))
        q_rel, t_rel = pose_product(f64(im2.qvec), f64(im2.tvec), q1_inv,
                                    t1_inv)
        imgs = [torch.as_tensor(np.asarray(PILImage.open(
            os.path.join(image_path, n)).convert("RGB"), np.float32),
            device=device) for n in (n1, n2)]
        t = time.perf_counter()
        r1, r2, und_cam, Q = rectify_and_undistort_stereo_pair(
            imgs[0], imgs[1], cam1, cam2, q_rel.numpy(), t_rel.numpy(),
            opt)
        r1, r2 = (r.cpu().numpy() for r in (r1, r2))
        t_warp += time.perf_counter() - t
        pair_dir = os.path.join(output_path,
                                f"{os.path.splitext(n1)[0]}-"
                                f"{os.path.splitext(n2)[0]}")
        os.makedirs(pair_dir, exist_ok=True)
        for tag, arr in (("left", r1), ("right", r2)):
            PILImage.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
                os.path.join(pair_dir, f"{tag}.png"))
        np.savetxt(os.path.join(pair_dir, "Q.txt"), Q)
        print(f"  rectified {n1} / {n2} -> {pair_dir}")
    print(f"rectification: {t_warp:.3f} s of warps for {len(pairs)} "
          f"pairs [{device}]")


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


def run_mesher(flags):
    """`poisson_mesher` and `delaunay_mesher` (ref: exe/mvs.cc:123
    RunPoissonMesher, exe/mvs.cc:43 RunDelaunayMesher), both realized as
    in sba_tpu: TSDF fusion of the workspace's depth maps (geometric,
    else photometric) on the device, then surface nets on the host. Prints
    sba_tpu's line, then the voxel grid, the fusion's device
    milliseconds, the surface nets' host seconds and (on CUDA) the peak
    device memory."""
    import torch

    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.mvs import read_colmap_map
    from sba_tpu_torch.mvs.meshing import (Mesh, TSDFOptions, grid_bounds,
                                           surface_nets, tsdf_fuse,
                                           write_mesh_ply)

    workspace, output_path = _require(flags, "input_path", "output_path")
    device = _device(flags)
    opt = apply_flags(TSDFOptions(), "Meshing", flags)
    rec = Reconstruction.read(os.path.join(workspace, "sparse"))
    stereo = os.path.join(workspace, "stereo")
    reg = sorted(i for i in rec.images if rec.is_registered(i))
    depths, Ks, qs, ts = [], [], [], []
    for iid in reg:
        name = rec.images[iid].name
        dp = os.path.join(stereo, "depth_maps", f"{name}.geometric.bin")
        if not os.path.exists(dp):   # fall back to photometric maps
            dp = os.path.join(stereo, "depth_maps",
                              f"{name}.photometric.bin")
        if not os.path.exists(dp):
            continue
        depths.append(read_colmap_map(dp))
        Ks.append(_pinhole_K(rec, iid))
        qs.append(rec.images[iid].qvec)
        ts.append(rec.images[iid].tvec)
    if not depths:
        raise SystemExit("no depth maps; run patch_match_stereo first")
    depths = np.stack(depths)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats(device)
    bounds = grid_bounds(depths, Ks, qs, ts, opt)
    t_fuse = t_nets = 0.0
    if bounds is None:
        mesh, dims = Mesh(np.zeros((0, 3)), np.zeros((0, 3), int)), (0, 0, 0)
    else:
        lo, dims = bounds
        t = time.perf_counter()
        tsdf, wts = tsdf_fuse(depths, Ks, qs, ts, lo, dims, opt,
                              device=device)
        t_fuse = time.perf_counter() - t
        t = time.perf_counter()
        mesh = surface_nets(tsdf, wts, lo, opt.voxel_size, opt.min_weight)
        t_nets = time.perf_counter() - t
    write_mesh_ply(mesh, output_path)
    print(f"meshed {len(mesh.vertices)} vertices / {len(mesh.faces)} "
          f"faces -> {output_path}")
    peak = ""
    if device != "cpu":
        peak = (f", peak device memory "
                f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    print(f"meshing: {len(depths)} maps, voxel grid {dims[0]} x {dims[1]} x "
          f"{dims[2]} ({int(np.prod(dims))} voxels), TSDF fusion "
          f"{1e3 * t_fuse:.3f} ms wall [{device}], surface nets {t_nets:.3f} s "
          f"[host]{peak}")


# ---------------------------------------------------------------------------
# more matchers and the feature importer (ref: exe/feature.cc)
# ---------------------------------------------------------------------------


def run_spatial_matcher(flags):
    """Ref: exe/feature.cc (RunSpatialMatcher): kNN over the images'
    prior positions, then `_match_and_verify` on the device."""
    from sba_tpu_torch.features.pairing import spatial_pairs
    from sba_tpu_torch.io.database import Database

    (db_path,) = _require(flags, "database_path")
    db = Database(db_path)
    images = db.read_images()
    image_ids = sorted(images)
    pos = []
    valid = []
    for iid in image_ids:
        t = images[iid]["prior_tvec"]
        ok = all(v is not None for v in t)
        pos.append([v or 0.0 for v in t])
        valid.append(ok)
    pairs = spatial_pairs(
        np.asarray(pos),
        max_num_neighbors=int(flags.get(
            "SpatialMatching.max_num_neighbors", "50")),
        max_distance=float(flags.get("SpatialMatching.max_distance", "100")),
        valid=np.asarray(valid))
    n = _match_and_verify(db, pairs, image_ids, flags)
    db.close()
    print(f"verified {n}/{len(pairs)} pairs")


def run_matches_importer(flags):
    """Ref: exe/feature.cc RunMatchesImporter: the image pairs of a text
    file (two names a line), matched and verified on the device."""
    from sba_tpu_torch.features.pairing import pairs_from_file
    from sba_tpu_torch.io.database import Database

    db_path, match_list = _require(flags, "database_path", "match_list_path")
    db = Database(db_path)
    images = db.read_images()
    image_ids = sorted(images)
    name_to_idx = {images[iid]["name"]: k
                   for k, iid in enumerate(image_ids)}
    pairs = pairs_from_file(match_list, name_to_idx)
    n = _match_and_verify(db, pairs, image_ids, flags)
    db.close()
    print(f"verified {n}/{len(pairs)} pairs")


def run_transitive_matcher(flags):
    """Complete the match graph transitively: match A-C when A-B and B-C
    matched (ref: exe/feature.cc:356 RunTransitiveMatcher); each round's
    new pairs are matched and verified on the device."""
    from sba_tpu_torch.features.pairing import transitive_pairs
    from sba_tpu_torch.io.database import Database

    db_path, = _require(flags, "database_path")
    num_iterations = int(flags.get("TransitiveMatching.num_iterations",
                                   "3"))
    db = Database(db_path)
    image_ids = sorted(db.read_images())
    idx_of = {iid: i for i, iid in enumerate(image_ids)}
    for it in range(num_iterations):
        existing = np.array(
            [(idx_of[a], idx_of[b])
             for (a, b) in db.read_all_matches()
             if a in idx_of and b in idx_of], np.int64).reshape(-1, 2)
        pairs = transitive_pairs(existing, len(image_ids))
        done = {tuple(sorted(p)) for p in existing.tolist()}
        new = [p for p in pairs.tolist()
               if tuple(sorted(p)) not in done]
        if not new:
            break
        print(f"iteration {it + 1}: {len(new)} new pairs")
        _match_and_verify(db, np.array(new), image_ids, flags)
    db.close()


def run_feature_importer(flags):
    """Import features from COLMAP text files: <name>.txt with header
    'N 128' and rows 'x y scale orientation d0..d127'
    (ref: exe/feature.cc:179 RunFeatureImporter). Host work: the cameras
    are set up as feature_extractor sets them up."""
    from PIL import Image as PILImage

    from sba_tpu_torch.geometry import camera_models
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.io.image_reader import (ImageReaderOptions,
                                               camera_params_for_image)

    db_path, image_path, import_path = _require(
        flags, "database_path", "image_path", "import_path")
    camera_model = flags.get("ImageReader.camera_model", "SIMPLE_RADIAL")
    single_camera = flags.get("ImageReader.single_camera", "0") in (
        "1", "true", "True")
    names = _list_images(image_path, flags.get("image_list_path"))
    spec = camera_models.model_by_name(camera_model)
    reader_opt = ImageReaderOptions(camera_model=camera_model,
                                    single_camera=single_camera)
    db = Database(db_path)
    shared_camera_id = None
    n_imported = 0
    for name in names:
        full = os.path.join(image_path, name)
        feat_path = os.path.join(import_path, name + ".txt")
        if not os.path.exists(feat_path):
            print(f"WARNING: no feature file for {name}")
            continue
        with PILImage.open(full) as im:
            w, h = im.size
        if shared_camera_id is None or not single_camera:
            _m, params, has_prior = camera_params_for_image(
                full, w, h, reader_opt)
            cam_id = db.write_camera(spec.model_id, w, h, params,
                                     prior_focal_length=has_prior)
            if single_camera:
                shared_camera_id = cam_id
        else:
            cam_id = shared_camera_id
        image_id = db.write_image(name, cam_id)
        with open(feat_path) as f:
            header = f.readline().split()
            n, dim = int(header[0]), int(header[1])
            if dim != 128:
                raise SystemExit(f"{feat_path}: descriptor dim {dim} != 128")
            rows = np.loadtxt(f, ndmin=2) if n else np.zeros((0, 132))
        if len(rows) != n:
            raise SystemExit(f"{feat_path}: expected {n} rows, "
                             f"got {len(rows)}")
        kps = rows[:, :4].astype(np.float32) if n else \
            np.zeros((0, 4), np.float32)
        desc = rows[:, 4:4 + 128].astype(np.uint8) if n else \
            np.zeros((0, 128), np.uint8)
        db.write_keypoints(image_id, kps)
        db.write_descriptors(image_id, desc)
        n_imported += 1
        print(f"  {name}: {n} features")
    db.commit()
    db.close()
    print(f"imported features for {n_imported} images -> {db_path}")


# ---------------------------------------------------------------------------
# model tools (ref: exe/model.cc, exe/image.cc, exe/sfm.cc)
# ---------------------------------------------------------------------------


def run_model_converter(flags):
    """Write a model as BIN, TXT, PLY, NVM, Bundler, CAM, R3D or VRML
    (ref: exe/model.cc RunModelConverter). Host work."""
    from sba_tpu_torch.models.reconstruction import Reconstruction

    input_path, output_path, output_type = _require(
        flags, "input_path", "output_path", "output_type")
    skip = flags.get("skip_distortion", "0") in ("1", "true", "True")
    rec = Reconstruction.read(input_path)
    ot = output_type.upper()
    if ot in ("BIN",):
        os.makedirs(output_path, exist_ok=True)
        rec.write(output_path, ext=".bin")
    elif ot in ("TXT",):
        os.makedirs(output_path, exist_ok=True)
        rec.write(output_path, ext=".txt")
    elif ot in ("PLY",):
        rec.export_ply(output_path)
    elif ot == "NVM":
        if not rec.export_nvm(output_path, skip_distortion=skip):
            raise SystemExit("NVM export failed (unsupported camera model)")
    elif ot == "BUNDLER":
        if not rec.export_bundler(output_path + ".bundle.out",
                                  output_path + ".list.txt",
                                  skip_distortion=skip):
            raise SystemExit("Bundler export failed")
    elif ot == "CAM":
        os.makedirs(output_path, exist_ok=True)
        if not rec.export_cam(output_path, skip_distortion=skip):
            raise SystemExit("CAM export failed")
    elif ot == "R3D":
        os.makedirs(output_path, exist_ok=True)
        if not rec.export_recon3d(output_path, skip_distortion=skip):
            raise SystemExit("Recon3D export failed")
    elif ot == "VRML":
        rec.export_vrml(output_path + ".images.wrl",
                        output_path + ".points3D.wrl")
    else:
        raise SystemExit(f"unsupported output_type {output_type}")
    print(f"converted {input_path} -> {output_path} ({ot})")


def run_model_analyzer(flags):
    """Ref: exe/model.cc RunModelAnalyzer output format. Host work."""
    from sba_tpu_torch.models.reconstruction import Reconstruction

    (input_path,) = _require(flags, "path" if "path" in flags
                             else "input_path")
    rec = Reconstruction.read(input_path)
    print(f"Cameras: {len(rec.cameras)}")
    print(f"Images: {len(rec.images)}")
    print(f"Registered images: {rec.num_registered_images()}")
    print(f"Points: {rec.num_points3d()}")
    print(f"Observations: {rec.compute_num_observations()}")
    print(f"Mean track length: {rec.compute_mean_track_length():.6f}")
    print("Mean observations per image: "
          f"{rec.compute_mean_observations_per_reg_image():.6f}")
    print("Mean reprojection error: "
          f"{rec.compute_mean_reprojection_error():.6f}px")


def _align_models(rec_src, rec_dst):
    """Similarity from the common registered images' centers (Umeyama,
    float64 on the host): (s, R, t, common names, src centers, dst
    centers)."""
    import torch

    from sba_tpu_torch.geometry.similarity import umeyama
    from sba_tpu_torch.sfm.incremental_triangulator import _projection_center

    by_name_src = {rec_src.images[i].name: i for i in rec_src.images
                   if rec_src.is_registered(i)}
    by_name_dst = {rec_dst.images[i].name: i for i in rec_dst.images
                   if rec_dst.is_registered(i)}
    common = sorted(set(by_name_src) & set(by_name_dst))
    if len(common) < 3:
        raise SystemExit("need >= 3 common registered images to align")
    src = np.stack([_projection_center(
        rec_src.images[by_name_src[n]].qvec,
        rec_src.images[by_name_src[n]].tvec) for n in common])
    dst = np.stack([_projection_center(
        rec_dst.images[by_name_dst[n]].qvec,
        rec_dst.images[by_name_dst[n]].tvec) for n in common])
    s, R, t = umeyama(torch.as_tensor(src), torch.as_tensor(dst))
    return float(s), R.numpy(), t.numpy(), common, src, dst


def run_model_aligner(flags):
    """Align a model to a reference model by common images
    (ref: exe/colmap.cc:125 model_aligner). Host work."""
    from sba_tpu_torch.geometry.quaternions import np_rotmat_to_quat
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.sfm.incremental_triangulator import _rotmat

    input_path, ref_path, output_path = _require(
        flags, "input_path", "ref_model_path", "output_path")
    rec = Reconstruction.read(input_path)
    ref = Reconstruction.read(ref_path)
    s, R, t, common, _, _ = _align_models(rec, ref)
    # world' = s R world + t. A camera x_cam = Rc x + tc becomes
    # Rc' = Rc R^T, tc' = s tc - Rc' t (centers c' = s R c + t).
    for iid in rec.images:
        img = rec.images[iid]
        Rc_new = _rotmat(img.qvec) @ R.T
        img.qvec = np_rotmat_to_quat(Rc_new)
        img.tvec = s * img.tvec - Rc_new @ t
    for pid in rec.points3D:
        p = rec.points3D[pid]
        p.xyz = s * (R @ p.xyz) + t
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"aligned over {len(common)} common images "
          f"(scale {s:.6f}) -> {output_path}")


def run_model_orientation_aligner(flags):
    """Align the model's orientation to a Manhattan world or gravity frame
    (ref: exe/model.cc:732 RunModelOrientationAligner). MANHATTAN-WORLD
    undistorts each image, computes its line field and its vanishing
    points on the device; IMAGE-ORIENTATION is host work."""
    from sba_tpu_torch.estimators.coordinate_frame import (
        ManhattanWorldFrameOptions,
        estimate_gravity_vector_from_image_orientation,
        estimate_manhattan_world_frame, rotation_from_unit_vectors,
        transform_reconstruction)
    from sba_tpu_torch.models.reconstruction import Reconstruction

    input_path, output_path = _require(flags, "input_path", "output_path")
    method = flags.get("method", "MANHATTAN-WORLD").lower()
    if method not in ("manhattan-world", "image-orientation"):
        raise SystemExit("ERROR: Invalid `method` - supported values are "
                         "'MANHATTAN-WORLD' or 'IMAGE-ORIENTATION'.")
    rec = Reconstruction.read(input_path)

    if method == "manhattan-world":
        device = _device(flags)
        opts = ManhattanWorldFrameOptions(
            max_image_size=int(flags.get("max_image_size", 1024)))
        frame = estimate_manhattan_world_frame(
            opts, rec, flags.get("image_path", ""), device=device)
        if np.abs(frame[:, 0]).sum() == 0 and np.abs(frame[:, 1]).sum() == 0:
            raise SystemExit("no coordinate axes could be determined")
        if np.abs(frame[:, 0]).sum() == 0:
            print("Only aligning vertical axis")
            R = rotation_from_unit_vectors(frame[:, 1], [0, 1, 0])
        elif np.abs(frame[:, 1]).sum() == 0:
            print("Only aligning horizontal axis")
            R = rotation_from_unit_vectors(frame[:, 0], [1, 0, 0])
        else:
            print("Aligning horizontal and vertical axes")
            R = frame.T
    else:
        gravity = estimate_gravity_vector_from_image_orientation(rec)
        R = rotation_from_unit_vectors(gravity, [0, 1, 0])

    print("Using the rotation matrix:")
    print(R)
    transform_reconstruction(rec, 1.0, R, np.zeros(3))
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"aligned -> {output_path}")


def run_model_comparer(flags):
    """ATE-style comparison of two models after a similarity by their
    common images (ref: exe/colmap.cc:127 model_comparer). Host work."""
    from sba_tpu_torch.models.reconstruction import Reconstruction

    input_path1, input_path2 = _require(flags, "input_path1", "input_path2")
    rec1 = Reconstruction.read(input_path1)
    rec2 = Reconstruction.read(input_path2)
    s, R, t, common, src, dst = _align_models(rec1, rec2)
    src_aligned = (s * (src @ R.T)) + t
    err = np.linalg.norm(src_aligned - dst, axis=-1)
    print(f"Common images: {len(common)}")
    print(f"Alignment scale: {s:.6f}")
    print(f"ATE mean: {err.mean():.6f}")
    print(f"ATE median: {np.median(err):.6f}")
    print(f"ATE rmse: {np.sqrt((err ** 2).mean()):.6f}")
    print(f"ATE max: {err.max():.6f}")


def run_model_viewer(flags):
    """Export a self-contained interactive HTML viewer of a model (the
    GUI substitute, `viewer.py`). `--follow <dir>` serves a live-mapping
    directory (written by `mapper --Mapper.live_viewer_path <dir>`) over
    HTTP at /live.html until interrupted. Host work."""
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.viewer import export_html_viewer

    follow = flags.get("follow")
    if follow:
        import functools
        import http.server

        from sba_tpu_torch.viewer import export_live_viewer

        os.makedirs(follow, exist_ok=True)
        export_live_viewer(follow)
        port = int(flags.get("port", "8011"))
        handler = functools.partial(
            http.server.SimpleHTTPRequestHandler, directory=follow)
        print(f"serving {follow} at http://localhost:{port}/live.html "
              f"(ctrl-c to stop)", flush=True)
        http.server.ThreadingHTTPServer(("", port), handler) \
            .serve_forever()
        return

    input_path, output_path = _require(flags, "input_path", "output_path")
    rec = Reconstruction.read(input_path)
    export_html_viewer(
        rec, output_path,
        max_points=int(flags.get("ModelViewer.max_points", "50000")),
        frustum_scale=float(flags.get("ModelViewer.frustum_scale", "0.3")),
        point_size=float(flags.get("ModelViewer.point_size", "3.0")),
        background=flags.get("ModelViewer.background", "#111"),
        color_mode=flags.get("ModelViewer.color_mode", "rgb"),
        animate=flags.get("ModelViewer.animate", "0") in ("1", "true",
                                                          "True"))
    print(f"viewer ({rec.num_points3d()} points, "
          f"{rec.num_registered_images()} cameras) -> {output_path}")


def run_project_generator(flags):
    """Write a project.ini of the extraction, matching and BA defaults
    (ref: exe/colmap.cc project_generator). Host work."""
    from sba_tpu_torch.features.matching import SiftMatchingOptions
    from sba_tpu_torch.features.sift import SiftExtractionOptions
    from sba_tpu_torch.optim.ba import BAOptions
    from sba_tpu_torch.options import write_project_ini

    (output_path,) = _require(flags, "output_path")
    write_project_ini(output_path, {
        "SiftExtraction": SiftExtractionOptions(),
        "SiftMatching": SiftMatchingOptions(),
        "BundleAdjustment": BAOptions(),
    }, top_level={"database_path": flags.get("database_path", ""),
                  "image_path": flags.get("image_path", "")})
    print(f"wrote {output_path}")


def run_color_extractor(flags):
    """Per-point mean RGB from the images, sampled and averaged on the
    device (ref: exe/sfm.cc:231 RunColorExtractor ->
    Reconstruction::ExtractColorsForAllImages)."""
    from sba_tpu_torch.models.reconstruction import Reconstruction

    output_path, = _require(flags, "output_path")
    device = _device(flags)
    rec = Reconstruction.read(flags.get("input_path", output_path))
    n = rec.extract_colors(flags.get("image_path", ""), device=device)
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"colored {n} / {rec.num_points3d()} points -> {output_path}")


def run_point_filtering(flags):
    """Filter 3D points by reprojection error, triangulation angle and
    track length (ref: exe/sfm.cc:366 RunPointFiltering). Host work."""
    from sba_tpu_torch.models.reconstruction import Reconstruction

    input_path, output_path = _require(flags, "input_path", "output_path")
    min_track_len = int(flags.get("min_track_len", 2))
    max_reproj_error = float(flags.get("max_reproj_error", 4.0))
    min_tri_angle = float(flags.get("min_tri_angle", 1.5))
    rec = Reconstruction.read(input_path)
    n = rec.filter_points_large_reprojection_error(max_reproj_error)
    n += rec.filter_points_min_tri_angle(min_tri_angle)
    for pid in list(rec.points3D.keys()):
        p = rec.points3D.get(pid)
        if p is not None and len(p.image_ids) < min_track_len:
            n += len(p.image_ids)
            rec.delete_point3d(pid)
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"Filtered observations: {n}")


def run_image_deleter(flags):
    """Deregister images listed by id or name (ref: exe/image.cc:77
    RunImageDeleter). Host work."""
    from sba_tpu_torch.models.reconstruction import Reconstruction

    input_path, output_path = _require(flags, "input_path", "output_path")
    rec = Reconstruction.read(input_path)

    def lines(path):
        with open(path) as f:
            return [l.strip() for l in f if l.strip()]

    if flags.get("image_ids_path"):
        for s in lines(flags["image_ids_path"]):
            iid = int(s)
            if iid in rec.images and rec.is_registered(iid):
                print(f"Deleting image_id={iid}, "
                      f"image_name={rec.images[iid].name}")
                rec.deregister_image(iid)
            else:
                print(f"WARNING: Skipping image_id={s} (not found)")
    if flags.get("image_names_path"):
        by_name = {im.name: iid for iid, im in rec.images.items()}
        for name in lines(flags["image_names_path"]):
            iid = by_name.get(name)
            if iid is not None and rec.is_registered(iid):
                print(f"Deleting image_id={iid}, image_name={name}")
                rec.deregister_image(iid)
            else:
                print(f"WARNING: Skipping image_name={name} (not found)")
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)


def run_image_filterer(flags):
    """Deregister images with degenerate intrinsics or too few
    observations (ref: exe/image.cc:155 RunImageFilterer). Host work."""
    from sba_tpu_torch.models.reconstruction import Reconstruction

    input_path, output_path = _require(flags, "input_path", "output_path")
    rec = Reconstruction.read(input_path)
    before = rec.num_registered_images()
    rec.filter_images(
        float(flags.get("min_focal_length_ratio", 0.1)),
        float(flags.get("max_focal_length_ratio", 10.0)),
        float(flags.get("max_extra_param", 100.0)))
    min_obs = int(flags.get("min_num_observations", 10))
    for iid in list(rec.registered_image_ids):
        if rec.images[iid].num_points3d() < min_obs:
            rec.deregister_image(iid)
    print(f"Filtered {before - rec.num_registered_images()} images "
          f"from a total of {before} images")
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)


def _parse_boundary(boundary, rec):
    """'x1,y1,z1,x2,y2,z2' (absolute) or 'p1,p2' (point percentiles)."""
    vals = [float(v) for v in boundary.split(",")]
    if len(vals) == 6:
        return np.array(vals[:3]), np.array(vals[3:])
    if len(vals) == 2:
        return rec.compute_bounding_box(vals[0], vals[1])
    raise SystemExit("ERROR: Invalid `boundary` - supported values are "
                     "'x1,y1,z1,x2,y2,z2' or 'p1,p2'.")


def run_model_cropper(flags):
    """Crop a model to a bounding box (ref: exe/model.cc:613
    RunModelCropper; absolute or percentile boundary). Host work."""
    from sba_tpu_torch.models.reconstruction import Reconstruction

    input_path, output_path, boundary = _require(
        flags, "input_path", "output_path", "boundary")
    rec = Reconstruction.read(input_path)
    lo, hi = _parse_boundary(boundary, rec)
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    cropped = rec.crop((lo, hi))
    os.makedirs(output_path, exist_ok=True)
    cropped.write(output_path)
    print(f"cropped to [{lo}, {hi}]: {cropped.num_points3d()} points, "
          f"{cropped.num_registered_images()} registered images")


def _split_boxes(split_type, split_params, lo, hi):
    """The boxes of model_splitter: `tiles` (x/y tile sizes), `extent`
    (box sizes, missing axes the whole extent) or `parts` (equal slabs
    along the longest axis)."""
    extent = np.maximum(hi - lo, 1e-9)
    boxes = []
    st = split_type.lower()
    if st == "tiles":
        sizes = np.array([float(v) for v in split_params.split(",")])
        if sizes.size == 1:
            sizes = np.repeat(sizes, 2)
        counts = np.maximum(np.ceil(extent[:2] / sizes[:2]), 1).astype(int)
        for i in range(counts[0]):
            for j in range(counts[1]):
                b_lo = lo.copy()
                b_hi = hi.copy()
                b_lo[0] = lo[0] + i * sizes[0]
                b_hi[0] = b_lo[0] + sizes[0]
                b_lo[1] = lo[1] + j * sizes[1]
                b_hi[1] = b_lo[1] + sizes[1]
                boxes.append((b_lo, b_hi))
    elif st == "extent":
        sizes = np.array([float(v) for v in split_params.split(",")])
        if sizes.size < 3:
            sizes = np.concatenate([sizes, extent[sizes.size:]])
        counts = np.maximum(np.ceil(extent / sizes), 1).astype(int)
        for i in range(counts[0]):
            for j in range(counts[1]):
                for k in range(counts[2]):
                    b_lo = lo + np.array([i, j, k]) * sizes
                    boxes.append((b_lo, b_lo + sizes))
    elif st == "parts":
        n = int(split_params)
        axis = int(np.argmax(extent))
        step = extent[axis] / max(n, 1)
        for i in range(n):
            b_lo = lo.copy()
            b_hi = hi.copy()
            b_lo[axis] = lo[axis] + i * step
            b_hi[axis] = b_lo[axis] + step
            boxes.append((b_lo, b_hi))
    else:
        raise SystemExit("ERROR: Invalid `split_type` - supported values "
                         "are {tiles, extent, parts}.")
    return boxes


def run_model_splitter(flags):
    """Split a model into spatial sub-models (ref: exe/model.cc:798
    RunModelSplitter; split_type in {tiles, extent, parts}). Host work."""
    from sba_tpu_torch.models.reconstruction import Reconstruction

    input_path, output_path, split_type, split_params = _require(
        flags, "input_path", "output_path", "split_type", "split_params")
    min_reg_images = int(flags.get("min_reg_images", 10))
    min_num_points = int(flags.get("min_num_points", 100))
    overlap = max(float(flags.get("overlap_ratio", 0.0)), 0.0)
    rec = Reconstruction.read(input_path)
    lo, hi = rec.compute_bounding_box(0.0, 1.0)
    boxes = _split_boxes(split_type, split_params, lo, hi)
    os.makedirs(output_path, exist_ok=True)
    written = 0
    for b_lo, b_hi in boxes:
        pad = (b_hi - b_lo) * overlap
        sub = rec.crop((b_lo - pad, b_hi + pad))
        if sub.num_registered_images() < min_reg_images or \
                sub.num_points3d() < min_num_points:
            continue
        d = os.path.join(output_path, str(written))
        os.makedirs(d, exist_ok=True)
        sub.write(d)
        written += 1
    print(f"wrote {written} / {len(boxes)} sub-models -> {output_path}")


def _read_transform_file(path):
    """3x4 or 4x4 [sR | t] row-major text matrix -> (s, R, t)
    (ref: SimilarityTransform3::FromFile)."""
    vals = []
    with open(path) as f:
        for line in f:
            vals.extend(float(v) for v in line.split())
    m = np.array(vals)
    if m.size not in (12, 16):
        raise SystemExit(f"{path}: expected a 3x4 or 4x4 transform")
    m = m.reshape(-1, 4)[:3]
    sR = m[:, :3]
    s = float(np.cbrt(np.linalg.det(sR)))
    return s, sR / s, m[:, 3]


def run_model_transformer(flags):
    """Apply a similarity transform from a file to a sparse model or a
    PLY cloud (ref: exe/model.cc:983 RunModelTransformer);
    `--is_inverse 1` applies its inverse. Host work."""
    from sba_tpu_torch.estimators.coordinate_frame import (
        transform_reconstruction)
    from sba_tpu_torch.models.reconstruction import Reconstruction

    input_path, output_path, transform_path = _require(
        flags, "input_path", "output_path", "transform_path")
    s, R, t = _read_transform_file(transform_path)
    if flags.get("is_inverse", "0") in ("1", "true", "True"):
        s, R, t = 1.0 / s, R.T, -(R.T @ t) / s
    if input_path.endswith(".ply"):
        from sba_tpu_torch.io.ply import read_ply, write_ply

        cloud = read_ply(input_path)
        xyz = s * (cloud["xyz"] @ R.T) + t
        normals = cloud.get("normals")
        if normals is not None:
            normals = normals @ R.T
        write_ply(output_path, xyz, rgb=cloud.get("rgb"), normals=normals)
        print(f"transformed {len(xyz)} PLY points -> {output_path}")
        return
    rec = Reconstruction.read(input_path)
    transform_reconstruction(rec, s, R, t)
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"transformed model (scale {s:.6f}) -> {output_path}")


def run_image_undistorter_standalone(flags):
    """Undistort images given explicit per-image cameras (ref:
    exe/image.cc:407; input_file lines 'image_name CAMERA_MODEL w h
    params...'); each image is warped on the device."""
    import torch
    from PIL import Image as PILImage

    from sba_tpu_torch.geometry import camera_models
    from sba_tpu_torch.geometry.undistortion import (UndistortCameraOptions,
                                                     undistort_image)
    from sba_tpu_torch.io.colmap_models import Camera

    input_file, output_path = _require(flags, "input_file", "output_path")
    device = _device(flags)
    image_path = flags.get("image_path", "")
    opt = apply_flags(UndistortCameraOptions(), "UndistortCamera", flags)
    os.makedirs(output_path, exist_ok=True)
    n = 0
    with open(input_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            name, model_name, w, h = parts[0], parts[1], int(parts[2]), \
                int(parts[3])
            spec = camera_models.model_by_name(model_name)
            params = np.array([float(v) for v in parts[4:]])
            if len(params) != spec.num_params:
                raise SystemExit(
                    f"{name}: {model_name} needs {spec.num_params} params")
            cam = Camera(1, spec.model_id, w, h, params)
            img = torch.as_tensor(np.asarray(PILImage.open(
                os.path.join(image_path, name)).convert("RGB"), np.float32),
                device=device)
            und, _und_cam = undistort_image(img, cam, opt)
            out = os.path.join(output_path, name)
            os.makedirs(os.path.dirname(out) or output_path, exist_ok=True)
            PILImage.fromarray(np.clip(und.cpu().numpy(), 0, 255)
                               .astype(np.uint8)).save(out)
            n += 1
    print(f"undistorted {n} images -> {output_path} [{device}]")


COMMANDS = {"database_creator": run_database_creator,
            "database_cleaner": run_database_cleaner,
            "database_merger": run_database_merger,
            "feature_extractor": run_feature_extractor,
            "exhaustive_matcher": run_exhaustive_matcher,
            "sequential_matcher": run_sequential_matcher,
            "vocab_tree_builder": run_vocab_tree_builder,
            "vocab_tree_matcher": run_vocab_tree_matcher,
            "vocab_tree_retriever": run_vocab_tree_retriever,
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
            "image_rectifier": run_image_rectifier,
            "patch_match_stereo": run_patch_match_stereo,
            "stereo_fuser": run_stereo_fuser,
            "stereo_fusion": run_stereo_fuser,
            "poisson_mesher": run_mesher,
            "delaunay_mesher": run_mesher,
            "spatial_matcher": run_spatial_matcher,
            "matches_importer": run_matches_importer,
            "feature_importer": run_feature_importer,
            "transitive_matcher": run_transitive_matcher,
            "image_deleter": run_image_deleter,
            "image_filterer": run_image_filterer,
            "image_undistorter_standalone":
                run_image_undistorter_standalone,
            "color_extractor": run_color_extractor,
            "point_filtering": run_point_filtering,
            "model_converter": run_model_converter,
            "model_analyzer": run_model_analyzer,
            "model_viewer": run_model_viewer,
            "model_aligner": run_model_aligner,
            "model_cropper": run_model_cropper,
            "model_splitter": run_model_splitter,
            "model_transformer": run_model_transformer,
            "model_orientation_aligner": run_model_orientation_aligner,
            "model_comparer": run_model_comparer,
            "project_generator": run_project_generator}


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
    flags, positional = parse_flags(argv[1:])
    if "project_path" in flags:
        from sba_tpu_torch.options import flags_from_ini, read_project_ini

        ini_flags = flags_from_ini(read_project_ini(flags["project_path"]))
        ini_flags.update(flags)
        flags = ini_flags
    if flags.get("help") or "-h" in positional:
        _print_command_help(cmd)
        return 0
    COMMANDS[cmd](flags)
    return 0


def _print_command_help(cmd):
    """A command's docstring, its required flags and its option sections,
    read from its source (as sba_tpu's CLI prints them)."""
    import inspect
    import re

    doc = inspect.getdoc(COMMANDS[cmd])
    print(f"{cmd}\n  {doc}" if doc else cmd)
    src = inspect.getsource(COMMANDS[cmd])
    req = re.search(r"_require\(\s*flags\s*,([^)]*)\)", src)
    if req:
        names = re.findall(r'"(\w+)"', req.group(1))
        if names:
            print("  required: " + " ".join(f"--{n}" for n in names))
    sections = sorted(set(re.findall(r'apply_flags\([^,]+,\s*"(\w+)"',
                                     src)))
    if sections:
        print("  option sections: "
              + ", ".join(f"--{s}.<field>" for s in sections))


if __name__ == "__main__":
    raise SystemExit(main())
