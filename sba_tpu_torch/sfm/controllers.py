"""Workflow controllers: the incremental mapping loop and global BA.

Port of ``sba_tpu/sfm/controllers.py`` (ref: src/controllers/
incremental_mapper.{h,cc} `IncrementalMapperController::Reconstruct`
:384-640, and src/controllers/bundle_adjustment.{h,cc}). Controllers
are plain functions returning the reconstructions, with an optional
per-step callback for progress and cancellation.

`adjust_bundle` builds its problem in the dtype `BAOptions.dtype` names
(one deliberate difference: ``dtype="float32"`` on CUDA runs the fused
kernels; the default "float64" is the plain path). The mapper's bundle
adjustments are float64, as sba_tpu's. `live_viewer_path` writes the
live viewer's page once and its state after every registration, as
sba_tpu's controller does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from sba_tpu_torch.models.reconstruction import Reconstruction
from sba_tpu_torch.optim.ba import BAOptions, build_problem, bundle_adjust
from sba_tpu_torch.sfm.incremental_mapper import (IncrementalMapper,
                                                  IncrementalMapperOptions)
from sba_tpu_torch.sfm.incremental_triangulator import TriangulatorOptions


@dataclass
class MapperControllerOptions:
    """Mirrors ref: controllers/incremental_mapper.h Options."""

    min_num_matches: int = 15
    ignore_watermarks: bool = True
    multiple_models: bool = True
    max_num_models: int = 50
    max_model_overlap: int = 20
    min_model_size: int = 3
    init_num_trials: int = 200
    extract_colors: bool = False
    ba_refine_focal_length: bool = True
    ba_refine_principal_point: bool = False
    ba_refine_extra_params: bool = True
    ba_local_num_images: int = 6
    ba_local_max_num_iterations: int = 25
    ba_global_images_ratio: float = 1.1
    ba_global_points_ratio: float = 1.1
    ba_global_images_freq: int = 500
    ba_global_points_freq: int = 250000
    ba_global_max_num_iterations: int = 50
    ba_local_max_refinements: int = 2
    ba_local_max_refinement_change: float = 0.001
    ba_global_max_refinements: int = 5
    ba_global_max_refinement_change: float = 0.0005
    snapshot_path: Optional[str] = None
    snapshot_images_freq: int = 0
    # The live model view (live.html once, state.json per registration;
    # `model_viewer --follow <dir>` serves it).
    live_viewer_path: Optional[str] = None
    mapper: IncrementalMapperOptions = field(
        default_factory=IncrementalMapperOptions)
    triangulator: TriangulatorOptions = field(
        default_factory=TriangulatorOptions)


def reconstruct_incremental(
    database_cache,
    options: Optional[MapperControllerOptions] = None,
    initial_reconstruction: Optional[Reconstruction] = None,
    callback: Optional[Callable[[str, dict], bool]] = None,
    device="cuda",
    draw_fn: Optional[Callable] = None,
    mappers: Optional[list] = None,
) -> List[Reconstruction]:
    """Run incremental SfM over a loaded database cache; returns the
    reconstructed models (ref: IncrementalMapperController::Run /
    Reconstruct controllers/incremental_mapper.cc:318,384).

    `callback(event, info) -> keep_going` mirrors the reference's thread
    callback. `device` runs the RANSACs and bundle adjustments;
    `draw_fn` replaces their draws (see `IncrementalMapper`); each
    model's mapper is appended to `mappers` when given (its `stats`)."""
    opt = options or MapperControllerOptions()
    models: List[Reconstruction] = []

    def notify(event, **info):
        if callback is not None:
            return callback(event, info)
        return True

    for model_idx in range(opt.max_num_models if opt.multiple_models else 1):
        mapper = IncrementalMapper(database_cache, device=device,
                                   draw_fn=draw_fn)
        if mappers is not None:
            mappers.append(mapper)
        rec = initial_reconstruction if (
            model_idx == 0 and initial_reconstruction is not None) \
            else Reconstruction()
        mapper.begin_reconstruction(rec)

        if rec.num_registered_images() < 2:
            # Initialization: try ranked init pairs (ref: :401).
            init_ok = False
            for _trial in range(opt.init_num_trials):
                found = mapper.find_initial_image_pair(opt.mapper)
                if found is None:
                    break
                i1, i2, info = found
                if mapper.register_initial_image_pair(
                        i1, i2, info, opt.mapper):
                    init_ok = True
                    break
                rec = Reconstruction()
                mapper.begin_reconstruction(rec)
            if not init_ok:
                break
            mapper.adjust_global_bundle(opt.mapper, BAOptions(
                max_iterations=opt.ba_global_max_num_iterations,
                refine_focal_length=False, refine_principal_point=False,
                refine_extra_params=False))
            mapper.filter_points(opt.mapper)
            notify("initialized", model=model_idx,
                   images=rec.num_registered_images(),
                   points=rec.num_points3d())

        # Growth-triggered global BA state (ref: :537-548).
        ba_prev_num_reg = rec.num_registered_images()
        ba_prev_num_points = rec.num_points3d()

        reg_next_success = True
        while reg_next_success:
            reg_next_success = False
            next_images = mapper.find_next_images(opt.mapper)
            for image_id in next_images:
                if mapper.register_next_image(image_id, opt.mapper):
                    reg_next_success = True
                    mapper.triangulate_image(image_id, opt.triangulator)
                    _iterative_local_refinement(mapper, image_id, opt)
                    num_reg = rec.num_registered_images()
                    num_pts = rec.num_points3d()
                    if (num_reg >= opt.ba_global_images_ratio
                            * ba_prev_num_reg
                            or num_reg >= ba_prev_num_reg
                            + opt.ba_global_images_freq
                            or num_pts >= opt.ba_global_points_ratio
                            * max(ba_prev_num_points, 1)
                            or num_pts >= ba_prev_num_points
                            + opt.ba_global_points_freq):
                        _iterative_global_refinement(mapper, opt)
                        ba_prev_num_reg = rec.num_registered_images()
                        ba_prev_num_points = rec.num_points3d()
                    if opt.snapshot_path and opt.snapshot_images_freq and \
                            num_reg % opt.snapshot_images_freq == 0:
                        _write_snapshot(rec, opt.snapshot_path, num_reg)
                    if opt.live_viewer_path:
                        _write_live_state(rec, opt.live_viewer_path,
                                          num_reg)
                    if not notify("registered", model=model_idx,
                                  image_id=image_id, images=num_reg,
                                  points=num_pts):
                        reg_next_success = False
                    break  # re-rank after each registration (ref loop)

        if rec.num_registered_images() >= 2:
            _iterative_global_refinement(mapper, opt)

        if rec.num_registered_images() >= opt.min_model_size:
            models.append(rec)
            notify("model_done", model=model_idx,
                   images=rec.num_registered_images(),
                   points=rec.num_points3d())
        # Remaining unregistered images with enough correspondences?
        remaining = [
            i for i in database_cache.images
            if not any(m.is_registered(i) for m in models)]
        if len(remaining) < max(opt.min_model_size, 2) or \
                not opt.multiple_models:
            break
        initial_reconstruction = None
    return models


def _rel_change(summary) -> float:
    denom = max(float(summary.final_cost), 1e-18)
    return abs(float(summary.initial_cost)
               - float(summary.final_cost)) / denom


def _iterative_local_refinement(mapper: IncrementalMapper, image_id: int,
                                opt: MapperControllerOptions):
    """Local BA + merge/complete/filter rounds until converged
    (ref: IterativeLocalRefinement controllers/incremental_mapper.cc);
    the intrinsics move by the ba_refine_* flags, as in the reference."""
    for _ in range(opt.ba_local_max_refinements):
        out = mapper.adjust_local_bundle(
            image_id, opt.mapper,
            BAOptions(max_iterations=opt.ba_local_max_num_iterations,
                      loss="cauchy", loss_scale=1.0,
                      refine_focal_length=opt.ba_refine_focal_length,
                      refine_principal_point=opt.ba_refine_principal_point,
                      refine_extra_params=opt.ba_refine_extra_params))
        image = mapper.rec.images[image_id]
        pids = [int(p) for p in image.point3D_ids if p != -1]
        mapper.triangulator.complete_tracks(pids, opt.triangulator)
        mapper.triangulator.merge_tracks(pids, opt.triangulator)
        changed = mapper.filter_points(opt.mapper)
        if changed == 0 and _rel_change(out["summary"]) \
                < opt.ba_local_max_refinement_change:
            break


def _iterative_global_refinement(mapper: IncrementalMapper,
                                 opt: MapperControllerOptions):
    """Global BA + retriangulate + filter until stable
    (ref: IterativeGlobalRefinement controllers/incremental_mapper.cc)."""
    mapper.triangulator.complete_tracks(
        list(mapper.rec.points3D), opt.triangulator)
    mapper.triangulator.merge_tracks(
        list(mapper.rec.points3D), opt.triangulator)
    for _ in range(opt.ba_global_max_refinements):
        out = mapper.adjust_global_bundle(opt.mapper, BAOptions(
            max_iterations=opt.ba_global_max_num_iterations,
            refine_focal_length=opt.ba_refine_focal_length,
            refine_principal_point=opt.ba_refine_principal_point,
            refine_extra_params=opt.ba_refine_extra_params))
        mapper.triangulator.retriangulate(opt.triangulator)
        changed = mapper.filter_points(opt.mapper)
        mapper.filter_images(opt.mapper)
        if changed == 0 and _rel_change(out["summary"]) \
                < opt.ba_global_max_refinement_change:
            break


def _write_snapshot(rec: Reconstruction, snapshot_path: str, num_reg: int):
    path = os.path.join(snapshot_path, f"snapshot_{num_reg:06d}")
    os.makedirs(path, exist_ok=True)
    rec.write(path)


def _write_live_state(rec: Reconstruction, live_path: str, revision: int):
    """The live viewer's page (once) and its state.json at `revision`."""
    from sba_tpu_torch.viewer import export_live_viewer, export_viewer_state

    os.makedirs(live_path, exist_ok=True)
    if not os.path.exists(os.path.join(live_path, "live.html")):
        export_live_viewer(live_path)
    export_viewer_state(rec, live_path, revision)


def adjust_bundle(reconstruction: Reconstruction,
                  ba_options: Optional[BAOptions] = None,
                  device="cuda") -> dict:
    """Standalone global BA (the `BundleAdjustmentController`); the gauge
    is fixed by the first pose and the x component of the second image's
    tvec. The cameras are not written back, as in sba_tpu."""
    reg = [i for i in reconstruction.images
           if reconstruction.is_registered(i)]
    if len(reg) < 2:
        raise ValueError("need >= 2 registered images")
    opt = ba_options or BAOptions()
    arrays = reconstruction.to_arrays(image_ids=reg)
    problem = build_problem(
        arrays, constant_pose_rows=[0], constant_tvec_rows={1: [0]},
        dtype=getattr(torch, opt.dtype), device=device)
    out, summary = bundle_adjust(problem, opt)
    reconstruction.update_from_arrays(
        arrays, qvecs=out.qvecs.double().cpu().numpy(),
        tvecs=out.tvecs.double().cpu().numpy(),
        points=out.points.double().cpu().numpy())
    return dict(summary=summary)
