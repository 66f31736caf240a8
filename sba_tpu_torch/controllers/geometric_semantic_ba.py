"""Geometric-semantic BA controller: model + masks + cylinders in,
refined model + cylinders out. Port of
``sba_tpu/controllers/geometric_semantic_ba.py``
(ref: src/controllers/geometric_semantic_bundle_adjustment.{h,cc}).

Checks >= 2 registered images, filters observations with negative depth,
reads each image's `<stem>_semantic.tiff` map and the input cylinders,
adds the landmark term from the model's tracks when its weight is
positive, fixes the gauge (first pose constant, tvec x of the second
image constant; intrinsics constant), runs the solve, writes the model
and the cylinders, and with ``export_steps`` also writes the projected
hard masks and the per-image IoU table under
``<run_path>/optim_steps/final/``. The solve runs on `device` (default
"cuda") in float64, as the reference's controller builds it. Like
sba_tpu's, it reads a camera's first three parameters as SIMPLE_PINHOLE
(f, cx, cy) whatever its model.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from sba_tpu_torch.io.maps import (find_map_path, read_float_map_tiff,
                                   write_matrix_jpeg)
from sba_tpu_torch.models.cylinder import (
    Cylinder,
    project_quadrilateral,
    quadrilateral_mask,
    read_cylinders_text,
    write_cylinders_text,
)
from sba_tpu_torch.models.reconstruction import Reconstruction
from sba_tpu_torch.optim.gsba import (
    GSBAOptions,
    build_gsba_problem,
    geometric_semantic_bundle_adjust,
)


@dataclass
class GeometricSemanticBAControllerOptions:
    """Controller options (ref: RunGeometricSemanticBundleAdjuster,
    exe/sfm.cc:200)."""

    input_path: str = ""
    output_path: str = ""
    data_path: str = ""              # per-image *_semantic .tiff dir
    input_geometry: str = ""         # cylinders text file
    output_geometry: Optional[str] = None
    run_path: Optional[str] = None
    export_steps: bool = False
    gsba: GSBAOptions = field(default_factory=GSBAOptions)


def run_geometric_semantic_bundle_adjustment(
    options: GeometricSemanticBAControllerOptions,
    reconstruction: Optional[Reconstruction] = None,
    cylinders: Optional[List[Cylinder]] = None,
    semantic_maps: Optional[np.ndarray] = None,
    callback: Optional[Callable[[int, float], bool]] = None,
    device="cuda",
):
    """Full GSBA workflow. Returns (reconstruction, cylinders, summary)."""
    rec = reconstruction or Reconstruction.read(options.input_path)
    reg = sorted(i for i in rec.images if rec.is_registered(i))
    if len(reg) < 2:
        raise ValueError("geometric-semantic BA needs >= 2 registered "
                         "images")
    rec.filter_observations_with_negative_depth()

    if cylinders is None:
        cylinders = read_cylinders_text(options.input_geometry)
    if len(cylinders) == 0:
        raise ValueError("no cylinders in input geometry")

    names = [rec.images[i].name for i in reg]
    if semantic_maps is None:
        semantic_maps = np.stack([
            read_float_map_tiff(find_map_path(options.data_path, n,
                                              "semantic"))
            for n in names])

    qvecs = np.stack([rec.images[i].qvec for i in reg])
    tvecs = np.stack([rec.images[i].tvec for i in reg])
    cam_params = np.stack([
        rec.cameras[rec.images[i].camera_id].params[:3] for i in reg])

    # The landmark term shares the model's observations
    # (ref: .cc:729-794 SetUpLandmarkError).
    points = obs = None
    if options.gsba.landmark_error_weight > 0 and rec.points3D:
        arrays = rec.to_arrays(image_ids=reg)
        points = arrays.points
        obs = (arrays.obs_image, arrays.obs_point, arrays.obs_xy)

    problem = build_gsba_problem(
        qvecs, tvecs, cam_params, semantic_maps, cylinders,
        options=options.gsba, points=points, obs=obs, dtype=torch.float64,
        device=device)
    out, summary = geometric_semantic_bundle_adjust(problem, options.gsba)

    q_new = out.qvecs.cpu().numpy()
    t_new = out.tvecs.cpu().numpy()
    for row, iid in enumerate(reg):
        rec.images[iid].qvec = q_new[row]
        rec.images[iid].tvec = t_new[row]

    cq = out.cyl_qvec.cpu().numpy()
    ct = out.cyl_tvec.cpu().numpy()
    cr = np.exp(out.cyl_log_radius.cpu().numpy())
    ch = np.exp(out.cyl_log_height.cpu().numpy())
    new_cylinders = [Cylinder(qvec=cq[k], tvec=ct[k], radius=float(cr[k]),
                              height=float(ch[k]))
                     for k in range(len(cylinders))]

    if options.run_path and options.export_steps:
        _export_projected_masks(options.run_path, reg, rec, new_cylinders,
                                semantic_maps, summary)

    if options.output_path:
        os.makedirs(options.output_path, exist_ok=True)
        rec.write(options.output_path)
    out_geom = options.output_geometry
    if out_geom is None and options.output_path:
        out_geom = os.path.join(options.output_path, "cylinders.txt")
    if out_geom:
        os.makedirs(os.path.dirname(out_geom) or ".", exist_ok=True)
        write_cylinders_text(new_cylinders, out_geom)

    if callback is not None:
        callback(int(summary.num_iterations), float(summary.final_cost))
    return rec, new_cylinders, summary


def _export_projected_masks(run_path, reg, rec, cylinders, semantic_maps,
                            summary):
    """Per-image projected-cylinder mask JPEGs and the IoU table
    (ref: the iteration callback,
    optim/geometric_semantic_bundle_adjustment.cc:1475-1558, and the
    per-image IoU report :1089-1123). Host-side, float64."""
    step_dir = os.path.join(run_path, "optim_steps", "final")
    os.makedirs(step_dir, exist_ok=True)
    H, W = semantic_maps.shape[-2:]
    iou = summary.per_image_iou.cpu().numpy()
    with open(os.path.join(step_dir, "iou.txt"), "w") as f:
        for row, iid in enumerate(reg):
            f.write(f"{rec.images[iid].name} "
                    + " ".join(f"{v:.4f}" for v in np.atleast_1d(iou[row]))
                    + "\n")
        f.write(f"mean {float(summary.mean_iou):.4f}\n")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    for row, iid in enumerate(reg):
        img = rec.images[iid]
        cam = rec.cameras[img.camera_id]
        mask_total = np.zeros((H, W), np.float32)
        for cyl in cylinders:
            quad, valid = project_quadrilateral(
                t(cyl.qvec), t(cyl.tvec), t(cyl.radius), t(cyl.height),
                t(img.qvec), t(img.tvec), t(cam.params[:3]))
            if not bool(valid):
                continue
            m = quadrilateral_mask(quad, H, W, hard=True)
            mask_total = np.maximum(mask_total, m.numpy().astype(np.float32))
        stem = os.path.splitext(img.name)[0].replace("/", "_")
        write_matrix_jpeg(mask_total,
                          os.path.join(step_dir, f"{stem}_mask.jpg"),
                          vmin=0.0, vmax=1.0)
        write_matrix_jpeg(np.asarray(semantic_maps[row]),
                          os.path.join(step_dir, f"{stem}_semantic.jpg"))
