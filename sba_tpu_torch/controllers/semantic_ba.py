"""Semantic bundle adjustment controller: model + maps in, refined
model out. Port of ``sba_tpu/controllers/semantic_ba.py``.

Checks >= 2 registered images and SIMPLE_PINHOLE cameras, filters
observations with negative depth, loads the per-image depth and
semantic maps, fixes the gauge (first pose constant, tvec x of the
second image constant; intrinsics constant), runs the solve, writes the
refined model, and with ``export_steps`` also writes the model after
each LM iteration under ``<run_path>/optim_steps/step_<i>/``. The solve
runs on `device` (default "cuda") in float64, as the reference's
controller builds it.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.io.maps import load_depth_semantic_maps
from sba_tpu_torch.models.reconstruction import Reconstruction
from sba_tpu_torch.optim.sba import (
    SBAOptions,
    build_sba_problem,
    semantic_bundle_adjust,
)


@dataclass
class SemanticBAControllerOptions:
    """Controller-level options (ref: RunSemanticBundleAdjuster flags)."""

    input_path: str = ""
    output_path: str = ""
    data_path: str = ""              # per-image *_depth/_semantic .tiff
    run_path: Optional[str] = None   # per-iteration export dir
    export_steps: bool = False
    sba: SBAOptions = field(default_factory=SBAOptions)


def _assert_simple_pinhole(rec: Reconstruction):
    """Ref: optim/semantic_bundle_adjustment.cc:604-644 Assert()."""
    sp_id = camera_models.model_by_name("SIMPLE_PINHOLE").model_id
    for cam in rec.cameras.values():
        if cam.model_id != sp_id:
            raise ValueError(
                "SemanticBundleAdjustment requires SIMPLE_PINHOLE cameras "
                f"(camera {cam.camera_id} has model {cam.model_id})")


def _set_poses(rec, reg, out):
    q = out.qvecs.double().cpu().numpy()
    t = out.tvecs.double().cpu().numpy()
    for row, iid in enumerate(reg):
        rec.images[iid].qvec = q[row]
        rec.images[iid].tvec = t[row]


def run_semantic_bundle_adjustment(
    options: SemanticBAControllerOptions,
    reconstruction: Optional[Reconstruction] = None,
    callback: Optional[Callable[[int, float], bool]] = None,
    device="cuda",
) -> Reconstruction:
    """Full SBA workflow. Returns the refined reconstruction (also
    written to `output_path` if set); its `_last_sba_summary` holds the
    solve's summary."""
    rec = reconstruction or Reconstruction.read(options.input_path)
    reg = sorted(i for i in rec.images if rec.is_registered(i))
    if len(reg) < 2:
        raise ValueError("semantic bundle adjustment needs >= 2 "
                         "registered images")
    _assert_simple_pinhole(rec)
    rec.filter_observations_with_negative_depth()

    names = [rec.images[i].name for i in reg]
    depth_maps, semantic_maps = load_depth_semantic_maps(
        options.data_path, names)
    qvecs = np.stack([rec.images[i].qvec for i in reg])
    tvecs = np.stack([rec.images[i].tvec for i in reg])
    cam_params = np.stack([
        rec.cameras[rec.images[i].camera_id].params[:3] for i in reg])
    problem = build_sba_problem(
        qvecs, tvecs, cam_params, depth_maps, semantic_maps,
        options=options.sba, dtype=torch.float64, device=device)

    if options.run_path and options.export_steps:
        # Per-iteration state export (ref: SBACallbackFunctor): the solve
        # runs one LM iteration at a time, and each step's model is
        # written before the next.
        one_iter = dataclasses.replace(options.sba, max_iterations=1)
        out = problem
        summary = None
        for step in range(options.sba.max_iterations):
            out, summary = semantic_bundle_adjust(out, one_iter)
            step_dir = os.path.join(options.run_path, "optim_steps",
                                    f"step_{step}")
            os.makedirs(step_dir, exist_ok=True)
            _set_poses(rec, reg, out)
            rec.write(step_dir, ext=".txt")
            if summary.num_iterations == 0:
                break
    else:
        out, summary = semantic_bundle_adjust(problem, options.sba)

    _set_poses(rec, reg, out)
    if options.output_path:
        os.makedirs(options.output_path, exist_ok=True)
        rec.write(options.output_path)
    if callback is not None:
        callback(int(summary.num_iterations), float(summary.final_cost))
    rec._last_sba_summary = summary
    return rec
