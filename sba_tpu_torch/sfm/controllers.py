"""Global bundle adjustment over a reconstruction.

Port of ``adjust_bundle`` from ``sba_tpu/sfm/controllers.py`` (the
`BundleAdjustmentController` equivalent). One deliberate difference: the
problem is built in the dtype `BAOptions.dtype` names, so
``dtype="float32"`` on CUDA runs the fused kernels; the default
"float64" is the plain path.
"""

from __future__ import annotations

from typing import Optional

import torch

from sba_tpu_torch.models.reconstruction import Reconstruction
from sba_tpu_torch.optim.ba import BAOptions, build_problem, bundle_adjust


def adjust_bundle(reconstruction: Reconstruction,
                  ba_options: Optional[BAOptions] = None,
                  device="cuda") -> dict:
    """Standalone global BA; the gauge is fixed by the first pose and
    the x component of the second image's tvec."""
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
