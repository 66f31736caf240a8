"""Bilinear map sampling.

Port of `bilinear_sample2d` from ``sba_tpu/ops/interpolation.py``, which
the undistorter needs; the nearest, label and packed-neighbourhood
samplers of that module come with the SBA slice.
"""

from __future__ import annotations

import torch


def _gather2d(map2d, yi, xi):
    """map2d [H, W]; yi/xi integer tensors (clipped by caller)."""
    H, W = map2d.shape
    return map2d.reshape(-1)[yi * W + xi]


def bilinear_sample2d(map2d, xy, fill=0.0):
    """Bilinear sampling. map2d [H, W], xy [..., 2] -> [...].
    Out-of-bounds (outside the valid interpolation square) -> fill."""
    H, W = map2d.shape
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x0c = x0.clamp(0, W - 1)
    y0c = y0.clamp(0, H - 1)
    x1c = (x0 + 1).clamp(0, W - 1)
    y1c = (y0 + 1).clamp(0, H - 1)
    v00 = _gather2d(map2d, y0c, x0c)
    v01 = _gather2d(map2d, y0c, x1c)
    v10 = _gather2d(map2d, y1c, x0c)
    v11 = _gather2d(map2d, y1c, x1c)
    v = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
         + fy * ((1 - fx) * v10 + fx * v11))
    return torch.where(inb, v, torch.as_tensor(fill, dtype=v.dtype,
                                               device=v.device))
