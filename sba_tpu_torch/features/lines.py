"""Line segment detection + orientation classification.

Port of ``sba_tpu/features/lines.py`` (ref: src/base/line.{h,cc}
`DetectLineSegments` / `ClassifyLineSegmentOrientations`, backed by the
vendored lib/LSD/lsd.c Grompone von Gioi detector). Consumed by the
Manhattan world coordinate-frame estimator
(ref: src/estimators/coordinate_frame.cc:186-191).

LSD's per-pixel work (Gaussian smoothing, the 2x2 level-line gradient
field) runs on the device for a whole image at once (`_field`); the
region growing of lsd.c is replaced, as in sba_tpu, by connected-component
grouping of level-line-aligned pixels on the host (scipy.ndimage.label
on boolean masks, one per orientation bin) with a PCA line fit and
alignment-density validation per component, then a greedy
de-duplication of the two offset binnings.
"""

from __future__ import annotations

import numpy as np
import torch

HORIZONTAL = 1
VERTICAL = -1
UNDEFINED = 0


def _field(img):
    """Level-line angle + gradient magnitude of a [H, W] tensor, float32
    (lsd.c ll_angle math: a 3x3 separable [1/4, 1/2, 1/4] smoothing with
    edge padding, then the 2x2 forward-difference scheme; the level-line
    direction is the gradient rotated by 90 degrees). Returns (ang, mag)
    [H-1, W-1] on the image's device."""
    img = img.to(torch.float32)
    k0, k1 = 0.25, 0.5
    pad = torch.cat([img[:1], img, img[-1:]], 0)
    sm = pad[:-2] * k0 + pad[1:-1] * k1 + pad[2:] * k0
    pad = torch.cat([sm[:, :1], sm, sm[:, -1:]], 1)
    sm = pad[:, :-2] * k0 + pad[:, 1:-1] * k1 + pad[:, 2:] * k0
    a = sm[:-1, :-1]
    b = sm[:-1, 1:]
    c = sm[1:, :-1]
    d = sm[1:, 1:]
    gx = 0.5 * (b - a + d - c)
    gy = 0.5 * (c - a + d - b)
    mag = torch.sqrt(gx * gx + gy * gy)
    return torch.atan2(gx, -gy), mag


def _segments_from_mask(mask, min_length):
    """Fit one segment per connected component of `mask` (8-conn)."""
    from scipy import ndimage

    labels, n = ndimage.label(mask, structure=np.ones((3, 3), int))
    if n == 0:
        return np.zeros((0, 2, 2))
    ys, xs = np.nonzero(labels)
    lab = labels[ys, xs] - 1
    cnt = np.bincount(lab, minlength=n).astype(np.float64)
    keep0 = cnt >= max(min_length, 4)

    x = xs.astype(np.float64) + 0.5   # 2x2 scheme centers between pixels
    y = ys.astype(np.float64) + 0.5
    sx = np.bincount(lab, x, n)
    sy = np.bincount(lab, y, n)
    cx, cy = sx / cnt, sy / cnt
    dx, dy = x - cx[lab], y - cy[lab]
    sxx = np.bincount(lab, dx * dx, n) / cnt
    syy = np.bincount(lab, dy * dy, n) / cnt
    sxy = np.bincount(lab, dx * dy, n) / cnt
    # Principal axis of the 2x2 scatter (eigenvector of largest eigval).
    tr, det = sxx + syy, sxx * syy - sxy * sxy
    disc = np.sqrt(np.maximum(tr * tr / 4 - det, 0.0))
    l1 = tr / 2 + disc   # major
    l2 = tr / 2 - disc   # minor
    ux = np.where(np.abs(sxy) > 1e-12, l1 - syy, 1.0 * (sxx >= syy))
    uy = np.where(np.abs(sxy) > 1e-12, sxy, 1.0 * (sxx < syy))
    nrm = np.sqrt(ux * ux + uy * uy) + 1e-12
    ux, uy = ux / nrm, uy / nrm

    # Endpoints: extreme projections of member pixels onto the axis.
    proj = dx * ux[lab] + dy * uy[lab]
    pmin = np.full(n, np.inf)
    pmax = np.full(n, -np.inf)
    np.minimum.at(pmin, lab, proj)
    np.maximum.at(pmax, lab, proj)
    length = pmax - pmin

    # Validation (lsd.c rectangle NFA stand-in): long, thin, and dense
    # in aligned pixels along the axis.
    width = 2.0 * np.sqrt(np.maximum(l2, 0.0)) + 1.0
    density = cnt / np.maximum(length * width, 1e-9)
    keep = keep0 & (length >= min_length) & (length >= 2.0 * width) \
        & (density >= 0.4)
    if not np.any(keep):
        return np.zeros((0, 2, 2))
    idx = np.nonzero(keep)[0]
    start = np.stack([cx[idx] + pmin[idx] * ux[idx],
                      cy[idx] + pmin[idx] * uy[idx]], -1)
    end = np.stack([cx[idx] + pmax[idx] * ux[idx],
                    cy[idx] + pmax[idx] * uy[idx]], -1)
    return np.stack([start, end], axis=1)


def detect_line_segments(image, min_length: float = 3.0,
                         grad_threshold: float = 5.3,
                         prec_deg: float = 22.5,
                         device="cuda") -> np.ndarray:
    """Detect line segments in a grayscale image.

    Ref parity: `DetectLineSegments` (src/base/line.cc:48-83) — returns
    segments with length >= min_length. `grad_threshold` is lsd.c's
    rho = 2.0 / sin(prec) quantization bound scaled for [0,255] input.

    Args:
      image: [H, W] grayscale array (any numeric dtype, 0-255 range).
      device: where the gradient field is computed (the rest is host
        work).
    Returns:
      [M, 2, 2] array of (start(x,y), end(x,y)) in pixel coordinates.
    """
    image = np.asarray(image)
    if image.ndim == 3:
        image = image.mean(axis=-1)
    if image.shape[0] < 4 or image.shape[1] < 4:
        return np.zeros((0, 2, 2))
    ang, mag = _field(torch.as_tensor(np.ascontiguousarray(image),
                                      device=device))
    ang = ang.cpu().numpy()
    mag = mag.cpu().numpy()

    prec = np.deg2rad(prec_deg)
    strong = mag > grad_threshold
    segs = []
    nbins = int(round(np.pi / prec))  # level-line angle is mod pi for bins
    # Two offset binnings so segments straddling a bin edge are caught.
    for offset in (0.0, 0.5):
        ang_mod = np.mod(ang + offset * prec, np.pi)
        bins = np.minimum((ang_mod / prec).astype(int), nbins - 1)
        for b in range(nbins):
            mask = strong & (bins == b)
            if mask.sum() < max(min_length, 4):
                continue
            s = _segments_from_mask(mask, min_length)
            if len(s):
                segs.append(s)
    if not segs:
        return np.zeros((0, 2, 2))
    segs = np.concatenate(segs)
    return _dedup_segments(segs, dist_tol=3.0, ang_tol=prec / 2)


def _dedup_segments(segs, dist_tol, ang_tol):
    """Greedy NMS over near-duplicate segments from overlapping binnings:
    keep the longest of any pair with close midpoints + parallel axes."""
    d = segs[:, 1] - segs[:, 0]
    length = np.linalg.norm(d, axis=-1)
    theta = np.mod(np.arctan2(d[:, 1], d[:, 0]), np.pi)
    mid = 0.5 * (segs[:, 0] + segs[:, 1])
    order = np.argsort(-length)
    keep = []
    for i in order:
        dup = False
        for j in keep:
            dang = np.abs(theta[i] - theta[j])
            dang = min(dang, np.pi - dang)
            if dang < ang_tol and \
                    np.linalg.norm(mid[i] - mid[j]) < dist_tol + \
                    0.25 * abs(length[j] - length[i]):
                dup = True
                break
        if not dup:
            keep.append(i)
    return segs[sorted(keep)]


def classify_line_segment_orientations(segments, tolerance: float = 0.25
                                       ) -> np.ndarray:
    """HORIZONTAL / VERTICAL / UNDEFINED per segment
    (ref: src/base/line.cc:86-106; tolerance on |direction| components)."""
    assert tolerance <= 0.5
    segments = np.asarray(segments)
    if len(segments) == 0:
        return np.zeros(0, int)
    d = segments[:, 1] - segments[:, 0]
    d = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-12)
    out = np.full(len(segments), UNDEFINED, int)
    out[np.abs(d[:, 0]) + tolerance > 1] = HORIZONTAL
    out[np.abs(d[:, 1]) + tolerance > 1] = VERTICAL
    return out
