"""Two-view geometry estimation and configuration classification.

Port of ``sba_tpu/estimators/two_view_geometry.py`` (ref: src/
estimators/two_view_geometry.{h,cc}: `Estimate` :113, `EstimateCalibrated`
:232, `EstimateUncalibrated` :371, `DetectWatermark` :514). The three
robust fits (E by 5 points, F by 7, H by 4) are batched RANSACs over the
same correspondences; the configuration decision and the pose recovery
run on the host, as in sba_tpu.

`estimate_two_view_geometry_batch` is the matcher commands' device path:
all pairs of a batch at once, with sba_tpu's 512-correspondence cap, its
adaptive trial rounds (256 -> 1024 -> 4096, per model family), its
re-evaluation of the winners over all matches and its sub-batching under
a memory budget. Draws come from a ``torch.Generator``; `draw_fn`
replaces them (a test hands in sba_tpu's).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from sba_tpu_torch.estimators import _linalg
from sba_tpu_torch.estimators.essential_matrix import (
    essential_5pt, pose_from_essential, sampson_error_e)
from sba_tpu_torch.estimators.fundamental_matrix import (
    _epipolar_rows, _normalize_points, fundamental_7pt, sampson_error_f)
from sba_tpu_torch.estimators.homography_matrix import (
    homography_dlt, homography_transfer_error, pose_from_homography)
from sba_tpu_torch.geometry.quaternions import (
    np_rotmat_to_quat, quat_normalize, quat_to_rotmat, rotmat_to_quat)
from sba_tpu_torch.optim.ransac import (
    RANSACOptions, _ransac_impl, draw_samples, num_required_trials)


def _h_solve(a, b):
    """4-point homography as a one-model solver."""
    H = homography_dlt(a, b)[..., None, :, :]
    return H, torch.ones(H.shape[:-2], dtype=torch.bool, device=H.device)


class TwoViewConfig(IntEnum):
    """Ref: two_view_geometry.h ConfigurationType enum (same values)."""

    UNDEFINED = 0
    DEGENERATE = 1
    CALIBRATED = 2
    UNCALIBRATED = 3
    PLANAR = 4
    PANORAMIC = 5
    PLANAR_OR_PANORAMIC = 6
    WATERMARK = 7
    MULTIPLE = 8


@dataclass(frozen=True)
class TwoViewGeometryOptions:
    """Subset of ref: two_view_geometry.h `Options`."""

    min_num_inliers: int = 15
    max_error: float = 4.0           # px
    confidence: float = 0.999
    min_inlier_ratio: float = 0.25
    max_num_trials: int = 4096
    min_E_F_inlier_ratio: float = 0.95
    max_H_inlier_ratio: float = 0.8
    watermark_min_inlier_ratio: float = 0.7
    watermark_border_size: float = 0.1
    detect_watermark: bool = True
    compute_relative_pose: bool = True


class TwoViewGeometryResult(NamedTuple):
    config: int
    E: np.ndarray            # [3,3]
    F: np.ndarray            # [3,3]
    H: np.ndarray            # [3,3]
    qvec: np.ndarray         # [4] relative rotation (cam1 -> cam2)
    tvec: np.ndarray         # [3] relative translation (unit norm)
    inlier_mask: np.ndarray  # [N] bool, for the winning model
    num_inliers: int


_KINDS = {"F": (7, 3), "H": (4, 1), "E": (5, 10)}   # sample size, models


def _degenerate(n) -> TwoViewGeometryResult:
    return TwoViewGeometryResult(
        int(TwoViewConfig.DEGENERATE), np.eye(3), np.eye(3), np.eye(3),
        np.array([1.0, 0, 0, 0]), np.zeros(3), np.zeros(n, bool), 0)


def _normalized(xy, c):
    """Pixel -> normalized coords; xy [B, N, 2], c [B, 4] (fx, fy, cx, cy)."""
    return torch.stack([(xy[..., 0] - c[:, 2, None]) / c[:, 0, None],
                        (xy[..., 1] - c[:, 3, None]) / c[:, 1, None]], -1)


def _run_kind(kind, xy1, xy2, mask, c1, c2, opt, samples):
    """One model family's RANSAC for a batch of pairs (xy* [B, N, 2],
    mask [B, N]; c* [B, 4] intrinsics, used by E only). Returns (model,
    inlier mask, count) and, for E, the normalized coords."""
    ropt = RANSACOptions(
        max_error=opt.max_error, min_inlier_ratio=opt.min_inlier_ratio,
        confidence=opt.confidence, max_num_trials=opt.max_num_trials)
    if kind == "F":
        rep = _ransac_impl((xy1, xy2), fundamental_7pt, sampson_error_f, 7,
                           ropt, mask, _weighted_f_refit, samples)
    elif kind == "H":
        rep = _ransac_impl((xy1, xy2), _h_solve, homography_transfer_error,
                           4, ropt, mask, None, samples)
    else:
        n1, n2 = _normalized(xy1, c1), _normalized(xy2, c2)
        fmean = (c1[:, 0] + c1[:, 1] + c2[:, 0] + c2[:, 1]) / 4.0
        rep = _ransac_impl((n1, n2), essential_5pt, sampson_error_e, 5, ropt,
                           mask, _weighted_e_refit, samples,
                           max_error=opt.max_error / fmean)
        return rep.model, rep.inlier_mask, rep.num_inliers, n1, n2
    return rep.model, rep.inlier_mask, rep.num_inliers


def estimate_two_view_geometry(
    xy1, xy2,
    cam1_fxycxy=None, cam2_fxycxy=None,
    image_size1=None, image_size2=None,
    options: Optional[TwoViewGeometryOptions] = None,
    seed: int = 0,
    mask=None,
    samples: Optional[dict] = None,
    dtype=torch.float64,
    device="cuda",
) -> TwoViewGeometryResult:
    """Classify a matched image pair and estimate its relative geometry
    (ref two_view_geometry.cc:232-369). xy1/xy2: [N, 2] matched pixel
    keypoints; cam*_fxycxy: (fx, fy, cx, cy), which enable the
    CALIBRATED path; mask: optional [N] validity. `samples` maps "E",
    "F", "H" to [T, s] index tensors that replace the draws (T =
    `num_required_trials` for each family)."""
    return estimate_two_view_geometries([dict(
        xy1=xy1, xy2=xy2, cam1=cam1_fxycxy, cam2=cam2_fxycxy,
        size1=image_size1, size2=image_size2, seed=seed, mask=mask,
        samples=samples)], options, dtype=dtype, device=device)[0]


def estimate_two_view_geometries(pairs, options=None, dtype=torch.float64,
                                 device="cuda"):
    """`estimate_two_view_geometry` of several pairs in one set of device
    calls: `pairs` holds dicts of its arguments (xy1, xy2, cam1, cam2,
    size1, size2, seed, mask, samples), all of one correspondence count
    (a bucket) and all calibrated or none. Each pair draws from its own
    seed's generator (F, H, then E, as one call does) unless `samples`
    gives its draws; the results are one call's per pair (on the CPU bit
    for bit; batched device reductions may round otherwise)."""
    opt = options or TwoViewGeometryOptions()
    out = [None] * len(pairs)
    live = []
    for k, p in enumerate(pairs):
        n = int(p["xy1"].shape[0])
        m = p.get("mask")
        if (n if m is None else int(np.asarray(m).sum())) \
                < opt.min_num_inliers:
            out[k] = _degenerate(n)
        else:
            live.append(k)
    if not live:
        return out
    ps = [pairs[k] for k in live]
    n = int(ps[0]["xy1"].shape[0])
    xy1_np = [np.asarray(p["xy1"], np.float64) for p in ps]
    xy2_np = [np.asarray(p["xy2"], np.float64) for p in ps]
    t1 = torch.as_tensor(np.stack(xy1_np), dtype=dtype, device=device)
    t2 = torch.as_tensor(np.stack(xy2_np), dtype=dtype, device=device)
    has_mask = ps[0].get("mask") is not None
    mt = torch.as_tensor(np.stack([np.asarray(p["mask"], bool) for p in ps]),
                         device=device) if has_mask else None
    calibrated = ps[0]["cam1"] is not None and ps[0]["cam2"] is not None
    ropt = RANSACOptions(
        max_error=opt.max_error, min_inlier_ratio=opt.min_inlier_ratio,
        confidence=opt.confidence, max_num_trials=opt.max_num_trials)

    kinds = ("F", "H", "E") if calibrated else ("F", "H")
    smp = {kind: [] for kind in kinds}
    for b, p in enumerate(ps):
        gen = torch.Generator(device=device).manual_seed(p["seed"])
        for kind in kinds:
            given = p.get("samples")
            if given is not None and kind in given:
                smp[kind].append(torch.as_tensor(np.asarray(
                    given[kind]), device=device).to(torch.int64)[None])
                continue
            ssz = _KINDS[kind][0]
            smp[kind].append(draw_samples(
                n, num_required_trials(ssz, ropt), ssz,
                mask=None if mt is None else mt[b:b + 1], generator=gen,
                batch=(1,)))
    smp = {kind: torch.cat(v) for kind, v in smp.items()}

    def host(rep, b):
        return (rep[0][b].cpu().numpy(), rep[1][b].cpu().numpy(),
                int(rep[2][b]))

    repF = [a.cpu() for a in _run_kind("F", t1, t2, mt, None, None, opt,
                                        smp["F"])]
    repH = [a.cpu() for a in _run_kind("H", t1, t2, mt, None, None, opt,
                                        smp["H"])]
    repE = None
    if calibrated:
        c1 = torch.as_tensor(np.asarray([p["cam1"] for p in ps], np.float64),
                             dtype=dtype, device=device)
        c2 = torch.as_tensor(np.asarray([p["cam2"] for p in ps], np.float64),
                             dtype=dtype, device=device)
        repE = [a.cpu() for a in _run_kind("E", t1, t2, mt, c1, c2, opt,
                                            smp["E"])]
    for b, (k, p) in enumerate(zip(live, ps)):
        out[k] = _finalize(
            opt, calibrated, None if repE is None else host(repE, b),
            host(repF, b), host(repH, b), xy1_np[b], xy2_np[b],
            None if repE is None else repE[3][b].numpy(),
            None if repE is None else repE[4][b].numpy(),
            tuple(float(v) for v in p["cam1"]) if calibrated else None,
            tuple(float(v) for v in p["cam2"]) if calibrated else None,
            p["size1"], p["size2"])
    return out


def _finalize(opt, calibrated, repE, repF, repH, xy1, xy2, n1, n2,
              cam1_fxycxy, cam2_fxycxy, image_size1, image_size2):
    """Host-side configuration decision and pose recovery from the three
    robust fits (numpy inputs; rep* = (model, inlier_mask, n) or None);
    the decision mirrors ref two_view_geometry.cc:286-338."""
    empty3 = np.eye(3)
    Fm, Fmask, nF = repF
    Hm, Hmask, nH = repH
    Em, Emask, nE = repE if repE is not None else (None, None, 0)

    best_n = max(nE, nF, nH)
    if best_n < opt.min_num_inliers:
        config = TwoViewConfig.DEGENERATE
        win = (Fm, Fmask, nF)
    elif calibrated and nE >= opt.min_E_F_inlier_ratio * max(nF, 1):
        win = (Em, Emask, nE)
        config = TwoViewConfig.CALIBRATED
        if nH >= opt.max_H_inlier_ratio * nE:
            config = TwoViewConfig.PLANAR_OR_PANORAMIC
    else:
        win = (Fm, Fmask, nF)
        config = TwoViewConfig.UNCALIBRATED
        if nH >= opt.max_H_inlier_ratio * nF:
            config = TwoViewConfig.PLANAR_OR_PANORAMIC

    inlier_mask = np.asarray(win[1])
    num_inliers = int(win[2])

    if (opt.detect_watermark and config != TwoViewConfig.DEGENERATE
            and image_size1 is not None and image_size2 is not None
            and num_inliers >= opt.min_num_inliers):
        if _is_watermark(xy1, xy2, inlier_mask, image_size1, image_size2,
                         opt):
            config = TwoViewConfig.WATERMARK

    qvec = np.array([1.0, 0, 0, 0])
    tvec = np.zeros(3)
    if (opt.compute_relative_pose and calibrated
            and config == TwoViewConfig.CALIBRATED and Em is not None):
        Et = torch.as_tensor(np.asarray(Em))
        R, t, _ = pose_from_essential(
            Et, torch.as_tensor(np.asarray(n1), dtype=Et.dtype),
            torch.as_tensor(np.asarray(n2), dtype=Et.dtype),
            torch.as_tensor(np.asarray(Emask)))
        qvec = np_rotmat_to_quat(R.numpy())
        t = t.numpy()
        nrm = float(np.linalg.norm(t))
        tvec = t / (nrm if nrm > 1e-12 else 1.0)
    elif (opt.compute_relative_pose and calibrated
          and config == TwoViewConfig.PLANAR_OR_PANORAMIC):
        f1x, f1y, c1x, c1y = cam1_fxycxy
        f2x, f2y, c2x, c2y = cam2_fxycxy
        K1 = np.array([[f1x, 0, c1x], [0, f1y, c1y], [0, 0, 1.0]])
        K2 = np.array([[f2x, 0, c2x], [0, f2y, c2y], [0, 0, 1.0]])
        R, t, _, _ = pose_from_homography(Hm, K1, K2, xy1, xy2,
                                          inlier_mask=Hmask)
        qvec = np_rotmat_to_quat(np.asarray(R))
        nrm = float(np.linalg.norm(t))
        # |t| = 0 resolves the ambiguity to PANORAMIC, else PLANAR
        # (ref: two_view_geometry.cc:221-228).
        if nrm <= 1e-12:
            config = TwoViewConfig.PANORAMIC
            tvec = np.zeros(3)
        else:
            config = TwoViewConfig.PLANAR
            tvec = np.asarray(t) / nrm

    return TwoViewGeometryResult(
        config=int(config), E=Em if Em is not None else empty3, F=Fm, H=Hm,
        qvec=qvec, tvec=tvec, inlier_mask=inlier_mask,
        num_inliers=num_inliers)


def _bmm_t(a, b):
    """a^T b over the last two axes."""
    return a.transpose(-1, -2) @ b


def _weighted_f_refit(w, xy1, xy2):
    """Weighted 8-point refit for LO-RANSAC on F; w [B, N], xy* [B, N, 2]."""
    n1, T1 = _normalize_points(xy1)
    n2, T2 = _normalize_points(xy2)
    A = _epipolar_rows(n1, n2) * w[..., None]
    V = _linalg.eigh_vectors(_bmm_t(A, A))
    F = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    U, S, Vt = _linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    F = _bmm_t(T2, (U * S[..., None, :]) @ Vt @ T1)
    return _linalg.frob_normalize(F)


def _weighted_e_refit(w, n1, n2):
    """Weighted 8-point refit with (1, 1, 0) singular values, two IRLS
    rounds of Sampson reweighting, then `refine_essential_sampson`
    (LO-RANSAC on E); w [B, N], n* [B, N, 2] normalized coords."""
    p1, T1 = _normalize_points(n1)
    p2, T2 = _normalize_points(n2)
    A = _epipolar_rows(p1, p2)

    def fit(weights):
        Aw = A * weights[..., None]
        V = _linalg.eigh_vectors(_bmm_t(Aw, Aw))
        E = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
        E = _bmm_t(T2, E @ T1)
        U, S, Vt = _linalg.svd(E)
        s = 0.5 * (S[..., 0] + S[..., 1])
        S2 = torch.stack([s, s, torch.zeros_like(s)], -1)
        return _linalg.frob_normalize((U * S2[..., None, :]) @ Vt)

    E = fit(w)
    h1 = torch.cat([n1, torch.ones_like(n1[..., :1])], -1)
    h2 = torch.cat([n2, torch.ones_like(n2[..., :1])], -1)
    for _ in range(2):
        l2 = h1 @ E.transpose(-1, -2)
        l1 = h2 @ E
        den = (l2[..., 0] ** 2 + l2[..., 1] ** 2
               + l1[..., 0] ** 2 + l1[..., 1] ** 2)
        E = fit(w / torch.sqrt(torch.clamp(den, min=1e-12)))
    return refine_essential_sampson(E, n1, n2, w, num_iterations=8)


def _nanmedian(a):
    """numpy's nanmedian over the last axis (the mean of the two middle
    values for an even count; NaN where all are NaN)."""
    s = torch.sort(a, dim=-1).values          # NaN sort last
    c = torch.sum(~torch.isnan(a), -1, keepdim=True)
    lo = torch.clamp((c - 1) // 2, min=0)
    hi = torch.clamp(c // 2, max=a.shape[-1] - 1)
    m = 0.5 * torch.gather(s, -1, lo) + 0.5 * torch.gather(s, -1, hi)
    return torch.where(c > 0, m, torch.full_like(m, math.nan))[..., 0]


def _skew(t):
    z = torch.zeros_like(t[..., 0])
    return torch.stack([
        torch.stack([z, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], z, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], z], -1)], -2)


def _unit(t):
    return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                           min=1e-12)


def _e_of_params(p):
    """E = [t]x R(q) of p = (q [4], t [3]) [..., 7]."""
    return _skew(_unit(p[..., 4:])) @ quat_to_rotmat(quat_normalize(
        p[..., :4]))


def refine_essential_sampson(E, n1, n2, w, num_iterations: int = 8):
    """Gauss-Newton refinement of E over (q, t direction), minimizing the
    weighted Sampson error with Cauchy IRLS weights on a MAD scale; a
    step is kept only where it lowers the cost. Batched: E [B, 3, 3],
    n* [B, N, 2], w [B, N]. The Jacobian is forward-mode, as sba_tpu's
    jacfwd."""
    R0, t0, _ = pose_from_essential(E, n1, n2, w > 0)
    p = torch.cat([rotmat_to_quat(R0), _unit(t0)], -1)
    h1 = torch.cat([n1, torch.ones_like(n1[..., :1])], -1)
    h2 = torch.cat([n2, torch.ones_like(n2[..., :1])], -1)
    sw = torch.sqrt(w)
    active = w > 0

    def e_one(p_, h1_, h2_, sw_):
        Em = _e_of_params(p_)
        l2 = h1_ @ Em.transpose(-1, -2)
        l1 = h2_ @ Em
        num = torch.sum(h2_ * l2, -1)
        den = (l2[..., 0] ** 2 + l2[..., 1] ** 2
               + l1[..., 0] ** 2 + l1[..., 1] ** 2)
        return sw_ * num / torch.sqrt(torch.clamp(den, min=1e-18))

    def e_of(p_):
        return e_one(p_, h1, h2, sw)

    # Forward mode over the 7 parameters in one batched pass per pair.
    jac = torch.func.vmap(torch.func.jacfwd(e_one))
    eye7 = torch.eye(7, dtype=p.dtype, device=p.device)
    for _ in range(num_iterations):
        r = e_of(p)
        J = jac(p, h1, h2, sw)                                # [B, N, 7]
        a = torch.abs(r)
        a_act = torch.where(active, a, torch.full_like(a, math.nan))
        delta = 3.0 * (1.48 * _nanmedian(a_act) + 1e-18)
        hw = 1.0 / torch.sqrt(1.0 + (a / delta[..., None]) ** 2)
        r_w = hw * r
        J = hw[..., None] * J
        JtJ = _bmm_t(J, J)
        g = _bmm_t(J, r_w[..., None])[..., 0]
        tr = torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1)
        damp = 1e-8 * torch.clamp(tr / 7.0, min=1e-12)
        dp = _linalg.solve(JtJ + damp[..., None, None] * eye7,
                           -g[..., None])[..., 0]
        p_new = p + dp
        better = torch.sum((hw * e_of(p_new)) ** 2, -1) \
            < torch.sum(r_w ** 2, -1)
        p = torch.where(better[..., None], p_new, p)
    return _linalg.frob_normalize(_e_of_params(p))


def estimate_two_view_geometry_multiple(
    xy1, xy2,
    cam1_fxycxy=None, cam2_fxycxy=None,
    image_size1=None, image_size2=None,
    options: Optional[TwoViewGeometryOptions] = None,
    seed: int = 0,
    max_models: int = 8,
    draw_fn=None,
    dtype=torch.float64,
    device="cuda",
):
    """Recursive multi-model two-view estimation
    (ref: two_view_geometry.h:158-166 EstimateMultiple, .cc:128):
    estimate, remove the inliers, re-estimate on the remainder, until
    too few correspondences survive or a model fails. Each round pads
    the remainder to sba_tpu's power-of-two bucket (at least 32) and
    calls `estimate_two_view_geometry` with seed `seed + k`;
    `draw_fn(seed, num_padded, mask)` gives that round's `samples` (the
    E, F and H draws). Returns a list of TwoViewGeometryResult; each
    result's inlier_mask indexes the ORIGINAL correspondences. When more
    than one model is found every result's config is MULTIPLE (the
    reference's marker for several rigid motions or a watermark
    overlay); each keeps its own geometry."""
    opt = options or TwoViewGeometryOptions()
    xy1 = np.asarray(xy1)
    xy2 = np.asarray(xy2)
    n = len(xy1)
    remaining = np.ones(n, bool)
    results = []
    for k in range(max_models):
        if remaining.sum() < opt.min_num_inliers:
            break
        idx = np.nonzero(remaining)[0]
        m = len(idx)
        mpad = 1 << max(5, (m - 1).bit_length())
        x1 = np.zeros((mpad, 2))
        x2 = np.zeros((mpad, 2))
        x1[:m] = xy1[idx]
        x2[:m] = xy2[idx]
        mask = np.zeros(mpad, bool)
        mask[:m] = True
        tv = estimate_two_view_geometry(
            x1, x2, cam1_fxycxy, cam2_fxycxy, image_size1, image_size2,
            options=opt, seed=seed + k, mask=mask,
            samples=None if draw_fn is None else draw_fn(seed + k, mpad,
                                                         mask),
            dtype=dtype, device=device)
        if (tv.config == int(TwoViewConfig.DEGENERATE)
                or tv.num_inliers < opt.min_num_inliers):
            break
        full_mask = np.zeros(n, bool)
        full_mask[idx[np.nonzero(np.asarray(tv.inlier_mask)[:m])[0]]] = True
        results.append(tv._replace(inlier_mask=full_mask))
        remaining &= ~full_mask
    if len(results) > 1:
        results = [r._replace(config=int(TwoViewConfig.MULTIPLE))
                   for r in results]
    return results


# ---------------------------------------------------------------------------
# Batched verification: the matcher commands' device path
# ---------------------------------------------------------------------------

# RANSAC correspondence cap: sampling and support ranking run on an
# evenly strided subsample of at most this many correspondences; the
# winners' inlier masks and counts are then re-evaluated on all of them.
_TVG_RANSAC_CAP = 512
# Device sub-batching: trials * models * N * 4 bytes per pair under this.
SUB_BATCH_BYTES = 2.5e9


def _trials_needed(num_inliers, num_valid, sample_size, confidence):
    """Reference adaptive stopping criterion (ref: ransac.h:143-182) at
    the OBSERVED inlier ratio."""
    w = max(num_inliers / max(num_valid, 1), 1e-3) ** sample_size
    if w >= 1.0:
        return 1
    return math.log(max(1.0 - confidence, 1e-12)) \
        / math.log(1.0 - w + 1e-300)


def trial_rounds(max_num_trials: int):
    """256, 1024, ... below the maximum, then the maximum."""
    rounds = []
    t = 256
    while t < max_num_trials:
        rounds.append(t)
        t *= 4
    return rounds + [max_num_trials]


def pack_matches(keypoints, matches):
    """Padded correspondences of matched pairs, the input of
    `estimate_two_view_geometry_batch`: `keypoints[i]` holds image i's
    keypoint rows ([K, >= 2], x and y first) and `matches` lists
    (i, j, m), m [M, 2] rows of keypoints[i] and keypoints[j]. Returns
    xy1, xy2 [B, mpad, 2] (float64) and mask [B, mpad], mpad the power
    of two, at least 32, that holds the longest pair: the batch's
    bucket."""
    mpad = 1 << max(5, (max(len(m) for _, _, m in matches) - 1)
                    .bit_length())
    B = len(matches)
    xy1 = np.zeros((B, mpad, 2))
    xy2 = np.zeros((B, mpad, 2))
    mask = np.zeros((B, mpad), bool)
    for k, (i, j, m) in enumerate(matches):
        xy1[k, :len(m)] = keypoints[i][m[:, 0], :2]
        xy2[k, :len(m)] = keypoints[j][m[:, 1], :2]
        mask[k, :len(m)] = True
    return xy1, xy2, mask


def estimate_two_view_geometry_batch(
    xy1, xy2, masks,
    cams1_fxycxy, cams2_fxycxy,
    image_sizes1, image_sizes2,
    options: Optional[TwoViewGeometryOptions] = None,
    seed: int = 0,
    dtype=torch.float64,
    device="cuda",
    draw_fn: Optional[Callable] = None,
):
    """Batched `estimate_two_view_geometry` on the calibrated path: the
    E/F/H RANSACs of Bp pairs (xy* [Bp, N, 2], masks [Bp, N], cams*
    [Bp, 4]) run on `device` in `dtype`, then the configuration decision
    and pose recovery of each pair run on the host through `_finalize`.
    Returns a list of TwoViewGeometryResult.

    draw_fn(kind, trials, pairs, masks) -> [len(pairs), trials, s]
    indices replaces the draws of one round; `pairs` are the active pair
    indices and `masks` the [Bp, N'] validity after the cap."""
    opt = options or TwoViewGeometryOptions()
    masks_np = np.asarray(masks, bool)
    Bp, N_full = masks_np.shape
    xy1_full = np.asarray(xy1, np.float64)
    xy2_full = np.asarray(xy2, np.float64)

    if N_full > _TVG_RANSAC_CAP:
        cap = _TVG_RANSAC_CAP
        sub_idx = np.zeros((Bp, cap), np.int64)
        sub_mask = np.zeros((Bp, cap), bool)
        for i in range(Bp):
            m = int(masks_np[i].sum())
            k = min(m, cap)
            if k:
                sub_idx[i, :k] = (np.arange(k) * max(m, 1)) // max(k, 1)
                sub_mask[i, :k] = True
        r = np.arange(Bp)[:, None]
        xy1_r, xy2_r = xy1_full[r, sub_idx], xy2_full[r, sub_idx]
        masks_r, N = sub_mask, cap
    else:
        xy1_r, xy2_r, masks_r, N = xy1_full, xy2_full, masks_np, N_full

    tens = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                     device=device)
    xy1t, xy2t = tens(xy1_r), tens(xy2_r)
    mt = torch.as_tensor(masks_r, device=device)
    c1t, c2t = tens(cams1_fxycxy), tens(cams2_fxycxy)
    nvalid = masks_r.sum(axis=1)
    gen = torch.Generator(device=device).manual_seed(seed)

    res = {k: [None] * Bp for k in _KINDS}
    for kind, (ssz, nmodels) in _KINDS.items():
        active = np.arange(Bp)
        for trials in trial_rounds(opt.max_num_trials):
            if draw_fn is not None:
                smp = torch.as_tensor(np.asarray(draw_fn(
                    kind, trials, active, masks_r)),
                    device=device).to(torch.int64)
            else:
                smp = draw_samples(N, trials, ssz, mask=mt[active],
                                   generator=gen, batch=(len(active),))
            sub = max(1, min(len(active), int(
                SUB_BATCH_BYTES / max(trials * nmodels * N * 4, 1))))
            for s0 in range(0, len(active), sub):
                sel = active[s0:s0 + sub]
                o = _run_kind(kind, xy1t[sel], xy2t[sel], mt[sel], c1t[sel],
                              c2t[sel], opt, smp[s0:s0 + sub])
                o = [a.cpu().numpy() for a in o]
                for j, p in enumerate(sel):
                    if res[kind][p] is None or trials > res[kind][p][0]:
                        res[kind][p] = (trials, [a[j] for a in o])
            if trials >= opt.max_num_trials:
                break
            active = np.asarray(
                [p for p in active
                 if _trials_needed(int(res[kind][p][1][2]), int(nvalid[p]),
                                   ssz, opt.confidence) > trials], int)
            if len(active) == 0:
                break
    Fm, Fmask, nFs = [np.stack([res["F"][p][1][i] for p in range(Bp)])
                      for i in range(3)]
    Hm, Hmask, nHs = [np.stack([res["H"][p][1][i] for p in range(Bp)])
                      for i in range(3)]
    Em, Emask, nEs, n1s, n2s = [np.stack([res["E"][p][1][i]
                                          for p in range(Bp)])
                                for i in range(5)]

    if N_full > _TVG_RANSAC_CAP:
        (Fmask, nFs, Hmask, nHs, Emask, nEs, n1s, n2s) = _evaluate_full(
            tens(xy1_full), tens(xy2_full),
            torch.as_tensor(masks_np, device=device), c1t, c2t,
            tens(Fm), tens(Hm), tens(Em), opt)

    results = []
    for i in range(Bp):
        if int(masks_np[i].sum()) < opt.min_num_inliers:
            results.append(_degenerate(N_full))
            continue
        results.append(_finalize(
            opt, True,
            (Em[i], Emask[i], int(nEs[i])),
            (Fm[i], Fmask[i], int(nFs[i])),
            (Hm[i], Hmask[i], int(nHs[i])),
            xy1_full[i], xy2_full[i], n1s[i], n2s[i],
            tuple(float(v) for v in cams1_fxycxy[i]),
            tuple(float(v) for v in cams2_fxycxy[i]),
            tuple(image_sizes1[i]), tuple(image_sizes2[i])))
    return results


def _evaluate_full(xy1, xy2, mask, c1, c2, Fm, Hm, Em, opt):
    """The three winners' inlier masks and counts over ALL
    correspondences, and the normalized coords (host numpy)."""
    thr2 = opt.max_error ** 2
    mF = (sampson_error_f(Fm, xy1, xy2) <= thr2) & mask
    mH = (homography_transfer_error(Hm, xy1, xy2) <= thr2) & mask
    n1, n2 = _normalized(xy1, c1), _normalized(xy2, c2)
    fmean = (c1[:, 0] + c1[:, 1] + c2[:, 0] + c2[:, 1]) / 4.0
    mE = (sampson_error_e(Em, n1, n2)
          <= ((opt.max_error / fmean) ** 2)[:, None]) & mask
    out = (mF, mF.sum(-1), mH, mH.sum(-1), mE, mE.sum(-1), n1, n2)
    return [a.cpu().numpy() for a in out]


def _is_watermark(xy1, xy2, inlier_mask, size1, size2,
                  opt: TwoViewGeometryOptions) -> bool:
    """Pure-translation border match test (ref: two_view_geometry.cc:514)."""
    idx = np.nonzero(inlier_mask)[0]
    if idx.size < opt.min_num_inliers:
        return False
    p1, p2 = xy1[idx], xy2[idx]
    d = p2 - p1
    med = np.median(d, axis=0)
    trans_ok = np.hypot(*(d - med).T) <= opt.max_error
    w1, h1 = size1
    w2, h2 = size2
    b1 = opt.watermark_border_size * min(w1, h1)
    b2 = opt.watermark_border_size * min(w2, h2)
    border1 = ((p1[:, 0] < b1) | (p1[:, 0] > w1 - b1)
               | (p1[:, 1] < b1) | (p1[:, 1] > h1 - b1))
    border2 = ((p2[:, 0] < b2) | (p2[:, 0] > w2 - b2)
               | (p2[:, 1] < b2) | (p2[:, 1] > h2 - b2))
    both = border1 & border2
    in_border = both & trans_ok
    if both.sum() == 0:
        return False
    ratio_all = in_border.sum() / idx.size
    ratio_border = in_border.sum() / max(both.sum(), 1)
    return (ratio_border >= opt.watermark_min_inlier_ratio
            and ratio_all >= opt.watermark_min_inlier_ratio * 0.5)
