"""Geometric-semantic bundle adjustment: joint camera poses + 3D cylinders.
Port of ``sba_tpu/optim/gsba.py``.

What is solved (ref: src/optim/geometric_semantic_bundle_adjustment.cc):

- One residual per (image, cylinder): ``1 - IoU`` between the projected
  cylinder silhouette (the convex quadrilateral between its two tangent
  lines) and the image's boolean trunk mask (pixels equal to
  trunk_semantic_class), under a ScaledLoss of 1/num_images
  (ref .cc:714-726). The IoU is the soft one of
  `models.cylinder.quadrilateral_mask`; the hard one is reported.
- An optional landmark term: SIMPLE_PINHOLE reprojection residuals with
  weight ``landmark_error_weight / total_num_2d_features``
  (ref .cc:729-794).
- Two cylinder parametrizations: (qvec, tvec, log radius, log height)
  and "by 2 points" (base point, top point, log radius). The logs keep
  radius and height positive; the reference bounds them instead and
  applies the height's bound to the radius (ref .cc:1180).

How the port linearizes. Residual (n, k) depends on pose n and cylinder
k alone, so, as sba_tpu does, every row is perturbed by ONE shared local
tangent of 6 + kdim entries and its Jacobian row is the derivative of
the IRLS-weighted residual ``r * sqrt(w(r^2))`` along it (the weight's
own derivative included, as sba_tpu's ``jacfwd`` of
``_geo_weighted_local`` has it). sba_tpu pushes the tangents through the
rasterizer by forward-mode AD; the port splits the chain:

1. the [N, K, 4, 2] quadrilaterals' Jacobian in the tangent, by one
   forward-mode pass (``torch.autograd.forward_ad``) over 6 + kdim
   replicas of the retraction and the projection (small tensors);
2. per pixel, the closed-form derivative of the soft mask in the 8 quad
   coordinates, reduced to per-(n, k) sums: for each edge and for the
   weights 1 and s (the trunk mask), the sums of m (1 - sigmoid_e) by
   rows, by columns and times the signed distance; the derivative of
   each edge distance is affine in (px, py, d), so these moments give
   the sums of dm/dquad and of s dm/dquad exactly;
3. the IoU's and the weight's derivatives on [N, K] tensors.

The pixel work runs in chunks of whole images under a byte budget
(`GSBA_CHUNK_BYTES`), and every pixel sum is taken one image at a time
on a tensor whose shape does not depend on the chunk, so the budget
changes no bit of a solve. The LM loop is a Python loop with one host
sync per iteration; the [dim, dim] system (dim = 6N + kdim K + 3P) is
solved by Cholesky. Images sharded over devices (``axis_name``) are not
ported yet.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch.func import jacfwd

from sba_tpu_torch.geometry.quaternions import (
    quat_normalize,
    quat_retract,
    quat_rotate,
)
from sba_tpu_torch.models.cylinder import (
    edge_cross,
    project_quadrilateral,
    quadrilateral_mask,
)
from sba_tpu_torch.optim.losses import loss_value, loss_weight

LOG = logging.getLogger(__name__)

# Device memory one chunk of the pixel work may take. One image of a
# chunk costs _IMAGE_TENSORS tensors of [K, H, W]: the linearization's 18
# moment channels, 4 edge distances, 4 sigmoids, the mask and their
# temporaries (an H100 peaked at 4295 MiB over float32 chunks of 6
# forest images, 16 trunks at 640x480: ~38 such tensors an image).
GSBA_CHUNK_BYTES = 4 << 30
_IMAGE_TENSORS = 38


class GSBAProblem(NamedTuple):
    qvecs: torch.Tensor        # [N, 4]
    tvecs: torch.Tensor        # [N, 3]
    cam_params: torch.Tensor   # [N, 3] SIMPLE_PINHOLE
    sem_masks: torch.Tensor    # [N, H, W] 0/1 (label == trunk class)
    # Cylinder state, default parametrization (by_2_points converts
    # through this form inside the residual).
    cyl_qvec: torch.Tensor       # [K, 4]
    cyl_tvec: torch.Tensor       # [K, 3]
    cyl_log_radius: torch.Tensor  # [K]
    cyl_log_height: torch.Tensor  # [K]
    free_rot: torch.Tensor     # [N]
    free_trans: torch.Tensor   # [N, 3]
    # Optional landmark (reprojection) term; empty arrays disable it.
    points: torch.Tensor       # [P, 3]
    obs_image: torch.Tensor    # [O] int64
    obs_point: torch.Tensor    # [O] int64
    obs_xy: torch.Tensor       # [O, 2]
    obs_mask: torch.Tensor     # [O]
    free_points: torch.Tensor  # [P]
    # Per-image geometry weight; None is the reference's uniform
    # ScaledLoss(1/num_images).
    img_weight: Optional[torch.Tensor] = None  # [N]


@dataclass(frozen=True)
class GSBAOptions:
    """Mirrors GeometricSemanticBundleAdjustmentOptions
    (ref: src/optim/geometric_semantic_bundle_adjustment.h:51-152) with
    sba_tpu's fields and defaults."""

    trunk_semantic_class: float = 250.0
    refine_geometry: bool = True
    refine_extrinsics: bool = True
    cylinder_parametrization: str = "default"  # default | by_2_points
    landmark_error_weight: float = 0.0
    loss: str = "trivial"
    loss_scale: float = 1.0
    mode: str = "soft"         # soft | hard (hard only for evaluation)
    # Soft silhouette sharpness in pixels; well below the silhouette's
    # width, or the blur biases the radius upward.
    soft_tau: float = 0.3
    max_iterations: int = 50
    function_tolerance: float = 1e-10
    gradient_tolerance: float = 1e-14
    parameter_tolerance: float = 1e-12
    initial_trust_radius: float = 1e2
    # Images sharded over a device mesh: not ported yet (raises).
    axis_name: Optional[str] = None
    spmd_num_images: int = 0
    spmd_num_obs: int = 0


class GSBASummary(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_iterations: int
    cost_trace: torch.Tensor     # [max_iterations + 1], NaN-padded
    per_image_iou: torch.Tensor  # [N, K] hard IoU at the solution
    mean_iou: torch.Tensor


def _kdim(opt: GSBAOptions) -> int:
    return 8 if opt.cylinder_parametrization == "default" else 7


# ---------------------------------------------------------------------------
# Pixel work: per-(image, cylinder) mask sums, chunked over images.
# ---------------------------------------------------------------------------

def image_chunks(problem: GSBAProblem) -> List[slice]:
    """Slices of whole images whose pixel work fits GSBA_CHUNK_BYTES."""
    N = problem.qvecs.shape[0]
    K = problem.cyl_qvec.shape[0]
    H, W = problem.sem_masks.shape[-2:]
    per_image = (_IMAGE_TENSORS * K * H * W
                 * problem.sem_masks.element_size())
    n = max(1, min(N, GSBA_CHUNK_BYTES // per_image))
    return [slice(lo, min(lo + n, N)) for lo in range(0, N, n)]


def _mask_sums(quad, sem, tau, hard, chunks):
    """T = sum(m * s) and M = sum(m) per (n, k), [N, K]."""
    H, W = sem.shape[-2:]
    ts, ms = [], []
    for sl in chunks:
        m = quadrilateral_mask(quad[sl], H, W, soft_tau=tau, hard=hard)
        mst = m * sem[sl, None]
        for i in range(m.shape[0]):
            ts.append(mst[i].sum(dim=(-2, -1)))
            ms.append(m[i].sum(dim=(-2, -1)))
        del m, mst   # before the next chunk allocates
    return torch.stack(ts), torch.stack(ms)


def _mask_moments(quad, sem, tau, chunks):
    """T, M [N, K] and their derivatives in the quad, [N, K, 4, 2] each.

    Per chunk, 18 channels per (n, k) pixel: m s, m, then for each edge e
    with G_e = m (1 - sigmoid_e): G_e s, G_e (channels 2-9), G_e s d_e,
    G_e d_e (10-17). Each image's channels are summed by rows ([18, H])
    and G's by columns ([8, W]); the rest of the reduction runs on the
    stacked sums of all images."""
    N, K = quad.shape[:2]
    H, W = sem.shape[-2:]
    px = torch.arange(W, dtype=sem.dtype, device=sem.device)
    py = torch.arange(H, dtype=sem.dtype, device=sem.device)
    rows, cols = [], []
    for sl in chunks:
        q, s = quad[sl], sem[sl, None]
        n = q.shape[0]
        buf = q.new_empty(n, K, 18, H, W)
        ds, sig = [], []
        for e in range(4):
            cross, ex, ey = edge_cross(q, e, px, py)
            el = torch.sqrt(ex * ex + ey * ey)
            ds.append(cross / torch.clamp(el, min=1e-12)[..., None, None])
            sig.append(torch.sigmoid(-ds[-1] / tau))
        m = sig[0] * sig[1] * sig[2] * sig[3]
        torch.mul(m, s, out=buf[:, :, 0])
        buf[:, :, 1].copy_(m)
        for e in range(4):
            g = m * (1.0 - sig[e])
            torch.mul(g, s, out=buf[:, :, 2 + 2 * e])
            buf[:, :, 3 + 2 * e].copy_(g)
            torch.mul(buf[:, :, 2 + 2 * e], ds[e], out=buf[:, :, 10 + 2 * e])
            torch.mul(g, ds[e], out=buf[:, :, 11 + 2 * e])
        del ds, sig, m
        for i in range(n):
            rows.append(buf[i].sum(dim=-1))
            cols.append(buf[i, :, 2:10].sum(dim=-2))
        del buf      # before the next chunk allocates
    R = torch.stack(rows)                       # [N, K, 18, H]
    C = torch.stack(cols).reshape(N, K, 4, 2, W)
    T, M = R[:, :, 0].sum(-1), R[:, :, 1].sum(-1)
    RG = R[:, :, 2:10].reshape(N, K, 4, 2, H)   # [.., edge, (s, 1), H]
    Sd = R[:, :, 10:18].reshape(N, K, 4, 2, H).sum(-1)

    a = quad                                    # edge e runs a -> b
    b = quad.roll(-1, dims=2)

    def moment(sums, coord, c):
        return (sums * (coord - c[..., None, None])).sum(-1)

    sy_a, sy_b = moment(RG, py, a[..., 1]), moment(RG, py, b[..., 1])
    sx_a, sx_b = moment(C, px, a[..., 0]), moment(C, px, b[..., 0])
    ex, ey = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    el = torch.sqrt(ex * ex + ey * ey)
    big = el > 1e-12
    safe = torch.where(big, el, torch.ones_like(el))
    fx = torch.where(big, ex / safe, torch.zeros_like(el))[..., None]
    fy = torch.where(big, ey / safe, torch.zeros_like(el))[..., None]
    # d(m) = m sum_e (1 - sigmoid_e) (-1 / tau) d(d_e), and d_e's
    # derivative in (ax, ay, bx, by) is (py - by, bx - px, ay - py,
    # px - ax) / el + d_e (ex, ey, -ex, -ey) / el^2.
    c = (-1.0 / tau) / torch.clamp(el, min=1e-12)[..., None]
    d_a = torch.stack([c * (sy_b + fx * Sd), c * (fy * Sd - sx_b)], -1)
    d_b = torch.stack([c * (-sy_a - fx * Sd), c * (sx_a - fy * Sd)], -1)
    dq = d_a + d_b.roll(1, dims=2)              # [N, K, vertex, (s, 1), 2]
    return T, M, dq[:, :, :, 0], dq[:, :, :, 1]


def _iou(T, M, S, valid, eps=1e-9):
    """IoU = T / max(T + fp + fn, eps) with fp + fn = M + S - 2T."""
    iou = T / torch.clamp(M + S - T, min=eps)
    return torch.where(valid, iou, torch.zeros_like(iou))


def _sem_sum(problem):
    return problem.sem_masks.sum(dim=(-2, -1))[:, None]


# ---------------------------------------------------------------------------
# Residuals
# ---------------------------------------------------------------------------

def _quads(qvecs, tvecs, cam_params, cq, ct, r, h):
    """[..., N, K, 4, 2] quadrilaterals of every cylinder ([..., K] state)
    in every image ([..., N] poses), and valid [..., N, K]."""
    return project_quadrilateral(
        cq[..., None, :, :], ct[..., None, :, :], r[..., None, :],
        h[..., None, :], qvecs[..., :, None, :], tvecs[..., :, None, :],
        cam_params[:, None, :])


def _cyl_residuals(qvecs, tvecs, cyl_q, cyl_t, cyl_r, cyl_h, problem, opt,
                   hard):
    """[N, K] silhouette residuals 1 - IoU, and the IoU matrix."""
    quad, valid = _quads(qvecs, tvecs, problem.cam_params, cyl_q, cyl_t,
                         cyl_r, cyl_h)
    T, M = _mask_sums(quad, problem.sem_masks, opt.soft_tau, hard,
                      image_chunks(problem))
    iou = _iou(T, M, _sem_sum(problem), valid)
    return 1.0 - iou, iou


def _two_points_to_cylinder(t1, t2, log_r):
    """Differentiable CylinderBy2Points -> (qvec, tvec, r, h)
    (ref: cylinder_by_2_points.h:84-108): the shortest rotation z -> dn
    as the half-angle quaternion normalize([1 + z.dn, z x dn]), smooth
    except at dn = -z, where it is 180 degrees about x."""
    d = t2 - t1
    h2 = torch.sum(d * d, dim=-1)
    h = torch.sqrt(torch.clamp(h2, min=1e-24))
    dn = d / h[..., None]
    w = 1.0 + dn[..., 2:3]
    xyz = torch.stack([-dn[..., 1], dn[..., 0], torch.zeros_like(w[..., 0])],
                      dim=-1)                   # (0, 0, 1) x dn
    q = quat_normalize(torch.cat([w, xyz], dim=-1))
    flip = q.new_tensor([0.0, 1.0, 0.0, 0.0]).expand(q.shape)
    q = torch.where(w < 1e-8, flip, q)
    return q, t1, torch.exp(log_r), h


def _landmark_residuals(qvecs, tvecs, points, problem):
    """SIMPLE_PINHOLE reprojection residuals [O, 2] (ref .cc:1391-1407)."""
    q0 = qvecs[problem.obs_image]
    t0 = tvecs[problem.obs_image]
    x0 = points[problem.obs_point]
    k0 = problem.cam_params[problem.obs_image]
    p_cam = quat_rotate(q0, x0) + t0
    z = p_cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    uv = p_cam[..., :2] / safe_z[..., None]
    proj = k0[..., 0:1] * uv + k0[..., 1:3]
    return (proj - problem.obs_xy) * problem.obs_mask[:, None]


def _retract_cyl(problem: GSBAProblem, opt: GSBAOptions, d_cyl):
    """Retract [..., K, kdim] cylinder deltas onto the stored state.
    Returns (cyl_state=(q, t, r, h), new_state=(q, t, log_r, log_h))."""
    if opt.cylinder_parametrization == "default":
        cq = quat_retract(problem.cyl_qvec, d_cyl[..., :3])
        ct = problem.cyl_tvec + d_cyl[..., 3:6]
        clr = problem.cyl_log_radius + d_cyl[..., 6]
        clh = problem.cyl_log_height + d_cyl[..., 7]
        return (cq, ct, torch.exp(clr), torch.exp(clh)), (cq, ct, clr, clh)
    # The state read through the 2-point form: base point = cyl_tvec,
    # top point = tvec + R (0, 0, h).
    h0 = torch.exp(problem.cyl_log_height)
    zero = torch.zeros_like(h0)
    top0 = problem.cyl_tvec + quat_rotate(
        problem.cyl_qvec, torch.stack([zero, zero, h0], -1))
    t1 = problem.cyl_tvec + d_cyl[..., 0:3]
    t2 = top0 + d_cyl[..., 3:6]
    log_r = problem.cyl_log_radius + d_cyl[..., 6]
    cq, ct, r, h = _two_points_to_cylinder(t1, t2, log_r)
    return (cq, ct, r, h), (cq, ct, log_r,
                            torch.log(torch.clamp(h, min=1e-8)))


def _geo_img_weight(problem: GSBAProblem):
    """[N] per-image geometry weight (uniform 1/N unless given)."""
    if problem.img_weight is not None:
        return problem.img_weight
    N = problem.qvecs.shape[0]
    return torch.full((N,), 1.0 / N, dtype=problem.tvecs.dtype,
                      device=problem.tvecs.device)


def _dims(problem: GSBAProblem, opt: GSBAOptions):
    return (problem.qvecs.shape[0], problem.cyl_qvec.shape[0],
            problem.points.shape[0], _kdim(opt))


def _apply_deltas(problem: GSBAProblem, opt: GSBAOptions, delta):
    """Unflatten and retract an LM step. Layout:
    [N*6 pose | K*kdim cylinder | P*3 points]."""
    N, K, P, kdim = _dims(problem, opt)
    d_pose = delta[: N * 6].reshape(N, 6)
    d_cyl = delta[N * 6: N * 6 + K * kdim].reshape(K, kdim)
    d_pts = delta[N * 6 + K * kdim:].reshape(P, 3)
    q = quat_retract(problem.qvecs, d_pose[:, :3])
    t = problem.tvecs + d_pose[:, 3:]
    cyl_state, new_cyl = _retract_cyl(problem, opt, d_cyl)
    return q, t, cyl_state, new_cyl, problem.points + d_pts


def _free_vector(problem: GSBAProblem, opt: GSBAOptions):
    N, K, P, kdim = _dims(problem, opt)
    dtype = problem.tvecs.dtype
    ext = 1.0 if opt.refine_extrinsics else 0.0
    free_pose = torch.cat([
        problem.free_rot[:, None].expand(N, 3) * ext,
        problem.free_trans * ext], dim=1).reshape(-1)
    geo = 1.0 if opt.refine_geometry else 0.0
    free_cyl = torch.full((K * kdim,), geo, dtype=dtype,
                          device=problem.tvecs.device)
    free_pts = (problem.free_points.repeat_interleave(3)
                if opt.landmark_error_weight > 0
                else torch.zeros_like(problem.points).reshape(-1))
    return torch.cat([free_pose.to(dtype), free_cyl, free_pts.to(dtype)])


def _use_landmarks(problem, opt):
    return opt.landmark_error_weight > 0 and problem.obs_xy.shape[0] > 0


def _land_scale(problem, opt):
    return opt.landmark_error_weight / max(problem.obs_xy.shape[0], 1)


def _all_residuals(problem: GSBAProblem, opt: GSBAOptions, delta,
                   hard=False):
    """Stacked residuals and their weights at params (+) delta."""
    q, t, (cq, ct, r, h), _, pts = _apply_deltas(problem, opt, delta)
    geo_r, _ = _cyl_residuals(q, t, cq, ct, r, h, problem, opt, hard)
    K = problem.cyl_qvec.shape[0]
    res = [geo_r.reshape(-1)]
    wts = [_geo_img_weight(problem).repeat_interleave(K).to(geo_r.dtype)]
    if _use_landmarks(problem, opt):
        rl = _landmark_residuals(q, t, pts, problem).reshape(-1)
        res.append(rl)
        wts.append(torch.full_like(rl, _land_scale(problem, opt)))
    return torch.cat(res), torch.cat(wts)


def _robust_cost(res, wts, opt):
    return 0.5 * torch.sum(wts * loss_value(opt.loss, res * res,
                                            opt.loss_scale))


def _cost(problem, opt):
    N, K, P, kdim = _dims(problem, opt)
    z = problem.tvecs.new_zeros(N * 6 + K * kdim + P * 3)
    return _robust_cost(*_all_residuals(problem, opt, z), opt)


# ---------------------------------------------------------------------------
# Linearization
# ---------------------------------------------------------------------------

def _local_quads(problem: GSBAProblem, opt: GSBAOptions, dlocal):
    """Quadrilaterals [..., N, K, 4, 2] with every (pose, cylinder) block
    moved by the shared local tangent dlocal [..., 6 + kdim]."""
    d = dlocal[..., None, :]
    q = quat_retract(problem.qvecs, d[..., :3])
    t = problem.tvecs + d[..., 3:6]
    (cq, ct, r, h), _ = _retract_cyl(problem, opt, d[..., 6:])
    return _quads(q, t, problem.cam_params, cq, ct, r, h)


def _quad_jacobian(problem: GSBAProblem, opt: GSBAOptions):
    """Quadrilaterals [N, K, 4, 2], their Jacobian in the local tangent
    [N, K, 4, 2, 6 + kdim] and valid [N, K]: one forward-mode pass over
    6 + kdim replicas of the tangent's zero, replica j carrying the
    tangent e_j."""
    n = 6 + _kdim(opt)
    z = problem.tvecs.new_zeros(n, n)
    with fwAD.dual_level():
        quad, valid = _local_quads(problem, opt, fwAD.make_dual(
            z, torch.eye(n, dtype=z.dtype, device=z.device)))
        primal, tangent = fwAD.unpack_dual(quad)
    return primal[0], tangent.movedim(0, -1), valid[0]


def _weighted(problem, opt, res):
    """IRLS-weighted residuals r sqrt(w_n rho'(r^2)), [N, K]."""
    w = _geo_img_weight(problem)[:, None] * loss_weight(
        opt.loss, res * res, opt.loss_scale)
    return res * torch.sqrt(w)


def _geo_local_jacobian(problem: GSBAProblem, opt: GSBAOptions):
    """IRLS-weighted geometry residuals [N*K] and their exact Jacobian
    rows in the shared local tangent, [N*K, 6 + kdim] (the counterpart
    of sba_tpu's ``jacfwd(_geo_weighted_local)``)."""
    N, K, _, kdim = _dims(problem, opt)
    quad, jq, valid = _quad_jacobian(problem, opt)
    T, M, dT, dM = _mask_moments(quad, problem.sem_masks, opt.soft_tau,
                                 image_chunks(problem))
    S = _sem_sum(problem)
    eps = 1e-9
    U_raw = M + S - T
    U = torch.clamp(U_raw, min=eps)
    dU = torch.where((U_raw > eps)[..., None, None], dM - dT,
                     torch.zeros_like(dM))
    diou = dT / U[..., None, None] - (T / U)[..., None, None] \
        * dU / U[..., None, None]
    dres = -torch.einsum("nkvc,nkvct->nkt", diou, jq)
    dres = torch.where(valid[..., None], dres, torch.zeros_like(dres))
    res = 1.0 - _iou(T, M, S, valid, eps)
    with fwAD.dual_level():
        rw, drw = fwAD.unpack_dual(_weighted(
            problem, opt, fwAD.make_dual(res, torch.ones_like(res))))
    return rw.reshape(-1), (drw[..., None] * dres).reshape(N * K, 6 + kdim)


def _land_weighted(problem: GSBAProblem, opt: GSBAOptions, delta):
    """IRLS-weighted landmark residuals [2*O] at params (+) delta."""
    q, t, _, _, pts = _apply_deltas(problem, opt, delta)
    res = _landmark_residuals(q, t, pts, problem).reshape(-1)
    w = _land_scale(problem, opt) * loss_weight(opt.loss, res * res,
                                                opt.loss_scale)
    return res * torch.sqrt(w)


def _linearize(problem: GSBAProblem, opt: GSBAOptions, free):
    """(g, H) of the free-masked Gauss-Newton system."""
    N, K, P, kdim = _dims(problem, opt)
    rg, jl = _geo_local_jacobian(problem, opt)
    jl = jl.reshape(N, K, 6 + kdim)
    dtype, dev = rg.dtype, rg.device
    eye_n = torch.eye(N, dtype=dtype, device=dev)
    eye_k = torch.eye(K, dtype=dtype, device=dev)
    J = torch.cat([
        torch.einsum("nkp,nm->nkmp", jl[..., :6], eye_n).reshape(N * K,
                                                                 N * 6),
        torch.einsum("nkc,kl->nklc", jl[..., 6:], eye_k).reshape(
            N * K, K * kdim),
        rg.new_zeros(N * K, P * 3)], dim=1)
    r = rg
    if _use_landmarks(problem, opt):
        z = torch.zeros_like(free)

        def land(d):
            return _land_weighted(problem, opt, d)

        r = torch.cat([rg, land(z)])
        J = torch.cat([J, jacfwd(land)(z)], dim=0)
    J = J * free[None, :]
    return J.T @ r, J.T @ J


# ---------------------------------------------------------------------------
# LM solve
# ---------------------------------------------------------------------------

def _lm_step(H, g, lam, free):
    """Damped step with sba_tpu's relative diagonal floor (1e-6 of the
    largest curvature: near-unobservable directions, e.g. a trunk's
    height past every frame, are pinned, not wild). Returns (delta, d)."""
    diag = torch.diagonal(H)
    d = torch.clamp(diag, min=1e-6 * torch.max(diag) + 1e-30, max=1e32)
    A = H + torch.diag(lam * d + (1.0 - free))
    L, info = torch.linalg.cholesky_ex(A)
    delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
    # A failed factorization yields NaN, which the LM test rejects.
    delta = torch.where(info == 0, delta, torch.full_like(delta,
                                                          float("nan")))
    return delta * free, d


def _gsba_solve(problem: GSBAProblem, opt: GSBAOptions):
    free = _free_vector(problem, opt)
    dtype, dev = problem.tvecs.dtype, problem.tvecs.device
    chunks = image_chunks(problem)
    LOG.info("GSBA: pixel work in %d chunk(s) of up to %d image(s) "
             "under a budget of %d bytes", len(chunks), chunks[0].stop,
             GSBA_CHUNK_BYTES)

    cost0 = _cost(problem, opt)
    trace = torch.full((opt.max_iterations + 1,), float("nan"),
                       dtype=dtype, device=dev)
    trace[0] = cost0
    lam = torch.as_tensor(1.0 / opt.initial_trust_radius, dtype=dtype,
                          device=dev)
    nu = torch.as_tensor(2.0, dtype=dtype, device=dev)
    prob, cost, it, done, lin = problem, cost0, 0, False, None
    while it < opt.max_iterations and not done:
        if lin is None:   # a rejected step keeps the same linearization
            lin = _linearize(prob, opt, free)
        g, H = lin
        delta, d = _lm_step(H, g, lam, free)
        q, t, _, (cq, ct, clr, clh), pts = _apply_deltas(prob, opt, delta)
        prob_try = prob._replace(qvecs=q, tvecs=t, cyl_qvec=cq, cyl_tvec=ct,
                                 cyl_log_radius=clr, cyl_log_height=clh,
                                 points=pts)
        new_cost = _cost(prob_try, opt)
        actual = cost - new_cost
        predicted = -(g @ delta + 0.5 * delta @ (H @ delta)
                      + 0.5 * torch.sum(lam * d * delta * delta))
        accept = (actual > 0) & (predicted > 0)
        rho = actual / torch.clamp(predicted, min=1e-30)
        lam = torch.where(
            accept,
            torch.clamp(lam * torch.clamp(1.0 - (2 * rho - 1.0) ** 3,
                                          min=1.0 / 3.0), min=1e-14),
            torch.clamp(lam * nu, max=1e12))
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        cost_new = torch.where(accept, new_cost, cost)
        done_t = ((accept & (torch.abs(actual) < opt.function_tolerance
                             * torch.clamp(cost, min=1e-30)))
                  | (torch.max(torch.abs(g)) < opt.gradient_tolerance)
                  | (lam >= 1e12))
        it += 1
        trace[it] = cost_new
        cost = cost_new
        accepted, done = torch.stack([accept, done_t]).tolist()
        if accepted:
            prob, lin = prob_try, None

    _, iou = _cyl_residuals(prob.qvecs, prob.tvecs, prob.cyl_qvec,
                            prob.cyl_tvec, torch.exp(prob.cyl_log_radius),
                            torch.exp(prob.cyl_log_height), prob, opt,
                            True)
    m = (_geo_img_weight(prob) > 0).to(iou.dtype)
    mean_iou = torch.sum(iou * m[:, None]) / torch.clamp(
        torch.sum(m) * iou.shape[1], min=1.0)
    return prob, GSBASummary(initial_cost=cost0, final_cost=cost,
                             num_iterations=it, cost_trace=trace,
                             per_image_iou=iou, mean_iou=mean_iou)


def geometric_semantic_bundle_adjust(problem: GSBAProblem,
                                     options: Optional[GSBAOptions] = None):
    """Solve; returns (refined problem, GSBASummary)."""
    opt = options or GSBAOptions()
    if opt.axis_name is not None:
        raise NotImplementedError(
            "GSBAOptions.axis_name: images sharded over devices come with "
            "the multi-GPU slice of the port")
    return _gsba_solve(problem, opt)


def evaluate_iou(problem: GSBAProblem, options: Optional[GSBAOptions] = None):
    """Hard per-image x cylinder IoU matrix [N, K] (reference parity)."""
    opt = options or GSBAOptions()
    _, iou = _cyl_residuals(problem.qvecs, problem.tvecs, problem.cyl_qvec,
                            problem.cyl_tvec,
                            torch.exp(problem.cyl_log_radius),
                            torch.exp(problem.cyl_log_height), problem, opt,
                            True)
    return iou


# ---------------------------------------------------------------------------
# Problem construction
# ---------------------------------------------------------------------------

def gsba_problem_from_numpy(fields, device="cuda") -> GSBAProblem:
    """The port's problem from sba_tpu's `GSBAProblem` fields as numpy
    arrays (``{name: np.asarray(value)}``; a None `img_weight` stays
    None), on `device`. Float fields take the dtype of `qvecs`."""
    dt = torch.from_numpy(np.zeros(0, np.asarray(fields["qvecs"]).dtype)
                          ).dtype
    out = {}
    for name in GSBAProblem._fields:
        v = fields.get(name)
        if v is None:
            continue
        if name in ("obs_image", "obs_point"):
            out[name] = torch.tensor(np.asarray(v, np.int64), device=device)
        else:
            out[name] = torch.tensor(np.asarray(v), dtype=dt, device=device)
    return GSBAProblem(**out)


def build_gsba_problem(qvecs, tvecs, cam_params, semantic_maps, cylinders,
                       options: Optional[GSBAOptions] = None, points=None,
                       obs=None, dtype=torch.float64,
                       device="cuda") -> GSBAProblem:
    """Assemble from pose arrays, raw semantic maps (thresholded into
    boolean trunk masks, ref .cc:1328-1333) and host `Cylinder`s, on
    `device`. Gauge as the GSBA controller fixes it: the first pose
    constant and the second image's tvec x constant
    (ref: controllers/geometric_semantic_bundle_adjustment.cc:109-110)."""
    opt = options or GSBAOptions()
    qvecs = np.asarray(qvecs)
    N = qvecs.shape[0]
    masks = (np.asarray(semantic_maps) == opt.trunk_semantic_class
             ).astype(np.float64)
    free_rot = np.ones(N)
    free_trans = np.ones((N, 3))
    free_rot[0] = 0.0
    free_trans[0] = 0.0
    if N > 1:
        free_trans[1, 0] = 0.0
    if points is None:
        points = np.zeros((1, 3))
        obs_image = np.zeros(0, np.int64)
        obs_point = np.zeros(0, np.int64)
        obs_xy = np.zeros((0, 2))
    else:
        obs_image, obs_point, obs_xy = obs

    def f(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    def i(a):
        return torch.tensor(np.asarray(a, np.int64), device=device)

    return GSBAProblem(
        qvecs=f(qvecs), tvecs=f(tvecs), cam_params=f(cam_params),
        sem_masks=f(masks),
        cyl_qvec=f(np.stack([c.qvec for c in cylinders])),
        cyl_tvec=f(np.stack([c.tvec for c in cylinders])),
        cyl_log_radius=f(np.log([c.radius for c in cylinders])),
        cyl_log_height=f(np.log([c.height for c in cylinders])),
        free_rot=f(free_rot), free_trans=f(free_trans),
        points=f(points), obs_image=i(obs_image), obs_point=i(obs_point),
        obs_xy=f(obs_xy), obs_mask=f(np.ones(len(obs_image))),
        free_points=f(np.ones(len(points))))
