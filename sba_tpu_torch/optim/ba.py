"""Bundle adjustment: Levenberg-Marquardt with an explicit Schur step.

Port of the single-device part of ``sba_tpu/optim/ba.py``:

- `BAProblem` is a NamedTuple of tensors: poses ``[N,4]+[N,3]``, points
  ``[P,3]``, zero-padded intrinsics ``[C,12]`` and the observation table.
  Free/fixed parameters are 0/1 multiplier masks (the reference's
  SetConstantPose / SetConstantTvec gauge semantics).
- `_linearize` gives exact per-observation Jacobian blocks by forward-mode
  differentiation (``torch.func.jvp``) of the local, retracted residual.
- `_solve_step_explicit_pm` is the point-major explicit-Schur step: point
  blocks are eliminated in closed form, the reduced camera system
  ``S = B + lam D - EL EL^T`` is assembled dense and solved by Cholesky.
- `_make_operators` builds the implicit Schur operators of one COO
  linearization (segment sums by image, camera and point); `_pcg` and
  `_dense_schur_solve` solve the reduced camera system with them, and
  `_solve_step` adds the back-substitution and the predicted reduction.
- `_bundle_adjust_impl` is the LM trust-region loop (Madsen-Nielsen
  damping, accept/reject on actual vs predicted reduction) as a Python
  loop with one host sync per iteration for the stopping test.

`bundle_adjust` dispatches float32 problems on CUDA to the fused kernel
path (optim/ba_fused.py: dense Schur up to 128 images, implicit PCG
above), and everything else as sba_tpu does: the explicit step while its
couplings fit EXPLICIT_SCHUR_MAX_BYTES, else the dense or the PCG step.
`pad_problem_pow2` pads the incremental mapper's problems to sba_tpu's
power-of-two buckets, so that the solver route (judged on sizes) is
sba_tpu's. The COO explicit step and the SPMD path are not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.geometry.quaternions import (quat_normalize,
                                                quat_retract, quat_rotate)
from sba_tpu_torch.ops.ba_kernels import intrinsic_refine_mask
from sba_tpu_torch.optim.losses import loss_value, loss_weight

MAXP = camera_models.MAX_NUM_PARAMS  # 12
# The explicit step stores the whitened couplings [6N + 12C, 3P]; above
# this many bytes `bundle_adjust` takes the dense or the PCG step.
EXPLICIT_SCHUR_MAX_BYTES = 2 * 1024 ** 3

_FIELDS = ("qvecs", "tvecs", "points", "cam_params", "obs_image",
           "obs_point", "obs_cam", "obs_xy", "obs_mask", "free_rot",
           "free_trans", "free_points", "free_cam")
_INT_FIELDS = ("obs_image", "obs_point", "obs_cam", "image_cam")


class BAProblem(NamedTuple):
    """Dense BA state + structure; all tensors on one device.

    Masks use 1.0 = free, 0.0 = constant; `free_trans` is per component
    so one tvec coordinate can be fixed (the gauge of global BA).
    """

    qvecs: torch.Tensor        # [N, 4]
    tvecs: torch.Tensor        # [N, 3]
    points: torch.Tensor       # [P, 3]
    cam_params: torch.Tensor   # [C, 12] zero-padded
    obs_image: torch.Tensor    # [O] int32
    obs_point: torch.Tensor    # [O] int32
    obs_cam: torch.Tensor      # [O] int32
    obs_xy: torch.Tensor       # [O, 2]
    obs_mask: torch.Tensor     # [O] float (0/1; padding + invalid)
    free_rot: torch.Tensor     # [N]
    free_trans: torch.Tensor   # [N, 3]
    free_points: torch.Tensor  # [P]
    free_cam: torch.Tensor     # [C, 12]
    image_cam: Optional[torch.Tensor] = None  # [N] camera row per image


def problem_from_numpy(arrays, device="cuda", dtype=None) -> BAProblem:
    """BAProblem from a mapping of numpy arrays named like the fields of
    ``sba_tpu.optim.ba.BAProblem`` (extra keys such as its gather layouts
    are ignored). Float fields keep their dtype unless `dtype` is given;
    index fields become int32."""
    def conv(name):
        a = arrays.get(name)
        if a is None:
            return None
        a = np.asarray(a)
        if name in _INT_FIELDS:
            return torch.as_tensor(a.astype(np.int32), device=device)
        t = torch.as_tensor(a, device=device)
        return t if dtype is None else t.to(dtype)

    return BAProblem(**{f: conv(f) for f in _FIELDS + ("image_cam",)})


def problem_to_numpy(problem: BAProblem) -> dict:
    """Inverse of `problem_from_numpy`: {field: numpy array or None}."""
    return {f: (None if v is None else v.detach().cpu().numpy())
            for f, v in problem._asdict().items()}


def pad_problem_pow2(problem: BAProblem, min_images: int = 8,
                     min_points: int = 64, min_obs: int = 256) -> BAProblem:
    """Pad images, points and observations to power-of-two buckets, as
    sba_tpu's incremental mapper does. The port compiles nothing per
    shape; the padding keeps sba_tpu's solver route, since the explicit
    step's byte limit and `dense_threshold` are judged on these sizes.
    Padding rows are fully masked (obs_mask 0, free_* 0, identity poses);
    padding observations are spread round-robin over all padded points,
    and `image_cam` is recomputed over the padded table as sba_tpu's
    `attach_gather_layouts` does."""

    def pow2(n, lo):
        return 1 << int(np.ceil(np.log2(max(n, lo))))

    N = problem.qvecs.shape[0]
    P = problem.points.shape[0]
    O = problem.obs_image.shape[0]
    Np, Pp, Op = pow2(N, min_images), pow2(P, min_points), pow2(O, min_obs)
    if (Np, Pp, Op) == (N, P, O):
        return problem
    arr = problem_to_numpy(problem)

    def padv(a, n, fill=0.0):
        if a.shape[0] == n:
            return a
        return np.concatenate(
            [a, np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)])

    qpad = np.tile(np.asarray([1.0, 0, 0, 0], arr["qvecs"].dtype),
                   (Np - N, 1))
    pad_op = (np.arange(Op - O) % Pp).astype(arr["obs_point"].dtype)
    obs_image = padv(arr["obs_image"], Op)
    obs_cam = padv(arr["obs_cam"], Op)
    image_cam = np.zeros(Np, np.int32)
    image_cam[obs_image] = obs_cam
    out = dict(
        qvecs=np.concatenate([arr["qvecs"], qpad]),
        tvecs=padv(arr["tvecs"], Np), points=padv(arr["points"], Pp),
        cam_params=arr["cam_params"], obs_image=obs_image,
        obs_point=np.concatenate([arr["obs_point"], pad_op]),
        obs_cam=obs_cam, obs_xy=padv(arr["obs_xy"], Op),
        obs_mask=padv(arr["obs_mask"], Op),
        free_rot=padv(arr["free_rot"], Np),
        free_trans=padv(arr["free_trans"], Np),
        free_points=padv(arr["free_points"], Pp),
        free_cam=arr["free_cam"], image_cam=image_cam)
    return problem_from_numpy(out, device=problem.points.device)


@dataclass(frozen=True)
class BAOptions:
    """Solve configuration; same fields and defaults as sba_tpu's
    `BAOptions` for everything the port runs."""

    model_id: int = 0
    loss: str = "trivial"              # trivial | huber | soft_l1 | cauchy
    loss_scale: float = 1.0
    max_iterations: int = 50
    cg_iterations: int = 100
    # Inexact-Newton forcing for the reduced-system PCG of the fused path:
    # the trust region accepts/rejects every step against the true cost.
    cg_tolerance: float = 1e-2
    # Warm-start the reduced-system PCG from the previous LM iteration's
    # camera step, optimally rescaled against the new damped system (so
    # it never starts worse than a cold start). Costs one extra matvec
    # per LM iteration.
    cg_warm_start: bool = False
    function_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-12
    parameter_tolerance: float = 1e-10
    initial_trust_radius: float = 1e4   # lambda0 = 1/radius
    # auto | explicit_schur | dense_schur | schur_pcg | fused
    solver: str = "auto"
    dense_threshold: int = 512         # max reduced dim for dense schur
    refine_focal_length: bool = True
    refine_principal_point: bool = False
    refine_extra_params: bool = True
    refine_extrinsics: bool = True
    # Working precision of the problem `sfm.controllers.adjust_bundle`
    # builds: "float64" is the plain path, "float32" on CUDA the kernels.
    dtype: str = "float64"
    # Fused path: round the Schur-correction factors EL to bfloat16
    # before EL EL^T (f32 accumulation), as the TPU kernel does.
    schur_bf16: bool = True
    # Implicit path: store the PCG matvec's whitened couplings in
    # bfloat16 (the same rounded EL on both sides keeps the operator
    # symmetric PSD). Applied only in the ranged regime.
    matvec_bf16: bool = True
    # Fused reduced-system solve: "dense" (explicit S), "implicit" (PCG
    # whose matvec is the K3 kernel, S never formed), "auto" switches on
    # image count (implicit above 128 images).
    fused_mode: str = "auto"
    # Ranged regime: "auto" at Npad >= 2048 images, "on"/"off" force it.
    # On the card it only selects bf16 couplings (with matvec_bf16) and
    # forces the implicit solve (ops/ba_kernels.py docstring).
    fused_ranged: str = "auto"


class BASummary(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_iterations: int
    num_residuals: torch.Tensor
    gradient_norm: torch.Tensor
    cost_trace: torch.Tensor  # [max_iterations + 1]


# ---------------------------------------------------------------------------
# Layout helpers (host side)
# ---------------------------------------------------------------------------

def _image_cam_of(problem) -> np.ndarray:
    oi = problem.obs_image.cpu().numpy()
    oc = problem.obs_cam.cpu().numpy()
    image_cam = np.zeros(problem.qvecs.shape[0], np.int32)
    image_cam[oi] = oc
    return image_cam


def to_point_major(problem: BAProblem) -> BAProblem:
    """Reorder + pad the observation table to point-major layout:
    O' = P * K rows (K = max track length rounded up to a power of two),
    point p owning rows [p*K, (p+1)*K), padding rows with obs_mask 0.
    Masked observations are dropped before the layout."""
    dev = problem.points.device
    op = problem.obs_point.cpu().numpy()
    om = problem.obs_mask.cpu().numpy()
    P = problem.points.shape[0]
    keep = np.nonzero(om > 0)[0]
    op = op[keep]
    O = len(op)
    counts = np.bincount(op, minlength=P) if O else np.zeros(P, int)
    kmax = max(int(counts.max()), 1) if O else 1
    K = 1 << int(np.ceil(np.log2(kmax)))
    order = np.argsort(op, kind="stable")
    offs = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(O) - offs[op[order]]
    rows = op[order] * K + slot

    def place(t):
        v = t.cpu().numpy()[keep]
        out = np.zeros((P * K,) + v.shape[1:], v.dtype)
        out[rows] = v[order]
        return torch.as_tensor(out, device=dev)

    image_cam = problem.image_cam
    if image_cam is None:
        image_cam = torch.as_tensor(_image_cam_of(problem), device=dev)
    return problem._replace(
        obs_image=place(problem.obs_image),
        obs_point=torch.arange(P, dtype=torch.int32,
                               device=dev).repeat_interleave(K),
        obs_cam=place(problem.obs_cam),
        obs_xy=place(problem.obs_xy),
        obs_mask=place(problem.obs_mask),
        image_cam=image_cam)


def _free_pose(problem: BAProblem, opt: BAOptions):
    """[N, 6] free mask of the pose step (rotation x3, translation)."""
    fp = torch.cat([problem.free_rot[:, None].expand(-1, 3),
                    problem.free_trans], dim=1)
    return fp * 0.0 if not opt.refine_extrinsics else fp


# ---------------------------------------------------------------------------
# Residual + Jacobian blocks
# ---------------------------------------------------------------------------

def _project(qvecs, tvecs, points, cams, model_id):
    """Pixel projections of points [..., 3] by poses / intrinsics
    broadcast against them."""
    p_cam = quat_rotate(qvecs, points) + tvecs
    z = p_cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    uv = p_cam[..., :2] / safe_z[..., None]
    return camera_models.world_to_image(model_id, cams, uv)


def _linearize(problem: BAProblem, opt: BAOptions):
    """Batched residuals + per-observation Jacobian blocks.

    Returns r [O,2], (Jq, Jt, Jx, Jk) of shapes [O,2,3/3/3/12], already
    multiplied by the free-parameter masks and the sqrt IRLS weights.
    Each Jacobian column is one forward-mode derivative (jvp) of the
    residual of the retracted local parametrization, at delta = 0; the
    columns come from one jvp vmapped over the one-hot tangents.
    """
    oi = problem.obs_image.long()
    q0 = problem.qvecs[oi]
    t0 = problem.tvecs[oi]
    x0 = problem.points[problem.obs_point.long()]
    k0 = problem.cam_params[problem.obs_cam.long()]
    xy = problem.obs_xy
    nparams = camera_models.model_by_id(opt.model_id).num_params

    # q0 * exp(dq / 2) through q0's left-multiplication matrix and the
    # first-order exp [1, dq / 2]: the same value and derivative at
    # dq = 0 as `quat_retract` (whose Taylor branch it is there), in a
    # few operations instead of ~40 under the forward-mode transform.
    w, x, y, z = q0.unbind(-1)
    L0 = torch.stack([torch.stack(r_, -1) for r_ in (
        (w, -x, -y, -z), (x, w, -z, y), (y, z, w, -x), (z, -y, x, w))], -2)

    def residual(dq, dt, dx, dk):
        qe = torch.cat([torch.ones_like(dq[..., :1]), 0.5 * dq], -1)
        q = quat_normalize((L0 @ qe[..., None])[..., 0])
        return _project(q, t0 + dt, x0 + dx, k0 + dk, opt.model_id) - xy

    primals = (torch.zeros_like(t0), torch.zeros_like(t0),
               torch.zeros_like(t0), torch.zeros_like(k0))
    r = residual(*primals)
    # All 9 + nparams columns in one forward-mode pass, vmapped over the
    # one-hot tangents (each column's bits are those of its own jvp; one
    # pass keeps the per-operation host cost of the transform once).
    D = 9 + nparams
    tangents = []
    col = 0
    for arg, width in ((0, 3), (1, 3), (2, 3), (3, nparams)):
        tg = torch.zeros((D,) + primals[arg].shape, dtype=r.dtype,
                         device=r.device)
        for j in range(width):
            tg[col + j, :, j] = 1.0
        col += width
        tangents.append(tg)
    J = torch.func.vmap(
        lambda *t: torch.func.jvp(residual, primals, t)[1])(*tangents)
    J = J.permute(1, 2, 0)                                  # [O, 2, 9+np]
    Jq, Jt, Jx = J[..., 0:3], J[..., 3:6], J[..., 6:9]
    Jk = torch.zeros(J.shape[:2] + (MAXP,), dtype=J.dtype, device=J.device)
    Jk[..., :nparams] = J[..., 9:]
    return _apply_linearize_masks(problem, opt, r, Jq, Jt, Jx, Jk)


def _apply_linearize_masks(problem, opt, r, Jq, Jt, Jx, Jk):
    s = torch.sum(r * r, dim=-1)
    w = problem.obs_mask * loss_weight(opt.loss, s, opt.loss_scale)
    sw = torch.sqrt(w)[:, None]
    r = r * sw
    sww = sw[..., None]
    oi = problem.obs_image.long()
    ext = 1.0 if opt.refine_extrinsics else 0.0
    rot_mask = (problem.free_rot[oi] * ext)[:, None, None]
    trans_mask = (problem.free_trans[oi] * ext)[:, None, :]
    refine = torch.as_tensor(intrinsic_refine_mask(opt), dtype=r.dtype,
                             device=r.device)
    cam_mask = (problem.free_cam * refine)[problem.obs_cam.long()][:, None, :]
    Jq = Jq * sww * rot_mask
    Jt = Jt * sww * trans_mask
    Jx = Jx * sww * problem.free_points[problem.obs_point.long()][:, None,
                                                                  None]
    Jk = Jk * sww * cam_mask
    return r, Jq, Jt, Jx, Jk


def _sym3_inverse(A, eps=1e-12):
    """Batched closed-form inverse of symmetric 3x3 blocks [P,3,3]."""
    a, b, c = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    d, e, f = A[:, 1, 1], A[:, 1, 2], A[:, 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / torch.where(torch.abs(det) > eps, det,
                                torch.full_like(det, eps))
    inv = torch.stack([
        torch.stack([co00, co01, co02], -1),
        torch.stack([co01, co11, co12], -1),
        torch.stack([co02, co12, co22], -1)], -2)
    return inv * inv_det[:, None, None]


# ---------------------------------------------------------------------------
# Cost
# ---------------------------------------------------------------------------

def _residuals_only(qvecs, tvecs, points, cam_params, problem: BAProblem,
                    opt: BAOptions):
    """Pixel residuals [O, 2] of the observations at the given values
    (no loss, no mask)."""
    oi = problem.obs_image.long()
    proj = _project(qvecs[oi], tvecs[oi], points[problem.obs_point.long()],
                    cam_params[problem.obs_cam.long()], opt.model_id)
    return proj - problem.obs_xy


def _cost(qvecs, tvecs, points, cam_params, problem: BAProblem,
          opt: BAOptions):
    r = _residuals_only(qvecs, tvecs, points, cam_params, problem, opt)
    s = torch.sum(r * r, dim=-1)
    return 0.5 * torch.sum(problem.obs_mask
                           * loss_value(opt.loss, s, opt.loss_scale))


def evaluate_cost(problem: BAProblem, options: BAOptions):
    return _cost(problem.qvecs, problem.tvecs, problem.points,
                 problem.cam_params, problem, options)


# ---------------------------------------------------------------------------
# The LM step and loop
# ---------------------------------------------------------------------------

def _segsum(v, idx, n, dim=0):
    """Sum the slices of v along `dim` into n slices by idx."""
    shape = list(v.shape)
    shape[dim] = n
    return torch.zeros(shape, dtype=v.dtype, device=v.device).index_add_(
        dim, idx, v)


def _clamp_diag(d):
    return torch.clamp(d, 1e-6, 1e32)


def _solve_step_explicit_pm(problem: BAProblem, opt: BAOptions, lam):
    """Point-major explicit-Schur LM step (see module docstring). Needs
    the layout of `to_point_major`. Returns (u_pose [N,6], u_cam [C,12],
    d_pts [P,3], predicted, g_inf)."""
    r, Jq, Jt, Jx, Jk = _linearize(problem, opt)
    N = problem.qvecs.shape[0]
    P = problem.points.shape[0]
    C = problem.cam_params.shape[0]
    O = r.shape[0]
    K = O // P
    oi = problem.obs_image.long()
    oc = problem.obs_cam.long()
    op = problem.obs_point.long()
    dtype, dev = r.dtype, r.device
    D = 6 * N + MAXP * C
    Jc = torch.cat([Jq, Jt], dim=-1)                        # [O, 2, 6]

    def pt_reduce(v):
        return torch.sum(v.reshape((P, K) + v.shape[1:]), dim=1)

    def img_reduce(v):
        return _segsum(v, oi, N)

    # ---- point side ----
    g_pts = pt_reduce(torch.einsum("oki,ok->oi", Jx, r))     # [P, 3]
    Hpp = pt_reduce(torch.einsum("oki,okj->oij", Jx, Jx))    # [P, 3, 3]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    d_pts_l = lam * _clamp_diag(torch.diagonal(Hpp, dim1=1, dim2=2))
    Hpp = Hpp + torch.diag_embed(d_pts_l) + 1e-12 * eye3
    Hpp_inv = _sym3_inverse(Hpp)
    Lp = torch.linalg.cholesky(Hpp_inv + 1e-14 * eye3)       # [P, 3, 3]

    # ---- image side ----
    g_pose = img_reduce(torch.einsum("oki,ok->oi", Jc, r))   # [N, 6]
    Hcc_pose = img_reduce(torch.einsum("oki,okj->oij", Jc, Jc))
    Hpc_img = img_reduce(torch.einsum("oki,okj->oij", Jc, Jk))  # [N,6,12]
    img_cam = problem.image_cam.long()
    g_cam = _segsum(img_reduce(torch.einsum("oki,ok->oi", Jk, r)), img_cam, C)
    Hcc_cam = _segsum(img_reduce(torch.einsum("oki,okj->oij", Jk, Jk)),
                      img_cam, C)
    d_pose_l = lam * _clamp_diag(torch.diagonal(Hcc_pose, dim1=1, dim2=2))
    d_cam_l = lam * _clamp_diag(torch.diagonal(Hcc_cam, dim1=1, dim2=2))

    # ---- whitened coupling matrix EL [D, 3P]: rows n*6+i | 6N+c*12+m ----
    LpO = Lp.repeat_interleave(K, dim=0)                     # [O, 3, 3]
    WL_pose = torch.einsum("oij,ojk->oik",
                           torch.einsum("oki,okj->oij", Jc, Jx), LpO)
    WL_cam = torch.einsum("oij,ojk->oik",
                          torch.einsum("oki,okj->oij", Jk, Jx), LpO)
    EL_pose = torch.zeros(N, P, 6, 3, dtype=dtype, device=dev)
    EL_pose.index_put_((oi, op), WL_pose, accumulate=True)
    EL_cam = torch.zeros(C, P, MAXP, 3, dtype=dtype, device=dev)
    EL_cam.index_put_((oc, op), WL_cam, accumulate=True)
    EL = torch.cat([EL_pose.permute(0, 2, 1, 3).reshape(6 * N, 3 * P),
                    EL_cam.permute(0, 2, 1, 3).reshape(MAXP * C, 3 * P)])

    # ---- assemble + solve the reduced system ----
    bi = (torch.arange(N, device=dev)[:, None] * 6
          + torch.arange(6, device=dev)[None, :])            # [N, 6]
    ci = 6 * N + (torch.arange(C, device=dev)[:, None] * MAXP
                  + torch.arange(MAXP, device=dev)[None, :])  # [C, 12]
    cam_cols = ci[img_cam]                                   # [N, 12]
    B = torch.zeros(D, D, dtype=dtype, device=dev)
    B.index_put_((bi[:, :, None], bi[:, None, :]), Hcc_pose, accumulate=True)
    B.index_put_((ci[:, :, None], ci[:, None, :]), Hcc_cam, accumulate=True)
    B.index_put_((bi[:, :, None], cam_cols[:, None, :]), Hpc_img,
                 accumulate=True)
    B.index_put_((cam_cols[:, :, None], bi[:, None, :]),
                 Hpc_img.transpose(1, 2), accumulate=True)
    d_l = torch.cat([d_pose_l.reshape(-1), d_cam_l.reshape(-1)])
    S = B + torch.diag(d_l) - EL @ EL.T
    free_pose = _free_pose(problem, opt)
    free_cam_m = problem.free_cam * torch.as_tensor(
        intrinsic_refine_mask(opt), dtype=dtype, device=dev)
    free = torch.cat([free_pose.reshape(-1), free_cam_m.reshape(-1)])
    S = S * free[:, None] * free[None, :] + torch.diag(1.0 - free)

    Ltg = torch.einsum("pji,pj->pi", Lp, g_pts).reshape(-1)  # [3P]
    Ey = EL @ Ltg
    g_u = torch.cat([g_pose.reshape(-1), g_cam.reshape(-1)])
    b = (-g_u + Ey) * free
    chol = torch.linalg.cholesky_ex(S)[0]
    du = torch.cholesky_solve(b[:, None], chol)[:, 0]
    u_pose = du[:6 * N].reshape(N, 6) * free_pose
    u_cam = du[6 * N:].reshape(C, MAXP) * free_cam_m
    du_masked = torch.cat([u_pose.reshape(-1), u_cam.reshape(-1)])

    # Back-substitution: dp = -Hpp^-1 g_p - Lp (EL^T du).
    ELt_du = (EL.T @ du_masked).reshape(P, 3)
    dp = (-torch.einsum("pij,pj->pi", Hpp_inv, g_pts)
          - torch.einsum("pij,pj->pi", Lp, ELt_du))
    d_pts_step = dp * problem.free_points[:, None]

    # Predicted reduction -(g^T d + 1/2 d^T (H + D) d).
    t = (torch.einsum("oki,oi->ok", Jc, u_pose[oi])
         + torch.einsum("oki,oi->ok", Jk, u_cam[oc])
         + torch.einsum("oki,oi->ok", Jx,
                        d_pts_step.repeat_interleave(K, dim=0)))
    gTd = (torch.sum(g_pose * u_pose) + torch.sum(g_cam * u_cam)
           + torch.sum(g_pts * d_pts_step))
    dHd = (torch.sum(t * t) + torch.sum(d_pts_l * d_pts_step * d_pts_step)
           + torch.sum(d_pose_l * u_pose * u_pose)
           + torch.sum(d_cam_l * u_cam * u_cam))
    predicted = -(gTd + 0.5 * dHd)
    g_inf = torch.maximum(
        torch.max(torch.abs(g_pose)),
        torch.maximum(torch.max(torch.abs(g_cam)),
                      torch.max(torch.abs(g_pts))))
    return u_pose, u_cam, d_pts_step, predicted, g_inf


def _make_operators(problem: BAProblem, r, Jq, Jt, Jx, Jk, lam):
    """The implicit Schur operators of one COO linearization.

    Reduced unknowns u = (pose [N,6], cam [C,12]); the points [P,3] are
    eliminated. The operators take a leading batch of vectors
    ([..., N, 6], [..., C, 12]), which `_dense_schur_solve` uses to
    apply them to a basis.
    """
    N = problem.qvecs.shape[0]
    P = problem.points.shape[0]
    C = problem.cam_params.shape[0]
    oi = problem.obs_image.long()
    op = problem.obs_point.long()
    oc = problem.obs_cam.long()
    Jc = torch.cat([Jq, Jt], dim=-1)                        # [O, 2, 6]

    def obs_sum(v, idx, n):                 # [..., O, d] -> [..., n, d]
        return _segsum(v, idx, n, v.ndim - 2)

    g_pose = _segsum(torch.einsum("oki,ok->oi", Jc, r), oi, N)
    g_cam = _segsum(torch.einsum("oki,ok->oi", Jk, r), oc, C)
    g_pts = _segsum(torch.einsum("oki,ok->oi", Jx, r), op, P)
    d_pose_l = lam * _clamp_diag(
        _segsum(torch.einsum("oki,oki->oi", Jc, Jc), oi, N))
    d_cam_l = lam * _clamp_diag(
        _segsum(torch.einsum("oki,oki->oi", Jk, Jk), oc, C))
    d_pts_l = lam * _clamp_diag(
        _segsum(torch.einsum("oki,oki->oi", Jx, Jx), op, P))
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    Hpp = (_segsum(torch.einsum("oki,okj->oij", Jx, Jx), op, P)
           + torch.diag_embed(d_pts_l) + 1e-12 * eye3)
    Hpp_inv = _sym3_inverse(Hpp)

    def J_apply(u_pose, u_cam, v_pts=None):
        """(J [u; v]) per observation -> [..., O, 2]."""
        out = (torch.einsum("oki,...oi->...ok", Jc, u_pose[..., oi, :])
               + torch.einsum("oki,...oi->...ok", Jk, u_cam[..., oc, :]))
        if v_pts is not None:
            out = out + torch.einsum("oki,...oi->...ok", Jx,
                                     v_pts[..., op, :])
        return out

    def JT_apply_cam(t):
        return (obs_sum(torch.einsum("oki,...ok->...oi", Jc, t), oi, N),
                obs_sum(torch.einsum("oki,...ok->...oi", Jk, t), oc, C))

    def JT_apply_pts(t):
        return obs_sum(torch.einsum("oki,...ok->...oi", Jx, t), op, P)

    def hpp_solve(y):
        return torch.einsum("pij,...pj->...pi", Hpp_inv, y)

    def schur_matvec(u_pose, u_cam):
        """S u = (Hcc + lam Dc) u - Hcp Hpp^-1 Hpc u, implicit."""
        t1 = J_apply(u_pose, u_cam)
        z = hpp_solve(JT_apply_pts(t1))
        t2 = torch.einsum("oki,...oi->...ok", Jx, z[..., op, :])
        a_pose, a_cam = JT_apply_cam(t1 - t2)
        return a_pose + d_pose_l * u_pose, a_cam + d_cam_l * u_cam

    # SCHUR_JACOBI preconditioner blocks; fixed parameters have all-zero
    # rows, made invertible.
    Bp = torch.einsum("oki,okj->oij", Jc, Jx)               # [O, 6, 3]
    Bc = torch.einsum("oki,okj->oij", Jk, Jx)               # [O, 12, 3]
    HinvO = Hpp_inv[op]
    S_pose = (_segsum(torch.einsum("oki,okj->oij", Jc, Jc), oi, N)
              - _segsum(torch.einsum("oij,ojk,olk->oil", Bp, HinvO, Bp),
                        oi, N))
    S_cam = (_segsum(torch.einsum("oki,okj->oij", Jk, Jk), oc, C)
             - _segsum(torch.einsum("oij,ojk,olk->oil", Bc, HinvO, Bc),
                       oc, C))
    free_pose = torch.cat([problem.free_rot[:, None].expand(-1, 3),
                           problem.free_trans], dim=1)
    S_pose = (S_pose + torch.diag_embed(d_pose_l + 1e-10)
              + torch.diag_embed(1.0 - free_pose))
    S_cam = (S_cam + torch.diag_embed(d_cam_l + 1e-10)
             + torch.diag_embed(1.0 - problem.free_cam))
    P_pose = torch.linalg.inv(S_pose)
    P_cam = torch.linalg.inv(S_cam)

    def precond(u_pose, u_cam):
        return (torch.einsum("nij,nj->ni", P_pose, u_pose),
                torch.einsum("cij,cj->ci", P_cam, u_cam))

    # RHS: b = -g_c + Hcp Hpp^-1 g_p.
    zp = hpp_solve(g_pts)
    hp_pose, hp_cam = JT_apply_cam(torch.einsum("oki,oi->ok", Jx, zp[op]))

    def back_substitute(u_pose, u_cam):
        return hpp_solve(-g_pts - JT_apply_pts(J_apply(u_pose, u_cam)))

    return dict(
        schur_matvec=schur_matvec, precond=precond,
        b_pose=-g_pose + hp_pose, b_cam=-g_cam + hp_cam,
        back_substitute=back_substitute,
        g_pose=g_pose, g_cam=g_cam, g_pts=g_pts,
        d_pose_l=d_pose_l, d_cam_l=d_cam_l, d_pts_l=d_pts_l,
        J_apply=J_apply)


def _pcg(matvec, precond, b_pose, b_cam, iters, tol):
    """Preconditioned CG on the reduced camera system. Stops at the
    first iteration whose residual is under `tol` relative to b (one
    host sync per iteration), or after `iters` matvecs."""

    def dot(a, b):
        return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

    x = (torch.zeros_like(b_pose), torch.zeros_like(b_cam))
    r = (b_pose, b_cam)
    z = precond(*r)
    p = z
    rz = dot(r, z)
    thresh = tol * tol * torch.clamp(dot(r, r), min=1e-30)
    i = 0
    while i < iters and bool(dot(r, r) > thresh):
        Ap = matvec(*p)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
        x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        r = (r[0] - alpha * Ap[0], r[1] - alpha * Ap[1])
        z = precond(*r)
        rz_new = dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = (z[0] + beta * p[0], z[1] + beta * p[1])
        rz = rz_new
        i += 1
    return x


def _dense_schur_solve(matvec, b_pose, b_cam, n_obs):
    """Materialize the reduced system by applying the implicit operator
    to a basis and solve it by Cholesky: the DENSE_SCHUR path for small
    reduced systems. The basis goes through the operator in chunks whose
    largest intermediate ([chunk, n_obs, 12]) stays near 256 MiB."""
    N, C = b_pose.shape[0], b_cam.shape[0]
    dim = N * 6 + C * MAXP
    eye = torch.eye(dim, dtype=b_pose.dtype, device=b_pose.device)
    step = max(1, 2 ** 28 // (max(n_obs, 1) * MAXP * eye.element_size()))
    rows = []
    for c0 in range(0, dim, step):
        e = eye[c0:c0 + step]
        mp, mc = matvec(e[:, :N * 6].reshape(-1, N, 6),
                        e[:, N * 6:].reshape(-1, C, MAXP))
        rows.append(torch.cat([mp.reshape(e.shape[0], -1),
                               mc.reshape(e.shape[0], -1)], dim=1))
    S = torch.cat(rows).T
    b = torch.cat([b_pose.reshape(-1), b_cam.reshape(-1)])
    chol = torch.linalg.cholesky_ex(S)[0]
    x = torch.cholesky_solve(b[:, None], chol)[:, 0]
    return x[:N * 6].reshape(N, 6), x[N * 6:].reshape(C, MAXP)


def _solve_step(problem: BAProblem, opt: BAOptions, lam):
    """One linearization + linear solve by `opt.solver` (explicit_schur
    on a point-major problem, dense_schur or schur_pcg on any layout).
    Returns (u_pose, u_cam, d_pts, predicted, g_inf), the step masked."""
    if opt.solver == "explicit_schur":
        return _solve_step_explicit_pm(problem, opt, lam)
    lin = _linearize(problem, opt)
    ops = _make_operators(problem, *lin, lam)
    if opt.solver == "dense_schur":
        u_pose, u_cam = _dense_schur_solve(ops["schur_matvec"],
                                           ops["b_pose"], ops["b_cam"],
                                           lin[0].shape[0])
    else:
        u_pose, u_cam = _pcg(ops["schur_matvec"], ops["precond"],
                             ops["b_pose"], ops["b_cam"],
                             opt.cg_iterations, opt.cg_tolerance)
    d_pts = ops["back_substitute"](u_pose, u_cam)

    # Re-mask the step (numerical safety; preconditioner identity rows).
    u_pose = u_pose * _free_pose(problem, opt)
    u_cam = u_cam * problem.free_cam * torch.as_tensor(
        intrinsic_refine_mask(opt), dtype=u_cam.dtype, device=u_cam.device)
    d_pts = d_pts * problem.free_points[:, None]

    # Predicted reduction: -(g^T d + 1/2 d^T H d) with H including damping.
    t = ops["J_apply"](u_pose, u_cam, d_pts)
    gTd = (torch.sum(ops["g_pose"] * u_pose) + torch.sum(ops["g_cam"] * u_cam)
           + torch.sum(ops["g_pts"] * d_pts))
    dHd = (torch.sum(t * t)
           + torch.sum(ops["d_pose_l"] * u_pose * u_pose)
           + torch.sum(ops["d_cam_l"] * u_cam * u_cam)
           + torch.sum(ops["d_pts_l"] * d_pts * d_pts))
    predicted = -(gTd + 0.5 * dHd)
    g_inf = torch.maximum(
        torch.max(torch.abs(ops["g_pose"])),
        torch.maximum(torch.max(torch.abs(ops["g_cam"])),
                      torch.max(torch.abs(ops["g_pts"]))))
    return u_pose, u_cam, d_pts, predicted, g_inf


def lm_update(lam, nu, cost, new_cost, predicted):
    """Madsen-Nielsen damping update (device tensors, no host sync).
    Returns (accept, actual, lam, nu)."""
    actual = cost - new_cost
    rho = actual / torch.clamp(predicted, min=1e-30)
    accept = (actual > 0) & (predicted > 0)
    lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam = torch.where(accept, torch.clamp(lam_acc, min=1e-14),
                      torch.clamp(lam * nu, max=1e10))
    nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
    return accept, actual, lam, nu


def lm_done(opt: BAOptions, accept, actual, cost, g_inf, lam, step_norm,
            x_norm):
    """The solve's stopping rule (device bool)."""
    return ((accept & (torch.abs(actual) < opt.function_tolerance
                       * torch.clamp(cost, min=1e-30)))
            | (g_inf < opt.gradient_tolerance)
            | (accept & (step_norm < opt.parameter_tolerance * x_norm))
            | (lam >= 1e10))


def _bundle_adjust_impl(problem: BAProblem, options: BAOptions):
    """LM loop over `_solve_step` (a point-major problem for the
    explicit step)."""
    opt = options
    cost0 = evaluate_cost(problem, opt)
    q, t, x, k = (problem.qvecs, problem.tvecs, problem.points,
                  problem.cam_params)
    lam = torch.full_like(cost0, 1.0 / opt.initial_trust_radius)
    nu = torch.full_like(cost0, 2.0)
    cost = cost0
    g_inf = torch.full_like(cost0, float("inf"))
    trace = torch.full((opt.max_iterations + 1,), float("nan"),
                       dtype=cost0.dtype, device=cost0.device)
    trace[0] = cost0
    it = 0
    while it < opt.max_iterations:
        prob = problem._replace(qvecs=q, tvecs=t, points=x, cam_params=k)
        u_pose, u_cam, d_pts, predicted, g_inf = _solve_step(prob, opt,
                                                             lam)
        q2 = quat_retract(q, u_pose[:, :3])
        t2 = t + u_pose[:, 3:]
        x2 = x + d_pts
        k2 = k + u_cam
        new_cost = _cost(q2, t2, x2, k2, problem, opt)
        accept, actual, lam, nu = lm_update(lam, nu, cost, new_cost,
                                            predicted)
        q = torch.where(accept, q2, q)
        t = torch.where(accept, t2, t)
        x = torch.where(accept, x2, x)
        k = torch.where(accept, k2, k)
        prev_cost = cost
        cost = torch.where(accept, new_cost, cost)
        step_norm = torch.sqrt(torch.sum(u_pose ** 2) + torch.sum(u_cam ** 2)
                               + torch.sum(d_pts ** 2))
        x_norm = torch.sqrt(torch.sum(t ** 2) + torch.sum(x ** 2)
                            + torch.sum(k ** 2)) + 1.0
        it += 1
        trace[it] = cost
        if bool(lm_done(opt, accept, actual, prev_cost, g_inf, lam,
                        step_norm, x_norm)):
            break
    out = problem._replace(qvecs=q, tvecs=t, points=x, cam_params=k)
    summary = BASummary(
        initial_cost=cost0, final_cost=cost, num_iterations=it,
        num_residuals=torch.sum(problem.obs_mask).to(torch.int32),
        gradient_norm=g_inf, cost_trace=trace)
    return out, summary


def bundle_adjust(problem: BAProblem, options: Optional[BAOptions] = None):
    """Solve. float32 problems on CUDA go through the fused kernels.
    Everything else is routed as sba_tpu routes it: the point-major
    explicit-Schur step while its couplings fit
    EXPLICIT_SCHUR_MAX_BYTES (solver auto or explicit_schur); otherwise
    the dense step for solver dense_schur, or under auto for a reduced
    system of at most `dense_threshold` unknowns, and the PCG step for
    the rest. (sba_tpu's explicit_schur above the limit takes its COO
    explicit step, which is not ported: the port takes the PCG step.)"""
    options = options or BAOptions()
    if options.solver not in ("auto", "fused", "explicit_schur",
                              "dense_schur", "schur_pcg"):
        raise ValueError(f"unknown solver {options.solver!r}")
    if options.solver in ("auto", "fused"):
        from sba_tpu_torch.optim import ba_fused

        if ba_fused.can_use_fused(problem, options):
            return ba_fused.bundle_adjust_fused(problem, options)
    n, c, p = (problem.qvecs.shape[0], problem.cam_params.shape[0],
               problem.points.shape[0])
    reduced = 6 * n + MAXP * c
    fits = (reduced * 3 * p * problem.points.element_size()
            <= EXPLICIT_SCHUR_MAX_BYTES)
    if fits and options.solver in ("auto", "fused", "explicit_schur"):
        options = dataclasses.replace(options, solver="explicit_schur")
        return _bundle_adjust_impl(to_point_major(problem), options)
    dense = options.solver == "dense_schur" or (
        options.solver in ("auto", "fused")
        and reduced <= options.dense_threshold)
    options = dataclasses.replace(
        options, solver="dense_schur" if dense else "schur_pcg")
    return _bundle_adjust_impl(problem, options)


# ---------------------------------------------------------------------------
# Problem construction from a SceneArrays view
# ---------------------------------------------------------------------------

def build_problem(arrays, constant_pose_rows=(), constant_tvec_rows=None,
                  constant_point_rows=(), constant_cam_rows=(),
                  dtype=torch.float64, device="cuda") -> BAProblem:
    """Assemble a BAProblem from a `SceneArrays` dense view.

    constant_tvec_rows: {image_row: [component indices]}.
    """
    n = arrays.num_images
    p = max(arrays.num_points, 1)
    c = len(arrays.camera_ids)
    free_rot = np.ones(n)
    free_trans = np.ones((n, 3))
    for row in constant_pose_rows:
        free_rot[row] = 0.0
        free_trans[row] = 0.0
    for row, comps in (constant_tvec_rows or {}).items():
        for comp in comps:
            free_trans[row, comp] = 0.0
    free_points = np.ones(p)
    if arrays.num_points == 0:
        free_points[:] = 0.0
    for row in constant_point_rows:
        free_points[row] = 0.0
    free_cam = np.ones((c, MAXP))
    for row in constant_cam_rows:
        free_cam[row] = 0.0
    points = arrays.points if arrays.num_points else np.zeros((1, 3))
    obs_cam = arrays.obs_camera_idx()
    image_cam = np.zeros(n, np.int32)
    image_cam[arrays.obs_image] = obs_cam
    return problem_from_numpy(dict(
        qvecs=arrays.qvecs, tvecs=arrays.tvecs, points=points,
        cam_params=arrays.camera_params, obs_image=arrays.obs_image,
        obs_point=arrays.obs_point, obs_cam=obs_cam, obs_xy=arrays.obs_xy,
        obs_mask=np.ones(arrays.num_observations), free_rot=free_rot,
        free_trans=free_trans, free_points=free_points, free_cam=free_cam,
        image_cam=image_cam), device=device, dtype=dtype)
