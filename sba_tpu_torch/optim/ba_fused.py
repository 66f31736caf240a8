"""Fused-kernel bundle adjustment: the single-device fast path.

Port of the dense branch of ``sba_tpu/optim/ba_fused.py``. It drives the
kernels of ops/ba_kernels.py inside the LM trust-region loop of
optim/ba.py. Per LM iteration and per track-length bucket:

  K1 `fused_schur`  -> per-image/point payloads, Schur correction
                       S_corr = EL EL^T, RHS coupling Ey, stored blocks
  epilogue (plain torch) -> assemble the reduced system S, damping, gauge
                       masks, Jacobi-PCG solve for du (`_solve_reduced`)
  K4 `backsub`      -> point step dp + predicted-reduction sums
  K5 `fused_cost`   -> trial cost for accept/reject

On CUDA tensors the kernels are the hand-written CUDA ones; on CPU
tensors their plain twins. The implicit path for more than
DENSE_MAX_IMAGES images (kernels K2/K3) is not ported and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from sba_tpu_torch.geometry.quaternions import quat_retract
from sba_tpu_torch.ops import ba_kernels as bk
from sba_tpu_torch.optim.ba import (
    MAXP, BAOptions, BAProblem, BASummary, _image_cam_of, lm_done,
    lm_update, problem_to_numpy,
)

DENSE_MAX_IMAGES = 128   # auto-policy crossover to the implicit path
TP = 128                 # points per kernel block
MAX_BUCKETS = 3          # track-length buckets


def use_implicit(lay, options: BAOptions) -> bool:
    if options.fused_mode == "dense":
        return False
    if options.fused_mode == "implicit":
        return True
    return lay.N > DENSE_MAX_IMAGES


def can_use_fused(problem: BAProblem, options: BAOptions) -> bool:
    """The problem's tensors are float32 on CUDA and the camera model is
    one whose CUDA kernel heads are ported."""
    return (problem.points.is_cuda
            and problem.points.dtype == torch.float32
            and options.model_id in bk.CUDA_MODELS)


def _solve_reduced(S, b, free, opt: BAOptions):
    """Jacobi-preconditioned CG on the masked dense reduced system.

    Same stopping rule as the reference's while loop (at most
    opt.cg_iterations matvecs, relative residual opt.cg_tolerance). The
    updates are masked once converged, so the device runs a fixed trip
    count and the host checks for convergence every 8 iterations only.
    """
    S = S * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    b = b * free
    d = torch.diagonal(S)
    dinv = 1.0 / torch.where(torch.abs(d) > 1e-30, d, torch.ones_like(d))
    bnorm2 = torch.clamp(torch.dot(b, b), min=1e-30)
    thresh = (opt.cg_tolerance ** 2) * bnorm2
    x = torch.zeros_like(b)
    r = b
    p = dinv * r
    rz = torch.dot(r, p)
    for i in range(opt.cg_iterations):
        active = torch.dot(r, r) > thresh
        if i % 8 == 0 and not bool(active):
            break
        Ap = S @ p
        alpha = rz / torch.clamp(torch.dot(p, Ap), min=1e-30)
        x = torch.where(active, x + alpha * p, x)
        r_new = r - alpha * Ap
        z = dinv * r_new
        rz_new = torch.dot(r_new, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = torch.where(active, z + beta * p, p)
        r = torch.where(active, r_new, r)
        rz = torch.where(active, rz_new, rz)
    return x * free


def _bucketize(problem: dict, options: BAOptions, device):
    """Partition points into track-length buckets (host side, numpy).

    Returns [(static, lay, idx)] with idx the bucket's original point
    indices; the bucket's padded points are columns [0, len(idx)) of
    its [3, lay.Pp] array.
    """
    op = problem["obs_point"]
    oi = problem["obs_image"]
    oc = problem["obs_cam"]
    oxy = problem["obs_xy"]
    om = problem["obs_mask"]
    P = problem["points"].shape[0]
    counts = np.maximum(np.bincount(op[om > 0], minlength=P), 1)

    # Quantile slot counts; the top bucket carries the max track length.
    qs = np.linspace(0, 1, MAX_BUCKETS + 1)[1:]
    ks = sorted({int(np.ceil(np.quantile(counts, q))) for q in qs})
    ks[-1] = int(counts.max())
    ks = sorted(set(ks))
    k_of_point = np.asarray(
        [next((k for k in ks if k >= c), ks[-1]) for c in counts])

    order = np.argsort(op, kind="stable")
    offs = np.concatenate([[0], np.cumsum(np.bincount(op, minlength=P))])
    # Locality sort by mean observing image (kept from the reference
    # for identical point order inside each bucket).
    sum_img = np.zeros(P)
    real = om > 0
    np.add.at(sum_img, op[real], oi[real].astype(np.float64))
    mean_img = sum_img / counts

    buckets = []
    for K in ks:
        idx = np.nonzero(k_of_point == K)[0]
        if len(idx) == 0:
            continue
        idx = idx[np.argsort(mean_img[idx], kind="stable")]
        Pb = len(idx)
        sub = dict(problem)
        sub_oi = np.zeros(Pb * K, np.int32)
        sub_oc = np.zeros(Pb * K, np.int32)
        sub_xy = np.zeros((Pb * K, 2), np.float64)
        sub_m = np.zeros(Pb * K, np.float64)
        for local, p in enumerate(idx):
            rows = order[offs[p]:offs[p + 1]]
            if len(rows) > K:
                rows = rows[np.argsort(-om[rows], kind="stable")][:K]
            n = len(rows)
            base = local * K
            sub_oi[base:base + n] = oi[rows]
            sub_oc[base:base + n] = oc[rows]
            sub_xy[base:base + n] = oxy[rows]
            sub_m[base:base + n] = om[rows]
        sub.update(points=problem["points"][idx],
                   free_points=problem["free_points"][idx],
                   obs_image=sub_oi,
                   obs_point=np.repeat(np.arange(Pb, dtype=np.int32), K),
                   obs_cam=sub_oc, obs_xy=sub_xy, obs_mask=sub_m)
        lay = bk.plan_layout(sub, options, TP)
        static = bk.build_static(sub, options, lay, device)
        buckets.append((static, lay, idx))
    return buckets


def _fused_step(statics, lays, opt, qvecs, tvecs, pts_list, cams, lam,
                free_arrays):
    """One linearize + solve over all buckets. Returns (u_pose [N,6],
    u_cam [C,12], dp_list (per-bucket [3, Pp]), predicted, g_inf)."""
    lay0 = lays[0]
    N, C, Npad, Dk = lay0.N, lay0.C, lay0.Npad, lay0.Dk
    nparams = lay0.nparams
    if use_implicit(lay0, opt):
        raise NotImplementedError("implicit path: K2/K3 not yet ported")
    image_cam = statics[0].image_cam
    dev = qvecs.device
    f32 = dict(dtype=torch.float32, device=dev)

    par = bk.pack_params(qvecs, tvecs, cams, image_cam, lay0)
    s_corr = torch.zeros(Dk, Dk, **f32)
    img_red = torch.zeros(Npad, lay0.DI, **f32)
    ey = torch.zeros(Dk, **f32)
    per_bucket = []
    for static, lay, pts_b in zip(statics, lays, pts_list):
        s_b, i_b, e_b, pt_pay, jw = bk.fused_schur(static, par, pts_b, lam,
                                                   lay, opt)
        s_corr += s_b
        img_red += i_b
        ey += e_b
        per_bucket.append((pt_pay, jw))

    # ---- unpack the image payload ----
    ofs = np.cumsum([0, 6, 36, 6 * nparams, nparams, nparams * nparams])
    red = img_red[:N]
    icam = image_cam[:N].long()
    g_pose = red[:, ofs[0]:ofs[1]]                          # [N, 6]
    Hcc_pose = red[:, ofs[1]:ofs[2]].reshape(N, 6, 6)
    Hpc_img = red[:, ofs[2]:ofs[3]].reshape(N, 6, nparams)
    g_cam = torch.zeros(C, nparams, **f32).index_add_(
        0, icam, red[:, ofs[3]:ofs[4]])
    Hcc_cam = torch.zeros(C, nparams, nparams, **f32).index_add_(
        0, icam, red[:, ofs[4]:ofs[5]].reshape(N, nparams, nparams))
    d_pose_l = lam * torch.clamp(torch.diagonal(Hcc_pose, dim1=1, dim2=2),
                                 1e-6, 1e32)
    d_cam_l = lam * torch.clamp(torch.diagonal(Hcc_cam, dim1=1, dim2=2),
                                1e-6, 1e32)
    free, free_pose, free_cam_np = free_arrays

    # ---- assemble the reduced system in kernel coordinates ----
    bi = (torch.arange(N, device=dev)[:, None]
          + torch.arange(6, device=dev)[None, :] * Npad)      # [N, 6]
    ci = (6 * Npad + torch.arange(C, device=dev)[:, None]
          + torch.arange(nparams, device=dev)[None, :] * C)   # [C, np]
    cam_cols = ci[icam]                                       # [N, np]
    S = -s_corr
    S.index_put_((bi[:, :, None], bi[:, None, :]), Hcc_pose, accumulate=True)
    S.index_put_((ci[:, :, None], ci[:, None, :]), Hcc_cam, accumulate=True)
    S.index_put_((bi[:, :, None], cam_cols[:, None, :]), Hpc_img,
                 accumulate=True)
    S.index_put_((cam_cols[:, :, None], bi[:, None, :]),
                 Hpc_img.transpose(1, 2), accumulate=True)
    d_l = torch.zeros(Dk, **f32)
    d_l[bi.reshape(-1)] = d_pose_l.reshape(-1)
    d_l[ci.reshape(-1)] = d_cam_l.reshape(-1)
    S = S + torch.diag(d_l)
    g_u = torch.zeros(Dk, **f32)
    g_u[bi.reshape(-1)] = g_pose.reshape(-1)
    g_u[ci.reshape(-1)] = g_cam.reshape(-1)
    du = _solve_reduced(S, (-g_u + ey) * free, free, opt)
    u_pose = du[:6 * Npad].reshape(6, Npad).T[:N] * free_pose
    u_cam_np = (du[6 * Npad:6 * Npad + 12 * C].reshape(12, C).T[:, :nparams]
                * free_cam_np)

    # ---- back-substitute + predicted sums (per bucket) ----
    du_pose_t = torch.zeros(6, Npad, **f32)
    du_pose_t[:, :N] = u_pose.T
    du_cam_t = torch.zeros(12, C, **f32)
    du_cam_t[:nparams] = u_cam_np.T
    dp_list = []
    acc = torch.zeros(3, **f32)
    g_inf_pts = torch.zeros((), **f32)
    for static, lay, (pt_pay, jw) in zip(statics, lays, per_bucket):
        dp, acc_b = bk.backsub(static, du_pose_t, du_cam_t, pt_pay, jw, lam,
                               lay, opt)
        dp_list.append(dp)
        acc += acc_b
        g_inf_pts = torch.maximum(g_inf_pts, torch.max(torch.abs(pt_pay[:3])))
    t2, g_dp, d_dp2 = acc
    gTd = torch.sum(g_pose * u_pose) + torch.sum(g_cam * u_cam_np) + g_dp
    dHd = (t2 + torch.sum(d_pose_l * u_pose * u_pose)
           + torch.sum(d_cam_l * u_cam_np * u_cam_np) + d_dp2)
    predicted = -(gTd + 0.5 * dHd)
    g_inf = torch.maximum(
        torch.max(torch.abs(g_pose)),
        torch.maximum(torch.max(torch.abs(g_cam)), g_inf_pts))
    u_cam = torch.zeros(C, MAXP, **f32)
    u_cam[:, :nparams] = u_cam_np
    return u_pose, u_cam, dp_list, predicted, g_inf


def _fused_lm_loop(statics, lays, pts0, problem, options, free_arrays):
    """The LM loop (Python; one host sync per iteration for the stopping
    test, plus the PCG's convergence checks)."""
    opt = options
    lay0 = lays[0]
    image_cam = statics[0].image_cam

    def cost_of(q, t, pts_list, k):
        par = bk.pack_params(q, t, k, image_cam, lay0)
        return sum(bk.fused_cost(static, par, pts_b, lay, opt)
                   for static, lay, pts_b in zip(statics, lays, pts_list))

    q, t, k = problem.qvecs, problem.tvecs, problem.cam_params
    pts_t = pts0
    cost0 = cost_of(q, t, pts_t, k)
    cost = cost0
    lam = torch.full_like(cost0, 1.0 / opt.initial_trust_radius)
    nu = torch.full_like(cost0, 2.0)
    g_inf = torch.full_like(cost0, float("inf"))
    trace = torch.full((opt.max_iterations + 1,), float("nan"),
                       dtype=torch.float32, device=cost0.device)
    trace[0] = cost0
    it = 0
    while it < opt.max_iterations:
        u_pose, u_cam, dp_list, predicted, g_inf = _fused_step(
            statics, lays, opt, q, t, pts_t, k, lam, free_arrays)
        q2 = quat_retract(q, u_pose[:, :3])
        t2 = t + u_pose[:, 3:]
        pts2 = [p + dp for p, dp in zip(pts_t, dp_list)]
        k2 = k + u_cam
        new_cost = cost_of(q2, t2, pts2, k2)
        accept, actual, lam, nu = lm_update(lam, nu, cost, new_cost,
                                            predicted)
        q = torch.where(accept, q2, q)
        t = torch.where(accept, t2, t)
        pts_t = [torch.where(accept, p2, p) for p2, p in zip(pts2, pts_t)]
        k = torch.where(accept, k2, k)
        prev_cost = cost
        cost = torch.where(accept, new_cost, cost)
        dp2_sum = sum(torch.sum(dp ** 2) for dp in dp_list)
        pts2_sum = sum(torch.sum(p ** 2) for p in pts_t)
        step_norm = torch.sqrt(torch.sum(u_pose ** 2) + torch.sum(u_cam ** 2)
                               + dp2_sum)
        x_norm = torch.sqrt(torch.sum(t ** 2) + pts2_sum
                            + torch.sum(k ** 2)) + 1.0
        it += 1
        trace[it] = cost
        if bool(lm_done(opt, accept, actual, prev_cost, g_inf, lam,
                        step_norm, x_norm)):
            break
    summary = BASummary(
        initial_cost=cost0, final_cost=cost, num_iterations=it,
        num_residuals=torch.sum(problem.obs_mask).to(torch.int32),
        gradient_norm=g_inf, cost_trace=trace)
    return (q, t, pts_t, k), summary


def _pack_bucket_points(points, idxs, lays):
    """points [P,3] -> list of per-bucket padded [3, Pp_b] tensors."""
    dev = points.device
    return [bk.pack_points(points[torch.as_tensor(idx, device=dev)], lay)
            for idx, lay in zip(idxs, lays)]


def prepare(problem: BAProblem, options: BAOptions):
    """Host-side prep (track-length bucketing, static tables, gauge
    masks), separated from the solve so that repeated solves over one
    problem structure pay it once. Returns a context for
    `solve_prepared`."""
    dev = problem.points.device
    problem = BAProblem(*[
        None if v is None else (v.float() if v.is_floating_point() else v)
        for v in problem])
    if problem.image_cam is None:
        problem = problem._replace(
            image_cam=torch.as_tensor(_image_cam_of(problem), device=dev))
    host = problem_to_numpy(problem)
    derived = host["image_cam"].copy()
    derived[host["obs_image"]] = host["obs_cam"]
    if not np.array_equal(derived, host["image_cam"]):
        raise ValueError(
            "problem.image_cam is inconsistent with obs_image/obs_cam")
    buckets = _bucketize(host, options, dev)
    statics = tuple(b[0] for b in buckets)
    lays = tuple(b[1] for b in buckets)
    idxs = tuple(b[2] for b in buckets)
    pts0 = _pack_bucket_points(problem.points, idxs, lays)

    lay0 = lays[0]
    N, C, Npad, Dk = lay0.N, lay0.C, lay0.Npad, lay0.Dk
    nparams = lay0.nparams
    free_pose = np.concatenate(
        [np.repeat(host["free_rot"][:, None], 3, axis=1),
         host["free_trans"]], axis=1).astype(np.float32)
    if not options.refine_extrinsics:
        free_pose = free_pose * 0.0
    refine = bk.intrinsic_refine_mask(options)[:nparams]
    free_cam_np = (host["free_cam"][:, :nparams] * refine).astype(np.float32)
    free = np.zeros(Dk, np.float32)
    free[(np.arange(N)[:, None] + np.arange(6)[None, :] * Npad)
         .reshape(-1)] = free_pose.reshape(-1)
    free[(6 * Npad + np.arange(C)[:, None]
          + np.arange(nparams)[None, :] * C).reshape(-1)] = \
        free_cam_np.reshape(-1)
    free_arrays = tuple(torch.as_tensor(a, device=dev)
                        for a in (free, free_pose, free_cam_np))
    return (statics, lays, pts0, idxs, problem, options, free_arrays)


def unpack_bucket_points(pts_t, idxs, num_points):
    """Inverse of `_pack_bucket_points`: per-bucket [3, Pp_b] tensors ->
    points [P, 3] in the original order."""
    out = torch.empty(num_points, 3, dtype=pts_t[0].dtype,
                      device=pts_t[0].device)
    for pts_b, idx in zip(pts_t, idxs):
        out[torch.as_tensor(idx, device=out.device)] = pts_b[:, :len(idx)].T
    return out


def solve_prepared(ctx):
    """Run the LM loop on a prepared context."""
    (statics, lays, pts0, idxs, problem, options, free_arrays) = ctx
    (q, t, pts_t, k), summary = _fused_lm_loop(
        statics, lays, pts0, problem, options, free_arrays)
    pts_out = unpack_bucket_points(pts_t, idxs, problem.points.shape[0])
    out = problem._replace(qvecs=q, tvecs=t, points=pts_out, cam_params=k)
    return out, summary


def bundle_adjust_fused(problem: BAProblem, options: BAOptions):
    """Solve with the fused kernel path (COO or point-major input)."""
    return solve_prepared(prepare(problem, options))
