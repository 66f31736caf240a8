"""Fused-kernel bundle adjustment: the single-device fast path.

Port of ``sba_tpu/optim/ba_fused.py``. It drives the kernels of
ops/ba_kernels.py inside the LM trust-region loop of optim/ba.py. Per LM
iteration and per track-length bucket, on the dense path (up to
DENSE_MAX_IMAGES images):

  K1 `fused_schur`  -> per-image/point payloads, Schur correction
                       S_corr = EL EL^T, RHS coupling Ey, stored blocks
  epilogue (plain torch) -> assemble the reduced system S, damping, gauge
                       masks, Jacobi-PCG solve for du (`_solve_reduced`,
                       `_pcg`)
  K4 `backsub`      -> point step dp + predicted-reduction sums
  K5 `fused_cost`   -> trial cost for accept/reject

and on the implicit path (more images, or a ranged layout), where S is
never formed:

  K2 `fused_reduce` -> the payloads plus Ey and the Jacobi blocks of
                       EL EL^T per image, and the coupling store jcorr
  epilogue (plain torch) -> PCG over the (pose, camera) blocks
                       (`_pcg`) whose matvec runs
                       K3 `schur_matvec` (EL (EL^T p) from jcorr) once
                       per bucket per CG iteration
  K4, K5            -> as above

On CUDA tensors the kernels are the hand-written CUDA ones; on CPU
tensors their plain twins.

With `axis_name`, the point blocks are sharded over the ranks of that
axis (parallel/ba_fused_spmd.py): each rank runs the kernels on its own
blocks, and all-reduces make the replicated epilogue see the global
system, where sba_tpu psums: the image payload, S_corr and Ey once per
LM iteration, K3's correction once per CG iteration, the step sums (and
the max of the point gradient), the cost and the point norms.
"""

from __future__ import annotations

import numpy as np
import torch

from sba_tpu_torch.geometry.quaternions import quat_retract
from sba_tpu_torch.ops import ba_kernels as bk
from sba_tpu_torch.ops.segment import segment_sum, segment_table
from sba_tpu_torch.optim.ba import (
    MAXP, BAOptions, BAProblem, BASummary, _image_cam_of,
    lm_done, lm_update, problem_to_numpy,
)
from sba_tpu_torch.parallel import group

DENSE_MAX_IMAGES = 128   # auto-policy crossover to the implicit path
TP = 128                 # points per kernel block
MAX_BUCKETS = 3          # track-length buckets


def use_implicit(lay, options: BAOptions) -> bool:
    if lay.ranged:
        return True   # as the reference: its dense kernel is not ranged
    if options.fused_mode == "dense":
        return False
    if options.fused_mode == "implicit":
        return True
    return lay.N > DENSE_MAX_IMAGES


def can_use_fused(problem: BAProblem, options: BAOptions) -> bool:
    """The problem's tensors are float32 on CUDA (the kernels carry a
    head for every camera model; `bk.CUDA_MODELS`)."""
    return problem.points.is_cuda and problem.points.dtype == torch.float32


def _pcg(matvec, b, prec, opt: BAOptions, x0=None):
    """Preconditioned CG on a tuple of blocks: `matvec` and `prec` map a
    tuple like `b` to another.

    Same stopping rule as the reference's while loop (at most
    opt.cg_iterations matvecs, relative residual opt.cg_tolerance). The
    updates are masked once converged, so the device runs a fixed trip
    count and the host checks for convergence every 8 iterations only.
    `x0` warm-starts from the previous LM step (opt.cg_warm_start): the
    seed is rescaled optimally against this system and its matvec
    counts against opt.cg_iterations.
    """
    def dot(u, v):
        d = [torch.dot(ui.reshape(-1), vi.reshape(-1))
             for ui, vi in zip(u, v)]
        return sum(d[1:], d[0])

    def where(c, u, v):
        return tuple(torch.where(c, ui, vi) for ui, vi in zip(u, v))

    thresh = (opt.cg_tolerance ** 2) * torch.clamp(dot(b, b), min=1e-30)
    x, r, i0 = tuple(torch.zeros_like(bi) for bi in b), b, 0
    if x0 is not None:
        # The optimally scaled seed s x0 (s minimizes ||b - s A x0||) makes
        # ||r0|| <= ||b||; a non-finite s (a rejected NaN step, or A x0
        # overflowing) falls back to the cold start.
        A0 = matvec(x0)
        s = dot(b, A0) / torch.clamp(dot(A0, A0), min=1e-30)
        ok = torch.isfinite(s)
        x = where(ok, tuple(s * v for v in x0), x)
        r = where(ok, tuple(bi - s * ai for bi, ai in zip(b, A0)), b)
        i0 = 1
    p = prec(r)
    rz = dot(r, p)
    for i in range(i0, opt.cg_iterations):
        active = dot(r, r) > thresh
        if (i - i0) % 8 == 0 and not bool(active):
            break
        Ap = matvec(p)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
        x = where(active, tuple(xi + alpha * pi for xi, pi in zip(x, p)), x)
        r_new = tuple(ri - alpha * ai for ri, ai in zip(r, Ap))
        z = prec(r_new)
        rz_new = dot(r_new, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = where(active, tuple(zi + beta * pi for zi, pi in zip(z, p)), p)
        r = where(active, r_new, r)
        rz = torch.where(active, rz_new, rz)
    return x


def _solve_reduced(S, b, free, opt: BAOptions, x0=None):
    """Jacobi-preconditioned CG on the masked dense reduced system S;
    frozen coordinates become identity rows and columns."""
    S = S * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    d = torch.diagonal(S)
    dinv = 1.0 / torch.where(torch.abs(d) > 1e-30, d, torch.ones_like(d))
    x, = _pcg(lambda v: (S @ v[0],), (b * free,), lambda r: (dinv * r[0],),
              opt, x0=None if x0 is None else (x0 * free,))
    return x * free


def _bucketize(problem: dict, options: BAOptions, device,
               block_multiple: int = 1):
    """Partition points into track-length buckets (host side, numpy).

    Returns [(static, lay, idx)] with idx the bucket's original point
    indices; the bucket's padded points are columns [0, len(idx)) of
    its [3, lay.Pp] array. `block_multiple` pads each bucket's block
    count so that the blocks divide evenly over the ranks of an SPMD
    solve.
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
        lay = bk.plan_layout(sub, options, TP, block_multiple)
        static = bk.build_static(sub, options, lay, device)
        buckets.append((static, lay, idx))
    return buckets


def _fused_step(statics, lays, opt, qvecs, tvecs, pts_list, cams, lam,
                free_arrays, warm=None, axis_name=None):
    """One linearize + solve over all buckets. Returns (u_pose [N,6],
    u_cam [C,12], dp_list (per-bucket [3, Pp]), predicted, g_inf).
    `warm = (u_pose [N,6], u_cam [C,np])` seeds the reduced solve. With
    `axis_name`, the buckets hold this rank's point blocks."""
    lay0 = lays[0]
    N, C, Npad, Dk = lay0.N, lay0.C, lay0.Npad, lay0.Dk
    nparams = lay0.nparams
    image_cam = statics[0].image_cam
    implicit = use_implicit(lay0, opt)
    dev = qvecs.device
    f32 = dict(dtype=torch.float32, device=dev)

    par = bk.pack_params(qvecs, tvecs, cams, image_cam, lay0)
    per_bucket = []
    if implicit:
        img_red = torch.zeros(Npad, lay0.DI_implicit, **f32)
        for static, lay, pts_b in zip(statics, lays, pts_list):
            i_b, pt_pay, jw, jcorr = bk.fused_reduce(static, par, pts_b, lam,
                                                     lay, opt)
            img_red += i_b
            per_bucket.append((pt_pay, jw, jcorr))
    else:
        s_corr = torch.zeros(Dk, Dk, **f32)
        img_red = torch.zeros(Npad, lay0.DI, **f32)
        ey = torch.zeros(Dk, **f32)
        for static, lay, pts_b in zip(statics, lays, pts_list):
            s_b, i_b, e_b, pt_pay, jw = bk.fused_schur(static, par, pts_b,
                                                       lam, lay, opt)
            s_corr += s_b
            img_red += i_b
            ey += e_b
            per_bucket.append((pt_pay, jw, None))
        s_corr = group.all_reduce(s_corr, axis_name)
        ey = group.all_reduce(ey, axis_name)
    img_red = group.all_reduce(img_red, axis_name)

    # ---- unpack the image payload ----
    ofs = np.cumsum([0, 6, 36, 6 * nparams, nparams, nparams * nparams])
    red = img_red[:N]
    icam = image_cam[:N].long()
    cam_tab = segment_table(icam, C)

    def cam_sum(v):
        # Rows keyed by image -> by camera, in a fixed order: every rank
        # sums the same replicated rows and must get the same bits (the
        # PCG's and the LM loop's tests read them).
        return segment_sum(v, cam_tab)

    g_pose = red[:, ofs[0]:ofs[1]]                          # [N, 6]
    Hcc_pose = red[:, ofs[1]:ofs[2]].reshape(N, 6, 6)
    Hpc_img = red[:, ofs[2]:ofs[3]].reshape(N, 6, nparams)
    g_cam = cam_sum(red[:, ofs[3]:ofs[4]])
    Hcc_cam = cam_sum(red[:, ofs[4]:ofs[5]].reshape(N, nparams, nparams))
    d_pose_l = lam * torch.clamp(torch.diagonal(Hcc_pose, dim1=1, dim2=2),
                                 1e-6, 1e32)
    d_cam_l = lam * torch.clamp(torch.diagonal(Hcc_cam, dim1=1, dim2=2),
                                1e-6, 1e32)
    free, free_pose, free_cam_np = free_arrays

    if implicit:
        # ---- implicit reduced solve: PCG whose matvec runs K3 ----
        # S v = (H + D_lam) v - EL (EL^T v); EL is never formed.
        o = ofs[5]
        ey_pose = red[:, o:o + 6]                           # [N, 6]
        ey_cam = cam_sum(red[:, o + 6:o + 6 + nparams])     # [C, np]
        o += 6 + nparams
        if lay0.BJ:
            # The 6x6 pose block of EL EL^T (upper triangle) for
            # block-Jacobi PCG.
            iu, ju = np.triu_indices(6)
            corr6 = torch.zeros(N, 6, 6, **f32)
            corr6[:, iu, ju] = red[:, o:o + 21]
            corr6[:, ju, iu] = red[:, o:o + 21]
            o += 21
        else:
            dcorr_pose = red[:, o:o + 6]
            o += 6
        dcorr_cam = cam_sum(red[:, o:o + nparams])
        vp_t = torch.zeros(6, Npad, **f32)     # K3's input layout
        vc_t = torch.zeros(12, C, **f32)

        def matvec(v):
            vp, vc = v
            vp = vp * free_pose
            vc = vc * free_cam_np
            hp = (torch.einsum("nij,nj->ni", Hcc_pose, vp)
                  + torch.einsum("nip,np->ni", Hpc_img, vc[icam])
                  + d_pose_l * vp)
            hc = (cam_sum(torch.einsum("nip,ni->np", Hpc_img, vp))
                  + torch.einsum("cpq,cq->cp", Hcc_cam, vc)
                  + d_cam_l * vc)
            vp_t[:, :N] = vp.T
            vc_t[:nparams] = vc.T
            corr = group.all_reduce(
                sum(bk.schur_matvec(static, vp_t, vc_t, jcorr, lay, opt)
                    for static, lay, (_, _, jcorr)
                    in zip(statics, lays, per_bucket)), axis_name)
            hp = hp - corr[:N, :6]
            hc = hc - cam_sum(corr[:N, 6:6 + nparams])
            # gauge: identity on frozen coordinates
            hp = hp * free_pose + (1.0 - free_pose) * vp
            hc = hc * free_cam_np + (1.0 - free_cam_np) * vc
            return hp, hc

        b_pose = (-g_pose + ey_pose) * free_pose
        b_cam = (-g_cam + ey_cam) * free_cam_np
        diag_c = ((torch.diagonal(Hcc_cam, dim1=1, dim2=2) + d_cam_l
                   - dcorr_cam) * free_cam_np + (1.0 - free_cam_np))
        if lay0.BJ:
            # Exact 6x6 diagonal blocks of the damped reduced system;
            # frozen coordinates become identity rows and columns.
            eye6 = torch.eye(6, **f32)[None]
            F = free_pose
            M = Hcc_pose - corr6 + eye6 * d_pose_l[:, None, :]
            M = (M * F[:, :, None] * F[:, None, :]
                 + eye6 * (1.0 - F)[:, :, None])
            Minv = torch.linalg.inv(M)

            def prec_p(r):
                return torch.einsum("nij,nj->ni", Minv, r)
        else:
            diag_p = ((torch.diagonal(Hcc_pose, dim1=1, dim2=2) + d_pose_l
                       - dcorr_pose) * free_pose + (1.0 - free_pose))
            dinv_p = 1.0 / torch.where(diag_p > 1e-20, diag_p,
                                       torch.ones_like(diag_p))

            def prec_p(r):
                return dinv_p * r
        dinv_c = 1.0 / torch.where(diag_c > 1e-20, diag_c,
                                   torch.ones_like(diag_c))
        x0 = None if warm is None else (warm[0] * free_pose,
                                        warm[1] * free_cam_np)
        u_pose, u_cam_np = _pcg(matvec, (b_pose, b_cam),
                                lambda r: (prec_p(r[0]), dinv_c * r[1]), opt,
                                x0=x0)
        u_pose = u_pose * free_pose
        u_cam_np = u_cam_np * free_cam_np
    else:
        # ---- assemble the reduced system in kernel coordinates ----
        bi = (torch.arange(N, device=dev)[:, None]
              + torch.arange(6, device=dev)[None, :] * Npad)    # [N, 6]
        ci = (6 * Npad + torch.arange(C, device=dev)[:, None]
              + torch.arange(nparams, device=dev)[None, :] * C)  # [C, np]
        cam_cols = ci[icam]                                     # [N, np]
        S = -s_corr
        S.index_put_((bi[:, :, None], bi[:, None, :]), Hcc_pose,
                     accumulate=True)
        S.index_put_((ci[:, :, None], ci[:, None, :]), Hcc_cam,
                     accumulate=True)
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
        x0 = None
        if warm is not None:
            x0 = torch.zeros(Dk, **f32)
            x0[bi.reshape(-1)] = (warm[0] * free_pose).reshape(-1)
            x0[ci.reshape(-1)] = (warm[1] * free_cam_np).reshape(-1)
        du = _solve_reduced(S, (-g_u + ey) * free, free, opt, x0=x0)
        u_pose = du[:6 * Npad].reshape(6, Npad).T[:N] * free_pose
        u_cam_np = (du[6 * Npad:6 * Npad + 12 * C].reshape(12, C).T
                    [:, :nparams] * free_cam_np)

    # ---- back-substitute + predicted sums (per bucket) ----
    du_pose_t = torch.zeros(6, Npad, **f32)
    du_pose_t[:, :N] = u_pose.T
    du_cam_t = torch.zeros(12, C, **f32)
    du_cam_t[:nparams] = u_cam_np.T
    dp_list = []
    acc = torch.zeros(3, **f32)
    g_inf_pts = torch.zeros((), **f32)
    for static, lay, (pt_pay, jw, _) in zip(statics, lays, per_bucket):
        dp, acc_b = bk.backsub(static, du_pose_t, du_cam_t, pt_pay, jw, lam,
                               lay, opt)
        dp_list.append(dp)
        acc += acc_b
        g_inf_pts = torch.maximum(g_inf_pts, torch.max(torch.abs(pt_pay[:3])))
    t2, g_dp, d_dp2 = group.all_reduce(acc, axis_name)
    g_inf_pts = group.all_reduce(g_inf_pts, axis_name, "max")
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


def _fused_lm_loop(statics, lays, pts0, problem, options, free_arrays,
                   axis_name=None):
    """The LM loop (Python; one host sync per iteration for the stopping
    test, plus the PCG's convergence checks). With `axis_name`, `statics`,
    `lays` and `pts0` are this rank's blocks and every test reads
    all-reduced values, so that all ranks stop at the same iteration."""
    opt = options
    lay0 = lays[0]
    image_cam = statics[0].image_cam

    def cost_of(q, t, pts_list, k):
        par = bk.pack_params(q, t, k, image_cam, lay0)
        return group.all_reduce(
            bk.fused_cost_buckets(statics, par, pts_list, lays, opt),
            axis_name)

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
    warm = None
    while it < opt.max_iterations:
        u_pose, u_cam, dp_list, predicted, g_inf = _fused_step(
            statics, lays, opt, q, t, pts_t, k, lam, free_arrays, warm=warm,
            axis_name=axis_name)
        if opt.cg_warm_start:
            # Seed of the next reduced solve; it is rescaled against the
            # next damped system, so accept or reject needs no fix-up.
            warm = (u_pose, u_cam[:, :lay0.nparams])
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
        dp2_sum, pts2_sum = group.all_reduce(torch.stack([
            sum(torch.sum(dp ** 2) for dp in dp_list),
            sum(torch.sum(p ** 2) for p in pts_t)]), axis_name)
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


def with_schur_tiles(statics, lays, options: BAOptions):
    """`statics` with K1's Schur work list (fixed for the solve, built
    on the card) where the dense path runs on CUDA."""
    if statics[0].obs_img.is_cuda and not use_implicit(lays[0], options):
        statics = tuple(st._replace(tiles=bk.build_schur_tiles(st, lay))
                        for st, lay in zip(statics, lays))
    return statics


def prepare(problem: BAProblem, options: BAOptions, block_multiple: int = 1,
            tiles: bool = True):
    """Host-side prep (track-length bucketing, static tables, gauge
    masks), separated from the solve so that repeated solves over one
    problem structure pay it once. Returns a context for
    `solve_prepared`. `block_multiple` pads every bucket's blocks to a
    multiple of it; `tiles=False` leaves K1's work list unbuilt (an SPMD
    solve builds it per rank)."""
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
    buckets = _bucketize(host, options, dev, block_multiple)
    statics = tuple(b[0] for b in buckets)
    lays = tuple(b[1] for b in buckets)
    if tiles:
        statics = with_schur_tiles(statics, lays, options)
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
