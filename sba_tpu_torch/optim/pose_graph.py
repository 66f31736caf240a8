"""Pose-graph optimization (SE(3) / Sim(3)): batched Levenberg-Marquardt.

Port of the single-device part of ``sba_tpu/optim/pose_graph.py``. The
reference has no pose-graph module; this relaxes drifted trajectories
and the hierarchical mapper's merged models before a global BA.

- All E edge residuals are evaluated at once. The [E, D, D] Jacobians
  of both endpoints come from one forward-mode pass (``torch.func.jvp``
  vmapped over the 2D one-hot tangents), as sba_tpu's ``jax.jacfwd``.
- The normal equations are never formed: each LM step solves
  (J^T J + lam diag(J^T J)) dx = -J^T r by PCG whose matvec is gather,
  per-edge products, scatter-add, with the block diagonal of J^T J as
  preconditioner (batched D x D Cholesky).
- The PCG and LM loops stop at the first iteration under tolerance, as
  sba_tpu's ``lax.while_loop``s do: the host reads each loop's test
  before every iteration (one sync per PCG iteration), so no iteration
  runs past sba_tpu's last.

Conventions: poses are world->camera ``(qvec wxyz, tvec)``; an edge
(i, j) holds the measured ``T_ij = T_j o T_i^{-1}``; the residual is the
log error ``[log_rot, t, (log s)]`` of ``T_meas^{-1} o (T_j o T_i^{-1})``
whitened by the edge's square-root information. Edges sharded over
devices (sba_tpu's ``shard_edges``, ``distributed_optimize_pose_graph``)
come with the multi-GPU slice: ``PoseGraphOptions.axis_name`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from sba_tpu_torch.geometry.quaternions import (quat_conjugate,
                                                quat_multiply,
                                                quat_normalize, quat_retract,
                                                quat_rotate,
                                                quat_to_angle_axis)
from sba_tpu_torch.optim.losses import loss_value, loss_weight

class PoseGraphProblem(NamedTuple):
    """Static-shape pose graph on one device; edges may be padded
    (mask 0) to power-of-two counts."""

    qvecs: torch.Tensor        # [N, 4] world->cam rotations (wxyz)
    tvecs: torch.Tensor        # [N, 3]
    log_scales: torch.Tensor   # [N] per-pose log scale (Sim3); zeros SE3
    edge_i: torch.Tensor       # [E] int64 source pose index
    edge_j: torch.Tensor       # [E] int64 target pose index
    rel_q: torch.Tensor        # [E, 4] measured q_ij (wxyz)
    rel_t: torch.Tensor        # [E, 3] measured t_ij
    rel_log_s: torch.Tensor    # [E] measured log scale (Sim3; zeros SE3)
    sqrt_info: torch.Tensor    # [E, D, D] square-root information
    edge_mask: torch.Tensor    # [E] 1.0 valid / 0.0 padding
    pose_fixed: torch.Tensor   # [N] 1.0 = held constant (gauge)


@dataclasses.dataclass(frozen=True)
class PoseGraphOptions:
    max_iterations: int = 50
    sim3: bool = False                  # optimize per-pose scale too
    loss: str = "trivial"               # trivial|huber|cauchy|soft_l1
    loss_scale: float = 1.0
    cg_iterations: int = 50
    cg_tolerance: float = 1e-6
    initial_trust_radius: float = 1e4
    function_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-10
    # Mesh axis the edges shard over: the multi-GPU slice.
    axis_name: Optional[str] = None


class PoseGraphSummary(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_iterations: int
    num_residuals: torch.Tensor
    gradient_norm: torch.Tensor
    cost_trace: torch.Tensor
    # PCG iterations of each LM iteration, on the host (the port's
    # addition).
    cg_iterations: torch.Tensor


def make_problem(qvecs, tvecs, edge_i, edge_j, rel_q, rel_t,
                 sqrt_info=None, edge_mask=None, pose_fixed=None,
                 log_scales=None, rel_log_s=None, sim3=False,
                 dtype=torch.float32, device="cuda") -> PoseGraphProblem:
    """A PoseGraphProblem on `device` with sba_tpu's defaults: identity
    information, first pose fixed, SE3 scales at zero. Float inputs are
    rounded to `dtype` once, from float64."""
    def f(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return torch.as_tensor(np.array(a, np.float64)).to(
            dtype=dtype, device=device)

    def i(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    qvecs = f(qvecs)
    n = qvecs.shape[0]
    edge_i, edge_j = i(edge_i), i(edge_j)
    e = edge_i.shape[0]
    d = 7 if sim3 else 6
    if sqrt_info is None:
        sqrt_info = np.broadcast_to(np.eye(d), (e, d, d))
    else:
        sqrt_info = np.asarray(
            sqrt_info.detach().cpu().numpy()
            if isinstance(sqrt_info, torch.Tensor) else sqrt_info,
            np.float64)
        if sqrt_info.ndim == 2:
            sqrt_info = np.broadcast_to(sqrt_info[None], (e, d, d))
    if edge_mask is None:
        edge_mask = np.ones(e)
    if pose_fixed is None:
        pose_fixed = np.zeros(n)
        pose_fixed[0] = 1.0
    if log_scales is None:
        log_scales = np.zeros(n)
    if rel_log_s is None:
        rel_log_s = np.zeros(e)
    return PoseGraphProblem(
        qvecs=qvecs, tvecs=f(tvecs), log_scales=f(log_scales),
        edge_i=edge_i, edge_j=edge_j, rel_q=f(rel_q), rel_t=f(rel_t),
        rel_log_s=f(rel_log_s), sqrt_info=f(np.ascontiguousarray(sqrt_info)),
        edge_mask=f(edge_mask), pose_fixed=f(pose_fixed))


def relative_pose(qi, ti, qj, tj, si=None, sj=None):
    """T_ij = T_j o T_i^{-1}: maps camera_i coords to camera_j coords.
    With Sim3 scales s (x_cam = s R x_world + t): s_ij = s_j / s_i,
    R_ij = R_j R_i^T, t_ij = t_j - s_ij R_ij t_i."""
    q_ij = quat_multiply(quat_normalize(qj),
                         quat_conjugate(quat_normalize(qi)))
    if si is None:
        return q_ij, tj - quat_rotate(q_ij, ti)
    s_ij = sj / si
    return q_ij, tj - s_ij[..., None] * quat_rotate(q_ij, ti), s_ij


def _edge_residual(delta_i, delta_j, qi0, ti0, li0, qj0, tj0, lj0,
                   rq, rt, rls, sqrt_info, sim3):
    """Whitened residuals [E, D] of the edges as a function of their
    endpoints' tangent updates delta [E, D] = (omega, dt, (dlog_s))."""
    qi = quat_retract(qi0, delta_i[..., :3])
    ti = ti0 + delta_i[..., 3:6]
    qj = quat_retract(qj0, delta_j[..., :3])
    tj = tj0 + delta_j[..., 3:6]
    mq_inv = quat_conjugate(quat_normalize(rq))
    if sim3:
        si = torch.exp(li0 + delta_i[..., 6])
        sj = torch.exp(lj0 + delta_j[..., 6])
        q_ij, t_ij, s_ij = relative_pose(qi, ti, qj, tj, si, sj)
        s_m = torch.exp(rls)
        q_err = quat_multiply(mq_inv, q_ij)
        t_err = quat_rotate(mq_inv, t_ij - rt) / s_m[..., None]
        r = torch.cat([quat_to_angle_axis(q_err), t_err,
                       torch.log(s_ij / s_m)[..., None]], -1)
    else:
        q_ij, t_ij = relative_pose(qi, ti, qj, tj)
        q_err = quat_multiply(mq_inv, q_ij)
        t_err = quat_rotate(mq_inv, t_ij - rt)
        r = torch.cat([quat_to_angle_axis(q_err), t_err], -1)
    return torch.einsum("eij,ej->ei", sqrt_info, r)


def _edge_args(problem: PoseGraphProblem):
    ei, ej = problem.edge_i, problem.edge_j
    return (problem.qvecs[ei], problem.tvecs[ei], problem.log_scales[ei],
            problem.qvecs[ej], problem.tvecs[ej], problem.log_scales[ej],
            problem.rel_q, problem.rel_t, problem.rel_log_s,
            problem.sqrt_info)


def _linearize(problem: PoseGraphProblem, opt: PoseGraphOptions):
    """Residuals r [E, D] and Jacobians Ji, Jj [E, D, D] with respect to
    the endpoint tangents, robust-weighted (IRLS), masked, gauge-fixed."""
    d = 7 if opt.sim3 else 6
    args = _edge_args(problem)
    e = problem.edge_i.shape[0]
    zeros = problem.qvecs.new_zeros((e, d))

    def f(di, dj):
        return _edge_residual(di, dj, *args, opt.sim3)

    r = f(zeros, zeros)
    eye = torch.eye(2 * d, dtype=zeros.dtype, device=zeros.device)
    ti = eye[:, None, :d].expand(2 * d, e, d)
    tj = eye[:, None, d:].expand(2 * d, e, d)
    J = torch.func.vmap(
        lambda a, b: torch.func.jvp(f, (zeros, zeros), (a, b))[1])(ti, tj)
    J = J.permute(1, 2, 0)                              # [E, D, 2D]
    Ji, Jj = J[..., :d], J[..., d:]

    # IRLS weight sqrt(rho'(s)); padded edges by `where` (their Jacobians
    # may be NaN at a degenerate measurement).
    valid = problem.edge_mask > 0
    s = torch.sum(r * r, dim=-1)
    w = torch.sqrt(loss_weight(opt.loss, s, opt.loss_scale))
    w = torch.where(valid, w * problem.edge_mask, torch.zeros_like(w))
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    r = torch.where(valid[:, None], r * w[:, None], zero)
    Ji = torch.where(valid[:, None, None], Ji * w[:, None, None], zero)
    Jj = torch.where(valid[:, None, None], Jj * w[:, None, None], zero)
    free = 1.0 - problem.pose_fixed
    Ji = Ji * free[problem.edge_i][:, None, None]
    Jj = Jj * free[problem.edge_j][:, None, None]
    return r, Ji, Jj


def _cost(problem: PoseGraphProblem, opt: PoseGraphOptions):
    d = 7 if opt.sim3 else 6
    zeros = problem.qvecs.new_zeros((problem.edge_i.shape[0], d))
    r = _edge_residual(zeros, zeros, *_edge_args(problem), opt.sim3)
    valid = problem.edge_mask > 0
    s = torch.where(valid, torch.sum(r * r, dim=-1), torch.zeros_like(r[:, 0]))
    return 0.5 * torch.sum(loss_value(opt.loss, s, opt.loss_scale)
                           * problem.edge_mask)


def _segsum(x, idx, n):
    return x.new_zeros((n,) + x.shape[1:]).index_add_(0, idx, x)


def _solve_step(problem: PoseGraphProblem, opt: PoseGraphOptions, lam):
    """One LM step: PCG on (J^T J + lam diag(J^T J)) dx = -J^T r with a
    block-Jacobi preconditioner. Returns dx [N, D], the predicted
    reduction, the gradient's inf-norm and the PCG's iteration count."""
    n = problem.qvecs.shape[0]
    d = 7 if opt.sim3 else 6
    r, Ji, Jj = _linearize(problem, opt)
    ei, ej = problem.edge_i, problem.edge_j

    g = _segsum(torch.einsum("edk,ed->ek", Ji, r), ei, n) + \
        _segsum(torch.einsum("edk,ed->ek", Jj, r), ej, n)
    g_inf = torch.max(torch.abs(g))

    Hii = _segsum(torch.einsum("edk,edl->ekl", Ji, Ji), ei, n) + \
        _segsum(torch.einsum("edk,edl->ekl", Jj, Jj), ej, n)
    diag = torch.diagonal(Hii, dim1=-2, dim2=-1)            # [N, D]
    damp = lam * torch.clamp(diag, min=1e-12)
    eye = torch.eye(d, dtype=r.dtype, device=r.device)
    Hii_d = Hii + torch.diag_embed(damp)
    # Fixed and unconnected poses (all-zero blocks) solve against I.
    deg = torch.sum(torch.abs(diag), dim=-1) > 0
    Hii_safe = torch.where(deg[:, None, None], Hii_d, eye)
    L = torch.linalg.cholesky_ex(Hii_safe).L
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    Hinv = torch.einsum("nkm,nkl->nml", Linv, Linv)
    Hinv = torch.where(deg[:, None, None], Hinv, torch.zeros_like(Hinv))

    def matvec(u):
        ju = torch.einsum("edk,ek->ed", Ji, u[ei]) + \
            torch.einsum("edk,ek->ed", Jj, u[ej])
        out = _segsum(torch.einsum("edk,ed->ek", Ji, ju), ei, n) + \
            _segsum(torch.einsum("edk,ed->ek", Jj, ju), ej, n)
        return out + damp * u

    def precond(u):
        return torch.einsum("nkl,nl->nk", Hinv, u)

    dx, cg_it = _pcg(matvec, precond, -g, opt.cg_iterations,
                     opt.cg_tolerance)
    # Gauss-Newton model reduction: -g^T dx - 0.5 dx^T (J^T J) dx.
    predicted = -torch.sum(g * dx) - 0.5 * torch.sum(
        dx * (matvec(dx) - damp * dx))
    return dx, predicted, g_inf, cg_it


def _pcg(matvec, precond, b, iters, tol):
    """sba_tpu's PCG loop: iterate while it < iters and
    ||r|| > tol ||b||, the test read on the host before every iteration.
    Returns (x, iterations)."""
    def dot(a, c):
        return torch.sum(a * c)

    thr = tol * torch.sqrt(dot(b, b))
    x = torch.zeros_like(b)
    rr = b
    z = precond(b)
    p = z
    rz = dot(b, z)
    it = 0
    while it < iters and bool(torch.sqrt(dot(rr, rr)) > thr):
        hp = matvec(p)
        alpha = rz / torch.clamp(dot(p, hp), min=1e-30)
        x = x + alpha * p
        rr = rr - alpha * hp
        z = precond(rr)
        rz2 = dot(rr, z)
        beta = rz2 / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz2
        it += 1
    return x, it


def _apply(problem: PoseGraphProblem, dx, sim3):
    dx = dx * (1.0 - problem.pose_fixed)[:, None]
    q = quat_retract(problem.qvecs, dx[:, :3])
    t = problem.tvecs + dx[:, 3:6]
    ls = problem.log_scales + dx[:, 6] if sim3 else problem.log_scales
    return problem._replace(qvecs=q, tvecs=t, log_scales=ls)


def optimize_pose_graph(problem: PoseGraphProblem,
                        options: Optional[PoseGraphOptions] = None):
    """The LM loop on the problem's device. Returns (problem', summary)."""
    opt = options or PoseGraphOptions()
    if opt.axis_name is not None:
        raise NotImplementedError(
            "PoseGraphOptions.axis_name: edges sharded over devices come "
            "with the multi-GPU slice of the port")
    cost0 = _cost(problem, opt)
    max_it = opt.max_iterations
    trace = torch.full((max_it + 1,), float("nan"), dtype=cost0.dtype,
                       device=cost0.device)
    trace[0] = cost0
    cg_counts = torch.zeros(max_it, dtype=torch.int64)
    lam = torch.full_like(cost0, 1.0 / opt.initial_trust_radius)
    nu = torch.full_like(cost0, 2.0)
    cost = cost0
    g_inf = torch.full_like(cost0, float("inf"))
    prob = problem
    it = 0
    while it < max_it:
        dx, predicted, g_inf, cg_it = _solve_step(prob, opt, lam)
        prob2 = _apply(prob, dx, opt.sim3)
        new_cost = _cost(prob2, opt)
        actual = cost - new_cost
        rho = actual / torch.clamp(predicted, min=1e-30)
        accept = (actual > 0) & (predicted > 0)
        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                    min=1.0 / 3.0)
        lam = torch.where(accept, torch.clamp(lam_acc, min=1e-14),
                          torch.clamp(lam * nu, max=1e10))
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        prob = prob._replace(
            qvecs=torch.where(accept, prob2.qvecs, prob.qvecs),
            tvecs=torch.where(accept, prob2.tvecs, prob.tvecs),
            log_scales=torch.where(accept, prob2.log_scales,
                                   prob.log_scales))
        prev_cost = cost
        cost = torch.where(accept, new_cost, cost)
        step_norm = torch.sqrt(torch.sum(dx ** 2))
        done = ((accept & (torch.abs(actual) < opt.function_tolerance
                           * torch.clamp(prev_cost, min=1e-30)))
                | (g_inf < opt.gradient_tolerance)
                | (accept & (step_norm < opt.parameter_tolerance))
                | (lam >= 1e10))
        cg_counts[it] = cg_it
        it += 1
        trace[it] = cost
        if bool(done):
            break
    summary = PoseGraphSummary(
        initial_cost=cost0, final_cost=cost, num_iterations=it,
        num_residuals=torch.sum(problem.edge_mask).to(torch.int32),
        gradient_norm=g_inf, cost_trace=trace, cg_iterations=cg_counts)
    return prob, summary


# ---------------------------------------------------------------------------
# Graph construction
# ---------------------------------------------------------------------------

def covisible_pairs(tracks, num_ids: int):
    """Every pair of positions (a < b) within each track, counted.

    tracks: a list of int arrays of ids in [0, num_ids) (-1: skipped).
    Returns (i, j, count) for the distinct pairs i < j, in the order of
    their first appearance when the tracks are walked in order, each
    over a < b in order (the insertion order of sba_tpu's ``Counter``).
    Pairs of a track's id with itself are skipped."""
    lens_all = np.array([len(t) for t in tracks], np.int64)
    flat = (np.concatenate(tracks).astype(np.int64) if len(tracks)
            else np.zeros(0, np.int64))
    keep = flat >= 0
    owner = np.repeat(np.arange(len(tracks)), lens_all)[keep]
    flat = flat[keep]
    lens = np.bincount(owner, minlength=len(tracks))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    npairs = lens * (lens - 1) // 2
    pair_start = np.concatenate([[0], np.cumsum(npairs)[:-1]])
    keys, order = [], []
    for L in np.unique(lens[lens >= 2]):
        pts = np.nonzero(lens == L)[0]
        M = flat[starts[pts][:, None] + np.arange(L)[None, :]]
        a, b = np.triu_indices(L, 1)
        i, j = M[:, a], M[:, b]
        lo, hi = np.minimum(i, j), np.maximum(i, j)
        pos = pair_start[pts][:, None] + np.arange(len(a))[None, :]
        ok = lo != hi
        keys.append((lo * num_ids + hi)[ok])
        order.append(pos[ok])
    if not keys:
        z = np.zeros(0, np.int64)
        return z, z, z
    keys = np.concatenate(keys)[np.argsort(np.concatenate(order),
                                           kind="stable")]
    uniq, first, count = np.unique(keys, return_index=True,
                                   return_counts=True)
    seq = np.argsort(first, kind="stable")
    uniq, count = uniq[seq], count[seq]
    return uniq // num_ids, uniq % num_ids, count


def _id_rows(rec, img_ids):
    lut = np.full(max(max(rec.images, default=0), max(img_ids, default=0))
                  + 1, -1, np.int64)
    lut[np.asarray(img_ids, np.int64)] = np.arange(len(img_ids))
    return lut


def pose_graph_from_reconstruction(rec, min_common_points: int = 15,
                                   max_edges_per_image: int = 10,
                                   sim3: bool = False,
                                   dtype=torch.float32, device="cuda"):
    """A covisibility pose graph of a Reconstruction: an edge per pair of
    registered images sharing >= min_common_points 3D points (the
    strongest pairs first, while either image has fewer than
    max_edges_per_image edges), measured at the current relative poses;
    each edge's sqrt_info is sqrt(#shared points) * I. The pairs are
    counted in bulk over all tracks (numpy); the edges and their order
    are sba_tpu's. Returns (problem, registered image ids)."""
    img_ids = list(rec.registered_image_ids)
    n = len(img_ids)
    lut = _id_rows(rec, img_ids)
    tracks = [lut[np.asarray(p.image_ids, np.int64)]
              for p in rec.points3D.values()]
    i, j, c = covisible_pairs(tracks, max(n, 1))
    strong = c >= min_common_points
    i, j, c = i[strong], j[strong], c[strong]
    # sba_tpu sorts (c, i, j) tuples in reverse.
    order = np.lexsort((-j, -i, -c))
    per_img = np.zeros(n, np.int64)
    edges = []
    k = max_edges_per_image
    for a, b, cnt in zip(i[order].tolist(), j[order].tolist(),
                         c[order].tolist()):
        if per_img[a] < k or per_img[b] < k:
            edges.append((a, b, cnt))
            per_img[a] += 1
            per_img[b] += 1
    if not edges:
        raise ValueError("pose graph has no edges (graph too sparse)")
    qvecs = np.stack([rec.images[im].qvec for im in img_ids]).astype(
        np.float64)
    tvecs = np.stack([rec.images[im].tvec for im in img_ids]).astype(
        np.float64)
    e = np.asarray(edges, np.int64)
    ei, ej, cw = e[:, 0], e[:, 1], e[:, 2].astype(np.float64)
    rq, rt = relative_pose(*(torch.as_tensor(a) for a in (
        qvecs[ei], tvecs[ei], qvecs[ej], tvecs[ej])))
    d = 7 if sim3 else 6
    sqrt_info = np.sqrt(cw)[:, None, None] * np.eye(d)[None]
    problem = make_problem(qvecs, tvecs, ei, ej, rq.numpy(), rt.numpy(),
                           sqrt_info=sqrt_info, sim3=sim3, dtype=dtype,
                           device=device)
    return problem, img_ids


def apply_pose_graph_result(rec, problem: PoseGraphProblem, img_ids):
    """Write optimized poses back into the Reconstruction (in place)."""
    q = problem.qvecs.detach().cpu().numpy().astype(np.float64)
    t = problem.tvecs.detach().cpu().numpy().astype(np.float64)
    for k, im in enumerate(img_ids):
        rec.images[im].qvec = q[k]
        rec.images[im].tvec = t[k]
    return rec


def pad_edges_pow2(problem: PoseGraphProblem, min_edges: int = 8
                   ) -> PoseGraphProblem:
    """Pad the edge arrays to the next power of two (mask 0; identity
    measurements, so padded residuals stay finite)."""
    e = problem.edge_i.shape[0]
    target = max(min_edges, 1 << (e - 1).bit_length())
    if target == e:
        return problem
    pad = target - e

    def padv(a):
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])

    ident = problem.rel_q.new_zeros((pad, 4))
    ident[:, 0] = 1.0
    return problem._replace(
        edge_i=padv(problem.edge_i), edge_j=padv(problem.edge_j),
        rel_q=torch.cat([problem.rel_q, ident]), rel_t=padv(problem.rel_t),
        rel_log_s=padv(problem.rel_log_s),
        sqrt_info=padv(problem.sqrt_info),
        edge_mask=padv(problem.edge_mask))
