"""Distributed bundle adjustment in float64: SPMD Schur solves.

Port of ``sba_tpu/parallel/distributed_ba.py``. Two partitions:

- **Observations** (`distributed_bundle_adjust`): the observation table
  is padded to a multiple of the mesh size and split contiguously over
  the ranks; poses, intrinsics and points are replicated. Every
  reduction over the observations is all-reduced
  (`group.all_reduce`), and the reduced camera system is solved by PCG on
  every rank (or by the COO explicit step for solver explicit_schur).
- **Points** (`distributed_bundle_adjust_pm`): every point and its whole
  track live on one rank (`shard_problem_by_points`, round robin over
  the points sorted by track length), so landmark elimination is local;
  the point-major explicit step all-reduces the image payload, EL EL^T
  and the RHS once per LM iteration.

Every rank is handed the whole problem, keeps its own shard, and
returns the same replicated result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sba_tpu_torch.optim.ba import (
    BAOptions, BAProblem, _bundle_adjust_impl, _image_cam_of,
)
from sba_tpu_torch.parallel import group
from sba_tpu_torch.parallel.group import make_mesh

_OBS = ("obs_image", "obs_point", "obs_cam", "obs_xy", "obs_mask")


def pad_observations(problem: BAProblem, multiple: int) -> BAProblem:
    """Pad the observation table to a multiple of the mesh size with
    mask-0 rows (image, point and camera 0; they contribute nothing).
    Unlike sba_tpu, `image_cam` is kept (from the whole table), so that every
    rank's COO explicit step reads the same camera of each image."""
    problem = problem._replace(
        image_cam=torch.as_tensor(_image_cam_of(problem),
                                  device=problem.points.device))
    pad = (-problem.obs_image.shape[0]) % multiple
    if pad == 0:
        return problem
    return problem._replace(**{
        f: torch.cat([getattr(problem, f), getattr(problem, f).new_zeros(
            (pad,) + getattr(problem, f).shape[1:])]) for f in _OBS})


def shard_problem(problem: BAProblem,
                  mesh: Optional[group.Mesh] = None) -> BAProblem:
    """This rank's problem: the padded observation table's contiguous
    1/size, the parameters whole."""
    mesh = mesh or make_mesh()
    problem = pad_observations(problem, mesh.size)
    return problem._replace(**{
        f: group.shard_rows(getattr(problem, f), mesh.rank,
                            mesh.size).contiguous() for f in _OBS})


def distributed_bundle_adjust(problem: BAProblem,
                              options: Optional[BAOptions] = None,
                              mesh: Optional[group.Mesh] = None):
    """Solve BA SPMD over `mesh` with the observations sharded. The same
    solve as `optim.ba.bundle_adjust` with solver schur_pcg (or, for
    solver explicit_schur, its COO explicit step) up to the order of
    the sums across ranks. Returns the padded problem with the solved
    parameters, and the summary."""
    options = options or BAOptions()
    mesh = mesh or make_mesh()
    solver = ("explicit_schur" if options.solver == "explicit_schur"
              else "schur_pcg")
    options = dataclasses.replace(options, axis_name=mesh.axis_name,
                                  solver=solver, obs_layout="coo")
    out, summary = _bundle_adjust_impl(shard_problem(problem, mesh), options)
    padded = pad_observations(problem, mesh.size)
    return padded._replace(qvecs=out.qvecs, tvecs=out.tvecs,
                           points=out.points,
                           cam_params=out.cam_params), summary


# ---------------------------------------------------------------------------
# Point-sharded (track-aware) partitioning and the point-major SPMD solve.
# ---------------------------------------------------------------------------

def shard_problem_by_points(problem: BAProblem, n_shards: int):
    """Track-aware partition: every point and its whole track on one
    shard; round robin over the points sorted by track length balances
    the observations. Returns (the problem in per-shard point-major
    layout, leading dimension n_shards * Pmax, observation rows
    n_shards * Pmax * K with K the longest track; point_perm) where
    point_perm[row] is the original point of a row (-1: padding)."""
    dev = problem.points.device
    op = problem.obs_point.cpu().numpy()
    om = problem.obs_mask.cpu().numpy()
    oi = problem.obs_image.cpu().numpy()
    oc = problem.obs_cam.cpu().numpy()
    oxy = problem.obs_xy.cpu().numpy()
    P = problem.points.shape[0]
    counts = np.bincount(op[om > 0], minlength=P)
    K = max(int(counts.max()), 1)
    order = np.argsort(-counts, kind="stable")
    shard_of = np.empty(P, np.int64)
    shard_of[order] = np.arange(P) % n_shards
    locals_ = [np.nonzero(shard_of == d)[0] for d in range(n_shards)]
    Pmax = max(max(len(l) for l in locals_), 1)

    obs_order = np.argsort(op, kind="stable")
    offs = np.concatenate([[0], np.cumsum(np.bincount(op, minlength=P))])

    pts = np.zeros((n_shards * Pmax, 3))
    freep = np.zeros(n_shards * Pmax)
    perm = np.full(n_shards * Pmax, -1, np.int64)
    Ob = Pmax * K
    s_oi = np.zeros(n_shards * Ob, np.int32)
    s_oc = np.zeros(n_shards * Ob, np.int32)
    s_xy = np.zeros((n_shards * Ob, 2))
    s_m = np.zeros(n_shards * Ob)
    pts_np = problem.points.cpu().numpy()
    freep_np = problem.free_points.cpu().numpy()
    for d, idx in enumerate(locals_):
        base_p = d * Pmax
        pts[base_p:base_p + len(idx)] = pts_np[idx]
        freep[base_p:base_p + len(idx)] = freep_np[idx]
        perm[base_p:base_p + len(idx)] = idx
        for local, p in enumerate(idx):
            rows = obs_order[offs[p]:offs[p + 1]]
            if len(rows) > K:
                rows = rows[np.argsort(-om[rows], kind="stable")][:K]
            base = d * Ob + local * K
            n = len(rows)
            s_oi[base:base + n] = oi[rows]
            s_oc[base:base + n] = oc[rows]
            s_xy[base:base + n] = oxy[rows]
            s_m[base:base + n] = om[rows]
    s_op = np.tile(np.repeat(np.arange(Pmax, dtype=np.int32), K), n_shards)

    dtype = problem.points.dtype
    image_cam = problem.image_cam
    if image_cam is None:
        image_cam = torch.as_tensor(_image_cam_of(problem), device=dev)

    def t(a, dt=dtype):
        return torch.as_tensor(a, device=dev).to(dt)

    sharded = problem._replace(
        points=t(pts), free_points=t(freep),
        obs_image=t(s_oi, torch.int32), obs_point=t(s_op, torch.int32),
        obs_cam=t(s_oc, torch.int32), obs_xy=t(s_xy), obs_mask=t(s_m),
        image_cam=image_cam)
    return sharded, torch.as_tensor(perm, device=dev)


def distributed_bundle_adjust_pm(problem: BAProblem,
                                 options: Optional[BAOptions] = None,
                                 mesh: Optional[group.Mesh] = None):
    """Point-sharded SPMD solve with the point-major explicit step: one
    all-reduce each for the image payload, the Schur correction and the
    RHS per LM iteration, landmark elimination local by construction.
    Returns the problem with the solved parameters (points in their
    original order), and the summary."""
    options = options or BAOptions()
    mesh = mesh or make_mesh()
    W, r = mesh.size, mesh.rank
    options = dataclasses.replace(
        options, axis_name=mesh.axis_name, solver="explicit_schur",
        obs_layout="point_major")
    sharded, perm = shard_problem_by_points(problem, W)
    Pmax = sharded.points.shape[0] // W
    local = sharded._replace(
        points=group.shard_rows(sharded.points, r, W).contiguous(),
        free_points=group.shard_rows(sharded.free_points, r, W).contiguous(),
        **{f: group.shard_rows(getattr(sharded, f), r, W).contiguous()
           for f in ("obs_image", "obs_cam", "obs_xy", "obs_mask")},
        obs_point=sharded.obs_point[:sharded.obs_point.shape[0] // W])
    out, summary = _bundle_adjust_impl(local, options)
    rows = group.gather_rows(out.points, r * Pmax, W * Pmax, mesh.axis_name)
    valid = perm >= 0
    pts = problem.points.clone()
    pts[perm[valid]] = rows[valid].to(pts.dtype)
    return problem._replace(qvecs=out.qvecs, tvecs=out.tvecs, points=pts,
                            cam_params=out.cam_params), summary
