"""SPMD geometric-semantic bundle adjustment: images sharded over a mesh.

Port of ``sba_tpu/parallel/gsba_spmd.py``. The GSBA residuals are
[N images x K cylinders], each one soft IoU over the image's trunk
mask, so the work scales with N K H W while the parameters (6N +
kdim K (+ 3P)) stay few:

- images (poses, intrinsics, masks, their rasterization) are padded to
  a multiple of the mesh size with `img_weight = 0` rows (they add
  neither cost nor gradient) and split contiguously over the ranks;
- cylinders and landmark points are replicated;
- landmark observations go with their image (`_shard_observations`):
  each rank's block holds its images' observations with rank-local
  image indices, padded to the largest block with obs_mask 0, and the
  landmark weight divides by the global count;
- per LM iteration, one all-reduce of the normal equations and one of
  each cost; the dense solve is replicated.

The per-image outputs (poses, `per_image_iou`) are put together by an
all-reduce of zero-filled full tensors, so every rank returns the same
result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sba_tpu_torch.optim.gsba import (GSBAOptions, GSBAProblem,
                                      _gsba_solve)
from sba_tpu_torch.parallel import group

_AXIS = "gsba_images"
_IMAGE_ROWS = ("qvecs", "tvecs", "cam_params", "sem_masks", "free_rot",
               "free_trans", "img_weight")
_OBS = ("obs_image", "obs_point", "obs_xy", "obs_mask")


def _pad_images(problem: GSBAProblem, ndev: int) -> GSBAProblem:
    """Pad the images to a multiple of `ndev` with copies of the last
    one at zero weight and frozen; `img_weight` becomes explicit (1/N
    for the real images unless given)."""
    N = problem.qvecs.shape[0]
    wt = (problem.img_weight if problem.img_weight is not None
          else torch.full((N,), 1.0 / N, dtype=problem.tvecs.dtype,
                          device=problem.tvecs.device))
    pad = (-N) % ndev
    if pad == 0:
        return problem._replace(img_weight=wt)

    def padrow(a):
        return torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])

    return problem._replace(
        qvecs=padrow(problem.qvecs), tvecs=padrow(problem.tvecs),
        cam_params=padrow(problem.cam_params),
        sem_masks=padrow(problem.sem_masks),
        free_rot=torch.cat([problem.free_rot,
                            problem.free_rot.new_zeros(pad)]),
        free_trans=torch.cat([problem.free_trans,
                              problem.free_trans.new_zeros(pad, 3)]),
        img_weight=torch.cat([wt, wt.new_zeros(pad)]))


def _shard_observations(problem: GSBAProblem, ndev: int):
    """Lay the landmark observations out as `ndev` equal blocks, block s
    holding those of images [s Nl, (s + 1) Nl) with image indices local
    to the block (images padded to a multiple of ndev first). Returns
    (the problem, the real observation count)."""
    O = problem.obs_xy.shape[0]
    if O == 0:
        return problem, 0
    Nl = problem.qvecs.shape[0] // ndev
    obs = {f: getattr(problem, f).cpu().numpy() for f in _OBS}
    shard_of = obs["obs_image"] // Nl
    Opad = max(int(np.bincount(shard_of, minlength=ndev).max()), 1)
    new = {f: np.zeros((ndev, Opad) + a.shape[1:], a.dtype)
           for f, a in obs.items()}
    for s in range(ndev):
        sel = np.nonzero(shard_of == s)[0]
        for f, a in obs.items():
            new[f][s, :len(sel)] = a[sel]
        new["obs_image"][s, :len(sel)] -= s * Nl       # local indices
    n_real = int(obs["obs_mask"].sum())
    dev = problem.obs_xy.device
    return problem._replace(**{
        f: torch.as_tensor(a.reshape((-1,) + a.shape[2:]), device=dev)
        for f, a in new.items()}), n_real


def geometric_semantic_bundle_adjust_spmd(
        problem: GSBAProblem, options: Optional[GSBAOptions] = None,
        mesh: Optional[group.Mesh] = None):
    """`geometric_semantic_bundle_adjust` over the ranks of `mesh` (the
    world group by default). Every rank returns the whole solved problem
    and summary, padding stripped."""
    opt = options or GSBAOptions()
    mesh = group.as_mesh(mesh, _AXIS)
    W, r = mesh.size, mesh.rank
    N_real = problem.qvecs.shape[0]
    padded = _pad_images(problem, W)
    N = padded.qvecs.shape[0]
    padded, n_obs = _shard_observations(padded, W)
    opt = dataclasses.replace(opt, axis_name=_AXIS, spmd_num_images=N,
                              spmd_num_obs=n_obs)
    Nl = N // W
    local = padded._replace(
        **{f: group.shard_rows(getattr(padded, f), r, W).contiguous()
           for f in _IMAGE_ROWS + _OBS})
    out, summary = _gsba_solve(local, opt)

    def full(a):
        return group.gather_rows(a, r * Nl, N, _AXIS)[:N_real]

    out = padded._replace(
        qvecs=full(out.qvecs), tvecs=full(out.tvecs),
        cam_params=padded.cam_params[:N_real],
        sem_masks=padded.sem_masks[:N_real],
        free_rot=padded.free_rot[:N_real],
        free_trans=padded.free_trans[:N_real],
        img_weight=padded.img_weight[:N_real],
        cyl_qvec=out.cyl_qvec, cyl_tvec=out.cyl_tvec,
        cyl_log_radius=out.cyl_log_radius,
        cyl_log_height=out.cyl_log_height, points=out.points)
    return out, summary._replace(per_image_iou=full(summary.per_image_iou))
