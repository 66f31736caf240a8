"""SPMD semantic bundle adjustment: ordered pairs sharded over a mesh.

Port of ``sba_tpu/parallel/sba_spmd.py``. The SBA residual field is
parallel over ordered image pairs (Q = N(N-1)) and its parameters are
the poses alone ([6N]), so:

- the pair lists (pair_src, pair_dst, pair_mask) are padded to a
  multiple of the mesh size with mask-0 pairs and split contiguously
  over the ranks;
- poses, intrinsics and the packed depth/semantic maps are replicated:
  every rank holds the maps whole (the bench_sba scene's 50 packed
  640x480 maps are ~60 MB), so no pixel gather crosses ranks;
- per LM iteration, one all-reduce of (H [6N, 6N], g [6N], cost) makes
  every rank's dense solve see the global normal equations, O((6N)^2)
  whatever Q and the map resolution.

The map gathers run on each rank's own pairs through the map-gather
kernels (ops/map_gather.py), chunked within the rank as on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sba_tpu_torch.optim.sba import SBAOptions, SBAProblem, _sba_solve
from sba_tpu_torch.parallel import group

_AXIS = "sba_pairs"
_PAIRS = ("pair_src", "pair_dst", "pair_mask")


def _pad_pairs(problem: SBAProblem, ndev: int) -> SBAProblem:
    pad = (-problem.pair_src.shape[0]) % ndev
    if pad == 0:
        return problem
    return problem._replace(**{
        f: torch.cat([getattr(problem, f), getattr(problem, f).new_zeros(pad)])
        for f in _PAIRS})


def semantic_bundle_adjust_spmd(problem: SBAProblem,
                                options: Optional[SBAOptions] = None,
                                mesh: Optional[group.Mesh] = None):
    """`semantic_bundle_adjust` over the ranks of `mesh` (the world group
    by default). Every rank returns the padded problem with the solved
    poses and the summary (its counts summed over all pairs)."""
    opt = dataclasses.replace(options or SBAOptions(), axis_name=_AXIS)
    mesh = group.as_mesh(mesh, _AXIS)
    W, r = mesh.size, mesh.rank
    problem = _pad_pairs(problem, W)
    local = problem._replace(**{
        f: group.shard_rows(getattr(problem, f), r, W).contiguous()
        for f in _PAIRS})
    out, summary = _sba_solve(local, opt)
    return problem._replace(qvecs=out.qvecs, tvecs=out.tvecs), summary
