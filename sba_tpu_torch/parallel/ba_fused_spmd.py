"""SPMD fused bundle adjustment: the kernel path over the ranks of a mesh.

Port of ``sba_tpu/parallel/ba_fused_spmd.py``. Each track-length
bucket's point blocks (TP = 128 points each, slot-major observations)
are divided contiguously over the ranks; camera poses and intrinsics
are replicated. Per LM iteration each rank runs K1 (or K2 and, per CG
iteration, K3), K4 and K5 on its own blocks, and all-reduces of the
reduced camera system (image payload, S_corr, Ey; K3's correction; the
step sums, the cost and the point norms) let every rank run the same
replicated epilogue (optim/ba_fused.py). Communication per iteration
is O(Dk^2), whatever the number of observations.

Every rank is handed the whole problem and keeps its own blocks, as
sba_tpu's ``make_array_from_callback`` feeds each process its shards;
the solved points are put together by one all-reduce per bucket, and
every rank returns the same result.
"""

from __future__ import annotations

from typing import Optional

from sba_tpu_torch.optim import ba_fused as bf
from sba_tpu_torch.optim.ba import BAOptions, BAProblem
from sba_tpu_torch.parallel import group


def _shard_static(static, lay, rank: int, world: int):
    """The rank's blocks of a bucket's KernelStatic (sba_tpu's
    ``_static_specs``): observation lanes and point tables split along
    the block axis, the image tables replicated."""
    lanes = lay.Pp // world * lay.K
    points = lay.Pp // world

    def lane_rows(a):
        return a.narrow(-1, rank * lanes, lanes).contiguous()

    return static._replace(
        obs_sta=lane_rows(static.obs_sta), obs_img=lane_rows(static.obs_img),
        obs_cam=lane_rows(static.obs_cam),
        free_pts=static.free_pts.narrow(0, rank * points, points).contiguous(),
        tiles=None)


def prepare_spmd(problem: BAProblem, options: BAOptions,
                 mesh: Optional[group.Mesh] = None):
    """Host-side prep: buckets with block counts padded to a multiple of
    the mesh size, this rank's blocks of the static tables and points
    (K1's work list built on them), and the per-rank kernel layouts."""
    mesh = mesh or group.make_mesh()
    world, rank = mesh.size, mesh.rank
    statics, lays, pts0, idxs, problem_f, options_f, free_arrays = \
        bf.prepare(problem, options, block_multiple=world, tiles=False)
    local_lays = tuple(lay._replace(Pp=lay.Pp // world, nb=lay.nb // world)
                       for lay in lays)
    statics = bf.with_schur_tiles(
        tuple(_shard_static(st, lay, rank, world)
              for st, lay in zip(statics, lays)), local_lays, options_f)
    pts0 = [p.narrow(1, rank * lay.Pp, lay.Pp).contiguous()
            for p, lay in zip(pts0, local_lays)]
    return (statics, lays, local_lays, pts0, idxs, problem_f, options_f,
            free_arrays, mesh)


def solve_prepared_spmd(ctx):
    """Run the LM loop on a prepared SPMD context; every rank returns
    the whole solved problem and the summary."""
    (statics, lays, local_lays, pts0, idxs, problem, options,
     free_arrays, mesh) = ctx
    (q, t, pts_t, k), summary = bf._fused_lm_loop(
        statics, local_lays, pts0, problem, options, free_arrays,
        axis_name=mesh.axis_name)
    full = [group.gather_rows(p, mesh.rank * loc.Pp, lay.Pp,
                              mesh.axis_name, dim=1)
            for p, loc, lay in zip(pts_t, local_lays, lays)]
    pts_out = bf.unpack_bucket_points(full, idxs, problem.points.shape[0])
    out = problem._replace(qvecs=q, tvecs=t, points=pts_out, cam_params=k)
    return out, summary


def distributed_bundle_adjust_fused(problem: BAProblem,
                                    options: Optional[BAOptions] = None,
                                    mesh: Optional[group.Mesh] = None):
    """Solve BA with the fused kernels SPMD over `mesh` (the world group
    by default). The same solve as `optim.ba_fused.bundle_adjust_fused`
    up to the order of the sums across ranks (bit for bit on one rank)."""
    options = options or BAOptions()
    return solve_prepared_spmd(prepare_spmd(problem, options, mesh))
