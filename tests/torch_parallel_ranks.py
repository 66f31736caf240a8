"""Rank bodies of tests/test_torch_parallel.py.

They run in processes spawned by `sba_tpu_torch.parallel.group.run_ranks`
and import the port alone: importing the test module would pull in jax
and the repository's conftest settings.
"""

import torch

from sba_tpu_torch import parallel
from sba_tpu_torch.ops import ba_kernels as bk
from sba_tpu_torch.ops import map_gather as mg
from sba_tpu_torch.optim import ba, gsba, pose_graph, sba


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _ba(fields, device):
    return ba.problem_from_numpy(fields, device=device)


def _pose_graph(fields, device):
    return pose_graph.make_problem(
        fields["qvecs"], fields["tvecs"], fields["edge_i"], fields["edge_j"],
        fields["rel_q"], fields["rel_t"], sqrt_info=fields["sqrt_info"],
        edge_mask=fields["edge_mask"], pose_fixed=fields["pose_fixed"],
        log_scales=fields["log_scales"], rel_log_s=fields["rel_log_s"],
        dtype=torch.float64, device=device)


# kind -> (problem from numpy fields, options class, sharded solve)
SOLVERS = {
    "fused": (_ba, ba.BAOptions, parallel.distributed_bundle_adjust_fused),
    "obs": (_ba, ba.BAOptions, parallel.distributed_bundle_adjust),
    "pm": (_ba, ba.BAOptions, parallel.distributed_bundle_adjust_pm),
    "sba": (sba.sba_problem_from_numpy, sba.SBAOptions,
            parallel.semantic_bundle_adjust_spmd),
    "gsba": (gsba.gsba_problem_from_numpy, gsba.GSBAOptions,
             parallel.geometric_semantic_bundle_adjust_spmd),
    "pose_graph": (_pose_graph, pose_graph.PoseGraphOptions,
                   pose_graph.distributed_optimize_pose_graph),
}


def solve_cases(rank, world, device, cases):
    """Every case {name: (kind, numpy fields, option kwargs)} through its
    sharded solve; returns {name: (problem fields, summary fields, the
    kernels' launch counts)} as numpy."""
    out = {}
    for name, (kind, fields, opt_kw) in cases.items():
        make, options, solve = SOLVERS[kind]
        bk.reset_launches()
        mg.reset_launches()
        problem, summary = solve(make(fields, device), options(**opt_kw))
        out[name] = ({k: _np(v) for k, v in problem._asdict().items()
                      if v is not None},
                     {k: _np(v) for k, v in summary._asdict().items()},
                     dict(bk.LAUNCHES, **mg.LAUNCHES))
    return out


def fail_on_rank_one(rank, world, device):
    """A rank that raises while the other waits in a collective."""
    if rank == 1:
        raise ValueError("rank 1 stops here")
    torch.distributed.barrier()
    return rank
