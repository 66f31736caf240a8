"""SPMD solvers over torch.distributed process groups (sba_tpu/parallel).

The solvers are imported on first use (PEP 562), so that the optim
modules can import `parallel.group` without importing themselves back.
"""

import importlib

_EXPORTS = {
    "make_mesh": "group",
    "shard_problem": "distributed_ba",
    "shard_problem_by_points": "distributed_ba",
    "distributed_bundle_adjust": "distributed_ba",
    "distributed_bundle_adjust_pm": "distributed_ba",
    "distributed_bundle_adjust_fused": "ba_fused_spmd",
    "semantic_bundle_adjust_spmd": "sba_spmd",
    "geometric_semantic_bundle_adjust_spmd": "gsba_spmd",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
