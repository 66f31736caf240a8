"""The port and chip_smoke.py import neither jax nor sba_tpu."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import sba_tpu_torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, sys
sys.modules["jax"] = None      # any import of jax now raises ImportError
sys.modules["sba_tpu"] = None
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
import chip_smoke               # import only: main() does not run
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sba_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("clean", len({modules!r}))
"""


def test_port_and_chip_smoke_import_without_jax():
    modules = ["sba_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(sba_tpu_torch.__path__,
                                              "sba_tpu_torch.")]
    for name in ("sba_tpu_torch.ops.ba_kernels",
                 "sba_tpu_torch.ops.patch_match_kernels",
                 "sba_tpu_torch.mvs.patch_match",
                 "sba_tpu_torch.mvs.fusion",
                 "sba_tpu_torch.geometry.undistortion",
                 "sba_tpu_torch.utils.render",
                 "sba_tpu_torch.utils.mvs_accuracy",
                 "sba_tpu_torch.ops.map_gather",
                 "sba_tpu_torch.ops.interpolation",
                 "sba_tpu_torch.optim.sba",
                 "sba_tpu_torch.io.maps",
                 "sba_tpu_torch.controllers.semantic_ba",
                 "sba_tpu_torch.utils.card_repeat",
                 "sba_tpu_torch.models.cylinder",
                 "sba_tpu_torch.optim.gsba",
                 "sba_tpu_torch.controllers.geometric_semantic_ba",
                 "sba_tpu_torch.io.database",
                 "sba_tpu_torch.geometry.projection",
                 "sba_tpu_torch.geometry.triangulation",
                 "sba_tpu_torch.ops.polynomial",
                 "sba_tpu_torch.ops.topk",
                 "sba_tpu_torch.estimators.fundamental_matrix",
                 "sba_tpu_torch.estimators.essential_matrix",
                 "sba_tpu_torch.estimators.homography_matrix",
                 "sba_tpu_torch.estimators.two_view_geometry",
                 "sba_tpu_torch.optim.ransac",
                 "sba_tpu_torch.features.pairing",
                 "sba_tpu_torch.features.matching",
                 "sba_tpu_torch.features.sift",
                 "sba_tpu_torch.io.image_reader",
                 "sba_tpu_torch.geometry.similarity",
                 "sba_tpu_torch.estimators.absolute_pose",
                 "sba_tpu_torch.estimators.pose",
                 "sba_tpu_torch.io.database_cache",
                 "sba_tpu_torch.sfm.visibility_pyramid",
                 "sba_tpu_torch.sfm.incremental_triangulator",
                 "sba_tpu_torch.sfm.incremental_mapper",
                 "sba_tpu_torch.sfm.controllers",
                 "sba_tpu_torch.sfm.scene_clustering",
                 "sba_tpu_torch.sfm.hierarchical_mapper",
                 "sba_tpu_torch.optim.pose_graph",
                 "sba_tpu_torch.optim.least_absolute_deviations",
                 "sba_tpu_torch.estimators.generalized_relative_pose",
                 "sba_tpu_torch.estimators.generalized_pose",
                 "sba_tpu_torch.models.camera_rig",
                 "sba_tpu_torch.mvs.meshing",
                 "sba_tpu_torch.retrieval",
                 "sba_tpu_torch.retrieval.vocab_tree",
                 "sba_tpu_torch.retrieval.visual_index",
                 "sba_tpu_torch.retrieval.vote_and_verify",
                 "sba_tpu_torch.ops.segment",
                 "sba_tpu_torch.parallel",
                 "sba_tpu_torch.parallel.group",
                 "sba_tpu_torch.parallel.ba_fused_spmd",
                 "sba_tpu_torch.parallel.distributed_ba",
                 "sba_tpu_torch.parallel.sba_spmd",
                 "sba_tpu_torch.parallel.gsba_spmd",
                 "sba_tpu_torch.estimators.coordinate_frame",
                 "sba_tpu_torch.features.lines",
                 "sba_tpu_torch.geometry.gps",
                 "sba_tpu_torch.io.native_loader",
                 "sba_tpu_torch.io.ply",
                 "sba_tpu_torch.utils.host",
                 "sba_tpu_torch.utils.profiling",
                 "sba_tpu_torch.viewer",
                 "sba_tpu_torch.cli"):
        assert name in modules, name
    from sba_tpu_torch import cli

    for cmd in ("feature_extractor", "exhaustive_matcher",
                "sequential_matcher", "mapper", "point_triangulator",
                "image_registrator", "automatic_reconstructor",
                "hierarchical_mapper", "model_merger",
                "pose_graph_optimizer", "rig_bundle_adjuster",
                "poisson_mesher", "delaunay_mesher", "stereo_fusion",
                "image_rectifier", "vocab_tree_builder",
                "vocab_tree_matcher", "vocab_tree_retriever",
                "spatial_matcher", "model_converter", "model_viewer",
                "project_generator"):
        assert cmd in cli.COMMANDS, cmd
    assert len(cli.COMMANDS) == 46
    import sba_tpu_torch.parallel as par

    for name in ("make_mesh", "shard_problem", "shard_problem_by_points",
                 "distributed_bundle_adjust", "distributed_bundle_adjust_pm",
                 "distributed_bundle_adjust_fused",
                 "semantic_bundle_adjust_spmd",
                 "geometric_semantic_bundle_adjust_spmd"):
        assert callable(getattr(par, name)), name
    from sba_tpu_torch.optim.pose_graph import (
        distributed_optimize_pose_graph, shard_edges)  # noqa: F401
    res = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT),
                                             modules=modules)],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"clean {len(modules)}"


def test_port_has_every_command_and_module_of_sba_tpu():
    """The port's CLI lists sba_tpu's 46 command names, and every module
    of sba_tpu has a counterpart of the same path in the port."""
    import sba_tpu
    from sba_tpu import cli as jcli
    from sba_tpu_torch import cli as tcli

    assert sorted(tcli.COMMANDS) == sorted(jcli.COMMANDS)
    assert len(tcli.COMMANDS) == 46
    res = subprocess.run([sys.executable, "-m", "sba_tpu_torch.cli",
                          "--help"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    listed = [l.strip() for l in res.stdout.splitlines()
              if l.startswith("  ")]
    assert listed == sorted(jcli.COMMANDS)
    ours = {m.name.split(".", 1)[1] for m in pkgutil.walk_packages(
        sba_tpu_torch.__path__, "sba_tpu_torch.")}
    theirs = {m.name.split(".", 1)[1] for m in pkgutil.walk_packages(
        sba_tpu.__path__, "sba_tpu.")}
    assert not theirs - ours, sorted(theirs - ours)
