"""The port's scene clustering, hierarchical mapper, model merge, seam
relaxation and LAD solver against sba_tpu's, in float64 on the CPU with
the same numpy inputs (tests/test_aux_modules.py's cases): the same
cuts and the same cluster tree, leaf for leaf with its overlap images in
order; merged models equal (poses and points at 1e-9 of the scene's
scale); relaxed poses at 1e-9 of scale; LAD solutions at 1e-9 with
equal iteration counts. One whole hierarchical run through both CLIs
on tests/test_torch_mapper.py's ring database forced into two leaves,
with sba_tpu's draws (models at 1e-6 of scale, as
tests/test_torch_sfm.py holds the mapper), then `model_merger` on the
leaf models and `pose_graph_optimizer` on the merged model through both
CLIs. The new commands fail without a card unless asked for the CPU."""

import numpy as np
import pytest
import torch

from sba_tpu.io import database as j_db
from sba_tpu.models.reconstruction import Reconstruction as JRec
from sba_tpu.optim import least_absolute_deviations as j_lad
from sba_tpu.sfm import hierarchical_mapper as j_hm
from sba_tpu.sfm import scene_clustering as j_sc
from sba_tpu_torch import cli as t_cli
from sba_tpu_torch.geometry.quaternions import (angle_axis_to_quat,
                                                quat_multiply, quat_normalize)
from sba_tpu_torch.models.reconstruction import Reconstruction as TRec
from sba_tpu_torch.optim import least_absolute_deviations as t_lad
from sba_tpu_torch.sfm import hierarchical_mapper as t_hm
from sba_tpu_torch.sfm import scene_clustering as t_sc
from test_aux_modules import _two_community_edges
from test_torch_mapper import write_ring_scene
from test_torch_sfm import _scale, assert_same_model, mappers, run_both

torch.set_num_threads(2)


def _random_graph(seed, n=23, p=0.35):
    rng = np.random.default_rng(seed)
    edges = {}
    for a in range(n):
        for b in range(a + 1, n):
            if rng.uniform() < p:
                edges[(a + 1, b + 1)] = int(rng.integers(15, 400))
    return edges


GRAPHS = {"communities": lambda: _two_community_edges(n=10, cross=2),
          "random0": lambda: _random_graph(0), "random1": lambda: _random_graph(1)}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("parts", [2, 4])
def test_normalized_min_cut_matches_sba_tpu(graph, parts):
    edges = GRAPHS[graph]()
    ids = sorted({i for p in edges for i in p})
    assert t_sc.normalized_min_cut(ids, edges, parts) == \
        j_sc.normalized_min_cut(ids, edges, parts)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("leaf,overlap,branching", [(12, 2, 2), (5, 3, 2),
                                                    (6, 4, 3)])
def test_cluster_tree_matches_sba_tpu(graph, leaf, overlap, branching):
    """The leaves in order, each image list (own images, then the overlap
    images in score order) equal."""
    edges = GRAPHS[graph]()
    opt = dict(leaf_max_num_images=leaf, image_overlap=overlap,
               branching=branching)
    a = j_sc.SceneClustering(j_sc.SceneClusteringOptions(**opt))
    b = t_sc.SceneClustering(t_sc.SceneClusteringOptions(**opt))
    a.partition(edges)
    b.partition(edges)
    la, lb = a.leaf_clusters(), b.leaf_clusters()
    assert len(la) > 1
    assert [c.image_ids for c in lb] == [c.image_ids for c in la]


# ---------------------------------------------------------------------------
# merge and relaxation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synthetic_dir(tmp_path_factory):
    from sba_tpu.utils.synthetic import make_synthetic_reconstruction

    path = tmp_path_factory.mktemp("hier_synth")
    make_synthetic_reconstruction(num_images=8, num_points=160,
                                  seed=5).write(str(path))
    return path


def _similarity(rec, s, R, t):
    """Move a model into the frame world' = s R world + t (in place)."""
    from sba_tpu_torch.geometry.quaternions import (np_quat_to_rotmat,
                                                    np_rotmat_to_quat)
    for im in rec.images.values():
        Rc = np_quat_to_rotmat(im.qvec) @ R.T
        im.qvec = np_rotmat_to_quat(Rc)
        im.tvec = s * im.tvec - Rc @ t
    for p in rec.points3D.values():
        p.xyz = s * (R @ p.xyz) + t


def _pair(cls, path, keep1, keep2, transform):
    """Two models read from `path` by `cls`: images keep1 and keep2 kept
    registered, the second moved by `transform`."""
    r1, r2 = cls.read(str(path)), cls.read(str(path))
    for rec, keep in ((r1, keep1), (r2, keep2)):
        for iid in list(rec.registered_image_ids):
            if iid not in keep:
                rec.deregister_image(iid)
    _similarity(r2, *transform)
    return r1, r2


@pytest.mark.parametrize("keep2", [(3, 4, 5, 6, 7, 8), (4, 5, 6, 7, 8),
                                   (5, 6, 7, 8)])
def test_merge_reconstructions_matches_sba_tpu(synthetic_dir, keep2):
    """rec2 (images keep2, in a rotated, scaled, shifted frame) onto rec1
    (images 1-6): four and three common images, and two (refused)."""
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    tr = (2.0, R, np.array([1.0, -2.0, 0.5]))
    keep1 = (1, 2, 3, 4, 5, 6)
    j1, j2 = _pair(JRec, synthetic_dir, keep1, keep2, tr)
    t1, t2 = _pair(TRec, synthetic_dir, keep1, keep2, tr)
    ok = j_hm.merge_reconstructions(j1, j2)
    assert t_hm.merge_reconstructions(t1, t2) == ok
    assert ok == (len(set(keep1) & set(keep2)) >= 3)
    assert_same_model(j1, t1, 1e-9 * _scale(j1))
    assert_same_model(j2, t2, 1e-9 * _scale(j1))
    if ok:
        assert t1.num_registered_images() == 8


def test_relax_merged_model_matches_sba_tpu(synthetic_dir):
    """tests/test_aux_modules.py's seam: exact partials over images 1-5
    and 4-8, seam error injected into images 6-8 of the merged model."""
    rng = np.random.default_rng(4)
    noise = {i: (rng.normal(size=3) * 0.05, rng.normal(size=3) * 0.1)
             for i in (6, 7, 8)}
    out = {}
    for cls, hm in ((JRec, j_hm), (TRec, t_hm)):
        base = cls.read(str(synthetic_dir))
        parts = []
        for keep in (set(range(1, 6)), set(range(4, 9))):
            part = cls.read(str(synthetic_dir))
            for iid in list(part.registered_image_ids):
                if iid not in keep:
                    part.deregister_image(iid)
            parts.append(part)
        for iid, (daa, dt) in noise.items():
            im = base.images[iid]
            im.qvec = quat_normalize(quat_multiply(
                angle_axis_to_quat(torch.as_tensor(daa)),
                torch.as_tensor(im.qvec))).numpy()
            im.tvec = im.tvec + dt
        kw = dict(min_common_points=5)
        if hm is t_hm:
            kw["device"] = "cpu"
        assert hm.relax_merged_model(base, parts, **kw) is True
        out[cls] = base
    j, t = out[JRec], out[TRec]
    assert_same_model(j, t, 1e-9 * _scale(j))
    truth = TRec.read(str(synthetic_dir))
    for i in t.registered_image_ids:
        np.testing.assert_allclose(t.images[i].tvec, truth.images[i].tvec,
                                   atol=1e-3)


def test_relax_without_edges_returns_false(synthetic_dir):
    base = TRec.read(str(synthetic_dir))
    assert t_hm.relax_merged_model(base, [base], min_common_points=10 ** 6,
                                   device="cpu") is False


# ---------------------------------------------------------------------------
# LAD
# ---------------------------------------------------------------------------

def _lad_case(name):
    rng = np.random.default_rng(0)
    if name == "exact":
        return np.eye(4), np.array([1.0, -2.0, 3.0, 0.0]), {}
    A = rng.standard_normal((60, 5))
    b = A @ rng.standard_normal(5)
    b[::7] += 50.0
    if name == "outliers":
        return A, b, dict(max_num_iterations=2000)
    return A, b, dict(rho=2.0, alpha=1.5, max_num_iterations=40)


@pytest.mark.parametrize("case", ["exact", "outliers", "capped"])
def test_lad_matches_sba_tpu(case):
    """The same iterate at the same stopping iteration (and, capped, the
    same unconverged state)."""
    import jax.numpy as jnp

    A, b, kw = _lad_case(case)
    ref = j_lad.solve_least_absolute_deviations(
        jnp.asarray(A), jnp.asarray(b), options=j_lad.LADOptions(**kw))
    got = t_lad.solve_least_absolute_deviations(
        torch.as_tensor(A), torch.as_tensor(b),
        options=t_lad.LADOptions(**kw))
    assert got.num_iterations == int(ref.num_iterations)
    assert got.converged == bool(ref.converged)
    assert got.converged == (case != "capped")
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------

RING = dict(n_images=8, n_points=150)
HIER_FLAGS = {"Mapper.init_min_num_inliers": "50",
              "Mapper.abs_pose_min_num_inliers": "15",
              "SceneClustering.leaf_max_num_images": "4",
              "SceneClustering.image_overlap": "2"}


def test_hierarchical_commands_match_sba_tpu(tmp_path):
    """`hierarchical_mapper` (two leaves of six views, one merge, the
    relaxation) through both CLIs: the clusters, each leaf's mapper (its
    initial pair and registration order) and the merged model equal.
    Then `model_merger` on the port's leaf models and
    `pose_graph_optimizer` (float32) on the merged model, both CLIs."""
    db = j_db.Database(str(tmp_path / "db.db"))
    write_ring_scene(db, **RING)
    db.close()
    jm, tm = [], []
    with mappers(jm, tm):
        out = run_both("hierarchical_mapper", dict(
            HIER_FLAGS, database_path=str(tmp_path / "db.db"),
            output_path=str(tmp_path / "@_hier"),
            leaf_output_path=str(tmp_path / "leaves")))
    assert len(jm) == len(tm) == 2
    for a, b in zip(jm, tm):
        assert a.rec.registered_image_ids == b.rec.registered_image_ids
    j = JRec.read(str(tmp_path / "j_hier" / "0"))
    t = TRec.read(str(tmp_path / "t_hier" / "0"))
    assert t.num_registered_images() == 8
    assert not (tmp_path / "t_hier" / "1").exists()
    assert_same_model(j, t, 1e-6 * _scale(j))
    assert "leaf 0: 6 images -> 1 models" in out
    assert "leaf 1: 6 images -> 1 models" in out
    assert "(1 merges)" in out and "(relaxed: True) [cpu]" in out
    assert f"model 0: 8 images, {t.num_points3d()} points -> " in out

    leaves = [str(tmp_path / "leaves" / str(k)) for k in (0, 1)]
    out = run_both("model_merger", dict(
        input_path1=leaves[0], input_path2=leaves[1],
        output_path=str(tmp_path / "@_merged")))
    jm_, tm_ = (cls.read(str(tmp_path / f"{p}_merged"))
                for cls, p in ((JRec, "j"), (TRec, "t")))
    assert tm_.num_registered_images() == 8
    assert f"merged: 8 images, {tm_.num_points3d()} points" in out
    assert_same_model(jm_, tm_, 1e-9 * _scale(jm_))

    out = run_both("pose_graph_optimizer", dict(
        input_path=str(tmp_path / "j_hier" / "0"),
        output_path=str(tmp_path / "@_pg"),
        **{"PoseGraph.min_common_points": "10"}))
    assert "pose graph: 8 nodes, " in out and "[cpu]" in out
    jp, tp = (cls.read(str(tmp_path / f"{p}_pg"))
              for cls, p in ((JRec, "j"), (TRec, "t")))
    # float32 solves: the poses at float32's resolution of the scene.
    assert_same_model_poses(jp, tp, 1e-5 * _scale(jp))


def assert_same_model_poses(j, t, atol):
    assert sorted(j.registered_image_ids) == sorted(t.registered_image_ids)
    for iid, im in j.images.items():
        np.testing.assert_allclose(t.images[iid].qvec, im.qvec, rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(t.images[iid].tvec, im.tvec, rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("command", ["hierarchical_mapper", "model_merger",
                                     "pose_graph_optimizer",
                                     "rig_bundle_adjuster"])
def test_new_commands_need_a_card(command, tmp_path, monkeypatch):
    """Without a card and without --device cpu each new command fails
    before it writes anything; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = {"hierarchical_mapper": ["--database_path",
                                     str(tmp_path / "db.db")],
             "model_merger": ["--input_path1", str(tmp_path),
                              "--input_path2", str(tmp_path)],
             "pose_graph_optimizer": ["--input_path", str(tmp_path)],
             "rig_bundle_adjuster": ["--input_path", str(tmp_path),
                                     "--rig_config_path",
                                     str(tmp_path / "rig.json")]}[command]
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="no CUDA device"):
        t_cli.main([command] + flags + ["--output_path", str(out)])
    assert not out.exists()
