"""The port's incremental mapper and its commands against sba_tpu's, on
tests/test_incremental_mapper.py's 8-image scene with that file's mapper
options, in float64 on the CPU with sba_tpu's draws: `mapper` (from
scratch and resumed from a partial model), `point_triangulator` and
`image_registrator` of both CLIs give the same models (registration
order, tracks; poses and points within 1e-6 of the scene's scale, 1e-9
without a bundle adjustment). `automatic_reconstructor --dense 0` equals
its four commands run in a row, `--dense 1` raises, and every new command
fails without a card unless it is asked for the CPU."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from sba_tpu import cli as j_cli
from sba_tpu.io import database as j_db
from sba_tpu.models.reconstruction import Reconstruction as JRec
from sba_tpu.sfm import controllers as j_ctl
from sba_tpu_torch import cli as t_cli
from sba_tpu_torch.models.reconstruction import Reconstruction as TRec
from sba_tpu_torch.sfm import controllers as t_ctl
from sba_tpu_torch.sfm import incremental_mapper as t_map
from test_torch_mapper import sba_draws, write_ring_scene

torch.set_num_threads(2)

# tests/test_incremental_mapper.py's `mapper_opts`, as flags.
MAPPER_FLAGS = {"Mapper.init_min_num_inliers": "50",
                "Mapper.abs_pose_min_num_inliers": "15"}


def _recording(base, instances, **inject):
    """A subclass of an IncrementalMapper class that records its
    instances (and passes `inject` to the constructor)."""
    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, **inject})
            instances.append(self)
    return Recording


@contextlib.contextmanager
def mappers(j_list, t_list):
    """Both packages' mappers recorded; the port's draw sba_tpu's samples."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ctl, "IncrementalMapper",
                   _recording(j_ctl.IncrementalMapper, j_list))
        mp.setattr(t_ctl, "IncrementalMapper",
                   _recording(t_map.IncrementalMapper, t_list,
                              draw_fn=sba_draws))
        mp.setattr(t_map, "IncrementalMapper",
                   _recording(t_map.IncrementalMapper, t_list,
                              draw_fn=sba_draws))
        import sba_tpu.sfm.incremental_mapper as j_map
        mp.setattr(j_map, "IncrementalMapper",
                   _recording(j_map.IncrementalMapper, j_list))
        yield


def run_both(command, flags):
    """One command of each CLI (sba_tpu's run_* in process, the port's
    main with --device cpu); returns the port's printed output."""
    getattr(j_cli, "run_" + command)(
        {k: v.replace("@", "j") for k, v in flags.items()})
    buf = io.StringIO()
    args = [command, "--device", "cpu"]
    for k, v in flags.items():
        args += ["--" + k, v.replace("@", "t")]
    with contextlib.redirect_stdout(buf):
        assert t_cli.main(args) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("sfm")
    db = j_db.Database(str(root / "db.db"))
    truth = write_ring_scene(db)
    db.close()
    return root, truth


@pytest.fixture(scope="module")
def mapped(ws):
    root, _ = ws
    jm, tm = [], []
    with mappers(jm, tm):
        out = run_both("mapper", dict(
            MAPPER_FLAGS, database_path=str(root / "db.db"),
            output_path=str(root / "@_sparse")))
    return dict(jm=jm, tm=tm, out=out,
                j=JRec.read(str(root / "j_sparse" / "0")),
                t=TRec.read(str(root / "t_sparse" / "0")))


def _scale(rec):
    c = np.stack([-_R(im.qvec).T @ im.tvec for im in rec.images.values()])
    return float(np.max(np.linalg.norm(c - c.mean(0), axis=1)))


def _R(q):
    from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat
    return np_quat_to_rotmat(q)


def assert_same_model(j, t, atol):
    assert sorted(j.images) == sorted(t.images)
    assert sorted(j.registered_image_ids) == sorted(t.registered_image_ids)
    for iid, im in j.images.items():
        np.testing.assert_allclose(t.images[iid].qvec, im.qvec, rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(t.images[iid].tvec, im.tvec, rtol=0,
                                   atol=atol)
        np.testing.assert_array_equal(t.images[iid].point3D_ids,
                                      im.point3D_ids)
    assert list(j.points3D) == list(t.points3D)
    for pid, p in j.points3D.items():
        q = t.points3D[pid]
        np.testing.assert_array_equal(q.image_ids, p.image_ids)
        np.testing.assert_array_equal(q.point2D_idxs, p.point2D_idxs)
        np.testing.assert_allclose(q.xyz, p.xyz, rtol=0, atol=atol)
    for cid, c in j.cameras.items():
        np.testing.assert_allclose(t.cameras[cid].params, c.params,
                                   rtol=1e-9)


def test_whole_mapper_matches_sba_tpu(mapped, ws):
    """The initial pair, the registration order and the counts equal;
    poses and points within 1e-6 of the scene's scale (measured: ~4e-11
    of it)."""
    (jm,), (tm,) = mapped["jm"], mapped["tm"]
    assert jm.rec.registered_image_ids == tm.rec.registered_image_ids
    assert tm.init_pair[:2] == tuple(jm.rec.registered_image_ids[:2])
    assert tm.rec.num_registered_images() == 8
    assert jm.rec.num_points3d() == tm.rec.num_points3d() > 150
    assert_same_model(jm.rec, tm.rec, 1e-6 * _scale(jm.rec))
    assert tm.rec.compute_mean_reprojection_error() < 1.0
    assert tm.stats["local_ba"] > 0 and tm.stats["global_ba"] > 0


def test_mapper_command_matches_sba_tpu(mapped):
    """The written models are equal, and the port prints sba_tpu's lines
    and its own account of the run."""
    j, t = mapped["j"], mapped["t"]
    assert_same_model(j, t, 1e-6 * _scale(j))
    out = mapped["out"]
    assert "loaded 8 images, " in out
    assert f"model 0: 8 images, {t.num_points3d()} points -> " in out
    assert "registrations/s); BA " in out and "[cpu]" in out
    assert "[registered] {'model': 0, 'image_id': " in out


@pytest.fixture(scope="module")
def partial(mapped, ws):
    """The sba_tpu model with its last three registered images
    deregistered, written once for both packages."""
    root, _ = ws
    rec = JRec.read(str(root / "j_sparse" / "0"))
    order = mapped["jm"][0].rec.registered_image_ids
    for iid in order[-3:]:
        rec.deregister_image(iid)
    path = root / "partial"
    path.mkdir()
    rec.write(str(path))
    return path, order[-3:]


def test_resume_matches_sba_tpu(partial, ws):
    root, _ = ws
    path, dropped = partial
    jm, tm = [], []
    with mappers(jm, tm):
        run_both("mapper", dict(
            MAPPER_FLAGS, database_path=str(root / "db.db"),
            input_path=str(path), output_path=str(root / "@_resumed")))
    assert jm[0].rec.registered_image_ids == tm[0].rec.registered_image_ids
    assert sorted(jm[0].rec.registered_image_ids[-3:]) == sorted(dropped)
    j = JRec.read(str(root / "j_resumed" / "0"))
    t = TRec.read(str(root / "t_resumed" / "0"))
    assert t.num_registered_images() == 8
    assert_same_model(j, t, 1e-6 * _scale(j))


def test_image_registrator_matches_sba_tpu(partial, ws):
    """P3P registration and refinement alone (no BA): 1e-9."""
    root, _ = ws
    path, dropped = partial
    with mappers([], []):
        out = run_both("image_registrator", dict(
            MAPPER_FLAGS, database_path=str(root / "db.db"),
            input_path=str(path), output_path=str(root / "@_reg")))
    assert "registered 3 additional images" in out
    j = JRec.read(str(root / "j_reg"))
    t = TRec.read(str(root / "t_reg"))
    assert sorted(set(t.images) - set(TRec.read(str(path)).images)) == \
        sorted(dropped)
    assert_same_model(j, t, 1e-9 * _scale(j))


def test_point_triangulator_matches_sba_tpu(ws):
    """Points triangulated against the true poses (a model without points
    over the database's keypoints): equal tracks, points at 1e-9."""
    from sba_tpu.io.colmap_models import Camera, Image

    root, (qvecs, tvecs, _pts) = ws
    db = j_db.Database(str(root / "db.db"))
    rec = JRec()
    for cid, c in db.read_cameras().items():
        rec.add_camera(Camera(cid, c["model_id"], c["width"], c["height"],
                              np.asarray(c["params"])))
    for k, (iid, im) in enumerate(sorted(db.read_images().items())):
        kp = db.read_keypoints(iid)
        rec.add_image(Image(iid, qvecs[k], tvecs[k], im["camera_id"],
                            im["name"], np.asarray(kp[:, :2], np.float64),
                            np.full(len(kp), -1, np.int64)), registered=True)
    db.close()
    rec.write(str(root / "gt"))
    out = run_both("point_triangulator", dict(
        database_path=str(root / "db.db"), input_path=str(root / "gt"),
        output_path=str(root / "@_tri")))
    j = JRec.read(str(root / "j_tri"))
    t = TRec.read(str(root / "t_tri"))
    assert f"{t.num_points3d()} points -> " in out
    assert t.num_points3d() > 150
    assert_same_model(j, t, 1e-9)


def test_automatic_reconstructor_equals_the_commands(tmp_path):
    """--dense 0 on four rendered views equals database_creator,
    feature_extractor, exhaustive_matcher and mapper run in a row with
    the same flags (on the CPU, the same generator draws)."""
    from sba_tpu_torch.utils.render import render_scene, write_scene_images

    scene = render_scene(num_images=4, image_size=(320, 240),
                         focal=1.2 * 320, seed=3, device="cpu")
    write_scene_images(scene, str(tmp_path / "imgs"))
    flags = ["--device", "cpu", "--TwoViewGeometry.max_num_trials", "256",
             "--Mapper.init_min_num_inliers", "40"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert t_cli.main(["automatic_reconstructor", "--workspace_path",
                           str(tmp_path / "auto"), "--image_path",
                           str(tmp_path / "imgs"), "--dense", "0"]
                          + flags) == 0
        db = str(tmp_path / "db.db")
        for cmd in (["database_creator"],
                    ["feature_extractor", "--image_path",
                     str(tmp_path / "imgs")],
                    ["exhaustive_matcher"],
                    ["mapper", "--output_path", str(tmp_path / "sparse")]):
            assert t_cli.main(cmd + ["--database_path", db] + flags) == 0
    assert "automatic reconstruction complete" in buf.getvalue()
    a = TRec.read(str(tmp_path / "auto" / "sparse" / "0"))
    b = TRec.read(str(tmp_path / "sparse" / "0"))
    assert a.num_registered_images() == 4 and a.num_points3d() > 50
    assert_same_model(b, a, 0.0)


def test_automatic_reconstructor_dense_raises(tmp_path):
    """--dense 1 with a mesher other than poisson or delaunay fails
    before any work, with sba_tpu's message."""
    with pytest.raises(SystemExit, match="Invalid `mesher`"):
        t_cli.main(["automatic_reconstructor", "--workspace_path",
                    str(tmp_path / "ws"), "--image_path", str(tmp_path),
                    "--dense", "1", "--mesher", "marching", "--device",
                    "cpu"])
    assert not (tmp_path / "ws").exists()


def test_automatic_reconstructor_dense_runs_the_chain(tmp_path):
    """--dense 1 on four rendered views of one camera goes on through
    image_undistorter, patch_match_stereo (a short photometric search),
    stereo_fuser and the Delaunay mesher; its mesh is the one
    delaunay_mesher writes on the same dense workspace. (One camera:
    patch_match_stereo stacks each view's sources, which needs one
    undistorted size, in sba_tpu as in the port.)"""
    from sba_tpu_torch.utils.render import render_scene, write_scene_images

    scene = render_scene(num_images=4, image_size=(320, 240),
                         focal=1.2 * 320, seed=3, device="cpu")
    write_scene_images(scene, str(tmp_path / "imgs"))
    ws = tmp_path / "auto"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert t_cli.main([
            "automatic_reconstructor", "--workspace_path", str(ws),
            "--image_path", str(tmp_path / "imgs"), "--dense", "1",
            "--mesher", "delaunay", "--device", "cpu",
            "--ImageReader.single_camera", "1",
            "--TwoViewGeometry.max_num_trials", "256",
            "--Mapper.init_min_num_inliers", "40",
            "--PatchMatchStereo.window_radius", "1",
            "--PatchMatchStereo.num_iterations", "2",
            "--PatchMatchStereo.num_random_samples", "1",
            "--PatchMatchStereo.geom_consistency", "false"]) == 0
        assert t_cli.main(["delaunay_mesher", "--input_path",
                           str(ws / "dense"), "--output_path",
                           str(tmp_path / "again.ply"), "--device",
                           "cpu"]) == 0
    out = buf.getvalue()
    assert "automatic reconstruction complete" in out
    maps = os.listdir(ws / "dense" / "stereo" / "depth_maps")
    assert len([m for m in maps if m.endswith(".photometric.bin")]) == 4
    assert (ws / "dense" / "fused.ply").exists()
    mesh = (ws / "dense" / "meshed-delaunay.ply").read_bytes()
    assert mesh == (tmp_path / "again.ply").read_bytes()
    assert int(mesh.split(b"element vertex ")[1].split()[0]) > 0


@pytest.mark.parametrize("command", ["mapper", "point_triangulator",
                                     "image_registrator",
                                     "automatic_reconstructor"])
def test_new_commands_need_a_card(command, ws, tmp_path, monkeypatch):
    """Without a card and without --device cpu each new command fails
    before it writes anything; nothing falls back to the CPU."""
    root, _ = ws
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = {"mapper": ["--database_path", str(root / "db.db")],
             "point_triangulator": ["--database_path", str(root / "db.db"),
                                    "--input_path", str(root)],
             "image_registrator": ["--database_path", str(root / "db.db"),
                                   "--input_path", str(root)],
             "automatic_reconstructor": ["--image_path", str(root)]}[command]
    out = tmp_path / "out"
    path_flag = ("--workspace_path" if command == "automatic_reconstructor"
                 else "--output_path")
    with pytest.raises(SystemExit, match="no CUDA device"):
        t_cli.main([command] + flags + [path_flag, str(out)])
    assert not out.exists()


def test_live_viewer_path_raises(tmp_path):
    """`Mapper.live_viewer_path` (which used to raise NotImplementedError)
    writes the live page once and the state after every registration, as
    sba_tpu's controller does: sba_tpu's page, and a last state whose
    revision and registered count are the model's. sba_tpu's mapper
    command rejects the flag (its `apply_flags` takes it for an
    IncrementalMapperOptions field); the port's takes it."""
    import json

    from sba_tpu import viewer as j_viewer

    db = j_db.Database(str(tmp_path / "db.db"))
    write_ring_scene(db, n_images=5, n_points=120)
    db.close()
    flags = dict(MAPPER_FLAGS, database_path=str(tmp_path / "db.db"),
                 output_path=str(tmp_path / "sparse"),
                 **{"Mapper.live_viewer_path": str(tmp_path / "live")})
    with pytest.raises(ValueError, match="live_viewer_path"):
        j_cli.run_mapper(flags)
    args = ["mapper", "--device", "cpu"]
    for k, v in flags.items():
        args += ["--" + k, v]
    with contextlib.redirect_stdout(io.StringIO()):
        assert t_cli.main(args) == 0
    j_viewer.export_live_viewer(str(tmp_path))
    assert (tmp_path / "live" / "live.html").read_bytes() == \
        (tmp_path / "live.html").read_bytes()
    st = json.loads((tmp_path / "live" / "state.json").read_text())
    rec = TRec.read(str(tmp_path / "sparse" / "0"))
    assert st["num_registered"] == st["revision"] \
        == rec.num_registered_images() >= 4
    assert len(st["cameras"]) == rec.num_registered_images()
