"""The model and image tools, the spatial, file-list and transitive
matchers, feature_importer and project_generator (19 commands), each
through both CLIs on the same toy model, images or database (modelled on
tests/test_cli_model_tools.py and tests/test_cli.py's model tools and
project.ini round trip).

Tolerances: exporter files and written models byte for byte (the same
float64 host code); poses after alignment at 1e-12; undistorted pixels
within one gray level (the port warps in float64 on the device, sba_tpu
in float32 on its CPU device), 99.9% of them equal. The matchers are
held on the image pairs each command selects (both packages' commands
run with their matching stubbed out; the matching and verification they
share are held in tests/test_torch_frontend.py), then the port's
commands run for real on the CPU.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from sba_tpu import cli as jcli
from sba_tpu_torch import cli as tcli
from sba_tpu_torch.geometry.quaternions import (np_angle_axis_to_quat,
                                                np_quat_to_rotmat)
from sba_tpu_torch.io.database import Database
from sba_tpu_torch.models.reconstruction import Reconstruction as TRec

from test_torch_viewer_io import same_files, write_toy_model

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_both(tmp, cmd, flags, device=False, outs=("j", "t")):
    """Run `cmd` through sba_tpu's and the port's COMMANDS; "{out}" in a
    flag value becomes the per-package name. Returns both captured
    stdouts, the per-package names put back as "{out}"."""
    import contextlib
    import io

    texts = []
    for tag, mod in zip(outs, (jcli, tcli)):
        os.makedirs(tmp / tag, exist_ok=True)
        f = {k: v.replace("{out}", str(tmp / tag)) for k, v in flags.items()}
        if device and mod is tcli:
            f["device"] = "cpu"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.COMMANDS[cmd](f)
        texts.append(buf.getvalue().replace(str(tmp / tag), "{out}"))
    return texts


def same_dirs(a, b):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb, (fa, fb)
    for n in fa:
        if os.path.isdir(os.path.join(a, n)):
            same_dirs(os.path.join(a, n), os.path.join(b, n))
        else:
            same_files(os.path.join(a, n), os.path.join(b, n))


def poses(path):
    rec = TRec.read(path)
    return np.concatenate([np.concatenate([rec.images[i].qvec,
                                           rec.images[i].tvec])
                           for i in sorted(rec.images)]), \
        np.stack([rec.points3D[p].xyz for p in sorted(rec.points3D)])


@pytest.fixture
def toy(tmp_path):
    model = write_toy_model(tmp_path / "model",
                            images_dir=str(tmp_path / "images"))
    return tmp_path, model, str(tmp_path / "images")


CONVERT = ["BIN", "TXT", "PLY", "NVM", "BUNDLER", "CAM", "R3D", "VRML"]


@pytest.mark.parametrize("output_type", CONVERT)
def test_model_converter(toy, output_type):
    tmp, model, _ = toy
    run_both(tmp, "model_converter", {
        "input_path": model, "output_path": "{out}/m",
        "output_type": output_type})
    same_dirs(tmp / "j", tmp / "t")
    assert os.listdir(tmp / "t")


def test_model_analyzer(toy):
    tmp, model, _ = toy
    out_j, out_t = run_both(tmp, "model_analyzer", {"input_path": model})
    assert out_t == out_j and "Registered images: 4" in out_t


def _similar_copy(src, dst, s, aa, t):
    """The model moved by the similarity x -> s R(aa) x + t."""
    from sba_tpu_torch.estimators.coordinate_frame import (
        transform_reconstruction)

    rec = TRec.read(src)
    transform_reconstruction(rec, s, np_quat_to_rotmat(
        np_angle_axis_to_quat(aa)), np.asarray(t, float))
    os.makedirs(dst, exist_ok=True)
    rec.write(dst)


def test_model_aligner_and_comparer(toy):
    tmp, model, _ = toy
    moved = str(tmp / "moved")
    _similar_copy(model, moved, 1.7, [0.1, -0.3, 0.2], [1.0, 2.0, -3.0])
    run_both(tmp, "model_aligner", {"input_path": moved,
                                    "ref_model_path": model,
                                    "output_path": "{out}"})
    (qj, xj), (qt, xt) = poses(str(tmp / "j")), poses(str(tmp / "t"))
    np.testing.assert_allclose(qt, qj, atol=1e-12)
    np.testing.assert_allclose(xt, xj, atol=1e-12)
    np.testing.assert_allclose(xt, poses(model)[1], atol=1e-9)
    out_j, out_t = run_both(tmp, "model_comparer", {"input_path1": moved,
                                                    "input_path2": model})
    assert out_t == out_j and "ATE max: 0.000000" in out_t


def test_model_orientation_aligner_image_orientation(toy):
    tmp, model, _ = toy
    run_both(tmp, "model_orientation_aligner", {
        "input_path": model, "output_path": "{out}",
        "method": "IMAGE-ORIENTATION"})
    (qj, xj), (qt, xt) = poses(str(tmp / "j")), poses(str(tmp / "t"))
    np.testing.assert_allclose(qt, qj, atol=1e-12)
    np.testing.assert_allclose(xt, xj, atol=1e-12)


def test_model_orientation_aligner_manhattan(tmp_path, monkeypatch):
    """MANHATTAN-WORLD on tests/test_lines_coordinate_frame.py's grid
    seen by a camera rolled 0.15 rad, with sba_tpu's vanishing-point draws
    in both: the same model at 1e-9, and the roll undone."""
    import jax

    from sba_tpu.optim import ransac as jransac
    from sba_tpu_torch.io.colmap_models import Camera, Image
    from sba_tpu_torch.optim import ransac as transac
    from test_torch_coordinate_frame import grid_image

    PILImage.fromarray(grid_image().astype(np.uint8)).save(
        tmp_path / "g.png")
    roll = np_angle_axis_to_quat([0.0, 0.0, 0.15])
    rec = TRec()
    rec.add_camera(Camera(1, 0, 320, 240, np.array([300.0, 160, 120])))
    rec.add_image(Image(1, roll, np.zeros(3), 1, "g.png", np.zeros((0, 2)),
                        np.zeros(0, np.int64)), registered=True)
    rec.add_point3d(np.array([0.0, 0.0, 5.0]), [])
    rec.write(str(tmp_path / "m"))

    def jax_draws(n, trials, s, **_):
        return torch.as_tensor(np.asarray(jransac.draw_samples(
            jax.random.PRNGKey(n), n, trials, s)))

    monkeypatch.setattr(transac, "draw_samples", jax_draws)
    run_both(tmp_path, "model_orientation_aligner", {
        "input_path": str(tmp_path / "m"), "output_path": "{out}",
        "image_path": str(tmp_path), "max_image_size": "512"}, device=True)
    (qj, xj), (qt, xt) = poses(str(tmp_path / "j")), \
        poses(str(tmp_path / "t"))
    np.testing.assert_allclose(qt, qj, atol=1e-9)
    np.testing.assert_allclose(xt, xj, atol=1e-9)
    R = np_quat_to_rotmat(qt[:4])
    assert abs(abs(R[0, 0]) - 1) < 1e-3 or abs(abs(R[0, 1]) - 1) < 1e-3


def test_model_transformer(toy):
    """A model and a PLY cloud, each undone by --is_inverse 1."""
    tmp, model, _ = toy
    tf = tmp / "tf.txt"
    R = np_quat_to_rotmat(np_angle_axis_to_quat([0.2, 0.1, -0.3]))
    m = np.concatenate([2.0 * R, [[1.0], [2.0], [3.0]]], 1)
    tf.write_text("\n".join(" ".join(f"{v:.17g}" for v in r) for r in m))
    run_both(tmp, "model_transformer", {
        "input_path": model, "output_path": "{out}/fwd",
        "transform_path": str(tf)})
    same_dirs(tmp / "j", tmp / "t")
    run_both(tmp, "model_transformer", {
        "input_path": "{out}/fwd", "output_path": "{out}/back",
        "transform_path": str(tf), "is_inverse": "1"})
    same_dirs(tmp / "j", tmp / "t")
    np.testing.assert_allclose(poses(str(tmp / "t" / "back"))[1],
                               poses(model)[1], atol=1e-12)
    from sba_tpu_torch.io.ply import read_ply, write_ply

    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(30, 3))
    write_ply(str(tmp / "in.ply"), xyz, rgb=rng.integers(0, 255, (30, 3)),
              normals=rng.normal(size=(30, 3)))
    run_both(tmp, "model_transformer", {
        "input_path": str(tmp / "in.ply"), "output_path": "{out}/o.ply",
        "transform_path": str(tf)})
    same_files(tmp / "j" / "o.ply", tmp / "t" / "o.ply")
    run_both(tmp, "model_transformer", {
        "input_path": "{out}/o.ply", "output_path": "{out}/b.ply",
        "transform_path": str(tf), "is_inverse": "1"})
    same_files(tmp / "j" / "b.ply", tmp / "t" / "b.ply")
    np.testing.assert_allclose(read_ply(str(tmp / "t" / "b.ply"))["xyz"],
                               xyz, atol=1e-5)


CROPS = {
    "crop-absolute": ("model_cropper", {"boundary": "-0.5,-0.5,-1,1,1,1"}),
    "crop-percentile": ("model_cropper", {"boundary": "0.1,0.9"}),
    "split-tiles": ("model_splitter", {"split_type": "tiles",
                                       "split_params": "0.8"}),
    "split-extent": ("model_splitter", {"split_type": "extent",
                                        "split_params": "1.0,1.0"}),
    "split-parts": ("model_splitter", {"split_type": "parts",
                                       "split_params": "3",
                                       "overlap_ratio": "0.1"}),
}


@pytest.mark.parametrize("case", list(CROPS))
def test_model_cropper_and_splitter(toy, case):
    tmp, model, _ = toy
    cmd, extra = CROPS[case]
    flags = dict(extra, input_path=model, output_path="{out}",
                 min_reg_images="1", min_num_points="1")
    out_j, out_t = run_both(tmp, cmd, flags)
    assert out_t == out_j
    same_dirs(tmp / "j", tmp / "t")
    assert os.listdir(tmp / "t")


@pytest.mark.parametrize("split_type", ["tiles", "extent"])
def test_model_splitter_loses_upper_face_points(tmp_path, split_type):
    """A box ends at lo + k * size in floating point, so a point on the
    bounding box's upper face can fall just outside the last box: sba_tpu
    loses such points, and the port loses the same ones (ROADMAP Queue 3).
    The toy's points are shifted to an offset where this happens."""
    rec = TRec.read(write_toy_model(tmp_path / "toy"))
    for p in rec.points3D.values():
        p.xyz = p.xyz + np.array([1.3, -0.6, 0.5])
    model = tmp_path / "model"
    model.mkdir()
    rec.write(str(model))
    lo, hi = rec.compute_bounding_box(0.0, 1.0)
    ext = hi - lo
    params = ",".join(f"{v / 2:.17g}" for v in ext[:2])
    if split_type == "extent":
        params += f",{ext[2]:.17g}"
    out_j, out_t = run_both(tmp_path, "model_splitter", {
        "input_path": str(model), "output_path": "{out}",
        "split_type": split_type, "split_params": params,
        "min_reg_images": "1", "min_num_points": "1"})
    assert out_t == out_j
    same_dirs(tmp_path / "j", tmp_path / "t")
    kept = {tuple(p.xyz) for d in os.listdir(tmp_path / "t")
            for p in TRec.read(str(tmp_path / "t" / d)).points3D.values()}
    lost = [p.xyz for p in rec.points3D.values() if tuple(p.xyz) not in kept]
    assert lost and all((x == hi).any() for x in lost), lost


@pytest.mark.parametrize("cmd", ["color_extractor", "point_filtering",
                                 "image_deleter", "image_filterer"])
def test_model_edit_commands(toy, cmd):
    tmp, model, images = toy
    flags = {"input_path": model, "output_path": "{out}"}
    if cmd == "color_extractor":
        flags["image_path"] = images
    elif cmd == "point_filtering":
        flags.update(max_reproj_error="0.5", min_track_len="4")
    elif cmd == "image_deleter":
        (tmp / "ids.txt").write_text("2\n99\n")
        (tmp / "names.txt").write_text("im3.png\nnope.png\n")
        flags.update(image_ids_path=str(tmp / "ids.txt"),
                     image_names_path=str(tmp / "names.txt"))
    else:
        flags.update(min_num_observations="41")
    out_j, out_t = run_both(tmp, cmd, flags,
                            device=cmd == "color_extractor")
    assert out_t.replace(" [cpu]", "") == out_j
    same_dirs(tmp / "j", tmp / "t")


def test_image_undistorter_standalone(toy):
    tmp, _, images = toy
    (tmp / "cams.txt").write_text(
        "im0.png SIMPLE_RADIAL 64 48 60 32 24 -0.05\n"
        "im1.png OPENCV 64 48 60 58 31 25 0.02 -0.01 0.001 0.002\n")
    out_j, out_t = run_both(tmp, "image_undistorter_standalone", {
        "input_file": str(tmp / "cams.txt"), "image_path": images,
        "output_path": "{out}"}, device=True)
    for n in ("im0.png", "im1.png"):
        a = np.asarray(PILImage.open(tmp / "j" / n), int)
        b = np.asarray(PILImage.open(tmp / "t" / n), int)
        assert a.shape == b.shape
        d = np.abs(a - b)
        assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                           (d == 0).mean())


def test_project_generator_roundtrip(tmp_path):
    """project.ini from both CLIs: the sections the two packages' option
    classes share read back equal, and flags_from_ini round-trips them;
    `--project_path` feeds the file's flags to a command."""
    from sba_tpu.options import read_project_ini as jread
    from sba_tpu_torch.options import flags_from_ini, read_project_ini

    run_both(tmp_path, "project_generator", {
        "output_path": "{out}.ini", "database_path": "db.db",
        "image_path": "imgs"})
    it, ij = read_project_ini(str(tmp_path / "t.ini")), \
        jread(str(tmp_path / "j.ini"))
    assert sorted(it) == sorted(ij)
    for sec in ("DEFAULT", "SiftExtraction", "SiftMatching"):
        assert it[sec] == ij[sec], sec
    common = set(it["BundleAdjustment"]) & set(ij["BundleAdjustment"])
    assert len(common) >= 10
    for k in common:
        assert it["BundleAdjustment"][k] == ij["BundleAdjustment"][k], k
    flags = flags_from_ini(it)
    assert flags["SiftExtraction.max_num_features"] == "8192"
    assert flags["database_path"] == "db.db"
    # --project_path: model_analyzer takes its input_path from the file.
    model = write_toy_model(tmp_path / "model")
    with open(tmp_path / "p.ini", "w") as f:
        f.write(f"[DEFAULT]\ninput_path = {model}\n")
    assert tcli.main(["model_analyzer", "--project_path",
                      str(tmp_path / "p.ini")]) == 0


def test_model_viewer(toy, capsys):
    """The HTML page byte for byte, its JSON payload parses; `--follow`
    serves a live directory on localhost."""
    tmp, model, _ = toy
    run_both(tmp, "model_viewer", {"input_path": model,
                                   "output_path": "{out}.html",
                                   "ModelViewer.max_points": "25"})
    same_files(tmp / "j.html", tmp / "t.html")
    html = (tmp / "t.html").read_text()
    cams = json.loads(html.split("let CAMS = ")[1].split(";\n")[0])
    assert len(cams) == 4
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    live = tmp / "live"
    proc = subprocess.Popen(
        [sys.executable, "-m", "sba_tpu_torch.cli", "model_viewer",
         "--follow", str(live), "--port", str(port)], cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        body = b""
        for _ in range(100):
            try:
                body = urllib.request.urlopen(
                    f"http://localhost:{port}/live.html", timeout=2).read()
                break
            except OSError:
                time.sleep(0.1)
        assert b"state.json" in body
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# ---------------------------------------------------------------------------
# the database commands: matchers and the feature importer
# ---------------------------------------------------------------------------


def write_match_database(path, n_images=6, n_points=160, seed=9):
    """Ring views of a point cloud: keypoints at the projections, each
    point's descriptor a random u8 vector with a little noise per view,
    the camera centers as position priors."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_points, 3))
    desc = rng.integers(0, 200, (n_points, 128))
    db = Database(path)
    cid = db.write_camera(model_id=0, width=160, height=120,
                          params=[150.0, 80, 60])
    for k in range(n_images):
        q = np_angle_axis_to_quat([0.0, 0.25 * k - 0.6, 0.0])
        R = np_quat_to_rotmat(q)
        c = np.array([2.0 * np.sin(0.25 * k - 0.6), 0.0,
                      -5.0 * np.cos(0.25 * k - 0.6)])
        pc = (pts - c) @ R.T
        xy = pc[:, :2] / pc[:, 2:] * 150.0 + [80, 60]
        iid = db.write_image(f"v{k}.png", cid, prior_t=tuple(c))
        db.write_keypoints(iid, np.concatenate(
            [xy, np.ones((n_points, 1)), np.zeros((n_points, 1))],
            1).astype(np.float32))
        d = np.clip(desc + rng.integers(-3, 4, desc.shape), 0, 255)
        db.write_descriptors(iid, d.astype(np.uint8))
    db.commit()
    db.close()


MATCHERS = {
    "spatial_matcher": {"SpatialMatching.max_num_neighbors": "2",
                        "SpatialMatching.max_distance": "1.5"},
    "matches_importer": {"match_list_path": "{list}"},
    "transitive_matcher": {"TransitiveMatching.num_iterations": "2"},
}
FAST = {"TwoViewGeometry.max_num_trials": "256", "SiftMatching.batch_size":
        "8"}


@pytest.mark.parametrize("cmd", list(MATCHERS))
def test_matchers(tmp_path, monkeypatch, cmd):
    db = str(tmp_path / "db.db")
    write_match_database(db)
    (tmp_path / "list.txt").write_text("v0.png v3.png\nv5.png v1.png\n"
                                       "v2.png v4.png\n")
    if cmd == "transitive_matcher":
        d = Database(db)
        ids = sorted(d.read_images())
        for a, b in zip(ids[:-1], ids[1:]):
            d.write_matches(a, b, np.stack([np.arange(20)] * 2, 1)
                            .astype(np.uint32))
        d.commit()
        d.close()
    flags = {k: v.replace("{list}", str(tmp_path / "list.txt"))
             for k, v in MATCHERS[cmd].items()}
    seen = {}
    for tag, mod in (("j", jcli), ("t", tcli)):
        calls = seen.setdefault(tag, [])
        monkeypatch.setattr(mod, "_match_and_verify",
                            lambda _db, pairs, ids, _f, c=calls:
                            c.append(np.asarray(pairs).tolist()) or 0)
        mod.COMMANDS[cmd](dict(flags, database_path=db))
    assert seen["t"] == seen["j"] and seen["t"] and seen["t"][0]
    monkeypatch.undo()
    tcli.COMMANDS[cmd]({**flags, **FAST, "database_path": db,
                        "device": "cpu"})
    d = Database(db)
    ids = sorted(d.read_images())
    written = {tuple(sorted(p)) for p in d.read_all_matches()}
    geoms = d.read_all_two_view_geometries()
    d.close()
    for a, b in seen["t"][0]:
        assert tuple(sorted((ids[a], ids[b]))) in written
    assert len(geoms) >= len(seen["t"][0])


def test_feature_importer(toy):
    """Features exported as text by the port's database go back in
    through both packages' importers: the same database rows, and the
    same keypoints and descriptors as the source."""
    from sba_tpu.io.database import Database as JDatabase

    tmp, _, images = toy
    rng = np.random.default_rng(6)
    imp = tmp / "feats"
    imp.mkdir()
    src = {}
    for i in range(3):
        kp = rng.uniform(0, 40, (7, 4)).astype(np.float32)
        d = rng.integers(0, 255, (7, 128)).astype(np.uint8)
        src[f"im{i}.png"] = (kp, d)
        rows = [" ".join([f"{v:.9g}" for v in kp[r]]
                         + [str(int(v)) for v in d[r]]) for r in range(7)]
        (imp / f"im{i}.png.txt").write_text("7 128\n" + "\n".join(rows))
    run_both(tmp, "feature_importer", {
        "database_path": "{out}.db", "image_path": images,
        "import_path": str(imp), "ImageReader.single_camera": "1"})
    dj, dt = JDatabase(str(tmp / "j.db")), Database(str(tmp / "t.db"))
    assert dt.read_images() == dj.read_images()
    assert len(dt.read_images()) == 3
    cj, ct = dj.read_cameras(), dt.read_cameras()
    assert sorted(cj) == sorted(ct)
    for c in cj:
        np.testing.assert_array_equal(ct[c]["params"], cj[c]["params"])
    for iid, im in dt.read_images().items():
        kp, d = src[im["name"]]
        np.testing.assert_array_equal(dt.read_keypoints(iid), kp)
        np.testing.assert_array_equal(dt.read_descriptors(iid), d)
        np.testing.assert_array_equal(dj.read_keypoints(iid), kp)
    dj.close()
    dt.close()
