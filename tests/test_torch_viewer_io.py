"""The port's viewer, PLY and model exporters, native loader, profiling
and host helpers against sba_tpu on the CPU: files byte for byte on the
same inputs, decoded images bit for bit."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from sba_tpu import viewer as jv
from sba_tpu.io import colmap_models as jcm
from sba_tpu.io import native_loader as jn
from sba_tpu.io import ply as jply
from sba_tpu.models.reconstruction import Reconstruction as JRec
from sba_tpu.utils import profiling as jprof
from sba_tpu_torch import viewer as tv
from sba_tpu_torch.geometry.quaternions import (np_angle_axis_to_quat,
                                                np_quat_conjugate,
                                                np_quat_to_rotmat)
from sba_tpu_torch.io import colmap_models as tcm
from sba_tpu_torch.io import maps as tmaps
from sba_tpu_torch.io import native_loader as tn
from sba_tpu_torch.io import ply as tply
from sba_tpu_torch.models.reconstruction import Reconstruction as TRec
from sba_tpu_torch.utils import host as thost
from sba_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)


def write_toy_model(path, model_id=2, params=(60.0, 32, 24, 0.01),
                    n_img=4, n_pts=40, seed=0, images_dir=None):
    """A small scene (ring of cameras around a point cloud) written as a
    COLMAP model through the port's writer; RGB images when asked."""
    rng = np.random.default_rng(seed)
    rec = TRec()
    rec.add_camera(tcm.Camera(1, model_id, 64, 48, np.array(params)))
    pts = rng.uniform(-1, 1, (n_pts, 3))
    for i in range(n_img):
        q = np_angle_axis_to_quat([0.05 * i, 0.3 * i - 0.4, 0.02])
        R = np_quat_to_rotmat(q)
        t = np.array([0.1 * i, -0.05, 5.0])
        pc = pts @ R.T + t
        xy = pc[:, :2] / pc[:, 2:] * params[0] + params[1:3]
        rec.add_image(tcm.Image(i + 1, q, t, 1, f"im{i}.png", xy,
                                np.full(n_pts, -1, np.int64)),
                      registered=True)
        if images_dir is not None:
            os.makedirs(images_dir, exist_ok=True)
            PILImage.fromarray(rng.integers(0, 255, (48, 64, 3),
                                            dtype=np.uint8)).save(
                os.path.join(images_dir, f"im{i}.png"))
    for p in range(n_pts):
        rec.add_point3d(pts[p], [(i + 1, p) for i in range(n_img)],
                        rgb=tuple(int(v) for v in rng.integers(0, 255, 3)),
                        error=float(rng.uniform(0, 1)))
    os.makedirs(path, exist_ok=True)
    rec.write(str(path))
    return str(path)


def same_files(a, b):
    assert open(a, "rb").read() == open(b, "rb").read(), (a, b)


@pytest.fixture
def model(tmp_path):
    return write_toy_model(tmp_path / "model", images_dir=str(
        tmp_path / "images")), str(tmp_path / "images")


@pytest.mark.parametrize("color_mode", ["rgb", "height", "uniform"])
def test_html_viewer(model, tmp_path, color_mode):
    """The page of tests/test_viewer.py, byte for byte, and its JSON
    payload parses."""
    path, _ = model
    kw = dict(max_points=30, color_mode=color_mode, animate=True,
              point_size=2.0, background="#222")
    jv.export_html_viewer(JRec.read(path), str(tmp_path / "j.html"), **kw)
    tv.export_html_viewer(TRec.read(path), str(tmp_path / "t.html"), **kw)
    same_files(tmp_path / "j.html", tmp_path / "t.html")
    html = (tmp_path / "t.html").read_text()
    pts = json.loads(html.split("let PTS = ")[1].split(";\n")[0])
    assert len(pts) == 30


def test_live_viewer_state(model, tmp_path):
    path, _ = model
    for mod, rec, d in ((jv, JRec.read(path), tmp_path / "j"),
                        (tv, TRec.read(path), tmp_path / "t")):
        d.mkdir()
        mod.export_live_viewer(str(d))
        rec.deregister_image(2)
        mod.export_viewer_state(rec, str(d), revision=3)
    for f in ("live.html", "state.json"):
        same_files(tmp_path / "j" / f, tmp_path / "t" / f)
    s = json.loads((tmp_path / "t" / "state.json").read_text())
    assert s["revision"] == 3 and s["num_registered"] == 3


def test_model_exports(model, tmp_path):
    """tests/test_model_io.py's export formats (SIMPLE_RADIAL, so every
    Bundler-family writer takes it) and the PLY export, both packages."""
    path, _ = model
    for tag, rec in (("j", JRec.read(path)), ("t", TRec.read(path))):
        d = tmp_path / tag
        d.mkdir()
        assert rec.export_nvm(str(d / "m.nvm"))
        assert rec.export_cam(str(d))
        assert rec.export_recon3d(str(d))
        rec.export_vrml(str(d / "i.wrl"), str(d / "p.wrl"), image_scale=2.0)
        rec.export_ply(str(d / "m.ply"))
        (jcm if tag == "j" else tcm).export_ply(rec.points3D,
                                                str(d / "p.ply"))
    names = ["m.nvm", "i.wrl", "p.wrl", "m.ply", "p.ply",
             "Recon/synth_0.out", "Recon/urd-images.txt",
             "Recon/imagemap_0.txt"] + [f"im{i}.cam" for i in range(4)]
    for n in names:
        same_files(tmp_path / "j" / n, tmp_path / "t" / n)


def test_bounding_box_crop_and_colors(model):
    path, images = model
    rj, rt = JRec.read(path), TRec.read(path)
    for p0, p1 in ((0.0, 1.0), (0.1, 0.9)):
        for a, b in zip(rt.compute_bounding_box(p0, p1),
                        rj.compute_bounding_box(p0, p1)):
            np.testing.assert_array_equal(a, b)
    box = rj.compute_bounding_box(0.2, 0.8)
    cj, ct = rj.crop(box), rt.crop(box)
    assert sorted(ct.points3D) == sorted(cj.points3D)
    assert ct.registered_image_ids == cj.registered_image_ids
    for pid in cj.points3D:
        np.testing.assert_array_equal(ct.points3D[pid].xyz,
                                      cj.points3D[pid].xyz)
    rt.deregister_image(3)
    rj.deregister_image(3)
    assert rt.extract_colors(images, device="cpu") == \
        rj.extract_colors(images)
    for pid in rj.points3D:
        np.testing.assert_array_equal(rt.points3D[pid].rgb,
                                      rj.points3D[pid].rgb)
    assert TRec().compute_bounding_box()[0].shape == (3,)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_read_write(tmp_path, binary):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(20, 3))
    rgb = rng.integers(0, 255, (20, 3))
    nrm = rng.normal(size=(20, 3))
    tply.write_ply(str(tmp_path / "t.ply"), xyz, rgb=rgb, normals=nrm,
                   binary=binary)
    jply.write_ply(str(tmp_path / "j.ply"), xyz, rgb=rgb, normals=nrm,
                   binary=binary)
    same_files(tmp_path / "t.ply", tmp_path / "j.ply")
    a, b = tply.read_ply(str(tmp_path / "t.ply")), \
        jply.read_ply(str(tmp_path / "t.ply"))
    assert sorted(a) == sorted(b) == ["normals", "rgb", "xyz"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    (tmp_path / "bad.ply").write_bytes(b"nope\n")
    with pytest.raises(ValueError):
        tply.read_ply(str(tmp_path / "bad.ply"))


def _write_pgm(path, arr):
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(arr.astype(np.uint8).tobytes())


def test_native_loader(tmp_path):
    """The port builds native/sba_native.cc into its own build directory
    and decodes as sba_tpu's binding does (tests/test_native_loader.py's
    PGM, PPM, float TIFF, resize, missing file, and the prefetcher)."""
    assert tn.is_available()
    assert os.path.dirname(tn._LIB_PATH) == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(tn.__file__))),
        "_build")
    rng = np.random.default_rng(2)
    paths = []
    for i in range(5):
        p = str(tmp_path / f"im{i}.pgm")
        _write_pgm(p, rng.integers(0, 255, (30 + i, 40)))
        paths.append(p)
    rgb = rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)
    PILImage.fromarray(rgb).save(tmp_path / "c.ppm")
    paths.append(str(tmp_path / "c.ppm"))
    fmap = rng.normal(size=(17, 23)).astype(np.float32)
    tmaps.write_float_map_tiff(fmap, str(tmp_path / "m.tiff"))
    paths.append(str(tmp_path / "m.tiff"))
    for p in paths:
        for ms in (0, 16):
            a = tn.decode_image_native(p, max_size=ms)
            b = jn.decode_image_native(p, max_size=ms)
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tmaps.read_float_map_tiff(str(tmp_path / "m.tiff")), fmap)
    np.testing.assert_array_equal(
        tmaps.read_float_map_tiff(str(tmp_path / "m.tiff")),
        np.asarray(PILImage.open(tmp_path / "m.tiff"), np.float32))
    assert tn.decode_image_native(str(tmp_path / "none.pgm")) is None
    assert tn.decode_image_native(str(tmp_path / "x.png")) is None
    with tn.PrefetchingImageLoader(paths[:5], num_threads=2) as loader:
        got = dict(loader)
    assert sorted(got) == list(range(5))
    for i in range(5):
        np.testing.assert_array_equal(got[i],
                                      jn.decode_image_native(paths[i]))


def test_timer_metrics_and_trace(tmp_path):
    """tests/test_misc_util.py's Timer and Metrics on both packages, and
    the port's torch.profiler trace."""
    for mod in (tprof, jprof):
        t = mod.Timer()
        assert t.elapsed_seconds() == 0.0
        t.start()
        t.pause()
        e = t.elapsed_seconds()
        assert e >= 0 and t.elapsed_seconds() == e
        t.resume()
        t.restart()
        assert t.elapsed_minutes() >= 0
    mt, mj = tprof.Metrics(), jprof.Metrics()
    for m in (mt, mj):
        with m.phase("a"):
            pass
        with m.phase("a"):
            pass
        m.set("x", 3)
        m.add("y")
        m.add("y", 2.5)
    dt, dj = mt.as_dict(), mj.as_dict()
    assert dt["values"] == dj["values"] == {"x": 3.0, "y": 3.5}
    assert dt["phases"]["a"]["count"] == dj["phases"]["a"]["count"] == 2
    mt.dump_json(str(tmp_path / "m.json"))
    assert json.load(open(tmp_path / "m.json"))["values"]["y"] == 3.5
    assert "a:" in mt.report()
    with tprof.torch_trace(str(tmp_path / "tr"), cuda=False) as prof:
        torch.ones(64) @ torch.ones(64)
    assert (tmp_path / "tr" / "trace.json").exists()
    assert len(prof.key_averages()) > 0


def test_host_helpers(tmp_path):
    from sba_tpu.utils import host as jhost

    assert thost.host_cpu_device() == torch.device("cpu")
    with thost.on_host():
        assert torch.zeros(1).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            thost.accel_device()
    a = thost.machine_cache_dir(str(tmp_path / "t"))
    b = jhost.machine_cache_dir(str(tmp_path / "j"))
    assert os.path.basename(a) == os.path.basename(b) and os.path.isdir(a)


def test_quat_conjugate():
    from sba_tpu.geometry.quaternions import np_quat_conjugate as jconj

    q = np.random.default_rng(3).normal(size=(5, 4))
    np.testing.assert_array_equal(np_quat_conjugate(q), jconj(q))
