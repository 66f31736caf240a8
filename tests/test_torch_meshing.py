"""The rest of the port's dense chain against sba_tpu on the CPU:
meshing (TSDF fusion, surface nets, the PLY writer) and its two mesher
commands, stereo rectification and image_rectifier, and the PMVS and
CMP-MVS workspaces of image_undistorter.

Inputs are seeded numpy depth maps and poses (and, for the commands, a
3-view 64x48 rendered workspace with its true depth maps), given to both
packages. float64 TSDFs agree to 1e-12; in float32 the two packages'
3-element products may round apart, which can move a voxel across a
pixel boundary, so float32 is held as a share of voxels.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from sba_tpu.mvs import meshing as jm
from sba_tpu_torch.mvs import meshing as tm


def _plane_views(n=4, H=40, W=50, f=40.0, seed=0, dtype=np.float64):
    """A tilted plane with seeded relief seen from `n` jittered cameras:
    (depths [n, H, W], Ks, qvecs, tvecs); one map has a hole."""
    rng = np.random.default_rng(seed)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    yy, xx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    depths = np.zeros((n, H, W))
    qvecs, tvecs = [], []
    for i in range(n):
        aa = rng.normal(0, 0.03, 3)
        q = np.concatenate([[1.0], 0.5 * aa])
        q /= np.linalg.norm(q)
        qvecs.append(q)
        tvecs.append(np.array([0.25 * (i - n / 2), 0.05 * i, 0.1])
                     + rng.normal(0, 0.02, 3))
        depths[i] = 2.0 + 0.3 * (xx - W / 2) / W + 0.2 * np.sin(yy / 7.0) \
            + 0.01 * rng.standard_normal((H, W))
    depths[1, 5:12, 8:20] = 0.0
    return (depths.astype(dtype), [K] * n, np.array(qvecs),
            np.array(tvecs))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tsdf_fuse_matches_sba_tpu(dtype):
    """float64: tsdf and weights at 1e-12. float32: equal weights and at
    least 99.9% of the voxels within 1e-5."""
    depths, Ks, q, t = _plane_views(dtype=dtype)
    opt = tm.TSDFOptions(voxel_size=0.04, truncation=0.12)
    jopt = jm.TSDFOptions(voxel_size=0.04, truncation=0.12)
    origin = np.array([-1.1, -0.9, 1.2])
    dims = (55, 45, 30)
    tj, wj = jm.tsdf_fuse(depths, Ks, q, t, origin, dims, jopt)
    tt, wt = tm.tsdf_fuse(depths, Ks, q, t, origin, dims, opt, device="cpu")
    assert tt.dtype == tj.dtype == dtype and tt.shape == tj.shape
    assert (wj > 0).mean() > 0.2 and wj.max() == 4
    if dtype == np.float64:
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-12)
        return
    share = (np.abs(tt - tj) <= 1e-5).mean()
    print(f"float32 tsdf: {share:.6f} of {tt.size} voxels within 1e-5, "
          f"weights differ at {(wt != wj).sum()}")
    np.testing.assert_array_equal(wt, wj)
    assert share >= 0.999


def test_mesh_from_depth_maps_and_ply_match_sba_tpu(tmp_path):
    """Grid bounds, vertices, faces and normals (1e-9) equal; the PLY
    writers give the same bytes; surface nets on an analytic sphere and
    an empty volume as sba_tpu's."""
    depths, Ks, q, t = _plane_views(seed=1)
    for vs in (0.05, 0.08):
        mj = jm.mesh_from_depth_maps(depths, Ks, q, t, jm.TSDFOptions(
            voxel_size=vs, truncation=0.2))
        mt = tm.mesh_from_depth_maps(depths, Ks, q, t, tm.TSDFOptions(
            voxel_size=vs, truncation=0.2), device="cpu")
        assert len(mt.vertices) == len(mj.vertices) > 50
        np.testing.assert_array_equal(mt.faces, mj.faces)
        np.testing.assert_allclose(mt.vertices, mj.vertices, rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(mt.normals, mj.normals, rtol=0,
                                   atol=1e-9)
    jm.write_mesh_ply(mj, tmp_path / "j.ply")
    tm.write_mesh_ply(mj, tmp_path / "t.ply")
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply"
                                                 ).read_bytes()

    xs = np.linspace(-1.5, 1.5, 24)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    sdf = (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 1.0).astype(np.float32)
    w = np.full_like(sdf, 10.0)
    w[:3] = 0.0     # a slab below min_weight
    for vol in (sdf, np.ones_like(sdf)):
        a = jm.surface_nets(vol, w, np.array([-1.5] * 3), xs[1] - xs[0])
        b = tm.surface_nets(vol, w, np.array([-1.5] * 3), xs[1] - xs[0])
        assert len(a.vertices) == len(b.vertices)
        np.testing.assert_array_equal(b.faces, a.faces)
        np.testing.assert_allclose(b.vertices, a.vertices, atol=1e-12)
        if a.normals is not None:
            np.testing.assert_allclose(b.normals, a.normals, atol=1e-12)
    assert tm.mesh_from_depth_maps(np.zeros((2, 8, 8)), Ks[:2], q[:2],
                                   t[:2], device="cpu").faces.shape == (0, 3)


def _mesh_workspace(tmp_path):
    """A 3-view 64x48 rendered workspace (sparse/ + stereo/) whose
    geometric depth maps are the true ones (float32, as the files)."""
    from sba_tpu_torch.mvs import write_colmap_map
    from sba_tpu_torch.utils.render import (gt_sparse_reconstruction,
                                            render_scene,
                                            write_scene_images)

    scene = render_scene(num_images=3, image_size=(64, 48), ring_radius=1.0,
                         jitter=0.05, seed=3, device="cpu")
    ws = tmp_path / "ws"
    names = write_scene_images(scene, str(ws / "images"))
    gt_sparse_reconstruction(scene, names, stride=8).write(str(ws / "sparse"))
    (ws / "stereo" / "depth_maps").mkdir(parents=True)
    for name, d in zip(names, scene["depths"]):
        write_colmap_map(d, str(ws / "stereo" / "depth_maps"
                                / f"{name}.geometric.bin"))
    return ws


def _read_mesh_ply(path):
    head, body = open(path).read().split("end_header\n")
    nv = int(head.split("element vertex ")[1].split()[0])
    rows = body.splitlines()
    v = np.array([[float(x) for x in r.split()] for r in rows[:nv]])
    f = np.array([[int(x) for x in r.split()[1:]] for r in rows[nv:]])
    return head, v.reshape(-1, 3), f.reshape(-1, 3)


@pytest.mark.parametrize("cmd", ["poisson_mesher", "delaunay_mesher"])
def test_mesher_commands_match_sba_tpu(tmp_path, cmd):
    """Both packages' command on the same workspace: the same header and
    faces, vertices within 1e-5 (float32 maps), and sba_tpu's printed
    line."""
    from sba_tpu import cli as jcli
    from sba_tpu_torch import cli as tcli

    ws = _mesh_workspace(tmp_path)
    flags = {"input_path": str(ws), "Meshing.voxel_size": "0.08",
             "Meshing.truncation": "0.24"}
    logs = {}
    for tag, mod, dev in (("j", jcli, {}), ("t", tcli, {"device": "cpu"})):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            mod.COMMANDS[cmd](dict(flags, output_path=str(
                tmp_path / f"{tag}.ply"), **dev))
        logs[tag] = log.getvalue().replace(f"{tag}.ply", "X.ply")
    hj, vj, fj = _read_mesh_ply(tmp_path / "j.ply")
    ht, vt, ft = _read_mesh_ply(tmp_path / "t.ply")
    assert ht == hj and len(vj) > 100
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)
    assert logs["t"].splitlines()[0] == logs["j"].splitlines()[0]


def test_mesher_needs_depth_maps_and_a_card(tmp_path):
    """The mesher fails with no card, with no depth maps, and on an
    option TSDFOptions does not have (sba_tpu's inert
    `--Meshing.space_carving`)."""
    from sba_tpu_torch import cli as tcli

    ws = _mesh_workspace(tmp_path)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["poisson_mesher", "--input_path", str(ws),
                   "--output_path", str(tmp_path / "m.ply")])
    for f in (ws / "stereo" / "depth_maps").iterdir():
        os.remove(f)
    with pytest.raises(SystemExit, match="no depth maps"):
        tcli.main(["delaunay_mesher", "--input_path", str(ws),
                   "--output_path", str(tmp_path / "m.ply"), "--device",
                   "cpu"])
    with pytest.raises(ValueError, match="--Meshing.space_carving"):
        tcli.main(["poisson_mesher", "--input_path", str(ws),
                   "--output_path", str(tmp_path / "m.ply"), "--device",
                   "cpu", "--Meshing.space_carving", "1"])


# ---------------------------------------------------------------------------
# Stereo rectification and the PMVS / CMP-MVS workspaces
# ---------------------------------------------------------------------------


def _cameras(model, params, w=64, h=48):
    from sba_tpu.geometry import camera_models as jcm
    from sba_tpu.io.colmap_models import Camera as JCamera
    from sba_tpu_torch.geometry import camera_models as tcm
    from sba_tpu_torch.io.colmap_models import Camera

    params = np.asarray(params, np.float64)
    return (JCamera(1, jcm.model_by_name(model).model_id, w, h, params),
            Camera(1, tcm.model_by_name(model).model_id, w, h, params))


@pytest.mark.parametrize("t", [(0.5, 0.03, -0.02), (-0.4, 0.1, 0.05),
                               (0.3, 0.0, 0.0)])
def test_rectify_stereo_cameras_matches_sba_tpu(t):
    """H1, H2, Q at 1e-12 (host float64), for a rightward, a leftward and
    an axis-aligned baseline; np_quat_to_angle_axis as sba_tpu's."""
    from sba_tpu.geometry import quaternions as jq
    from sba_tpu.geometry.undistortion import rectify_stereo_cameras as jr
    from sba_tpu_torch.geometry import quaternions as tq
    from sba_tpu_torch.geometry.undistortion import rectify_stereo_cameras

    rng = np.random.default_rng(0)
    c1 = _cameras("PINHOLE", [70.0, 72.0, 31.0, 25.0])
    c2 = _cameras("PINHOLE", [68.0, 69.0, 33.0, 22.0])
    for q in (np.array([1.0, 0, 0, 0]), tq.np_angle_axis_to_quat(
            rng.normal(0, 0.1, 3)), np.array([-0.9, 0.1, 0.3, 0.2])):
        np.testing.assert_allclose(tq.np_quat_to_angle_axis(q),
                                   jq.np_quat_to_angle_axis(q), atol=1e-15)
        for a, b in zip(jr(c1[0], c2[0], q, np.array(t)),
                        rectify_stereo_cameras(c1[1], c2[1], q,
                                               np.array(t))):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


@pytest.mark.parametrize("model,params", [
    ("SIMPLE_RADIAL", [70.0, 32.0, 24.0, -0.08]),
    ("OPENCV", [70.0, 72.0, 31.0, 25.0, -0.05, 0.01, 0.001, -0.002]),
])
def test_rectify_and_undistort_stereo_pair_matches_sba_tpu(model, params):
    """The two rectified images within 1e-9 of the image range, the
    undistorted camera and Q equal; the warp is float64 on the device
    (the Newton image_to_world of the lens)."""
    import jax.numpy as jnp

    from sba_tpu.geometry.undistortion import (
        rectify_and_undistort_stereo_pair as jrect)
    from sba_tpu_torch.geometry.quaternions import np_angle_axis_to_quat
    from sba_tpu_torch.geometry.undistortion import (
        rectify_and_undistort_stereo_pair)

    rng = np.random.default_rng(1)
    cj, ct = _cameras(model, params)
    imgs = [rng.random((48, 64, 3)) * 255 for _ in range(2)]
    q = np_angle_axis_to_quat(np.array([0.01, -0.05, 0.02]))
    t = np.array([0.4, 0.02, -0.03])
    a = jrect(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), cj, cj, q, t)
    b = rectify_and_undistort_stereo_pair(
        torch.as_tensor(imgs[0]), torch.as_tensor(imgs[1]), ct, ct, q, t)
    for x, y in zip(a[:2], b[:2]):
        assert tuple(y.shape) == x.shape
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                   atol=255e-9)
    assert (b[2].width, b[2].height) == (a[2].width, a[2].height)
    np.testing.assert_allclose(b[2].params, a[2].params, rtol=1e-12)
    np.testing.assert_allclose(b[3], a[3], rtol=0, atol=1e-12)


def _tiny_model(tmp_path):
    from test_undistortion import _tiny_reconstruction_with_points

    return _tiny_reconstruction_with_points(tmp_path, n_images=4)[1:]


def _same_tokens(x, y):
    """Equal whitespace-separated tokens, numbers within 1e-9 relative
    (the undistorted cameras and keypoints agree at that tolerance,
    tests/test_torch_mvs.py::test_undistortion_matches_sba_tpu)."""
    tx, ty = x.split(), y.split()
    assert len(tx) == len(ty) and x.count("\n") == y.count("\n")
    for u, v in zip(tx, ty):
        if u != v:
            assert abs(float(u) - float(v)) <= 1e-9 * max(abs(float(u)),
                                                          1.0), (u, v)


def _same_tree(a, b, image_tol=1):
    """Equal file lists; text files token by token (`_same_tokens`),
    images within `image_tol` grey levels."""
    from PIL import Image as PILImage

    fa = sorted(os.path.relpath(os.path.join(r, f), a)
                for r, _d, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(r, f), b)
                for r, _d, fs in os.walk(b) for f in fs)
    assert fa == fb and fa
    for f in fa:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith((".jpg", ".png")):
            x, y = (np.asarray(PILImage.open(p), int) for p in (pa, pb))
            assert x.shape == y.shape and np.abs(x - y).max() <= image_tol, f
        else:
            _same_tokens(open(pa).read(), open(pb).read())
    return fa


@pytest.mark.parametrize("output_type", ["PMVS", "CMP-MVS"])
def test_undistorter_workspaces_match_sba_tpu(tmp_path, output_type):
    """tests/test_undistortion.py:177,203's workspaces, written by both
    packages: the same files (projection matrices, bundle.rd.out,
    vis.dat, option-all, scripts; numbers within 1e-9), images within 3
    grey levels (JPEG of warps within one level)."""
    from sba_tpu import cli as jcli
    from sba_tpu_torch import cli as tcli

    img_dir, sparse = _tiny_model(tmp_path)
    for tag, mod, dev in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod.main(["image_undistorter", "--image_path", img_dir,
                             "--input_path", sparse, "--output_path",
                             str(tmp_path / tag), "--output_type",
                             output_type] + dev) == 0
    files = _same_tree(tmp_path / "j", tmp_path / "t", image_tol=3)
    if output_type == "PMVS":
        assert "pmvs/bundle.rd.out" in files and "pmvs/vis.dat" in files
        vis = open(tmp_path / "t" / "pmvs" / "vis.dat").read().splitlines()
        assert vis[:3] == ["VISDATA", "4", "0 3 1 2 3"]
    else:
        assert {"00001.jpg", "00004_P.txt"} <= set(files)


def test_image_rectifier_matches_sba_tpu(tmp_path):
    """Both packages' image_rectifier on two pairs of a SIMPLE_RADIAL
    model: the same files, images within one grey level, Q at 1e-12."""
    from sba_tpu import cli as jcli
    from sba_tpu_torch import cli as tcli

    img_dir, sparse = _tiny_model(tmp_path)
    with open(tmp_path / "pairs.txt", "w") as f:
        f.write("im0.png im1.png\nim2.png im3.png\nim0.png nope.png\n")
    for tag, mod, dev in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod.main(["image_rectifier", "--image_path", img_dir,
                             "--input_path", sparse, "--output_path",
                             str(tmp_path / tag), "--stereo_pairs_list",
                             str(tmp_path / "pairs.txt")] + dev) == 0
    for d in ("im0-im1", "im2-im3"):
        np.testing.assert_allclose(
            np.loadtxt(tmp_path / "t" / d / "Q.txt"),
            np.loadtxt(tmp_path / "j" / d / "Q.txt"), rtol=0, atol=1e-12)
        for f in ("Q.txt",):
            os.remove(tmp_path / "t" / d / f)
            os.remove(tmp_path / "j" / d / f)
    assert len(_same_tree(tmp_path / "j", tmp_path / "t")) == 4
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["image_rectifier", "--image_path", img_dir,
                   "--input_path", sparse, "--output_path",
                   str(tmp_path / "x"), "--stereo_pairs_list",
                   str(tmp_path / "pairs.txt")])
