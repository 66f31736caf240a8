"""The port's line detection, coordinate frames and GPS transforms
against sba_tpu on the CPU, on the same numpy inputs.

The line field is float32 on both sides and atan2's last bit differs
between the libraries, so a pixel on an orientation-bin edge can change
bins: segments are held equal in count with endpoints within 0.05 px
(the fit averages hundreds of pixels). Vanishing points use sba_tpu's
draws (its `draw_samples` at its key, PRNGKey(number of segments)) and
agree at 1e-9; everything else is float64 host math held at 1e-12.
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from sba_tpu.estimators import coordinate_frame as jcf
from sba_tpu.features import lines as jl
from sba_tpu.geometry import gps as jgps
from sba_tpu.io.colmap_models import Camera as JCamera, Image as JImage
from sba_tpu.models.reconstruction import Reconstruction as JRec
from sba_tpu.optim import ransac as jransac
from sba_tpu_torch.estimators import coordinate_frame as tcf
from sba_tpu_torch.features import lines as tl
from sba_tpu_torch.geometry import gps as tgps
from sba_tpu_torch.geometry.quaternions import np_rotmat_to_quat
from sba_tpu_torch.io.colmap_models import Camera as TCamera, Image as TImage
from sba_tpu_torch.models.reconstruction import Reconstruction as TRec

torch.set_num_threads(2)
SEG_TOL = 0.05     # px, segment endpoints


def draw_line(img, x0, y0, x1, y1, value=255.0, thickness=1):
    """tests/test_lines_coordinate_frame.py's line raster."""
    n = int(max(abs(x1 - x0), abs(y1 - y0)) * 2 + 1)
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    for t in range(-(thickness // 2), thickness - thickness // 2):
        xi = np.clip(np.round(xs).astype(int), 0, img.shape[1] - 1)
        yi = np.clip(np.round(ys + t).astype(int), 0, img.shape[0] - 1)
        img[yi, xi] = value
    return img


def grid_image(w=320, h=240, step=40):
    """The Manhattan grid of test_manhattan_world_frame_synthetic (its
    spacing scaled with the size): vertical and horizontal lines."""
    img = np.zeros((h, w), np.float32)
    for x in range(30, w - 20, step):
        draw_line(img, x, 20, x, h - 20, thickness=2)
    for y in range(30, h - 20, step):
        draw_line(img, 15, y, w - 15, y, thickness=2)
    return img


def lines_image():
    img = np.zeros((128, 128), np.float32)
    draw_line(img, 10, 30, 110, 30, thickness=2)
    draw_line(img, 60, 10, 60, 120, thickness=2)
    draw_line(img, 10, 60, 100, 110, thickness=2)
    rng = np.random.default_rng(0)
    return img + rng.uniform(0, 2, img.shape).astype(np.float32)


def jax_draw_fn(n, trials, sample_size):
    """sba_tpu's vanishing-point draws for n segments."""
    return np.asarray(jransac.draw_samples(jax.random.PRNGKey(n), n, trials,
                                           sample_size))


def same_segments(a, b, tol=SEG_TOL):
    assert a.shape == b.shape, (a.shape, b.shape)
    if len(a):
        assert np.abs(a - b).max() <= tol, np.abs(a - b).max()


def test_line_field():
    img = lines_image()
    with jax.enable_x64(False):
        aj, mj = map(np.asarray, jl._field_fn()(img))
    at, mt = (x.numpy() for x in tl._field(torch.as_tensor(img)))
    assert np.abs(mt - mj).max() <= 1e-4
    d = np.abs(at - aj)
    d = np.minimum(d, 2 * np.pi - d)
    assert d[mj > 1e-3].max() <= 1e-5


@pytest.mark.parametrize("name", ["lines", "grid"])
def test_detect_and_classify_segments(name):
    img = lines_image() if name == "lines" else grid_image()
    ml = 20 if name == "lines" else 3.0
    sj = jl.detect_line_segments(img, min_length=ml)
    st = tl.detect_line_segments(img, min_length=ml, device="cpu")
    assert len(sj) >= 3
    same_segments(st, sj)
    for tol in (0.2, 0.25):
        np.testing.assert_array_equal(
            tl.classify_line_segment_orientations(st, tol),
            jl.classify_line_segment_orientations(sj, tol))
    assert len(tl.detect_line_segments(np.zeros((3, 3)), device="cpu")) == 0


def test_consensus_and_rotation_from_unit_vectors():
    rng = np.random.default_rng(3)
    axes = rng.normal(size=(9, 3)) * 0.02 + [0, 1, 0]
    axes[-2:] = rng.normal(size=(2, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    np.testing.assert_array_equal(tcf.find_best_consensus_axis(axes),
                                  jcf.find_best_consensus_axis(axes))
    for a, b in (rng.normal(size=(2, 3)), ([0, 0, 1.0], [0, 0, -1.0])):
        a = np.asarray(a) / np.linalg.norm(a)
        b = np.asarray(b) / np.linalg.norm(b)
        np.testing.assert_allclose(tcf.rotation_from_unit_vectors(a, b),
                                   jcf.rotation_from_unit_vectors(a, b),
                                   atol=1e-12)


def test_vanishing_point_with_sba_tpu_draws():
    """tests/test_lines_coordinate_frame.py's converging segments with
    outliers: the same model and inliers as sba_tpu at 1e-9."""
    rng = np.random.default_rng(1)
    vp = np.array([400.0, -300.0])
    segs = []
    for _ in range(30):
        p = rng.uniform(0, 300, 2)
        d = (vp - p) / np.linalg.norm(vp - p)
        segs.append([p, p + 40 * d + rng.normal(0, 0.1, 2)])
    segs += [rng.uniform(0, 300, (2, 2)) for _ in range(10)]
    segs = np.asarray(segs)
    lines = jcf._segments_to_lines(segs)
    np.testing.assert_array_equal(tcf._segments_to_lines(segs), lines)
    with jax.enable_x64(True):
        mj, nj = jcf.estimate_vanishing_point(segs, lines)
    mt, nt = tcf.estimate_vanishing_point(segs, lines, device="cpu",
                                          draw_fn=jax_draw_fn)
    assert nt == nj >= 25
    np.testing.assert_allclose(mt, mj, rtol=1e-9, atol=1e-9)
    # The port's own draws find the point too (a 2-line model of noisy
    # segments: within 5% of its distance).
    mo, no = tcf.estimate_vanishing_point(segs, lines, device="cpu")
    assert no >= 25
    assert np.linalg.norm(mo[:2] / mo[2] - vp) <= 0.05 * np.linalg.norm(vp)
    assert tcf.estimate_vanishing_point(segs[:1], lines[:1],
                                        device="cpu") == (None, 0)


def _recs(rotations, centers=None, points=None, cam=(500.0, 320, 240),
          size=(640, 480), names=None):
    """The same scene in both packages' Reconstruction."""
    out = []
    for Rec, Cam, Img in ((JRec, JCamera, JImage), (TRec, TCamera, TImage)):
        rec = Rec()
        rec.add_camera(Cam(1, 0, size[0], size[1], np.array(cam)))
        for i, R in enumerate(rotations):
            t = np.array([0.0, 0, float(i)]) if centers is None \
                else -R @ centers[i]
            name = names[i] if names else f"im{i}.png"
            rec.add_image(Img(i + 1, np_rotmat_to_quat(R), t, 1, name,
                              np.zeros((0, 2)), np.zeros(0, np.int64)),
                          registered=True)
        for p in ([] if points is None else points):
            rec.add_point3d(np.array(p), [])
        out.append(rec)
    return out


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _poses(rec):
    return np.concatenate([np.concatenate([rec.images[i].qvec,
                                           rec.images[i].tvec])
                           for i in sorted(rec.images)])


def _xyz(rec):
    return np.stack([rec.points3D[p].xyz for p in sorted(rec.points3D)])


def test_gravity_transform_and_plane_alignment():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(30, 3)) * [5, 3, 0.2]
    rots = [_yaw(a) @ _yaw(0.1 * a).T @ np.eye(3) for a in
            np.linspace(0, 1.0, 6)]
    rj, rt = _recs(rots, points=pts)
    np.testing.assert_allclose(
        tcf.estimate_gravity_vector_from_image_orientation(rt),
        jcf.estimate_gravity_vector_from_image_orientation(rj), atol=1e-12)
    R = tcf.rotation_from_unit_vectors([0, 0, 1.0], [1.0, 0, 0])
    for rec, mod in ((rj, jcf), (rt, tcf)):
        mod.transform_reconstruction(rec, 2.0, R, np.array([1.0, -2, 3]))
    np.testing.assert_allclose(_poses(rt), _poses(rj), atol=1e-12)
    np.testing.assert_allclose(_xyz(rt), _xyz(rj), atol=1e-12)
    outs = [mod.align_to_principal_plane(rec)
            for rec, mod in ((rj, jcf), (rt, tcf))]
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, atol=1e-12)
    np.testing.assert_allclose(_poses(rt), _poses(rj), atol=1e-12)
    base = tgps.ell_to_xyz([[47.37, 8.54, 400.0]])[0]
    for rec in (rj, rt):
        for p in rec.points3D.values():
            p.xyz = p.xyz + base
    outs = [mod.align_to_enu_plane(rec, unscaled=True, prior_scale=2.0)
            for rec, mod in ((rj, jcf), (rt, tcf))]
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(_xyz(rt), _xyz(rj), atol=1e-6)


def test_manhattan_world_frame(tmp_path):
    """tests/test_lines_coordinate_frame.py's grid seen by two cameras
    (one rolled), through undistortion, lines and vanishing points, with
    sba_tpu's draws: the same frame at 1e-9, and the true axes."""
    f, cx, cy = 300.0, 160.0, 120.0
    PILImage.fromarray(grid_image().astype(np.uint8)).save(tmp_path / "a.png")
    PILImage.fromarray(grid_image(step=36).astype(np.uint8)).save(
        tmp_path / "b.png")
    rj, rt = _recs([np.eye(3), _yaw(0.2)], cam=(f, cx, cy), size=(320, 240),
                   names=["a.png", "b.png"])
    opt = dict(max_image_size=512)
    with jax.enable_x64(True):
        fj = jcf.estimate_manhattan_world_frame(
            jcf.ManhattanWorldFrameOptions(**opt), rj, str(tmp_path),
            verbose=False)
    ft = tcf.estimate_manhattan_world_frame(
        tcf.ManhattanWorldFrameOptions(**opt), rt, str(tmp_path),
        verbose=False, device="cpu", draw_fn=jax_draw_fn)
    np.testing.assert_allclose(ft, fj, atol=1e-9)
    assert abs(ft[:, 0] @ [1, 0, 0]) > 0.95
    assert abs(ft[:, 1] @ [0, 1, 0]) > 0.95


def test_gps_transforms():
    """tests/test_aux_modules.py's GPS round trips, both packages bit for
    bit (the same float64 numpy code)."""
    rng = np.random.default_rng(4)
    lla = np.stack([rng.uniform(-80, 80, 20), rng.uniform(-179, 179, 20),
                    rng.uniform(-100, 3000, 20)], 1)
    xyz = tgps.ell_to_xyz(lla)
    np.testing.assert_array_equal(xyz, jgps.ell_to_xyz(lla))
    np.testing.assert_array_equal(tgps.xyz_to_ell(xyz), jgps.xyz_to_ell(xyz))
    np.testing.assert_allclose(tgps.xyz_to_ell(xyz), lla, atol=1e-6)
    enu = tgps.ell_to_enu(lla)
    np.testing.assert_array_equal(enu, jgps.ell_to_enu(lla))
    np.testing.assert_array_equal(tgps.enu_to_ell(enu, lla[0]),
                                  jgps.enu_to_ell(enu, lla[0]))
    np.testing.assert_allclose(tgps.enu_to_ell(enu, lla[0]), lla, atol=1e-6)
