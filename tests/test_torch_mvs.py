"""Parity of the port's dense MVS path with sba_tpu on the CPU.

The same numpy inputs go through sba_tpu and through sba_tpu_torch:
K6's twin against sba_tpu's Pallas kernel (interpret mode) and its XLA
formulation, the samplers, the hypothesis cost, the whole PatchMatch
solve in float64 with sba_tpu's own random draws fed in, fusion, the
dense-map IO, the undistorter, the renderer and the three CLI commands.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sba_tpu.mvs.fusion as jfus
import sba_tpu.mvs.patch_match as jpm
import sba_tpu_torch.mvs.fusion as tfus
import sba_tpu_torch.mvs.patch_match as tpm
from sba_tpu_torch.ops.patch_match_kernels import (ncc_cost_plain,
                                                   window_offsets)

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# K6 and the samplers
# ---------------------------------------------------------------------------


def _ncc_xla_formulation(ref, v, inb, offs, w_sp, sigma_color):
    """tests/test_mvs.py's float64 statement of the XLA path (rolls with
    shift-valid masks). Returns (cost, FIN / sum(w_sp))."""
    H, W = ref.shape
    iy, ix = np.arange(H), np.arange(W)
    z = lambda: np.zeros((H, W))
    SW, SR, SRR, SV, SVV, SRV, FIN = (z() for _ in range(7))
    for k in range(len(offs)):
        dx, dy = int(offs[k, 0]), int(offs[k, 1])
        r_k = np.roll(np.roll(ref, -dy, 0), -dx, 1)
        v_k = np.roll(np.roll(v, -dy, 0), -dx, 1)
        i_k = np.roll(np.roll(inb.astype(np.float64), -dy, 0), -dx, 1)
        valid = ((iy + dy >= 0) & (iy + dy < H))[:, None] \
            & ((ix + dx >= 0) & (ix + dx < W))[None, :]
        w = np.where(valid, w_sp[k] * np.exp(
            -((r_k - ref) ** 2) / (2 * sigma_color ** 2)), 0.0)
        i_k = np.where(valid, i_k, 0.0)
        SW += w; SR += w * r_k; SRR += w * r_k * r_k            # noqa: E702
        SV += w * v_k; SVV += w * v_k * v_k; SRV += w * r_k * v_k  # noqa
        FIN += w_sp[k] * i_k
    wsum = np.maximum(SW, 1e-9)
    mr = SR / wsum
    vr = SRR / wsum - mr * mr
    ms = SV / wsum
    vs = SVV / wsum - ms * ms
    cov = SRV / wsum - mr * ms
    ncc = np.clip(cov / np.sqrt(np.maximum(vr * vs, 1e-10)), -1, 1)
    frac = FIN / w_sp.sum()
    return np.where(frac > 0.5, 1.0 - ncc, 2.0), frac


@pytest.mark.parametrize("r,step", [(3, 1), (5, 1), (3, 2)])
def test_ncc_twin_matches_sba_tpu_kernel(r, step):
    """K6's twin against sba_tpu's `_ncc_kernel_call` (interpret mode)
    and against the XLA formulation, atol 2e-4 (tests/test_mvs.py:429),
    with partially visible windows: a column band and a row band outside
    the source. With step 2 the centre tap is skipped, so windows at the
    image border lie exactly half outside; there the float32 twin must
    decide the >half gate as the kernel does (same sums in the same
    order), and the float64 formulation may decide either way."""
    rng = np.random.default_rng(3)
    H, W, sc, ss = 40, 64, 0.2, 3.0
    ref = rng.random((H, W)).astype(np.float32)
    inb = np.ones((H, W), bool)
    inb[:, :5] = False
    inb[31:, :] = False
    v = np.where(inb, rng.random((H, W)), 0.0).astype(np.float32)
    offs = jpm._window_offsets(r, step)
    np.testing.assert_array_equal(window_offsets(r, step), offs)
    w_sp = np.exp(-(offs[:, 0] ** 2 + offs[:, 1] ** 2) / (2 * ss ** 2))
    pad = lambda a: jnp.pad(jnp.asarray(a, jnp.float32), ((r, r), (r, r)))
    c_kernel = np.asarray(jpm._ncc_kernel_call(
        pad(ref), pad(v), pad(np.ones((H, W))), pad(inb.astype(np.float32)),
        offs, w_sp, sc, H, W, r, interpret=True))
    c_twin = ncc_cost_plain(_t(ref), _t(v[None]), _t(inb[None]), r, step,
                            ss, sc)[0].numpy()
    np.testing.assert_allclose(c_twin, c_kernel, atol=2e-4, rtol=0)
    c_xla, frac = _ncc_xla_formulation(ref.astype(np.float64),
                                       v.astype(np.float64), inb, offs,
                                       w_sp, sc)
    tie = np.abs(frac - 0.5) < 1e-9
    assert step > 1 or not tie.any()
    ok = np.abs(c_twin - c_xla) <= 2e-4
    ok |= tie & ((c_twin == 2.0) | (np.abs(c_twin - np.where(
        frac >= 0.5 - 1e-9, c_xla, 0.0)) <= 2e-4) | (c_xla == 2.0))
    assert ok.all(), np.argwhere(~ok)[:5]
    assert (c_twin == 2.0).any() and (c_twin < 2.0).any()


def test_pack_intensity_nbhd_bit_equal():
    rng = np.random.default_rng(4)
    img = (rng.integers(0, 256, (21, 37)) / 255.0).astype(np.float32)
    a = np.asarray(jpm._pack_intensity_nbhd(jnp.asarray(img)))
    b = tpm._pack_intensity_nbhd(_t(img)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("W", [128, 100])
def test_bilinear_samplers_match_sba_tpu(W):
    """`_bilinear` and `_bilinear_packed` at 1e-6 in float32, with the
    image width a multiple of 128 (sba_tpu's row-select gather) and
    not."""
    rng = np.random.default_rng(5)
    H = 48
    img = (rng.integers(0, 256, (H, W)) / 255.0).astype(np.float32)
    xy = rng.uniform(-3, [W + 3, H + 3], (5000, 2)).astype(np.float32)
    v_j, inb_j = jpm._bilinear(jnp.asarray(img), jnp.asarray(xy))
    v_t, inb_t = tpm._bilinear(_t(img), _t(xy))
    np.testing.assert_array_equal(inb_t.numpy(), np.asarray(inb_j))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-6)
    pj, pinb_j = jpm._bilinear_packed(
        jpm._pack_intensity_nbhd(jnp.asarray(img)), H, W, jnp.asarray(xy))
    pt, pinb_t = tpm._bilinear_packed(tpm._pack_intensity_nbhd(_t(img)),
                                      H, W, _t(xy))
    np.testing.assert_array_equal(pinb_t.numpy(), np.asarray(pinb_j))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    # On 8-bit content the packed sampler is the exact one.
    m = inb_t.numpy()
    np.testing.assert_allclose(pt.numpy()[m], v_t.numpy()[m], atol=1e-5)


# ---------------------------------------------------------------------------
# The hypothesis cost and the whole solve, float64
# ---------------------------------------------------------------------------


def _two_source_problem(H=30, W=40, seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    Rs = np.stack([tpm.np_quat_to_rotmat([1, 0.02, -0.03, 0.01]),
                   np.eye(3)])
    ts = np.array([[0.3, 0.05, 0.0], [-0.3, 0.0, 0.02]])
    return dict(ref=rng.random((H, W)), srcs=rng.random((2, H, W)), K=K,
                Ks=np.stack([K, K]), Rs=Rs, ts=ts,
                depth=rng.uniform(3, 5, (H, W)),
                normal=np.tile([0.0, 0.0, -1.0], (H, W, 1)),
                src_depths=rng.uniform(3.5, 4.5, (2, H, W)))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("geometric", [False, True])
def test_cost_for_hypothesis_matches_sba_tpu(packed, geometric):
    """rtol 1e-9 in float64, exact and packed source sampling, without
    and with the geometric term (`src_depths`); `_geom_costs` too."""
    p = _two_source_problem()
    kinv = np.linalg.inv(p["K"])
    sd = p["src_depths"] if geometric else None
    jo = jpm.PatchMatchOptions(window_radius=2)
    to = tpm.PatchMatchOptions(window_radius=2)
    ja = lambda a: None if a is None else jnp.asarray(a)
    c_j = jpm._cost_for_hypothesis(
        ja(p["ref"]), ja(p["srcs"]), ja(kinv), ja(p["Ks"]), ja(p["Rs"]),
        ja(p["ts"]), ja(p["depth"]), ja(p["normal"]), jo, K_ref=ja(p["K"]),
        src_depths=ja(sd), src_packed=[
            jpm._pack_intensity_nbhd(jnp.asarray(s)) for s in p["srcs"]]
        if packed else None)
    ta = lambda a: None if a is None else _t(a)
    c_t = tpm._cost_for_hypothesis(
        ta(p["ref"]), ta(p["srcs"]), ta(kinv), ta(p["Ks"]), ta(p["Rs"]),
        ta(p["ts"]), ta(p["depth"]), ta(p["normal"]), to, K_ref=ta(p["K"]),
        src_depths=ta(sd), src_packed=[
            tpm._pack_intensity_nbhd(_t(s)) for s in p["srcs"]]
        if packed else None)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-9,
                               atol=0)
    if geometric:
        g_j = jpm._geom_costs(ja(p["depth"]), ja(p["K"]), ja(kinv),
                              ja(p["Ks"]), ja(p["Rs"]), ja(p["ts"]),
                              ja(sd), 3.0)
        g_t = tpm._geom_costs(ta(p["depth"]), ta(p["K"]), ta(kinv),
                              ta(p["Ks"]), ta(p["Rs"]), ta(p["ts"]),
                              ta(sd), 3.0)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-9,
                                   atol=0)


class SbaTpuDraws:
    """Stands in for `patch_match.random_draw`: sba_tpu's own draws of
    `patch_match_stereo` for `key`, in its key-split order (split(key, 3)
    at init, split(k_init_n) inside `_random_normals`, split(key, 3) per
    random sample per parity per iteration), converted to torch."""

    def __init__(self, key):
        self.key = key
        self.init = None
        self.k_normal = None

    def __call__(self, generator, tag, shape, dtype, lo=0.0, hi=1.0):
        if self.init is None:
            self.key, kd, kn = jax.random.split(self.key, 3)
            k1, k2 = jax.random.split(kn)
            self.init = dict(init_depth=kd, init_normal_q1=k1,
                             init_normal_q2=k2)
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        if tag == "init_depth":
            a = jax.random.uniform(self.init[tag], shape, jdt, lo, hi)
        elif tag.startswith("init_normal"):
            a = jax.random.uniform(self.init[tag], shape, jdt)
        elif tag == "refine_depth":
            self.key, kd, self.k_normal = jax.random.split(self.key, 3)
            a = jax.random.normal(kd, shape, jdt)
        else:
            assert tag == "refine_normal"
            a = jax.random.normal(self.k_normal, shape, jdt)
        return torch.from_numpy(np.array(a))


def _render_pair(tag):
    """A 3-view 64x48 render in both packages (seed 3, as
    tests/test_mvs.py:313 uses)."""
    kw = dict(num_images=3, image_size=(64, 48), ring_radius=1.0,
              jitter=0.05, seed=3)
    if tag == "jax":
        from sba_tpu.utils.render import render_scene
        return render_scene(**kw)
    from sba_tpu_torch.utils.render import render_scene
    return render_scene(device="cpu", **kw)


def _report(name, got, ref, rtol=1e-8):
    """Fraction of pixels within rtol of sba_tpu's, and the count that
    differ (near ties of the strict `c_new < cost` update)."""
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
    bad = rel > rtol
    if bad.ndim == 3:
        bad = bad.any(-1)
    print(f"{name}: {int(bad.sum())} of {bad.size} pixels differ by more "
          f"than {rtol:g} relative")
    return 1.0 - bad.mean()


def test_patch_match_solve_matches_sba_tpu(monkeypatch):
    """The whole `patch_match_stereo` in float64 with sba_tpu's draws fed
    in: the photometric pass, then the geometric pass warm-started from
    it against the sources' true depths. Depth, normal and cost agree to
    1e-8 relative on at least 99.5% of pixels. (Radius 1, one random
    sample, two sources, 48x64: sba_tpu compiles each pass once.)"""
    scene = _render_pair("torch")
    p = scene["camera"]["params"]
    K = np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1.0]])
    ref, srcs = 1, [0, 2]
    imgs = scene["images"].astype(np.float64) / 255.0
    Rs, ts = map(np.stack, zip(*[tpm.relative_pose(
        scene["qvecs"][ref], scene["tvecs"][ref], scene["qvecs"][s],
        scene["tvecs"][s]) for s in srcs]))
    gt = scene["depths"][ref]
    kw = dict(depth_min=0.5 * float(gt.min()),
              depth_max=2.0 * float(gt.max()), window_radius=1,
              num_random_samples=1)
    args = (imgs[ref], imgs[srcs], K, np.stack([K, K]), Rs, ts)
    src_depths = scene["depths"][srcs].astype(np.float64)
    results = {}
    for geometric in (False, True):
        key = jax.random.PRNGKey(7 + geometric)
        extra = {}
        if geometric:
            extra = dict(src_depths=src_depths,
                         init_depth=results[False][0][0])
        r_j = jpm.patch_match_stereo(
            *map(jnp.asarray, args), key=key,
            options=jpm.PatchMatchOptions(geom_consistency=geometric, **kw),
            **{k: jnp.asarray(v) for k, v in extra.items()})
        monkeypatch.setattr(tpm, "random_draw", SbaTpuDraws(key))
        r_t = tpm.patch_match_stereo(
            *map(_t, args),
            options=tpm.PatchMatchOptions(geom_consistency=geometric, **kw),
            **{k: _t(v) for k, v in extra.items()})
        results[geometric] = ([np.asarray(a) for a in r_j],
                              [a.numpy() for a in r_t])
        for name, a_t, a_j in zip(("depth", "normal", "cost"),
                                  results[geometric][1],
                                  results[geometric][0]):
            frac = _report(f"{'geometric' if geometric else 'photometric'}"
                           f" {name}", a_t, a_j)
            assert frac >= 0.995, (geometric, name, frac)
    # The filter of each pass left some pixels and removed some.
    d_geo = results[True][1][0]
    assert 0 < (d_geo > 0).sum() < d_geo.size


# ---------------------------------------------------------------------------
# Fusion and dense-map IO
# ---------------------------------------------------------------------------


def _gt_maps(scene):
    """float64 depth and camera-frame normal maps of a rendered scene
    (normals from the analytic heightfield, facing the camera), with a
    noisy band so that some pixels are inconsistent."""
    from sba_tpu_torch.utils.render import _Heightfield

    field = _Heightfield(5.0, 0.55, 3)
    p = scene["camera"]["params"]
    N, H, W = scene["depths"].shape
    yy, xx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    ray = np.stack([(xx - p[1]) / p[0], (yy - p[2]) / p[0],
                    np.ones_like(xx)], -1)
    depths = scene["depths"].astype(np.float64)
    normals = np.zeros((N, H, W, 3))
    rng = np.random.default_rng(0)
    for i in range(N):
        R = tpm.np_quat_to_rotmat(scene["qvecs"][i])
        pw = (ray * depths[i][..., None] - scene["tvecs"][i]) @ R
        gx, gy = field.grad(_t(pw[..., 0]), _t(pw[..., 1]))
        n = np.stack([gx.numpy(), gy.numpy(), -np.ones((H, W))], -1)
        normals[i] = (n / np.linalg.norm(n, axis=-1, keepdims=True)) @ R.T
        depths[i, 10:16] *= 1.0 + 0.05 * rng.random((6, W))
    return depths, normals


def test_fuse_depth_maps_matches_sba_tpu(tmp_path):
    """Same point count, xyz/normal/colour at 1e-9 (float64), equal
    visibility lists; the port's .ply/.vis writers give the same bytes as
    sba_tpu's for one cloud, and each package's .vis of its own cloud is
    the same file."""
    scene = _render_pair("torch")
    depths, normals = _gt_maps(scene)
    images = scene["images"].astype(np.float64) / 255.0
    p = scene["camera"]["params"]
    K = np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1.0]])
    args = (depths, normals, images, np.stack([K] * 3), scene["qvecs"],
            scene["tvecs"])
    c_j = jfus.fuse_depth_maps(*args, jfus.StereoFusionOptions(
        min_num_pixels=2))
    c_t = tfus.fuse_depth_maps(*args, tfus.StereoFusionOptions(
        min_num_pixels=2), device="cpu")
    assert len(c_t.xyz) == len(c_j.xyz) > 1000
    for name in ("xyz", "normal", "color"):
        np.testing.assert_allclose(getattr(c_t, name), getattr(c_j, name),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    for name in ("num_views", "vis_counts", "vis_idxs"):
        np.testing.assert_array_equal(getattr(c_t, name),
                                      getattr(c_j, name), err_msg=name)
    for ext, jw, tw in (("ply", jfus.write_fused_ply, tfus.write_fused_ply),
                        ("vis", jfus.write_fused_vis, tfus.write_fused_vis)):
        jw(c_j, tmp_path / f"j.{ext}")
        tw(c_j, tmp_path / f"t.{ext}")
        assert (tmp_path / f"j.{ext}").read_bytes() \
            == (tmp_path / f"t.{ext}").read_bytes()
    tfus.write_fused_vis(c_t, tmp_path / "own.vis")
    assert (tmp_path / "own.vis").read_bytes() \
        == (tmp_path / "j.vis").read_bytes()
    counts, idxs = tfus.read_fused_vis(tmp_path / "own.vis")
    np.testing.assert_array_equal(counts, c_j.vis_counts)
    np.testing.assert_array_equal(idxs, c_j.vis_idxs)


def test_write_colmap_map_byte_identical(tmp_path):
    from sba_tpu.mvs import write_colmap_map as jwrite
    from sba_tpu_torch.mvs import read_colmap_map, write_colmap_map

    rng = np.random.default_rng(0)
    for shape in ((13, 17), (7, 9, 3)):
        a = rng.uniform(-1, 10, shape).astype(np.float32)
        jwrite(a, str(tmp_path / "j.bin"))
        write_colmap_map(a, str(tmp_path / "t.bin"))
        assert (tmp_path / "j.bin").read_bytes() \
            == (tmp_path / "t.bin").read_bytes()
        np.testing.assert_array_equal(read_colmap_map(tmp_path / "t.bin"), a)


# ---------------------------------------------------------------------------
# Undistortion and rendering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,params", [
    ("SIMPLE_RADIAL", [70.0, 32.0, 24.0, -0.08]),
    ("RADIAL", [70.0, 32.0, 24.0, -0.05, 0.01]),
    ("OPENCV", [70.0, 72.0, 31.0, 25.0, -0.05, 0.01, 0.001, -0.002]),
])
def test_undistortion_matches_sba_tpu(model, params):
    """`undistort_camera` params at 1e-9; `warp_image_between_cameras`
    at 1e-6."""
    from sba_tpu.geometry import camera_models as jcm
    from sba_tpu.geometry.undistortion import (
        undistort_camera as j_und, warp_image_between_cameras as j_warp)
    from sba_tpu.io.colmap_models import Camera as JCamera
    from sba_tpu_torch.geometry import camera_models as tcm
    from sba_tpu_torch.geometry.undistortion import (
        undistort_camera, warp_image_between_cameras)
    from sba_tpu_torch.io.colmap_models import Camera

    params = np.array(params)
    cj = JCamera(1, jcm.model_by_name(model).model_id, 64, 48, params)
    ct = Camera(1, tcm.model_by_name(model).model_id, 64, 48, params)
    uj, ut = j_und(cj), undistort_camera(ct)
    assert (ut.model_id, ut.width, ut.height) \
        == (uj.model_id, uj.width, uj.height)
    np.testing.assert_allclose(ut.params, uj.params, rtol=1e-9, atol=0)
    img = np.random.default_rng(1).random((48, 64, 3)).astype(np.float32)
    wj = np.asarray(j_warp(cj, uj, jnp.asarray(img)))
    wt = warp_image_between_cameras(ct, ut, _t(img)).numpy()
    assert wt.shape == wj.shape
    np.testing.assert_allclose(wt, wj, atol=1e-6, rtol=0)


@pytest.mark.parametrize("model", ["SIMPLE_PINHOLE", "SIMPLE_RADIAL"])
def test_render_scene_matches_sba_tpu(model):
    """Equal poses (to float64 rounding); images within one grey level on
    at least 99.9% of pixels; depths at 1e-5 relative."""
    from sba_tpu.utils.render import render_scene as j_render
    from sba_tpu_torch.utils.render import render_scene

    kw = dict(num_images=3, image_size=(64, 48), model_name=model,
              extra_params=(-0.05,) if model == "SIMPLE_RADIAL" else (),
              ring_radius=1.0, jitter=0.05, seed=3)
    a, b = j_render(**kw), render_scene(device="cpu", **kw)
    for k in ("qvecs", "tvecs", "centers"):
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(b["camera"]["params"], a["camera"]["params"])
    d = np.abs(b["images"].astype(int) - a["images"].astype(int))
    assert (d <= 1).mean() >= 0.999
    np.testing.assert_allclose(b["depths"], a["depths"], rtol=1e-5)


# ---------------------------------------------------------------------------
# The CLI chain
# ---------------------------------------------------------------------------


def _gt_depth(field, rec, iid):
    """True depth of every pixel of an undistorted (pinhole) view."""
    from sba_tpu_torch.utils.render import _march

    im = rec.images[iid]
    cam = rec.cameras[im.camera_id]
    fx, fy, cx, cy = cam.params
    yy, xx = np.meshgrid(np.arange(cam.height) + 0.5,
                         np.arange(cam.width) + 0.5, indexing="ij")
    d_cam = np.stack([(xx - cx) / fx, (yy - cy) / fy, np.ones_like(xx)],
                     -1).reshape(-1, 3)
    R = tpm.np_quat_to_rotmat(im.qvec)
    s = _march(field, _t(-R.T @ im.tvec), _t(d_cam @ R))
    return s.numpy().reshape(cam.height, cam.width)


def _depth_errors(ws, field, kind):
    """(median, p80) of |depth - truth| / median true depth over the
    valid pixels of every view's map (tests/test_mvs.py:313's measure,
    border of 4 pixels excluded)."""
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.mvs import read_colmap_map

    rec = Reconstruction.read(os.path.join(ws, "sparse"))
    out = []
    for iid, im in sorted(rec.images.items()):
        d = read_colmap_map(os.path.join(
            ws, "stereo", "depth_maps", f"{im.name}.{kind}.bin"))
        gt = _gt_depth(field, rec, iid)
        m = d > 0
        m[:4] = m[-4:] = False
        m[:, :4] = m[:, -4:] = False
        err = np.abs(d[m] - gt[m])
        med = float(np.median(gt[m]))
        out.append((float(np.median(err)) / med,
                    float(np.quantile(err, 0.8)) / med))
    return np.array(out)


def test_cli_dense_chain_matches_sba_tpu(tmp_path):
    """image_undistorter -> patch_match_stereo -> stereo_fuser of both
    packages on a 3-view 64x48 rendered SIMPLE_RADIAL workspace
    (`--device cpu` for the port). sba_tpu compiles every solve anew
    (its options are static and the depth range differs per view), so
    both run the photometric pass at window radius 1 with one random
    sample; the port's geometric pass runs after, on its own maps.

    Depth accuracy: sba_tpu's own maps do not meet
    tests/test_mvs.py:313's thresholds (median error under 1%, p80 under
    3% of the median depth) on this workspace (the test prints both
    packages' errors; sba_tpu's median is ~0.31 of the depth), nor on
    that test's own scene (run alone with the compilation cache off it
    fails with "median 1.7924 @ depth 5.08"): at 8-10 iterations its
    checkerboard search has not converged. So the port is held to
    sba_tpu's accuracy: its mean median and p80 errors at most 1.25x
    sba_tpu's plus 0.02 (the two random streams differ)."""
    from PIL import Image as PILImage

    from sba_tpu import cli as jcli
    from sba_tpu_torch import cli as tcli
    from sba_tpu_torch.io.colmap_models import read_model
    from sba_tpu_torch.mvs import read_colmap_map
    from sba_tpu_torch.utils.render import (_Heightfield,
                                            gt_sparse_reconstruction,
                                            render_scene,
                                            write_scene_images)

    scene = render_scene(num_images=3, image_size=(64, 48),
                         model_name="SIMPLE_RADIAL", extra_params=(-0.05,),
                         ring_radius=1.0, jitter=0.05, seed=3, device="cpu")
    names = write_scene_images(scene, str(tmp_path / "images"))
    gt_sparse_reconstruction(scene, names, stride=4).write(
        str(tmp_path / "sparse"))
    pm = {"PatchMatchStereo.window_radius": "1",
          "PatchMatchStereo.num_random_samples": "1",
          "PatchMatchStereo.geom_consistency": "false"}
    out = {}
    for tag, mod, dev in (("jax", jcli, {}), ("torch", tcli,
                                              {"device": "cpu"})):
        ws = str(tmp_path / tag)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            mod.run_image_undistorter(dict(
                image_path=str(tmp_path / "images"),
                input_path=str(tmp_path / "sparse"), output_path=ws, **dev))
            mod.run_patch_match_stereo(dict(workspace_path=ws, **pm, **dev))
        out[tag] = (ws, log.getvalue().splitlines())
    (ws_j, log_j), (ws_t, log_t) = out["jax"], out["torch"]

    # The undistorter: the same cameras, keypoints and configs; images
    # within one grey level.
    cams_j, imgs_j, _ = read_model(os.path.join(ws_j, "sparse"))
    cams_t, imgs_t, _ = read_model(os.path.join(ws_t, "sparse"))
    for cid in cams_j:
        assert (cams_t[cid].model_id, cams_t[cid].width,
                cams_t[cid].height) == (cams_j[cid].model_id,
                                        cams_j[cid].width,
                                        cams_j[cid].height)
        np.testing.assert_allclose(cams_t[cid].params, cams_j[cid].params,
                                   rtol=1e-9)
    for iid in imgs_j:
        np.testing.assert_allclose(imgs_t[iid].xys, imgs_j[iid].xys,
                                   atol=1e-9)
    for cfg in ("patch-match.cfg", "fusion.cfg"):
        assert open(os.path.join(ws_t, "stereo", cfg)).read() \
            == open(os.path.join(ws_j, "stereo", cfg)).read()
    for name in names:
        a, b = (np.asarray(PILImage.open(os.path.join(w, "images", name)),
                           int) for w in (ws_j, ws_t))
        assert a.shape == b.shape and np.abs(a - b).max() <= 1

    # patch_match_stereo: the same sources and depth ranges (the printed
    # lines up to the mean cost), maps with the same names and shapes.
    strip = lambda lines: [l.rsplit("mean cost", 1)[0] for l in lines
                           if l.startswith("  ")]
    assert strip(log_t[1:]) == strip(log_j[1:]) and len(strip(log_t)) == 3
    for sub in ("depth_maps", "normal_maps"):
        files = sorted(os.listdir(os.path.join(ws_j, "stereo", sub)))
        assert files == sorted(os.listdir(os.path.join(ws_t, "stereo", sub)))
        assert len(files) == 3
        for f in files:
            assert read_colmap_map(os.path.join(ws_t, "stereo", sub, f)
                                   ).shape == read_colmap_map(os.path.join(
                                       ws_j, "stereo", sub, f)).shape
    field = _Heightfield(5.0, 0.55, 3)
    e_j = _depth_errors(ws_j, field, "photometric")
    e_t = _depth_errors(ws_t, field, "photometric")
    print("photometric median/p80 relative depth error: sba_tpu",
          e_j.mean(0), "port", e_t.mean(0))
    assert (e_t.mean(0) <= 1.25 * e_j.mean(0) + 0.02).all()

    # The port's geometric pass, warm-started from its photometric maps.
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.run_patch_match_stereo(dict(
            workspace_path=ws_t, device="cpu", **dict(
                pm, **{"PatchMatchStereo.geom_consistency": "true"})))
    geo = sorted(f for f in os.listdir(os.path.join(ws_t, "stereo",
                                                    "depth_maps"))
                 if f.endswith(".geometric.bin"))
    assert geo == sorted(f"{n}.geometric.bin" for n in names)

    # stereo_fuser fed sba_tpu's maps writes sba_tpu's cloud. (The
    # maps' normals come from a search that has not converged, so the
    # normal test is opened and two views suffice.)
    fuse = {"StereoFusion.min_num_pixels": "2",
            "StereoFusion.max_normal_error": "180"}
    for tag, mod, dev in (("jax", jcli, {}), ("torch", tcli,
                                              {"device": "cpu"})):
        with contextlib.redirect_stdout(io.StringIO()):
            mod.run_stereo_fuser(dict(workspace_path=ws_j, output_path=str(
                tmp_path / f"{tag}.ply"), **fuse, **dev))
    body = {t: (tmp_path / f"{t}.ply").read_text().split("end_header\n")
            for t in ("jax", "torch")}
    assert body["torch"][0] == body["jax"][0]
    rows = {t: np.array([[float(x) for x in l.split()]
                         for l in body[t][1].splitlines()]).reshape(-1, 9)
            for t in body}
    assert len(rows["jax"]) > 100
    np.testing.assert_allclose(rows["torch"], rows["jax"], rtol=1e-9,
                               atol=1e-9)
    assert (tmp_path / "torch.ply.vis").read_bytes() \
        == (tmp_path / "jax.ply.vis").read_bytes()


# ---------------------------------------------------------------------------
# The accuracy measures of the dense chain (sba_tpu_torch.utils.mvs_accuracy)
# ---------------------------------------------------------------------------


def test_mvs_accuracy_reads_the_truth_as_exact(tmp_path):
    """The measures that gate the card's dense run read the rendered
    depths, written as the maps of a pinhole workspace, as exact (to
    their float32 rounding), a map 10% off on half its pixels as that,
    and points on the heightfield at known heights as those heights."""
    from sba_tpu_torch.mvs import write_colmap_map
    from sba_tpu_torch.utils import mvs_accuracy as ma
    from sba_tpu_torch.utils.render import (_Heightfield, gt_reconstruction,
                                            render_scene)

    scene = render_scene(num_images=2, image_size=(40, 30), seed=3,
                         device="cpu")
    names = [f"v{k}.png" for k in range(2)]
    gt_reconstruction(scene, names).write(str(tmp_path / "sparse"))
    maps = tmp_path / "stereo" / "depth_maps"
    maps.mkdir(parents=True)
    for name, d in zip(names, scene["depths"]):
        write_colmap_map(d, str(maps / f"{name}.photometric.bin"))
        off = 1.1 * d
        off[:, :20] = 0.0
        write_colmap_map(off, str(maps / f"{name}.geometric.bin"))
    field = _Heightfield(5.0, 0.55, 3)
    acc = ma.depth_map_accuracy(tmp_path, field)
    assert acc["photometric"]["valid"] == 1.0
    assert acc["photometric"]["p80"] < 1e-6
    assert acc["photometric"]["within1"] == 1.0
    assert acc["geometric"]["valid"] == 0.5
    assert abs(acc["geometric"]["median"] - 0.1) < 1e-6
    assert acc["geometric"]["within1"] == 0.0

    xy = np.random.default_rng(0).uniform(-1, 1, (5, 2))
    z = field.z(_t(xy[:, 0]), _t(xy[:, 1])).numpy()
    dz = np.array([0.0, 0.01, 0.02, 0.03, 0.04])
    c = ma.cloud_accuracy(np.column_stack([xy, z + dz]), field)
    assert c["points"] == 5 and abs(c["median"] - 0.02) < 1e-12
    assert ma.cloud_accuracy(np.zeros((0, 3)), field)["points"] == 0


def test_mvs_accuracy_script_runs_the_chain(capsys):
    """`python -m sba_tpu_torch.utils.mvs_accuracy` on a tiny scene on the
    CPU: both passes measured, one cloud per fusion option set, the
    patch_match_stereo flags passed through and recorded."""
    import json

    from sba_tpu_torch.utils import mvs_accuracy as ma

    pm = ["--PatchMatchStereo.window_radius", "1",
          "--PatchMatchStereo.num_iterations", "2"]
    assert ma.main(["--num_images", "3", "--size", "32", "24",
                    "--sparse_stride", "4", "--device", "cpu", *pm]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["patch_match"] == pm and rec["size"] == [32, 24]
    assert sorted(rec["maps"]) == ["geometric", "photometric"]
    assert 0.5 < rec["maps"]["photometric"]["valid"] <= 1.0
    assert [c["fusion"] for c in rec["clouds"]] == list(ma.FUSION_SETS)
