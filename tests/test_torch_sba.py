"""Parity of the port's semantic bundle adjustment with sba_tpu on the
CPU.

The same numpy scene (`make_sba_scene`, the port's copy is checked
bit-identical) goes through sba_tpu and through sba_tpu_torch; sba_tpu's
problem is carried across with `sba_problem_from_numpy`. Held: the
packers (word for word), the samplers (1e-12 in float64, 1e-6 in
float32, edge and out-of-bounds points included), the soft and hard
pair residuals and statuses, the analytic blocks, the forward-mode and
numeric Jacobians, the assembled (chunked) system, whole solves, the
map IO, the controller and the `semantic_bundle_adjuster` command.
Map samples on CPU tensors go through the gather twins.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the cap)
import torch
from threadpoolctl import threadpool_limits

import sba_tpu.ops.interpolation as jint
import sba_tpu.optim.sba as jsba
import sba_tpu_torch.ops.interpolation as tint
import sba_tpu_torch.optim.sba as tsba
from sba_tpu.utils.synthetic import make_sba_scene as j_make_sba_scene
from sba_tpu_torch.utils.synthetic import make_sba_scene

# Under pytest-xdist every worker imports every test module while it
# collects, so these caps hold for all the tests that a worker runs.
# Six workers with eight-thread BLAS pools oversubscribe the cores, and
# a host solver that makes many small BLAS calls (scipy's L-BFGS-B in the
# GR6P RANSAC of test_generalized_relative_pose.py) then runs four to
# eight times slower. numpy's and scipy's pools are both held to one.
torch.set_num_threads(2)
threadpool_limits(1, user_api="blas")


def _carry(p, device="cpu"):
    """sba_tpu's SBAProblem -> the port's, through numpy."""
    return tsba.sba_problem_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in p._asdict().items()}, device)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# Scenes and problems
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(num_images=4, image_size=(64, 48), pose_noise=0.01, seed=3),
    dict(num_images=3, image_size=(40, 30), pose_noise=0.02, cell=0.5,
         seed=5, num_labels=12),
])
def test_make_sba_scene_is_bit_identical(kw):
    for a, b in zip(j_make_sba_scene(**kw), make_sba_scene(**kw)):
        np.testing.assert_array_equal(a, b)


def _sem16(sem):
    """The scene's labels plus 12 more: a 17-label palette, so that the
    float32 problem takes the two-map path."""
    s = sem.copy()
    for k in range(12):
        s[:, k, k] = 100 + k
    return s


@pytest.fixture(scope="module")
def scene7():
    return make_sba_scene(num_images=5, image_size=(64, 48),
                          pose_noise=0.02, seed=7)


@pytest.fixture(scope="module", params=["f64", "f32-joint", "f32-pair"])
def problems(request, scene7):
    """(sba_tpu problem, carried port problem, options) on scene 7."""
    qg, tg, cam, depth, sem, qn, tn = scene7
    jdt = jnp.float64 if request.param == "f64" else jnp.float32
    if request.param == "f32-pair":
        sem = _sem16(sem)
    opt = jsba.SBAOptions(pixel_step=3)
    pj = jsba.build_sba_problem(qn, tn, cam, depth, sem, opt, dtype=jdt)
    return request.param, pj, _carry(pj), opt


def test_build_matches_carried_problem(problems, scene7):
    kind, pj, pt, opt = problems
    qg, tg, cam, depth, sem, qn, tn = scene7
    if kind == "f32-pair":
        sem = _sem16(sem)
        assert pt.pair_packed is not None and pt.joint_packed is None
    elif kind == "f32-joint":
        assert pt.joint_packed is not None and pt.pair_packed is None
    dt = torch.float64 if kind == "f64" else torch.float32
    pb = tsba.build_sba_problem(qn, tn, cam, depth, sem,
                                tsba.SBAOptions(pixel_step=3), dtype=dt,
                                device="cpu")
    for name in tsba.SBAProblem._fields:
        a, b = getattr(pt, name), getattr(pb, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), name


# ---------------------------------------------------------------------------
# Packers and samplers
# ---------------------------------------------------------------------------

def test_packers_are_word_identical(scene7):
    depth, sem = scene7[3][1], scene7[4][1]
    np.testing.assert_array_equal(
        tint.pack_label_neighborhood(sem.astype(np.int64)),
        jint.pack_label_neighborhood(sem.astype(np.int64)))
    for a, b in zip(tint.pack_depth_nbhd_u8(depth),
                    jint.pack_depth_nbhd_u8(depth)):
        np.testing.assert_array_equal(a, b)
    codes = np.searchsorted(np.unique(sem), sem)
    for a, b in zip(tint.pack_joint_nbhd(depth, codes),
                    jint.pack_joint_nbhd(depth, codes)):
        np.testing.assert_array_equal(a, b)
    # The joint word fills all 32 bits: the top code sits at bits 29-31.
    w, _, _ = tint.pack_joint_nbhd(depth, np.full_like(codes, 7))
    assert (w >> 29 == 7).all()
    assert (tint.as_int32_words(w) < 0).all()


def _points(H, W, n=400, seed=0):
    """Sample points inside, on the edges of and outside an H x W map."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, W + 1.0, n)
    y = rng.uniform(-2.0, H + 1.0, n)
    x[:8] = [0.0, W - 1.0, W - 1.0, 0.0, W - 1.5, -0.5, W - 0.5, 3.0]
    y[:8] = [0.0, H - 1.0, 0.0, H - 1.0, H - 1.0, 2.0, 2.0, H - 0.5]
    return x, y


def test_unpacked_samplers_match_f64(scene7):
    depth, sem = scene7[3], scene7[4]
    N, H, W = depth.shape
    x, y = _points(H, W)
    base = np.repeat(np.arange(N) * H * W, len(x) // N + 1)[:len(x)]
    label = sem.reshape(N, -1)[:, 5][base // (H * W)]
    jb = jnp.asarray(base, jnp.int32)
    tb = _t(base.astype(np.int32))
    for jf, tf, args in (
            (jint.bilinear_flat, tint.bilinear_flat, ()),
            (jint.bilinear_label_agreement_flat_raw,
             tint.bilinear_label_agreement_flat_raw, (label,))):
        ref = jf(jnp.asarray(depth if not args else sem).reshape(-1), H, W,
                 jb, jnp.asarray(x), jnp.asarray(y),
                 *[jnp.asarray(a) for a in args], fill=-3.0)
        got = tf(_t(depth if not args else sem).reshape(-1), H, W, tb,
                 _t(x), _t(y), *[_t(a) for a in args], fill=-3.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-12)
    xy = np.stack([x, y], -1)
    for jf, tf, extra in (
            (jint.nearest_sample2d, tint.nearest_sample2d, ()),
            (jint.bilinear_label_agreement, tint.bilinear_label_agreement,
             (label,))):
        m = sem[1] if extra else depth[1]
        ref = jf(jnp.asarray(m), jnp.asarray(xy),
                 *[jnp.asarray(a) for a in extra])
        got = tf(_t(m), _t(xy), *[_t(a) for a in extra])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-12)


def test_rounding_is_half_to_even():
    """Exact .5 positions round to the even neighbour in both packages
    (status counts are compared exactly)."""
    m = np.arange(48.0).reshape(6, 8)
    xy = np.array([[0.5, 0.5], [1.5, 2.5], [2.5, 3.5], [6.5, 4.5],
                   [-0.5, 0.0], [7.5, 5.5], [3.5, -0.5]])
    ref = np.asarray(jint.nearest_sample2d(jnp.asarray(m), jnp.asarray(xy),
                                           fill=-1.0))
    got = tint.nearest_sample2d(_t(m), _t(xy), fill=-1.0).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:4], [0.0, 18.0, 34.0, 38.0])


def test_packed_samplers_match_f32(scene7):
    depth, sem = scene7[3].astype(np.float32), scene7[4]
    N, H, W = depth.shape
    codes = np.searchsorted(np.unique(sem), sem)
    dp = [jint.pack_depth_nbhd_u8(d) for d in depth]
    jp = [jint.pack_joint_nbhd(d, c) for d, c in zip(depth, codes)]
    d_words = np.stack([p[0] for p in dp]).reshape(-1)
    l_words = np.stack([jint.pack_label_neighborhood(s.astype(np.int64))
                        for s in sem]).reshape(-1)
    j_words = np.stack([p[0] for p in jp]).reshape(-1)
    x, y = _points(H, W, seed=1)
    x, y = x.astype(np.float32), y.astype(np.float32)
    m = np.repeat(np.arange(N), len(x) // N + 1)[:len(x)]
    base = (m * H * W).astype(np.int32)
    label = sem.reshape(N, -1)[:, 7][m].astype(np.float32)
    code = codes.reshape(N, -1)[:, 7][m].astype(np.int32)
    lo = np.array([p[1] for p in dp])[m]
    hi = np.array([p[2] for p in dp])[m]
    jlo = np.array([p[1] for p in jp])[m]
    jhi = np.array([p[2] for p in jp])[m]
    J = {k: jnp.asarray(v) for k, v in dict(
        x=x, y=y, b=base, lab=label, code=code, lo=lo, hi=hi, jlo=jlo,
        jhi=jhi, d=d_words, l=l_words, j=j_words).items()}
    T = {k: _t(v) for k, v in dict(
        x=x, y=y, b=base, lab=label, code=code, lo=lo, hi=hi, jlo=jlo,
        jhi=jhi).items()}
    T.update(d=_t(tint.as_int32_words(d_words)),
             l=_t(tint.as_int32_words(l_words)),
             j=_t(tint.as_int32_words(j_words)),
             pair=_t(tint.pair_table(d_words, l_words)))

    def close(got, ref):
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-6 * max(1.0, float(
                                           np.abs(np.asarray(r)).max())))

    xy = (H, W)
    close(tint.bilinear_depth_u8_flat(T["d"], *xy, T["b"], T["x"], T["y"],
                                      T["lo"], T["hi"], fill=-1e6),
          jint.bilinear_depth_u8_flat(J["d"], *xy, J["b"], J["x"], J["y"],
                                      J["lo"], J["hi"], fill=-1e6))
    close(tint.bilinear_depth_u8_grad(T["d"], *xy, T["b"], T["x"], T["y"],
                                      T["lo"], T["hi"], fill=-1e6),
          jint.bilinear_depth_u8_grad(J["d"], *xy, J["b"], J["x"], J["y"],
                                      J["lo"], J["hi"], fill=-1e6))
    close(tint.bilinear_label_agreement_flat(T["l"], *xy, T["b"], T["x"],
                                             T["y"], T["lab"]),
          jint.bilinear_label_agreement_flat(J["l"], *xy, J["b"], J["x"],
                                             J["y"], J["lab"]))
    ref_a = jint.bilinear_label_agreement_grad(J["l"], *xy, J["b"], J["x"],
                                               J["y"], J["lab"])
    close(tint.bilinear_label_agreement_grad(T["l"], *xy, T["b"], T["x"],
                                             T["y"], T["lab"]), ref_a)
    ref_d = jint.bilinear_depth_u8_grad(J["d"], *xy, J["b"], J["x"],
                                        J["y"], J["lo"], J["hi"],
                                        fill=-1e6)
    close(tint.bilinear_depth_label_grad(T["pair"], *xy, T["b"], T["x"],
                                         T["y"], T["lab"], T["lo"],
                                         T["hi"], depth_fill=-1e6),
          (*ref_d, *ref_a))
    close(tint.bilinear_depth_label_flat(T["pair"], *xy, T["b"], T["x"],
                                         T["y"], T["lab"], T["lo"],
                                         T["hi"], depth_fill=-1e6),
          (ref_d[0], ref_a[0]))
    close(tint.bilinear_joint_grad(T["j"], *xy, T["b"], T["x"], T["y"],
                                   T["code"], T["jlo"], T["jhi"],
                                   depth_fill=-1e6),
          jint.bilinear_joint_grad(J["j"], *xy, J["b"], J["x"], J["y"],
                                   J["code"], J["jlo"], J["jhi"],
                                   depth_fill=-1e6))
    close(tint.bilinear_joint_flat(T["j"], *xy, T["b"], T["x"], T["y"],
                                   T["code"], T["jlo"], T["jhi"],
                                   depth_fill=-1e6),
          jint.bilinear_joint_flat(J["j"], *xy, J["b"], J["x"], J["y"],
                                   J["code"], J["jlo"], J["jhi"],
                                   depth_fill=-1e6))


# ---------------------------------------------------------------------------
# Solver pieces on the same problem
# ---------------------------------------------------------------------------

def _tol(kind):
    """float64: 1e-9 relative; float32: 1e-5 of scale."""
    return 1e-9 if kind == "f64" else 1e-5


def test_pair_residuals_and_statuses_match(problems):
    kind, pj, pt, opt = problems
    topt = tsba.SBAOptions(pixel_step=3)
    for soft in (True, False):
        ref = np.asarray(jsba._all_residuals(pj.qvecs, pj.tvecs, pj, opt,
                                             soft))
        got = tsba._all_residuals(pt.qvecs, pt.tvecs, pt, topt, soft)
        assert _rel(got, ref) <= _tol(kind) if soft else \
            np.array_equal(got.numpy(), ref)
    ref = jsba.evaluate_hard(pj, opt)
    got = tsba.evaluate_hard(pt, topt)
    np.testing.assert_array_equal(got["status"].numpy(),
                                  np.asarray(ref["status"]))
    for k in ("num_valid", "num_out_of_bounds", "num_invalid_depth",
              "num_label_mismatch"):
        assert int(got[k]) == int(ref[k]), k


def _blocks(mod, p, opt, analytic):
    if analytic:
        return mod._pair_blocks_analytic(p, opt, p.pair_src, p.pair_dst,
                                         p.pair_mask)
    r, J, c = mod._pair_jacobians(p, opt, p.pair_src, p.pair_dst,
                                  p.pair_mask)
    return r, J, c


def test_linearizations_match(problems):
    """Analytic (Hq, gq, cost) where the maps are packed; the forward-
    mode and numeric Jacobians J everywhere."""
    kind, pj, pt, opt = problems
    topt = tsba.SBAOptions(pixel_step=3)
    tol = _tol(kind)
    if kind != "f64":
        assert tsba._use_analytic(pt, topt)
        Hq, gq, c = _blocks(jsba, pj, opt, True)
        Hq_t, gq_t, c_t = _blocks(tsba, pt, topt, True)
        assert _rel(Hq_t, Hq) <= tol and _rel(gq_t, gq) <= tol
        assert _rel(c_t, c) <= tol
    for mode, lin in (("soft", "jacfwd"), ("hard_numeric", "jacfwd")):
        o = dataclasses.replace(opt, mode=mode, linearize=lin)
        to = dataclasses.replace(topt, mode=mode, linearize=lin)
        r, J, c = _blocks(jsba, pj, o, False)
        r_t, J_t, c_t = _blocks(tsba, pt, to, False)
        assert _rel(r_t, r) <= tol and _rel(c_t, c) <= tol, mode
        assert _rel(J_t, J) <= tol, mode


@pytest.mark.parametrize("chunk", [0, 5])
def test_assembled_system_matches(problems, chunk):
    """H, g and cost of `_linearize_system`, whole and in chunks of 5
    pairs (20 pairs: 4 chunks)."""
    kind, pj, pt, opt = problems
    opt = dataclasses.replace(opt, pair_chunk=chunk)
    topt = tsba.SBAOptions(pixel_step=3, pair_chunk=chunk)
    H, g, c = jsba._linearize_system(pj, opt)
    H_t, g_t, c_t = tsba._linearize_system(pt, topt)
    tol = _tol(kind)
    assert _rel(H_t, H) <= tol and _rel(g_t, g) <= tol
    assert _rel(c_t, c) <= tol


def test_sharded_pairs_raise(problems):
    """`SBAOptions.axis_name` solves sharded: the pairs over one rank
    (`semantic_bundle_adjust_spmd` in a world of this process alone)
    give `semantic_bundle_adjust`'s solve bit for bit, counts included."""
    from sba_tpu_torch.parallel import group, semantic_bundle_adjust_spmd

    _, _, pt, _ = problems
    opt = tsba.SBAOptions(pixel_step=3, max_iterations=3)
    ref, rs = tsba.semantic_bundle_adjust(pt, opt)
    with group.single_rank():
        out, s = semantic_bundle_adjust_spmd(pt, opt)
    for f in ("qvecs", "tvecs"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    for f in ("initial_cost", "final_cost", "num_residuals", "num_valid",
              "num_label_mismatch"):
        assert torch.equal(getattr(s, f), getattr(rs, f)), f


# ---------------------------------------------------------------------------
# Whole solves (the scenes of tests/test_sba.py)
# ---------------------------------------------------------------------------

_SOLVES = {
    # test_sba.py:245 (analytic, float32)
    "soft-analytic-f32": (
        dict(num_images=4, image_size=(64, 48), pose_noise=0.01, seed=11),
        dict(pixel_step=4, max_iterations=15), jnp.float32),
    # test_sba.py:116 (soft, float64: forward mode)
    "soft-jacfwd-f64": (
        dict(num_images=4, image_size=(64, 48), pose_noise=0.02, cell=0.5,
             seed=2),
        dict(pixel_step=2, max_iterations=40), jnp.float64),
    # test_sba.py:146 (hard numeric, float64)
    "hard-numeric-f64": (
        dict(num_images=3, image_size=(64, 48), pose_noise=0.02, cell=0.5,
             seed=5),
        dict(pixel_step=2, mode="hard_numeric", max_iterations=30),
        jnp.float64),
}


@pytest.mark.parametrize("case", list(_SOLVES))
def test_solve_matches_sba_tpu(case):
    """float32: final cost rtol 1e-3, poses 5e-3; float64: 1e-6; the
    hard status counts at the solution equal in float64."""
    scene_kw, opt_kw, jdt = _SOLVES[case]
    _, _, cam, depth, sem, q0, t0 = make_sba_scene(**scene_kw)
    pj = jsba.build_sba_problem(q0, t0, cam, depth, sem,
                                jsba.SBAOptions(**opt_kw), dtype=jdt)
    out_j, s_j = jsba.semantic_bundle_adjust(pj, jsba.SBAOptions(**opt_kw))
    out_t, s_t = tsba.semantic_bundle_adjust(_carry(pj),
                                             tsba.SBAOptions(**opt_kw))
    tol = (1e-3, 5e-3) if jdt == jnp.float32 else (1e-6, 1e-6)
    assert abs(float(s_t.final_cost) - float(s_j.final_cost)) \
        <= tol[0] * float(s_j.final_cost)
    assert float(s_t.final_cost) < float(s_t.initial_cost)
    for a, b in ((out_t.qvecs, out_j.qvecs), (out_t.tvecs, out_j.tvecs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol[1])
    if jdt == jnp.float64:
        assert s_t.num_iterations == int(s_j.num_iterations)
        for k in ("num_valid", "num_out_of_bounds", "num_invalid_depth",
                  "num_label_mismatch"):
            assert int(getattr(s_t, k)) == int(getattr(s_j, k)), k


def _pose_errors(q, t, q_gt, t_gt):
    q = np.asarray(q, np.float64)
    d = np.abs(np.sum(q * q_gt, axis=-1)) / np.linalg.norm(q, axis=-1)
    return (float(2 * np.degrees(np.arccos(np.clip(d, -1, 1))).max()),
            float(np.abs(np.asarray(t, np.float64) - t_gt).max()))


def test_pose_errors_track_sba_tpu_640x480():
    """8 images of the bench_sba scene (640x480, focal 500, pose noise
    0.003, seed 0; float32, 10 LM iterations, tolerances off): the port
    ends where sba_tpu ends (cost rtol 1e-3, poses 5e-3), and in both
    the cost, the largest rotation error and the hard label mismatches
    fall. The largest translation error is printed, not held: both
    solves raise it over these iterations (trading it against the
    rotation), which is why the card smoke does not gate it."""
    q_gt, t_gt, cam, depth, sem, q0, t0 = make_sba_scene(
        num_images=8, image_size=(640, 480), focal=500.0, pose_noise=0.003,
        seed=0)
    kw = dict(pixel_step=10, max_iterations=10, function_tolerance=0.0,
              gradient_tolerance=0.0, parameter_tolerance=0.0)
    pj = jsba.build_sba_problem(q0, t0, cam, depth, sem,
                                jsba.SBAOptions(**kw), dtype=jnp.float32)
    out_j, s_j = jsba.semantic_bundle_adjust(pj, jsba.SBAOptions(**kw))
    pt = _carry(pj)
    mis0 = int(tsba.evaluate_hard(pt, tsba.SBAOptions(**kw))[
        "num_label_mismatch"])
    out_t, s_t = tsba.semantic_bundle_adjust(pt, tsba.SBAOptions(**kw))
    assert abs(float(s_t.final_cost) - float(s_j.final_cost)) \
        <= 1e-3 * float(s_j.final_cost)
    np.testing.assert_allclose(out_t.qvecs.numpy(), np.asarray(out_j.qvecs),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(out_t.tvecs.numpy(), np.asarray(out_j.tvecs),
                               rtol=0, atol=5e-3)
    e0 = _pose_errors(q0, t0, q_gt, t_gt)
    for name, out, s in (("sba_tpu", out_j, s_j), ("port", out_t, s_t)):
        e1 = _pose_errors(out.qvecs, out.tvecs, q_gt, t_gt)
        print(f"{name}: cost {float(s.initial_cost):.6g} -> "
              f"{float(s.final_cost):.6g}; rotation {e0[0]:.4f} -> "
              f"{e1[0]:.4f} deg; translation {e0[1]:.5f} -> {e1[1]:.5f}; "
              f"mismatches {mis0} -> {int(s.num_label_mismatch)}")
        assert float(s.final_cost) < float(s.initial_cost)
        assert e1[0] < e0[0] and int(s.num_label_mismatch) < mis0


# ---------------------------------------------------------------------------
# IO, model filter, controller and CLI
# ---------------------------------------------------------------------------

def test_map_io_round_trip(tmp_path):
    from sba_tpu.io import maps as jmaps
    from sba_tpu_torch.io import maps as tmaps

    rng = np.random.default_rng(0)
    d = rng.uniform(1, 9, (7, 11)).astype(np.float32)
    tmaps.write_float_map_tiff(d, tmp_path / "a_depth.tiff")
    jmaps.write_float_map_tiff(d + 1, tmp_path / "a_semantic.tiff")
    np.testing.assert_array_equal(
        tmaps.read_float_map_tiff(tmp_path / "a_depth.tiff"), d)
    (tmp_path / "sub").mkdir()
    tmaps.write_float_map_tiff(d, tmp_path / "sub" / "b_extra_depth.tif")
    for name, kind in (("a.png", "depth"), ("x/a.jpg", "semantic"),
                       ("b.png", "depth")):
        root = str(tmp_path / ("sub" if name == "b.png" else ""))
        assert tmaps.find_map_path(root, name, kind) == \
            jmaps.find_map_path(root, name, kind)
    with pytest.raises(FileNotFoundError):
        tmaps.find_map_path(str(tmp_path), "c.png", "depth")
    dm, sm = tmaps.load_depth_semantic_maps(str(tmp_path), ["a.png"])
    np.testing.assert_array_equal(dm[0], d)
    np.testing.assert_array_equal(sm[0], d + 1)
    tmaps.write_matrix_jpeg(d, tmp_path / "t.jpg")
    jmaps.write_matrix_jpeg(d, tmp_path / "j.jpg")
    assert (tmp_path / "t.jpg").read_bytes() == \
        (tmp_path / "j.jpg").read_bytes()


def test_negative_depth_filter_matches_sba_tpu(tmp_path):
    from sba_tpu.models.reconstruction import Reconstruction as JRec
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.utils.synthetic import make_synthetic_reconstruction

    rec = make_synthetic_reconstruction(num_images=6, num_points=120,
                                        seed=1)
    # Push some points behind the cameras.
    for pid in list(rec.points3D)[::7]:
        rec.points3D[pid].xyz = rec.points3D[pid].xyz * np.array(
            [1.0, 1.0, -3.0])
    rec.write(str(tmp_path))
    t_rec, j_rec = Reconstruction.read(str(tmp_path)), JRec.read(
        str(tmp_path))
    n_t = t_rec.filter_observations_with_negative_depth()
    n_j = j_rec.filter_observations_with_negative_depth()
    assert n_t == n_j > 0
    assert sorted(t_rec.points3D) == sorted(j_rec.points3D)
    for iid in j_rec.images:
        np.testing.assert_array_equal(t_rec.images[iid].point3D_ids,
                                      j_rec.images[iid].point3D_ids)


@pytest.fixture
def workspace(tmp_path):
    from test_cli_semantic import _write_sba_workspace

    return tmp_path, _write_sba_workspace(tmp_path)


def test_cli_matches_sba_tpu(workspace, capsys):
    """`semantic_bundle_adjuster --device cpu` writes the poses sba_tpu's
    command writes (float64, forward mode: 1e-9)."""
    from sba_tpu.cli import main as jmain
    from sba_tpu_torch.cli import main as tmain
    from sba_tpu_torch.models.reconstruction import Reconstruction

    tmp, (inp, data, (q_gt, t_gt, q0, t0)) = workspace
    flags = ["--input_path", inp, "--data_path", data,
             "--run_path", str(tmp / "run"),
             "--SemanticBundleAdjustment.pixel_step", "2",
             "--SemanticBundleAdjustment.max_iterations", "30"]
    assert jmain(["semantic_bundle_adjuster", "--output_path",
                  str(tmp / "j"), *flags]) == 0
    j_out = capsys.readouterr().out
    assert tmain(["semantic_bundle_adjuster", "--output_path",
                  str(tmp / "t"), "--device", "cpu", *flags]) == 0
    t_out = capsys.readouterr().out
    line = re.compile(r"SBA: cost \S+ -> \S+ in \d+ iters")
    assert line.search(t_out).group(0) == line.search(j_out).group(0)
    a, b = Reconstruction.read(str(tmp / "t")), Reconstruction.read(
        str(tmp / "j"))
    for iid in b.images:
        np.testing.assert_allclose(a.images[iid].qvec, b.images[iid].qvec,
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(a.images[iid].tvec, b.images[iid].tvec,
                                   rtol=0, atol=1e-9)
    assert np.abs(np.stack([a.images[i + 1].tvec for i in range(4)])
                  - t_gt).max() < 0.12


def test_cli_rejects_radial(workspace):
    from sba_tpu_torch.cli import main as tmain
    from sba_tpu_torch.geometry import camera_models
    from sba_tpu_torch.io.colmap_models import Camera
    from sba_tpu_torch.models.reconstruction import Reconstruction

    tmp, (inp, data, _) = workspace
    rec = Reconstruction.read(inp)
    cam = rec.cameras[1]
    rec.cameras[1] = Camera(
        camera_id=1,
        model_id=camera_models.model_by_name("SIMPLE_RADIAL").model_id,
        width=cam.width, height=cam.height,
        params=np.concatenate([cam.params, [0.01]]))
    bad = tmp / "radial"
    bad.mkdir()
    rec.write(str(bad))
    with pytest.raises(ValueError, match="SIMPLE_PINHOLE"):
        tmain(["semantic_bundle_adjuster", "--input_path", str(bad),
               "--output_path", str(tmp / "o"), "--data_path", data,
               "--device", "cpu"])


def test_export_steps_writes_each_iteration(workspace):
    """The controller's per-iteration export: one text model per LM
    iteration (images without keypoints, whose POINTS2D line is empty,
    read back), the last one the final model."""
    from sba_tpu_torch.controllers.semantic_ba import (
        SemanticBAControllerOptions, run_semantic_bundle_adjustment)
    from sba_tpu_torch.models.reconstruction import Reconstruction

    tmp, (inp, data, _) = workspace
    opt = SemanticBAControllerOptions(
        input_path=inp, output_path=str(tmp / "out"), data_path=data,
        run_path=str(tmp / "run"), export_steps=True,
        sba=tsba.SBAOptions(pixel_step=4, max_iterations=3))
    rec = run_semantic_bundle_adjustment(opt, device="cpu")
    steps = sorted((tmp / "run" / "optim_steps").iterdir())
    assert [p.name for p in steps] == ["step_0", "step_1", "step_2"]
    last = Reconstruction.read(str(steps[-1]))
    for iid, im in rec.images.items():
        np.testing.assert_array_equal(last.images[iid].tvec, im.tvec)
    first = Reconstruction.read(str(steps[0]))
    assert any(not np.array_equal(first.images[i].tvec,
                                  Reconstruction.read(inp).images[i].tvec)
               for i in first.images)
