"""The plain twins of the port's kernels K1/K4/K5 and its fused solve
against sba_tpu's Pallas kernels run in interpret mode on the CPU.

Tolerances are those of tests/test_ba_fused.py for the f32 kernel path:
cost rtol 1e-4, payloads 1e-5 of their scale, S_corr / Ey 3e-5 of theirs;
the one-step and whole-solve checks use that file's step tolerances and
final cost rtol 1e-3 / poses atol 5e-3. Rows computed through the damped
3x3 point inverse (Hpp^-1, Lp, the whitened couplings WL and the point
step dp) are held at 1e-4 of their scale: for a point seen from one
image Hpp has rank 2 and its inverse amplifies f32 rounding by up to
1/lambda, so two correct f32 evaluations differ there at ~1e-4.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_tpu.ops import ba_kernels as jbk
from sba_tpu.optim import ba_fused as jbf
from sba_tpu.optim.ba import BAOptions as JOpt
from sba_tpu.optim.ba import to_point_major as j_to_point_major
from sba_tpu.utils.synthetic import make_ba_problem as j_make_ba_problem
from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.ops import ba_kernels as tbk
from sba_tpu_torch.optim import ba_fused as tbf
from sba_tpu_torch.optim.ba import BAOptions as TOpt
from sba_tpu_torch.optim.ba import problem_from_numpy

torch.set_num_threads(1)

# tests/test_ba_fused.py's small nonzero distortion per camera model, so
# that every analytic head runs off its pinhole special case.
_DISTORT = {
    2: {3: 0.02},
    3: {3: 0.02, 4: -0.005},
    4: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3},
    5: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3},
    6: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3, 8: 1e-3,
        9: 0.01, 10: -2e-3, 11: 5e-4},
    7: {4: 0.08},
    8: {3: 0.02},
    9: {3: 0.02, 4: -0.005},
    10: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3, 8: 1e-3, 9: -5e-4,
         10: 8e-4, 11: -6e-4},
}
# Normalized offsets (u = v) from the principal point of image 0 for the
# near-axis points of `_setup(center=True)`: exactly on the axis, under
# and just over the fisheye heads' r < 1e-8 guard, and under and over
# FOV's r^2 < 1e-4 one.
_NEAR_AXIS = (0.0, 3e-9, 2e-8, 4e-3, 6.5e-3, 9e-3)


def _numpy_fields(problem):
    return {k: np.asarray(v) for k, v in problem._asdict().items()
            if v is not None}


def _cut_tracks(problem, K):
    """`problem` point-major with K slots a point: each track cut to its
    first K observations, the short tracks' slots dead (mask 0)."""
    op = np.asarray(problem.obs_point)
    order = np.argsort(op, kind="stable")
    slot = np.empty_like(op)
    slot[order] = np.arange(len(op)) - np.searchsorted(op[order], op[order])
    obs = ("obs_image", "obs_point", "obs_cam", "obs_xy", "obs_mask")
    pm = j_to_point_major(problem._replace(
        **{k: np.asarray(getattr(problem, k))[slot < K] for k in obs}))
    P = len(pm.points)
    return pm._replace(**{
        k: np.asarray(getattr(pm, k)).reshape((P, -1) + np.shape(
            getattr(pm, k))[1:])[:, :K].reshape((P * K,) + np.shape(
                getattr(pm, k))[1:])
        for k in obs})


def _near_axis(problem):
    """Image 0 at the identity pose, and one point it sees moved onto
    each ray of `_NEAR_AXIS`, so that its lanes there have r = |(u, v)|
    at those offsets (exactly 0 for the first)."""
    oi = np.asarray(problem.obs_image)
    seen = np.unique(np.asarray(problem.obs_point)[oi == 0])
    pts = np.array(problem.points)
    for p, e in zip(seen, _NEAR_AXIS):
        depth = 8.0 + p % 3
        pts[p] = (e * depth, e * depth, depth)
    q = np.array(problem.qvecs)
    t = np.array(problem.tvecs)
    q[0], t[0] = (1.0, 0.0, 0.0, 0.0), 0.0
    return problem._replace(qvecs=q, tvecs=t, points=pts)


def _setup(model_id=0, pixel_noise=0.0, K=None, center=False):
    """One f32 scene in both packages' kernel layouts (sba_tpu's
    tests/test_ba_fused.py::_setup); with K, 24 images whose random
    tracks are cut to K slots a point (`_cut_tracks`); with `center`,
    points on and near image 0's optical axis (`_near_axis`)."""
    size = (dict(num_images=6, observations_per_point=4, seed=0)
            if K is None else
            dict(num_images=24, observations_per_point=(3 * K) // 4, seed=K))
    problem, _ = j_make_ba_problem(
        num_points=150, pose_noise=0.01, point_noise=0.05,
        pixel_noise=pixel_noise, dtype=jnp.float32, model_id=model_id,
        **size)
    cam = np.array(problem.cam_params)
    for i, val in _DISTORT.get(model_id, {}).items():
        cam[:, i] = val
    problem = problem._replace(cam_params=jnp.asarray(cam, jnp.float32))
    if center:
        problem = _near_axis(problem)
    kw = dict(model_id=model_id, dtype="float32", schur_bf16=False,
              cg_iterations=200, cg_tolerance=1e-9)
    opt_j = JOpt(solver="explicit_schur", obs_layout="point_major", **kw)
    opt_t = TOpt(solver="explicit_schur", **kw)
    pm = j_to_point_major(problem) if K is None else _cut_tracks(problem, K)
    lay_j = jbk.plan_layout(pm, opt_j)
    st_j = jbk.build_static(pm, opt_j, lay_j)
    par_j = jbk.pack_params(pm.qvecs.astype(jnp.float32),
                            pm.tvecs.astype(jnp.float32),
                            pm.cam_params.astype(jnp.float32),
                            st_j.image_cam, lay_j)
    pts_j = jbk.pack_points(jnp.asarray(pm.points, jnp.float32), lay_j)

    fields = _numpy_fields(pm)
    lay_t = tbk.plan_layout(fields, opt_t)
    st_t = tbk.build_static(fields, opt_t, lay_t, "cpu")
    f32 = lambda name: torch.tensor(fields[name], dtype=torch.float32)
    par_t = tbk.pack_params(f32("qvecs"), f32("tvecs"), f32("cam_params"),
                            st_t.image_cam, lay_t)
    pts_t = tbk.pack_points(f32("points"), lay_t)
    return (problem, pm, (opt_j, lay_j, st_j, par_j, pts_j),
            (opt_t, lay_t, st_t, par_t, pts_t))


def _close(got, ref, tol, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("model_id", list(range(11)))
def test_fused_cost_twin_matches_sba_tpu(model_id):
    _, _, (opt_j, lay_j, st_j, par_j, pts_j), (opt_t, lay_t, st_t, par_t,
                                               pts_t) = _setup(model_id)
    c_j = jbk.fused_cost(st_j, par_j, pts_j, lay_j, opt_j, interpret=True)
    c_t = tbk.fused_cost(st_t, par_t, pts_t, lay_t, opt_t)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-4)


def _bucket_setup(model_id):
    """A 12-image f32 scene whose tracks fall into three track-length
    buckets, with a tenth of the observations masked out (dead lanes
    beside the padding), prepared by both packages."""
    problem, _ = j_make_ba_problem(
        num_images=12, num_points=300, observations_per_point=5,
        pose_noise=0.01, point_noise=0.05, pixel_noise=0.5,
        dtype=jnp.float32, model_id=model_id, seed=model_id + 1)
    cam = np.array(problem.cam_params)
    for i, val in _DISTORT.get(model_id, {}).items():
        cam[:, i] = val
    mask = np.array(problem.obs_mask)
    mask[np.random.default_rng(model_id).random(mask.shape) < 0.1] = 0.0
    problem = problem._replace(cam_params=jnp.asarray(cam, jnp.float32),
                               obs_mask=jnp.asarray(mask, jnp.float32))
    kw = dict(model_id=model_id, dtype="float32", loss="cauchy",
              loss_scale=2.0)
    ctx_j = jbf.prepare(problem, JOpt(**kw))
    ctx_t = tbf.prepare(problem_from_numpy(_numpy_fields(problem), "cpu",
                                           torch.float32), TOpt(**kw))
    return ctx_j, ctx_t


@pytest.mark.parametrize("model_id", [0, 4, 10])
def test_fused_cost_buckets_twin_matches_sba_tpu(model_id):
    """K5 over all buckets of a cost evaluation (its twin on the CPU)
    against the sum of sba_tpu's per-bucket fused_cost."""
    ctx_j, ctx_t = _bucket_setup(model_id)
    statics, lays, pts0, _, prob, opt_j, _ = ctx_j
    par = jbk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                          statics[0].image_cam, lays[0])
    want = sum(float(jbk.fused_cost(st, par, p, lay, opt_j, interpret=True))
               for st, lay, p in zip(statics, lays, pts0))
    statics, lays_t, pts0, _, prob, opt_t, _ = ctx_t
    assert len(lays_t) == len(lays) == 3
    assert [lay.K for lay in lays_t] == [lay.K for lay in lays]
    dead = [float((st.obs_sta[2] == 0).float().mean()) for st in statics]
    assert min(dead) > 0.05
    par = tbk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                          statics[0].image_cam, lays_t[0])
    tbk.reset_launches()
    got = tbk.fused_cost_buckets(statics, par, pts0, lays_t, opt_t)
    assert got.shape == () and tbk.LAUNCHES["fused_cost"] == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-4)


def test_lm_loop_cost_goes_through_fused_cost_buckets(monkeypatch):
    """Each LM cost evaluation is one `fused_cost_buckets` call over all
    buckets; the per-bucket `fused_cost` is not called."""
    _, ctx_t = _bucket_setup(0)
    calls = []
    real = tbk.fused_cost_buckets

    def counted(statics, par, pts_list, lays, opt):
        calls.append(len(lays))
        return real(statics, par, pts_list, lays, opt)

    def per_bucket(*args):
        raise AssertionError("the LM loop called the per-bucket fused_cost")

    monkeypatch.setattr(tbk, "fused_cost_buckets", counted)
    monkeypatch.setattr(tbk, "fused_cost", per_bucket)
    statics, lays, pts0, _, prob, opt, free_arrays = ctx_t
    opt = dataclasses.replace(opt, max_iterations=3, function_tolerance=0.0,
                              gradient_tolerance=0.0,
                              parameter_tolerance=0.0)
    _, summary = tbf._fused_lm_loop(statics, lays, pts0, prob, opt,
                                    free_arrays)
    assert summary.num_iterations == 3
    assert calls == [3] * (summary.num_iterations + 1)


def test_k5_bucket_limit_matches_the_kernel_source():
    """K5's bucket limit in the wrapper is the kernel's (csrc
    kK5MaxBuckets) and the LM loop's (MAX_BUCKETS)."""
    src = (Path(tbk.__file__).resolve().parent.parent / "csrc"
           / "ba_kernels.cuh").read_text()
    assert re.search(r"kK5MaxBuckets = (\d+);", src).group(1) == str(
        tbk.K5_MAX_BUCKETS) == str(tbf.MAX_BUCKETS)


def _k1_both(j, t, lam=1e-3):
    opt_j, lay_j, st_j, par_j, pts_j = j
    opt_t, lay_t, st_t, par_t, pts_t = t
    out_j = jbk.fused_schur(st_j, par_j, pts_j, jnp.float32(lam), lay_j,
                            opt_j, interpret=True)
    out_t = tbk.fused_schur(st_t, par_t, pts_t,
                            torch.tensor(lam, dtype=torch.float32), lay_t,
                            opt_t)
    return out_j, out_t


def _fov_rows(t):
    """FOV's jw rows 4 and 9 (A2's off-diagonal terms, times 1/z, the
    free translation mask and the square root of the mask) and 22 and 27
    (the omega derivative's, times the free omega mask and the square
    root of the mask) from sba_tpu's analytic head evaluated in float64
    on the twin's lane coordinates."""
    opt_t, lay_t, st_t, par_t, pts_t = t
    g, _, _, u, v, iz = tbk._camera_uv(par_t, pts_t, st_t, lay_t)

    def f64(a):
        return jnp.asarray(a.double().numpy())

    _, _, A2, dk = jbk._head(7, [f64(g[7 + i]) for i in range(5)], f64(u),
                             f64(v))
    fr = st_t.free_sta[:, st_t.obs_img.long()].double().numpy()
    sw = np.sqrt(st_t.obs_sta[2].double().numpy())
    scale = iz.double().numpy() * sw
    return {4: np.asarray(A2[0][1]) * scale * fr[2],
            9: np.asarray(A2[1][0]) * scale * fr[1],
            22: np.asarray(dk[4][0]) * fr[8] * sw,
            27: np.asarray(dk[4][1]) * fr[8] * sw}


def _check_fused_schur(j, t):
    """K1's twin against sba_tpu's kernel at the module's tolerances.
    For FOV, jw rows 4, 9, 22 and 27 are held against sba_tpu's head in
    float64 (`_fov_rows`) instead: they are A2's off-diagonal terms and
    the omega derivative alone, proportional to the head's g and
    d(s)/d(omega), whose float32 forms in sba_tpu subtract terms that
    agree to ~1e-3 of themselves and miss the float64 values by up to
    1e-4 of the rows' scale; the port evaluates those differences in
    double (csrc Head<7>)."""
    (s_j, img_j, ey_j, pt_j, jw_j), (s_t, img_t, ey_t, pt_t, jw_t) = \
        _k1_both(j, t)
    lay = t[1]
    ref_rows = _fov_rows(t) if t[0].model_id == 7 else {}
    for r0, r1, tol in ((0, 3, 1e-5), (3, 6, 1e-5), (6, 12, 1e-4),
                        (12, 18, 1e-4), (18, 19, 1e-5)):
        _close(pt_t[r0:r1], pt_j[r0:r1], tol, f"pt_pay[{r0}:{r1}]")
    n_jac = 18 + 2 * lay.nparams           # Jc | Jx | Jk, then WLp | WLc
    for r in range(lay.JW):
        _close(jw_t[r], ref_rows.get(r, jw_j[r]), 1e-5 if r < n_jac else 1e-4,
               f"jw[{r}]")
    ofs = np.cumsum([0, 6, 36, 6 * lay.nparams, lay.nparams,
                     lay.nparams ** 2])
    for a, b in zip(ofs[:-1], ofs[1:]):
        _close(img_t[:, a:b], np.asarray(img_j)[:, a:b], 1e-5,
               f"img_red[:, {a}:{b}]")
    _close(s_t, s_j, 3e-5, "S_corr")
    _close(ey_t, np.asarray(ey_j)[0], 3e-5, "ey")


@pytest.mark.parametrize("model_id", list(range(11)))
def test_fused_schur_twin_matches_sba_tpu(model_id):
    _, _, j, t = _setup(model_id)
    _check_fused_schur(j, t)


def _head_rows(px, py, A2, dk):
    return [px, py, *A2[0], *A2[1], *(d for pair in dk for d in pair)]


@pytest.mark.parametrize("model_id", [5, 7, 8, 9, 10])
def test_twins_match_sba_tpu_near_the_principal_point(model_id):
    """The twins' camera head against sba_tpu's `_head` on the lanes at
    and near image 0's principal point (`_NEAR_AXIS`: r = 0 exactly,
    under and over the fisheye guard r < 1e-8, under and over FOV's
    r^2 < 1e-4): the projection and every derivative at 1e-5 of its
    scale over those lanes, all finite (FOV's A2 off-diagonal and omega
    derivative against the float64 head, as in `_check_fused_schur`);
    then K5's twin
    against sba_tpu's kernel on the scene (cost rtol 1e-4)."""
    _, _, j, t = _setup(model_id, center=True)
    opt_t, lay_t, st_t, par_t, pts_t = t
    g, _, _, u, v, _ = tbk._camera_uv(par_t, pts_t, st_t, lay_t)
    r = torch.sqrt(u * u + v * v)
    near = (st_t.obs_img == 0) & (st_t.obs_sta[2] > 0) & (r < 0.02)
    assert int(near.sum()) >= len(_NEAR_AXIS)
    assert float(r[near].min()) == 0.0
    assert bool(((r[near] > 0) & (r[near] < 1e-8)).any())
    assert bool(((r[near] > 1e-8) & (r[near] < 1e-6)).any())
    assert bool((r[near] > 1e-2).any() and (r[near] < 1e-2).any())
    k = g[7:7 + lay_t.nparams][:, near]
    got = _head_rows(*tbk._head(model_id, k, u[near], v[near]))

    def ref_head(dtype):
        def jx(a):
            return jnp.asarray(a.numpy(), dtype)

        return _head_rows(*jbk._head(model_id, [jx(row) for row in k],
                                     jx(u[near]), jx(v[near])))

    ref = ref_head(jnp.float32)
    if model_id == 7:             # g and d(s)/d(omega): see _fov_rows
        ref64 = ref_head(jnp.float64)
        ref[3:5], ref[14:16] = ref64[3:5], ref64[14:16]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert bool(torch.isfinite(a).all()), i
        _close(a, b, 1e-5, f"head row {i}")
    opt_j, lay_j, st_j, par_j, pts_j = j
    c_j = jbk.fused_cost(st_j, par_j, pts_j, lay_j, opt_j, interpret=True)
    c_t = tbk.fused_cost(st_t, par_t, pts_t, lay_t, opt_t)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-4)


CUH = Path(tbk.__file__).resolve().parent.parent / "csrc" / "ba_kernels.cuh"


def test_k1b_block_sizes_follow_nparams():
    """K1b's block sizes in Python equal the C++ table (whose static
    asserts hold the C++ functions to it) for every model's parameter
    count, and hold the blocks they carry."""
    table = {int(m.group(1)): (int(m.group(2)), int(m.group(3)))
             for m in re.finditer(
                 r"static_assert\(k1b_group_words\((\d+)\) == (\d+) && "
                 r"k1b_entries\(\1\) == (\d+)", CUH.read_text())}
    counts = {camera_models.model_by_id(m).num_params for m in range(11)}
    assert set(table) == counts
    for np_, (words, entries) in table.items():
        assert (tbk.k1b_group_words(np_), tbk.k1b_entries(np_)) == \
            (words, entries)
        assert words % 4 == 0 and words >= 3 * max(6, np_)
        assert entries >= max(36, 6 * np_, np_ * np_)


def _check_backsub(K=None):
    _, pm, j, t = _setup(0, K=K)
    (_, _, _, pt_j, jw_j), _ = _k1_both(j, t)
    opt_j, lay_j, st_j = j[:3]
    opt_t, lay_t, st_t = t[:3]
    rng = np.random.default_rng(7 if K is None else K)
    pt = np.array(pt_j, np.float32)
    if K is not None:
        assert (lay_j.K, lay_t.K) == (K, K)
        last = np.asarray(pm.obs_mask).reshape(-1, K)[:, K - 1]
        assert last.max() == 1 and last.min() == 0     # full and dead
        pt[18, rng.random(pt.shape[1]) < 0.2] = 0.0        # fixed points
    dup = np.zeros((6, lay_t.Npad), np.float32)
    dup[:, :lay_t.N] = 1e-3 * rng.normal(size=(6, lay_t.N))
    duc = np.zeros((12, lay_t.C), np.float32)
    duc[:lay_t.nparams] = 1e-2 * rng.normal(size=(lay_t.nparams, lay_t.C))
    lam = 1e-3
    dp_j, acc_j = jbk.backsub(st_j, jnp.asarray(dup), jnp.asarray(duc),
                              jnp.asarray(pt), jw_j, jnp.float32(lam), lay_j,
                              opt_j, interpret=True)
    pt_in = torch.as_tensor(pt[:tbk.PT_ROWS])
    jw_in = torch.as_tensor(np.asarray(jw_j)[:lay_t.JW])
    dp_t, acc_t = tbk.backsub(st_t, torch.as_tensor(dup),
                              torch.as_tensor(duc), pt_in, jw_in,
                              torch.tensor(lam, dtype=torch.float32), lay_t,
                              opt_t)
    assert np.all(dp_t.numpy()[:, pt[18] == 0] == 0)
    _close(dp_t, np.asarray(dp_j)[:3], 1e-4, "dp")
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j)[:3, 0],
                               rtol=1e-4)


def test_backsub_twin_matches_sba_tpu():
    _check_backsub()


@pytest.mark.parametrize("K", [4, 8, 20])
def test_backsub_twin_matches_sba_tpu_at_track_length(K):
    """K = 4, 8 and 20: fewer than, and more than but not a multiple of,
    the CUDA kernel's 16 slots a pass; dead lanes and fixed points."""
    _check_backsub(K)


def test_fused_step_matches_sba_tpu():
    _, pm, (opt_j, *_), (opt_t, *_) = _setup(0)
    lam = 1e-3
    ctx_j = jbf.prepare(pm, opt_j)
    statics, lays, pts0, idxs, prob_f, options, free_arrays = ctx_j
    out_j = jbf._fused_step(statics, lays, options, prob_f.qvecs,
                            prob_f.tvecs, pts0, prob_f.cam_params,
                            jnp.float32(lam), free_arrays, interpret=True)
    ctx_t = tbf.prepare(problem_from_numpy(_numpy_fields(pm), "cpu",
                                           torch.float32), opt_t)
    statics, lays, pts0, idxs_t, prob_t, options, free_arrays = ctx_t
    out_t = tbf._fused_step(statics, lays, options, prob_t.qvecs,
                            prob_t.tvecs, pts0, prob_t.cam_params,
                            torch.tensor(lam, dtype=torch.float32),
                            free_arrays)
    u_j, c_j, dp_j, pred_j, ginf_j = out_j
    u_t, c_t, dp_t, pred_t, ginf_t = out_t
    _close(u_t, u_j, 2e-3, "u_pose")
    _close(c_t, c_j, 2e-3, "u_cam")
    for a, b in zip(dp_t, dp_j):
        _close(a, np.asarray(b)[:3], 2e-3, "dp")
    np.testing.assert_allclose(float(pred_t), float(pred_j), rtol=1e-3)
    np.testing.assert_allclose(float(ginf_t), float(ginf_j), rtol=1e-4)


def test_fused_solve_matches_sba_tpu():
    problem, _, (opt_j, *_), (opt_t, *_) = _setup(0, pixel_noise=0.5)
    opt_j = JOpt(model_id=0, max_iterations=10, dtype="float32")
    opt_t = TOpt(model_id=0, max_iterations=10, dtype="float32")
    out_j, s_j = jbf.bundle_adjust_fused(problem, opt_j, interpret=True)
    out_t, s_t = tbf.bundle_adjust_fused(
        problem_from_numpy(_numpy_fields(problem), "cpu", torch.float32),
        opt_t)
    assert float(s_t.final_cost) < 1e-2 * float(s_t.initial_cost)
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(out_t.qvecs.numpy(), np.asarray(out_j.qvecs),
                               atol=5e-3)
    np.testing.assert_allclose(out_t.tvecs.numpy(), np.asarray(out_j.tvecs),
                               atol=5e-3)


def test_cuda_only_paths_raise_on_the_card_rules():
    """The implicit (N > 128) step, which raised before K2/K3 were
    ported, now runs on the CPU twins with finite outputs; the CUDA
    kernels carry every camera model, and an unknown model id raises."""
    _, pm, _, (opt_t, lay_t, st_t, par_t, pts_t) = _setup(0)
    ctx = tbf.prepare(problem_from_numpy(_numpy_fields(pm), "cpu",
                                         torch.float32),
                      TOpt(fused_mode="implicit"))
    statics, lays, pts0, _, prob, options, free_arrays = ctx
    assert tbf.use_implicit(lays[0], options)
    u_pose, u_cam, dp_list, predicted, g_inf = tbf._fused_step(
        statics, lays, options, prob.qvecs, prob.tvecs, pts0,
        prob.cam_params, torch.tensor(1e-3), free_arrays)
    for v in (u_pose, u_cam, predicted, g_inf, *dp_list):
        assert bool(torch.isfinite(v).all())
    assert float(predicted) > 0
    for model_id in range(11):
        tbk._check_model(TOpt(model_id=model_id))
    with pytest.raises(ValueError, match="camera model 11"):
        tbk._check_model(TOpt(model_id=11))
