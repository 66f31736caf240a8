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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_tpu.ops import ba_kernels as jbk
from sba_tpu.optim import ba_fused as jbf
from sba_tpu.optim.ba import BAOptions as JOpt
from sba_tpu.optim.ba import to_point_major as j_to_point_major
from sba_tpu.utils.synthetic import make_ba_problem as j_make_ba_problem
from sba_tpu_torch.ops import ba_kernels as tbk
from sba_tpu_torch.optim import ba_fused as tbf
from sba_tpu_torch.optim.ba import BAOptions as TOpt
from sba_tpu_torch.optim.ba import problem_from_numpy

torch.set_num_threads(1)

_DISTORT = {2: {3: 0.02}}


def _numpy_fields(problem):
    return {k: np.asarray(v) for k, v in problem._asdict().items()
            if v is not None}


def _setup(model_id=0, pixel_noise=0.0):
    """One f32 scene in both packages' kernel layouts (sba_tpu's
    tests/test_ba_fused.py::_setup)."""
    problem, _ = j_make_ba_problem(
        num_images=6, num_points=150, observations_per_point=4,
        pose_noise=0.01, point_noise=0.05, pixel_noise=pixel_noise, seed=0,
        dtype=jnp.float32, model_id=model_id)
    cam = np.array(problem.cam_params)
    for i, val in _DISTORT.get(model_id, {}).items():
        cam[:, i] = val
    problem = problem._replace(cam_params=jnp.asarray(cam, jnp.float32))
    kw = dict(model_id=model_id, dtype="float32", schur_bf16=False,
              cg_iterations=200, cg_tolerance=1e-9)
    opt_j = JOpt(solver="explicit_schur", obs_layout="point_major", **kw)
    opt_t = TOpt(solver="explicit_schur", **kw)
    pm = j_to_point_major(problem)
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


@pytest.mark.parametrize("model_id", [0, 1, 2])
def test_fused_cost_twin_matches_sba_tpu(model_id):
    _, _, (opt_j, lay_j, st_j, par_j, pts_j), (opt_t, lay_t, st_t, par_t,
                                               pts_t) = _setup(model_id)
    c_j = jbk.fused_cost(st_j, par_j, pts_j, lay_j, opt_j, interpret=True)
    c_t = tbk.fused_cost(st_t, par_t, pts_t, lay_t, opt_t)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-4)


def _k1_both(j, t, lam=1e-3):
    opt_j, lay_j, st_j, par_j, pts_j = j
    opt_t, lay_t, st_t, par_t, pts_t = t
    out_j = jbk.fused_schur(st_j, par_j, pts_j, jnp.float32(lam), lay_j,
                            opt_j, interpret=True)
    out_t = tbk.fused_schur(st_t, par_t, pts_t,
                            torch.tensor(lam, dtype=torch.float32), lay_t,
                            opt_t)
    return out_j, out_t


def test_fused_schur_twin_matches_sba_tpu():
    _, _, j, t = _setup(0)
    (s_j, img_j, ey_j, pt_j, jw_j), (s_t, img_t, ey_t, pt_t, jw_t) = \
        _k1_both(j, t)
    lay = t[1]
    for r0, r1, tol in ((0, 3, 1e-5), (3, 6, 1e-5), (6, 12, 1e-4),
                        (12, 18, 1e-4), (18, 19, 1e-5)):
        _close(pt_t[r0:r1], pt_j[r0:r1], tol, f"pt_pay[{r0}:{r1}]")
    n_jac = 18 + 2 * lay.nparams           # Jc | Jx | Jk, then WLp | WLc
    for r in range(lay.JW):
        _close(jw_t[r], jw_j[r], 1e-5 if r < n_jac else 1e-4, f"jw[{r}]")
    ofs = np.cumsum([0, 6, 36, 6 * lay.nparams, lay.nparams,
                     lay.nparams ** 2])
    for a, b in zip(ofs[:-1], ofs[1:]):
        _close(img_t[:, a:b], np.asarray(img_j)[:, a:b], 1e-5,
               f"img_red[:, {a}:{b}]")
    _close(s_t, s_j, 3e-5, "S_corr")
    _close(ey_t, np.asarray(ey_j)[0], 3e-5, "ey")


def test_backsub_twin_matches_sba_tpu():
    _, _, j, t = _setup(0)
    (_, _, _, pt_j, jw_j), _ = _k1_both(j, t)
    opt_j, lay_j, st_j = j[:3]
    opt_t, lay_t, st_t = t[:3]
    rng = np.random.default_rng(7)
    dup = np.zeros((6, lay_t.Npad), np.float32)
    dup[:, :lay_t.N] = 1e-3 * rng.normal(size=(6, lay_t.N))
    duc = np.zeros((12, lay_t.C), np.float32)
    duc[:lay_t.nparams] = 1e-2 * rng.normal(size=(lay_t.nparams, lay_t.C))
    lam = 1e-3
    dp_j, acc_j = jbk.backsub(st_j, jnp.asarray(dup), jnp.asarray(duc),
                              pt_j, jw_j, jnp.float32(lam), lay_j, opt_j,
                              interpret=True)
    pt_in = torch.as_tensor(np.asarray(pt_j)[:tbk.PT_ROWS])
    jw_in = torch.as_tensor(np.asarray(jw_j)[:lay_t.JW])
    dp_t, acc_t = tbk.backsub(st_t, torch.as_tensor(dup),
                              torch.as_tensor(duc), pt_in, jw_in,
                              torch.tensor(lam, dtype=torch.float32), lay_t,
                              opt_t)
    _close(dp_t, np.asarray(dp_j)[:3], 1e-4, "dp")
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j)[:3, 0],
                               rtol=1e-4)


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
    """Unported pieces raise instead of running a plain path: the
    implicit (N > 128) step, and the CUDA kernels' unported heads."""
    _, pm, _, (opt_t, lay_t, st_t, par_t, pts_t) = _setup(0)
    ctx = tbf.prepare(problem_from_numpy(_numpy_fields(pm), "cpu",
                                         torch.float32),
                      TOpt(fused_mode="implicit"))
    statics, lays, pts0, _, prob, options, free_arrays = ctx
    with pytest.raises(NotImplementedError, match="K2/K3"):
        tbf._fused_step(statics, lays, options, prob.qvecs, prob.tvecs,
                        pts0, prob.cam_params, torch.tensor(1e-3),
                        free_arrays)
    with pytest.raises(NotImplementedError, match="camera model 5"):
        tbk._check_model(TOpt(model_id=5))
