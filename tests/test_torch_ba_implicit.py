"""The port's implicit large-N BA path (K2 `fused_reduce`, K3
`schur_matvec`, the two-block PCG, `cg_warm_start`) and its sequential scene
against sba_tpu, whose Pallas kernels run in interpret mode on the CPU.

Tolerances: image and point payload rows 1e-5 of their scale, 1e-4 for
rows computed through the damped 3x3 point inverse (Hpp^-1, Lp, the
whitened couplings and everything built from them: Ey, the Jacobi blocks
of EL EL^T, f32 jcorr), the reason given in tests/test_torch_ba_kernels.py;
bf16 jcorr 2^-8 of its scale, since two f32 values one ulp apart may round
to neighbouring bf16 values; the matvec 3e-5 of its scale (S_corr's
tolerance). The one-step checks hold the step at 1e-3 (u) and 2e-3 (dp)
of its scale, the tolerances of sba_tpu's own implicit-vs-dense and the
port's dense step tests: on these scenes at lambda 1e-3 both packages'
f32 steps lie up to ~2e-4 (u) and ~1e-3 (dp) of scale from the exact
float64 step, in either direction, so they cannot agree to 1e-4. The
port's step is also held at those tolerances against the float64 step.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_tpu.ops import ba_kernels as jbk
from sba_tpu.optim import ba_fused as jbf
from sba_tpu.optim.ba import BAOptions as JOpt
from sba_tpu.optim.ba import _solve_step_explicit_pm
from sba_tpu.optim.ba import to_point_major as j_to_point_major
from sba_tpu.utils.synthetic import make_ba_problem as j_make_ba_problem
from sba_tpu.utils.synthetic import \
    make_sequential_ba_problem as j_make_sequential
from sba_tpu_torch.ops import ba_kernels as tbk
from sba_tpu_torch.optim import ba_fused as tbf
from sba_tpu_torch.optim.ba import BAOptions as TOpt
from sba_tpu_torch.optim.ba import problem_from_numpy
from sba_tpu_torch.utils.synthetic import make_ba_problem as t_make_ba_problem
from sba_tpu_torch.utils.synthetic import \
    make_sequential_ba_problem_numpy as t_make_sequential_numpy

torch.set_num_threads(1)

# Small distortion so that the heads run off the pinhole special case
# (tests/test_ba_fused.py::_DISTORT).
_DISTORT = {3: {3: 0.02, 4: -0.005},
            4: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3}}
_LAM = 1e-3


def _numpy_fields(problem):
    return {k: np.asarray(v) for k, v in problem._asdict().items()
            if v is not None}


def _scene(model_id=0, two_cameras=False):
    """sba_tpu's 6-image fixture (tests/test_ba_fused.py::_setup), or its
    two-camera scene (::_two_camera_problem): odd images use a second
    camera that starts off-truth."""
    if two_cameras:
        problem, _ = j_make_ba_problem(
            num_images=6, num_points=120, observations_per_point=4,
            pose_noise=0.01, point_noise=0.05, pixel_noise=0.0, seed=9,
            dtype=jnp.float32)
        cam2 = np.tile(np.asarray(problem.cam_params), (2, 1))
        cam2[1, 0] = 520.0
        image_cam = np.arange(6, dtype=np.int32) % 2
        return problem._replace(
            cam_params=jnp.asarray(cam2, jnp.float32),
            obs_cam=jnp.asarray(image_cam[np.asarray(problem.obs_image)]),
            image_cam=jnp.asarray(image_cam),
            free_cam=jnp.ones((2, 12), jnp.float32))
    problem, _ = j_make_ba_problem(
        num_images=6, num_points=150, observations_per_point=4,
        pose_noise=0.01, point_noise=0.05, pixel_noise=0.0, seed=0,
        dtype=jnp.float32, model_id=model_id)
    cam = np.array(problem.cam_params)
    for i, val in _DISTORT.get(model_id, {}).items():
        cam[:, i] = val
    return problem._replace(cam_params=jnp.asarray(cam, jnp.float32))


def _options(model_id, **kw):
    kw = dict(model_id=model_id, dtype="float32", schur_bf16=False,
              cg_iterations=200, cg_tolerance=1e-9, **kw)
    return (JOpt(solver="explicit_schur", obs_layout="point_major", **kw),
            TOpt(solver="explicit_schur", **kw))


def _kernel_inputs(problem, opt_j, opt_t):
    """One bucket of the point-major problem in both packages' layouts."""
    pm = j_to_point_major(problem)
    lay_j = jbk.plan_layout(pm, opt_j)
    st_j = jbk.build_static(pm, opt_j, lay_j)
    par_j = jbk.pack_params(pm.qvecs, pm.tvecs, pm.cam_params,
                            st_j.image_cam, lay_j)
    pts_j = jbk.pack_points(pm.points, lay_j)
    fields = _numpy_fields(pm)
    lay_t = tbk.plan_layout(fields, opt_t)
    st_t = tbk.build_static(fields, opt_t, lay_t, "cpu")
    f32 = lambda name: torch.tensor(fields[name], dtype=torch.float32)
    par_t = tbk.pack_params(f32("qvecs"), f32("tvecs"), f32("cam_params"),
                            st_t.image_cam, lay_t)
    pts_t = tbk.pack_points(f32("points"), lay_t)
    return (lay_j, st_j, par_j, pts_j), (lay_t, st_t, par_t, pts_t)


# sba_tpu's one-step function, jitted whole (half the time of running it
# op by op in interpret mode).
_j_fused_step = jax.jit(functools.partial(jbf._fused_step, interpret=True),
                        static_argnums=(1, 2))


def _close(got, ref, tol, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("ranged", ["off", "on"])
@pytest.mark.parametrize("model_id", [0, 3])
def test_fused_reduce_twin_matches_sba_tpu(model_id, ranged):
    """K2's twin; model 0 carries the 6x6 block rows (BJ), model 3 the
    diagonal (scalar Jacobi); ranged "on" stores bf16 couplings."""
    opt_j, opt_t = _options(model_id, fused_ranged=ranged)
    (lay_j, st_j, par_j, pts_j), (lay, st_t, par_t, pts_t) = \
        _kernel_inputs(_scene(model_id), opt_j, opt_t)
    assert lay.BJ == lay_j.BJ == (model_id == 0)
    img_j, pt_j, jw_j, jc_j = jbk.fused_reduce(
        st_j, par_j, pts_j, jnp.float32(_LAM), lay_j, opt_j, interpret=True)
    img_t, pt_t, jw_t, jc_t = tbk.fused_reduce(
        st_t, par_t, pts_t, torch.tensor(_LAM, dtype=torch.float32), lay,
        opt_t)
    for r0, r1, tol in ((0, 3, 1e-5), (3, 6, 1e-5), (6, 12, 1e-4),
                        (12, 18, 1e-4), (18, 19, 1e-5)):
        _close(pt_t[r0:r1], pt_j[r0:r1], tol, f"pt_pay[{r0}:{r1}]")
    n_jac = 18 + 2 * lay.nparams
    for r in range(lay.JW):
        _close(jw_t[r], jw_j[r], 1e-5 if r < n_jac else 1e-4, f"jw[{r}]")
    np_ = lay.nparams
    img_j = np.asarray(img_j)
    ofs = np.cumsum([0, 6, 36, 6 * np_, np_, np_ * np_, 6, np_,
                     21 if lay.BJ else 6, np_])
    for k, (a, b) in enumerate(zip(ofs[:-1], ofs[1:])):
        _close(img_t[:, a:b], img_j[:, a:b], 1e-5 if k < 5 else 1e-4,
               f"img_red[:, {a}:{b}]")
    assert ofs[-1] == lay.DI_implicit
    assert not np.any(img_j[:, lay.DI_implicit:])
    bf16 = ranged == "on"
    assert jc_t.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert (jc_j.dtype == jnp.bfloat16) == bf16
    jc_j = _f32(jc_j)
    # The port keeps the JC coupling rows; the reference pads them with
    # zero rows to JCW.
    assert tuple(jc_t.shape) == (lay.JC, jc_j.shape[1])
    assert not np.any(jc_j[lay.JC:lay.JCW])
    for r in range(lay.JC):
        _close(jc_t[r].float(), jc_j[r], 2.0 ** -8 if bf16 else 1e-4,
               f"jcorr[{r}]")


@pytest.mark.parametrize("ranged", ["off", "on"])
@pytest.mark.parametrize("model_id", [0, 3])
def test_schur_matvec_twin_matches_sba_tpu(model_id, ranged):
    """K3's twin on sba_tpu's own coupling store (f32 or bf16)."""
    opt_j, opt_t = _options(model_id, fused_ranged=ranged)
    (lay_j, st_j, par_j, pts_j), (lay, st_t, _, _) = \
        _kernel_inputs(_scene(model_id), opt_j, opt_t)
    _, _, _, jc_j = jbk.fused_reduce(st_j, par_j, pts_j, jnp.float32(_LAM),
                                     lay_j, opt_j, interpret=True)
    rng = np.random.default_rng(11)
    dup = np.zeros((6, lay.Npad), np.float32)
    dup[:, :lay.N] = 1e-3 * rng.normal(size=(6, lay.N))
    duc = np.zeros((12, lay.C), np.float32)
    duc[:lay.nparams] = 1e-2 * rng.normal(size=(lay.nparams, lay.C))
    out_j = np.asarray(jbk.schur_matvec(st_j, jnp.asarray(dup),
                                        jnp.asarray(duc), jc_j, lay_j,
                                        opt_j, interpret=True))
    jc_t = torch.tensor(_f32(jc_j)[:lay.JC]).to(tbk.jcorr_dtype(lay, opt_t))
    out_t = tbk.schur_matvec(st_t, torch.as_tensor(dup),
                             torch.as_tensor(duc), jc_t, lay, opt_t)
    dv = 6 + lay.nparams
    assert tuple(out_t.shape) == (lay.Npad, dv)
    _close(out_t, out_j[:, :dv], 3e-5, "matvec")
    assert not np.any(out_j[:, dv:])


def _exact_step(problem, model_id):
    """sba_tpu's explicit Schur step in float64 (Cholesky), the exact
    answer both f32 implicit steps approximate."""
    pm = jax.tree.map(
        lambda a: a.astype(jnp.float64)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
        else a, j_to_point_major(problem))
    opt = JOpt(model_id=model_id, solver="explicit_schur",
               obs_layout="point_major", dtype="float64", schur_bf16=False)
    return _solve_step_explicit_pm(pm, opt, jnp.float64(_LAM))


@pytest.mark.parametrize("model_id,two_cameras",
                         [(0, False), (3, False), (4, False), (0, True)])
def test_implicit_step_matches_sba_tpu(model_id, two_cameras):
    problem = _scene(model_id, two_cameras)
    opt_j, opt_t = _options(model_id, matvec_bf16=False,
                            fused_mode="implicit")
    pm = j_to_point_major(problem)
    ctx = jbf.prepare(pm, opt_j)
    statics, lays, pts0, idx_j, prob, options, free_arrays = ctx
    out_j = _j_fused_step(statics, lays, options, prob.qvecs, prob.tvecs,
                          pts0, prob.cam_params, jnp.float32(_LAM),
                          free_arrays)
    ctx = tbf.prepare(problem_from_numpy(_numpy_fields(pm), "cpu",
                                         torch.float32), opt_t)
    statics, lays, pts0, idx_t, prob, options, free_arrays = ctx
    assert tbf.use_implicit(lays[0], options)
    out_t = tbf._fused_step(statics, lays, options, prob.qvecs, prob.tvecs,
                            pts0, prob.cam_params,
                            torch.tensor(_LAM, dtype=torch.float32),
                            free_arrays)
    u_j, c_j, dp_j, pred_j, ginf_j = out_j
    u_t, c_t, dp_t, pred_t, ginf_t = out_t
    P = pm.points.shape[0]
    dp_j = np.asarray(jbf.unpack_bucket_points(tuple(dp_j), idx_j, P))
    dp_t = tbf.unpack_bucket_points(dp_t, idx_t, P)
    u_x, c_x, dp_x, _, _ = _exact_step(problem, model_id)
    for ref, name in ((u_j, "sba_tpu"), (u_x, "float64")):
        _close(u_t, ref, 1e-3, f"u_pose vs {name}")
    for ref, name in ((dp_j, "sba_tpu"), (dp_x, "float64")):
        _close(dp_t, ref, 2e-3, f"dp vs {name}")
    if two_cameras:
        for ref, name in ((c_j, "sba_tpu"), (c_x, "float64")):
            _close(c_t[:, :3], np.asarray(ref)[:, :3], 1e-3,
                   f"u_cam vs {name}")
    np.testing.assert_allclose(float(pred_t), float(pred_j), rtol=1e-4)
    np.testing.assert_allclose(float(ginf_t), float(ginf_j), rtol=1e-4)


_SEQ40 = dict(num_images=40, num_points=500, track_len=5, pose_noise=0.005,
              point_noise=0.03, pixel_noise=0.5, seed=3)


def _fresh_reference_loop(monkeypatch):
    """A fresh jit of sba_tpu's LM loop (a new function, so that no
    cached trace is reused): a patch of a function it calls is traced in."""
    def loop(statics, lays, pts0, problem, options, free_arrays,
             axis_name=None, interpret=False):
        return jbf._fused_lm_loop_impl(statics, lays, pts0, problem,
                                       options, free_arrays, axis_name,
                                       interpret)

    monkeypatch.setattr(jbf, "_fused_lm_loop", jax.jit(
        loop, static_argnames=("lays", "options", "axis_name", "interpret")))


def _nudge_jcorr(fused_reduce):
    """`fused_reduce` whose bf16 couplings have 8 entries moved by one
    bf16 ulp: what a one-ulp difference in an f32 coupling does when it
    crosses a rounding boundary."""
    rows = np.array([0, 5, 11, 17, 20, 24, 3, 9])
    cols = np.array([3, 101, 377, 640, 901, 1203, 1555, 1999])

    def nudged(*args, **kw):
        img, pt, jw, jc = fused_reduce(*args, **kw)
        u = jax.lax.bitcast_convert_type(jc, jnp.uint16)
        u = u.at[rows, cols].add(jnp.uint16(1))
        return img, pt, jw, jax.lax.bitcast_convert_type(u, jnp.bfloat16)
    return nudged


@pytest.mark.parametrize("bf16", [False, True])
def test_ranged_implicit_solve_matches_sba_tpu(bf16, monkeypatch):
    """A whole ranged implicit solve on a 40-image sequential scene:
    final cost rtol 1e-3 and rotations atol 5e-3 against sba_tpu.
    Translations: atol 5e-3 with f32 couplings. With bf16 couplings an
    entry that two correct f32 evaluations put on either side of a bf16
    rounding boundary differs by one bf16 ulp, and the inexact trust-
    region solve then moves along the corridor's soft mode on its own
    path. The witness: sba_tpu against itself with 8 couplings nudged by
    one ulp ends as far apart in tvecs (more than 5e-3) at the same cost.
    So there the port's translations must be as close to the true poses
    as sba_tpu's (within 1.5x, plus 5e-3); the bf16 step itself is held
    against sba_tpu's by test_bf16_implicit_step_matches_sba_tpu."""
    problem_j, truth = j_make_sequential(**_SEQ40)
    fields, _ = t_make_sequential_numpy(**_SEQ40)
    problem_t = problem_from_numpy(fields, "cpu", torch.float32)
    opts = dict(model_id=0, max_iterations=8, dtype="float32",
                fused_mode="implicit", fused_ranged="on", matvec_bf16=bf16)
    ctx_j = jbf.prepare(problem_j, JOpt(**opts))
    out_j, s_j = jbf.solve_prepared(ctx_j, interpret=True)
    ctx_t = tbf.prepare(problem_t, TOpt(**opts))
    assert ctx_t[1][0].ranged and ctx_j[1][0].ranged
    assert tbk.jcorr_dtype(ctx_t[1][0], ctx_t[5]) == \
        (torch.bfloat16 if bf16 else torch.float32)
    out_t, s_t = tbf.solve_prepared(ctx_t)
    assert float(s_t.final_cost) < 1e-2 * float(s_t.initial_cost)
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(out_t.qvecs.numpy(), np.asarray(out_j.qvecs),
                               atol=5e-3)
    if not bf16:
        np.testing.assert_allclose(out_t.tvecs.numpy(),
                                   np.asarray(out_j.tvecs), atol=5e-3)
        return
    _fresh_reference_loop(monkeypatch)
    monkeypatch.setattr(jbk, "fused_reduce", _nudge_jcorr(jbk.fused_reduce))
    out_n, s_n = jbf.solve_prepared(ctx_j, interpret=True)
    t_j = np.asarray(out_j.tvecs)
    spread = {"sba_tpu, 8 couplings nudged": np.asarray(out_n.tvecs),
              "the port": out_t.tvecs.numpy()}
    spread = {k: float(np.abs(v - t_j).max()) for k, v in spread.items()}
    print(f"tvecs max |d| from sba_tpu: {spread}; final cost sba_tpu "
          f"{float(s_j.final_cost)}, nudged {float(s_n.final_cost)}, port "
          f"{float(s_t.final_cost)}")
    assert spread["sba_tpu, 8 couplings nudged"] > 5e-3, spread
    np.testing.assert_allclose(float(s_n.final_cost), float(s_j.final_cost),
                               rtol=1e-3)
    err_t = np.abs(out_t.tvecs.numpy() - truth["tvecs"]).max()
    err_j = np.abs(t_j - truth["tvecs"]).max()
    assert err_t <= 1.5 * err_j + 5e-3, (err_t, err_j)


def test_bf16_implicit_step_matches_sba_tpu():
    """One implicit step with bf16 couplings on the 40-image scene, the
    PCG run to 1e-9: u at 5e-3 of its scale against sba_tpu. The port's
    own step with f32 couplings must lie more than 4x that tolerance
    away, so a matvec that read the couplings wrongly could not pass."""
    problem_j, _ = j_make_sequential(**_SEQ40)
    fields, _ = t_make_sequential_numpy(**_SEQ40)
    opts = dict(model_id=0, dtype="float32", fused_mode="implicit",
                fused_ranged="on", matvec_bf16=True, cg_iterations=200,
                cg_tolerance=1e-9)
    statics, lays, pts0, _, prob, opt, free = jbf.prepare(problem_j,
                                                          JOpt(**opts))
    u_j, _, _, pred_j, _ = _j_fused_step(
        statics, lays, opt, prob.qvecs, prob.tvecs, pts0, prob.cam_params,
        jnp.float32(_LAM), free)
    statics, lays, pts0, _, prob, opt, free = tbf.prepare(
        problem_from_numpy(fields, "cpu", torch.float32), TOpt(**opts))
    assert tbk.jcorr_dtype(lays[0], opt) == torch.bfloat16
    lam = torch.tensor(_LAM, dtype=torch.float32)
    u_t, _, _, pred_t, _ = tbf._fused_step(
        statics, lays, opt, prob.qvecs, prob.tvecs, pts0, prob.cam_params,
        lam, free)
    opt32 = TOpt(**dict(opts, matvec_bf16=False))
    u_32 = tbf._fused_step(statics, lays, opt32, prob.qvecs, prob.tvecs,
                           pts0, prob.cam_params, lam, free)[0]
    scale = float(np.abs(np.asarray(u_j)).max())
    d_ref = float(np.abs(u_t.numpy() - np.asarray(u_j)).max()) / scale
    d_32 = float((u_t - u_32).abs().max()) / scale
    print(f"bf16 step: |u - sba_tpu's| {d_ref:.2e}, |u - f32 couplings' "
          f"u| {d_32:.2e} of scale")
    assert d_32 > 4 * 5e-3, d_32
    _close(u_t, u_j, 5e-3, "u_pose")
    np.testing.assert_allclose(float(pred_t), float(pred_j), rtol=1e-4)


def test_pcg_iterations_match_sba_tpu(monkeypatch):
    """CG iterations (matvecs) per LM iteration at the default stopping
    rule (cg_tolerance 1e-2, at most 100): the port checks convergence
    every 8th iteration, so it runs the reference's count or up to 7
    more, and never past the cap."""
    kw = dict(num_images=40, num_points=2000, track_len=7, pose_noise=0.005,
              point_noise=0.02, pixel_noise=0.5, seed=0)
    opts = dict(model_id=0, max_iterations=3, dtype="float32",
                fused_mode="implicit", function_tolerance=0.0,
                gradient_tolerance=0.0, parameter_tolerance=0.0)
    ref, port = [], []
    pcg_j, pcg_t = jbf._pcg_2block, tbf._pcg

    def counted_j(matvec, *args, **kw):
        def mv(p, c):
            jax.debug.callback(lambda: ref.append(1), ordered=True)
            return matvec(p, c)
        jax.debug.callback(lambda: ref.append(0), ordered=True)
        return pcg_j(mv, *args, **kw)

    def counted_t(matvec, *args, **kw):
        port.append(0)

        def mv(v):
            port[-1] += 1
            return matvec(v)
        return pcg_t(mv, *args, **kw)

    _fresh_reference_loop(monkeypatch)
    monkeypatch.setattr(jbf, "_pcg_2block", counted_j)
    monkeypatch.setattr(tbf, "_pcg", counted_t)
    problem_j, _ = j_make_sequential(**kw)
    _, s_j = jbf.bundle_adjust_fused(problem_j, JOpt(**opts),
                                     interpret=True)
    jax.effects_barrier()
    fields, _ = t_make_sequential_numpy(**kw)
    _, s_t = tbf.bundle_adjust_fused(
        problem_from_numpy(fields, "cpu", torch.float32), TOpt(**opts))
    ref = [len(run) for run in "".join(map(str, ref)).split("0")[1:]]
    print(f"CG iterations per LM iteration: sba_tpu {ref}, port {port}")
    assert len(ref) == len(port) == int(s_j.num_iterations) == 3
    for r, p in zip(ref, port):
        assert r <= p <= min(r + 7, 100), (ref, port)
    assert min(ref) < 100, ref   # the stopping rule, not only the cap


@pytest.mark.parametrize("mode", ["dense", "implicit"])
def test_cg_warm_start_converges(mode):
    """Warm-started PCG (optimally rescaled previous step) reaches the
    cold start's basin on both reduced-solve branches
    (tests/test_ba_fused.py::test_cg_warm_start_converges)."""
    problem, _ = t_make_ba_problem(
        num_images=24, num_points=300, observations_per_point=4,
        pose_noise=0.01, point_noise=0.05, pixel_noise=0.0, seed=5,
        dtype=torch.float32, device="cpu")
    finals = {}
    for ws in (False, True):
        opt = TOpt(model_id=0, max_iterations=20, dtype="float32",
                   fused_mode=mode, cg_warm_start=ws)
        _, summary = tbf.bundle_adjust_fused(problem, opt)
        finals[ws] = float(summary.final_cost)
        assert finals[ws] < 1e-3 * float(summary.initial_cost)
    assert finals[True] < 2.0 * finals[False] + 1e-6


def test_sequential_scene_equals_sba_tpu():
    kw = dict(num_images=30, num_points=400, track_len=6, pose_noise=0.005,
              point_noise=0.03, pixel_noise=0.5, seed=4)
    problem_j, truth_j = j_make_sequential(dtype=np.float64, **kw)
    fields, truth_t = t_make_sequential_numpy(**kw)
    for name, ref in _numpy_fields(problem_j).items():
        if name in fields:
            np.testing.assert_allclose(fields[name], ref, rtol=0, atol=1e-12,
                                       err_msg=name)
    for name in truth_j:
        np.testing.assert_allclose(truth_t[name], truth_j[name], rtol=0,
                                   atol=1e-12, err_msg=name)
    assert np.array_equal(fields["image_cam"],
                          np.asarray(problem_j.image_cam))


@pytest.mark.parametrize("model_id", list(range(11)))
def test_plan_layout_flags_match_sba_tpu(model_id):
    for num_images in (200, 2048):
        for mode in ("auto", "on", "off"):
            arrays = dict(points=np.zeros((256, 3)),
                          obs_image=np.zeros(256 * 4, np.int32),
                          qvecs=np.zeros((num_images, 4)),
                          cam_params=np.zeros((1, 12)))
            lay_j = jbk.plan_layout(SimpleNamespace(**arrays),
                                    JOpt(model_id=model_id,
                                         fused_ranged=mode))
            lay_t = tbk.plan_layout(arrays, TOpt(model_id=model_id,
                                                 fused_ranged=mode))
            assert (lay_t.ranged, lay_t.BJ, lay_t.JCW) == \
                (lay_j.ranged, lay_j.BJ, lay_j.JCW), (num_images, mode)
    assert lay_t.BJ == (model_id not in (3, 7, 9))
