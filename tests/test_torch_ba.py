"""The port's plain BA path (optim/ba.py, sfm/controllers.py, cli.py)
against sba_tpu in float64 on the CPU."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_tpu.models.reconstruction import Reconstruction as JRec
from sba_tpu.optim import ba as jba
from sba_tpu.sfm.controllers import adjust_bundle as j_adjust_bundle
from sba_tpu.utils.synthetic import make_ba_problem as j_make_ba_problem
from sba_tpu.utils.synthetic import make_synthetic_reconstruction as jmake
from sba_tpu_torch import cli
from sba_tpu_torch.models.reconstruction import Reconstruction as TRec
from sba_tpu_torch.optim import ba as tba
from sba_tpu_torch.sfm.controllers import adjust_bundle as t_adjust_bundle
from sba_tpu_torch.utils.synthetic import make_ba_problem_numpy

torch.set_num_threads(1)


def _problems(model_id=0, **kw):
    """The same sba_tpu-made scene as a JAX and as a port problem."""
    args = dict(num_images=5, num_points=60, observations_per_point=4,
                pose_noise=0.01, point_noise=0.05, pixel_noise=0.5, seed=1,
                model_id=model_id)
    args.update(kw)
    j_prob, _ = j_make_ba_problem(dtype=jnp.float64, **args)
    cam = np.array(j_prob.cam_params)
    if model_id == 2:
        cam[:, 3] = 0.02
    j_prob = j_prob._replace(cam_params=cam)
    t_prob = tba.problem_from_numpy(
        {k: np.asarray(v) for k, v in j_prob._asdict().items()
         if v is not None}, device="cpu")
    return j_prob, t_prob


def test_make_ba_problem_matches_sba_tpu():
    j_prob, _ = j_make_ba_problem(num_images=5, num_points=60,
                                  observations_per_point=4, pose_noise=0.01,
                                  point_noise=0.05, pixel_noise=0.5, seed=1)
    fields, _ = make_ba_problem_numpy(num_images=5, num_points=60,
                                      observations_per_point=4,
                                      pose_noise=0.01, point_noise=0.05,
                                      pixel_noise=0.5, seed=1)
    for name in tba._FIELDS:
        np.testing.assert_allclose(fields[name],
                                   np.asarray(getattr(j_prob, name)),
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("model_id", [0, 2, 4])
def test_evaluate_cost_matches_sba_tpu(model_id):
    j_prob, t_prob = _problems(model_id)
    opt_j = jba.BAOptions(model_id=model_id, loss="cauchy", loss_scale=2.0)
    opt_t = tba.BAOptions(model_id=model_id, loss="cauchy", loss_scale=2.0)
    np.testing.assert_allclose(float(tba.evaluate_cost(t_prob, opt_t)),
                               float(jba.evaluate_cost(j_prob, opt_j)),
                               rtol=1e-12)


@pytest.mark.parametrize("model_id", [0, 2])
def test_linearize_matches_sba_tpu(model_id):
    j_prob, t_prob = _problems(model_id)
    opt_j = jba.BAOptions(model_id=model_id, loss="huber")
    opt_t = tba.BAOptions(model_id=model_id, loss="huber")
    out_j = jax.jit(jba._linearize, static_argnums=1)(j_prob, opt_j)
    out_t = tba._linearize(t_prob, opt_t)
    for name, a, b in zip(("r", "Jq", "Jt", "Jx", "Jk"), out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


def test_explicit_step_matches_sba_tpu():
    j_prob, t_prob = _problems(0)
    opt_j = jba.BAOptions(solver="explicit_schur", obs_layout="point_major")
    opt_t = tba.BAOptions(solver="explicit_schur")
    step = jax.jit(jba._solve_step_explicit_pm, static_argnums=1)
    out_j = step(jba.to_point_major(j_prob), opt_j, jnp.float64(1e-3))
    out_t = tba._solve_step_explicit_pm(
        tba.to_point_major(t_prob), opt_t,
        torch.tensor(1e-3, dtype=torch.float64))
    for name, a, b in zip(("u_pose", "u_cam", "d_pts", "predicted", "g_inf"),
                          out_t, out_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8,
                                   atol=1e-10 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("gather", [False, True])
def test_coo_explicit_step_matches_sba_tpu(gather):
    """The COO explicit step (`_solve_step_explicit`: EL by one scatter)
    on a two-camera OPENCV scene with free intrinsics and a robust loss,
    against sba_tpu's step without and with its gather layouts
    (`attach_gather_layouts`: one-hot contractions in place of the
    scatters). The port keeps no gather layouts: its segment sums hold
    against both of sba_tpu's routes."""
    j_prob, t_prob = _problems(4, observations_per_point=None)
    cam = np.array(j_prob.cam_params)
    cam[:, 4:8] = (0.02, -0.005, 1e-3, -2e-3)
    oc = (np.asarray(j_prob.obs_image) % 2).astype(np.int32)
    j_prob = j_prob._replace(cam_params=np.concatenate([cam, cam * 1.01]),
                             free_cam=np.ones((2, 12)), obs_cam=oc,
                             image_cam=np.arange(5, dtype=np.int32) % 2)
    t_prob = tba.problem_from_numpy(
        {k: np.asarray(v) for k, v in j_prob._asdict().items()
         if v is not None}, device="cpu")
    if gather:
        j_prob = jba.attach_gather_layouts(j_prob)
        np.testing.assert_array_equal(t_prob.image_cam.numpy(),
                                      np.asarray(j_prob.image_cam))
    kw = dict(model_id=4, solver="explicit_schur", loss="huber")
    step = jax.jit(jba._solve_step_explicit, static_argnums=1)
    out_j = step(j_prob, jba.BAOptions(**kw), jnp.float64(1e-3))
    out_t = tba._solve_step_explicit(t_prob, tba.BAOptions(**kw),
                                     torch.tensor(1e-3, dtype=torch.float64))
    for name, a, b in zip(("u_pose", "u_cam", "d_pts", "predicted", "g_inf"),
                          out_t, out_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8,
                                   atol=1e-10 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)


def _perturbed_model(path):
    rec = jmake(num_images=5, num_points=50, seed=5)
    rng = np.random.default_rng(5)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(scale=0.05, size=3)
    rec.write(str(path))


def test_adjust_bundle_matches_sba_tpu(tmp_path):
    _perturbed_model(tmp_path / "in")
    j_rec = JRec.read(str(tmp_path / "in"))
    t_rec = TRec.read(str(tmp_path / "in"))
    s_j = j_adjust_bundle(j_rec, jba.BAOptions(max_iterations=20))["summary"]
    s_t = t_adjust_bundle(t_rec, tba.BAOptions(max_iterations=20),
                          device="cpu")["summary"]
    assert float(s_t.final_cost) < 1e-6 * float(s_t.initial_cost)
    np.testing.assert_allclose(float(s_t.initial_cost),
                               float(s_j.initial_cost), rtol=1e-12)
    # Both converge to the noise-free optimum (cost ~1e-20 and below);
    # the relative test is on the cost reduction achieved.
    np.testing.assert_allclose(float(s_t.final_cost) / float(s_t.initial_cost),
                               float(s_j.final_cost) / float(s_j.initial_cost),
                               rtol=1e-6, atol=1e-12)
    t_arr, j_arr = t_rec.to_arrays(), j_rec.to_arrays()
    np.testing.assert_allclose(t_arr.qvecs, j_arr.qvecs, atol=1e-8)
    np.testing.assert_allclose(t_arr.tvecs, j_arr.tvecs, atol=1e-8)
    np.testing.assert_allclose(t_arr.points, j_arr.points, atol=1e-8)


def test_adjust_bundle_noisy_cost_matches_sba_tpu(tmp_path):
    """With pixel noise the optimum has a well-defined nonzero cost."""
    rec = jmake(num_images=5, num_points=50, seed=6)
    rng = np.random.default_rng(6)
    for im in rec.images.values():
        im.xys = im.xys + rng.normal(scale=0.5, size=im.xys.shape)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(scale=0.05, size=3)
    rec.write(str(tmp_path / "in"))
    s_j = j_adjust_bundle(JRec.read(str(tmp_path / "in")),
                          jba.BAOptions())["summary"]
    s_t = t_adjust_bundle(TRec.read(str(tmp_path / "in")), tba.BAOptions(),
                          device="cpu")["summary"]
    assert float(s_t.final_cost) < float(s_t.initial_cost)
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-6)


def test_cli_bundle_adjuster(tmp_path, capsys):
    _perturbed_model(tmp_path / "in")
    err0 = TRec.read(str(tmp_path / "in")).compute_mean_reprojection_error()
    assert cli.main(["bundle_adjuster", "--input_path", str(tmp_path / "in"),
                     "--output_path", str(tmp_path / "out"),
                     "--device", "cpu",
                     "--BundleAdjustment.max_iterations", "20"]) == 0
    m = re.search(r"BA: cost (\S+) -> (\S+) in (\d+) iters",
                  capsys.readouterr().out)
    assert m and float(m.group(2)) < float(m.group(1))
    out = TRec.read(str(tmp_path / "out"))
    assert len(out.images) == 5
    assert out.compute_mean_reprojection_error() < 1e-3 * err0


def _f1_scene(pixel_noise):
    """tests/test_ba.py::test_recovery_noisefree_observations's scene
    (and the same with pixel noise), as a JAX and as a port problem."""
    j_prob, _ = j_make_ba_problem(num_images=5, num_points=60,
                                  pose_noise=0.02, point_noise=0.05,
                                  pixel_noise=pixel_noise, seed=1)
    t_prob = tba.problem_from_numpy(
        {k: np.asarray(v) for k, v in j_prob._asdict().items()
         if v is not None}, device="cpu")
    return j_prob, t_prob


@pytest.mark.parametrize("pixel_noise", [0.0, 0.5])
@pytest.mark.parametrize("solver", ["dense_schur", "schur_pcg"])
def test_implicit_solvers_match_sba_tpu(solver, pixel_noise):
    """The f64 dense-Schur and PCG solves end where sba_tpu's do: final
    cost (rtol 1e-6) and poses (atol 1e-6)."""
    j_prob, t_prob = _f1_scene(pixel_noise)
    out_j, s_j = jba.bundle_adjust(j_prob, jba.BAOptions(solver=solver))
    out_t, s_t = tba.bundle_adjust(t_prob, tba.BAOptions(solver=solver))
    assert float(s_t.final_cost) < 1e-3 * float(s_t.initial_cost)
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(out_t.qvecs.numpy(), np.asarray(out_j.qvecs),
                               atol=1e-6)
    np.testing.assert_allclose(out_t.tvecs.numpy(), np.asarray(out_j.tvecs),
                               atol=1e-6)


@pytest.mark.parametrize("solver", ["dense_schur", "schur_pcg"])
def test_implicit_step_f64_matches_sba_tpu(solver):
    """One dense or PCG step (`_solve_step` over `_make_operators`) on an
    OPENCV scene with free intrinsics and a robust loss."""
    j_prob, t_prob = _problems(4, observations_per_point=None)
    cam = np.array(j_prob.cam_params)
    cam[:, 4:8] = (0.02, -0.005, 1e-3, -2e-3)
    free_cam = np.ones_like(cam)
    j_prob = j_prob._replace(cam_params=cam, free_cam=free_cam)
    t_prob = t_prob._replace(cam_params=torch.as_tensor(cam),
                             free_cam=torch.as_tensor(free_cam))
    kw = dict(model_id=4, solver=solver, loss="huber", cg_tolerance=1e-12)
    step = jax.jit(jba._solve_step, static_argnums=(1, 3))
    out_j = step(j_prob, jba.BAOptions(**kw), jnp.float64(1e-3),
                 solver == "dense_schur")
    out_t = tba._solve_step(t_prob, tba.BAOptions(**kw),
                            torch.tensor(1e-3, dtype=torch.float64))
    for name, a, b in zip(("u_pose", "u_cam", "d_pts", "predicted", "g_inf"),
                          out_t, out_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8,
                                   atol=1e-10 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)


def _routed_step(module, monkeypatch):
    """Record the step `module.bundle_adjust` routes to instead of
    solving: explicit (point-major), explicit_coo, dense or pcg."""
    seen = []

    def record(problem, options, use_dense=None):
        if options.solver == "explicit_schur":
            seen.append("explicit_coo" if getattr(
                options, "obs_layout", "point_major") == "coo"
                else "explicit")
        else:
            dense = (options.solver == "dense_schur" if use_dense is None
                     else use_dense)
            seen.append("dense" if dense else "pcg")
        return None, None

    monkeypatch.setattr(module, "_bundle_adjust_impl", record)
    return seen


@pytest.mark.parametrize("dense_threshold", [512, 16])
@pytest.mark.parametrize("over_limit", [False, True])
@pytest.mark.parametrize("solver", ["auto", "explicit_schur", "dense_schur",
                                    "schur_pcg", "fused"])
def test_solver_routing_matches_sba_tpu(monkeypatch, solver, over_limit,
                                        dense_threshold):
    """`bundle_adjust` picks sba_tpu's step for every solver, with the
    couplings under and over the explicit step's byte limit (the port's
    limit is lowered instead of allocating 2 GiB; sba_tpu's fixed one is
    passed by a zero-stride stand-in for the points, which its routing
    reads only the shape of), and with the reduced system (42 unknowns)
    under and over `dense_threshold`: explicit_schur over the limit
    takes the COO explicit step in both, and so does fused (off the
    kernels) under it."""
    j_prob, t_prob = _problems(0)
    if over_limit:
        monkeypatch.setattr(tba, "EXPLICIT_SCHUR_MAX_BYTES", 1)
        reduced = 6 * j_prob.qvecs.shape[0] + 12
        rows = 2 * 1024 ** 3 // (reduced * 3 * 8) + 1
        j_prob = j_prob._replace(points=np.broadcast_to(
            np.zeros(3), (rows, 3)))
    seen_j = _routed_step(jba, monkeypatch)
    seen_t = _routed_step(tba, monkeypatch)
    jba.bundle_adjust(j_prob, jba.BAOptions(
        solver=solver, dense_threshold=dense_threshold))
    tba.bundle_adjust(t_prob, tba.BAOptions(
        solver=solver, dense_threshold=dense_threshold))
    assert seen_t == seen_j
    assert (seen_j[0] == "explicit") == (solver in ("auto", "explicit_schur")
                                         and not over_limit)
