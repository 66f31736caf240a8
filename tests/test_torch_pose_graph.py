"""The port's pose graph (`sba_tpu_torch.optim.pose_graph`) against
sba_tpu's, in float64 on the CPU with the same numpy inputs: the SE3
and Sim3 rings, the gauge, padded edges, a robust loss and the round
trip from a reconstruction (tests/test_pose_graph.py's cases). Poses
and costs agree at 1e-9 of the scene's scale, the LM iteration counts
are equal, and so are the PCG iteration counts of every LM iteration
(sba_tpu's read by a callback after each of its loops, on short solves
whose PCG stops before its cap); the linearization's
rows agree at 1e-10. The covisible-pair count that replaces sba_tpu's
``Counter`` gives its pairs, counts and insertion order."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_tpu.optim import pose_graph as j_pg
from sba_tpu_torch.optim import pose_graph as t_pg
from test_pose_graph import _make_ring

torch.set_num_threads(2)


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def to_port(p, dtype=torch.float64):
    return t_pg.make_problem(
        np_(p.qvecs), np_(p.tvecs), np_(p.edge_i), np_(p.edge_j),
        np_(p.rel_q), np_(p.rel_t), sqrt_info=np_(p.sqrt_info),
        edge_mask=np_(p.edge_mask), pose_fixed=np_(p.pose_fixed),
        log_scales=np_(p.log_scales), rel_log_s=np_(p.rel_log_s),
        dtype=dtype, device="cpu")


def port_options(opt):
    return t_pg.PoseGraphOptions(**{
        f: getattr(opt, f) for f in t_pg.PoseGraphOptions.__dataclass_fields__})


def sba_counted(problem, opt):
    """sba_tpu's jitted solve, traced with each `lax.while_loop` followed
    by an ordered callback of its final iteration count; returns
    (problem, summary, PCG iterations of each LM iteration)."""
    counts = []
    while_loop = jax.lax.while_loop

    def counting_while(cond, body, init):
        out = while_loop(cond, body, init)
        jax.debug.callback(lambda it: counts.append(int(it)), out[0],
                           ordered=True)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "while_loop", counting_while)
        out, summary = jax.jit(lambda p: j_pg._optimize_impl(p, opt))(
            jax.tree.map(jnp.asarray, problem))
        jax.effects_barrier()
    return out, summary, counts[:-1]


def scale_of(p):
    return float(np.abs(np_(p.tvecs)).max())


def assert_same_solve(jp, opt, t_problem=None, eager=False):
    """Both solves of one problem: poses and costs at 1e-9 of scale,
    equal LM (and, with `eager`, PCG) iteration counts."""
    tp = to_port(jp) if t_problem is None else t_problem
    jo, js = j_pg.optimize_pose_graph(jp, opt)
    to, ts = t_pg.optimize_pose_graph(tp, port_options(opt))
    tol = 1e-9 * scale_of(jp)
    assert ts.num_iterations == int(js.num_iterations)
    for f in ("qvecs", "tvecs", "log_scales"):
        np.testing.assert_allclose(np_(getattr(to, f)), np_(getattr(jo, f)),
                                   rtol=0, atol=tol)
    c0 = float(js.initial_cost)
    assert abs(float(ts.initial_cost) - c0) <= 1e-12 * c0
    assert abs(float(ts.final_cost) - float(js.final_cost)) <= 1e-9 * c0
    assert int(ts.num_residuals) == int(js.num_residuals)
    if eager:
        eo, es, cg = sba_counted(jp, opt)
        assert int(es.num_iterations) == ts.num_iterations
        assert np_(ts.cg_iterations)[:ts.num_iterations].tolist() == cg
    return to, ts


def test_se3_ring_matches_sba_tpu():
    problem, _truth = _make_ring(n=12, noise=0.08, seed=3)
    assert_same_solve(problem, j_pg.PoseGraphOptions(
        max_iterations=100, function_tolerance=1e-15,
        gradient_tolerance=1e-14, parameter_tolerance=1e-14,
        cg_tolerance=1e-10))


def test_sim3_ring_matches_sba_tpu():
    problem, truth = _make_ring(n=10, noise=0.05, seed=7, sim3=True)
    opt = j_pg.PoseGraphOptions(max_iterations=120, sim3=True,
                                function_tolerance=1e-15,
                                cg_tolerance=1e-10)
    to, _ = assert_same_solve(problem, opt)
    np.testing.assert_allclose(np.exp(np_(to.log_scales)), truth[2],
                               rtol=1e-4)


@pytest.mark.parametrize("loss,scale", [("huber", 1.0), ("cauchy", 0.1),
                                        ("soft_l1", 0.5)])
def test_robust_loss_matches_sba_tpu(loss, scale):
    """A corrupted loop closure under a robust loss, at sba_tpu's default
    PCG tolerance (the PCG stops early: its counts are compared)."""
    problem, _truth = _make_ring(n=12, noise=0.05, seed=9)
    rt = np.array(problem.rel_t)
    rt[-1] += np.array([5.0, -4.0, 3.0])
    problem = problem._replace(rel_t=rt)
    assert_same_solve(problem, j_pg.PoseGraphOptions(
        max_iterations=30, loss=loss, loss_scale=scale))


@pytest.mark.parametrize("sim3,loss,cg_tol", [(False, "trivial", 1e-4),
                                              (True, "huber", 1e-3)])
def test_pcg_counts_match_sba_tpu(sim3, loss, cg_tol):
    """The PCG stops at sba_tpu's iteration in every LM iteration (a
    tolerance it reaches well before its cap)."""
    problem, _truth = _make_ring(n=12, noise=0.1, seed=4, sim3=sim3)
    _, ts = assert_same_solve(problem, j_pg.PoseGraphOptions(
        max_iterations=8, sim3=sim3, loss=loss, cg_tolerance=cg_tol),
        eager=True)
    cg = np_(ts.cg_iterations)[:ts.num_iterations]
    assert 0 < cg.min() and cg.max() < 50


def test_gauge_pose_stays_fixed():
    problem, _ = _make_ring(n=8, noise=0.1, seed=1)
    to, _ = assert_same_solve(problem, j_pg.PoseGraphOptions(
        max_iterations=20))
    np.testing.assert_array_equal(np_(to.qvecs[0]), problem.qvecs[0])
    np.testing.assert_array_equal(np_(to.tvecs[0]), problem.tvecs[0])


def test_padded_edges_match_sba_tpu():
    problem, _ = _make_ring(n=9, noise=0.06, seed=5)
    jpad = j_pg.pad_edges_pow2(jax.tree.map(jnp.asarray, problem))
    tpad = t_pg.pad_edges_pow2(to_port(problem))
    assert tpad.edge_i.shape[0] == jpad.edge_i.shape[0] > \
        problem.edge_i.shape[0]
    for f in t_pg.PoseGraphProblem._fields:
        np.testing.assert_array_equal(np_(getattr(tpad, f)),
                                      np_(getattr(jpad, f)), err_msg=f)
    opt = j_pg.PoseGraphOptions(max_iterations=40)
    tpad_out, _ = assert_same_solve(jax.tree.map(np.asarray, jpad), opt,
                                    t_problem=tpad)
    t_out, _ = t_pg.optimize_pose_graph(to_port(problem),
                                        port_options(opt))
    np.testing.assert_allclose(np_(tpad_out.tvecs), np_(t_out.tvecs),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("sim3,loss", [(False, "trivial"), (True, "trivial"),
                                       (False, "huber"), (True, "cauchy")])
def test_linearization_rows_match_sba_tpu(sim3, loss):
    """Residuals and both endpoint Jacobians at 1e-10 of their scale,
    away from the solution (noisy poses), with two padded edges and a
    fixed pose."""
    problem, _ = _make_ring(n=10, noise=0.2, seed=11, sim3=sim3)
    problem = problem._replace(edge_mask=np.concatenate(
        [np.ones(len(problem.edge_mask) - 2), np.zeros(2)]))
    jopt = j_pg.PoseGraphOptions(sim3=sim3, loss=loss, loss_scale=0.3)
    ref = jax.jit(j_pg._linearize, static_argnums=1)(
        jax.tree.map(jnp.asarray, problem), jopt)
    got = t_pg._linearize(to_port(problem), port_options(jopt))
    for a, b in zip(ref, got):
        a = np_(a)
        np.testing.assert_allclose(np_(b), a, rtol=0,
                                   atol=1e-10 * np.abs(a).max())
    c_ref = float(j_pg._cost(jax.tree.map(jnp.asarray, problem), jopt))
    c_got = float(t_pg._cost(to_port(problem), port_options(jopt)))
    assert abs(c_got - c_ref) <= 1e-12 * c_ref


def test_float32_problem_equals_sba_tpu():
    """make_problem's float32 default rounds as sba_tpu's does."""
    problem, _ = _make_ring(n=6, noise=0.05, seed=2, dtype=np.float64)
    jp = j_pg.make_problem(problem.qvecs, problem.tvecs, problem.edge_i,
                           problem.edge_j, problem.rel_q, problem.rel_t)
    tp = t_pg.make_problem(problem.qvecs, problem.tvecs, problem.edge_i,
                           problem.edge_j, problem.rel_q, problem.rel_t,
                           device="cpu")
    for f in t_pg.PoseGraphProblem._fields:
        a, b = np_(getattr(jp, f)), np_(getattr(tp, f))
        assert a.dtype.kind == b.dtype.kind and (
            a.dtype.kind == "i" or b.dtype == np.float32), f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_axis_name_raises():
    problem, _ = _make_ring(n=4, noise=0.05, seed=2)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        t_pg.optimize_pose_graph(to_port(problem),
                                 t_pg.PoseGraphOptions(axis_name="edges"))


@pytest.mark.parametrize("seed", [0, 1])
def test_covisible_pairs_equal_counter(seed):
    """The bulk count against sba_tpu's Counter loop: the same pairs and
    counts, in its insertion order; repeated ids and skipped (-1) ids."""
    rng = np.random.default_rng(seed)
    tracks = [rng.integers(-1, 30, rng.integers(0, 9)) for _ in range(400)]
    ref = Counter()
    for tr in tracks:
        tr = [int(x) for x in tr if x >= 0]
        for a in range(len(tr)):
            for b in range(a + 1, len(tr)):
                if tr[a] != tr[b]:
                    ref[(min(tr[a], tr[b]), max(tr[a], tr[b]))] += 1
    i, j, c = t_pg.covisible_pairs(tracks, 30)
    assert list(zip(i.tolist(), j.tolist())) == list(ref)
    assert c.tolist() == list(ref.values())


@pytest.fixture(scope="module")
def synthetic_model(tmp_path_factory):
    from sba_tpu.utils.synthetic import make_synthetic_reconstruction

    path = tmp_path_factory.mktemp("pg_model")
    make_synthetic_reconstruction(num_images=8, num_points=120,
                                  seed=2).write(str(path))
    return path


@pytest.mark.parametrize("sim3", [False, True])
def test_from_reconstruction_matches_sba_tpu(synthetic_model, sim3):
    """The covisibility graph (edges and their order, measurements,
    weights), a relaxation of perturbed poses and the write-back."""
    from sba_tpu.models.reconstruction import Reconstruction as JRec
    from sba_tpu_torch.models.reconstruction import Reconstruction as TRec

    jrec, trec = JRec.read(str(synthetic_model)), TRec.read(
        str(synthetic_model))
    jp, jids = j_pg.pose_graph_from_reconstruction(
        jrec, min_common_points=5, max_edges_per_image=4, sim3=sim3,
        dtype=jnp.float64)
    tp, tids = t_pg.pose_graph_from_reconstruction(
        trec, min_common_points=5, max_edges_per_image=4, sim3=sim3,
        dtype=torch.float64, device="cpu")
    assert tids == jids
    for f in ("edge_i", "edge_j", "sqrt_info", "edge_mask", "pose_fixed"):
        np.testing.assert_array_equal(np_(getattr(tp, f)),
                                      np_(getattr(jp, f)), err_msg=f)
    for f in ("rel_q", "rel_t", "qvecs", "tvecs"):
        np.testing.assert_allclose(np_(getattr(tp, f)), np_(getattr(jp, f)),
                                   rtol=0, atol=1e-12, err_msg=f)
    rng = np.random.default_rng(0)
    n = len(jids)
    daa = rng.normal(size=(n, 3)) * 0.05
    daa[0] = 0
    from sba_tpu.geometry.quaternions import (angle_axis_to_quat,
                                              quat_multiply, quat_normalize)
    q_p = np.asarray(quat_normalize(quat_multiply(
        angle_axis_to_quat(jnp.asarray(daa)), jnp.asarray(jp.qvecs))))
    t_p = np.asarray(jp.tvecs) + np.concatenate(
        [np.zeros((1, 3)), rng.normal(size=(n - 1, 3)) * 0.05])
    perturbed = jp._replace(qvecs=q_p, tvecs=t_p)
    out, _ = assert_same_solve(perturbed, j_pg.PoseGraphOptions(
        max_iterations=60, sim3=sim3))
    t_pg.apply_pose_graph_result(trec, out, tids)
    np.testing.assert_allclose(trec.images[tids[3]].tvec, np_(jp.tvecs)[3],
                               atol=1e-4)
