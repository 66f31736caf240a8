"""Parity of the port's geometric-semantic bundle adjustment with sba_tpu
on the CPU.

The same numpy inputs go through sba_tpu and through sba_tpu_torch, in
float64: the scene generators (the semantic maps pixel for pixel, apart
from pixels on a silhouette's edge), the cylinder math (1e-12), the text
format (byte for byte), the Jacobian rows of both parametrizations under
a robust loss (1e-10 of scale, the IRLS weight's derivative included),
the landmark rows and the assembled normal equations, whole solves
(final cost rtol 1e-6, state 1e-6, the same iteration count, the same
hard IoU), the controller and the command. The chunk budget of the pixel
work changes no bit of a solve.

Whole solves run 20 LM iterations. These scenes are chaotic over longer
solves: sba_tpu against itself with the initial translations moved by
1e-15 parts by ~3e-5 after 40 iterations, as much as the port parts from
it (`test_long_solve_spread_is_sba_tpu_own_spread`).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the cap)
import torch
from threadpoolctl import threadpool_limits

import sba_tpu.models.cylinder as jcyl
import sba_tpu.optim.gsba as jg
import sba_tpu.utils.synthetic as jsyn
import sba_tpu_torch.models.cylinder as tcyl
import sba_tpu_torch.optim.gsba as tg
import sba_tpu_torch.utils.synthetic as tsyn

torch.set_num_threads(2)
threadpool_limits(1, user_api="blas")

STATE = ("qvecs", "tvecs", "cyl_qvec", "cyl_tvec", "cyl_log_radius",
         "cyl_log_height", "points")
# bench.py's solve settings: tolerances off.
GSBA_NO_TOL = dict(mode="soft", function_tolerance=0.0,
                   gradient_tolerance=0.0, parameter_tolerance=0.0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _carry(p):
    """sba_tpu's GSBAProblem -> the port's, through numpy."""
    return tg.gsba_problem_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in p._asdict().items()}, "cpu")


def _cyls(c):
    return c if isinstance(c, list) else [c]


def _landmarks(q_gt, t_gt, cam, seed=0):
    """30 points seen by every image (tests/test_gsba.py's landmarks)."""
    from sba_tpu_torch.geometry.quaternions import np_quat_rotate

    pts = np.random.default_rng(seed).uniform([-2, -2, -1], [2, 2, 1],
                                              size=(30, 3))
    oi, op, ox = [], [], []
    for i in range(len(q_gt)):
        pc = np_quat_rotate(q_gt[i], pts) + t_gt[i]
        ox.append(cam[i, 0] * pc[:, :2] / pc[:, 2:3] + cam[i, 1:3])
        oi += [i] * len(pts)
        op += list(range(len(pts)))
    return pts, (np.array(oi, np.int32), np.array(op, np.int32),
                 np.concatenate(ox))


def _edge_distance(cyls, q, t, cam, h, w):
    """Per image and pixel, the least |cross| over every visible
    cylinder's edges, relative to the edge length times the image size
    (the port's float64 quads)."""
    out = np.full((len(q), h, w), np.inf)
    px, py = torch.arange(w, dtype=torch.float64), torch.arange(
        h, dtype=torch.float64)
    for c in cyls:
        n = len(q)
        quad, valid = tcyl.project_quadrilateral(
            _t(np.tile(c.qvec, (n, 1))), _t(np.tile(c.tvec, (n, 1))),
            _t(np.full(n, c.radius)), _t(np.full(n, c.height)), _t(q),
            _t(t), _t(cam))
        for e in range(4):
            cross, ex, ey = tcyl.edge_cross(quad, e, px, py)
            scale = torch.sqrt(ex * ex + ey * ey)[:, None, None] * max(h, w)
            rel = (cross.abs() / scale).numpy()
            rel[~valid.numpy()] = np.inf
            out = np.minimum(out, rel)
    return out


def _check_masks(name, a, b, cyls, q, t, cam):
    """Masks equal but on edges: every differing pixel lies within 1e-9
    of scale of a silhouette edge (sba_tpu's CPU program may contract
    the cross product into a fused multiply-add)."""
    diff = a != b
    n = int(diff.sum())
    print(f"{name}: {n} of {diff.size} pixels differ")
    if n:
        h, w = a.shape[-2:]
        assert (_edge_distance(cyls, q, t, cam, h, w)[diff] < 1e-9).all()


# ---------------------------------------------------------------------------
# Scenes and cylinder math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn, kw", [
    ("make_gsba_scene", dict(num_images=4, image_size=(64, 48),
                             pose_noise=0.01, cylinder_noise=0.05, seed=1)),
    ("make_gsba_forest_scene", dict(num_cylinders=4, cameras_per_cylinder=2,
                                    image_size=(96, 72), pose_noise=0.005,
                                    cylinder_noise=0.03, seed=0)),
])
def test_scene_generators_match_sba_tpu(fn, kw):
    ja = getattr(jsyn, fn)(**kw)
    ta = getattr(tsyn, fn)(**kw)
    q, t, cam, sem, cyls = ta[:5]
    # The port's look-at quaternions may differ from sba_tpu's in the
    # last bit (its rotmat_to_quat's order of operations); the rest of
    # the draws and arithmetic are the same.
    for i in (0, 5):
        np.testing.assert_allclose(ta[i], ja[i], rtol=0, atol=4e-16)
    for i in (1, 2, 6):
        np.testing.assert_array_equal(ta[i], ja[i])
    for i in (4, 7):
        for a, b in zip(_cyls(ta[i]), _cyls(ja[i])):
            for f in ("qvec", "tvec", "radius", "height"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    _check_masks(fn, sem, ja[3], _cyls(cyls), q, t, cam)


def _math_inputs():
    """Every cylinder of a small forest against every camera, plus a
    camera inside the first cylinder (invalid)."""
    q, t, cam, _, cyls, q0, t0, cyls0 = tsyn.make_gsba_forest_scene(
        num_cylinders=3, cameras_per_cylinder=2, image_size=(40, 30),
        focal=40.0, pose_noise=0.01, cylinder_noise=0.05, seed=2)
    from sba_tpu_torch.geometry.quaternions import np_quat_rotate

    inside = np.asarray(cyls0[0].tvec) + [0.0, 0.0, 1.0]
    q = np.concatenate([q0, q0[:1]])
    t = np.concatenate([t0, -np_quat_rotate(q0[0], inside)[None]])
    cam = np.concatenate([cam, cam[:1]])
    N, K = len(q), len(cyls0)
    cq = np.stack([c.qvec for c in cyls0])
    ct = np.stack([c.tvec for c in cyls0])
    cr = np.array([c.radius for c in cyls0])
    ch = np.array([c.height for c in cyls0])

    def nk(a, per_image):
        a = np.asarray(a)
        if per_image:
            return np.broadcast_to(a[:, None], (N, K) + a.shape[1:])
        return np.broadcast_to(a[None], (N, K) + a.shape[1:])

    return [np.ascontiguousarray(x) for x in (
        nk(cq, False), nk(ct, False), nk(cr, False), nk(ch, False),
        nk(q, True), nk(t, True), nk(cam, True))]


def test_cylinder_math_matches_sba_tpu():
    args = _math_inputs()
    jres = jax.jit(jcyl.cylinder_edge_points)(*map(jnp.asarray, args[:6]))
    tres = tcyl.cylinder_edge_points(*map(_t, args[:6]))
    np.testing.assert_array_equal(np.asarray(jres[4]), tres[4].numpy())
    assert not tres[4].numpy().all()       # the camera inside
    ok = tres[4].numpy()
    for a, b in zip(jres[:4], tres[:4]):
        assert _rel(b.numpy()[ok], np.asarray(a)[ok]) < 1e-12
    jq, jv = jax.jit(jcyl.project_quadrilateral)(*map(jnp.asarray, args))
    tq, tv = tcyl.project_quadrilateral(*map(_t, args))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    ok = tv.numpy()
    assert ok.sum() >= 10
    assert _rel(tq.numpy()[ok], np.asarray(jq)[ok]) < 1e-12

    quad = np.asarray(jq)[ok]
    H, W = 30, 40
    sem = (np.random.default_rng(0).uniform(size=(len(quad), H, W)) < 0.3
           ).astype(np.float64)
    jmask = jax.jit(jcyl.quadrilateral_mask,
                    static_argnames=("height", "width", "soft_tau", "hard"))
    for tau in (0.3, 1.0):
        jm = np.asarray(jmask(jnp.asarray(quad), height=H, width=W,
                              soft_tau=tau))
        tm = tcyl.quadrilateral_mask(_t(quad), H, W, soft_tau=tau)
        assert np.abs(tm.numpy() - jm).max() < 1e-12
        ji = np.asarray(jax.jit(jcyl.semantic_iou)(jnp.asarray(jm),
                                                   jnp.asarray(sem > 0.5)))
        ti = tcyl.semantic_iou(tm, _t(sem > 0.5)).numpy()
        assert np.abs(ti - ji).max() < 1e-12
    jh = np.asarray(jmask(jnp.asarray(quad), height=H, width=W,
                          hard=True))
    th = tcyl.quadrilateral_mask(_t(quad), H, W, hard=True).numpy()
    assert th.sum() > 0
    diff = jh != th
    print(f"hard masks: {int(diff.sum())} of {diff.size} pixels differ")
    if diff.any():
        px, py = torch.arange(W, dtype=torch.float64), torch.arange(
            H, dtype=torch.float64)
        near = np.full(diff.shape, np.inf)
        for e in range(4):
            cross, ex, ey = tcyl.edge_cross(_t(quad), e, px, py)
            scale = torch.sqrt(ex * ex + ey * ey)[:, None, None] * W
            near = np.minimum(near, (cross.abs() / scale).numpy())
        assert (near[diff] < 1e-9).all()


def test_cylinder_text_and_two_points_match_sba_tpu(tmp_path):
    _, _, _, _, cyls, _, _, cyls0 = tsyn.make_gsba_forest_scene(
        num_cylinders=3, cameras_per_cylinder=1, image_size=(20, 16),
        cylinder_noise=0.1, seed=4)
    jst = jcyl.stack_cylinders(cyls0)
    tst = tcyl.stack_cylinders(cyls0, device="cpu")
    for k, v in jst.items():
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(v))
        assert tst[k].dtype == torch.float64
    jpath, tpath = tmp_path / "j.txt", tmp_path / "t.txt"
    jcyl.write_cylinders_text(cyls + cyls0, jpath)
    got = tcyl.read_cylinders_text(jpath)
    tcyl.write_cylinders_text(got, tpath)
    assert tpath.read_bytes() == jpath.read_bytes()
    back = jcyl.read_cylinders_text(tpath)
    for a, b in zip(back, got):
        assert jcyl.cylinder_to_string(a) == tcyl.cylinder_to_string(b)
    with pytest.raises(ValueError):
        tcyl.cylinder_from_string("t 0 0 0 0 q 0 0 0 r 1 h 1")
    for c in cyls0:
        tc = tcyl.Cylinder(c.qvec, c.tvec, c.radius, c.height)
        np.testing.assert_allclose(tc.upper_tvec(), c.upper_tvec(),
                                   rtol=0, atol=1e-15)
        jt = jcyl.two_points_from_cylinder(c)
        tt = tcyl.two_points_from_cylinder(tc)
        for a, b in zip(jt, tt):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-15)
        ja = jcyl.cylinder_from_two_points(*jt)
        ta = tcyl.cylinder_from_two_points(*tt)
        for f in ("qvec", "tvec", "radius", "height"):
            np.testing.assert_allclose(getattr(ta, f), getattr(ja, f),
                                       rtol=0, atol=1e-15)
    assert tcyl.Cylinder(radius=-1.0, height=0.0).radius == 1e-4


# ---------------------------------------------------------------------------
# Linearization
# ---------------------------------------------------------------------------

def _problems(opt_kw, landmarks=False, seed=3, n=3, size=(32, 24),
              focal=26.0):
    q, t, cam, sem, cyl, q0, t0, cyl0 = tsyn.make_gsba_scene(
        num_images=n, image_size=size, focal=focal, pose_noise=0.01,
        cylinder_noise=0.05, seed=seed)
    pts = obs = None
    if landmarks:
        pts, obs = _landmarks(q, t, cam)
    jopt, topt = jg.GSBAOptions(**opt_kw), tg.GSBAOptions(**opt_kw)
    jp = jg.build_gsba_problem(q0, t0, cam, sem, [cyl0], jopt, points=pts,
                               obs=obs)
    tp = tg.build_gsba_problem(q0, t0, cam, sem, [cyl0], topt, points=pts,
                               obs=obs, device="cpu")
    for name in tg.GSBAProblem._fields[:-1]:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    assert tp.img_weight is None and jp.img_weight is None
    return jp, jopt, tp, topt


@pytest.mark.parametrize("param", ["default", "by_2_points"])
def test_geometry_rows_match_sba_tpu_jacfwd(param):
    """Residuals and Jacobian rows of the shared local tangent, under the
    Cauchy loss (the IRLS weight's derivative is in both)."""
    jp, jopt, tp, topt = _problems(dict(cylinder_parametrization=param,
                                        loss="cauchy", loss_scale=0.5))
    kdim = 8 if param == "default" else 7
    zl = jnp.zeros(6 + kdim)
    local = functools.partial(jg._geo_weighted_local, jp, jopt)
    jr = np.asarray(jax.jit(local)(zl))
    jj = np.asarray(jax.jit(jax.jacfwd(local))(zl))
    tr, tj = tg._geo_local_jacobian(tp, topt)
    assert _rel(tr.numpy(), jr) < 1e-12
    assert _rel(tj.numpy(), jj) < 1e-10
    # Without the weight's derivative the rows would differ.
    assert np.abs(jj).max() > 0


@pytest.mark.parametrize("param", ["default", "by_2_points"])
def test_normal_equations_match_sba_tpu(param):
    """The assembled (g, H) with the landmark term, against sba_tpu's
    loop body's assembly from its jacfwd pieces."""
    jp, jopt, tp, topt = _problems(
        dict(cylinder_parametrization=param, loss="huber", loss_scale=0.2,
             landmark_error_weight=10.0), landmarks=True)
    N, K, P = 3, 1, jp.points.shape[0]
    kdim = 8 if param == "default" else 7
    free = jg._free_vector(jp, jopt)
    z = jnp.zeros(free.shape[0])
    local = functools.partial(jg._geo_weighted_local, jp, jopt)
    land = functools.partial(jg._land_weighted, jp, jopt)
    jl = np.asarray(jax.jit(jax.jacfwd(local))(jnp.zeros(6 + kdim)))
    rg = np.asarray(jax.jit(local)(jnp.zeros(6 + kdim)))
    jland = np.asarray(jax.jit(jax.jacfwd(land))(z))
    rl = np.asarray(jax.jit(land)(z))
    J = np.zeros((N * K, free.shape[0]))
    for n in range(N):
        for k in range(K):
            J[n * K + k, n * 6:(n + 1) * 6] = jl[n * K + k, :6]
            c0 = N * 6 + k * kdim
            J[n * K + k, c0:c0 + kdim] = jl[n * K + k, 6:]
    J = np.concatenate([J, jland]) * np.asarray(free)[None]
    r = np.concatenate([rg, rl])

    tfree = tg._free_vector(tp, topt)
    np.testing.assert_array_equal(tfree.numpy(), np.asarray(free))
    trl = tg._land_weighted(tp, topt, torch.zeros_like(tfree))
    assert _rel(trl.numpy(), rl) < 1e-12
    tjl = torch.func.jacfwd(functools.partial(tg._land_weighted, tp,
                                              topt))(torch.zeros_like(tfree))
    assert _rel(tjl.numpy(), jland) < 1e-10
    g, H = tg._linearize(tp, topt, tfree)
    assert _rel(g.numpy(), J.T @ r) < 1e-10
    assert _rel(H.numpy(), J.T @ J) < 1e-10
    assert P * 3 > 0 and np.abs(J.T @ J)[-3 * P:, -3 * P:].max() > 0


def test_chunk_budget_changes_no_bit(monkeypatch):
    """One image per chunk and all images in one chunk: the same
    linearization and the same solve, bit for bit."""
    _, _, tp, topt = _problems(dict(landmark_error_weight=5.0,
                                    max_iterations=8), landmarks=True, n=4)
    free = tg._free_vector(tp, topt)
    runs = []
    for budget, n_chunks in ((1, 4), (1 << 40, 1)):
        monkeypatch.setattr(tg, "GSBA_CHUNK_BYTES", budget)
        assert len(tg.image_chunks(tp)) == n_chunks
        runs.append((tg._linearize(tp, topt, free),
                     tg.geometric_semantic_bundle_adjust(tp, topt)))
    ((g1, H1), (o1, s1)), ((g2, H2), (o2, s2)) = runs
    assert torch.equal(g1, g2) and torch.equal(H1, H2)
    assert s1.num_iterations == s2.num_iterations == 8
    for f in STATE:
        assert torch.equal(getattr(o1, f), getattr(o2, f)), f
    assert torch.equal(s1.per_image_iou, s2.per_image_iou)
    assert torch.equal(s1.cost_trace.nan_to_num(-1.0),
                       s2.cost_trace.nan_to_num(-1.0))


# ---------------------------------------------------------------------------
# Whole solves
# ---------------------------------------------------------------------------

def _solve_both(scene, opt_kw, landmarks=False):
    q, t, cam, sem, cyl, q0, t0, cyl0 = scene
    pts = obs = None
    if landmarks:
        pts, obs = _landmarks(q, t, cam)
    jopt, topt = jg.GSBAOptions(**opt_kw), tg.GSBAOptions(**opt_kw)
    jp = jg.build_gsba_problem(q0, t0, cam, sem, _cyls(cyl0), jopt,
                               points=pts, obs=obs)
    jo, js = jg.geometric_semantic_bundle_adjust(jp, jopt)
    to, ts = tg.geometric_semantic_bundle_adjust(_carry(jp), topt)
    return jp, (jo, js), (to, ts)


def _check_solve(name, j, t):
    (jo, js), (to, ts) = j, t
    c0, c1 = float(js.final_cost), float(ts.final_cost)
    state = max(float(np.abs(getattr(to, f).numpy()
                             - np.asarray(getattr(jo, f))).max())
                for f in STATE)
    print(f"{name}: sba_tpu {c0:.12g} in {int(js.num_iterations)} it, "
          f"port {c1:.12g} in {ts.num_iterations} it; state {state:.2e}")
    assert ts.num_iterations == int(js.num_iterations)
    assert abs(c1 - c0) <= 1e-6 * abs(c0)
    assert float(ts.initial_cost) == pytest.approx(float(js.initial_cost),
                                                   rel=1e-12)
    assert state <= 1e-6
    np.testing.assert_array_equal(ts.per_image_iou.numpy(),
                                  np.asarray(js.per_image_iou))
    assert float(ts.mean_iou) == pytest.approx(float(js.mean_iou),
                                               rel=1e-12)
    np.testing.assert_allclose(ts.cost_trace.numpy(),
                               np.asarray(js.cost_trace), rtol=1e-6)


@pytest.mark.parametrize("param", ["default", "by_2_points"])
def test_solve_with_landmarks_matches_sba_tpu(param):
    """tests/test_gsba.py's joint scene (seed 4) with its landmarks."""
    scene = tsyn.make_gsba_scene(num_images=4, image_size=(64, 48),
                                 pose_noise=0.005, cylinder_noise=0.03,
                                 seed=4)
    _, j, t = _solve_both(scene, dict(
        max_iterations=20, landmark_error_weight=10.0,
        cylinder_parametrization=param), landmarks=True)
    _check_solve(f"joint {param}", j, t)
    assert float(t[1].final_cost) < float(t[1].initial_cost)


def test_forest_solve_matches_sba_tpu():
    """4 cylinders x 8 images at 96x72, poses and cylinders free."""
    scene = tsyn.make_gsba_forest_scene(
        num_cylinders=4, cameras_per_cylinder=2, image_size=(96, 72),
        pose_noise=0.005, cylinder_noise=0.03, seed=0)
    _, j, t = _solve_both(scene, dict(max_iterations=20))
    _check_solve("forest", j, t)
    assert t[1].per_image_iou.shape == (8, 4)


def test_forest_trunk_trade_matches_sba_tpu():
    """bench.py's forest settings (tolerances off, poses and cylinders
    free) on 4 trunks x 8 images at 160x120: the mean own-view hard IoU
    rises, but one trunk's falls, in sba_tpu's solve as in the port's
    (one 1 - IoU residual per image against the union mask trades one
    trunk's views against the others'). So the card's forest phase
    gates the mean, not every trunk."""
    scene = tsyn.make_gsba_forest_scene(
        num_cylinders=4, cameras_per_cylinder=2, image_size=(160, 120),
        focal=175.0, pose_noise=0.005, cylinder_noise=0.03, seed=0)
    opt_kw = dict(GSBA_NO_TOL, max_iterations=10)
    jp, j, t = _solve_both(scene, opt_kw)
    _check_solve("forest 160x120", j, t)
    own = np.arange(8) // 2

    def own_iou(iou):
        iou = np.asarray(iou)[np.arange(8), own]
        return np.array([iou[own == k].mean() for k in range(4)])

    iou0 = own_iou(jg.evaluate_iou(jp))
    ij, it = own_iou(j[1].per_image_iou), own_iou(t[1].per_image_iou.numpy())
    print(f"own-view IoU {iou0} -> sba_tpu {ij}, port {it}")
    np.testing.assert_array_equal(it, ij)
    assert it.mean() > iou0.mean()
    assert np.nonzero(it < iou0)[0].tolist() == [1]


def test_long_solve_spread_is_sba_tpu_own_spread():
    """Over 40 iterations the joint scene is chaotic: the port parts
    from sba_tpu by no more than sba_tpu parts from itself when the
    free initial translations move by 1e-15."""
    scene = tsyn.make_gsba_scene(num_images=4, image_size=(64, 48),
                                 pose_noise=0.005, cylinder_noise=0.03,
                                 seed=4)
    opt_kw = dict(max_iterations=40, landmark_error_weight=10.0)
    jp, (jo, js), (to, ts) = _solve_both(scene, opt_kw, landmarks=True)
    jopt = jg.GSBAOptions(**opt_kw)
    jo2, js2 = jg.geometric_semantic_bundle_adjust(
        jp._replace(tvecs=jp.tvecs.at[2:].add(1e-15)), jopt)

    def spread(a, b):
        return max(float(np.abs(np.asarray(getattr(a, f))
                                - np.asarray(getattr(b, f))).max())
                   for f in STATE)

    own = spread(jo, jo2)
    port = max(float(np.abs(getattr(to, f).numpy()
                            - np.asarray(getattr(jo, f))).max())
               for f in STATE)
    print(f"40 iterations: sba_tpu vs itself (+1e-15) {own:.2e}, port vs "
          f"sba_tpu {port:.2e}")
    assert ts.num_iterations == int(js.num_iterations) == 40
    assert port <= 10 * own + 1e-12


def test_sharded_images_raise():
    _, _, tp, _ = _problems({})
    with pytest.raises(NotImplementedError):
        tg.geometric_semantic_bundle_adjust(tp, tg.GSBAOptions(axis_name="d"))


# ---------------------------------------------------------------------------
# Controller and command
# ---------------------------------------------------------------------------

def _write_workspace(tmp_path, landmarks):
    """tests/test_cli_semantic.py's GSBA model (4 x 64x48, seed 1): a
    SIMPLE_PINHOLE model of the initial poses, its semantic TIFFs and the
    perturbed cylinder; with `landmarks`, 30 points tracked in every
    image and pose noise."""
    from sba_tpu_torch.geometry import camera_models
    from sba_tpu_torch.io.colmap_models import Camera, Image
    from sba_tpu_torch.io.maps import write_float_map_tiff
    from sba_tpu_torch.models.reconstruction import Reconstruction

    q, t, cam, sem, cyl, q0, t0, cyl0 = tsyn.make_gsba_scene(
        num_images=4, image_size=(64, 48),
        pose_noise=0.005 if landmarks else 0.0, cylinder_noise=0.08, seed=1)
    rec = Reconstruction()
    sp = camera_models.model_by_name("SIMPLE_PINHOLE").model_id
    rec.add_camera(Camera(camera_id=1, model_id=sp, width=64, height=48,
                          params=np.asarray(cam[0], np.float64)))
    pts, (oi, op, oxy) = _landmarks(q, t, cam)
    for i in range(4):
        xy = oxy[oi == i] if landmarks else np.zeros((0, 2))
        rec.add_image(Image(image_id=i + 1, qvec=np.asarray(q0[i]),
                            tvec=np.asarray(t0[i]), camera_id=1,
                            name=f"im{i}.png", xys=xy,
                            point3D_ids=np.full(len(xy), -1, np.int64)),
                      registered=True)
    if landmarks:
        for p in range(len(pts)):
            rec.add_point3d(pts[p], [(i + 1, p) for i in range(4)])
    (tmp_path / "in").mkdir()
    rec.write(str(tmp_path / "in"))
    (tmp_path / "maps").mkdir()
    for i in range(4):
        write_float_map_tiff(sem[i],
                             tmp_path / "maps" / f"im{i}_semantic.tiff")
    tcyl.write_cylinders_text([cyl0], tmp_path / "cylinders.txt")
    return cyl, cyl0


@pytest.mark.parametrize("landmarks", [False, True])
def test_command_matches_sba_tpu(tmp_path, capsys, landmarks):
    """geometric_semantic_bundle_adjuster of both packages on the same
    files: the printed line, cylinders.txt and images.txt at 1e-6."""
    from sba_tpu.cli import main as jmain
    from sba_tpu_torch.cli import main as tmain
    from sba_tpu_torch.models.reconstruction import Reconstruction

    cyl, cyl0 = _write_workspace(tmp_path, landmarks)
    flags = (["--GeometricSemanticBundleAdjustment.landmark_error_weight",
              "10", "--GeometricSemanticBundleAdjustment.max_iterations",
              "15"] if landmarks else
             ["--GeometricSemanticBundleAdjustment.refine_extrinsics", "0",
              "--GeometricSemanticBundleAdjustment.max_iterations", "40"])
    lines = {}
    for tag, main, extra in (("j", jmain, []),
                             ("t", tmain, ["--device", "cpu"])):
        assert main(["geometric_semantic_bundle_adjuster",
                     "--input_path", str(tmp_path / "in"),
                     "--output_path", str(tmp_path / f"out_{tag}"),
                     "--data_path", str(tmp_path / "maps"),
                     "--input_geometry", str(tmp_path / "cylinders.txt"),
                     *flags, *extra]) == 0
        out = capsys.readouterr().out
        m = re.search(r"GSBA: cost (\S+) -> (\S+), mean IoU (\S+)", out)
        assert m, out
        lines[tag] = [float(x) for x in m.groups()]
    np.testing.assert_allclose(lines["t"], lines["j"], rtol=1e-5)
    (cj,) = tcyl.read_cylinders_text(tmp_path / "out_j" / "cylinders.txt")
    (ct,) = tcyl.read_cylinders_text(tmp_path / "out_t" / "cylinders.txt")
    for f in ("qvec", "tvec", "radius", "height"):
        np.testing.assert_allclose(getattr(ct, f), getattr(cj, f), rtol=0,
                                   atol=1e-6)
    assert lines["t"][1] < lines["t"][0]
    if not landmarks:   # tests/test_cli_semantic.py's check
        assert (np.linalg.norm(ct.tvec - cyl.tvec)
                < np.linalg.norm(cyl0.tvec - cyl.tvec))
    rj = Reconstruction.read(str(tmp_path / "out_j"))
    rt = Reconstruction.read(str(tmp_path / "out_t"))
    for iid in rj.images:
        np.testing.assert_allclose(rt.images[iid].qvec, rj.images[iid].qvec,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(rt.images[iid].tvec, rj.images[iid].tvec,
                                   rtol=0, atol=1e-6)
    assert len(rt.points3D) == (30 if landmarks else 0)


def test_controller_exports_match_sba_tpu(tmp_path):
    """export_steps: the IoU table equal to sba_tpu's, the mask JPEGs
    written; the callback sees the iteration count and final cost."""
    from sba_tpu.controllers import geometric_semantic_ba as jc
    from sba_tpu_torch.controllers import geometric_semantic_ba as tc

    _write_workspace(tmp_path, False)
    seen = {}
    for tag, mod, kw in (("j", jc, {}), ("t", tc, {"device": "cpu"})):
        opt = mod.GeometricSemanticBAControllerOptions(
            input_path=str(tmp_path / "in"),
            output_path=str(tmp_path / f"out_{tag}"),
            data_path=str(tmp_path / "maps"),
            input_geometry=str(tmp_path / "cylinders.txt"),
            output_geometry=str(tmp_path / f"geom_{tag}" / "c.txt"),
            run_path=str(tmp_path / f"run_{tag}"), export_steps=True)
        opt.gsba = mod.GSBAOptions(max_iterations=10,
                                   refine_extrinsics=False)
        mod.run_geometric_semantic_bundle_adjustment(
            opt, callback=lambda i, c, tag=tag: seen.update({tag: (i, c)}),
            **kw)
    step = "optim_steps/final"
    assert ((tmp_path / "run_t" / step / "iou.txt").read_text()
            == (tmp_path / "run_j" / step / "iou.txt").read_text())
    for i in range(4):
        for kind in ("mask", "semantic"):
            assert (tmp_path / "run_t" / step / f"im{i}_{kind}.jpg").exists()
    assert (tmp_path / "geom_t" / "c.txt").exists()
    assert seen["t"][0] == seen["j"][0] == 10
    assert seen["t"][1] == pytest.approx(seen["j"][1], rel=1e-6)

    from sba_tpu_torch.models.reconstruction import Reconstruction
    rec = Reconstruction.read(str(tmp_path / "in"))
    for iid in list(rec.images)[1:]:
        rec.registered_image_ids.remove(iid)
    with pytest.raises(ValueError):
        tc.run_geometric_semantic_bundle_adjustment(
            tc.GeometricSemanticBAControllerOptions(), reconstruction=rec,
            device="cpu")
