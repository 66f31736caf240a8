"""The port's geometry, solvers, RANSAC, two-view verification, matching,
pair schedules, image reader and front-end commands against sba_tpu on
the CPU.

Inputs are made from seeded numpy and go through both packages. The
minimal solvers' models are compared as sets (each normalized to unit
Frobenius norm, sign free): the null-space bases that LAPACK returns to
the two packages differ, so the same solutions come out in another
order. RANSAC and two-view verification get sba_tpu's own draws.
"""

import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_tpu.estimators import essential_matrix as j_ess
from sba_tpu.estimators import fundamental_matrix as j_fun
from sba_tpu.estimators import homography_matrix as j_hom
from sba_tpu.estimators import two_view_geometry as j_tvg
from sba_tpu.features import matching as j_match
from sba_tpu.features import pairing as j_pair
from sba_tpu.geometry import projection as j_proj
from sba_tpu.geometry import quaternions as j_quat
from sba_tpu.geometry import triangulation as j_tri
from sba_tpu.ops import polynomial as j_poly
from sba_tpu.optim import ransac as j_ransac
from sba_tpu.utils.host import host_cpu_device
from sba_tpu_torch.estimators import essential_matrix as t_ess
from sba_tpu_torch.estimators import fundamental_matrix as t_fun
from sba_tpu_torch.estimators import homography_matrix as t_hom
from sba_tpu_torch.estimators import two_view_geometry as t_tvg
from sba_tpu_torch.features import matching as t_match
from sba_tpu_torch.features import pairing as t_pair
from sba_tpu_torch.geometry import projection as t_proj
from sba_tpu_torch.geometry import quaternions as t_quat
from sba_tpu_torch.geometry import triangulation as t_tri
from sba_tpu_torch.ops import polynomial as t_poly
from sba_tpu_torch.optim import ransac as t_ransac

ROOT = Path(__file__).resolve().parent.parent
T = torch.as_tensor


def np_(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def close(a, b, tol):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol, err


# ---------------------------------------------------------------------------
# geometry and polynomials
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aa", [(0.3, -0.2, 0.1), (3.0, 0.1, 0.0),
                                (0.1, 3.0, 0.2), (0.0, 0.2, -3.05)])
def test_np_rotmat_to_quat(aa):
    """All four Shepperd branches."""
    R = j_quat.np_quat_to_rotmat(j_quat.np_angle_axis_to_quat(np.array(aa)))
    close(t_quat.np_rotmat_to_quat(R), j_quat.np_rotmat_to_quat(R), 1e-15)


@jax.jit
def _jax_geometry(q, t, X, cam, obs, q1, t1, q2, t2, xy1, xy2):
    """sba_tpu's side of the geometry test, as one program."""
    c2 = -j_quat.quat_rotate(j_quat.quat_conjugate(q2), t2)
    P = jnp.stack([j_proj.pose_matrix(q1, t1), j_proj.pose_matrix(q2, t2)],
                  1)
    return dict(
        pose=j_proj.pose_matrix(q, t),
        proj=j_proj.project_points(q, t, X, 2, cam),
        pinhole=j_proj.project_simple_pinhole(q, t, cam[:3], X),
        reproj=j_proj.reprojection_error(q, t, X, obs, 2, cam),
        depth=j_proj.calculate_depth(q, t, X),
        tri=j_tri.triangulate_points_batch(q1, t1, q2, t2, xy1, xy2),
        mid=j_tri.triangulate_midpoint(q1, t1, q2, t2, xy1, xy2),
        P=P,
        multi=j_tri.triangulate_multiview(P, jnp.stack([xy1, xy2], 1),
                                          jnp.ones(xy1.shape[:1] + (2,),
                                                   bool)),
        c2=c2,
        angle=j_tri.triangulation_angle(t1, c2, X))


def test_projection_and_triangulation():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((6, 4))
    t = rng.standard_normal((6, 3))
    X = rng.standard_normal((6, 3)) + [0, 0, 6]
    cam = np.array([500.0, 320.0, 240.0, 0.01])
    obs = rng.standard_normal((6, 2)) * 10 + 300
    q1 = np.tile([[1.0, 0, 0, 0]], (6, 1))
    t1 = np.zeros((6, 3))
    q2 = j_quat.np_angle_axis_to_quat(np.array([0.05, 0.1, 0.02]))[None] \
        .repeat(6, 0)
    t2 = np.tile([[0.4, 0.05, 0.1]], (6, 1))
    p2 = X @ j_quat.np_quat_to_rotmat(q2[0]).T + t2
    xy1 = X[:, :2] / X[:, 2:] + rng.normal(0, 1e-3, (6, 2))
    xy2 = p2[:, :2] / p2[:, 2:]
    j = {k: np.asarray(v) if not isinstance(v, tuple)
         else tuple(np.asarray(a) for a in v)
         for k, v in _jax_geometry(q, t, X, cam, obs, q1, t1, q2, t2,
                                   xy1, xy2).items()}
    close(t_proj.pose_matrix(T(q), T(t)), j["pose"], 1e-12)
    a = t_proj.project_points(T(q), T(t), T(X), 2, T(cam))
    close(a[0], j["proj"][0], 1e-9)
    close(a[1], j["proj"][1], 1e-12)
    a = t_proj.project_simple_pinhole(T(q), T(t), T(cam[:3]), T(X))
    close(a[0], j["pinhole"][0], 1e-9)
    ea = np_(t_proj.reprojection_error(T(q), T(t), T(X), T(obs), 2, T(cam)))
    eb = j["reproj"]
    assert (np.isinf(ea) == np.isinf(eb)).all()
    fin = np.isfinite(eb)
    assert np.abs(ea[fin] - eb[fin]).max() <= 1e-8 * max(1, eb[fin].max())
    close(t_proj.calculate_depth(T(q), T(t), T(X)), j["depth"], 1e-12)
    close(t_tri.triangulate_points_batch(T(q1), T(t1), T(q2), T(t2), T(xy1),
                                         T(xy2)), j["tri"], 1e-9)
    close(t_tri.triangulate_midpoint(T(q1), T(t1), T(q2), T(t2), T(xy1),
                                     T(xy2)), j["mid"], 1e-9)
    mask = np.ones((6, 2), bool)
    close(t_tri.triangulate_multiview(T(j["P"]), T(np.stack([xy1, xy2], 1)),
                                      T(mask)), j["multi"], 1e-9)
    close(t_tri.triangulation_angle(T(t1), T(j["c2"]), T(X)), j["angle"],
          1e-12)


@pytest.mark.parametrize("degree", [3, 10])
def test_polynomial_roots(degree):
    """Same iteration from the same starting points: the same roots in
    the same order."""
    c = np.random.default_rng(degree).standard_normal((40, degree + 1))
    iters = 80 if degree == 10 else 60
    x = np.linspace(-2, 2, 40)
    b, (rb, okb), vb = jax.jit(lambda c, x: (
        j_poly.roots(c, iters), j_poly.real_roots(c),
        j_poly.polyval(c, x)))(jnp.asarray(c), jnp.asarray(x))
    a = t_poly.roots(T(c), iters)
    close(a[0], b[0], 1e-10)
    close(a[1], b[1], 1e-10)
    ra, oka = t_poly.real_roots(T(c))
    close(ra, rb, 1e-10)
    close(t_poly.polyval(T(c), T(x)), vb, 1e-12)


# ---------------------------------------------------------------------------
# minimal solvers
# ---------------------------------------------------------------------------


def _unit(M):
    M = np.asarray(M, np.float64)
    return M / np.linalg.norm(M.reshape(M.shape[:-2] + (9,)),
                              axis=-1)[..., None, None]


def same_model_sets(Ma, va, Mb, vb, tol):
    """Per sample, every valid model of one has a twin (up to sign) among
    the valid models of the other, both ways."""
    Ma, Mb = _unit(Ma), _unit(Mb)
    va, vb = np.asarray(va, bool), np.asarray(vb, bool)
    worst = 0.0
    for i in range(Ma.shape[0]):
        a, b = Ma[i][va[i]], Mb[i][vb[i]]
        assert len(a) == len(b), (i, len(a), len(b))
        for x, ys in ((a, b), (b, a)):
            for m in x:
                worst = max(worst, min(min(np.abs(m - y).max(),
                                           np.abs(m + y).max())
                                       for y in ys))
    assert worst <= tol, worst


def set_distance(Ma, va, Mb, vb):
    """Worst distance of same_model_sets over the samples whose counts of
    valid models agree, and the share of such samples."""
    Ma, Mb = _unit(Ma), _unit(Mb)
    va, vb = np.asarray(va, bool), np.asarray(vb, bool)
    worst, same = 0.0, 0
    for i in range(Ma.shape[0]):
        a, b = Ma[i][va[i]], Mb[i][vb[i]]
        if len(a) != len(b):
            continue
        same += 1
        for m in a:
            worst = max(worst, min(min(np.abs(m - y).max(),
                                       np.abs(m + y).max()) for y in b))
    return worst, same / Ma.shape[0]


def check_five_point():
    """Nister's solver in both packages. sba_tpu's 80 Durand-Kerner
    iterations do not converge for every polynomial, and which ones
    depends on the null-space basis, so the sets are compared with
    sba_tpu's basis substituted; with its own basis every model the port
    returns must solve the epipolar constraints. Nister's elimination is
    ill-conditioned: the bound is the larger of 1e-8 and four times the
    change of sba_tpu's own solutions when its input moves by one ulp."""
    from collections import namedtuple

    from sba_tpu_torch.estimators import _linalg

    p1, p2 = _scene_pairs(24, 5, seed=8)
    Eb, vb = j_ess.essential_5pt(jnp.asarray(p1), jnp.asarray(p2))
    p1u = np.nextafter(p1, np.inf)
    Eu, vu = j_ess.essential_5pt(jnp.asarray(p1u), jnp.asarray(p2))
    self_spread, share = set_distance(Eu, vu, Eb, vb)
    assert share > 0.9
    tol = max(1e-8, 4 * self_spread)

    A = j_ess._epipolar_rows(jnp.asarray(p1), jnp.asarray(p2))
    Vt = np.asarray(jnp.linalg.svd(A, full_matrices=True)[2])
    Svd = namedtuple("Svd", "U S Vh")
    own_svd = _linalg.svd
    _linalg.svd = lambda a, full_matrices=False: Svd(None, None, T(Vt))
    try:
        Ea, va = t_ess.essential_5pt(T(p1), T(p2))
    finally:
        _linalg.svd = own_svd
    same_model_sets(np_(Ea), np_(va), Eb, vb, tol)
    print(f"5pt: sba_tpu self spread {self_spread:.3g}, bound {tol:.3g}")

    Ea, va = t_ess.essential_5pt(T(p1), T(p2))
    Ea, va = _unit(np_(Ea)), np_(va)
    assert va.sum() >= 24
    for i in range(24):
        h1 = np.concatenate([p1[i], np.ones((5, 1))], 1)
        h2 = np.concatenate([p2[i], np.ones((5, 1))], 1)
        for E in Ea[i][va[i]]:
            assert np.abs(np.einsum("mi,ij,mj->m", h2, E, h1)).max() < 1e-8
            # A root passes sba_tpu's real test at |imag| <= 1e-6 (1+|z|),
            # which is as far as 80 iterations may have converged it.
            assert np.abs(2 * E @ E.T @ E
                          - np.trace(E @ E.T) * E).max() < 1e-4


def _scene_pairs(n_samples, n_points, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n_samples, n_points, 3)) + [0, 0, 5]
    aa = rng.normal(0, 0.1, (n_samples, 3))
    R = np.stack([j_quat.np_quat_to_rotmat(j_quat.np_angle_axis_to_quat(a))
                  for a in aa])
    t = rng.normal(0, 0.5, (n_samples, 3))
    X2 = np.einsum("sij,snj->sni", R, X) + t[:, None]
    p1 = X[..., :2] / X[..., 2:] + rng.normal(0, noise, X[..., :2].shape)
    p2 = X2[..., :2] / X2[..., 2:]
    return p1, p2


@pytest.mark.parametrize("solver", ["7pt", "8pt", "5pt", "dlt", "e8pt"])
def test_minimal_solvers_as_sets(solver):
    p1, p2 = _scene_pairs(24, 8, seed=7, noise=1e-3)
    if solver == "7pt":
        Fa, va = t_fun.fundamental_7pt(T(p1[:, :7]), T(p2[:, :7]))
        Fb, vb = jax.jit(j_fun.fundamental_7pt)(jnp.asarray(p1[:, :7]),
                                                jnp.asarray(p2[:, :7]))
        same_model_sets(np_(Fa), np_(va), Fb, vb, 1e-8)
    elif solver == "5pt":
        check_five_point()
    else:
        fa, fb = {"8pt": (t_fun.fundamental_8pt, j_fun.fundamental_8pt),
                  "e8pt": (t_ess.essential_8pt, j_ess.essential_8pt),
                  "dlt": (t_hom.homography_dlt, j_hom.homography_dlt)}[solver]
        a = np_(fa(T(p1), T(p2)))[:, None]
        b = np.asarray(jax.jit(fb)(jnp.asarray(p1), jnp.asarray(p2)))[:, None]
        ones = np.ones(a.shape[:2], bool)
        same_model_sets(a, ones, b, ones, 1e-8)
    # Residuals of the same model agree (the scoring functions).
    F, H, rF, rH = _jax_residuals(jnp.asarray(p1), jnp.asarray(p2))
    F, H = np.asarray(F), np.asarray(H)
    close(t_fun.sampson_error_f(T(F), T(p1), T(p2)), rF, 1e-14)
    close(t_hom.homography_transfer_error(T(H), T(p1), T(p2)), rH, 1e-12)


@jax.jit
def _jax_residuals(p1, p2):
    F = j_fun.fundamental_8pt(p1, p2)
    H = j_hom.homography_dlt(p1, p2)
    return (F, H, j_fun.sampson_error_f(F, p1, p2),
            j_hom.homography_transfer_error(H, p1, p2))


def test_pose_from_essential_and_homography():
    p1, p2 = _scene_pairs(12, 40, seed=9, noise=1e-4)
    mask = np.ones(p1.shape[:2])
    mask[:, :3] = 0

    @jax.jit
    def jax_side(a, b, m):
        E = j_ess.essential_8pt(a, b)
        return E, j_ess.pose_from_essential(E, a, b, m), \
            j_ess.decompose_essential(E)

    E, (Rb, tb, nb), dec_b = jax_side(jnp.asarray(p1), jnp.asarray(p2),
                                      jnp.asarray(mask))
    E = np.asarray(E)
    Ra, ta, na = t_ess.pose_from_essential(T(E), T(p1), T(p2), T(mask))
    close(Ra, Rb, 1e-8)
    close(ta, tb, 1e-8)
    close(na, nb, 0)
    # The SVD's signs are the library's: {R1, R2} as a set, t up to sign.
    R1a, R2a, tda = map(np_, t_ess.decompose_essential(T(E)))
    R1b, R2b, tdb = map(np.asarray, dec_b)
    for i in range(len(E)):
        d = min(np.abs(R1a[i] - R1b[i]).max() + np.abs(R2a[i] - R2b[i]).max(),
                np.abs(R1a[i] - R2b[i]).max() + np.abs(R2a[i] - R1b[i]).max())
        assert d <= 1e-8
        assert min(np.abs(tda[i] - tdb[i]).max(),
                   np.abs(tda[i] + tdb[i]).max()) <= 1e-8
    # Homography of a plane, decomposed on the host (numpy in both).
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    R = j_quat.np_quat_to_rotmat(j_quat.np_angle_axis_to_quat(
        np.array([0.05, 0.1, 0.02])))
    t = np.array([0.4, 0.05, 0.1])
    n = np.array([0.0, 0.0, 1.0])
    H = K @ (R + np.outer(t, n) / 4.0) @ np.linalg.inv(K)
    rng = np.random.default_rng(2)
    X = np.concatenate([rng.uniform(-1, 1, (80, 2)), np.full((80, 1), 4.0)],
                       1)
    X2 = X @ R.T + t
    xy1 = X[:, :2] / X[:, 2:] * 500 + [320, 240]
    xy2 = X2[:, :2] / X2[:, 2:] * 500 + [320, 240]
    for a, b in zip(t_hom.decompose_homography(H, K, K),
                    j_hom.decompose_homography(H, K, K)):
        close(np.stack(a), np.stack(b), 1e-8)
    for a, b in zip(t_hom.pose_from_homography(H, K, K, xy1, xy2),
                    j_hom.pose_from_homography(H, K, K, xy1, xy2)):
        close(a, b, 1e-8)


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def test_planar_pose_of_card_homographies():
    """The PLANAR ring pairs of chip_smoke.py's frontend phase (24
    rendered 1600x1200 views of a heightfield; H, intrinsics and matches
    as the card's exhaustive_matcher stored them, written by the smoke to
    chiprun_out/frontend_planar.npz): sba_tpu's pose from each H against
    the scene's true relative rotation. On the pairs whose matches were
    kept, sba_tpu's `pose_from_homography` (H's inliers recomputed at
    max_error) gives the rotation the card stored, and the port's the
    same at 1e-8: the error of the PLANAR poses is sba_tpu's own."""
    d = np.load(ROOT / "tests" / "data" / "frontend_planar.npz")
    thr2 = j_tvg.TwoViewGeometryOptions().max_error ** 2
    best = []
    for k in range(len(d["H"])):
        H, K1, K2, Rt = d["H"][k], d["K1"][k], d["K2"][k], d["R_true"][k]
        Rs, _, _ = j_hom.decompose_homography(H, K1, K2)
        best.append(min(_rot_deg(np.asarray(R), Rt) for R in Rs))
        stored = j_quat.np_quat_to_rotmat(d["qvec"][k])
        assert abs(_rot_deg(stored, Rt) - d["rot_err_deg"][k]) <= 1e-6
        if f"xy1_{k}" not in d.files:
            continue
        xy1 = d[f"xy1_{k}"].astype(np.float64)
        xy2 = d[f"xy2_{k}"].astype(np.float64)
        mask = np.asarray(j_hom.homography_transfer_error(H, xy1, xy2)) \
            <= thr2
        pj = j_hom.pose_from_homography(H, K1, K2, xy1, xy2,
                                        inlier_mask=mask)
        pt = t_hom.pose_from_homography(H, K1, K2, xy1, xy2,
                                        inlier_mask=mask)
        close(pt[0], pj[0], 1e-8)
        close(pt[1], pj[1], 1e-8)
        err = _rot_deg(np.asarray(pj[0]), Rt)
        print(f"PLANAR pair {tuple(int(v) for v in d['pairs'][k])}: "
              f"{mask.sum()} of "
              f"{len(mask)} matches on H; sba_tpu's rotation error "
              f"{err:.4f} deg (the card's {d['rot_err_deg'][k]:.4f}), "
              f"the best of H's decompositions {best[-1]:.4f} deg")
        assert abs(err - d["rot_err_deg"][k]) <= 1e-6
    print(f"{len(best)} PLANAR pairs: card rotation errors "
          f"{np.round(d['rot_err_deg'], 4).tolist()} deg; the best of each "
          f"H's decompositions {np.round(best, 4).tolist()} deg")


# ---------------------------------------------------------------------------
# RANSAC with sba_tpu's draws
# ---------------------------------------------------------------------------


def make_pair(planar=False, n=120, noise=0.0, outlier_frac=0.0, seed=0):
    """As tests/test_two_view_geometry.py builds its pairs."""
    rng = np.random.default_rng(seed)
    f, cx, cy = 500.0, 320.0, 240.0
    if planar:
        pts = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.zeros((n, 1))],
                             axis=1)
        pts[:, 2] += 4.0
    else:
        pts = rng.uniform(-1, 1, (n, 3))
        pts[:, 2] = rng.uniform(3, 8, n)
    q = np.asarray(j_quat.angle_axis_to_quat(jnp.array([0.05, 0.1, 0.02])))
    t = np.array([0.4, 0.05, 0.1])
    p2 = np.asarray(j_quat.quat_rotate(jnp.asarray(q)[None],
                                       jnp.asarray(pts))) + t
    xy1 = pts[:, :2] / pts[:, 2:] * f + [cx, cy]
    xy2 = p2[:, :2] / p2[:, 2:] * f + [cx, cy]
    xy1 += rng.normal(0, noise, xy1.shape)
    xy2 += rng.normal(0, noise, xy2.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        xy2[:n_out] = rng.uniform(0, 640, (n_out, 2))
    return xy1, xy2, (f, f, cx, cy)


def panoramic_pair():
    rng = np.random.default_rng(3)
    f, cx, cy = 500.0, 320.0, 240.0
    pts = rng.uniform(-1, 1, (150, 3))
    pts[:, 2] = rng.uniform(3, 8, 150)
    q = np.asarray(j_quat.angle_axis_to_quat(jnp.array([0.03, 0.12, 0.01])))
    p2 = np.asarray(j_quat.quat_rotate(jnp.asarray(q)[None],
                                       jnp.asarray(pts)))
    xy1 = pts[:, :2] / pts[:, 2:] * f + [cx, cy]
    xy2 = p2[:, :2] / p2[:, 2:] * f + [cx, cy]
    keep = ((xy2[:, 0] > 0) & (xy2[:, 0] < 640)
            & (xy2[:, 1] > 0) & (xy2[:, 1] < 480))
    return xy1[keep], xy2[keep], (f, f, cx, cy)


def watermark_pair():
    rng = np.random.default_rng(1)
    xy1 = np.stack([rng.uniform(0, 640, 60), rng.uniform(465, 478, 60)], -1)
    return xy1, xy1 + [1.5, 0.0], (500.0, 500.0, 320.0, 240.0)


def degenerate_pair():
    rng = np.random.default_rng(2)
    return (rng.uniform(0, 640, (100, 2)), rng.uniform(0, 640, (100, 2)),
            (500.0, 500.0, 320.0, 240.0))


PAIRS = {
    "calibrated": lambda: make_pair(noise=0.2, outlier_frac=0.2),
    "planar": lambda: make_pair(planar=True, noise=0.1),
    "panoramic": panoramic_pair,
    "watermark": watermark_pair,
    "degenerate": degenerate_pair,
}
N_PAD = 160       # one bucket for every pair: one program per family
TRIALS = 256


def padded(name):
    xy1, xy2, K = PAIRS[name]()
    n = len(xy1)
    a = np.zeros((N_PAD, 2))
    b = np.zeros((N_PAD, 2))
    a[:n], b[:n] = xy1, xy2
    m = np.zeros(N_PAD, bool)
    m[:n] = True
    return a, b, m, K


def test_draw_samples():
    """The port's own draws: distinct valid indices per trial, and with
    `progressive` every trial inside its growing prefix (as sba_tpu's)."""
    m = np.arange(N_PAD) % 5 != 0
    g = torch.Generator().manual_seed(0)
    smp = t_ransac.draw_samples(N_PAD, 64, 7, mask=T(m), generator=g)
    assert smp.shape == (64, 7) and m[smp.numpy()].all()
    assert all(len(set(r)) == 7 for r in smp.tolist())
    for mod in (t_ransac, j_ransac):
        if mod is j_ransac:
            smp = np.asarray(mod.draw_samples(jax.random.PRNGKey(0), N_PAD,
                                              64, 7, progressive=True))
        else:
            smp = mod.draw_samples(N_PAD, 64, 7, progressive=True,
                                   generator=g).numpy()
        t = np.arange(64)[:, None]
        prefix = np.maximum(14, np.minimum(1.0, (t + 1) / (64 * 0.7))
                            * N_PAD).astype(int)
        assert (smp < prefix).all()


def _jax_single_draws(seed, n, mask, opt):
    kE, kF, kH = jax.random.split(jax.random.PRNGKey(seed), 3)
    ropt = j_ransac.RANSACOptions(max_num_trials=opt.max_num_trials)
    out = {}
    for kind, k, s in (("E", kE, 5), ("F", kF, 7), ("H", kH, 4)):
        T_ = j_ransac.num_required_trials(s, ropt)
        out[kind] = np.asarray(j_ransac.draw_samples(
            k, n, T_, s, mask=None if mask is None else jnp.asarray(mask)))
    return out


def same_result(a, b, tol=1e-6):
    assert a.config == b.config, (a.config, b.config)
    assert abs(a.num_inliers - b.num_inliers) <= 1, (a.num_inliers,
                                                     b.num_inliers)
    qa, qb = np.asarray(a.qvec), np.asarray(b.qvec)
    assert min(np.abs(qa - qb).max(), np.abs(qa + qb).max()) <= tol
    close(a.tvec, b.tvec, tol)


JOPT = j_tvg.TwoViewGeometryOptions(max_num_trials=TRIALS)
TOPT = t_tvg.TwoViewGeometryOptions(max_num_trials=TRIALS)
SINGLE = list(PAIRS) + ["uncalibrated"]
IMG_W, IMG_H = 160, 120       # the command tests' rendered views
# The correspondence cap of both packages in the batch test: the bucket
# of the command tests' pairs (about 40 matches a pair), so that sba_tpu
# compiles its float64 batch programs once for both.
BATCH_CAP = 64
BATCH_SEED = 3


def _single_inputs(name):
    xy1, xy2, m, K = padded("calibrated" if name == "uncalibrated"
                            else name)
    return xy1, xy2, m, None if name == "uncalibrated" else K


def _batch_inputs():
    """The five pairs and one of 600 matches, in one batch of 1024."""
    rows = [PAIRS[name]() for name in PAIRS]
    rows.append(make_pair(n=600, noise=0.3, outlier_frac=0.3, seed=4))
    Bp, Np = len(rows), 1024
    X1 = np.zeros((Bp, Np, 2))
    X2 = np.zeros((Bp, Np, 2))
    M = np.zeros((Bp, Np), bool)
    C = np.zeros((Bp, 4))
    for i, (a, b, K) in enumerate(rows):
        X1[i, :len(a)], X2[i, :len(a)] = a, b
        M[i, :len(a)] = True
        C[i] = K
    return X1, X2, M, C, [(640, 480)] * Bp


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """sba_tpu's results, computed once, in three threads (each compiles
    programs of its own; the two 5-point RANSACs and SIFT are most of
    these tests' time): `estimate_two_view_geometry` on each SINGLE pair,
    with its draws; `estimate_two_view_geometry_batch` on `_batch_inputs`
    at BATCH_CAP, on the host device as sba_tpu's matcher commands call
    it; sba_tpu's feature_extractor on the command tests' four rendered
    views ("work" / "j.db")."""
    from sba_tpu import cli as jcli
    from sba_tpu_torch.utils.render import render_scene, write_scene_images

    work = tmp_path_factory.mktemp("frontend")
    sc = render_scene(num_images=4, image_size=(IMG_W, IMG_H),
                      focal=1.2 * IMG_W, device="cpu", seed=3)
    write_scene_images(sc, str(work / "imgs"))
    out, errors = {"work": work}, []

    def single():
        for name in SINGLE:
            xy1, xy2, m, K = _single_inputs(name)
            out[name] = j_tvg.estimate_two_view_geometry(
                xy1, xy2, K, K, (640, 480), (640, 480), options=JOPT,
                seed=5, mask=m)
            out[name, "draws"] = _jax_single_draws(5, N_PAD, m, JOPT)

    def batch():
        X1, X2, M, C, sizes = _batch_inputs()
        with jax.enable_x64(True), jax.default_device(host_cpu_device()):
            out["batch"] = j_tvg.estimate_two_view_geometry_batch(
                X1, X2, M, C, C, sizes, sizes, options=JOPT,
                seed=BATCH_SEED)

    def extract():
        with jax.enable_x64(False):
            jcli.main(["feature_extractor", "--database_path",
                       str(work / "j.db")] + _extract_flags(work))

    def guard(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    cap = j_tvg._TVG_RANSAC_CAP
    j_tvg._TVG_RANSAC_CAP = BATCH_CAP      # read by the batch path only
    try:
        threads = [threading.Thread(target=guard, args=(fn,))
                   for fn in (single, batch, extract)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        j_tvg._TVG_RANSAC_CAP = cap
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("name", SINGLE)
def test_estimate_two_view_geometry_same_draws(name, jax_refs):
    """Each pair type, and the calibrated pair without intrinsics (F and
    H only)."""
    xy1, xy2, m, K = _single_inputs(name)
    rt = t_tvg.estimate_two_view_geometry(
        xy1, xy2, K, K, (640, 480), (640, 480), options=TOPT, seed=5,
        mask=m, samples=jax_refs[name, "draws"], device="cpu")
    same_result(rt, jax_refs[name])
    expect = {"calibrated": 2, "planar": 4, "panoramic": 5, "watermark": 7,
              "degenerate": (1, 3), "uncalibrated": (3, 6)}[name]
    assert rt.config in np.atleast_1d(expect)


def test_estimate_two_view_geometry_batch_same_draws(jax_refs,
                                                     monkeypatch):
    """All five pairs and one of 600 matches in one batch of 1024, past
    the correspondence cap (BATCH_CAP in both packages), so the cap's
    subsampling, the adaptive rounds and the full-set re-evaluation all
    run."""
    monkeypatch.setattr(t_tvg, "_TVG_RANSAC_CAP", BATCH_CAP)
    X1, X2, M, C, sizes = _batch_inputs()
    keys = jax.random.split(jax.random.PRNGKey(BATCH_SEED), len(M))
    ssz = {"F": 7, "H": 4, "E": 5}

    def draw_fn(kind, trials, pairs, masks_r):
        return np.stack([np.asarray(j_ransac.draw_samples(
            keys[p], masks_r.shape[1], trials, ssz[kind],
            mask=jnp.asarray(masks_r[p]))) for p in pairs])

    rj = jax_refs["batch"]
    rt = t_tvg.estimate_two_view_geometry_batch(
        X1, X2, M, C, C, sizes, sizes, options=TOPT, seed=BATCH_SEED,
        device="cpu", draw_fn=draw_fn)
    for a, b in zip(rt, rj):
        same_result(a, b)
        assert a.inlier_mask.shape == (M.shape[1],)
    # The port's own draws: a run that completes with valid results.
    own = t_tvg.estimate_two_view_geometry_batch(
        X1[:2], X2[:2], M[:2], C[:2], C[:2], sizes[:2], sizes[:2],
        options=TOPT, seed=BATCH_SEED, device="cpu")
    assert [r.config for r in own] == [rj[0].config, rj[1].config]


@pytest.mark.parametrize("kind,scoring", [("F", "msac"), ("H", "msac"),
                                          ("H", "inlier_count")])
def test_ransac_impl_same_draws(kind, scoring):
    """sba_tpu's `_ransac_impl` and the port's on the same samples: the
    same winner's inlier mask and count, and the same best score (at
    1e-9 of it, or four times the change of sba_tpu's own best score when
    its input moves by one ulp, if that is larger: the 7-point models
    come from another null-space basis). E runs through the same
    function in the two-view tests below."""
    xy1, xy2, m, K = padded("calibrated")
    ssz = {"F": 7, "H": 4}[kind]
    key = jax.random.PRNGKey(11)
    smp = np.asarray(j_ransac.draw_samples(key, N_PAD, TRIALS, ssz,
                                           mask=jnp.asarray(m)))
    opt = j_ransac.RANSACOptions(max_num_trials=TRIALS, scoring=scoring)
    topt = t_ransac.RANSACOptions(max_num_trials=TRIALS, scoring=scoring)
    assert j_ransac.num_required_trials(ssz, opt) == TRIALS
    jfns = {"F": (j_fun.fundamental_7pt, j_fun.sampson_error_f,
                  j_tvg._weighted_f_refit),
            "H": (j_tvg._h_solve, j_hom.homography_transfer_error,
                  None)}[kind]
    tfns = {"F": (t_fun.fundamental_7pt, t_fun.sampson_error_f,
                  t_tvg._weighted_f_refit),
            "H": (t_tvg._h_solve, t_hom.homography_transfer_error,
                  None)}[kind]

    def run(k, a, b, mm):
        """sba_tpu's `ransac`: `_ransac_impl` as the one jitted program
        estimate_two_view_geometry compiles for these options."""
        return j_ransac.ransac(k, (a, b), jfns[0], jfns[1], ssz, opt,
                               mask=mm, refit_fn=jfns[2])
    rj = run(key, jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(m))
    rt = t_ransac._ransac_impl(
        (T(xy1)[None], T(xy2)[None]), tfns[0], tfns[1], ssz, topt,
        T(m)[None], tfns[2], T(smp)[None])
    assert (np_(rt.inlier_mask[0]) == np.asarray(rj.inlier_mask)).all()
    assert int(rt.num_inliers[0]) == int(rj.num_inliers)
    sa = np_(rt.support_trace[0])
    sb = np.asarray(rj.support_trace)
    ru = run(key, jnp.asarray(np.nextafter(xy1, np.inf)), jnp.asarray(xy2),
             jnp.asarray(m))
    spread = abs(float(np.max(np.asarray(ru.support_trace))) - sb.max())
    tol = max(1e-9 * max(1.0, abs(sb.max())), 4 * spread)
    assert abs(sa.max() - sb.max()) <= tol, (sa.max(), sb.max(), tol)


def test_two_view_unported_and_rounds():
    """`estimate_two_view_geometry_multiple` computes (it used to raise
    NotImplementedError): too few correspondences give no model. The
    trial rounds and counts of both packages agree."""
    assert t_tvg.estimate_two_view_geometry_multiple(
        np.zeros((10, 2)), np.zeros((10, 2)), device="cpu") == []
    assert t_tvg.trial_rounds(4096) == [256, 1024, 4096]
    assert t_tvg.trial_rounds(256) == [256]
    for s in (4, 5, 7):
        assert t_ransac.num_required_trials(s, t_ransac.RANSACOptions()) \
            == j_ransac.num_required_trials(s, j_ransac.RANSACOptions())


def two_motion_pair(n_per=60):
    """tests/test_two_view_geometry.py:192's pair: correspondences of two
    rigid motions, 0.2 px noise."""
    rng = np.random.default_rng(3)
    f, cx, cy = 400.0, 320.0, 240.0

    def motion(R, t, seed):
        r2 = np.random.default_rng(seed)
        pts = np.stack([r2.uniform(-2, 2, n_per), r2.uniform(-1.5, 1.5, n_per),
                        r2.uniform(4, 8, n_per)], 1)
        p2 = pts @ R.T + t
        return (f * pts[:, :2] / pts[:, 2:] + [cx, cy],
                f * p2[:, :2] / p2[:, 2:] + [cx, cy])

    def rotz(a):
        c, s_ = np.cos(a), np.sin(a)
        return np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1.0]])

    a1, a2 = motion(rotz(0.05), np.array([0.8, 0.0, 0.1]), 1)
    b1, b2 = motion(rotz(-0.25), np.array([-0.3, 0.9, -0.4]), 2)
    xy1 = np.concatenate([a1, b1]) + rng.normal(0, 0.2, (2 * n_per, 2))
    xy2 = np.concatenate([a2, b2]) + rng.normal(0, 0.2, (2 * n_per, 2))
    return xy1, xy2, (f, f, cx, cy)


def test_estimate_two_view_geometry_multiple_same_draws():
    """The recursive multi-model estimate with sba_tpu's draws in every
    round: the same models (same_result's 1e-6), the same disjoint inlier
    sets but one correspondence, every config MULTIPLE."""
    xy1, xy2, K = two_motion_pair()
    jopt = j_tvg.TwoViewGeometryOptions(max_num_trials=TRIALS,
                                        detect_watermark=False)
    topt = t_tvg.TwoViewGeometryOptions(max_num_trials=TRIALS,
                                        detect_watermark=False)
    rj = j_tvg.estimate_two_view_geometry_multiple(
        xy1, xy2, K, K, (640, 480), (640, 480), options=jopt, seed=2)
    rt = t_tvg.estimate_two_view_geometry_multiple(
        xy1, xy2, K, K, (640, 480), (640, 480), options=topt, seed=2,
        draw_fn=lambda sd, n, m: _jax_single_draws(sd, n, m, jopt),
        device="cpu")
    assert len(rt) == len(rj) >= 2
    for a, b in zip(rt, rj):
        same_result(a, b)
        assert a.config == int(t_tvg.TwoViewConfig.MULTIPLE)
        assert (a.inlier_mask != b.inlier_mask).sum() <= 1
    assert not (rt[0].inlier_mask & rt[1].inlier_mask).any()


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------


def _descriptor_sets(n1, n2, seed):
    """u8 descriptors, half of set 2 noisy copies of set 1."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 60, (n1, 128)).astype(np.uint8)
    d2 = rng.integers(0, 60, (n2, 128)).astype(np.uint8)
    k = min(n1, n2) // 2
    d2[:k] = np.clip(d1[:k].astype(int)
                     + rng.integers(-6, 7, (k, 128)), 0, 255)
    return d1, d2


def _norm(d):
    d = d.astype(np.float32)
    return d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-12)


@jax.jit
def _jax_distances(d1, d2):
    return j_match._acos_distance(j_match._similarity(d1, d2))


def _near_tie_rows(d1, d2, m1, m2, opt, eps=1e-6):
    """Rows whose decision sits within eps of a tie or a threshold, in
    either direction of the cross check, from sba_tpu's float32
    distances."""
    with jax.enable_x64(False):
        dist = np.asarray(_jax_distances(jnp.asarray(d1), jnp.asarray(d2)))

    def ties(d, valid_cols):
        d = np.where(valid_cols[None, :], d, np.inf)
        s = np.sort(d, axis=1)
        best, second = s[:, 0], s[:, 1]
        return np.argmin(d, axis=1), (
            (np.abs(best - opt.max_distance) < eps)
            | (np.abs(best - opt.max_ratio * second) < eps)
            | (np.abs(second - best) < eps))

    best12, tie12 = ties(dist, m2)
    _, tie21 = ties(dist.T, m1)
    return tie12 | tie21[best12]


def test_match_descriptors():
    d1, d2 = _descriptor_sets(300, 260, seed=3)
    f1, f2 = _norm(d1), _norm(d2)
    m1 = np.ones(300, bool)
    m2 = np.arange(260) < 240
    opt = j_match.SiftMatchingOptions()
    with jax.enable_x64(False):
        rj = jax.jit(j_match.match_descriptors, static_argnums=4)(
            jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(m1),
            jnp.asarray(m2), opt)
    rt = t_match.match_descriptors(T(f1), T(f2), T(m1), T(m2),
                                   t_match.SiftMatchingOptions())
    tie = _near_tie_rows(f1, f2, m1, m2, opt)
    a, b = np_(rt.matches12), np.asarray(rj.matches12)
    assert (a == b)[~tie].all() and (a >= 0).sum() > 50
    fin = np.isfinite(np.asarray(rj.distances)) & ~tie
    # arccos near 0.1 rad turns a float32 rounding of the product into
    # ~1e-6 of distance.
    close(np_(rt.distances)[fin], np.asarray(rj.distances)[fin], 1e-5)
    close(t_match.matches_to_pairs(rt), j_match.matches_to_pairs(rj), 0)


def test_match_guided():
    rng = np.random.default_rng(5)
    d1, d2 = _descriptor_sets(120, 120, seed=6)
    f1, f2 = _norm(d1), _norm(d2)
    xy1 = rng.uniform(0, 640, (120, 2)).astype(np.float32)
    xy2 = (xy1 + [5.0, 0.0]).astype(np.float32)
    F = np.array([[0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]], np.float32)
    with jax.enable_x64(False):
        rj = jax.jit(j_match.match_guided)(
            jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(xy1),
            jnp.asarray(xy2), jnp.asarray(F))
    rt = t_match.match_guided(T(f1), T(f2), T(xy1), T(xy2), T(F))
    assert (np_(rt.matches12) == np.asarray(rj.matches12)).all()


def test_match_pairs_batched():
    rng = np.random.default_rng(8)
    I, N = 4, 256
    stack = np.zeros((I, N, 128), np.uint8)
    nvalid = np.array([256, 200, 231, 180], np.int32)
    base = rng.integers(0, 60, (N, 128))
    for i in range(I):
        noisy = np.clip(base + rng.integers(-8, 9, (N, 128)), 0, 255)
        own = rng.integers(0, 60, (N, 128))
        keep = rng.random(N) < 0.6
        d = np.where(keep[:, None], noisy, own)
        stack[i, :nvalid[i]] = d[:nvalid[i]]
    pairs = np.array([[0, 1], [0, 2], [1, 3], [2, 3], [0, 3]], np.int32)
    # Padded to the matcher commands' batch of 32 pairs and placed on the
    # host device, as sba_tpu's commands call it (the command tests below
    # share this program).
    pidx = np.concatenate([pairs, np.repeat(pairs[-1:], 32 - len(pairs), 0)])
    opt = j_match.SiftMatchingOptions()
    dev = host_cpu_device()
    with jax.enable_x64(False):
        mj, nj = j_match.match_pairs_batched(
            jax.device_put(stack, dev),
            jax.device_put(jnp.asarray(nvalid), dev),
            jax.device_put(pidx, dev), opt)
    mt, nt = t_match.match_pairs_batched(T(stack), T(nvalid), pidx,
                                         t_match.SiftMatchingOptions())
    mj = np.asarray(mj)
    mt = np_(mt)
    assert (mt[len(pairs):] == mt[len(pairs) - 1]).all()
    for k, (a, b) in enumerate(pairs):
        f1, f2 = _norm(stack[a]), _norm(stack[b])
        tie = _near_tie_rows(f1, f2, np.arange(N) < nvalid[a],
                             np.arange(N) < nvalid[b], opt)
        assert (mt[k] == mj[k])[~tie].all()
        assert (mt[k] >= 0).sum() > 20
    assert np.abs(np_(nt) - np.asarray(nj)).max() <= \
        max(1, int(0.001 * N))


# ---------------------------------------------------------------------------
# pair schedules and the image reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(7, 50), (23, 5), (1, 50)])
def test_exhaustive_and_sequential_pairs(n, block):
    close(t_pair.exhaustive_pairs(n, block), j_pair.exhaustive_pairs(n, block),
          0)
    for overlap, quad in ((10, True), (3, False), (2, True)):
        close(t_pair.sequential_pairs(n, overlap, quad),
              j_pair.sequential_pairs(n, overlap, quad), 0)


def test_spatial_transitive_and_file_pairs(tmp_path):
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, 50, (30, 3))
    valid = rng.random(30) > 0.2
    for k, d in ((5, 100.0), (50, 20.0)):
        close(t_pair.spatial_pairs(pos, k, d, valid),
              j_pair.spatial_pairs(pos, k, d, valid), 0)
    ex = j_pair.spatial_pairs(pos, 3, 100.0)
    for bs in (1000, 7):
        close(t_pair.transitive_pairs(ex, 30, bs),
              j_pair.transitive_pairs(ex, 30, bs), 0)
    p = tmp_path / "pairs.txt"
    p.write_text("# pairs\na.jpg b.jpg\nc.jpg a.jpg\n\nb.jpg b.jpg\n")
    names = {"a.jpg": 0, "b.jpg": 1, "c.jpg": 2}
    close(t_pair.pairs_from_file(str(p), names),
          j_pair.pairs_from_file(str(p), names), 0)


@pytest.mark.parametrize("model", ["SIMPLE_RADIAL", "PINHOLE", "OPENCV",
                                   "FOV"])
def test_camera_params_for_image(tmp_path, model):
    """A JPEG with an EXIF 35 mm focal, one with a focal and a known make,
    and one without EXIF: the same model, parameters and prior flag."""
    from PIL import Image

    from sba_tpu.io import image_reader as j_ir
    from sba_tpu_torch.io import image_reader as t_ir

    img = Image.new("L", (160, 120), 128)
    plain = tmp_path / "plain.jpg"
    img.save(plain)
    f35 = tmp_path / "f35.jpg"
    ex = Image.Exif()
    ex[0xA405] = 50                      # FocalLengthIn35mmFilm
    img.save(f35, exif=ex)
    fmm = tmp_path / "fmm.jpg"
    ex = Image.Exif()
    ex[0x010F] = "Canon"                 # Make
    ex[0x920A] = 24.0                    # FocalLength
    img.save(fmm, exif=ex)
    for path, prior in ((plain, False), (f35, True), (fmm, True)):
        a = t_ir.camera_params_for_image(str(path), 160, 120,
                                         t_ir.ImageReaderOptions(model))
        b = j_ir.camera_params_for_image(str(path), 160, 120,
                                         j_ir.ImageReaderOptions(model))
        assert a[0] == b[0] and a[2] == b[2] == prior
        close(np.asarray(a[1], float), np.asarray(b[1], float), 0)
        assert t_ir.focal_length_from_exif(str(path), 160, 120) == \
            j_ir.focal_length_from_exif(str(path), 160, 120)


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------

MATCH_FLAGS = ["--TwoViewGeometry.max_num_trials", str(TRIALS)]


def _extract_flags(work):
    return ["--image_path", str(work / "imgs"),
            "--SiftExtraction.max_num_features", "256"]


@pytest.fixture(scope="module")
def frontend_dbs(jax_refs):
    """The port's feature_extractor on the four rendered views of
    `jax_refs` (where sba_tpu's ran), then both packages' matchers on
    copies of sba_tpu's database (the port's with sba_tpu's draws). Both
    verify in float64, the precision of the batch test, whose sba_tpu
    programs (cap and bucket 64) these pairs share; extraction and
    matching run in float32, as the commands run them."""
    from sba_tpu import cli as jcli
    from sba_tpu_torch import cli as tcli

    work = jax_refs["work"]
    tcli.main(["feature_extractor", "--database_path", str(work / "t.db"),
               "--device", "cpu"] + _extract_flags(work))

    ssz = {"F": 7, "H": 4, "E": 5}
    own_batch = t_tvg.estimate_two_view_geometry_batch

    def with_jax_draws(*a, seed=0, **kw):
        keys = jax.random.split(jax.random.PRNGKey(seed), len(a[2]))

        def draw_fn(kind, trials, pairs, masks_r):
            return np.stack([np.asarray(j_ransac.draw_samples(
                keys[p], masks_r.shape[1], trials, ssz[kind],
                mask=jnp.asarray(masks_r[p]))) for p in pairs])
        return own_batch(*a, seed=seed, draw_fn=draw_fn,
                         **dict(kw, dtype=torch.float64))

    j_batch = j_tvg.estimate_two_view_geometry_batch

    def j_f64(*a, **kw):
        with jax.enable_x64(True):
            return j_batch(*a, **dict(kw, dtype=jnp.float64))

    t_tvg.estimate_two_view_geometry_batch = with_jax_draws
    j_tvg.estimate_two_view_geometry_batch = j_f64
    try:
        for cmd in ("exhaustive_matcher", "sequential_matcher"):
            for pkg in ("j", "t"):
                db = work / f"{cmd}_{pkg}.db"
                shutil.copy(work / "j.db", db)
                args = [cmd, "--database_path", str(db)] + MATCH_FLAGS
                if pkg == "j":
                    with jax.enable_x64(False):
                        jcli.main(args)
                else:
                    tcli.main(args + ["--SiftMatching.use_gpu", "0"])
    finally:
        t_tvg.estimate_two_view_geometry_batch = own_batch
        j_tvg.estimate_two_view_geometry_batch = j_batch
    return work


def _db(path):
    from sba_tpu_torch.io.database import Database

    return Database(str(path))


def test_feature_extractor_matches_sba_tpu(frontend_dbs):
    a, b = _db(frontend_dbs / "t.db"), _db(frontend_dbs / "j.db")
    ca, cb = a.read_cameras(), b.read_cameras()
    assert ca.keys() == cb.keys()
    for k in ca:
        assert ca[k]["model_id"] == cb[k]["model_id"] == 2
        assert (ca[k]["width"], ca[k]["height"]) == (IMG_W, IMG_H)
        np.testing.assert_array_equal(ca[k]["params"], cb[k]["params"])
        assert ca[k]["prior_focal_length"] == cb[k]["prior_focal_length"]
    ia, ib = a.read_images(), b.read_images()
    assert {k: v["name"] for k, v in ia.items()} == \
        {k: v["name"] for k, v in ib.items()}
    rows = []
    for iid in ia:
        ka, kb = a.read_keypoints(iid), b.read_keypoints(iid)
        assert ka.shape == kb.shape and len(ka) > 40
        d = np.abs(ka - kb)
        d[:, 3] = np.minimum(d[:, 3], 2 * np.pi - d[:, 3])
        rows.append(d.max(axis=1))
        da = a.read_descriptors(iid).astype(int)
        db = b.read_descriptors(iid).astype(int)
        assert (np.abs(da - db) <= 1).mean() >= 0.99
    rows = np.concatenate(rows)
    print(f"feature_extractor: {(rows <= 1e-3).mean():.4f} of "
          f"{len(rows)} rows within 1e-3 (worst {rows.max():.2e})")
    assert (rows <= 1e-3).mean() >= 0.98 and rows.max() <= 5e-3


@pytest.mark.parametrize("cmd", ["exhaustive_matcher", "sequential_matcher"])
def test_matchers_match_sba_tpu(frontend_dbs, cmd):
    a = _db(frontend_dbs / f"{cmd}_t.db")
    b = _db(frontend_dbs / f"{cmd}_j.db")
    ma, mb = a.read_all_matches(), b.read_all_matches()
    assert ma.keys() == mb.keys() and len(ma) == 6
    for k in ma:
        np.testing.assert_array_equal(ma[k], mb[k])
    ga, gb = a.read_all_two_view_geometries(), b.read_all_two_view_geometries()
    assert ga.keys() == gb.keys()
    for k in ga:
        assert ga[k]["config"] == gb[k]["config"]
        assert abs(len(ga[k]["inlier_matches"])
                   - len(gb[k]["inlier_matches"])) <= 1


def test_commands_need_a_card_unless_asked_for_the_cpu(tmp_path):
    """No card here: every front-end command fails unless --device cpu or
    use_gpu 0 asks for the CPU (one of them as its own process, for the
    exit code)."""
    from PIL import Image

    from sba_tpu_torch import cli as tcli

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for k in range(2):
        Image.fromarray((np.random.default_rng(k).random((64, 64)) * 255)
                        .astype(np.uint8)).save(imgs / f"{k}.png")
    db = str(tmp_path / "db.db")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "sba_tpu_torch.cli", "feature_extractor",
         "--database_path", db, "--image_path", str(imgs)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path, env=env)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr + res.stdout
    for cmd in ("exhaustive_matcher", "sequential_matcher"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.main([cmd, "--database_path", db])
    tcli.main(["feature_extractor", "--database_path", db, "--image_path",
               str(imgs), "--SiftExtraction.use_gpu", "0",
               "--SiftExtraction.max_num_features", "64"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["sequential_matcher", "--database_path", db,
                   "--SequentialMatching.loop_detection", "1"])
    tcli.main(["sequential_matcher", "--database_path", db, "--device",
               "cpu", "--SequentialMatching.loop_detection", "1"])
