"""The port's incremental-mapper modules against sba_tpu's, in float64
on the CPU with the same numpy inputs (and sba_tpu's draws where a
RANSAC runs): similarity, P3P / EPnP, absolute and relative pose,
`pad_problem_pow2`, the reconstruction edits and filters, the database
cache, the visibility pyramid, and the triangulator and the mapper's
steps from one registered state (tracks equal, points at 1e-9). The
port's batched camera-model calls and its vectorized graph scans are
held against the per-call form here too. The whole mapper and the
commands: tests/test_torch_sfm.py."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_tpu.estimators import absolute_pose as j_abs
from sba_tpu.estimators import pose as j_pose
from sba_tpu.geometry import similarity as j_sim
from sba_tpu.io import database as j_db
from sba_tpu.io import database_cache as j_cache
from sba_tpu.models.reconstruction import Reconstruction as JRec
from sba_tpu.optim import ba as j_ba
from sba_tpu.optim import ransac as j_ransac
from sba_tpu.sfm import incremental_mapper as j_map
from sba_tpu.sfm import visibility_pyramid as j_vis
from sba_tpu.utils.synthetic import make_synthetic_reconstruction
from sba_tpu_torch.estimators import absolute_pose as t_abs
from sba_tpu_torch.estimators import pose as t_pose
from sba_tpu_torch.geometry import similarity as t_sim
from sba_tpu_torch.io import database as t_db
from sba_tpu_torch.io import database_cache as t_cache
from sba_tpu_torch.models.reconstruction import Reconstruction as TRec
from sba_tpu_torch.optim import ba as t_ba
from sba_tpu_torch.optim import ransac as t_ransac
from sba_tpu_torch.sfm import incremental_mapper as t_map
from sba_tpu_torch.sfm import incremental_triangulator as t_tri
from sba_tpu_torch.sfm import visibility_pyramid as t_vis

torch.set_num_threads(2)

T = torch.as_tensor
J = jnp.asarray


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def sba_draws(kind, seed, n, trials, sample_size, mask):
    """sba_tpu's draws for one RANSAC of its mapper: the seed's key (split
    in three, E, F, H, for the initial pair's two-view geometry)."""
    key = jax.random.PRNGKey(seed)
    if kind != "P3P":
        key = dict(zip("EFH", jax.random.split(key, 3)))[kind]
    return np.asarray(j_ransac.draw_samples(key, n, trials, sample_size,
                                            mask=J(mask)))


# ---------------------------------------------------------------------------
# similarity, P3P, EPnP, absolute and relative pose
# ---------------------------------------------------------------------------

def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("with_scale,weighted", [(True, False),
                                                 (False, False),
                                                 (True, True)])
def test_umeyama_matches_sba_tpu(with_scale, weighted):
    rng = np.random.default_rng(1)
    src = rng.normal(size=(6, 30, 3))
    dst = 1.7 * src @ _rot(rng).T + rng.normal(size=3) \
        + 0.01 * rng.normal(size=src.shape)
    w = rng.uniform(0.1, 1.0, size=(6, 30)) if weighted else None
    ref = j_sim.umeyama(J(src), J(dst), None if w is None else J(w),
                        with_scale=with_scale)
    got = t_sim.umeyama(T(src), T(dst), None if w is None else T(w),
                        with_scale=with_scale)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np_(b), np_(a), rtol=0, atol=1e-10)
    q_ref, R_ref, t_ref = j_sim.rigid_from_points(J(src), J(dst))
    q, R, t = t_sim.rigid_from_points(T(src), T(dst))
    for a, b in ((q_ref, q), (R_ref, R), (t_ref, t)):
        np.testing.assert_allclose(np_(b), np_(a), rtol=0, atol=1e-10)
    s, R, t = got
    np.testing.assert_allclose(
        np_(t_sim.apply_similarity(s, R, t, T(src))),
        np_(j_sim.apply_similarity(*ref, J(src))), rtol=0, atol=1e-10)


def _pnp_scene(seed, n=100, noise=0.0):
    rng = np.random.default_rng(seed)
    R = _rot(rng)
    t = np.array([0.1, -0.2, 5.0])
    X = rng.uniform(-1, 1, (n, 3))
    pc = X @ R.T + t
    xy = pc[:, :2] / pc[:, 2:] + noise * rng.normal(size=(n, 2))
    return rng, X, xy


def test_p3p_solutions_match_sba_tpu():
    """Every valid solution of a sample is one of sba_tpu's at 1e-8,
    over well-separated roots (a double root moves by the square root of
    the rounding: such samples are counted, and held at 1e-3)."""
    rng, X, xy = _pnp_scene(2)
    idx = rng.integers(0, len(X), (200, 3))
    idx = idx[(idx[:, 0] != idx[:, 1]) & (idx[:, 1] != idx[:, 2])
              & (idx[:, 0] != idx[:, 2])]
    qj, tj, vj = (np_(a) for a in j_abs.p3p_solve(J(X[idx]), J(xy[idx])))
    qt, tt, vt = (np_(a) for a in t_abs.p3p_solve(T(X[idx]), T(xy[idx])))
    assert (vj == vt).all()
    close = 0
    for s in range(len(idx)):
        pj = np.concatenate([qj[s], tj[s]], -1)[vj[s]]
        pt = np.concatenate([qt[s], tt[s]], -1)[vt[s]]
        d = np.abs(pj[:, None] - pt[None]).max(-1).min(1)
        sep = np.abs(tj[s][vj[s]][:, None] - tj[s][vj[s]][None]).max(-1)
        sep = (sep + np.eye(len(sep)) * 1e9).min() if len(sep) > 1 else 1e9
        tol = 1e-8 if sep > 1e-2 else 1e-3
        close += sep <= 1e-2
        assert d.max(initial=0.0) <= tol, (s, d, sep)
    assert close <= 0.05 * len(idx)


@pytest.mark.parametrize("n", [8, 20, 60])
def test_epnp_matches_sba_tpu(n, monkeypatch):
    """EPnP with sba_tpu's control points substituted: the covariance's
    eigenvectors from LAPACK and from XLA may differ in sign, and with
    noise the least-squares pose depends on the control points (at 20
    points by ~1e-4). With its own basis the port's pose is held against
    the truth. (The mapper refines the refit's pose, which washes the
    difference out.)"""
    _rng, X, xy = _pnp_scene(3, n=n, noise=1e-3)
    qj, tj, vj = j_abs.epnp_solve(J(X), J(xy))
    own = t_abs.epnp_solve(T(X), T(xy))
    c = X - X.mean(0, keepdims=True)
    w, V = jnp.linalg.eigh(J(c.T @ c / n))
    monkeypatch.setattr(t_abs._linalg, "eigh",
                        lambda a: (T(np.array(w)), T(np.array(V))))
    qt, tt, vt = t_abs.epnp_solve(T(X), T(xy))
    assert bool(vj) == bool(vt)
    np.testing.assert_allclose(np_(qt), np_(qj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(np_(tt), np_(tj), rtol=0, atol=1e-8)
    from sba_tpu_torch.geometry.quaternions import np_quat_rotate
    pc = np_quat_rotate(np_(own[0]), X) + np_(own[1])
    assert np.abs(pc[:, :2] / pc[:, 2:] - xy).max() < 1e-2


def _abs_pose_data(degenerate):
    """128 rows (100 real, the bucket's 28 masked), 10 outliers; the
    degenerate case repeats one correspondence 12 times, so that many of
    the 438 P3P samples hold a repeated point (zero side lengths)."""
    _rng, X, xy = _pnp_scene(4, noise=1e-3)
    xy = xy.copy()
    xy[5:15] += 0.3
    if degenerate:
        X[20:32] = X[20]
        xy[20:32] = xy[20]
    X3 = np.concatenate([X, np.zeros((28, 3))])
    x2 = np.concatenate([xy, np.zeros((28, 2))])
    mask = np.concatenate([np.ones(100), np.zeros(28)])
    return X3, x2, mask


@pytest.mark.parametrize("degenerate", [False, True])
def test_absolute_pose_ransac_matches_sba_tpu(degenerate):
    X3, x2, mask = _abs_pose_data(degenerate)
    seed = 3
    jopt = j_pose.AbsolutePoseOptions(ransac=j_ransac.RANSACOptions(
        max_error=0.01, min_inlier_ratio=0.25))
    topt = t_pose.AbsolutePoseOptions(ransac=t_ransac.RANSACOptions(
        max_error=0.01, min_inlier_ratio=0.25))
    ref = j_pose.estimate_absolute_pose(jax.random.PRNGKey(seed), J(X3),
                                        J(x2), options=jopt, mask=J(mask))
    trials = t_ransac.num_required_trials(3, topt.ransac)
    smp = sba_draws("P3P", seed, len(mask), trials, 3, mask)
    if degenerate:
        rep = np.isin(smp, np.arange(20, 32)).sum(1) >= 2
        assert rep.sum() >= 3, "no sample with a repeated point"
    got = t_pose.estimate_absolute_pose(T(X3), T(x2), options=topt,
                                        mask=T(mask), samples=smp)
    assert int(got.num_inliers) == int(ref.num_inliers) >= 85
    np.testing.assert_array_equal(np_(got.inlier_mask),
                                  np_(ref.inlier_mask))
    np.testing.assert_allclose(np_(got.qvec), np_(ref.model[0]), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(np_(got.tvec), np_(ref.model[1]), rtol=0,
                               atol=1e-8)
    # Draws from a generator on the data's device: a valid pose too.
    own = t_pose.estimate_absolute_pose(
        T(X3), T(x2), options=topt, mask=T(mask),
        generator=torch.Generator().manual_seed(0))
    assert int(own.num_inliers) >= 85


def test_refine_absolute_pose_matches_sba_tpu():
    X3, x2, mask = _abs_pose_data(False)
    rng = np.random.default_rng(5)
    q0 = np.array([0.99, 0.05, -0.03, 0.02])
    q0 /= np.linalg.norm(q0)
    t0 = np.array([0.12, -0.18, 5.1])
    w = mask.copy()
    w[5:15] = 0.0
    w[rng.integers(0, 100, 3)] = 0.0
    qa, ta, sa = j_pose.refine_absolute_pose(J(q0), J(t0), J(X3), J(x2),
                                             weights=J(w))
    qb, tb, sb = t_pose.refine_absolute_pose(T(q0), T(t0), T(X3), T(x2),
                                             weights=T(w))
    np.testing.assert_allclose(np_(qb), np_(qa), rtol=0, atol=1e-8)
    np.testing.assert_allclose(np_(tb), np_(ta), rtol=0, atol=1e-8)
    assert int(sb.num_iterations) == int(sa.num_iterations)
    np.testing.assert_allclose(float(sb.final_cost), float(sa.final_cost),
                               rtol=1e-9)


def test_relative_pose_matches_sba_tpu():
    rng = np.random.default_rng(6)
    aa = np.array([0.05, -0.1, 0.02])
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(aa).as_matrix()
    t = np.array([1.0, 0.1, 0.05])
    X = rng.uniform(-1, 1, (120, 3)) + [0, 0, 5]
    x1 = X[:, :2] / X[:, 2:]
    pc = X @ R.T + t
    x2 = pc[:, :2] / pc[:, 2:] + 1e-4 * rng.normal(size=(120, 2))
    x2[:12] += 0.05
    mask = np.concatenate([np.ones(100), np.zeros(20)])
    key = jax.random.PRNGKey(7)
    Rj, tj, Ej, repj = j_pose.estimate_relative_pose(key, J(x1), J(x2),
                                                     mask=J(mask))
    opt = t_pose.RelativePoseOptions()
    trials = t_ransac.num_required_trials(5, opt.ransac)
    smp = np.asarray(j_ransac.draw_samples(key, 120, trials, 5,
                                           mask=J(mask)))
    Rt, tt, Et, rept = t_pose.estimate_relative_pose(T(x1), T(x2),
                                                     mask=T(mask),
                                                     samples=smp)
    np.testing.assert_array_equal(np_(rept.inlier_mask),
                                  np_(repj.inlier_mask))
    np.testing.assert_allclose(np_(Rt), np_(Rj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(np_(tt), np_(tj), rtol=0, atol=1e-8)
    # E up to its sign (the null vector's sign is the solver's).
    s = np.sign(np.sum(np_(Et) * np_(Ej)))
    np.testing.assert_allclose(s * np_(Et), np_(Ej), rtol=0, atol=1e-8)


# ---------------------------------------------------------------------------
# pad_problem_pow2
# ---------------------------------------------------------------------------

def _ba_problems():
    rec = make_synthetic_reconstruction(num_images=5, num_points=70,
                                        seed=2)
    arrays = rec.to_arrays()
    rng = np.random.default_rng(0)
    arrays.points = arrays.points + 0.02 * rng.normal(
        size=arrays.points.shape)
    arrays.tvecs = arrays.tvecs + 0.02 * rng.normal(size=arrays.tvecs.shape)
    arrays.obs_xy = arrays.obs_xy + 0.5 * rng.normal(size=arrays.obs_xy.shape)
    kw = dict(constant_pose_rows=[0], constant_tvec_rows={1: [0]})
    return (j_ba.build_problem(arrays, **kw),
            t_ba.build_problem(arrays, device="cpu", **kw))


def test_pad_problem_pow2_matches_sba_tpu():
    jp, tp = _ba_problems()
    jpad = j_ba.pad_problem_pow2(jp)
    tpad = t_ba.pad_problem_pow2(tp)
    assert tpad.qvecs.shape[0] == 8 and tpad.points.shape[0] == 128
    for f in t_ba._FIELDS + ("image_cam",):
        a, b = np.asarray(getattr(jpad, f)), np_(getattr(tpad, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f)
    assert t_ba.pad_problem_pow2(tpad) is tpad


def test_padded_solve_equals_unpadded():
    _jp, tp = _ba_problems()
    opt = t_ba.BAOptions(max_iterations=10)
    out, s = t_ba.bundle_adjust(tp, opt)
    outp, sp = t_ba.bundle_adjust(t_ba.pad_problem_pow2(tp), opt)
    N, P = tp.qvecs.shape[0], tp.points.shape[0]
    assert sp.num_iterations == s.num_iterations
    np.testing.assert_allclose(float(sp.final_cost), float(s.final_cost),
                               rtol=1e-10)
    for a, b in ((out.qvecs, outp.qvecs[:N]), (out.tvecs, outp.tvecs[:N]),
                 (out.points, outp.points[:P])):
        np.testing.assert_allclose(np_(b), np_(a), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# reconstruction edits and filters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """One model (SIMPLE_RADIAL, noisy points, a bogus second camera) read
    by both packages from the same files."""
    from sba_tpu_torch.utils.synthetic import \
        make_synthetic_reconstruction as t_make

    rec = t_make(
        num_images=6, num_points=80, seed=3, model_id=2,
        params=[500.0, 320.0, 240.0, 0.01])
    rng = np.random.default_rng(1)
    for k, p in enumerate(rec.points3D.values()):
        p.xyz = p.xyz + (0.3 if k % 7 == 0 else 0.002) * rng.normal(size=3)
    path = tmp_path_factory.mktemp("edit_model")
    rec.write(str(path))
    return str(path)


def _state(rec):
    pts = {pid: (p.xyz, list(zip(p.image_ids.tolist(),
                                 p.point2D_idxs.tolist())))
           for pid, p in rec.points3D.items()}
    ims = {iid: (im.point3D_ids.tolist(), im.qvec, im.tvec)
           for iid, im in rec.images.items()}
    cams = {cid: c.params for cid, c in rec.cameras.items()}
    return pts, ims, cams, list(rec.registered_image_ids)


def _assert_same(a, b):
    pa, ia, ca, ra = _state(a)
    pb, ib, cb, rb = _state(b)
    assert ra == rb
    assert list(pa) == list(pb)
    for pid in pa:
        np.testing.assert_array_equal(pb[pid][0], pa[pid][0])
        assert pb[pid][1] == pa[pid][1], pid
    assert list(ia) == list(ib)
    for iid in ia:
        assert ib[iid][0] == ia[iid][0], iid
    for cid in ca:
        np.testing.assert_array_equal(cb[cid], ca[cid])


def _edit(op, rec):
    pids = list(rec.points3D)
    if op == "deregister_image":
        rec.deregister_image(rec.registered_image_ids[2])
        return None
    if op == "add_observation":
        p = rec.points3D[pids[0]]
        im = rec.images[int(p.image_ids[0])]
        free = int(np.nonzero(im.point3D_ids == -1)[0][0]) \
            if (im.point3D_ids == -1).any() else None
        if free is None:
            im.xys = np.concatenate([im.xys, [[10.0, 20.0]]])
            im.point3D_ids = np.append(im.point3D_ids, -1)
            free = len(im.xys) - 1
        rec.add_observation(pids[0], int(p.image_ids[0]), free)
        return None
    if op == "merge_points":
        return rec.merge_points(pids[1], pids[2])
    if op == "filter_points_large_reprojection_error":
        return rec.filter_points_large_reprojection_error(2.0)
    if op == "filter_points_min_tri_angle":
        return rec.filter_points_min_tri_angle(25.0)
    if op == "filter_images":
        cam = rec.cameras[rec.images[rec.registered_image_ids[1]].camera_id]
        cam.params = np.asarray(cam.params, np.float64).copy()
        cam.params[3] = 150.0
        return rec.filter_images(max_extra_param=100.0)
    if op == "statistics":
        return (rec.num_points3d(), rec.num_registered_images(),
                rec.compute_num_observations(),
                rec.compute_mean_track_length(),
                rec.compute_mean_observations_per_reg_image(),
                rec.compute_mean_reprojection_error())
    raise ValueError(op)


@pytest.mark.parametrize("op", [
    "deregister_image", "add_observation", "merge_points",
    "filter_points_large_reprojection_error", "filter_points_min_tri_angle",
    "filter_images", "statistics"])
def test_reconstruction_edits_match_sba_tpu(model_dir, op):
    a, b = JRec.read(model_dir), TRec.read(model_dir)
    ra, rb = _edit(op, a), _edit(op, b)
    if op == "statistics":
        np.testing.assert_allclose(rb, ra, rtol=1e-12)
    else:
        assert rb == ra
    if op.startswith("filter_points"):
        assert ra > 0
    _assert_same(a, b)
    assert TRec.read(model_dir).cameras[1].mean_focal_length() == \
        JRec.read(model_dir).cameras[1].mean_focal_length()


# ---------------------------------------------------------------------------
# the 8-image scene of tests/test_incremental_mapper.py
# ---------------------------------------------------------------------------

def look_at_rotation(center, target, up=np.array([0.0, 0.0, 1.0])):
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0, 0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def write_ring_scene(db, n_images=8, n_points=300, seed=42, model_id=0,
                     extra=()):
    """tests/test_incremental_mapper.py's scene (8 views on an arc, 300
    points, 0.3 px noise) written into `db`; `model_id`/`extra` give the
    camera another model (its distortion applied to the keypoints).
    Returns the true (qvecs, tvecs, points)."""
    from sba_tpu.geometry.quaternions import quat_to_rotmat, rotmat_to_quat
    from sba_tpu_torch.geometry import camera_models

    rng = np.random.default_rng(seed)
    f, w, h = 500.0, 640, 480
    pts = rng.uniform(-2, 2, (n_points, 3))
    pts[:, 2] *= 0.5
    qvecs, tvecs = [], []
    for k in range(n_images):
        ang = 2 * np.pi * k / n_images
        center = np.array([4 * np.cos(ang), 4 * np.sin(ang), 2.0])
        R = look_at_rotation(center, np.zeros(3))
        qvecs.append(np.asarray(rotmat_to_quat(J(R))))
        tvecs.append(-R @ center)
    params = ([f, w / 2, h / 2] if model_id == 0
              else [f, w / 2, h / 2, *extra])
    cid = db.write_camera(model_id=model_id, width=w, height=h,
                          params=params)
    ids, vis = [], []
    for k in range(n_images):
        R = np.asarray(quat_to_rotmat(J(qvecs[k])))
        pc = pts @ R.T + tvecs[k]
        z = pc[:, 2]
        if model_id == 0:
            xy = pc[:, :2] / pc[:, 2:] * f + [w / 2, h / 2]
        else:
            xy = camera_models.world_to_image(
                model_id, T(np.asarray(params)),
                T(pc[:, :2] / pc[:, 2:])).numpy()
        xy += rng.normal(0, 0.3, xy.shape)
        visible = (z > 0.5) & (xy[:, 0] > 0) & (xy[:, 0] < w) \
            & (xy[:, 1] > 0) & (xy[:, 1] < h)
        iid = db.write_image(f"img{k}.png", cid)
        ids.append(iid)
        db.write_keypoints(iid, np.concatenate(
            [xy, np.ones_like(xy)], -1).astype(np.float32))
        vis.append(visible)
    for a in range(n_images):
        for b in range(a + 1, n_images):
            common = np.nonzero(vis[a] & vis[b])[0]
            if len(common) < 20:
                continue
            m = np.stack([common, common], -1).astype(np.uint32)
            db.write_two_view_geometry(ids[a], ids[b], m, config=2)
    db.commit()
    return np.stack(qvecs), np.stack(tvecs), pts


@pytest.fixture(scope="module")
def ring_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ring") / "db.db")
    db = j_db.Database(path)
    write_ring_scene(db)
    db.close()
    return path


def _caches(path):
    jd, td = j_db.Database(path), t_db.Database(path)
    try:
        return (j_cache.DatabaseCache.create(jd, min_num_matches=15),
                t_cache.DatabaseCache.create(td, min_num_matches=15))
    finally:
        jd.close()
        td.close()


def test_database_cache_matches_sba_tpu(ring_db):
    jc, tc = _caches(ring_db)
    assert list(jc.images) == list(tc.images)
    assert list(jc.cameras) == list(tc.cameras)
    for iid in jc.images:
        np.testing.assert_array_equal(tc.images[iid].keypoints,
                                      jc.images[iid].keypoints)
        assert tc.images[iid].num_observations == \
            jc.images[iid].num_observations
    jg, tg = jc.correspondence_graph, tc.correspondence_graph
    assert list(jg.image_pairs) == list(tg.image_pairs)
    for key in jg.image_pairs:
        np.testing.assert_array_equal(tg.image_pairs[key],
                                      jg.image_pairs[key])
    for i in jg.offsets:
        for f in ("offsets", "corr_images", "corr_features"):
            np.testing.assert_array_equal(getattr(tg, f)[i],
                                          getattr(jg, f)[i])
    rng = np.random.default_rng(0)
    for i in jg.offsets:
        for f in rng.integers(0, len(jg.offsets[i]) - 1, 20):
            for k in (1, 2):
                np.testing.assert_array_equal(
                    tg.find_transitive_correspondences(i, int(f), k),
                    jg.find_transitive_correspondences(i, int(f), k))


def test_visibility_pyramid_matches_sba_tpu():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 1, (500, 2)) * [640, 480]
    xy[:5] = [[0, 0], [639.9, 479.9], [640, 480], [-3, 10], [320, 240]]
    a = j_vis.VisibilityPyramid(6, 640, 480)
    b = t_vis.VisibilityPyramid(6, 640, 480)
    c = t_vis.VisibilityPyramid(6, 640, 480)
    for k, (x, y) in enumerate(xy):
        a.set_point(x, y)
        b.set_point(x, y)
        if k % 97 == 0:
            assert a.score == b.score
    c.set_points(xy)
    assert a.score == b.score == c.score
    for l in range(6):
        np.testing.assert_array_equal(c.cells[l], a.cells[l])
    for x, y in xy[:200]:
        a.reset_point(x, y)
        b.reset_point(x, y)
    assert a.score == b.score


# ---------------------------------------------------------------------------
# the triangulator and the mapper's steps from one registered state
# ---------------------------------------------------------------------------

def _assert_tracks(jrec, trec, atol=1e-9):
    assert list(jrec.registered_image_ids) == list(trec.registered_image_ids)
    assert list(jrec.points3D) == list(trec.points3D)
    for pid, p in jrec.points3D.items():
        q = trec.points3D[pid]
        assert p.image_ids.tolist() == q.image_ids.tolist(), pid
        assert p.point2D_idxs.tolist() == q.point2D_idxs.tolist(), pid
        np.testing.assert_allclose(q.xyz, p.xyz, rtol=0, atol=atol)
    for iid, im in jrec.images.items():
        np.testing.assert_array_equal(trec.images[iid].point3D_ids,
                                      im.point3D_ids)


@pytest.fixture(scope="module")
def stepped(ring_db):
    """Both mappers on the ring scene stepped in lock: initial pair, then
    one registration; each stage's states are kept (deep copies)."""
    jc, tc = _caches(ring_db)
    jm = j_map.IncrementalMapper(jc)
    tm = t_map.IncrementalMapper(tc, device="cpu", draw_fn=sba_draws)
    opt_j = j_map.IncrementalMapperOptions(init_min_num_inliers=50,
                                           abs_pose_min_num_inliers=15)
    opt_t = t_map.IncrementalMapperOptions(init_min_num_inliers=50,
                                           abs_pose_min_num_inliers=15)
    stages = {}
    jm.begin_reconstruction(JRec())
    tm.begin_reconstruction(TRec())
    found = [m.find_initial_image_pair(o)
             for m, o in ((jm, opt_j), (tm, opt_t))]
    stages["init"] = found
    for m, o, f in ((jm, opt_j, found[0]), (tm, opt_t, found[1])):
        assert m.register_initial_image_pair(f[0], f[1], f[2], o)
    stages["pair"] = (copy.deepcopy(jm.rec), copy.deepcopy(tm.rec))
    nxt = (jm.find_next_images(opt_j), tm.find_next_images(opt_t))
    stages["next"] = nxt
    ok = (jm.register_next_image(nxt[0][0], opt_j),
          tm.register_next_image(nxt[1][0], opt_t))
    stages["registered"] = (ok, copy.deepcopy(jm.rec),
                            copy.deepcopy(tm.rec))
    topt_j, topt_t = (j_map.TriangulatorOptions(),
                      t_tri.TriangulatorOptions())
    stages["triangulated"] = (jm.triangulate_image(nxt[0][0], topt_j),
                              tm.triangulate_image(nxt[1][0], topt_t))
    stages["tri_state"] = (copy.deepcopy(jm.rec), copy.deepcopy(tm.rec))
    return dict(jm=jm, tm=tm, opt=(opt_j, opt_t), topt=(topt_j, topt_t),
                stages=stages)


def test_initial_pair_matches_sba_tpu(stepped):
    (i1, i2, a), (k1, k2, b) = stepped["stages"]["init"]
    assert (i1, i2) == (k1, k2)
    np.testing.assert_array_equal(b["inlier_matches"], a["inlier_matches"])
    np.testing.assert_allclose(b["qvec"], a["qvec"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(b["tvec"], a["tvec"], rtol=0, atol=1e-8)
    _assert_tracks(*stepped["stages"]["pair"])


def test_registration_step_matches_sba_tpu(stepped):
    st = stepped["stages"]
    assert st["next"][0] == st["next"][1]
    ok, jrec, trec = st["registered"]
    assert ok == (True, True)
    iid = st["next"][0][0]
    np.testing.assert_allclose(trec.images[iid].qvec, jrec.images[iid].qvec,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(trec.images[iid].tvec, jrec.images[iid].tvec,
                               rtol=0, atol=1e-8)
    _assert_tracks(jrec, trec)
    assert st["triangulated"][0] == st["triangulated"][1] > 0
    _assert_tracks(*st["tri_state"])


@pytest.mark.parametrize("step", ["complete_tracks", "merge_tracks",
                                  "retriangulate", "complete_image"])
def test_triangulator_steps_match_sba_tpu(stepped, step):
    """From the state after the first registration (points nudged apart
    and observations dropped so that each step has work), one step of
    each triangulator gives the same tracks and points."""
    jrec, trec = (copy.deepcopy(r) for r in stepped["stages"]["tri_state"])
    iid = stepped["stages"]["next"][0][0]
    for rec in (jrec, trec):
        im = rec.images[iid]
        tracked = np.nonzero(im.point3D_ids != -1)[0]
        for f in tracked[::3]:
            rec.delete_observation(iid, int(f))
        for k, p in enumerate(rec.points3D.values()):
            if k % 5 == 0:
                p.xyz = p.xyz + 1e-3
        if step == "retriangulate":     # under the re_min_ratio of 0.2
            for k, pid in enumerate(list(rec.points3D)):
                if k % 10:
                    rec.delete_point3d(pid)
    outs = []
    for rec, pkg, opt in ((jrec, j_map, stepped["topt"][0]),
                          (trec, t_tri, stepped["topt"][1])):
        tri = pkg.IncrementalTriangulator(
            (stepped["jm"] if pkg is j_map else stepped["tm"])
            .cache.correspondence_graph, rec)
        pids = list(rec.points3D)
        if step == "complete_tracks":
            outs.append(tri.complete_tracks(pids, opt))
        elif step == "merge_tracks":
            outs.append(tri.merge_tracks(pids, opt))
        elif step == "retriangulate":
            outs.append(tri.retriangulate(opt))
        else:
            outs.append(tri.complete_image(iid, opt))
    assert outs[0] == outs[1]
    if step != "merge_tracks":
        assert outs[0] > 0, step
    _assert_tracks(jrec, trec)


def test_batched_camera_calls_equal_per_call(stepped):
    """The triangulator's cached normalized keypoints and its batched
    projections give the bits of one camera-model call per keypoint or
    per projection (the per-call form of sba_tpu's code)."""
    trec = copy.deepcopy(stepped["stages"]["tri_state"][1])
    for cam in trec.cameras.values():      # Newton's undistortion runs
        cam.model_id = 2
        cam.params = np.append(np.asarray(cam.params, np.float64), -0.03)
    tri = t_tri.IncrementalTriangulator(
        stepped["tm"].cache.correspondence_graph, trec)
    reg = list(trec.registered_image_ids)
    # A second camera state: the cache must follow the parameters.
    for step in range(2):
        for iid in reg:
            im = trec.images[iid]
            cam = trec.cameras[im.camera_id]
            n = tri.normalized(iid)
            for f in (0, len(im.xys) // 2, len(im.xys) - 1):
                np.testing.assert_array_equal(
                    n[f], t_tri._image_to_normalized(cam, im.xys[f])[0])
        cam = trec.cameras[trec.images[reg[0]].camera_id]
        cam.params = np.asarray(cam.params) * [1.01, 1, 1, 1]
    pairs = [(iid, pid) for iid in reg for pid in list(trec.points3D)[:40]]
    tri._project_points(pairs)
    rows = []
    for iid, pid in pairs:
        im = trec.images[iid]
        cam = trec.cameras[im.camera_id]
        xy, z = t_tri._project(cam, im.qvec, im.tvec,
                               trec.points3D[pid].xyz)
        np.testing.assert_array_equal(tri._proj[iid, pid][0], xy[0])
        assert tri._proj[iid, pid][1] == z[0]
        rows.append((im, 0, cam, trec.points3D[pid].xyz))
    err, z = tri._reproj_errors(rows)
    for k, (im, ft, cam, xyz) in enumerate(rows):
        xy, zz = t_tri._project(cam, im.qvec, im.tvec, xyz)
        assert err[k] == np.linalg.norm(xy[0] - im.xys[ft])
        assert z[k] == zz[0]
    # sba_tpu's own per-call camera model agrees to rounding.
    j_tri_mod = __import__("sba_tpu.sfm.incremental_triangulator",
                           fromlist=["_project"])
    im = trec.images[reg[0]]
    cam = trec.cameras[im.camera_id]
    xyz = list(trec.points3D.values())[0].xyz
    np.testing.assert_allclose(
        t_tri._project(cam, im.qvec, im.tvec, xyz)[0],
        j_tri_mod._project(cam, im.qvec, im.tvec, xyz)[0], rtol=0,
        atol=1e-9)
    np.testing.assert_allclose(
        tri.normalized(reg[0])[:50],
        j_tri_mod._image_to_normalized(cam, im.xys[:50]), rtol=0,
        atol=1e-12)


def test_graph_scans_match_sba_tpu(stepped):
    """find_next_images and the 2D-3D gather (vectorized over the CSR
    graph) against sba_tpu's per-feature loops on the same state; the
    local bundle's ranking too."""
    jm, tm = stepped["jm"], stepped["tm"]
    opt_j, opt_t = stepped["opt"]
    assert tm.find_next_images(opt_t) == jm.find_next_images(opt_j)
    reg = [i for i in jm.rec.images if jm.rec.is_registered(i)]
    for iid in reg:
        assert tm.find_local_bundle(iid, opt_t) == \
            jm.find_local_bundle(iid, opt_j)
    # The gather: sba_tpu's loop, written out, on every unregistered image.
    g = tm.cache.correspondence_graph
    for iid, image in tm.rec.images.items():
        if tm.rec.is_registered(iid):
            continue
        p2d, p3d, seen = [], [], set()
        off = g.offsets[iid]
        for f in range(len(image.xys)):
            for oim, oft in zip(g.corr_images[iid][off[f]:off[f + 1]],
                                g.corr_features[iid][off[f]:off[f + 1]]):
                if not tm.rec.is_registered(int(oim)):
                    continue
                pid = int(tm.rec.images[int(oim)].point3D_ids[int(oft)])
                if pid == -1 or (f, pid) in seen:
                    continue
                seen.add((f, pid))
                p2d.append(f)
                p3d.append(pid)
        feat, pids = tm._corr_points(iid)
        ok = pids != -1
        _, first = np.unique((feat[ok].astype(np.int64) << 32) | pids[ok],
                             return_index=True)
        first = np.sort(first)
        assert feat[ok][first].tolist() == p2d
        assert pids[ok][first].tolist() == p3d
