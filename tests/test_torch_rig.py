"""The port's camera rigs, GR6P and generalized absolute pose against
sba_tpu's, in float64 on the CPU with the same numpy inputs and
sba_tpu's draws (tests/test_camera_rig.py,
tests/test_generalized_relative_pose.py and
tests/test_generalized_pose.py's cases): `compose_rig_poses` and
`compute_rig_from_reconstruction` at 1e-12; the rig BA's gradient and
block-diagonal Hessian against sba_tpu's dense ``jax.hessian`` of the
same cost (its off-diagonal blocks exactly zero) and the damped step
against its dense solve, at 1e-10 of their scale; whole rig BAs
(snapshot poses at 1e-9); GR6P's scoring at 1e-15, its RANSAC with
sba_tpu's draws (the same model and inliers); the generalized absolute
pose with sba_tpu's draws (pose at 1e-9, the same inliers) and its
refinement. sba_tpu's rig loop runs eagerly (~12 s per iteration here):
its solves are capped at two iterations."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_tpu.estimators import generalized_pose as j_gp
from sba_tpu.estimators import generalized_relative_pose as j_gr
from sba_tpu.geometry import quaternions as j_q
from sba_tpu.models import camera_rig as j_rig
from sba_tpu.optim import ba as j_ba
from sba_tpu.optim import ransac as j_ransac
from sba_tpu_torch.estimators import generalized_pose as t_gp
from sba_tpu_torch.estimators import generalized_relative_pose as t_gr
from sba_tpu_torch.models import camera_rig as t_rig
from sba_tpu_torch.optim import ba as t_ba
from sba_tpu_torch.optim.ransac import RANSACOptions
from test_generalized_pose import _make_rig_problem
from test_generalized_relative_pose import make_rig_pair

torch.set_num_threads(2)

T = torch.as_tensor


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _aa_quat(aa):
    return np.asarray(j_q.angle_axis_to_quat(jnp.asarray(aa, jnp.float64)))


def test_compose_rig_poses_matches_sba_tpu():
    rng = np.random.default_rng(0)
    sq = np.stack([_aa_quat(a) for a in rng.normal(0, 0.5, (7, 3))])
    cq = np.stack([_aa_quat(a) for a in rng.normal(0, 0.5, (7, 3))])
    st, ct = rng.normal(size=(7, 3)), rng.normal(size=(7, 3))
    ref = j_rig.compose_rig_poses(*(jnp.asarray(a) for a in (sq, st, cq,
                                                             ct)))
    got = t_rig.compose_rig_poses(*(T(a) for a in (sq, st, cq, ct)))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np_(b), np_(a), rtol=0, atol=1e-12)


def _rig_reconstruction(pkg, noise):
    """tests/test_camera_rig.py's two-camera rig over 4 snapshots, each
    image's relative pose perturbed by `noise` (so the average matters)."""
    import importlib

    cm = importlib.import_module(f"{pkg}.io.colmap_models")
    rc = importlib.import_module(f"{pkg}.models.reconstruction")
    rng = np.random.default_rng(0)
    rec = rc.Reconstruction()
    for cid in (1, 2):
        rec.add_camera(cm.Camera(camera_id=cid, model_id=0, width=100,
                                 height=100, params=np.array([100.0, 50, 50])))
    q_rel = _aa_quat([0.1, -0.05, 0.2])
    t_rel = np.array([0.3, 0.0, -0.1])
    iid = 1
    snaps = []
    for snap in range(4):
        q1 = _aa_quat(rng.normal(0, 0.3, 3))
        t1 = rng.normal(0, 1.0, 3)
        dq = _aa_quat(rng.normal(0, noise, 3))
        q2, t2 = j_q.pose_product(
            j_q.quat_multiply(jnp.asarray(dq), jnp.asarray(q_rel)),
            jnp.asarray(t_rel + rng.normal(0, noise, 3)), jnp.asarray(q1),
            jnp.asarray(t1))
        for k, (q, t) in enumerate(((q1, t1), (np_(q2), np_(t2)))):
            rec.add_image(cm.Image(
                image_id=iid + k, qvec=np.asarray(q), tvec=np.asarray(t),
                camera_id=k + 1, name=f"s{snap}_c{k + 1}",
                xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64)),
                registered=True)
        snaps.append([iid, iid + 1])
        iid += 2
    return rec, snaps


@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_compute_rig_from_reconstruction_matches_sba_tpu(noise):
    out = []
    for pkg, mod in (("sba_tpu", j_rig), ("sba_tpu_torch", t_rig)):
        rec, snaps = _rig_reconstruction(pkg, noise)
        rig = mod.CameraRig(ref_camera_id=1)
        rig.add_camera(1)
        rig.add_camera(2)
        for s in snaps:
            rig.add_snapshot(s)
        rig.compute_rig_from_reconstruction(rec)
        out.append(rig.cams_from_rig)
    for cid in (1, 2):
        for a, b in zip(out[0][cid], out[1][cid]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the rig BA
# ---------------------------------------------------------------------------

def rig_scene(S=3, P=60, seed=1):
    """tests/test_camera_rig.py's rig BA scene: S snapshots of a
    two-camera rig, P points, image poses perturbed off the rig
    constraint. Returns (BAProblem fields, snapshot ids, camera poses,
    true image poses)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (P, 3)) + [0, 0, 6.0]
    q_rel, t_rel = _aa_quat([0.0, 0.3, 0.0]), np.array([0.5, 0.0, 0.0])
    img_q, img_t, snap_ids, cam_qs, cam_ts = [], [], [], [], []
    for s in range(S):
        q_s = _aa_quat([0.02 * s, -0.03 * s, 0.01])
        t_s = np.array([0.4 * s - 0.8, 0.05 * s, 0.0])
        for cq, ct in (([1.0, 0, 0, 0], [0.0, 0, 0]), (q_rel, t_rel)):
            q, t = j_q.pose_product(jnp.asarray(cq, jnp.float64),
                                    jnp.asarray(ct, jnp.float64),
                                    jnp.asarray(q_s), jnp.asarray(t_s))
            img_q.append(np_(q))
            img_t.append(np_(t))
            snap_ids.append(s)
            cam_qs.append(np.asarray(cq, np.float64))
            cam_ts.append(np.asarray(ct, np.float64))
    img_q, img_t = np.stack(img_q), np.stack(img_t)
    N = len(img_q)
    obs_i = np.repeat(np.arange(N), P)
    obs_p = np.tile(np.arange(P), N)
    pc = np.einsum("nij,pj->npi", np.stack(
        [j_q.np_quat_to_rotmat(q) for q in img_q]), pts) + img_t[:, None]
    obs_xy = (pc[..., :2] / pc[..., 2:]).reshape(-1, 2)
    qn = img_q + rng.normal(0, 0.01, img_q.shape)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    tn = img_t + rng.normal(0, 0.05, img_t.shape)
    cam = np.zeros((1, 12))
    cam[0, 0] = 1.0
    O = len(obs_i)
    fields = dict(qvecs=qn, tvecs=tn, points=pts, cam_params=cam,
                  obs_image=obs_i.astype(np.int32),
                  obs_point=obs_p.astype(np.int32),
                  obs_cam=np.zeros(O, np.int32), obs_xy=obs_xy,
                  obs_mask=np.ones(O), free_rot=np.ones(N),
                  free_trans=np.ones((N, 3)), free_points=np.zeros(P),
                  free_cam=np.zeros((1, 12)))
    return (fields, np.array(snap_ids), np.stack(cam_qs), np.stack(cam_ts),
            (img_q, img_t))


def _j_problem(fields):
    return j_ba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.mark.parametrize("at", ["zero", "random"])
def test_rig_hessian_blocks_match_sba_tpu_dense(at):
    """sba_tpu's flat cost over [S*6], its dense jax.hessian and its
    damped dense solve, against the port's gradient, diagonal blocks and
    block solve on the same snapshot poses: the off-diagonal blocks of
    the dense Hessian are exactly zero."""
    fields, sid, cq, ct, _ = rig_scene(S=4)
    S = int(sid.max()) + 1
    rng = np.random.default_rng(3)
    snap_q = np.stack([_aa_quat(a) for a in rng.normal(0, 0.05, (S, 3))])
    snap_t = rng.normal(0, 0.5, (S, 3))
    delta = np.zeros((S, 6)) if at == "zero" else \
        rng.normal(0, 0.01, (S, 6))
    jopt, jp = j_ba.BAOptions(), _j_problem(fields)

    def flat_cost(d):
        d = d.reshape(S, 6)
        sq = jax.vmap(j_q.quat_retract)(jnp.asarray(snap_q), d[:, :3])
        st = jnp.asarray(snap_t) + d[:, 3:]
        iq, it = j_rig.compose_rig_poses(sq[sid], st[sid], jnp.asarray(cq),
                                         jnp.asarray(ct))
        r = j_ba._residuals_only(iq, it, jp.points, jp.cam_params, jp, jopt)
        return 0.5 * jnp.sum(jp.obs_mask * jnp.sum(r * r, -1))

    d0 = jnp.asarray(delta.reshape(-1))
    g_ref = np_(jax.jit(jax.grad(flat_cost))(d0)).reshape(S, 6)
    H_ref = np_(jax.jit(jax.hessian(flat_cost))(d0))
    tp = t_ba.problem_from_numpy(fields, device="cpu")
    cost_of = t_rig.rig_cost_fn(tp, t_ba.BAOptions(), T(snap_q), T(snap_t),
                                T(sid), T(cq), T(ct))
    g, H = t_rig.newton_blocks(cost_of, T(delta))
    blocks = H_ref.reshape(S, 6, S, 6)
    for a in range(S):
        for b in range(S):
            if a != b:
                assert not blocks[a, :, b, :].any()
    diag = np.stack([blocks[s, :, s, :] for s in range(S)])
    np.testing.assert_allclose(np_(g), g_ref, rtol=0,
                               atol=1e-10 * np.abs(g_ref).max())
    np.testing.assert_allclose(np_(H), diag, rtol=0,
                               atol=1e-10 * np.abs(diag).max())
    for lam in (1e-6, 1e-2):
        Hd = H_ref + lam * np.diag(np.clip(np.diag(H_ref), 1e-8, None))
        step_ref = np.linalg.solve(Hd, -g_ref.reshape(-1)).reshape(S, 6)
        step = np_(t_rig.damped_step(g, H, torch.tensor(lam,
                                                        dtype=torch.float64)))
        np.testing.assert_allclose(step, step_ref, rtol=0,
                                   atol=1e-10 * np.abs(step_ref).max())


def test_rig_bundle_adjust_and_command_match_sba_tpu(tmp_path):
    """Two iterations of both loops (sba_tpu's eager dense Newton): the
    initial snapshot poses, the accepted steps, the composed poses at
    1e-9 and the costs at 1e-9 relative; `refine_relative_poses` is not
    read, as in sba_tpu. Then `rig_bundle_adjuster` through both CLIs on
    the scene written as a COLMAP model (one iteration; in the same
    test, so that sba_tpu's eager loop compiles its operations once)."""
    from sba_tpu.models.reconstruction import Reconstruction as JRec
    from sba_tpu_torch.models.reconstruction import Reconstruction as TRec
    from test_torch_sfm import assert_same_model, run_both

    fields, sid, cq, ct, _ = rig_scene(S=3)
    ref = j_rig.rig_bundle_adjust(_j_problem(fields), sid, cq, ct,
                                  j_ba.BAOptions(max_iterations=2))
    tp = t_ba.problem_from_numpy(fields, device="cpu")
    got = t_rig.rig_bundle_adjust(tp, sid, cq, ct,
                                  t_ba.BAOptions(max_iterations=2))
    for k in ("snapshot_qvecs", "snapshot_tvecs", "image_qvecs",
              "image_tvecs"):
        np.testing.assert_allclose(np_(got[k]), np_(ref[k]), rtol=0,
                                   atol=1e-9, err_msg=k)
    c = float(ref["final_cost"])
    assert abs(float(got["final_cost"]) - c) <= 1e-9 * c
    assert int(got["num_accepted"]) == 2
    again = t_rig.rig_bundle_adjust(tp, sid, cq, ct,
                                    t_ba.BAOptions(max_iterations=2),
                                    refine_relative_poses=True)
    for k in got:
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(again[k]))

    model = tmp_path / "rig_model"
    model.mkdir()
    _write_rig_model("sba_tpu", model)
    out = run_both("rig_bundle_adjuster", {
        "input_path": str(model), "output_path": str(tmp_path / "@_rig"),
        "rig_config_path": str(model) + ".json",
        "BundleAdjustment.max_iterations": "1"})
    assert "Camera Rig: 2 cameras, 3 snapshots" in out
    assert "rig BA final cost: " in out and "[cpu]" in out
    assert_same_model(JRec.read(str(tmp_path / "j_rig")),
                      TRec.read(str(tmp_path / "t_rig")), 1e-9)


def test_rig_bundle_adjust_recovers_the_rig():
    """tests/test_camera_rig.py's recovery (the port alone, 60
    iterations): the composed poses beat the perturbed ones by 5x."""
    fields, sid, cq, ct, (img_q, img_t) = rig_scene(S=4)
    out = t_rig.rig_bundle_adjust(
        t_ba.problem_from_numpy(fields, device="cpu"), sid, cq, ct,
        t_ba.BAOptions(max_iterations=60))

    def pose_err(qs, ts):
        qe = np.minimum(np.abs(qs - img_q), np.abs(qs + img_q)).max()
        return qe + np.abs(ts - img_t).max()

    before = pose_err(fields["qvecs"], fields["tvecs"])
    after = pose_err(np_(out["image_qvecs"]), np_(out["image_tvecs"]))
    assert after < 0.2 * before and float(out["final_cost"]) < \
        float(out["initial_cost"])


def _write_rig_model(pkg, path, S=3, P=60):
    """The rig BA scene as a COLMAP model: cameras 1 and 2 (SIMPLE_PINHOLE,
    f 500), images left/sNNN.png and right/sNNN.png, the points with
    their tracks; and the rig config."""
    import importlib

    cm = importlib.import_module(f"{pkg}.io.colmap_models")
    rc = importlib.import_module(f"{pkg}.models.reconstruction")
    fields, sid, _cq, _ct, _ = rig_scene(S=S, P=P)
    rec = rc.Reconstruction()
    for cid in (1, 2):
        rec.add_camera(cm.Camera(camera_id=cid, model_id=0, width=640,
                                 height=480,
                                 params=np.array([500.0, 320, 240])))
    xy = fields["obs_xy"].reshape(-1, P, 2) * 500.0 + [320, 240]
    for i in range(len(sid)):
        side = ("left", "right")[i % 2]
        rec.add_image(cm.Image(
            image_id=i + 1, qvec=fields["qvecs"][i], tvec=fields["tvecs"][i],
            camera_id=i % 2 + 1, name=f"{side}/s{sid[i]:03d}.png",
            xys=xy[i], point3D_ids=np.full(P, -1, np.int64)),
            registered=True)
    for p in range(P):
        rec.add_point3d(fields["points"][p],
                        [(i + 1, p) for i in range(len(sid))])
    rec.write(str(path))
    with open(str(path) + ".json", "w") as f:
        json.dump([{"ref_camera_id": 1, "cameras": [
            {"camera_id": 1, "image_prefix": "left/"},
            {"camera_id": 2, "image_prefix": "right/"}]}], f)


# ---------------------------------------------------------------------------
# GR6P
# ---------------------------------------------------------------------------

def test_generalized_sampson_errors_match_sba_tpu():
    d = make_rig_pair(n=40, noise=1e-3, outlier_frac=0.2, seed=2)
    data, R, t = d[:6], d[6], d[7]
    rng = np.random.default_rng(1)
    Rs = [R, R.T, j_q.np_quat_to_rotmat(_aa_quat(rng.normal(0, 0.5, 3)))]
    ts = [t, -t, rng.normal(size=3)]
    got = t_gr.generalized_sampson_errors(
        T(np.stack(Rs)), T(np.stack(ts)), *(T(a) for a in data))
    for k in range(3):
        ref = j_gr.generalized_sampson_errors(Rs[k], ts[k], *data)
        np.testing.assert_allclose(np_(got[k]), ref, rtol=1e-12,
                                   atol=1e-15)


def sba_gr6p_draws(K, seed=0):
    """sba_tpu's RANSAC draws for `seed`: numpy's generator, a sample of
    8 and the solver's seed per trial."""
    rng = np.random.default_rng(seed)
    return lambda: (rng.choice(K, size=8, replace=False),
                    int(rng.integers(2 ** 31)))


@pytest.mark.parametrize("n,outliers,seed", [(60, 0.1, 3), (5, 0.0, 4)])
def test_gr6p_ransac_matches_sba_tpu(n, outliers, seed):
    """With sba_tpu's draws: the same model, inliers and success (five
    correspondences: refused by both)."""
    d = make_rig_pair(n=n, noise=5e-4, outlier_frac=outliers, seed=seed)
    data = d[:6]
    ref = j_gr.estimate_generalized_relative_pose(
        *data, j_gr.GeneralizedRelativePoseOptions(max_error=5e-3), seed=0)
    got = t_gr.estimate_generalized_relative_pose(
        *data, t_gr.GeneralizedRelativePoseOptions(max_error=5e-3), seed=0,
        device="cpu", draw_fn=sba_gr6p_draws(n))
    assert got.success == ref.success == (n >= 8)
    assert got.num_inliers == ref.num_inliers
    np.testing.assert_array_equal(got.inlier_mask, ref.inlier_mask)
    np.testing.assert_allclose(got.R, ref.R, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.t, ref.t, rtol=0, atol=1e-12)
    if got.success:
        assert np.abs(got.R - d[6]).max() < 0.01


def test_gr6p_with_its_own_draws_recovers_the_rig():
    d = make_rig_pair(n=60, noise=5e-4, outlier_frac=0.1, seed=3)
    rep = t_gr.estimate_generalized_relative_pose(
        *d[:6], t_gr.GeneralizedRelativePoseOptions(max_error=5e-3),
        device="cpu", generator=torch.Generator().manual_seed(5))
    assert rep.success and rep.inlier_mask[:d[8]].sum() <= 2
    assert np.abs(rep.R - d[6]).max() < 0.01
    assert np.abs(rep.t - d[7]).max() < 0.05


def test_snapshot_relative_pose_matches_sba_tpu():
    """tests/test_generalized_relative_pose.py's rig wiring (pixel
    observations of a three-camera rig) at 10% outliers."""
    from sba_tpu_torch.geometry.quaternions import np_rotmat_to_quat

    (R1, t1, xy1, R2, t2, xy2, R_true, _t, _n) = make_rig_pair(
        n=40, noise=1e-4, outlier_frac=0.1, seed=7)
    f = 400.0
    ids, cams = {}, {}
    rigs = [j_rig.CameraRig(ref_camera_id=1), t_rig.CameraRig(ref_camera_id=1)]
    obs = []
    for Rs, ts, xy in ((R1, t1, xy1), (R2, t2, xy2)):
        o = []
        for k in range(len(xy)):
            key = tuple(np.round(Rs[k].reshape(-1), 6))
            if key not in ids:
                ids[key] = len(ids) + 1
                for rig in rigs:
                    rig.add_camera(ids[key], np_rotmat_to_quat(Rs[k]), ts[k])
                cams[ids[key]] = (f, f, 0.0, 0.0)
            o.append((ids[key], (f * xy[k, 0], f * xy[k, 1])))
        obs.append(o)
    ref = j_rig.estimate_snapshot_relative_pose(rigs[0], cams, *obs)
    got = t_rig.estimate_snapshot_relative_pose(
        rigs[1], cams, *obs, device="cpu", draw_fn=sba_gr6p_draws(40))
    assert got.success and ref.success
    np.testing.assert_array_equal(got.inlier_mask, ref.inlier_mask)
    np.testing.assert_allclose(got.R, ref.R, rtol=0, atol=1e-12)
    dR = got.R @ R_true.T
    assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 1


# ---------------------------------------------------------------------------
# generalized absolute pose
# ---------------------------------------------------------------------------

def test_generalized_absolute_pose_matches_sba_tpu():
    """tests/test_generalized_pose.py's recovery with sba_tpu's draws:
    the pose at 1e-9, the same inliers (the outliers out)."""
    p3, p2, cc, rq, rt, gt_q, gt_t, bad = _make_rig_problem()
    key = jax.random.PRNGKey(0)
    ropt = dict(max_error=0.01, confidence=0.999, min_num_trials=500)
    ref = j_gp.estimate_generalized_absolute_pose(
        key, p3, p2, cc, rq, rt, options=j_gp.GeneralizedAbsolutePoseOptions(
            ransac=j_ransac.RANSACOptions(**ropt)))
    opt = t_gp.GeneralizedAbsolutePoseOptions(ransac=RANSACOptions(**ropt))
    samples = np_(j_ransac.draw_samples(
        key, p3.shape[0], j_ransac.num_required_trials(3, opt.ransac), 3))
    got = t_gp.estimate_generalized_absolute_pose(
        *(T(np_(a)) for a in (p3, p2, cc, rq, rt)), options=opt,
        samples=samples)
    np.testing.assert_allclose(np_(got.qvec), np_(ref.model[0]), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(np_(got.tvec), np_(ref.model[1]), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(np_(got.inlier_mask),
                                  np_(ref.inlier_mask))
    assert not np_(got.inlier_mask)[bad].any()
    np.testing.assert_allclose(np_(got.tvec), gt_t, atol=1e-3)


def test_refine_generalized_absolute_pose_matches_sba_tpu():
    p3, p2, cc, rq, rt, gt_q, gt_t, _bad = _make_rig_problem(n_outliers=0)
    rng = np.random.default_rng(3)
    q0 = gt_q + rng.normal(scale=0.02, size=4)
    q0 /= np.linalg.norm(q0)
    t0 = gt_t + rng.normal(scale=0.05, size=3)
    ref = j_gp.refine_generalized_absolute_pose(
        jnp.asarray(q0), jnp.asarray(t0), p3, p2, cc, rq, rt)
    got = t_gp.refine_generalized_absolute_pose(
        T(q0), T(t0), *(T(np_(a)) for a in (p3, p2, cc, rq, rt)))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np_(b), np_(a), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_(got[1]), gt_t, atol=1e-5)
