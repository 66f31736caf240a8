"""The port's SPMD solvers (`sba_tpu_torch.parallel`, the sharded pose
graph) against sba_tpu's on the CPU.

- One rank (a gloo world of this process alone): every sharded solve
  equals its single-device counterpart in the port bit for bit (SBA,
  GSBA and the pose graph are held so in their own test files).
- Two ranks (spawned gloo processes, `run_ranks`; their bodies in
  tests/torch_parallel_ranks.py import the port alone): each solver
  against sba_tpu's own sharded function on a 2-device mesh, on the
  scenes of tests/test_distributed_{ba,sba,gsba}.py and
  tests/test_pose_graph.py, uneven and padded cases included; float64
  at sba_tpu's tolerances (qvecs 1e-6, tvecs 1e-5, points 1e-4, final
  cost under 1e-10), float32 fused costs at rtol 1e-3. Both ranks
  return the same bits.
- The host layouts of the shards equal sba_tpu's arrays exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as ranks
from sba_tpu.optim import ba as jba
from sba_tpu.optim import ba_fused as jbf
from sba_tpu.optim import gsba as jg
from sba_tpu.optim import pose_graph as jpg
from sba_tpu.optim import sba as jsba
from sba_tpu.parallel import ba_fused_spmd as jfs
from sba_tpu.parallel import distributed_ba as jdba
from sba_tpu.parallel import gsba_spmd as jgs
from sba_tpu.parallel import sba_spmd as jss
from sba_tpu.utils.synthetic import make_ba_problem as j_make_ba_problem
from sba_tpu.utils.synthetic import make_gsba_scene, make_sba_scene
from sba_tpu_torch import parallel
from sba_tpu_torch.optim import ba as tba
from sba_tpu_torch.optim import ba_fused as tbf
from sba_tpu_torch.optim import pose_graph as tpg
from sba_tpu_torch.parallel import ba_fused_spmd as tfs
from sba_tpu_torch.parallel import distributed_ba as tdba
from sba_tpu_torch.parallel import group
from sba_tpu_torch.parallel import gsba_spmd as tgs
from test_pose_graph import _make_ring

torch.set_num_threads(1)


def _mesh(axis):
    return Mesh(np.array(jax.devices()[:2]), (axis,))


def _fields(p):
    return {k: np.asarray(v) for k, v in p._asdict().items()
            if v is not None}


def _two_ranks(cases, tmp_path):
    """{name: (problem fields, summary fields)} of `cases` solved sharded
    over 2 gloo ranks; asserts that the ranks returned the same bits."""
    r0, r1 = group.run_ranks(ranks.solve_cases, 2, "gloo", "cpu",
                             args=(cases,), timeout=120,
                             store_dir=str(tmp_path))
    for name in cases:
        for part in (0, 1):
            for k, v in r0[name][part].items():
                np.testing.assert_array_equal(
                    v, r1[name][part][k], err_msg=f"{name} {k}: ranks part")
    return {name: r0[name][:2] for name in cases}


def _ba_scene(seed, dtype=np.float64, mask_every=0, drop=0, **kw):
    problem, _ = j_make_ba_problem(seed=seed, dtype=dtype, **kw)
    if drop:
        problem = problem._replace(**{
            f: getattr(problem, f)[:-drop] for f in
            ("obs_image", "obs_point", "obs_cam", "obs_xy", "obs_mask")})
    if mask_every:
        mask = np.asarray(problem.obs_mask).copy()
        mask[::mask_every] = 0.0
        problem = problem._replace(obs_mask=jnp.asarray(mask))
    return problem


def _opt_kw(opt, cls):
    return {f: getattr(opt, f) for f in cls.__dataclass_fields__
            if hasattr(opt, f) and f != "axis_name"}


def _close_f64(got, ref, final_cost_max=1e-10):
    problem, summary = got
    assert float(summary["final_cost"]) < final_cost_max
    for f, tol in (("qvecs", 1e-6), ("tvecs", 1e-5), ("points", 1e-4)):
        np.testing.assert_allclose(problem[f], np.asarray(getattr(ref, f)),
                                   atol=tol, err_msg=f)


# ---------------------------------------------------------------------------
# One rank: bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    with group.single_rank(store_dir=str(tmp_path)):
        yield


def _port(problem, dtype=None):
    return tba.problem_from_numpy(_fields(problem), device="cpu",
                                  dtype=dtype)


def _assert_same(a, b, fields=("qvecs", "tvecs", "points", "cam_params")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("mode", ["dense", "implicit"])
def test_one_rank_fused_is_the_single_device_solve(one_rank, mode):
    """`distributed_bundle_adjust_fused` on one rank: the kernels' twins
    (K1, or K2 and K3, K4, K5) on the whole bucket layout, every
    all-reduce the identity."""
    problem = _port(_ba_scene(23, np.float32, num_images=6, num_points=150,
                              observations_per_point=4, pose_noise=0.01,
                              point_noise=0.05), torch.float32)
    opt = tba.BAOptions(max_iterations=8, dtype="float32", schur_bf16=False,
                        fused_mode=mode)
    ref, rs = tbf.bundle_adjust_fused(problem, opt)
    out, s = parallel.distributed_bundle_adjust_fused(problem, opt)
    _assert_same(out, ref)
    assert s.num_iterations == rs.num_iterations
    assert torch.equal(s.final_cost, rs.final_cost)


@pytest.mark.parametrize("solver", ["schur_pcg", "explicit_schur",
                                    "point_sharded"])
def test_one_rank_f64_is_the_single_device_solve(one_rank, solver):
    """The observation-sharded PCG and COO explicit solves against
    `_bundle_adjust_impl` on the same table, and the point-sharded solve
    against the same point-major layout on one device."""
    problem = _port(_ba_scene(11, num_images=6, num_points=80,
                              pose_noise=0.02, point_noise=0.05))
    if solver == "point_sharded":
        opt = tba.BAOptions(solver="explicit_schur", max_iterations=10,
                            obs_layout="point_major")
        sharded, perm = tdba.shard_problem_by_points(problem, 1)
        ref, rs = tba._bundle_adjust_impl(sharded, opt)
        ref = ref._replace(points=ref.points[torch.argsort(perm)])
        out, s = parallel.distributed_bundle_adjust_pm(problem, opt)
    else:
        opt = tba.BAOptions(solver=solver, max_iterations=10)
        ref, rs = tba._bundle_adjust_impl(problem, opt)
        out, s = parallel.distributed_bundle_adjust(problem, opt)
    _assert_same(out, ref)
    assert s.num_iterations == rs.num_iterations
    assert torch.equal(s.final_cost, rs.final_cost)
    assert torch.equal(s.num_residuals, rs.num_residuals)


# ---------------------------------------------------------------------------
# Two ranks against sba_tpu's 2-device mesh
# ---------------------------------------------------------------------------

def test_two_ranks_fused_match_sba_tpu(tmp_path):
    """tests/test_distributed_ba.py's fused scenes: the dense path (K1)
    and, gauge and masked observations, the implicit one (K2, K3), against
    sba_tpu's interpret-mode kernels on a 2-device mesh. The dense scene
    is noise-free: both solves reach float32's rounding floor (~5e-8),
    where both must have fallen by 1e-4. The implicit scene's pixels
    carry 0.5 px of noise, so that its final cost lies far above that
    floor and is compared at rtol 1e-3. The states at sba_tpu's own
    tolerances (tvecs 1e-4, points 1e-3)."""
    cases = {
        "dense": (_ba_scene(23, np.float32, num_images=6, num_points=150,
                            observations_per_point=4, pose_noise=0.01,
                            point_noise=0.05),
                  jba.BAOptions(max_iterations=20, dtype="float32",
                                schur_bf16=False)),
        "implicit": (_ba_scene(24, np.float32, mask_every=13, num_images=5,
                               num_points=90, observations_per_point=4,
                               pose_noise=0.02, point_noise=0.03,
                               pixel_noise=0.5),
                     jba.BAOptions(max_iterations=15, dtype="float32",
                                   schur_bf16=False, fused_mode="implicit")),
    }
    got = _two_ranks({k: ("fused", _fields(p), _opt_kw(o, tba.BAOptions))
                      for k, (p, o) in cases.items()}, tmp_path)
    for name, (p, o) in cases.items():
        ref, rs = jfs.distributed_bundle_adjust_fused(p, o, _mesh("obs"),
                                                      interpret=True)
        prob, summ = got[name]
        np.testing.assert_allclose(summ["initial_cost"],
                                   float(rs.initial_cost), rtol=1e-5)
        if name == "dense":
            assert summ["final_cost"] < 1e-4 * summ["initial_cost"]
            assert float(rs.final_cost) < 1e-4 * float(rs.initial_cost)
        else:
            np.testing.assert_allclose(summ["final_cost"],
                                       float(rs.final_cost), rtol=1e-3)
        np.testing.assert_allclose(prob["tvecs"], np.asarray(ref.tvecs),
                                   atol=1e-4)
        np.testing.assert_allclose(prob["points"], np.asarray(ref.points),
                                   atol=1e-3)


def test_two_ranks_observation_sharded_match_sba_tpu(tmp_path):
    """`distributed_bundle_adjust`: an even table, and one cut to an odd
    count (padded rows)."""
    cases = {
        "even": (_ba_scene(11, num_images=6, num_points=80, pose_noise=0.02,
                           point_noise=0.05),
                 jba.BAOptions(solver="schur_pcg", max_iterations=30)),
        "uneven": (_ba_scene(13, drop=3, num_images=5, num_points=61,
                             pose_noise=0.02, point_noise=0.02),
                   jba.BAOptions(max_iterations=30)),
    }
    assert cases["uneven"][0].obs_image.shape[0] % 2 == 1
    got = _two_ranks({k: ("obs", _fields(p), _opt_kw(o, tba.BAOptions))
                      for k, (p, o) in cases.items()}, tmp_path)
    for name, (p, o) in cases.items():
        ref, _ = jdba.distributed_bundle_adjust(p, o, _mesh("obs"))
        _close_f64(got[name], ref)
        assert got[name][0]["obs_image"].shape[0] % 2 == 0


def test_two_ranks_point_sharded_match_sba_tpu(tmp_path):
    """`distributed_bundle_adjust_pm`: 83 points, and 61 points with
    every 17th observation masked."""
    cases = {
        "even": (_ba_scene(21, num_images=6, num_points=83, pose_noise=0.02,
                           point_noise=0.05), 1e-10),
        "masked": (_ba_scene(22, mask_every=17, num_images=5, num_points=61,
                             pose_noise=0.02, point_noise=0.03), 1e-8),
    }
    opt = jba.BAOptions(solver="explicit_schur", max_iterations=30)
    got = _two_ranks({k: ("pm", _fields(p), _opt_kw(opt, tba.BAOptions))
                      for k, (p, _) in cases.items()}, tmp_path)
    for name, (p, limit) in cases.items():
        ref, _ = jdba.distributed_bundle_adjust_pm(p, opt, _mesh("obs"))
        _close_f64(got[name], ref, limit)


def test_two_ranks_sba_match_sba_tpu(tmp_path):
    """tests/test_distributed_sba.py's scenes in float32 (the joint
    map-gather path): 6 images, and 4 images with one of their 12 pairs
    dropped (an odd count, padded)."""
    _, _, cam, depth, sem, qn, tn = make_sba_scene(
        num_images=6, image_size=(64, 48), pose_noise=0.01, seed=5)
    opt = jsba.SBAOptions(pixel_step=4, max_iterations=10)
    even = jsba.build_sba_problem(qn, tn, cam, depth, sem, opt,
                                  dtype=jnp.float32)
    _, _, cam, depth, sem, qn, tn = make_sba_scene(
        num_images=4, image_size=(64, 48), pose_noise=0.005, seed=2)
    pairs = [(i, j) for i in range(4) for j in range(4) if i != j][:-1]
    opt_odd = jsba.SBAOptions(pixel_step=4, max_iterations=5)
    odd = jsba.build_sba_problem(qn, tn, cam, depth, sem, opt_odd,
                                 pairs=pairs, dtype=jnp.float32)
    cases = {"even": (even, opt), "odd": (odd, opt_odd)}
    from sba_tpu_torch.optim.sba import SBAOptions

    got = _two_ranks({k: ("sba", _fields(p), _opt_kw(o, SBAOptions))
                      for k, (p, o) in cases.items()}, tmp_path)
    for name, (p, o) in cases.items():
        ref, rs = jss.semantic_bundle_adjust_spmd(p, o, _mesh("sba_pairs"))
        prob, summ = got[name]
        np.testing.assert_allclose(summ["initial_cost"],
                                   float(rs.initial_cost), rtol=1e-5)
        np.testing.assert_allclose(summ["final_cost"], float(rs.final_cost),
                                   rtol=1e-3)
        np.testing.assert_allclose(prob["qvecs"], np.asarray(ref.qvecs),
                                   atol=1e-4)
        np.testing.assert_allclose(prob["tvecs"], np.asarray(ref.tvecs),
                                   atol=1e-3)
        assert int(summ["num_residuals"]) == int(rs.num_residuals)
        assert prob["pair_src"].shape[0] % 2 == 0


def _gsba_landmark_problem():
    """tests/test_distributed_gsba.py's landmark scene at 5 images (an
    odd count: one padded image), float64."""
    from sba_tpu.geometry.quaternions import quat_rotate

    q_gt, t_gt, cam, sem, cyl, q0, t0, cyl0 = make_gsba_scene(
        num_images=5, image_size=(96, 72), pose_noise=0.008,
        cylinder_noise=0.04, seed=6)
    rng = np.random.default_rng(1)
    pts = rng.uniform([-2, -2, -1], [2, 2, 1], size=(25, 3))
    obs_image, obs_point, obs_xy = [], [], []
    for i in range(5):
        pc = np.array(quat_rotate(jnp.asarray(q_gt[i]),
                                  jnp.asarray(pts))) + t_gt[i]
        obs_image += [i] * len(pts)
        obs_point += list(range(len(pts)))
        obs_xy.append(cam[i, 0] * pc[:, :2] / pc[:, 2:3] + cam[i, 1:3])
    obs = (np.array(obs_image, np.int32), np.array(obs_point, np.int32),
           np.concatenate(obs_xy))
    opt = jg.GSBAOptions(mode="soft", max_iterations=8,
                         landmark_error_weight=10.0)
    return jg.build_gsba_problem(np.asarray(q0), np.asarray(t0), cam, sem,
                                 [cyl0], opt, points=pts, obs=obs), opt


def test_two_ranks_gsba_match_sba_tpu(tmp_path):
    """GSBA with the landmark term, images and their observations
    sharded: costs, poses, cylinder and points at 1e-6, per-image IoU."""
    from sba_tpu_torch.optim.gsba import GSBAOptions

    p, o = _gsba_landmark_problem()
    got = _two_ranks({"gsba": ("gsba", _fields(p), _opt_kw(o, GSBAOptions))},
                     tmp_path)
    ref, rs = jgs.geometric_semantic_bundle_adjust_spmd(
        p, o, _mesh("gsba_images"))
    prob, summ = got["gsba"]
    for f in ("initial_cost", "final_cost", "mean_iou"):
        np.testing.assert_allclose(summ[f], float(getattr(rs, f)),
                                   rtol=1e-6, err_msg=f)
    for f in ("qvecs", "tvecs", "cyl_tvec", "cyl_log_radius", "points"):
        np.testing.assert_allclose(prob[f], np.asarray(getattr(ref, f)),
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(summ["per_image_iou"],
                               np.asarray(rs.per_image_iou), atol=1e-6)
    assert prob["qvecs"].shape == (5, 4)


def test_two_ranks_pose_graph_match_sba_tpu(tmp_path):
    """tests/test_pose_graph.py:150's SE3 ring (17 edges: one padded)."""
    cases = {"se3": (_make_ring(n=16, noise=0.07, seed=13),
                     jpg.PoseGraphOptions(max_iterations=40))}
    got = _two_ranks({k: ("pose_graph", _fields(p),
                          _opt_kw(o, tpg.PoseGraphOptions))
                      for k, ((p, _), o) in cases.items()}, tmp_path)
    for name, ((p, _), o) in cases.items():
        ref, rs = jpg.distributed_optimize_pose_graph(p, o, _mesh("edges"))
        prob, summ = got[name]
        assert float(summ["final_cost"]) < 1e-10
        for f in ("qvecs", "tvecs", "log_scales"):
            np.testing.assert_allclose(prob[f], np.asarray(getattr(ref, f)),
                                       atol=1e-6, err_msg=f)
        assert prob["edge_i"].shape[0] % 2 == 0
        assert int(summ["num_residuals"]) == int(rs.num_residuals)


def test_run_ranks_fails_when_a_rank_fails(tmp_path):
    """A rank that raises fails the call (with its traceback), and the
    rank left waiting in a collective is stopped."""
    with pytest.raises(RuntimeError, match="failed"):
        group.run_ranks(ranks.fail_on_rank_one, 2, "gloo", "cpu",
                        timeout=60, store_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# Host layouts of the shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 3])
def test_shard_problem_by_points_equals_sba_tpu(n_shards):
    p = _ba_scene(22, mask_every=17, num_images=5, num_points=61,
                  pose_noise=0.02, point_noise=0.03)
    jsh, jperm = jdba.shard_problem_by_points(p, n_shards)
    tsh, tperm = tdba.shard_problem_by_points(_port(p), n_shards)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    for f in ("points", "free_points", "obs_image", "obs_point", "obs_cam",
              "obs_xy", "obs_mask", "image_cam"):
        np.testing.assert_array_equal(getattr(tsh, f).numpy(),
                                      np.asarray(getattr(jsh, f)), f)


def test_observation_shards_equal_sba_tpu():
    """`pad_observations` as sba_tpu's, and the ranks' `shard_problem`
    slices put end to end give it back."""
    p = _ba_scene(13, drop=3, num_images=5, num_points=61, pose_noise=0.02)
    jpad = jdba.pad_observations(p, 2)
    tpad = tdba.pad_observations(_port(p), 2)
    fields = ("obs_image", "obs_point", "obs_cam", "obs_xy", "obs_mask")
    for f in fields:
        np.testing.assert_array_equal(getattr(tpad, f).numpy(),
                                      np.asarray(getattr(jpad, f)), f)
    parts = [tdba.shard_problem(_port(p), SimpleNamespace(size=2, rank=r))
             for r in range(2)]
    for f in fields:
        np.testing.assert_array_equal(
            torch.cat([getattr(q, f) for q in parts]).numpy(),
            np.asarray(getattr(jpad, f)), f)


def test_gsba_image_shards_equal_sba_tpu():
    """`_pad_images` and `_shard_observations` as sba_tpu's, over 2 and 4
    ranks (5 images: one and three padded)."""
    from sba_tpu_torch.optim.gsba import gsba_problem_from_numpy

    p, _ = _gsba_landmark_problem()
    tp = gsba_problem_from_numpy(_fields(p), device="cpu")
    for ndev in (2, 4):
        jpad = jgs._pad_images(p, ndev)
        tpad = tgs._pad_images(tp, ndev)
        jsh, jn = jgs._shard_observations(jpad, ndev)
        tsh, tn = tgs._shard_observations(tpad, ndev)
        assert tn == jn
        for f in ("qvecs", "tvecs", "cam_params", "sem_masks", "free_rot",
                  "free_trans", "img_weight", "obs_image", "obs_point",
                  "obs_xy", "obs_mask"):
            np.testing.assert_array_equal(getattr(tsh, f).numpy(),
                                          np.asarray(getattr(jsh, f)), f)


def test_shard_edges_padding_equals_sba_tpu():
    """`shard_edges` pads the 17 edges of the SE3 ring as sba_tpu's does
    over 2 and 4 ranks."""
    p, _ = _make_ring(n=16, noise=0.07, seed=13)
    tp = ranks._pose_graph(_fields(p), "cpu")
    for ndev in (2, 4):
        jsh = jpg.shard_edges(p, Mesh(np.array(jax.devices()[:ndev]),
                                      ("edges",)))
        tsh = tpg.shard_edges(tp, SimpleNamespace(size=ndev))
        for f in tpg._EDGES:
            np.testing.assert_array_equal(getattr(tsh, f).numpy(),
                                          np.asarray(getattr(jsh, f)), f)


def test_padded_bucket_layouts_equal_sba_tpu():
    """The fused path's buckets with their blocks padded to a multiple of
    2: the layouts, point orders and lane tables of sba_tpu's (float32
    lanes as sba_tpu's rows), and each rank's blocks its shard."""
    p = _ba_scene(23, np.float32, num_images=6, num_points=300,
                  observations_per_point=4, pose_noise=0.01)
    jopt = jba.BAOptions(max_iterations=1, dtype="float32")
    jb = jbf._bucketize(jbf.prepare(p, jopt)[4], jopt, block_multiple=2)
    tb = tbf._bucketize(tba.problem_to_numpy(tbf.prepare(
        _port(p, torch.float32), tba.BAOptions())[4]), tba.BAOptions(),
        "cpu", block_multiple=2)
    assert len(tb) == len(jb)
    for (tst, tlay, tidx), (jst, jlay, jidx) in zip(tb, jb):
        for f in ("TP", "K", "nb", "Pp", "N", "Npad", "C", "nparams", "Dk"):
            assert getattr(tlay, f) == getattr(jlay, f), f
        assert tlay.nb % 2 == 0
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_array_equal(tst.obs_img.numpy(),
                                      np.asarray(jst.obs_img)[0])
        np.testing.assert_array_equal(tst.obs_sta.numpy(),
                                      np.asarray(jst.obs_sta)[:3])
        np.testing.assert_array_equal(tst.free_pts.numpy(),
                                      np.asarray(jst.free_pts)[0])
        for r in range(2):
            loc = tfs._shard_static(tst, tlay, r, 2)
            half = np.split(np.asarray(jst.obs_img)[0], 2)[r]
            np.testing.assert_array_equal(loc.obs_img.numpy(), half)
