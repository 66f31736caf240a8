"""Tests of the port that need an NVIDIA card (marker `cuda`).

They skip where torch sees no CUDA device. On the card (where JAX is not
installed) run them without the repository's JAX conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sba_tpu_torch.mvs import patch_match as pm
from sba_tpu_torch.ops import ba_kernels as bk
from sba_tpu_torch.ops import patch_match_kernels as pk
from sba_tpu_torch.optim import ba_fused
from sba_tpu_torch.optim.ba import BAOptions, bundle_adjust
from sba_tpu_torch.utils.synthetic import make_ba_problem

pytestmark = pytest.mark.cuda

_SMALL = dict(num_images=6, num_points=150, observations_per_point=4,
              pose_noise=0.01, point_noise=0.05, pixel_noise=0.5, seed=0)
# tests/test_ba_fused.py's small distortion per camera model.
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
# Offsets (u = v) from image 0's principal point of `_near_axis`'s points:
# on the axis, under and over the fisheye guard r < 1e-8, under and over
# FOV's r^2 < 1e-4.
_NEAR_AXIS = (0.0, 3e-9, 2e-8, 4e-3, 6.5e-3, 9e-3)


def _model_problem(device, model_id, center=False, free_cam=True, **kw):
    """The small scene observed through camera model `model_id` with
    `_DISTORT`'s terms, every camera parameter free (`free_cam`, else
    all constant); with `center`,
    image 0 at the identity pose and one point it sees on each ray of
    `_NEAR_AXIS`."""
    from sba_tpu_torch.geometry import camera_models

    params = np.array(camera_models.model_by_id(model_id).init_params(
        500.0, 640, 480), np.float64)
    for i, val in _DISTORT.get(model_id, {}).items():
        params[i] = val
    problem, _ = make_ba_problem(dtype=torch.float32, device=device,
                                 model_id=model_id, params=params,
                                 **dict(_SMALL, **kw))
    if free_cam:
        problem = problem._replace(
            free_cam=torch.ones_like(problem.free_cam))
    if not center:
        return problem
    oi = problem.obs_image.cpu().numpy()
    seen = np.unique(problem.obs_point.cpu().numpy()[oi == 0])
    pts = problem.points.clone()
    for p, e in zip(seen, _NEAR_AXIS):
        depth = 8.0 + p % 3
        pts[p] = torch.tensor([e * depth, e * depth, depth])
    q, t = problem.qvecs.clone(), problem.tvecs.clone()
    q[0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    t[0] = 0.0
    return problem._replace(qvecs=q, tvecs=t, points=pts)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


def _check_dense_kernels(cuda, problem, opt):
    """K1, K4 and K5 against their twins on the problem's buckets."""
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    lam = torch.tensor(1e-3, device=cuda)
    for st, lay, pts in zip(statics, lays, pts0):
        k1 = bk.fused_schur(st, par, pts, lam, lay, opt)
        p1 = bk.fused_schur_plain(st, par, pts, lam, lay, opt)
        for name, a, b, tol in zip(("S", "img_red", "ey", "pt_pay", "jw"),
                                   k1, p1, (3e-5, 1e-5, 3e-5, 1e-4, 1e-4)):
            assert _rel_err(a, b) <= tol, name
        dup = 1e-3 * torch.ones(6, lay.Npad, device=cuda)
        duc = 1e-2 * torch.ones(12, lay.C, device=cuda)
        dp_k, acc_k = bk.backsub(st, dup, duc, k1[3], k1[4], lam, lay, opt)
        dp_p, acc_p = bk.backsub_plain(st, dup, duc, k1[3], k1[4], lam, lay,
                                       opt)
        assert _rel_err(dp_k, dp_p) <= 1e-4
        assert _rel_err(acc_k, acc_p) <= 1e-4
        c_k = bk.fused_cost(st, par, pts, lay, opt)
        c_p = bk.fused_cost_plain(st, par, pts, lay, opt)
        assert _rel_err(c_k, c_p) <= 1e-4


@pytest.mark.parametrize("model_id", list(range(11)))
def test_kernels_match_twins(cuda, model_id):
    """K1, K4 and K5 of every camera head against their twins, the
    intrinsics free so that the heads' derivatives fill the camera rows."""
    _check_dense_kernels(cuda, _model_problem(cuda, model_id), BAOptions(
        model_id=model_id, dtype="float32", schur_bf16=False))


@pytest.mark.parametrize("model_id", [5, 7, 8, 9, 10])
def test_heads_near_the_principal_point_match_twins(cuda, model_id):
    """The fisheye and FOV heads' guards: K1, K4 and K5 against their
    twins with points at and near image 0's principal point."""
    _check_dense_kernels(cuda, _model_problem(cuda, model_id, center=True),
                         BAOptions(model_id=model_id, dtype="float32",
                                   schur_bf16=False))


@pytest.mark.parametrize("model_id", list(range(3, 11)))
def test_implicit_kernels_match_twins_per_model(cuda, model_id):
    """K2-K5 of camera models 3-10 against their twins on the implicit
    path: K2 in its diagonal payload mode for the 5-parameter models,
    its 6x6 block mode for the others."""
    problem = _model_problem(cuda, model_id)
    opt = BAOptions(model_id=model_id, dtype="float32",
                    fused_mode="implicit")
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    lam = torch.tensor(1e-3, device=cuda)
    for st, lay, pts in zip(statics, lays, pts0):
        assert lay.BJ == (lay.nparams != 5)
        k2 = bk.fused_reduce(st, par, pts, lam, lay, opt)
        p2 = bk.fused_reduce_plain(st, par, pts, lam, lay, opt)
        for name, a, b in zip(("img_red", "pt_pay", "jw", "jcorr"), k2, p2):
            assert _rel_err(a.float(), b.float()) <= 1e-4, name
        dup = 1e-3 * torch.ones(6, lay.Npad, device=cuda)
        duc = 1e-2 * torch.ones(12, lay.C, device=cuda)
        m_k = bk.schur_matvec(st, dup, duc, k2[3], lay, opt)
        m_p = bk.schur_matvec_plain(st, dup, duc, k2[3], lay, opt)
        assert _rel_err(m_k, m_p) <= 3e-5
        dp_k, acc_k = bk.backsub(st, dup, duc, k2[1], k2[2], lam, lay, opt)
        dp_p, acc_p = bk.backsub_plain(st, dup, duc, k2[1], k2[2], lam, lay,
                                       opt)
        assert _rel_err(dp_k, dp_p) <= 1e-4
        assert _rel_err(acc_k, acc_p) <= 1e-4
        c_k = bk.fused_cost(st, par, pts, lay, opt)
        c_p = bk.fused_cost_plain(st, par, pts, lay, opt)
        assert _rel_err(c_k, c_p) <= 1e-4


@pytest.mark.parametrize("ranged", ["off", "on"])
def test_implicit_kernels_match_twins(cuda, ranged):
    """K2 and K3 against their twins, with f32 ("off") and bf16 ("on")
    coupling stores."""
    problem, _ = make_ba_problem(dtype=torch.float32, device=cuda, **_SMALL)
    opt = BAOptions(dtype="float32", fused_mode="implicit",
                    fused_ranged=ranged)
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    lam = torch.tensor(1e-3, device=cuda)
    for st, lay, pts in zip(statics, lays, pts0):
        k2 = bk.fused_reduce(st, par, pts, lam, lay, opt)
        p2 = bk.fused_reduce_plain(st, par, pts, lam, lay, opt)
        jc_tol = 2.0 ** -8 if ranged == "on" else 1e-4
        for name, a, b, tol in zip(("img_red", "pt_pay", "jw", "jcorr"),
                                   k2, p2, (1e-4, 1e-4, 1e-4, jc_tol)):
            assert a.dtype == b.dtype, name
            assert _rel_err(a.float(), b.float()) <= tol, name
        dup = 1e-3 * torch.ones(6, lay.Npad, device=cuda)
        duc = 1e-2 * torch.ones(12, lay.C, device=cuda)
        m_k = bk.schur_matvec(st, dup, duc, k2[3], lay, opt)
        m_p = bk.schur_matvec_plain(st, dup, duc, k2[3], lay, opt)
        assert _rel_err(m_k, m_p) <= 3e-5


def _cost_inputs(problem, opt):
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    return statics, lays, pts0, par


def _check_cost_buckets(statics, lays, pts0, par, opt, reps=20):
    """K5 over all buckets: one launch, the twin's sum at _rel_err 1e-4,
    and the same bits on `reps` calls. Returns the first result."""
    want = bk.fused_cost_buckets_plain(statics, par, pts0, lays, opt)
    bk.reset_launches()
    outs = [bk.fused_cost_buckets(statics, par, pts0, lays, opt)
            for _ in range(reps)]
    torch.cuda.synchronize()
    assert bk.LAUNCHES["fused_cost"] == reps
    assert outs[0].shape == () and outs[0].dtype == torch.float32
    assert _rel_err(outs[0], want) <= 1e-4
    assert all(torch.equal(o, outs[0]) for o in outs)
    return outs[0]


@pytest.mark.parametrize("model_id", list(range(11)))
def test_fused_cost_buckets_match_twin_and_repeat_bits(cuda, model_id):
    """K5 over the three buckets of a 12-image scene in one launch, with
    the parameter table staged in shared memory: every camera head
    against its twin, bit-identical over 20 calls, and the one-bucket
    `fused_cost` (the same kernel) against each bucket's twin."""
    problem = _model_problem(cuda, model_id, num_images=12, num_points=300,
                             observations_per_point=5)
    opt = BAOptions(model_id=model_id, dtype="float32", loss="cauchy",
                    loss_scale=2.0)
    statics, lays, pts0, par = _cost_inputs(problem, opt)
    assert len(lays) == 3 and bk.k5_stages_par(par, lays[0])
    _check_cost_buckets(statics, lays, pts0, par, opt)
    for st, lay, pts in zip(statics, lays, pts0):
        c_k = bk.fused_cost(st, par, pts, lay, opt)
        assert _rel_err(c_k, bk.fused_cost_plain(st, par, pts, lay, opt)) \
            <= 1e-4


@pytest.mark.parametrize("model_id, num_images", [(0, 6000), (6, 3100)])
def test_fused_cost_buckets_read_par_in_place(cuda, model_id, num_images):
    """K5 where the parameter table [7+np, Npad] passes the shared-memory
    opt-in limit (SIMPLE_PINHOLE at 6,000 images, FULL_OPENCV at 3,100):
    the kernel reads it in place, against its twin and bit-identical
    over 20 calls."""
    problem = _model_problem(cuda, model_id, num_images=num_images,
                             num_points=3000, observations_per_point=5)
    opt = BAOptions(model_id=model_id, dtype="float32")
    statics, lays, pts0, par = _cost_inputs(problem, opt)
    assert not bk.k5_stages_par(par, lays[0])
    _check_cost_buckets(statics, lays, pts0, par, opt)


def test_fused_cost_buckets_with_dead_buckets(cuda):
    """K5 with one bucket whose lanes are all masked out, and with every
    bucket so: the twin's sum (0 when all are dead), bit-identical over
    20 calls."""
    problem, _ = make_ba_problem(dtype=torch.float32, device=cuda,
                                 **dict(_SMALL, num_images=12,
                                        num_points=300,
                                        observations_per_point=5))
    opt = BAOptions(dtype="float32")
    statics, lays, pts0, par = _cost_inputs(problem, opt)
    assert len(lays) == 3
    for dead in ({1}, {0, 1, 2}):
        sts = [st._replace(obs_sta=torch.cat([st.obs_sta[:2],
                                              0 * st.obs_sta[2:]]))
               if b in dead else st for b, st in enumerate(statics)]
        got = _check_cost_buckets(sts, lays, pts0, par, opt)
        assert (float(got) == 0.0) == (len(dead) == 3)


def test_fused_cost_buckets_on_two_streams(cuda):
    """K5 launched in turn on two streams, each with its own workspace,
    40 calls in flight at once: every result has the bits of a call on
    the default stream, and later calls on the default stream too."""
    problem, _ = make_ba_problem(dtype=torch.float32, device=cuda,
                                 **dict(_SMALL, num_images=12,
                                        num_points=300,
                                        observations_per_point=5))
    opt = BAOptions(dtype="float32")
    statics, lays, pts0, par = _cost_inputs(problem, opt)
    want = bk.fused_cost_buckets(statics, par, pts0, lays, opt)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(20):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(bk.fused_cost_buckets(statics, par, pts0, lays,
                                                  opt))
    torch.cuda.synchronize()
    assert len({w.data_ptr() for w in bk._K5_WORK.values()}) >= 3
    assert all(torch.equal(o, want) for o in outs)
    assert torch.equal(bk.fused_cost_buckets(statics, par, pts0, lays, opt),
                       want)


def test_fused_solve_on_card_matches_cpu_twins(cuda):
    """The card's f32 solve ends at the CPU twins' cost (rtol 1e-3), as
    the f32 sums report it and as one float64 evaluation on the CPU of
    each final state does. The final poses are not compared coordinate
    by coordinate: this 6-image problem has a flat mode that float32
    does not resolve. The twins alone move their translations by up to
    2.3e-3, at a cost within 6.1e-5, when the points are perturbed by
    1e-6 relative (20 perturbations), and the order of K1's float
    atomics moves the card's by 6e-6 to 4.7e-3 from the CPU's at a cost
    within 5.1e-5 (32 card runs): `python -m
    sba_tpu_torch.utils.card_repeat [--runs 0] --witness 20`; ROADMAP
    Queue 3."""
    from sba_tpu_torch.optim.ba import evaluate_cost

    opt = BAOptions(max_iterations=10, dtype="float32")
    gpu, _ = make_ba_problem(dtype=torch.float32, device=cuda, **_SMALL)
    cpu, _ = make_ba_problem(dtype=torch.float32, device="cpu", **_SMALL)
    bk.reset_launches()
    out_g, s_g = bundle_adjust(gpu, opt)
    # The dense path (6 images): K1, K4 and K5, not the implicit K2/K3.
    assert all(bk.LAUNCHES[k] > 0
               for k in ("fused_schur", "backsub", "fused_cost"))
    assert bk.LAUNCHES["fused_reduce"] == bk.LAUNCHES["schur_matvec"] == 0
    out_c, s_c = ba_fused.bundle_adjust_fused(cpu, opt)
    assert abs(float(s_g.final_cost) - float(s_c.final_cost)) \
        <= 1e-3 * float(s_c.final_cost)

    def cost64(out):
        p = type(out)(*[None if v is None else v.cpu().double()
                        if v.is_floating_point() else v.cpu()
                        for v in out])
        return float(evaluate_cost(p, BAOptions()))

    c_g, c_c = cost64(out_g), cost64(out_c)
    assert c_g < cost64(cpu)
    assert abs(c_g - c_c) <= 1e-3 * c_c
    assert bool(torch.isfinite(out_g.tvecs).all())


def test_unported_pieces_raise_on_card(cuda):
    """An OPENCV (model 4) solve, which raised before its head was
    ported, runs on the card through K1, K4 and K5 and ends at the CPU
    twins' final cost (rtol 1e-3). The intrinsics stay constant, as in
    the SIMPLE_PINHOLE solve above: with them free this 6-image problem
    has a flat mode (focal length against distortion) that 50 LM
    iterations do not settle, and two solves stop at different points
    of it; with them constant both converge by 25. More than 128 images
    run the implicit path through K2 and K3."""
    opt = BAOptions(model_id=4, max_iterations=25, dtype="float32")
    bk.reset_launches()
    _, s_g = bundle_adjust(_model_problem(cuda, 4, free_cam=False), opt)
    assert all(bk.LAUNCHES[k] > 0
               for k in ("fused_schur", "backsub", "fused_cost"))
    _, s_c = ba_fused.bundle_adjust_fused(
        _model_problem("cpu", 4, free_cam=False), opt)
    assert float(s_g.final_cost) < float(s_g.initial_cost)
    assert abs(float(s_g.final_cost) - float(s_c.final_cost)) \
        <= 1e-3 * float(s_c.final_cost)
    # More than 128 images: no longer raises, but runs the implicit
    # path through K2 and K3.
    big, _ = make_ba_problem(dtype=torch.float32, device=cuda,
                             **dict(_SMALL, num_images=130))
    bk.reset_launches()
    _, s = bundle_adjust(big, BAOptions(dtype="float32", max_iterations=5))
    assert float(s.final_cost) < float(s.initial_cost)
    assert bk.LAUNCHES["fused_reduce"] > 0 and bk.LAUNCHES["schur_matvec"] > 0
    assert bk.LAUNCHES["fused_schur"] == 0


@pytest.mark.parametrize("r", [3, 5])
def test_ncc_kernel_matches_twin(cuda, r):
    """K6 against its twin at 480x640 x 4 sources, atol 2e-4 (the
    reference's kernel-vs-XLA tolerance), with bands outside the
    sources."""
    gen = torch.Generator().manual_seed(r)
    ref = torch.rand(480, 640, generator=gen)
    v = torch.rand(4, 480, 640, generator=gen)
    inb = torch.ones(4, 480, 640, dtype=torch.bool)
    inb[1, :, :50] = False
    inb[2, 400:] = False
    v = torch.where(inb, v, torch.zeros_like(v))
    ref, v, inb = ref.to(cuda), v.to(cuda), inb.to(cuda)
    pk.reset_launches()
    c_k = pk.ncc_cost(ref, v, inb, r, 1, 3.0, 0.2)
    c_p = pk.ncc_cost_plain(ref, v, inb, r, 1, 3.0, 0.2)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["ncc_cost"] == 1
    assert float((c_k - c_p).abs().max()) <= 2e-4
    assert bool((c_k == 2.0).any()) and bool((c_k < 2.0).any())
    with pytest.raises(ValueError, match="float32"):
        pk.ncc_cost(ref.double(), v.double(), inb, r, 1, 3.0, 0.2)


@pytest.mark.parametrize("S", [1, 4, 7, 20])
@pytest.mark.parametrize("r,step", [(3, 1), (5, 1), (3, 2)])
def test_ncc_kernel_bit_equal_to_twin(cuda, S, r, step):
    """K6 equals its twin bit for bit on the same CUDA tensors, for one
    source, a whole chunk of sources, and S past the chunk (7, 20), on a
    481x643 image (not a multiple of the tile), with a flat patch (where
    the NCC's variances cancel) and a band outside the last source, so
    that both outcomes of the half-window gate occur."""
    rng = np.random.default_rng(100 * S + 10 * r + step)
    H, W = 481, 643
    ref = rng.random((H, W), dtype=np.float32)
    ref[200:260, 300:400] = 0.5
    v = rng.random((S, H, W), dtype=np.float32)
    v[:, 200:260, 300:400] = 0.25
    inb = np.ones((S, H, W), dtype=bool)
    inb[S - 1, :, :150] = False
    v[~inb] = 0.0
    ref, v, inb = (torch.as_tensor(a, device=cuda) for a in (ref, v, inb))
    pk.reset_launches()
    c_k = pk.ncc_cost(ref, v, inb, r, step, 3.0, 0.2)
    c_p = pk.ncc_cost_plain(ref, v, inb, r, step, 3.0, 0.2)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["ncc_cost"] == 1
    assert torch.equal(c_k, c_p)
    gated = c_k == 2.0
    assert bool(gated.any()) and bool((~gated).any())
    assert bool(gated[S - 1, :, :140].all())


def _sequential_bucket(device, model_id, ranged, order):
    """The one bucket of a 1024-image sequential scene (20,000 points,
    track 7; SIMPLE_PINHOLE, or PINHOLE for 4 intrinsics), K3's inputs
    on it and K2's outputs. `order` "permuted" maps the image ids
    through `spread_image_ids`, so that every block's window spans
    several chunks."""
    from sba_tpu_torch.optim.ba import problem_from_numpy
    from sba_tpu_torch.utils.synthetic import (
        make_sequential_ba_problem_numpy, spread_image_ids)

    f, _ = make_sequential_ba_problem_numpy(
        num_images=1024, num_points=20_000, track_len=7, seed=4)
    if model_id == 1:
        c = f["cam_params"]
        c[0, :4] = [c[0, 0], c[0, 0], c[0, 1], c[0, 2]]
    problem = problem_from_numpy(f, device, torch.float32)
    opt = BAOptions(model_id=model_id, dtype="float32", fused_ranged=ranged)
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    st, lay, pts = statics[0], lays[0], pts0[0]
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         st.image_cam, lay)
    k2 = bk.fused_reduce(st, par, pts, torch.tensor(1e-3, device=device),
                         lay, opt)
    gen = torch.Generator().manual_seed(5)
    if order == "permuted":
        perm = torch.as_tensor(spread_image_ids(lay.N), device=device)
        st = st._replace(obs_img=perm[st.obs_img.long()].contiguous())
    dup = torch.zeros(6, lay.Npad)
    dup[:, :lay.N] = 1e-3 * torch.randn(6, lay.N, generator=gen)
    duc = torch.zeros(12, lay.C)
    duc[:lay.nparams] = 1e-2 * torch.randn(lay.nparams, lay.C, generator=gen)
    return st, lay, opt, dup.to(device), duc.to(device), k2[3], k2


@pytest.mark.parametrize("order", ["sorted", "permuted"])
@pytest.mark.parametrize("ranged", ["off", "on"])
@pytest.mark.parametrize("model_id", [0, 1])
def test_schur_matvec_windows_match_twin(cuda, model_id, ranged, order):
    """K3 within 3e-5 of its twin (float atomics sum in no fixed order) on
    a sequential scene, whose blocks see narrow image windows, and on the
    same bucket with its image ids permuted, whose every block takes
    several window chunks; f32 and bf16 couplings, 3 and 4 intrinsics."""
    st, lay, opt, dup, duc, jc, _ = _sequential_bucket(cuda, model_id,
                                                       ranged, order)
    assert jc.dtype == (torch.bfloat16 if ranged == "on" else torch.float32)
    assert lay.nparams == (3 if model_id == 0 else 4)
    _, _, chunks = bk.schur_matvec_windows(st, lay)
    live = chunks > 0
    if order == "sorted":
        assert int(chunks.max()) == 1
    else:
        assert bool((chunks[live] > 1).all())
    bk.reset_launches()
    m_k = bk.schur_matvec(st, dup, duc, jc, lay, opt)
    m_p = bk.schur_matvec_plain(st, dup, duc, jc, lay, opt)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["schur_matvec"] == 1
    assert tuple(m_k.shape) == (lay.Npad, 6 + lay.nparams)
    assert float(m_p.abs().max()) > 0
    assert _rel_err(m_k, m_p) <= 3e-5


_HEADLINE = dict(num_images=128, num_points=30_000, observations_per_point=7,
                 pose_noise=0.005, point_noise=0.02, pixel_noise=0.5, seed=0)


@pytest.mark.parametrize("schur_bf16", [True, False], ids=["bf16", "f32"])
def test_fused_schur_matches_twin_random_tracks(cuda, schur_bf16):
    """K1 against its twin on the headline's random tracks (128 images,
    30,000 points: buckets K = 6, 8 and 20), with S_corr rounded to bf16
    and not: S and Ey at 3e-5 of scale, the image payload at 1e-5, the
    point payload and jw at 1e-4. S gets no atomics: it is exactly
    symmetric and the same on a second launch."""
    problem, _ = make_ba_problem(dtype=torch.float32, device=cuda,
                                 **_HEADLINE)
    opt = BAOptions(dtype="float32", schur_bf16=schur_bf16)
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    assert [lay.K for lay in lays] == [6, 8, 20]
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    lam = torch.tensor(1e-3, device=cuda)
    for st, lay, pts in zip(statics, lays, pts0):
        bk.reset_launches()
        k1 = bk.fused_schur(st, par, pts, lam, lay, opt)
        p1 = bk.fused_schur_plain(st, par, pts, lam, lay, opt)
        torch.cuda.synchronize()
        assert bk.LAUNCHES["fused_schur"] == 1
        for name, a, b, tol in zip(("S", "img_red", "ey", "pt_pay", "jw"),
                                   k1, p1, (3e-5, 1e-5, 3e-5, 1e-4, 1e-4)):
            assert _rel_err(a, b) <= tol, (lay.K, name)
        assert torch.equal(k1[0], k1[0].T)
        assert torch.equal(k1[0], bk.fused_schur(st, par, pts, lam, lay,
                                                 opt)[0])


@pytest.mark.parametrize("kernel", ["fused_schur", "fused_reduce"])
def test_wide_windows_and_long_tracks_match_twins(cuda, kernel):
    """K1 (dense path forced) and K2 on random tracks over 300 images:
    blocks whose payload window spans several 128-image chunks, and a
    bucket with K > 8 slots, whose lanes the kernel walks in passes.
    The tolerances of the tests above; K1's S exactly symmetric."""
    problem, _ = make_ba_problem(
        dtype=torch.float32, device=cuda, num_images=300, num_points=6000,
        observations_per_point=7, pose_noise=0.005, point_noise=0.02,
        pixel_noise=0.5, seed=1)
    mode = "dense" if kernel == "fused_schur" else "implicit"
    opt = BAOptions(dtype="float32", fused_mode=mode, schur_bf16=False)
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    assert max(lay.K for lay in lays) > bk.K12_SLOTS
    assert any(int(bk.fused_reduce_windows(st, lay)[2].max()) > 1
               for st, lay in zip(statics, lays))
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    lam = torch.tensor(1e-3, device=cuda)
    for st, lay, pts in zip(statics, lays, pts0):
        out_k = getattr(bk, kernel)(st, par, pts, lam, lay, opt)
        out_p = getattr(bk, kernel + "_plain")(st, par, pts, lam, lay, opt)
        torch.cuda.synchronize()
        if kernel == "fused_schur":
            names, tols = ("S", "img_red", "ey", "pt_pay", "jw"), \
                (3e-5, 1e-5, 3e-5, 1e-4, 1e-4)
            assert torch.equal(out_k[0], out_k[0].T)
        else:
            names, tols = ("img_red", "pt_pay", "jw", "jcorr"), \
                (1e-4, 1e-4, 1e-4, 1e-4)
        for name, a, b, tol in zip(names, out_k, out_p, tols):
            assert _rel_err(a, b) <= tol, (lay.K, name)


@pytest.mark.parametrize("scene", ["headline", "sequential-0",
                                   "sequential-1"])
def test_backsub_matches_twin_at_path_buckets(cuda, scene):
    """K4 against its twin with random du at the main path's buckets: the
    headline's K = 6, 8 and 20 (random tracks, dead lanes; 20 slots take
    two passes of the kernel's 16 slots) from K1, and a 1024-image sequential
    bucket (K = 7) from K2 with 3 and 4 intrinsics; a fifth of the points
    fixed (free_p = 0). dp at 1e-4 of scale, acc rtol 1e-4."""
    gen = torch.Generator().manual_seed(6)
    lam = torch.tensor(1e-3, device=cuda)
    if scene == "headline":
        problem, _ = make_ba_problem(dtype=torch.float32, device=cuda,
                                     **_HEADLINE)
        opt = BAOptions(dtype="float32")
        statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
        assert [lay.K for lay in lays] == [6, 8, 20]
        assert lays[-1].K > 16 and lays[-1].K % 16
        par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                             statics[0].image_cam, lays[0])
        outs = [bk.fused_schur(st, par, p, lam, lay, opt)[3:]
                for st, lay, p in zip(statics, lays, pts0)]
        dup = torch.zeros(6, lays[0].Npad)
        dup[:, :lays[0].N] = 1e-3 * torch.randn(6, lays[0].N, generator=gen)
        duc = torch.zeros(12, lays[0].C)
        duc[:3] = 1e-2 * torch.randn(3, lays[0].C, generator=gen)
        dup, duc = dup.to(cuda), duc.to(cuda)
    else:
        st, lay, opt, dup, duc, _, k2 = _sequential_bucket(
            cuda, int(scene[-1]), "off", "sorted")
        assert lay.K == 7
        statics, lays, outs = [st], [lay], [k2[1:3]]
    for st, lay, (pt_pay, jw) in zip(statics, lays, outs):
        assert bool((st.obs_sta[2] == 0).any())
        pt_pay = pt_pay.clone()
        fixed = torch.rand(lay.Pp, generator=gen) < 0.2
        pt_pay[18, fixed.to(cuda)] = 0.0
        bk.reset_launches()
        dp_k, acc_k = bk.backsub(st, dup, duc, pt_pay, jw, lam, lay, opt)
        dp_p, acc_p = bk.backsub_plain(st, dup, duc, pt_pay, jw, lam, lay,
                                       opt)
        torch.cuda.synchronize()
        assert bk.LAUNCHES["backsub"] == 1
        assert float(dp_p.abs().max()) > 0 and float(acc_p[0]) > 0
        assert bool((dp_k[:, fixed.to(cuda)] == 0).all())
        assert _rel_err(dp_k, dp_p) <= 1e-4, lay.K
        torch.testing.assert_close(acc_k, acc_p, rtol=1e-4, atol=0)


# The lengths of tests/test_torch_map_gather.py's odd-length cases, as
# (maps, samples per map).
_ODD_LENGTHS = {1: (1, 1), 3: (3, 1), 4: (2, 2), 5: (5, 1),
                4097: (17, 241)}


@pytest.mark.parametrize("form", ["probe", "flat"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_map_gather_bit_equal_at_odd_lengths_and_views(cuda, dtype, form):
    """map_gather equals its twin bit for bit at the odd lengths, on
    index views offset by 0-3 elements and, through the C entry, into an
    `out` offset by one word, in 4- and 8-byte words and both forms, with
    maps of 1024 and 1021 words."""
    from sba_tpu_torch.ops import cuda_build
    from sba_tpu_torch.ops import map_gather as mg

    gen = torch.Generator().manual_seed(1)
    for hw, (n, (maps, per)) in ((hw, c) for hw in (1024, 1021)
                                 for c in _ODD_LENGTHS.items()):
        if dtype == torch.int32:
            table = torch.randint(-2 ** 31, 2 ** 31 - 1, (maps * hw,),
                                  dtype=dtype, generator=gen)
        else:
            table = torch.randn(maps * hw, dtype=dtype, generator=gen)
        il = torch.randint(0, hw, (n + 3,), dtype=torch.int32,
                           generator=gen)
        if form == "flat":
            k = torch.arange(n + 3) % n
            il = (il + hw * (k // per)).int()
            per_, hw_ = 0, 0
        else:
            per_, hw_ = per, hw
        table, il = table.to(cuda), il.to(cuda)
        for off in range(4):
            if form == "probe" and off:     # samples map by position
                idx = torch.cat([il[:off], il[:n]])[off:]
            else:
                idx = il[off:off + n]
            assert idx.storage_offset() == off and idx.is_contiguous()
            want = mg.map_gather_plain(table, idx, per_, hw_)
            assert torch.equal(mg.map_gather(table, idx, per_, hw_), want)
            buf = torch.zeros(n + 1, dtype=dtype, device=cuda)
            err = cuda_build.lib().sba_map_gather(
                table.element_size(), n, per_, hw_, table.data_ptr(),
                idx.data_ptr(), buf[1:].data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            cuda_build.check(err, "sba_map_gather")
            torch.cuda.synchronize()
            assert torch.equal(buf[1:], want), (hw, n, off)
            assert int(buf[0]) == 0


@pytest.mark.parametrize("form", ["probe", "flat"])
def test_map_gather_pair_bit_equal_at_odd_lengths_and_views(cuda, form):
    """map_gather_pair (B3's kernel) equals its twin bit for bit at n = 1,
    3 and 4097, on index views offset by 0-3 elements, in its summed and
    pair forms, on the probes' layout (indices local to their map) and
    the flat one, with maps of 1024 and 1021 pixels."""
    from sba_tpu_torch.ops import map_gather as mg

    gen = torch.Generator().manual_seed(2)
    for hw, (n, (maps, per)) in ((hw, c) for hw in (1024, 1021)
                                 for c in _ODD_LENGTHS.items()
                                 if c[0] in (1, 3, 4097)):
        table = torch.randint(-2 ** 31, 2 ** 31 - 1, (maps * hw, 2),
                              dtype=torch.int32, generator=gen)
        il = torch.randint(0, hw, (n + 3,), dtype=torch.int32,
                           generator=gen)
        if form == "flat":
            il = (il + hw * ((torch.arange(n + 3) % n) // per)).int()
            per_, hw_ = 0, 0
        else:
            per_, hw_ = per, hw
        table, il = table.to(cuda), il.to(cuda)
        for off in range(4):
            if form == "probe" and off:     # samples map by position
                idx = torch.cat([il[:off], il[:n]])[off:]
            else:
                idx = il[off:off + n]
            assert idx.storage_offset() == off and idx.is_contiguous()
            for summed in (True, False):
                want = mg.map_gather_pair_plain(table, idx, per_, hw_, summed)
                got = mg.map_gather_pair(table, idx, per_, hw_, summed)
                assert got.dtype == want.dtype and torch.equal(got, want), (
                    hw, n, off, summed)


@pytest.mark.parametrize("order", ["sorted", "spread"])
@pytest.mark.parametrize("ranged", ["off", "on"])
@pytest.mark.parametrize("model_id", [0, 1])
def test_fused_reduce_windows_match_twin(cuda, model_id, ranged, order):
    """K2 against its twin on a 1024-image sequential bucket (20,000
    points, track 7), whose blocks see narrow image windows, and on the
    same bucket with its images renamed by `spread_image_ids`, whose
    every block's window spans several chunks; f32 and bf16 couplings,
    3 and 4 intrinsics. Image payload, point payload and jw at 1e-4 of
    scale, bf16 jcorr at 2^-8."""
    from sba_tpu_torch.optim.ba import problem_from_numpy
    from sba_tpu_torch.utils.synthetic import (
        make_sequential_ba_problem_numpy, rename_images, spread_image_ids)

    f, _ = make_sequential_ba_problem_numpy(
        num_images=1024, num_points=20_000, track_len=7, seed=4)
    if model_id == 1:
        c = f["cam_params"]
        c[0, :4] = [c[0, 0], c[0, 0], c[0, 1], c[0, 2]]
    problem = problem_from_numpy(f, cuda, torch.float32)
    opt = BAOptions(model_id=model_id, dtype="float32", fused_ranged=ranged)
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    st, lay, pts = statics[0], lays[0], pts0[0]
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         st.image_cam, lay)
    if order == "spread":
        st, par = rename_images(st, par, spread_image_ids(lay.N))
    _, _, chunks = bk.fused_reduce_windows(st, lay)
    live = chunks > 0
    if order == "sorted":
        assert int(chunks.max()) == 1
    else:
        assert bool((chunks[live] > 1).all())
    lam = torch.tensor(1e-3, device=cuda)
    bk.reset_launches()
    k2 = bk.fused_reduce(st, par, pts, lam, lay, opt)
    p2 = bk.fused_reduce_plain(st, par, pts, lam, lay, opt)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["fused_reduce"] == 1
    jc_tol = 2.0 ** -8 if ranged == "on" else 1e-4
    assert float(p2[0].abs().max()) > 0
    for name, a, b, tol in zip(("img_red", "pt_pay", "jw", "jcorr"), k2, p2,
                               (1e-4, 1e-4, 1e-4, jc_tol)):
        assert a.dtype == b.dtype, name
        assert _rel_err(a.float(), b.float()) <= tol, name


def _textured_plane_views(H=60, W=80, depth0=4.0, n_src=2, seed=0):
    """tests/test_mvs.py's fronto-parallel textured plane: a reference
    camera at the origin and x-translated sources."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1.0]])
    G, EXT = 256, 16.0
    grid = gaussian_filter(rng.standard_normal((G, G)), 1.2)
    grid = (grid - grid.min()) / (grid.max() - grid.min() + 1e-9)

    def texture(X, Y):
        gx = (X / EXT + 0.5) * (G - 1)
        gy = (Y / EXT + 0.5) * (G - 1)
        x0 = np.clip(np.floor(gx).astype(int), 0, G - 2)
        y0 = np.clip(np.floor(gy).astype(int), 0, G - 2)
        fx, fy = np.clip(gx - x0, 0, 1), np.clip(gy - y0, 0, 1)
        return (grid[y0, x0] * (1 - fy) * (1 - fx)
                + grid[y0, x0 + 1] * (1 - fy) * fx
                + grid[y0 + 1, x0] * fy * (1 - fx)
                + grid[y0 + 1, x0 + 1] * fy * fx)

    yy, xx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    rays = np.stack([xx, yy, np.ones_like(xx)], -1) @ np.linalg.inv(K).T
    P = rays * depth0
    ts = np.array([[0.4 * (s + 1) * (-1) ** s, 0.15 * s, 0.0]
                   for s in range(n_src)])
    srcs = [texture(*(P - t)[..., :2].transpose(2, 0, 1)) for t in ts]
    # 8-bit images, as the CLI loads them (the packed sampler is lossless).
    q = lambda a: np.round(a * 255.0) / 255.0
    return (q(texture(P[..., 0], P[..., 1])), q(np.stack(srcs)), K,
            np.stack([K] * n_src), np.stack([np.eye(3)] * n_src), ts)


def test_patch_match_plane_on_card(cuda):
    """A 60x80 textured-plane solve on the card (packed sampling, every
    cost through K6: 161 launches) from depths 5% off the plane: it must
    come back onto the plane by tests/test_mvs.py:93's measures (80% of
    the pixels within 3%, median error under 1%, normals facing the
    camera), as the same solve on the CPU twins does. (From a random
    init neither sba_tpu nor the port meets them in 10 iterations:
    sba_tpu puts 3.4% of the pixels within 3%.)"""
    ref, srcs, K, Ks, Rs, ts = _textured_plane_views()
    opt = pm.PatchMatchOptions(depth_min=1.0, depth_max=20.0,
                               num_iterations=10, window_radius=3,
                               filter=False)
    gen = torch.Generator().manual_seed(0)
    init = 4.0 * (1.0 + 0.1 * (torch.rand(60, 80, generator=gen) - 0.5))
    fronto = torch.zeros(60, 80, 3)
    fronto[..., 2] = -1.0
    inner = (slice(10, -10), slice(15, -15))
    for dev in (torch.device("cpu"), cuda):
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        pk.reset_launches()
        res = pm.patch_match_stereo(
            t(ref), t(srcs), t(K), t(Ks), t(Rs), t(ts),
            generator=torch.Generator(dev).manual_seed(0), options=opt,
            init_depth=init.to(dev), init_normal=fronto.to(dev))
        n_launch = 1 + 10 * 2 * (8 + 2) if dev.type == "cuda" else 0
        assert pk.LAUNCHES["ncc_cost"] == n_launch
        rel = (res.depth.cpu().numpy()[inner] - 4.0) / 4.0
        nz = res.normal.cpu().numpy()[inner][..., 2]
        print(f"{dev.type}: {(abs(rel) < 0.03).mean():.3f} within 3%, "
              f"median {np.median(abs(rel)):.4f}, nz {np.median(nz):.3f}")
        assert (abs(rel) < 0.03).mean() > 0.8
        assert np.median(abs(rel)) < 0.01
        assert np.median(nz) < -0.9


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_map_gather_kernels_match_twins(cuda, dtype):
    """map_gather (4- and 8-byte words, probe and flat forms) and
    map_gather_pair (both words, and the u32 sum) equal their twins bit
    for bit on the same CUDA tensors."""
    from sba_tpu_torch.ops import map_gather as mg

    gen = torch.Generator().manual_seed(0)
    maps, hw, per = 5, 640 * 48, 3000
    if dtype == torch.int32:
        table = torch.randint(-2 ** 31, 2 ** 31 - 1, (maps * hw,),
                              dtype=dtype, generator=gen)
    else:
        table = torch.randn(maps * hw, dtype=dtype, generator=gen)
    il = torch.randint(0, hw, (maps, per), dtype=torch.int32, generator=gen)
    flat = torch.randint(0, maps * hw, (7, 1111), dtype=torch.int32,
                         generator=gen)
    pair = torch.randint(-2 ** 31, 2 ** 31 - 1, (maps * hw, 2),
                         dtype=torch.int32, generator=gen)
    table, il, flat, pair = (table.to(cuda), il.to(cuda), flat.to(cuda),
                             pair.to(cuda))
    mg.reset_launches()
    assert torch.equal(mg.map_gather(table, il, per, hw),
                       mg.map_gather_plain(table, il, per, hw))
    assert torch.equal(mg.map_gather(table, flat),
                       mg.map_gather_plain(table, flat))
    assert torch.equal(mg.map_gather_pair(pair, flat),
                       mg.map_gather_pair_plain(pair, flat))
    assert torch.equal(mg.map_gather_pair(pair, il, per, hw, summed=True),
                       mg.map_gather_pair_plain(pair, il, per, hw, True))
    torch.cuda.synchronize()
    assert mg.LAUNCHES == {"map_gather": 2, "map_gather_pair": 2}
    with pytest.raises(ValueError, match="int32"):
        mg.map_gather(table, flat.long())


def test_forward_mode_through_gather_kernel(cuda):
    """The forward-mode Jacobian of a float64 soft SBA problem (every
    sample through map_gather) equals the CPU twins' to 1e-12 of scale."""
    from sba_tpu_torch.ops import map_gather as mg
    from sba_tpu_torch.optim import sba as tsba
    from sba_tpu_torch.utils.synthetic import make_sba_scene

    scene = make_sba_scene(num_images=3, image_size=(64, 48),
                           pose_noise=0.02, seed=7)
    opt = tsba.SBAOptions(pixel_step=3, linearize="jacfwd")
    out = {}
    for dev in ("cpu", cuda):
        p = tsba.build_sba_problem(scene[5], scene[6], *scene[2:5], opt,
                                   dtype=torch.float64, device=dev)
        mg.reset_launches()
        r, J, c = tsba._pair_jacobians(p, opt)
        out[str(dev)] = (r.cpu(), J.cpu(), dict(mg.LAUNCHES))
    (r0, J0, l0), (r1, J1, l1) = out["cpu"], out["cuda"]
    assert l0["map_gather"] == 0 and l1["map_gather"] == 8
    assert float(J0.abs().max()) > 0
    assert _rel_err(r1, r0) <= 1e-12 and _rel_err(J1, J0) <= 1e-12


def test_sba_solve_on_card_matches_cpu(cuda):
    """A 4-image float64 soft solve (forward mode) on the card against
    the same solve on the CPU: final cost and poses at 1e-8."""
    from sba_tpu_torch.ops import map_gather as mg
    from sba_tpu_torch.optim import sba as tsba
    from sba_tpu_torch.utils.synthetic import make_sba_scene

    scene = make_sba_scene(num_images=4, image_size=(64, 48),
                           pose_noise=0.02, cell=0.5, seed=2)
    opt = tsba.SBAOptions(pixel_step=2, max_iterations=20)
    res = {}
    for dev in ("cpu", cuda):
        p = tsba.build_sba_problem(scene[5], scene[6], *scene[2:5], opt,
                                   dtype=torch.float64, device=dev)
        mg.reset_launches()
        o, s = tsba.semantic_bundle_adjust(p, opt)
        res[str(dev)] = (float(s.final_cost), o.qvecs.cpu(), o.tvecs.cpu(),
                         mg.LAUNCHES["map_gather"])
    c0, q0, t0, n0 = res["cpu"]
    c1, q1, t1, n1 = res["cuda"]
    assert n0 == 0 and n1 > 0
    assert abs(c1 - c0) <= 1e-8 * c0
    assert float((q1 - q0).abs().max()) <= 1e-8
    assert float((t1 - t0).abs().max()) <= 1e-8


def test_gsba_solve_on_card_matches_cpu(cuda, monkeypatch):
    """A 4-image GSBA solve (poses, cylinder and landmarks free) in
    float32 on the card against the float64 solve on the CPU: final cost
    at rtol 1e-3. The float32 solve with one image per chunk of pixel
    work is bit-equal to the one with every image in one chunk."""
    from sba_tpu_torch.optim import gsba as tg
    from sba_tpu_torch.utils.synthetic import make_gsba_scene

    q, t, cam, sem, cyl, q0, t0, cyl0 = make_gsba_scene(
        num_images=4, image_size=(64, 48), pose_noise=0.005,
        cylinder_noise=0.03, seed=4)
    opt = tg.GSBAOptions(max_iterations=10)
    ref = tg.build_gsba_problem(q0, t0, cam, sem, [cyl0], opt,
                                dtype=torch.float64, device="cpu")
    _, s0 = tg.geometric_semantic_bundle_adjust(ref, opt)
    p = tg.build_gsba_problem(q0, t0, cam, sem, [cyl0], opt,
                              dtype=torch.float32, device=cuda)
    runs = []
    for budget, n_chunks in ((1, 4), (1 << 40, 1)):
        monkeypatch.setattr(tg, "GSBA_CHUNK_BYTES", budget)
        assert len(tg.image_chunks(p)) == n_chunks
        runs.append(tg.geometric_semantic_bundle_adjust(p, opt))
    (o1, s1), (o2, s2) = runs
    c0, c1 = float(s0.final_cost), float(s2.final_cost)
    assert c1 < float(s2.initial_cost)
    assert abs(c1 - c0) <= 1e-3 * c0
    assert s1.num_iterations == s2.num_iterations
    for f in ("qvecs", "tvecs", "cyl_qvec", "cyl_tvec", "cyl_log_radius",
              "cyl_log_height"):
        assert torch.equal(getattr(o1, f), getattr(o2, f)), f
    assert torch.equal(s1.cost_trace.nan_to_num(-1.0),
                       s2.cost_trace.nan_to_num(-1.0))
    assert torch.equal(s1.per_image_iou, s2.per_image_iou)


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------


def _views(n=4, size=(320, 240)):
    from sba_tpu_torch.utils.render import render_scene

    sc = render_scene(num_images=n, image_size=size, focal=1.2 * size[0],
                      seed=5, device="cpu")
    return sc


def _same_draws(kind, trials, pairs, masks_r):
    """Seeded CPU draws per (family, trials, pair): the card and the CPU
    verify with the same samples."""
    from sba_tpu_torch.optim.ransac import draw_samples

    ssz = {"F": 7, "H": 4, "E": 5}[kind]
    return torch.stack([draw_samples(
        masks_r.shape[1], trials, ssz, mask=torch.as_tensor(masks_r[p]),
        generator=torch.Generator().manual_seed(
            1000003 * int(p) + 7919 * trials + ord(kind)))
        for p in pairs]).numpy()


def _rows_share(kc, mc, kp, mp):
    """Share of the card's valid rows with a CPU row within 1e-3 px in x,
    y and scale and 1e-3 rad in orientation; and the CPU row of each."""
    a, b = kc[mc], kp[mp]
    d = (a[:, None, :] - b[None, :, :]).abs()
    d[..., 3] = torch.minimum(d[..., 3], 2 * torch.pi - d[..., 3])
    worst = d.amax(-1)
    best = worst.argmin(1)
    ok = worst.gather(1, best[:, None])[:, 0] <= 1e-3
    return float(ok.float().mean()), torch.where(ok, best, -1)


def test_sift_on_card_matches_cpu(cuda):
    """SIFT of 320x240 views on the card (gradient taps through the
    map_gather kernel, two launches an image) against the CPU path."""
    from sba_tpu_torch.features.sift import (descriptors_to_uint8,
                                             extract_sift)
    from sba_tpu_torch.ops import map_gather as mg

    sc = _views()
    for im in sc["images"]:
        img = im.astype(np.float32) / 255.0
        mg.reset_launches()
        c = extract_sift(img, device=cuda)
        torch.cuda.synchronize()
        assert mg.LAUNCHES["map_gather"] == 2
        p = extract_sift(img, device="cpu")
        share, idx = _rows_share(c.keypoints.cpu(), c.mask.cpu(),
                                 p.keypoints, p.mask)
        assert share >= 0.98 and int(c.mask.sum()) > 200
        uc = descriptors_to_uint8(c.descriptors.cpu())[c.mask.cpu()][idx >= 0]
        up = descriptors_to_uint8(p.descriptors)[p.mask][idx[idx >= 0]]
        assert float(((uc.int() - up.int()).abs() <= 1).float().mean()) \
            >= 0.99


# The SIFT options beyond the defaults, and map_gather's launches an
# image under each: six Baumberg iterations, the orientation windows and
# the descriptors (affine); one launch for all DSP scales.
_SIFT_VARIANTS = {"first_octave": (dict(first_octave=-1), 2),
                  "affine": (dict(estimate_affine_shape=True), 8),
                  "dsp": (dict(domain_size_pooling=True), 2)}


def _affine_rows(k):
    """[K, 6] affine rows -> [K, 4] (x, y, scale, orientation): scale =
    sqrt(det A), orientation from A's polar factor (A = scale S R). The
    padding rows (all zero) come out as zeros."""
    A = k[:, 2:].double().reshape(-1, 2, 2)
    sc = torch.sqrt(torch.abs(torch.linalg.det(A)))
    safe = torch.where(sc > 0, sc, torch.ones_like(sc))
    A = torch.where((sc > 0)[:, None, None], A,
                    torch.eye(2, dtype=A.dtype).expand_as(A))
    u, _, vh = torch.linalg.svd(A / safe[:, None, None])
    R = u @ vh
    ori = torch.remainder(torch.atan2(R[:, 1, 0], R[:, 0, 0]), 2 * torch.pi)
    return torch.stack([k[:, 0].double(), k[:, 1].double(), sc, ori], 1)


@pytest.mark.parametrize("variant", list(_SIFT_VARIANTS))
def test_map_gather_bit_equal_at_sift_option_laws(cuda, variant):
    """Every map_gather launch of SIFT under first_octave -1, the affine
    shape and DSP (each a new index law: a 4x table, taps through each
    keypoint's shape, ten scales in one launch) equals map_gather_plain
    on the same card tensors bit for bit."""
    from sba_tpu_torch.features import sift
    from sba_tpu_torch.ops import map_gather as mg

    kw, launches = _SIFT_VARIANTS[variant]
    same, calls = [], []

    def checked(table, idx, *args):
        out = mg.map_gather(table, idx, *args)
        same.append(torch.equal(out, mg.map_gather_plain(table, idx, *args)))
        calls.append(idx.numel())
        return out

    img = _views(1)["images"][0].astype(np.float32) / 255.0
    orig = sift.map_gather
    sift.map_gather = checked
    try:
        mg.reset_launches()
        sift.extract_sift(img, sift.SiftExtractionOptions(**kw), device=cuda)
        torch.cuda.synchronize()
    finally:
        sift.map_gather = orig
    assert mg.LAUNCHES["map_gather"] == launches == len(calls)
    assert all(same), same


@pytest.mark.parametrize("variant", list(_SIFT_VARIANTS))
def test_sift_options_on_card_match_cpu(cuda, variant):
    """One 320x240 view under each option on the card against the CPU
    path: 98% of rows within 1e-3 px / rad (the affine variant 95%: its
    orientation comes out of six Baumberg iterations that amplify a
    float32 rounding), u8 descriptors within 1 in 99% (98% affine)."""
    from sba_tpu_torch.features.sift import (SiftExtractionOptions,
                                             descriptors_to_uint8,
                                             extract_sift_batch)

    kw, _ = _SIFT_VARIANTS[variant]
    img = _views(1)["images"][:1].astype(np.float32) / 255.0
    opt = SiftExtractionOptions(**kw)
    kc, uc, mc = (torch.as_tensor(a[0]) for a in
                  extract_sift_batch(img, opt, device=cuda))
    kp, up, mp = (torch.as_tensor(a[0]) for a in
                  extract_sift_batch(img, opt, device="cpu"))
    assert int(mc.sum()) > 200
    if variant == "affine":
        assert kc.shape[1] == 6
        kc, kp = _affine_rows(kc).float(), _affine_rows(kp).float()
        assert torch.isfinite(kc[mc]).all()
    share, idx = _rows_share(kc, mc, kp, mp)
    assert share >= (0.95 if variant == "affine" else 0.98), share
    a = uc[mc][idx >= 0].int()
    b = up[mp][idx[idx >= 0]].int()
    assert float(((a - b).abs() <= 1).float().mean()) >= (
        0.98 if variant == "affine" else 0.99)


def test_matcher_and_verifier_on_card_match_cpu(cuda):
    """match_pairs_batched on one descriptor stack (rows equal but 0.1%)
    and estimate_two_view_geometry_batch with the same draws
    (configurations equal, inliers within 1%), card against CPU."""
    from sba_tpu_torch.estimators.two_view_geometry import (
        estimate_two_view_geometry_batch, pack_matches)
    from sba_tpu_torch.features.matching import match_pairs_batched
    from sba_tpu_torch.features.sift import (descriptors_to_uint8,
                                             extract_sift)

    sc = _views()
    feats = [extract_sift(im.astype(np.float32) / 255.0, device="cpu")
             for im in sc["images"]]
    I = len(feats)
    N = 256 * -(-max(int(f.mask.sum()) for f in feats) // 256)
    stack = np.zeros((I, N, 128), np.uint8)
    nvalid = np.array([int(f.mask.sum()) for f in feats], np.int32)
    for i, f in enumerate(feats):
        stack[i, :nvalid[i]] = descriptors_to_uint8(f.descriptors)[f.mask]
    pairs = np.array([(a, b) for a in range(I) for b in range(a + 1, I)])
    mc, _ = match_pairs_batched(torch.as_tensor(stack, device=cuda),
                                torch.as_tensor(nvalid, device=cuda), pairs)
    mp, _ = match_pairs_batched(torch.as_tensor(stack),
                                torch.as_tensor(nvalid), pairs)
    mc, mp = mc.cpu().numpy(), mp.numpy()
    assert (mc != mp).sum() <= 0.001 * nvalid[pairs[:, 0]].sum()
    matches = []
    for j, (a, b) in enumerate(pairs):
        i1 = np.nonzero(mp[j] >= 0)[0]
        matches.append((a, b, np.stack([i1, mp[j][i1]], -1)))
    xy1, xy2, vm = pack_matches(
        [f.keypoints[f.mask].double().numpy() for f in feats], matches)
    w, h = 320, 240
    cam = np.tile([[1.2 * w, 1.2 * w, w / 2, h / 2]], (len(pairs), 1))
    sizes = [(w, h)] * len(pairs)
    rc, rp = [estimate_two_view_geometry_batch(
        xy1, xy2, vm, cam, cam, sizes, sizes, dtype=torch.float32,
        device=dev, draw_fn=_same_draws) for dev in (cuda, "cpu")]
    for a, b in zip(rc, rp):
        assert a.config == b.config
        assert abs(a.num_inliers - b.num_inliers) <= 0.01 * b.num_inliers
        assert b.num_inliers >= 15


def test_frontend_commands_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """feature_extractor and exhaustive_matcher on the card against
    --device cpu on four 320x240 views (the matchers on copies of one
    database, with the same draws)."""
    import shutil

    from sba_tpu_torch import cli
    from sba_tpu_torch.estimators import two_view_geometry as tvg
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.utils.render import write_scene_images

    write_scene_images(_views(), str(tmp_path / "imgs"))
    for dev in ("cuda", "cpu"):
        assert cli.main(["feature_extractor", "--database_path",
                         str(tmp_path / f"{dev}.db"), "--image_path",
                         str(tmp_path / "imgs"), "--device", dev]) == 0
    a, b = Database(str(tmp_path / "cuda.db")), Database(str(tmp_path
                                                            / "cpu.db"))
    for iid in a.read_images():
        kc, kp = T_(a.read_keypoints(iid)), T_(b.read_keypoints(iid))
        share, _ = _rows_share(kc, torch.ones(len(kc), dtype=torch.bool),
                               kp, torch.ones(len(kp), dtype=torch.bool))
        assert share >= 0.98
    own = tvg.estimate_two_view_geometry_batch
    monkeypatch.setattr(tvg, "estimate_two_view_geometry_batch",
                        lambda *x, **kw: own(*x, **dict(
                            kw, draw_fn=_same_draws)))
    for dev in ("cuda", "cpu"):
        shutil.copy(tmp_path / "cpu.db", tmp_path / f"m_{dev}.db")
        assert cli.main(["exhaustive_matcher", "--database_path",
                         str(tmp_path / f"m_{dev}.db"), "--device",
                         dev]) == 0
    a, b = Database(str(tmp_path / "m_cuda.db")), Database(
        str(tmp_path / "m_cpu.db"))
    ma, mb = a.read_all_matches(), b.read_all_matches()
    assert ma.keys() == mb.keys() and len(ma) == 6
    rows = sum(len(m) for m in mb.values())
    diff = sum(len(set(map(tuple, ma[k])) ^ set(map(tuple, mb[k])))
               for k in ma)
    assert diff <= 0.002 * max(rows, 1) + 2
    ga, gb = a.read_all_two_view_geometries(), \
        b.read_all_two_view_geometries()
    for k in ga:
        assert ga[k]["config"] == gb[k]["config"]


def T_(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _ring_database(path):
    """tests/test_incremental_mapper.py's 8-image scene (8 views on an
    arc, 300 points, 0.3 px noise) written with the port's own modules."""
    from sba_tpu_torch.geometry.quaternions import (np_quat_to_rotmat,
                                                    np_rotmat_to_quat)
    from sba_tpu_torch.io.database import Database

    rng = np.random.default_rng(42)
    f, w, h = 500.0, 640, 480
    pts = rng.uniform(-2, 2, (300, 3))
    pts[:, 2] *= 0.5
    db = Database(str(path))
    cid = db.write_camera(model_id=0, width=w, height=h,
                          params=[f, w / 2, h / 2])
    ids, vis = [], []
    for k in range(8):
        ang = 2 * np.pi * k / 8
        c = np.array([4 * np.cos(ang), 4 * np.sin(ang), 2.0])
        z = -c / np.linalg.norm(c)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        R = np_quat_to_rotmat(np_rotmat_to_quat(np.stack(
            [x, np.cross(z, x), z])))
        pc = pts @ R.T - R @ c
        xy = pc[:, :2] / pc[:, 2:] * f + [w / 2, h / 2]
        xy += rng.normal(0, 0.3, xy.shape)
        vis.append((pc[:, 2] > 0.5) & (xy[:, 0] > 0) & (xy[:, 0] < w)
                   & (xy[:, 1] > 0) & (xy[:, 1] < h))
        ids.append(db.write_image(f"img{k}.png", cid))
        db.write_keypoints(ids[-1], np.concatenate(
            [xy, np.ones_like(xy)], -1).astype(np.float32))
    for a in range(8):
        for b in range(a + 1, 8):
            common = np.nonzero(vis[a] & vis[b])[0]
            if len(common) >= 20:
                db.write_two_view_geometry(
                    ids[a], ids[b], np.stack([common, common], -1)
                    .astype(np.uint32), config=2)
    db.close()


def _fixed_mapper_draws(kind, seed, n, trials, sample_size, mask):
    from sba_tpu_torch.optim.ransac import draw_samples

    g = torch.Generator().manual_seed(7919 * seed + ord(kind[0]))
    return draw_samples(n, trials, sample_size,
                        mask=torch.as_tensor(mask > 0), generator=g).numpy()


def test_mapper_on_card_matches_cpu(cuda, tmp_path):
    """The whole incremental mapper on the 8-image scene on the card and
    on the CPU with the same draws: the same registrations and tracks,
    poses and points within 1e-6 of the scene's scale."""
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.io.database_cache import DatabaseCache
    from sba_tpu_torch.sfm.controllers import (MapperControllerOptions,
                                               reconstruct_incremental)

    _ring_database(tmp_path / "db.db")
    db = Database(str(tmp_path / "db.db"))
    cache = DatabaseCache.create(db)
    db.close()
    opt = MapperControllerOptions()
    opt.mapper.init_min_num_inliers = 50
    opt.mapper.abs_pose_min_num_inliers = 15
    recs = {}
    for dev in ("cuda", "cpu"):
        models = reconstruct_incremental(cache, opt, device=dev,
                                         draw_fn=_fixed_mapper_draws)
        assert len(models) == 1
        recs[dev] = models[0]
    a, b = recs["cuda"], recs["cpu"]
    assert a.registered_image_ids == b.registered_image_ids
    assert a.num_registered_images() == 8
    assert list(a.points3D) == list(b.points3D)
    c = np.stack([im.tvec for im in b.images.values()])
    tol = 1e-6 * float(np.abs(c).max())
    for iid in b.registered_image_ids:
        np.testing.assert_allclose(a.images[iid].qvec, b.images[iid].qvec,
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(a.images[iid].tvec, b.images[iid].tvec,
                                   rtol=0, atol=tol)
    for pid, p in b.points3D.items():
        np.testing.assert_array_equal(a.points3D[pid].image_ids, p.image_ids)
        np.testing.assert_allclose(a.points3D[pid].xyz, p.xyz, rtol=0,
                                   atol=tol)
    assert b.compute_mean_reprojection_error() < 1.0


def _pose_graph_ring(device, dtype, sim3=False, n=24, noise=0.08, seed=3):
    """A noisy odometry ring with two loop closures (tests/test_pose_graph.py's
    construction with the port's own modules): exact relative measurements,
    perturbed initial poses, pose 0 the gauge."""
    from sba_tpu_torch.geometry.quaternions import (angle_axis_to_quat,
                                                    quat_multiply,
                                                    quat_normalize)
    from sba_tpu_torch.optim.pose_graph import make_problem, relative_pose

    rng = np.random.default_rng(seed)
    q = quat_normalize(angle_axis_to_quat(torch.as_tensor(
        rng.normal(size=(n, 3)) * 0.5)))
    t = torch.as_tensor(rng.normal(size=(n, 3)))
    s = torch.as_tensor(np.exp(rng.normal(size=n) * (0.1 if sim3 else 0.0)))
    edges = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1), (0, n // 2)]
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    rel = relative_pose(q[ei], t[ei], q[ej], t[ej],
                        *((s[ei], s[ej]) if sim3 else ()))
    q0 = quat_normalize(quat_multiply(angle_axis_to_quat(torch.as_tensor(
        rng.normal(size=(n, 3)) * noise)), q))
    t0 = t + torch.as_tensor(rng.normal(size=(n, 3)) * noise)
    ls0 = torch.log(s) + torch.as_tensor(rng.normal(size=n)
                                         * (noise if sim3 else 0.0))
    q0[0], t0[0], ls0[0] = q[0], t[0], torch.log(s[0])
    return make_problem(q0, t0, ei, ej, rel[0], rel[1],
                        rel_log_s=torch.log(rel[2]) if sim3 else None,
                        log_scales=ls0, sim3=sim3, dtype=dtype,
                        device=device)


@pytest.mark.parametrize("sim3,loss", [(False, "trivial"), (True, "huber")])
def test_pose_graph_on_card_matches_cpu(cuda, sim3, loss):
    """float64 on the card and the CPU: the same LM and PCG iteration
    counts, poses within 1e-9 of the scene's scale; float32 on the card:
    its final cost within 1e-3 of the float64 one (relative to the
    initial cost)."""
    from sba_tpu_torch.optim.pose_graph import (PoseGraphOptions,
                                                optimize_pose_graph)

    opt = PoseGraphOptions(max_iterations=30, sim3=sim3, loss=loss,
                           cg_tolerance=1e-4)
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = optimize_pose_graph(
            _pose_graph_ring(dev, torch.float64, sim3), opt)
    (a, sa), (b, sb) = out["cuda"], out["cpu"]
    assert sa.num_iterations == sb.num_iterations
    assert torch.equal(sa.cg_iterations.cpu(), sb.cg_iterations)
    tol = 1e-9 * float(b.tvecs.abs().max())
    for f in ("qvecs", "tvecs", "log_scales"):
        np.testing.assert_allclose(getattr(a, f).cpu().numpy(),
                                   getattr(b, f).numpy(), rtol=0, atol=tol)
    _, s32 = optimize_pose_graph(
        _pose_graph_ring("cuda", torch.float32, sim3), opt)
    assert float(sb.final_cost) < float(sb.initial_cost)
    assert abs(float(s32.final_cost) - float(sb.final_cost)) <= \
        1e-3 * float(sb.initial_cost)


def test_pose_graph_float32_on_card_repeats_bit_for_bit(cuda):
    """Two float32 solves of one ring on the card end in the same bits
    (the segment sums run through a gather table, not float atomics)."""
    from sba_tpu_torch.optim.pose_graph import (PoseGraphOptions,
                                                optimize_pose_graph)

    opt = PoseGraphOptions(max_iterations=20, sim3=True, loss="huber")
    runs = [optimize_pose_graph(_pose_graph_ring(
        "cuda", torch.float32, True, n=200), opt) for _ in range(2)]
    (a, sa), (b, sb) = runs
    assert float(sa.final_cost) == float(sb.final_cost)
    for f in ("qvecs", "tvecs", "log_scales"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _rig_pair_port(n=60, outlier_frac=0.1, seed=3):
    """tests/test_generalized_relative_pose.py's two rig frames (3
    cameras) with the port's modules."""
    rng = np.random.default_rng(seed)

    def roty(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])

    cams = [(roty(a), -roty(a) @ np.array([dx, 0.0, 0.0]))
            for dx, a in ((-0.3, -0.25), (0.0, 0.0), (0.3, 0.25))]
    c, s = np.cos(0.15), np.sin(0.15)
    R_true = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) @ roty(-0.1)
    t_true = np.array([0.5, 0.2, 0.1])
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 10, n)], axis=1)
    out = []
    for X in (pts, pts @ R_true.T + t_true):
        ci = rng.integers(0, 3, n)
        cR = np.stack([cams[i][0] for i in ci])
        ct = np.stack([cams[i][1] for i in ci])
        pc = np.einsum("kij,kj->ki", cR, X) + ct
        out += [cR, ct, pc[:, :2] / pc[:, 2:] + rng.normal(0, 5e-4, (n, 2))]
    k = int(outlier_frac * n)
    out[5][:k] = rng.uniform(-0.5, 0.5, (k, 2))
    return out, R_true, t_true


def test_gr6p_on_card_matches_cpu(cuda):
    """GR6P's scoring on the card against the CPU (float64, 1e-12 of
    scale), and its RANSAC with the same generator's draws: the same
    model and inliers."""
    from sba_tpu_torch.estimators import generalized_relative_pose as gr

    data, R_true, t_true = _rig_pair_port()
    Rs = torch.as_tensor(np.stack([R_true, R_true.T]))
    ts = torch.as_tensor(np.stack([t_true, -t_true]))
    e = {dev: gr.generalized_sampson_errors(
        Rs.to(dev), ts.to(dev), *(torch.as_tensor(a, device=dev)
                                  for a in data)).cpu().numpy()
         for dev in ("cuda", "cpu")}
    np.testing.assert_allclose(e["cuda"], e["cpu"], rtol=0,
                               atol=1e-12 * np.abs(e["cpu"]).max())
    reps = {dev: gr.estimate_generalized_relative_pose(
        *data, gr.GeneralizedRelativePoseOptions(max_error=5e-3),
        device=dev, generator=torch.Generator().manual_seed(1))
        for dev in ("cuda", "cpu")}
    a, b = reps["cuda"], reps["cpu"]
    assert a.success and b.success
    np.testing.assert_array_equal(a.inlier_mask, b.inlier_mask)
    np.testing.assert_allclose(a.R, b.R, rtol=0, atol=1e-12)
    assert np.abs(a.R - R_true).max() < 0.01


def _rig_ba_problem(device, S=8, P=200, seed=1):
    """A two-camera rig over S snapshots observing P points (normalized
    coordinates, identity pinhole), image poses perturbed off the rig."""
    from sba_tpu_torch.geometry.quaternions import (np_angle_axis_to_quat,
                                                    np_quat_to_rotmat,
                                                    pose_product)
    from sba_tpu_torch.optim.ba import problem_from_numpy

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (P, 3)) + [0, 0, 6.0]
    rel = (np_angle_axis_to_quat([0.0, 0.3, 0.0]), np.array([0.5, 0, 0]))
    ident = (np.array([1.0, 0, 0, 0]), np.zeros(3))
    q, t, sid, cq, ct = [], [], [], [], []
    for s in range(S):
        qs = torch.as_tensor(np_angle_axis_to_quat(
            [0.02 * s, -0.03 * s, 0.01]))
        ts = torch.as_tensor([0.4 * s - 0.8, 0.05 * s, 0.0],
                             dtype=torch.float64)
        for c in (ident, rel):
            qi, ti = pose_product(torch.as_tensor(c[0]),
                                  torch.as_tensor(c[1], dtype=torch.float64),
                                  qs, ts)
            q.append(qi.numpy())
            t.append(ti.numpy())
            sid.append(s)
            cq.append(c[0])
            ct.append(c[1])
    q, t = np.stack(q), np.stack(t)
    N = len(q)
    pc = np.einsum("nij,pj->npi", np.stack([np_quat_to_rotmat(x) for x in q]),
                   pts) + t[:, None]
    qn = q + rng.normal(0, 0.01, q.shape)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    O = N * P
    cam = np.zeros((1, 12))
    cam[0, 0] = 1.0
    problem = problem_from_numpy(dict(
        qvecs=qn, tvecs=t + rng.normal(0, 0.05, t.shape), points=pts,
        cam_params=cam, obs_image=np.repeat(np.arange(N), P),
        obs_point=np.tile(np.arange(P), N), obs_cam=np.zeros(O),
        obs_xy=(pc[..., :2] / pc[..., 2:]).reshape(-1, 2),
        obs_mask=np.ones(O), free_rot=np.ones(N), free_trans=np.ones((N, 3)),
        free_points=np.zeros(P), free_cam=np.zeros((1, 12))), device=device)
    return problem, np.array(sid), np.stack(cq), np.stack(ct)


def test_rig_bundle_adjust_on_card_matches_cpu(cuda):
    """The rig BA's gradient, Hessian blocks and damped step on the card
    against the CPU (1e-10 of scale), and 10 iterations of the whole loop
    (snapshot poses at 1e-9, the same accepted steps)."""
    from sba_tpu_torch.models import camera_rig as cr
    from sba_tpu_torch.optim.ba import BAOptions

    out, blocks = {}, {}
    for dev in ("cuda", "cpu"):
        problem, sid, cq, ct = _rig_ba_problem(dev)
        S = int(sid.max()) + 1
        rng = np.random.default_rng(2)
        cost_of = cr.rig_cost_fn(
            problem, BAOptions(), cr.quat_normalize(torch.as_tensor(
                rng.normal(0, 0.02, (S, 4)) + [1.0, 0, 0, 0], device=dev)),
            torch.as_tensor(rng.normal(0, 0.5, (S, 3)), device=dev),
            torch.as_tensor(sid, device=dev),
            torch.as_tensor(cq, device=dev), torch.as_tensor(ct, device=dev))
        g, H = cr.newton_blocks(cost_of, torch.zeros(
            (S, 6), dtype=torch.float64, device=dev))
        step = cr.damped_step(g, H, torch.tensor(1e-4, dtype=torch.float64,
                                                 device=dev))
        blocks[dev] = [x.cpu().numpy() for x in (g, H, step)]
        out[dev] = cr.rig_bundle_adjust(problem, sid, cq, ct,
                                        BAOptions(max_iterations=10))
    for a, b in zip(blocks["cuda"], blocks["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * np.abs(b).max())
    a, b = out["cuda"], out["cpu"]
    assert int(a["num_accepted"]) == int(b["num_accepted"]) > 0
    for k in ("snapshot_qvecs", "snapshot_tvecs"):
        np.testing.assert_allclose(a[k].cpu().numpy(), b[k].numpy(), rtol=0,
                                   atol=1e-9)
    assert float(b["final_cost"]) < float(b["initial_cost"])


def test_tsdf_fuse_on_card_equals_cpu(cuda):
    """tsdf_fuse of one set of float32 depth maps on the card and on the
    CPU: equal weights, at least 99.9% of the voxels within 1e-5 (the two
    devices' 3-element products may round apart), the card's mesh as
    large as the CPU's."""
    from sba_tpu_torch.mvs import meshing as tm

    rng = np.random.default_rng(0)
    H, W, f, n = 120, 160, 130.0, 5
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    yy, xx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    depths = np.stack([2.0 + 0.3 * np.sin(xx / 17.0 + i) + 0.1 * yy / H
                       + 0.005 * rng.standard_normal((H, W))
                       for i in range(n)]).astype(np.float32)
    q = np.tile([1.0, 0, 0, 0], (n, 1)) + rng.normal(0, 0.01, (n, 4))
    t = np.stack([[0.2 * i, 0.0, 0.0] for i in range(n)])
    opt = tm.TSDFOptions(voxel_size=0.02, truncation=0.06)
    lo, dims = tm.grid_bounds(depths, [K] * n, q, t, opt)
    out = {dev: tm.tsdf_fuse(depths, [K] * n, q, t, lo, dims, opt,
                             device=dev) for dev in ("cuda", "cpu")}
    (ta, wa), (tb, wb) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(wa, wb)
    share = (np.abs(ta - tb) <= 1e-5).mean()
    assert share >= 0.999, share
    ma = tm.surface_nets(ta, wa, lo, opt.voxel_size)
    mb = tm.surface_nets(tb, wb, lo, opt.voxel_size)
    assert len(mb.vertices) > 1000
    assert abs(len(ma.vertices) - len(mb.vertices)) <= 1e-3 * len(
        mb.vertices)


def test_retrieval_on_card_equals_cpu(cuda):
    """quantize_descriptors of a 16^2 tree and of a depth-1 tree of
    4096 imported words, build_vocab_tree with the same seed (the CPU's
    k-means objective, the same centres from run to run), and
    vote_and_verify give the CPU's words and counts on the card."""
    from sba_tpu_torch.retrieval import vocab_tree as tvt
    from sba_tpu_torch.retrieval.vote_and_verify import vote_and_verify

    rng = np.random.default_rng(0)
    c = rng.standard_normal((64, 128))
    x = np.repeat(c, 60, 0) + 0.3 * rng.standard_normal((64 * 60, 128))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    tree = tvt.build_vocab_tree(x, branching=16, depth=2, device="cpu")
    flat = tvt.VocabTree((torch.as_tensor(x[:4096])[None],), 4096, 1)
    for tr in (tree, flat):
        on_card = tvt.VocabTree(tuple(c.cuda() for c in tr.centers),
                                tr.branching, tr.depth)
        a = tvt.quantize_descriptors(on_card, x).cpu().numpy()
        b = tvt.quantize_descriptors(tr, x).numpy()
        assert (a == b).mean() >= 0.999, (a != b).sum()
    # The default draws come from a CPU generator: the tree built on the
    # card starts from the CPU's centres and reaches its k-means
    # objective (the mean cosine of a descriptor and its word's centre).
    card = tvt.build_vocab_tree(x, branching=16, depth=2, device="cuda")
    assert card.centers[1].shape == (16, 16, 128)

    def objective(t):
        t = tvt.VocabTree(tuple(c.cpu() for c in t.centers), 16, 2)
        w = tvt.quantize_descriptors(t, x).numpy()
        return np.mean(np.sum(x * t.centers[1].reshape(-1, 128).numpy()[w],
                              1))

    assert abs(objective(card) - objective(tree)) <= 1e-3
    # Its segment sums add in a fixed order: the same tree every run.
    again = tvt.build_vocab_tree(x, branching=16, depth=2, device="cuda")
    assert all(torch.equal(a, b) for a, b in zip(card.centers,
                                                  again.centers))
    g1 = np.concatenate([rng.uniform(0, 900, (300, 2)),
                         rng.uniform(1, 3, (300, 1)),
                         rng.uniform(0, 6, (300, 1))], 1).astype(np.float32)
    g2 = g1.copy()
    g2[:, :2] += [40.0, -25.0]
    g2[::4, :2] = rng.uniform(0, 900, (75, 2))
    assert vote_and_verify(g1, g2, device="cuda") \
        == vote_and_verify(g1, g2, device="cpu") >= 200


# ---------------------------------------------------------------------------
# SPMD solvers on torch.distributed (sba_tpu_torch.parallel)
# ---------------------------------------------------------------------------

def _spmd_cases():
    """Small scenes of every sharded solver, as numpy (the ranks' input):
    the fused dense and implicit paths (float32), the float64
    observation- and point-sharded solves, the implicit and the
    point-sharded ones again with one shared camera's intrinsics free,
    SBA (float32, map_gather),
    GSBA with its landmark term and a Sim3 pose graph. Returns {name:
    (kind, fields, option kwargs, the single-device solve on the card,
    the final cost's rtol, the kernels that must launch)}."""
    import dataclasses

    from sba_tpu_torch.optim import gsba as tg
    from sba_tpu_torch.optim import pose_graph as tpg
    from sba_tpu_torch.optim import sba as tsba
    from sba_tpu_torch.optim.ba import problem_to_numpy
    from sba_tpu_torch.utils.synthetic import make_gsba_scene, make_sba_scene

    def fields(p):
        return {k: v.detach().cpu().numpy() for k, v in p._asdict().items()
                if v is not None}

    cases = {}
    p32 = make_ba_problem(dtype=torch.float32, device="cuda", **_SMALL)[0]
    for mode, kernels in (("dense", ("fused_schur", "backsub", "fused_cost")),
                          ("implicit", ("fused_reduce", "schur_matvec",
                                        "backsub", "fused_cost"))):
        opt = BAOptions(max_iterations=10, dtype="float32", fused_mode=mode)
        cases[f"fused {mode}"] = (
            "fused", {k: v for k, v in problem_to_numpy(p32).items()
                      if v is not None}, dataclasses.asdict(opt),
            lambda o=opt: bundle_adjust(p32, o), 1e-3, kernels)
    # One camera shared by every image, its intrinsics free: the
    # replicated per-camera sums must come out bit-equal on every rank.
    p32c = p32._replace(free_cam=torch.ones_like(p32.free_cam))
    opt = BAOptions(max_iterations=10, dtype="float32", fused_mode="implicit")
    cases["fused implicit, free shared intrinsics"] = (
        "fused", {k: v for k, v in problem_to_numpy(p32c).items()
                  if v is not None}, dataclasses.asdict(opt),
        lambda o=opt: bundle_adjust(p32c, o), 1e-3,
        ("fused_reduce", "schur_matvec", "backsub", "fused_cost"))
    p64 = make_ba_problem(device="cuda", **_SMALL)[0]
    p64c = p64._replace(free_cam=torch.ones_like(p64.free_cam))
    for kind, solver, p, tag in (
            ("obs", "schur_pcg", p64, ""), ("pm", "explicit_schur", p64, ""),
            ("pm", "explicit_schur", p64c, ", free shared intrinsics")):
        opt = BAOptions(max_iterations=10, solver=solver)
        cases[f"f64 {kind}{tag}"] = (
            kind, fields(p), dataclasses.asdict(opt),
            lambda o=opt, p=p: bundle_adjust(p, o), 1e-6, ())
    q, t, cam, depth, sem, q0, t0 = make_sba_scene(
        num_images=5, image_size=(64, 48), pose_noise=0.01, seed=11)
    so = tsba.SBAOptions(pixel_step=4, max_iterations=8)
    ps = tsba.build_sba_problem(q0, t0, cam, depth, sem, so,
                                dtype=torch.float32, device="cuda")
    cases["sba"] = ("sba", fields(ps), dataclasses.asdict(so),
                    lambda: tsba.semantic_bundle_adjust(ps, so), 1e-3,
                    ("map_gather",))
    q, t, cam, sem, cyl, q0, t0, cyl0 = make_gsba_scene(
        num_images=5, image_size=(64, 48), pose_noise=0.005,
        cylinder_noise=0.03, seed=4)
    pts = np.random.default_rng(1).uniform([-1, -1, 4], [1, 1, 6], (20, 3))
    obs = (np.repeat(np.arange(5), 20), np.tile(np.arange(20), 5),
           np.random.default_rng(2).uniform(0, 60, (100, 2)))
    go = tg.GSBAOptions(max_iterations=5, landmark_error_weight=1.0)
    pg = tg.build_gsba_problem(q0, t0, cam, sem, [cyl0], go, points=pts,
                               obs=obs, device="cuda")
    cases["gsba"] = ("gsba", fields(pg), dataclasses.asdict(go),
                     lambda: tg.geometric_semantic_bundle_adjust(pg, go),
                     1e-6, ())
    rng = np.random.default_rng(3)
    n = 9
    ei, ej = np.arange(n - 1), np.arange(1, n)
    qv = np.tile([1.0, 0, 0, 0], (n, 1)) + rng.normal(0, 0.01, (n, 4))
    tv = np.cumsum(rng.normal(0, 1, (n, 3)), 0)
    rq, rt = tpg.relative_pose(*(torch.as_tensor(a) for a in (
        qv[ei], tv[ei], qv[ej], tv[ej])))
    qv[1:] += rng.normal(0, 0.02, (n - 1, 4))
    pp = tpg.make_problem(qv, tv, ei, ej, rq.numpy(), rt.numpy(), sim3=True,
                          dtype=torch.float64, device="cuda")
    po = tpg.PoseGraphOptions(sim3=True, max_iterations=20)
    cases["pose graph"] = ("pose_graph", fields(pp), dataclasses.asdict(po),
                           lambda: tpg.optimize_pose_graph(pp, po), 1e-6, ())
    return cases


def _check_spmd_runs(runs, cases):
    """Every rank returns the same bits and launched the case's kernels;
    the final costs match the single-device solves on the card."""
    for name, (_, _, _, single, rtol, kernels) in cases.items():
        for r in runs[1:]:
            for part in (0, 1):
                for k, v in runs[0][name][part].items():
                    np.testing.assert_array_equal(v, r[name][part][k],
                                                  err_msg=f"{name} {k}")
        for r in runs:
            assert all(r[name][2][k] > 0 for k in kernels), (name, r[name][2])
        ref = float(single()[1].final_cost)
        got = float(runs[0][name][1]["final_cost"])
        assert abs(got - ref) <= rtol * abs(ref), (name, got, ref)


def test_spmd_two_gloo_ranks_share_one_card(cuda, tmp_path):
    """Two gloo ranks on card 0 (NCCL refuses two ranks of one
    communicator on one GPU): every sharded solver, both ranks bit-equal,
    each rank's kernels launched, the final costs those of the
    single-device solves."""
    import torch_parallel_ranks as ranks

    from sba_tpu_torch.ops import cuda_build
    from sba_tpu_torch.parallel import group

    cuda_build.build()   # once, before the ranks load it
    cases = _spmd_cases()
    runs = group.run_ranks(ranks.solve_cases, 2, "gloo", "cuda:0",
                           args=({k: v[:3] for k, v in cases.items()},),
                           timeout=300, store_dir=str(tmp_path))
    _check_spmd_runs(runs, cases)


def test_spmd_nccl_one_rank_per_card(cuda, tmp_path):
    """NCCL at one rank per card (world size = the card count)."""
    import torch_parallel_ranks as ranks

    from sba_tpu_torch.ops import cuda_build
    from sba_tpu_torch.parallel import group

    cuda_build.build()
    cases = _spmd_cases()
    runs = group.run_ranks(ranks.solve_cases, torch.cuda.device_count(),
                           "nccl", "cuda",
                           args=({k: v[:3] for k, v in cases.items()},),
                           timeout=300, store_dir=str(tmp_path))
    _check_spmd_runs(runs, cases)
