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
