"""Tests of the port that need an NVIDIA card (marker `cuda`).

They skip where torch sees no CUDA device. On the card (where JAX is not
installed) run them without the repository's JAX conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from sba_tpu_torch.ops import ba_kernels as bk
from sba_tpu_torch.optim import ba_fused
from sba_tpu_torch.optim.ba import BAOptions, bundle_adjust
from sba_tpu_torch.utils.synthetic import make_ba_problem

pytestmark = pytest.mark.cuda

_SMALL = dict(num_images=6, num_points=150, observations_per_point=4,
              pose_noise=0.01, point_noise=0.05, pixel_noise=0.5, seed=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("model_id", [0, 1, 2])
def test_kernels_match_twins(cuda, model_id):
    problem, _ = make_ba_problem(dtype=torch.float32, device=cuda,
                                 model_id=model_id, **_SMALL)
    opt = BAOptions(model_id=model_id, dtype="float32", schur_bf16=False)
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
        duc = torch.zeros(12, lay.C, device=cuda)
        dp_k, acc_k = bk.backsub(st, dup, duc, k1[3], k1[4], lam, lay, opt)
        dp_p, acc_p = bk.backsub_plain(st, dup, duc, k1[3], k1[4], lam, lay,
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
    assert float((out_g.tvecs.cpu() - out_c.tvecs).abs().max()) <= 5e-3


def test_unported_pieces_raise_on_card(cuda):
    problem, _ = make_ba_problem(dtype=torch.float32, device=cuda,
                                 model_id=4, **_SMALL)
    with pytest.raises(NotImplementedError, match="camera model 4"):
        bundle_adjust(problem, BAOptions(model_id=4, dtype="float32"))
    # More than 128 images: no longer raises, but runs the implicit
    # path through K2 and K3.
    big, _ = make_ba_problem(dtype=torch.float32, device=cuda,
                             **dict(_SMALL, num_images=130))
    bk.reset_launches()
    _, s = bundle_adjust(big, BAOptions(dtype="float32", max_iterations=5))
    assert float(s.final_cost) < float(s.initial_cost)
    assert bk.LAUNCHES["fused_reduce"] > 0 and bk.LAUNCHES["schur_matvec"] > 0
    assert bk.LAUNCHES["fused_schur"] == 0
