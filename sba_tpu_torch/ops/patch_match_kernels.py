"""K6, the bilateral-weighted NCC cost of PatchMatch: CUDA wrapper and
its plain twin.

Port of ``sba_tpu/mvs/patch_match.py::_ncc_kernel_call``. `ncc_cost`
launches the hand-written kernel of ``csrc/patch_match_kernels.cu`` when
its tensors are on CUDA and runs `ncc_cost_plain` only when they lie on
the CPU. Both take the reference image ``ref [H, W]``, the sources
warped once onto the reference grid ``v [S, H, W]`` and their in-bounds
masks ``inb [S, H, W]``, and return ``cost [S, H, W]``:

    cost = 1 - clip(bilateral NCC over the window, -1, 1)

with the window's taps at `window_offsets(r, step)`, each weighted by
its spatial Gaussian, by whether it lies inside the image, and by the
reference's colour similarity to the centre; a pixel whose window lies
more than half outside its source gets 2.0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sba_tpu_torch.ops import cuda_build

# Launch count of the CUDA kernel (the wrapper adds one per launch).
LAUNCHES = {"ncc_cost": 0}


def reset_launches() -> None:
    LAUNCHES["ncc_cost"] = 0


def window_offsets(radius: int, step: int) -> np.ndarray:
    """[K, 2] window offsets (dx, dy), dy outer: ``arange(-radius,
    radius + 1, step)`` on both axes. With step > 1 the centre tap may be
    skipped (r=3, step=2: -3, -1, 1, 3)."""
    r = np.arange(-radius, radius + 1, step)
    oy, ox = np.meshgrid(r, r, indexing="ij")
    return np.stack([ox.reshape(-1), oy.reshape(-1)], -1)


def spatial_weights(radius: int, step: int, sigma_spatial: float
                    ) -> np.ndarray:
    """[K] float64 spatial Gaussian of each window tap."""
    offs = window_offsets(radius, step)
    return np.exp(-(offs[:, 0] ** 2 + offs[:, 1] ** 2)
                  / (2 * sigma_spatial ** 2))


def _gate_and_scale(radius, step, sigma_spatial, sigma_color):
    """(spatial weights, 1 / (2 sigma_c^2), FIN threshold) as the TPU
    kernel uses them: the threshold is half the weights' float64 sum."""
    w_sp = spatial_weights(radius, step, sigma_spatial)
    return w_sp, 1.0 / (2.0 * sigma_color ** 2), 0.5 * float(w_sp.sum())


def ncc_cost_plain(ref, v, inb, r: int, step: int, sigma_spatial: float,
                   sigma_color: float):
    """Plain PyTorch K6: the kernel's arithmetic on zero-padded planes,
    in the dtype of `ref` (the CPU path and the kernel's oracle)."""
    S, H, W = v.shape
    dt = ref.dtype
    w_sp, inv2sc2, fin_min = _gate_and_scale(r, step, sigma_spatial,
                                             sigma_color)
    w_sp = torch.tensor(w_sp, dtype=dt, device=ref.device)
    inv2sc2 = torch.tensor(inv2sc2, dtype=dt, device=ref.device)

    def pad(a):
        return F.pad(a, (r, r, r, r))

    ref_p = pad(ref)
    bnd_p = pad(torch.ones_like(ref))
    v_p = pad(v.to(dt))
    inb_p = pad(inb.to(dt))
    zero = torch.zeros(S, H, W, dtype=dt, device=ref.device)
    SW = torch.zeros_like(ref)
    SR = torch.zeros_like(ref)
    SRR = torch.zeros_like(ref)
    SV, SVV, SRV, FIN = zero, zero, zero, zero
    for k, (dx, dy) in enumerate(window_offsets(r, step).tolist()):
        ys = slice(r + dy, r + dy + H)
        xs = slice(r + dx, r + dx + W)
        r_k = ref_p[ys, xs]
        v_k = v_p[:, ys, xs]
        d = r_k - ref
        w = (w_sp[k] * bnd_p[ys, xs]) * torch.exp(-(d * d) * inv2sc2)
        wv = w * v_k
        wr = w * r_k
        SW = SW + w
        SR = SR + wr
        SRR = SRR + wr * r_k
        SV = SV + wv
        SVV = SVV + wv * v_k
        SRV = SRV + wr * v_k
        FIN = FIN + w_sp[k] * inb_p[:, ys, xs]
    wsum = torch.clamp(SW, min=1e-9)
    mr = SR / wsum
    vr = SRR / wsum - mr * mr
    ms = SV / wsum
    vs = SVV / wsum - ms * ms
    cov = SRV / wsum - mr * ms
    ncc = cov * torch.rsqrt(torch.clamp(vr * vs, min=1e-10))
    cost = 1.0 - torch.clamp(ncc, -1.0, 1.0)
    return torch.where(FIN > torch.tensor(fin_min, dtype=dt), cost,
                       torch.full_like(cost, 2.0))


def _check(t, name, shape, dtypes, device):
    if t.device != device or t.dtype not in dtypes \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"ncc_cost: {name} must be a contiguous {dtypes} "
                         f"tensor of shape {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def ncc_cost(ref, v, inb, r: int, step: int, sigma_spatial: float,
             sigma_color: float):
    """K6: cost [S, H, W] (see the module docstring). CUDA tensors go
    through the hand-written kernel (float32, `inb` bool or uint8); CPU
    tensors through `ncc_cost_plain`."""
    if not ref.is_cuda:
        return ncc_cost_plain(ref, v, inb, r, step, sigma_spatial,
                              sigma_color)
    S, H, W = v.shape
    _check(ref, "ref", (H, W), (torch.float32,), ref.device)
    _check(v, "v", (S, H, W), (torch.float32,), ref.device)
    _check(inb, "inb", (S, H, W), (torch.bool, torch.uint8), ref.device)
    if inb.dtype == torch.bool:
        inb = inb.view(torch.uint8)
    _, inv2sc2, fin_min = _gate_and_scale(r, step, sigma_spatial,
                                          sigma_color)
    cost = torch.empty_like(v)
    err = cuda_build.lib().sba_ncc_cost(
        H, W, S, r, step, float(sigma_spatial),
        float(np.float32(inv2sc2)), float(np.float32(fin_min)),
        ref.data_ptr(), v.data_ptr(), inb.data_ptr(), cost.data_ptr(),
        torch.cuda.current_stream(ref.device).cuda_stream)
    cuda_build.check(err, "sba_ncc_cost")
    LAUNCHES["ncc_cost"] += 1
    return cost
