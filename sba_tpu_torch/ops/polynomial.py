"""Polynomial roots by Durand-Kerner iteration.

Port of ``sba_tpu/ops/polynomial.py``: all roots at once, a fixed
number of iterations from fixed starting points on a spiral, batched
over leading dims, with the complex arithmetic written out over (re, im)
pairs as sba_tpu does (same operations, so the roots come out in the
same order).
"""

from __future__ import annotations

import numpy as np
import torch


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi, eps=1e-30):
    d = br * br + bi * bi
    d = torch.where(d > eps, d, torch.full_like(d, eps))
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def roots(coeffs, iters: int = 60):
    """All roots of real polynomials, coeffs [..., n+1] highest degree
    first -> (re [..., n], im [..., n])."""
    n = coeffs.shape[-1] - 1
    lead = coeffs[..., :1]
    safe_lead = torch.where(torch.abs(lead) > 1e-30, lead,
                            torch.ones_like(lead))
    monic = coeffs / safe_lead
    radius = 1.0 + torch.amax(torch.abs(monic[..., 1:]), dim=-1)
    init = np.power(0.4 + 0.9j, np.arange(1, n + 1))
    zr = radius[..., None] * torch.as_tensor(init.real, dtype=coeffs.dtype,
                                             device=coeffs.device)
    zi = radius[..., None] * torch.as_tensor(init.imag, dtype=coeffs.dtype,
                                             device=coeffs.device)
    eye = torch.eye(n, dtype=coeffs.dtype, device=coeffs.device)
    mon = [monic[..., i][..., None] for i in range(n + 1)]
    for _ in range(iters):
        pr = mon[0].expand_as(zr)
        pi = torch.zeros_like(zr)
        for i in range(1, n + 1):
            pr, pi = _cmul(pr, pi, zr, zi)
            pr = pr + mon[i]
        dr = zr[..., :, None] - zr[..., None, :] + eye
        di = zi[..., :, None] - zi[..., None, :]
        prod_r = dr[..., 0]
        prod_i = di[..., 0]
        for j in range(1, n):
            prod_r, prod_i = _cmul(prod_r, prod_i, dr[..., j], di[..., j])
        qr, qi = _cdiv(pr, pi, prod_r, prod_i)
        zr, zi = zr - qr, zi - qi
    return zr, zi


def real_roots(coeffs, iters: int = 60, imag_tol: float = 1e-6):
    """(real parts [..., n], is_real [..., n])."""
    zr, zi = roots(coeffs, iters)
    scale = 1.0 + torch.sqrt(zr * zr + zi * zi)
    return zr, torch.abs(zi) <= imag_tol * scale


def polyval(coeffs, x):
    """Horner evaluation, coeffs [..., n+1] highest first."""
    p = coeffs[..., 0]
    for i in range(1, coeffs.shape[-1]):
        p = p * x + coeffs[..., i]
    return p
