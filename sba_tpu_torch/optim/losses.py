"""Robust loss functions (Ceres semantics), port of ``sba_tpu/optim/losses.py``.

A loss rho(s) acts on the SQUARED residual norm s = ||r||^2; the total
cost is 1/2 sum rho(s_i). Gauss-Newton/LM uses IRLS re-weighting with
w = rho'(s). All functions are elementwise on tensors.
"""

from __future__ import annotations

import torch


def _trivial(s, a2):
    return s


def _trivial_d(s, a2):
    return torch.ones_like(s)


def _huber(s, a2):
    a = a2 ** 0.5
    r = torch.sqrt(torch.clamp(s, min=1e-20))
    return torch.where(s <= a2, s, 2.0 * a * r - a2)


def _huber_d(s, a2):
    a = a2 ** 0.5
    r = torch.sqrt(torch.clamp(s, min=1e-20))
    return torch.where(s <= a2, torch.ones_like(s), a / r)


def _soft_l1(s, a2):
    return 2.0 * a2 * (torch.sqrt(1.0 + s / a2) - 1.0)


def _soft_l1_d(s, a2):
    return 1.0 / torch.sqrt(1.0 + s / a2)


def _cauchy(s, a2):
    return a2 * torch.log1p(s / a2)


def _cauchy_d(s, a2):
    return 1.0 / (1.0 + s / a2)


LOSSES = {
    "trivial": (_trivial, _trivial_d),
    "huber": (_huber, _huber_d),
    "soft_l1": (_soft_l1, _soft_l1_d),
    "cauchy": (_cauchy, _cauchy_d),
}

# Integer ids the CUDA kernels switch on (csrc/ba_kernels.cuh, loss_*).
LOSS_IDS = {name: i for i, name in enumerate(LOSSES)}


def loss_value(name: str, s, scale: float = 1.0):
    """rho(s) for squared norms s; `scale` is the Ceres loss scale a."""
    fn, _ = LOSSES[name]
    return fn(s, scale * scale)


def loss_weight(name: str, s, scale: float = 1.0):
    """IRLS weight rho'(s)."""
    _, d = LOSSES[name]
    return d(s, scale * scale)
