"""L1 (least-absolute-deviations) linear solver by ADMM.

Port of ``sba_tpu/optim/least_absolute_deviations.py`` (ref: src/optim/
least_absolute_deviations.{h,cc} `SolveLeastAbsoluteDeviations`, the
ADMM of Boyd et al. for min ||Ax - b||_1). The normal matrix A^T A is
factored once by Cholesky, as the reference factors it once; each ADMM
iteration is two matrix-vector products and one pair of triangular
solves on A's device. The loop stops at the first iteration whose
primal and dual residuals are under tolerance, as sba_tpu's
``lax.while_loop`` does: the host reads that test once per iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch


@dataclass(frozen=True)
class LADOptions:
    """Mirrors ref: least_absolute_deviations.h Options."""

    rho: float = 1.0
    alpha: float = 1.0           # over-relaxation
    max_num_iterations: int = 1000
    absolute_tolerance: float = 1e-4
    relative_tolerance: float = 1e-2


class LADResult(NamedTuple):
    x: torch.Tensor
    num_iterations: int
    converged: bool


def solve_least_absolute_deviations(
        A, b, x0=None, options: Optional[LADOptions] = None) -> LADResult:
    """min_x ||A x - b||_1 for a dense A [M, N] and b [M] (tensors on one
    device; the translation-averaging systems this serves are small)."""
    opt = options or LADOptions()
    m, n = A.shape
    x = A.new_zeros(n) if x0 is None else torch.as_tensor(
        x0, dtype=A.dtype, device=A.device)
    z = A.new_zeros(m)
    u = A.new_zeros(m)
    L = torch.linalg.cholesky(
        A.T @ A + 1e-12 * torch.eye(n, dtype=A.dtype, device=A.device))
    sqrt_m, sqrt_n = m ** 0.5, n ** 0.5

    def shrinkage(v, kappa):
        return torch.clamp(v - kappa, min=0.0) - torch.clamp(-v - kappa,
                                                             min=0.0)

    it = 0
    done = False
    while it < opt.max_num_iterations and not done:
        q = A.T @ (b + z - u)
        x = torch.cholesky_solve(q[:, None], L)[:, 0]
        Ax = A @ x
        Ax_hat = opt.alpha * Ax + (1 - opt.alpha) * (z + b)
        z_old = z
        z = shrinkage(Ax_hat - b + u, 1.0 / opt.rho)
        u = u + Ax_hat - z - b
        r_norm = torch.linalg.norm(Ax - z - b)
        s_norm = torch.linalg.norm(-opt.rho * (A.T @ (z - z_old)))
        eps_pri = sqrt_m * opt.absolute_tolerance \
            + opt.relative_tolerance * torch.maximum(
                torch.linalg.norm(Ax),
                torch.maximum(torch.linalg.norm(z), torch.linalg.norm(b)))
        eps_dual = sqrt_n * opt.absolute_tolerance \
            + opt.relative_tolerance * torch.linalg.norm(opt.rho * A.T @ u)
        done = bool((r_norm < eps_pri) & (s_norm < eps_dual))
        it += 1
    return LADResult(x=x, num_iterations=it, converged=done)
