"""Small batched dense linear algebra for the minimal solvers.

``torch.linalg`` raises where LAPACK or cuSOLVER report a failure (a
singular system, a non-finite input), while sba_tpu's ``jnp.linalg``
returns inf or NaN and lets the RANSAC scoring mask the model. These
helpers keep sba_tpu's behaviour: solves go through ``solve_ex`` and
the decompositions see non-finite entries as zeros (the model they
feed is masked or dropped either way).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def finite(a):
    return torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)


# Matrices per batched cuSOLVER call: its batched eigensolver refuses
# large batches (CUSOLVER_STATUS_INVALID_VALUE at 32 x 1024 9x9 systems
# on the H100).
MAX_BATCH = 8192


def _chunked(fn, a):
    """fn over [..., m, n] in batches of at most MAX_BATCH matrices; fn
    returns a tuple of tensors with the same leading dims."""
    lead = a.shape[:-2]
    flat = finite(a).reshape((-1,) + a.shape[-2:])
    if flat.shape[0] <= MAX_BATCH:
        return tuple(x.reshape(lead + x.shape[1:]) for x in fn(flat))
    parts = [fn(flat[i:i + MAX_BATCH])
             for i in range(0, flat.shape[0], MAX_BATCH)]
    return tuple(torch.cat(xs).reshape(lead + xs[0].shape[1:])
                 for xs in zip(*parts))


def eigh_vectors(a):
    """Eigenvectors of symmetric [..., n, n], ascending eigenvalues."""
    return _chunked(lambda m: (torch.linalg.eigh(m).eigenvectors,), a)[0]


def eigh(a):
    """(eigenvalues [..., n] ascending, eigenvectors [..., n, n])."""
    return _chunked(lambda m: tuple(torch.linalg.eigh(m)), a)


class _Svd(NamedTuple):
    U: torch.Tensor
    S: torch.Tensor
    Vh: torch.Tensor


def svd(a, full_matrices: bool = False):
    return _Svd(*_chunked(lambda m: tuple(torch.linalg.svd(
        m, full_matrices=full_matrices)), a))


def solve(a, b):
    """a^-1 b without raising on singular a (no error check)."""
    return torch.linalg.solve_ex(a, b, check_errors=False).result


def det3(m):
    """Closed-form determinant of [..., 3, 3]."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def frob_normalize(m, eps: float = 1e-12):
    """m / max(||m||_F, eps) over the last two axes."""
    n = torch.linalg.norm(m.reshape(m.shape[:-2] + (-1,)), dim=-1)
    return m / torch.clamp(n, min=eps)[..., None, None]
