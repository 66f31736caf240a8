"""Similarity / rigid transform estimation (Umeyama) + alignment.

Port of ``sba_tpu/geometry/similarity.py`` (ref: src/base/
similarity_transform.{h,cc}): the batched closed form, with the 3x3 SVD
through the port's `estimators/_linalg` helpers (non-finite entries read
as zeros, where ``jnp.linalg`` would return NaN: the caller masks such
models either way).
"""

from __future__ import annotations

import torch

from sba_tpu_torch.estimators import _linalg
from sba_tpu_torch.geometry.quaternions import rotmat_to_quat


def umeyama(src, dst, weights=None, with_scale=True, eps=1e-12):
    """Least-squares similarity transform dst ~ s R src + t.

    src, dst: [..., M, 3]; weights: [..., M] optional.
    Returns (s [...], R [..., 3, 3], t [..., 3]).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(torch.sum(weights, -1, keepdim=True), min=eps)
    mu_s = torch.einsum("...m,...mi->...i", w, src)
    mu_d = torch.einsum("...m,...mi->...i", w, dst)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = torch.einsum("...m,...mi,...mj->...ij", w, dc, sc)  # dst x src
    U, S, Vt = _linalg.svd(cov)
    d = torch.sign(_linalg.det3(U) * _linalg.det3(Vt))
    D = torch.ones(cov.shape[:-2] + (3,), dtype=src.dtype, device=src.device)
    D[..., 2] = d
    R = torch.einsum("...ik,...k,...kj->...ij", U, D, Vt)
    if with_scale:
        var_s = torch.einsum("...m,...mi,...mi->...", w, sc, sc)
        s = torch.sum(S * D, dim=-1) / torch.clamp(var_s, min=eps)
    else:
        s = torch.ones(cov.shape[:-2], dtype=src.dtype, device=src.device)
    t = mu_d - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return s, R, t


def rigid_from_points(src, dst, weights=None):
    """Rigid (scale=1) alignment: returns (qvec, R, t) with dst = R src + t."""
    s, R, t = umeyama(src, dst, weights, with_scale=False)
    return rotmat_to_quat(R), R, t


def apply_similarity(s, R, t, points):
    return (s[..., None, None] * torch.einsum("...ij,...mj->...mi", R, points)
            + t[..., None, :])
