"""Essential matrix solvers: Nister 5-point, normalized 8-point, pose.

Port of ``sba_tpu/estimators/essential_matrix.py`` (ref: src/estimators/
essential_matrix.{h,cc}, src/base/essential_matrix.cc). The 5-point
solver follows sba_tpu's steps: a 4-D null space from the SVD of the
[5, 9] epipolar system, the 10 cubic constraints in Nister's 20-monomial
order, one batched 10x10 solve, Nister's elimination to the 3x3
polynomial matrix B(z), and the degree-10 roots by Durand-Kerner
iteration. The cubic constraints are built as coefficient tensors over
the monomials (x, y, z, 1) by einsum and one fixed [64, 20] fold, where
sba_tpu expands them term by term; both give the same coefficients up
to rounding.

The null-space basis that LAPACK or cuSOLVER return is one basis of the
space, not sba_tpu's: the same set of solutions comes out in another
order and with other signs.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from sba_tpu_torch.estimators import _linalg
from sba_tpu_torch.estimators.fundamental_matrix import (
    _epipolar_rows, _normalize_points, sampson_error_f)
from sba_tpu_torch.ops.polynomial import real_roots

# Nister's 20-monomial order (x, y, z exponents; the first 10 are
# eliminated by the 10x10 solve).
_MONOS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0),
    (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1), (0, 1, 0),
    (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_EXP = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0))   # x, y, z, 1


def _fold_matrix() -> np.ndarray:
    """[64, 20]: a product m_a m_b m_d of (x, y, z, 1) -> its monomial."""
    idx = {m: i for i, m in enumerate(_MONOS)}
    M = np.zeros((64, 20))
    for a, b, d in itertools.product(range(4), repeat=3):
        e = tuple(_EXP[a][k] + _EXP[b][k] + _EXP[d][k] for k in range(3))
        M[(a * 4 + b) * 4 + d, idx[e]] = 1.0
    return M


_FOLD = _fold_matrix()
_LEVI = np.zeros((3, 3, 3))
for _p in itertools.permutations(range(3)):
    _LEVI[_p] = np.linalg.det(np.eye(3)[list(_p)])


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _cubic_constraints(B):
    """B [..., 4, 3, 3] (E = x B0 + y B1 + z B2 + B3) -> the 10 cubic
    equations det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0 as [..., 10, 20]
    coefficients in Nister's monomial order."""
    det = torch.einsum("ijk,...ai,...bj,...dk->...abd", _const(_LEVI, B),
                       B[..., :, 0, :], B[..., :, 1, :], B[..., :, 2, :])
    Q = torch.einsum("...ark,...bck->...rcab", B, B)          # E E^T
    L = torch.einsum("...rkab,...dkc->...rcabd", Q, B)        # E E^T E
    T = torch.einsum("...rrab->...ab", Q)                     # tr(E E^T)
    C = 2.0 * L - torch.einsum("...ab,...drc->...rcabd", T, B)
    cub = torch.cat([det.reshape(det.shape[:-3] + (1, 64)),
                     C.reshape(C.shape[:-5] + (9, 64))], -2)
    return cub @ _const(_FOLD, B)


def _pad_to(p, n):
    pad = n - p.shape[-1]
    if pad == 0:
        return p
    return torch.cat([p.new_zeros(p.shape[:-1] + (pad,)), p], -1)


def _shift_z(p):
    return torch.cat([p, p.new_zeros(p.shape[:-1] + (1,))], -1)


def _conv(p, q):
    """Product of highest-first coefficient arrays."""
    n1, n2 = p.shape[-1], q.shape[-1]
    terms = [[] for _ in range(n1 + n2 - 1)]
    for i in range(n1):
        for j in range(n2):
            terms[i + j].append(p[..., i] * q[..., j])
    return torch.stack([sum(t[1:], t[0]) for t in terms], -1)


def _combine(rA, rB):
    """<A> - z <B> of two reduced rows -> (x deg 3, y deg 3, 1 deg 4)."""
    def split(r):
        return r[..., 0:3], r[..., 3:6], r[..., 6:10]
    ax, ay, a1 = split(rA)
    bx, by, b1 = split(rB)
    return (_pad_to(ax, 4) - _shift_z(bx), _pad_to(ay, 4) - _shift_z(by),
            _pad_to(a1, 5) - _shift_z(b1))


def _psub(p, q):
    n = max(p.shape[-1], q.shape[-1])
    return _pad_to(p, n) - _pad_to(q, n)


def _evalp(p, z):
    out = p[..., 0:1] * torch.ones_like(z)
    for i in range(1, p.shape[-1]):
        out = out * z + p[..., i:i + 1]
    return out


def essential_5pt(xy1, xy2):
    """Nister 5-point: up to 10 essential matrices. xy* [..., 5, 2]
    normalized coords -> (E [..., 10, 3, 3], valid [..., 10])."""
    A = _epipolar_rows(xy1, xy2)
    Vt = _linalg.svd(A, full_matrices=True).Vh              # [..., 9, 9]
    B = torch.stack([Vt[..., 8 - i, :].reshape(Vt.shape[:-2] + (3, 3))
                     for i in range(4)], -3)                 # [..., 4, 3, 3]
    C = _cubic_constraints(B)
    Mred = _linalg.solve(C[..., :, :10], C[..., :, 10:])
    kx, ky, k1 = _combine(Mred[..., 4, :], Mred[..., 5, :])
    lx, ly, l1 = _combine(Mred[..., 6, :], Mred[..., 7, :])
    mx, my, m1 = _combine(Mred[..., 8, :], Mred[..., 9, :])
    d1 = _conv(k1, _psub(_conv(lx, my), _conv(ly, mx)))
    d2 = _conv(l1, _psub(_conv(kx, my), _conv(ky, mx)))
    d3 = _conv(m1, _psub(_conv(kx, ly), _conv(ky, lx)))
    det = _psub(_psub(d1, d2), d3 * -1.0)
    z, ok = real_roots(det, iters=80)
    Kx, Ky, K1 = _evalp(kx, z), _evalp(ky, z), _evalp(k1, z)
    Lx, Ly, L1 = _evalp(lx, z), _evalp(ly, z), _evalp(l1, z)
    detM = Kx * Ly - Ky * Lx
    safe = torch.where(torch.abs(detM) > 1e-20, detM,
                       torch.full_like(detM, 1e-20))
    x = (-K1 * Ly + L1 * Ky) / safe
    y = (-Kx * L1 + Lx * K1) / safe
    Es = (x[..., None, None] * B[..., None, 0, :, :]
          + y[..., None, None] * B[..., None, 1, :, :]
          + z[..., None, None] * B[..., None, 2, :, :]
          + B[..., None, 3, :, :])
    ok = ok & (torch.abs(detM) > 1e-18) & torch.isfinite(x) \
        & torch.isfinite(y)
    return _linalg.frob_normalize(Es), ok


def essential_8pt(xy1, xy2):
    """Normalized 8-point for E with (s, s, 0) singular values; xy*
    [..., M >= 8, 2] normalized coords -> E [..., 3, 3]."""
    n1, T1 = _normalize_points(xy1)
    n2, T2 = _normalize_points(xy2)
    A = _epipolar_rows(n1, n2)
    V = _linalg.eigh_vectors(torch.einsum("...mi,...mj->...ij", A, A))
    E = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    E = torch.einsum("...ji,...jk,...kl->...il", T2, E, T1)
    U, S, Vt = _linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) / 2.0
    S2 = torch.stack([s, s, torch.zeros_like(s)], -1)
    E = torch.einsum("...ik,...k,...kj->...ij", U, S2, Vt)
    return _linalg.frob_normalize(E)


_W = ((0.0, 1.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def decompose_essential(E):
    """E -> (R1, R2, t) candidates (ref: src/base/essential_matrix.cc
    DecomposeEssentialMatrix)."""
    U, S, Vt = _linalg.svd(E)
    U = U * torch.sign(_linalg.det3(U))[..., None, None]
    Vt = Vt * torch.sign(_linalg.det3(Vt))[..., None, None]
    W = _const(_W, E)
    R1 = torch.einsum("...ik,kl,...lj->...ij", U, W, Vt)
    R2 = torch.einsum("...ik,lk,...lj->...ij", U, W, Vt)
    return R1, R2, U[..., :, 2]


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def pose_from_essential(E, xy1, xy2, mask=None):
    """Cheirality-resolved relative pose: (R [..., 3, 3], t [..., 3],
    num_in_front [...]) for the best of the four decompositions, with
    the closed-form two-view depths of sba_tpu (ref: essential_matrix.cc
    PoseFromEssentialMatrix)."""
    if mask is None:
        mask = torch.ones(xy1.shape[:-1], dtype=E.dtype, device=E.device)
    mask = mask.to(E.dtype)
    R1, R2, t = decompose_essential(E)
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    f1 = torch.cat([xy1, torch.ones_like(xy1[..., :1])], -1)
    f2 = torch.cat([xy2, torch.ones_like(xy2[..., :1])], -1)

    def count_front(R, tv):
        Rf1 = torch.einsum("...ij,...mj->...mi", R, f1)
        a = _cross(Rf1, f2)
        b = -_cross(tv[..., None, :].expand(f2.shape), f2)
        denom = torch.sum(a * a, -1)
        z1 = torch.sum(a * b, -1) / torch.where(
            denom > 1e-20, denom, torch.full_like(denom, 1e-20))
        z2 = z1 * Rf1[..., 2] + tv[..., None, 2]
        ok = (z1 > 0) & (z2 > 0) & (z1 < 1000.0) & (z2 < 1000.0)
        return torch.sum(ok * mask, -1)

    counts = torch.stack([count_front(R, tv) for R, tv in cands], -1)
    best = torch.argmax(counts, -1)
    Rs = torch.stack([c[0] for c in cands], -3)
    ts = torch.stack([c[1] for c in cands], -2)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3)))[..., 0, :, :]
    tv = torch.gather(ts, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    return R, tv, torch.amax(counts, -1)


def sampson_error_e(E, xy1, xy2, eps=1e-12):
    return sampson_error_f(E, xy1, xy2, eps)
