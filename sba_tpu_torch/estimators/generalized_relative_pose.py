"""Generalized (rig-to-rig) relative pose: GR6P.

Port of ``sba_tpu/estimators/generalized_relative_pose.py`` (ref: src/
estimators/generalized_relative_pose.{h,cc} `GR6PEstimator`, Kneip & Li
CVPR 2014): from 2D-2D correspondences seen by the cameras of two rig
frames, the rig1 -> rig2 transform. Minimal sample: 8.

The objective is the generalized epipolar constraint in matrix form,
a_i(R) . t + b_i(R) = 0 with a_i = (R f1_i) x f2_i and
b_i = f2_i . (R m1_i) + m2_i . (R f1_i) for Pluecker lines (f, m = c x f);
the cost is the smallest eigenvalue of M(R) = [A b]^T [A b], minimized
over a Cayley rotation by L-BFGS-B from several starts.

The minimal solver stays what sba_tpu's is: host float64 numpy and
scipy's L-BFGS-B with numpy's restarts (`gr6p_solve`, a copy of
sba_tpu's), so that its iterates are sba_tpu's. The scoring of every
correspondence against each candidate (`generalized_sampson_errors`) is
a torch function on the caller's device, all of a trial's candidates at
once. The RANSAC's samples and the solver's seeds come from an explicit
``torch.Generator``, or from `draw_fn` (a test hands in sba_tpu's).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


def _cayley_to_rotmat(c):
    c0, c1, c2 = c
    s = 1.0 + c0 * c0 + c1 * c1 + c2 * c2
    R = np.array([
        [1 + c0 * c0 - c1 * c1 - c2 * c2, 2 * (c0 * c1 - c2),
         2 * (c0 * c2 + c1)],
        [2 * (c0 * c1 + c2), 1 - c0 * c0 + c1 * c1 - c2 * c2,
         2 * (c1 * c2 - c0)],
        [2 * (c0 * c2 - c1), 2 * (c1 * c2 + c0),
         1 - c0 * c0 - c1 * c1 + c2 * c2],
    ])
    return R / s


def _rotmat_to_cayley(R):
    C = (R - np.eye(3)) @ np.linalg.inv(R + np.eye(3))
    return np.array([-C[1, 2], C[0, 2], -C[0, 1]])


def compose_pluecker(cam_R, cam_t, xy):
    """Pluecker lines of the correspondences in the RIG frame.

    cam_R [K,3,3], cam_t [K,3]: camera-from-rig extrinsics of the camera
    observing each correspondence; xy [K,2] normalized image points.
    Returns (f [K,3] unit bearings, m [K,3] moments = c x f)
    (ref: generalized_relative_pose.cc:71-80 ComposePlueckerData)."""
    xyh = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    f = np.einsum("kji,kj->ki", cam_R, xyh)
    f = f / np.linalg.norm(f, axis=1, keepdims=True)
    c = -np.einsum("kji,kj->ki", cam_R, cam_t)
    return f, np.cross(c, f)


def _build_Ab(R, f1, m1, f2, m2):
    Rf1 = f1 @ R.T
    Rm1 = m1 @ R.T
    a = np.cross(Rf1, f2)
    b = np.sum(f2 * Rm1, axis=1) + np.sum(m2 * Rf1, axis=1)
    return np.concatenate([a, b[:, None]], axis=1)      # [K, 4]


def _build_M(R, f1, m1, f2, m2):
    """[A b]^T [A b]: the 4x4 generalized-epipolar normal matrix."""
    Ab = _build_Ab(R, f1, m1, f2, m2)
    return Ab.T @ Ab


def _lambda_min_and_grad(cayley, f1, m1, f2, m2):
    """The smallest eigenvalue and its gradient,
    d lambda = 2 (Ab v) . (dAb v), v the unit eigenvector (dR by central
    differences of the Cayley map)."""
    R = _cayley_to_rotmat(cayley)
    Ab = _build_Ab(R, f1, m1, f2, m2)
    w, V = np.linalg.eigh(Ab.T @ Ab)
    v = V[:, 0]
    r = Ab @ v
    grad = np.zeros(3)
    eps = 1e-7
    for j in range(3):
        dR = (_cayley_to_rotmat(cayley + eps * np.eye(3)[j])
              - _cayley_to_rotmat(cayley - eps * np.eye(3)[j])) / (2 * eps)
        dRf1 = f1 @ dR.T
        da = np.cross(dRf1, f2)
        db = np.sum(f2 * (m1 @ dR.T), axis=1) + np.sum(m2 * dRf1, axis=1)
        dAb = np.concatenate([da, db[:, None]], axis=1)
        grad[j] = 2.0 * np.dot(r, dAb @ v)
    return w[0], grad


def _central_essential_init(f1, f2):
    """The two rotations of the 8-point essential matrix on the bearings,
    both rigs taken as central cameras (offsets ignored)."""
    A = np.einsum("ki,kj->kij", f2, f1).reshape(len(f1), 9)
    _, _, Vt = np.linalg.svd(A)
    E = Vt[-1].reshape(3, 3)
    U, _, Vt2 = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U[:, 2] *= -1
    if np.linalg.det(Vt2) < 0:
        Vt2[2] *= -1
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    return [U @ W @ Vt2, U @ W.T @ Vt2]


def _init_rotation(f1, f2):
    """Kabsch alignment of the bearing clouds (ref: .cc:116-153
    ComputeRotationBetweenPoints)."""
    g1 = f1 - f1.mean(axis=0)
    g2 = f2 - f2.mean(axis=0)
    U, _, Vt = np.linalg.svd(g2.T @ g1)
    d = np.sign(np.linalg.det(U @ Vt))
    return U @ np.diag([1.0, 1.0, d]) @ Vt


def gr6p_solve(cam_R1, cam_t1, xy1, cam_R2, cam_t2, xy2, seed=0,
               max_iterations=50, fast=False):
    """GR6P on >= 6 (use 8) correspondences (host, float64). Returns up
    to 4 candidate (R, t) rig1 -> rig2 transforms, one per eigenvector of
    M at the best rotation (ref: .cc:577-585). Starts: Kabsch, the two
    central essential-matrix rotations and (unless `fast`, the RANSAC
    trials' mode: two starts, 25 iterations) three random perturbations
    drawn from numpy's generator at `seed`."""
    from scipy.optimize import minimize

    f1, m1 = compose_pluecker(cam_R1, cam_t1, xy1)
    f2, m2 = compose_pluecker(cam_R2, cam_t2, xy2)
    rng = np.random.default_rng(seed)
    init = _rotmat_to_cayley(_init_rotation(f1, f2))
    starts = [init]
    try:
        starts.extend(_rotmat_to_cayley(Rc)
                      for Rc in _central_essential_init(f1, f2))
    except np.linalg.LinAlgError:
        pass
    if fast:
        starts = starts[:2]
        max_iterations = min(max_iterations, 25)
    else:
        for trial in range(3):
            amp = 0.3 if trial < 2 else 0.6
            starts.append(init + rng.uniform(-amp, amp, 3))

    exit_cost = 1e-11 if fast else 1e-14
    best = init
    best_cost = np.inf
    for cay0 in starts:
        res = minimize(
            lambda c: _lambda_min_and_grad(c, f1, m1, f2, m2),
            cay0, jac=True, method="L-BFGS-B",
            options={"maxiter": max_iterations, "gtol": 1e-16,
                     "ftol": 1e-18})
        if res.fun < best_cost:
            best, best_cost = res.x, res.fun
        if best_cost < exit_cost:
            break

    R = _cayley_to_rotmat(best)
    _, V = np.linalg.eigh(_build_M(R, f1, m1, f2, m2))
    models = []
    for i in range(4):
        v = V[:, i]
        if abs(v[3]) < 1e-12:
            continue
        models.append((R, v[:3] / v[3]))
    return models


def generalized_sampson_errors(R, t, cam_R1, cam_t1, xy1, cam_R2, cam_t2,
                               xy2):
    """Squared Sampson errors [..., K] of the correspondences under the
    rig transforms R [..., 3, 3], t [..., 3], each through its own camera
    pair: E_k = [t12_k]x R12_k of cam2-from-cam1 = cam2-from-rig2 .
    rig2-from-rig1 . rig1-from-cam1 (ref: .cc:588-617 Residuals). Torch
    tensors on one device."""
    R = R[..., None, :, :]
    t = t[..., None, :, None]
    R12 = cam_R2 @ R @ cam_R1.transpose(-1, -2)          # [..., K, 3, 3]
    t12 = (cam_t2 + (cam_R2 @ t)[..., 0]
           - (R12 @ cam_t1[..., None])[..., 0])
    tx = torch.zeros_like(R12)
    tx[..., 0, 1] = -t12[..., 2]
    tx[..., 0, 2] = t12[..., 1]
    tx[..., 1, 0] = t12[..., 2]
    tx[..., 1, 2] = -t12[..., 0]
    tx[..., 2, 0] = -t12[..., 1]
    tx[..., 2, 1] = t12[..., 0]
    E = tx @ R12
    h1 = torch.cat([xy1, torch.ones_like(xy1[..., :1])], -1)
    h2 = torch.cat([xy2, torch.ones_like(xy2[..., :1])], -1)
    Ex1 = (E @ h1[..., None])[..., 0]
    Etx2 = (E.transpose(-1, -2) @ h2[..., None])[..., 0]
    num = torch.sum(h2 * Ex1, dim=-1)
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return num * num / torch.clamp(den, min=1e-18)


@dataclass(frozen=True)
class GeneralizedRelativePoseOptions:
    max_error: float = 0.01          # Sampson, normalized coords
    min_inlier_ratio: float = 0.2
    confidence: float = 0.999
    max_num_trials: int = 100
    min_num_inliers: int = 10


class GeneralizedRelativePoseReport(NamedTuple):
    R: np.ndarray                    # [3,3] rig1->rig2
    t: np.ndarray                    # [3]
    inlier_mask: np.ndarray          # [K] bool
    num_inliers: int
    success: bool


def _torch_draws(num: int, generator: torch.Generator):
    """The default draws: a trial's 8 distinct indices and the seed of
    its solver's restarts, from `generator`."""
    idx = torch.randperm(num, generator=generator,
                         device=generator.device)[:8]
    seed = torch.randint(2 ** 31, (1,), generator=generator,
                         device=generator.device)
    return idx.cpu().numpy(), int(seed)


def estimate_generalized_relative_pose(
        cam_R1, cam_t1, xy1, cam_R2, cam_t2, xy2,
        options: Optional[GeneralizedRelativePoseOptions] = None,
        seed: int = 0, device="cuda",
        generator: Optional[torch.Generator] = None,
        draw_fn: Optional[Callable] = None
) -> GeneralizedRelativePoseReport:
    """RANSAC GR6P over rig-to-rig correspondences (numpy inputs: the
    per-correspondence camera-from-rig extrinsics and normalized points
    of both rig frames), with sba_tpu's adaptive trial count, its exit
    at 85% support and its refit on all inliers (solver seed `seed + 1`).

    The correspondences go to `device` once; each trial's candidates are
    scored there together. `draw_fn()` -> (8 indices, solver seed) gives
    each trial's draws; by default they come from `generator` (a CPU
    generator seeded `seed` if None)."""
    opt = options or GeneralizedRelativePoseOptions()
    K = len(xy1)
    best = GeneralizedRelativePoseReport(
        np.eye(3), np.zeros(3), np.zeros(K, bool), 0, False)
    if K < 8:
        return best
    if draw_fn is None:
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        gen = generator

        def draw_fn():
            return _torch_draws(K, gen)

    data = [torch.as_tensor(np.asarray(a, np.float64), device=device)
            for a in (cam_R1, cam_t1, xy1, cam_R2, cam_t2, xy2)]
    thr2 = opt.max_error * opt.max_error

    def score(models):
        R = torch.as_tensor(np.stack([m[0] for m in models]), device=device)
        t = torch.as_tensor(np.stack([m[1] for m in models]), device=device)
        inl = (generalized_sampson_errors(R, t, *data) < thr2).cpu().numpy()
        return inl, inl.sum(axis=1)

    max_trials = opt.max_num_trials
    trial = 0
    while trial < max_trials:
        trial += 1
        idx, solver_seed = draw_fn()
        try:
            models = gr6p_solve(cam_R1[idx], cam_t1[idx], xy1[idx],
                                cam_R2[idx], cam_t2[idx], xy2[idx],
                                seed=solver_seed, fast=True)
        except np.linalg.LinAlgError:
            continue
        if models:
            inl, counts = score(models)
            for (R, t), m, n in zip(models, inl, counts.tolist()):
                if n > best.num_inliers:
                    best = GeneralizedRelativePoseReport(R, t, m, n, True)
                    ratio = max(n / K, opt.min_inlier_ratio)
                    denom = np.log(max(1.0 - ratio ** 8, 1e-12))
                    if denom < 0:
                        need = int(np.ceil(np.log(max(
                            1.0 - opt.confidence, 1e-12)) / denom))
                        max_trials = min(max_trials, max(trial, need))
        if best.num_inliers >= 0.85 * K:
            break
    if best.num_inliers >= opt.min_num_inliers:
        keep = np.nonzero(best.inlier_mask)[0]
        try:
            models = gr6p_solve(cam_R1[keep], cam_t1[keep], xy1[keep],
                                cam_R2[keep], cam_t2[keep], xy2[keep],
                                seed=seed + 1)
            if models:
                inl, counts = score(models)
                for (R, t), m, n in zip(models, inl, counts.tolist()):
                    if n >= best.num_inliers:
                        best = GeneralizedRelativePoseReport(R, t, m, n,
                                                             True)
        except np.linalg.LinAlgError:
            pass
    else:
        best = best._replace(success=False)
    return best
