"""Semantic bundle adjustment: dense pairwise semantic consistency,
pose-only. Port of ``sba_tpu/optim/sba.py``.

For every ordered image pair (src, dst) and every pixel of src on a
stride grid (``pixel_step``), skipping zero-depth pixels, one residual:
unproject the pixel with src's depth map, transform through pose_src^-1
then pose_dst, project into dst (SIMPLE_PINHOLE), then

- hard mode (the reference's semantics): round to the nearest pixel;
  out of bounds -> 0 (OUT_OF_BOUNDS); |depth_dst - projected depth| >
  depth_error_threshold -> 0 (INVALID_DEPTH); else 0/1 on label
  equality (VALID). Jacobians by numeric central differences
  (``mode="hard_numeric"``).
- soft mode: bilinear sampling, sigmoid bounds and depth gates, and
  ``r = 1 - gates * bilinear label agreement``; Jacobians closed form
  (``linearize="analytic"``, packed maps) or by forward-mode AD over the
  12 local pose DoF of each pair (``linearize="jacfwd"``).

All (pair, pixel) residuals of a chunk of pairs evaluate as one batched
``[Q, S]`` program; every map sample goes through the map-gather
kernels (`sba_tpu_torch.ops.map_gather`) on the card. Per-pair 12x12
blocks scatter into a dense ``[6N, 6N]`` system solved by Cholesky
inside a Python LM loop that reads its stopping test once per iteration.

Where the port differs from the reference: forward-mode AD
(`torch.autograd.forward_ad`) carries one tangent per dual pass, up to
12 passes batched into one call, where ``jax.jacfwd`` batches the
tangents of one pass; the two-map f32 path reads one interleaved
depth|label table (`pair_table`) with one 8-byte gather where sba_tpu
keeps two tables; pairs sharded over a device mesh (``axis_name``) are
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from sba_tpu_torch.geometry.quaternions import quat_retract, quat_to_rotmat
from sba_tpu_torch.ops.interpolation import (
    JOINT_MAX_LABELS,
    as_int32_words,
    bilinear_depth_label_flat,
    bilinear_depth_label_grad,
    bilinear_flat,
    bilinear_joint_flat,
    bilinear_joint_grad,
    bilinear_label_agreement_flat_raw,
    pack_depth_nbhd_u8,
    pack_joint_nbhd,
    pack_label_neighborhood,
    pair_table,
    to_index,
)
from sba_tpu_torch.ops.map_gather import map_gather
from sba_tpu_torch.optim.losses import loss_value, loss_weight

# Reprojection status codes (ref: src/base/semantic_cost_functions.h:45).
OUT_OF_BOUNDS = -1
INVALID_DEPTH = -2
VALID = 10


class SBAProblem(NamedTuple):
    """Pose-only dense semantic BA state (tensors on one device).

    cam_params are per-image SIMPLE_PINHOLE (f, cx, cy), constant."""

    qvecs: torch.Tensor        # [N, 4]
    tvecs: torch.Tensor        # [N, 3]
    cam_params: torch.Tensor   # [N, 3]
    depth_maps: torch.Tensor   # [N, H, W]
    semantic_maps: torch.Tensor  # [N, H, W]
    pix_xy: torch.Tensor       # [S, 2] (x, y) sample grid
    src_depth: torch.Tensor    # [N, S] depth at the grid
    src_label: torch.Tensor    # [N, S] label at the grid
    pair_src: torch.Tensor     # [Q] int64
    pair_dst: torch.Tensor     # [Q] int64
    pair_mask: torch.Tensor    # [Q]
    free_rot: torch.Tensor     # [N]
    free_trans: torch.Tensor   # [N, 3]
    # Two-map f32 path (palette > 8 labels): [N*H*W, 2] int32, each
    # pixel's u8 depth patch beside its u8 label patch (`pair_table`).
    pair_packed: Optional[torch.Tensor] = None
    depth_range: Optional[torch.Tensor] = None   # [N, 2] f32 (lo, hi)
    # Joint f32 path (palette <= 8 labels): [N*H*W] int32 words of
    # `pack_joint_nbhd`, and each source grid pixel's palette code.
    joint_packed: Optional[torch.Tensor] = None
    src_code: Optional[torch.Tensor] = None      # [N, S] int32


@dataclass(frozen=True)
class SBAOptions:
    """Mirrors sba_tpu's SBAOptions (ref: src/optim/
    semantic_bundle_adjustment.h:53-133)."""

    depth_error_threshold: float = 2.0
    pixel_step: int = 10
    loss: str = "trivial"
    loss_scale: float = 1.0
    max_iterations: int = 50
    mode: str = "soft"               # soft | hard_numeric
    tau_depth: float = 0.25          # soft depth-gate sharpness (x thr)
    tau_bounds: float = 2.0          # soft bounds-gate sharpness, pixels
    numeric_step: float = 1e-3
    # "analytic": closed-form blocks, one gather pass (needs packed
    # maps; otherwise "jacfwd" runs); "jacfwd": forward-mode AD.
    linearize: str = "analytic"
    # Pairs per linearization chunk; 0 = ~4M (pair, pixel) samples.
    pair_chunk: int = 0
    function_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-12
    parameter_tolerance: float = 1e-10
    initial_trust_radius: float = 1e2
    # Mesh axis the pairs are sharded over: the multi-GPU slice.
    axis_name: Optional[str] = None


class SBASummary(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_iterations: int
    num_residuals: torch.Tensor
    cost_trace: torch.Tensor
    # Hard-mode status counts at the solution.
    num_valid: torch.Tensor
    num_out_of_bounds: torch.Tensor
    num_invalid_depth: torch.Tensor
    num_label_mismatch: torch.Tensor


def _col(a):
    """[Q] -> [Q, 1], to broadcast a per-pair value over its samples."""
    return a[:, None]


def _where(cond, a, b):
    """torch.where with python-scalar branches in a's dtype/device."""
    ref = a if torch.is_tensor(a) else b
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
    if not torch.is_tensor(b):
        b = torch.as_tensor(b, dtype=ref.dtype, device=ref.device)
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# Geometry shared by both modes: warp src grid pixels into dst.
# ---------------------------------------------------------------------------

def _warp_core(q_src, t_src, q_dst, t_dst, cam_src, cam_dst, px, py,
               src_depth):
    """World point, dst camera point and rotations of a batch of pairs:
    per-pair inputs [Q, ...], px/py [S], src_depth [Q, S]."""
    f = _col(cam_src[:, 0])
    d = src_depth
    x1 = (px - _col(cam_src[:, 1])) / f * d
    y1 = (py - _col(cam_src[:, 2])) / f * d
    Rs = quat_to_rotmat(q_src)[..., None]      # [Q, 3, 3, 1]
    ax = x1 - _col(t_src[:, 0])
    ay = y1 - _col(t_src[:, 1])
    az = d - _col(t_src[:, 2])
    # world = R_src^T (p - t_src)
    wx = Rs[:, 0, 0] * ax + Rs[:, 1, 0] * ay + Rs[:, 2, 0] * az
    wy = Rs[:, 0, 1] * ax + Rs[:, 1, 1] * ay + Rs[:, 2, 1] * az
    wz = Rs[:, 0, 2] * ax + Rs[:, 1, 2] * ay + Rs[:, 2, 2] * az
    # cam2 = R_dst world + t_dst
    Rd = quat_to_rotmat(q_dst)[..., None]
    cx2 = Rd[:, 0, 0] * wx + Rd[:, 0, 1] * wy + Rd[:, 0, 2] * wz \
        + _col(t_dst[:, 0])
    cy2 = Rd[:, 1, 0] * wx + Rd[:, 1, 1] * wy + Rd[:, 1, 2] * wz \
        + _col(t_dst[:, 1])
    z2 = Rd[:, 2, 0] * wx + Rd[:, 2, 1] * wy + Rd[:, 2, 2] * wz \
        + _col(t_dst[:, 2])
    return (wx, wy, wz), (cx2, cy2, z2), Rs, Rd


def _warp_pair_lanes(q_src, t_src, q_dst, t_dst, cam_src, cam_dst,
                     px, py, src_depth):
    """(x2, y2, z2) [Q, S]: src grid pixels projected into dst."""
    _, (cx2, cy2, z2), _, _ = _warp_core(q_src, t_src, q_dst, t_dst,
                                         cam_src, cam_dst, px, py,
                                         src_depth)
    safe_z = _where(torch.abs(z2) > 1e-12, z2, 1e-12)
    x2 = _col(cam_dst[:, 0]) * cx2 / safe_z + _col(cam_dst[:, 1])
    y2 = _col(cam_dst[:, 0]) * cy2 / safe_z + _col(cam_dst[:, 2])
    return x2, y2, z2


def _bounds_gate(x2, y2, z2, HW, opt):
    H, W = HW
    tb = opt.tau_bounds
    gb = (torch.sigmoid(x2 / tb) * torch.sigmoid((W - 1 - x2) / tb)
          * torch.sigmoid(y2 / tb) * torch.sigmoid((H - 1 - y2) / tb))
    return gb * torch.sigmoid(z2 / 0.01)


def _depth_gate(depth2, z2, opt):
    thr = opt.depth_error_threshold
    return torch.sigmoid((thr - torch.abs(depth2 - z2))
                         / (opt.tau_depth * thr))


def _pair_residual_soft(q_src, t_src, q_dst, t_dst, cam_src, cam_dst,
                        flat_depth, flat_sem, HW, pix_xy, src_depth,
                        src_label, opt: SBAOptions, pair_packed=None,
                        base=None, depth_lo=None, depth_hi=None,
                        joint_packed=None, src_code=None):
    """Soft residual field [Q, S] of a batch of pairs. Maps are FLAT
    [N*H*W] stacks indexed at the per-pair offsets `base` [Q] (= dst *
    H * W); `depth_lo/hi` [Q] are dst's dequantization ranges."""
    H, W = HW
    x2, y2, z2 = _warp_pair_lanes(q_src, t_src, q_dst, t_dst, cam_src,
                                  cam_dst, pix_xy[:, 0], pix_xy[:, 1],
                                  src_depth)
    gb = _bounds_gate(x2, y2, z2, HW, opt)
    b = _col(base)
    if joint_packed is not None:
        depth2, agree = bilinear_joint_flat(
            joint_packed, H, W, b, x2, y2, src_code, _col(depth_lo),
            _col(depth_hi), depth_fill=-1e6)
    elif pair_packed is not None:
        depth2, agree = bilinear_depth_label_flat(
            pair_packed, H, W, b, x2, y2, src_label, _col(depth_lo),
            _col(depth_hi), depth_fill=-1e6)
    else:
        depth2 = bilinear_flat(flat_depth, H, W, b, x2, y2, fill=-1e6)
        agree = bilinear_label_agreement_flat_raw(
            flat_sem, H, W, b, x2, y2, src_label, fill=0.0)
    gd = _depth_gate(depth2, z2, opt)
    valid_src = (src_depth > 0).to(x2.dtype)
    # r = valid * (1 - gate * agreement): invalidity costs as much as a
    # mismatch, so the optimizer cannot escape by gating pixels away.
    return valid_src * (1.0 - gb * gd * agree)


def _pair_residual_hard(q_src, t_src, q_dst, t_dst, cam_src, cam_dst,
                        flat_depth, flat_sem, HW, base, pix_xy,
                        src_depth, src_label, opt: SBAOptions):
    """The reference's residual: (r [Q, S], status [Q, S] int32).
    `flat_depth`/`flat_sem` are the FLAT [N*H*W] map stacks, `base` [Q]
    the dst map offsets."""
    H, W = HW
    x2, y2, z2 = _warp_pair_lanes(q_src, t_src, q_dst, t_dst, cam_src,
                                  cam_dst, pix_xy[:, 0], pix_xy[:, 1],
                                  src_depth)
    # torch.round rounds half to even, as jnp.round does. Coordinates
    # are clamped to [-1, W] before the cast: both ends are out of bounds.
    xi = to_index(torch.round(x2), -1, W)
    yi = to_index(torch.round(y2), -1, H)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    flat = (_col(base) + torch.clamp(yi, 0, H - 1) * W
            + torch.clamp(xi, 0, W - 1)).contiguous()
    depth2 = _where(inb, map_gather(flat_depth, flat), 0.0)
    depth_ok = torch.abs(depth2 - z2) <= opt.depth_error_threshold
    label2 = map_gather(flat_sem, flat)
    mismatch = inb & (label2 != src_label)
    valid_src = src_depth > 0
    status = torch.where(
        ~inb, OUT_OF_BOUNDS,
        torch.where(~depth_ok, INVALID_DEPTH, VALID)).to(torch.int32)
    r = _where(inb & depth_ok & valid_src, mismatch.to(x2.dtype), 0.0)
    status = torch.where(valid_src, status,
                         torch.full_like(status, OUT_OF_BOUNDS))
    return r, status


# ---------------------------------------------------------------------------
# Analytic linearization (the soft-mode hot path)
# ---------------------------------------------------------------------------

def _pair_linearize_analytic(q_src, t_src, q_dst, t_dst, cam_src, cam_dst,
                             HW, px, py, src_depth, src_label,
                             opt: SBAOptions, pair_packed, base, depth_lo,
                             depth_hi, joint_packed=None, src_code=None):
    """Residuals and condensed Jacobian blocks of a batch of pairs, closed
    form: (r [Q, S], P [Q, 9, S]) where the rows of P are the 3-vectors
    (a, b, G) of J = [a | b | -a | G] over (omega_src, t_src, omega_dst,
    t_dst). With the right-multiplicative retraction and G = dr/dc (the
    chain through the gates and the bilinear samples, whose x/y
    derivatives come from the gathered corners): a = (R_d^T G) x w,
    b = -R_s (R_d^T G)."""
    Hm, Wm = HW
    (wx, wy, wz), (cx2, cy2, z2), Rs, Rd = _warp_core(
        q_src, t_src, q_dst, t_dst, cam_src, cam_dst, px, py, src_depth)
    okz = torch.abs(z2) > 1e-12
    safe_z = _where(okz, z2, 1e-12)
    zi = 1.0 / safe_z
    fd = _col(cam_dst[:, 0])
    x2 = fd * cx2 * zi + _col(cam_dst[:, 1])
    y2 = fd * cy2 * zi + _col(cam_dst[:, 2])

    # --- gates + samples (primal) ---
    tb = opt.tau_bounds
    sa = torch.sigmoid(x2 / tb)
    sb = torch.sigmoid((Wm - 1 - x2) / tb)
    sc = torch.sigmoid(y2 / tb)
    sd_ = torch.sigmoid((Hm - 1 - y2) / tb)
    sz = torch.sigmoid(z2 / 0.01)
    gb = sa * sb * sc * sd_ * sz
    thr = opt.depth_error_threshold
    tau = opt.tau_depth * thr
    b = _col(base)
    lo, hi = _col(depth_lo), _col(depth_hi)
    if joint_packed is not None:
        depth2, dD_dx, dD_dy, agree, dA_dx, dA_dy = bilinear_joint_grad(
            joint_packed, Hm, Wm, b, x2, y2, src_code, lo, hi,
            depth_fill=-1e6)
    else:
        depth2, dD_dx, dD_dy, agree, dA_dx, dA_dy = \
            bilinear_depth_label_grad(pair_packed, Hm, Wm, b, x2, y2,
                                      src_label, lo, hi, depth_fill=-1e6)
    delta = depth2 - z2
    gd = torch.sigmoid((thr - torch.abs(delta)) / tau)
    valid = (src_depth > 0).to(x2.dtype)
    r = valid * (1.0 - gb * gd * agree)

    # --- screen-space gradient of r (sign(0) = 0, as jnp.sign) ---
    dgb_dx = gb * (sb - sa) / tb
    dgb_dy = gb * (sd_ - sc) / tb
    dgb_dz = gb * (1.0 - sz) / 0.01
    dgd_dDelta = -gd * (1.0 - gd) * torch.sign(delta) / tau
    dgd_dx = dgd_dDelta * dD_dx
    dgd_dy = dgd_dDelta * dD_dy
    dgd_dz = -dgd_dDelta
    ga = gd * agree
    Gx = -valid * (dgb_dx * ga + gb * (dgd_dx * agree + gd * dA_dx))
    Gy = -valid * (dgb_dy * ga + gb * (dgd_dy * agree + gd * dA_dy))
    Gz = -valid * (dgb_dz * ga + gb * dgd_dz * agree)

    # --- chain to the camera-frame gradient G = dr/dc ---
    Gcx = Gx * fd * zi
    Gcy = Gy * fd * zi
    Gcz = Gz + _where(okz, -(Gx * cx2 + Gy * cy2) * fd * zi * zi, 0.0)

    # h = R_d^T G
    hx = Rd[:, 0, 0] * Gcx + Rd[:, 1, 0] * Gcy + Rd[:, 2, 0] * Gcz
    hy = Rd[:, 0, 1] * Gcx + Rd[:, 1, 1] * Gcy + Rd[:, 2, 1] * Gcz
    hz = Rd[:, 0, 2] * Gcx + Rd[:, 1, 2] * Gcy + Rd[:, 2, 2] * Gcz
    # a = h x w (omega_src block; omega_dst = -a)
    a_x = hy * wz - hz * wy
    a_y = hz * wx - hx * wz
    a_z = hx * wy - hy * wx
    # b = -R_s h (t_src block)
    b_x = -(Rs[:, 0, 0] * hx + Rs[:, 0, 1] * hy + Rs[:, 0, 2] * hz)
    b_y = -(Rs[:, 1, 0] * hx + Rs[:, 1, 1] * hy + Rs[:, 1, 2] * hz)
    b_z = -(Rs[:, 2, 0] * hx + Rs[:, 2, 1] * hy + Rs[:, 2, 2] * hz)
    P = torch.stack([a_x, a_y, a_z, b_x, b_y, b_z, Gcx, Gcy, Gcz], dim=1)
    return r, P


# Column map expanding the condensed [9] block rows (a, b, G) to the
# 12 local DoF [omega_src | t_src | omega_dst | t_dst] = [a | b | -a | G].
_ANALYTIC_COLS = np.array([0, 1, 2, 3, 4, 5, 0, 1, 2, 6, 7, 8])
_ANALYTIC_SIGNS = np.array([1.0, 1, 1, 1, 1, 1, -1, -1, -1, 1, 1, 1])


def _free_pose(problem: SBAProblem):
    """[N, 6] free-parameter mask (rotation x3, translation x3)."""
    return torch.cat([problem.free_rot[:, None].expand(-1, 3),
                      problem.free_trans], dim=1)


def _hw(problem):
    return tuple(problem.depth_maps.shape[-2:])


def _base(problem, pair_dst):
    H, W = _hw(problem)
    return (pair_dst * (H * W)).to(torch.int32)


def _range(problem, pair_dst):
    if problem.depth_range is None:
        return None, None
    return problem.depth_range[pair_dst, 0], problem.depth_range[pair_dst, 1]


def _pair_blocks_analytic(problem: SBAProblem, opt: SBAOptions,
                          pair_src, pair_dst, pair_mask):
    """(Hq [Q,12,12], gq [Q,12], cost) via the analytic path."""
    ps, pd = pair_src, pair_dst
    lo, hi = _range(problem, pd)
    r, P = _pair_linearize_analytic(
        problem.qvecs[ps], problem.tvecs[ps], problem.qvecs[pd],
        problem.tvecs[pd], problem.cam_params[ps], problem.cam_params[pd],
        _hw(problem), problem.pix_xy[:, 0], problem.pix_xy[:, 1],
        problem.src_depth[ps], problem.src_label[ps], opt,
        problem.pair_packed, _base(problem, pd), lo, hi,
        joint_packed=problem.joint_packed,
        src_code=None if problem.src_code is None else problem.src_code[ps])
    s = r * r
    cost = 0.5 * torch.sum(loss_value(opt.loss, s, opt.loss_scale)
                           * pair_mask[:, None])
    w = pair_mask[:, None] * loss_weight(opt.loss, s, opt.loss_scale)
    sw = torch.sqrt(w)
    rw = r * sw
    Pw = P * sw[:, None, :]
    M9 = torch.bmm(Pw, Pw.transpose(1, 2))
    v9 = torch.bmm(Pw, rw[:, :, None])[..., 0]
    cols = torch.as_tensor(_ANALYTIC_COLS, device=r.device)
    sg = torch.as_tensor(_ANALYTIC_SIGNS, dtype=r.dtype, device=r.device)
    Hq = M9[:, cols][:, :, cols] * (sg[:, None] * sg[None, :])[None]
    gq = v9[:, cols] * sg[None]
    free_pose = _free_pose(problem)
    m12 = torch.cat([free_pose[ps], free_pose[pd]], dim=1)   # [Q, 12]
    Hq = Hq * m12[:, :, None] * m12[:, None, :]
    gq = gq * m12
    return Hq, gq, cost


def _use_analytic(problem: SBAProblem, opt: SBAOptions) -> bool:
    return (opt.mode == "soft" and opt.linearize == "analytic"
            and (problem.joint_packed is not None
                 or problem.pair_packed is not None))


# ---------------------------------------------------------------------------
# Residual fields over pairs
# ---------------------------------------------------------------------------

def _residuals(problem: SBAProblem, opt: SBAOptions, soft: bool, ps, pd,
               qvecs=None, tvecs=None, d_src=None, d_dst=None):
    """Residual field [Q, S] of the pairs (ps, pd), at the problem's poses
    (or `qvecs`/`tvecs`) moved by the local per-pair steps d_src/d_dst
    [Q, 6] (rotation, translation) when given."""
    qvecs = problem.qvecs if qvecs is None else qvecs
    tvecs = problem.tvecs if tvecs is None else tvecs
    q_s, t_s, q_d, t_d = qvecs[ps], tvecs[ps], qvecs[pd], tvecs[pd]
    if d_src is not None:
        q_s = quat_retract(q_s, d_src[:, :3])
        t_s = t_s + d_src[:, 3:]
        q_d = quat_retract(q_d, d_dst[:, :3])
        t_d = t_d + d_dst[:, 3:]
    HW = _hw(problem)
    args = (q_s, t_s, q_d, t_d, problem.cam_params[ps],
            problem.cam_params[pd], problem.depth_maps.reshape(-1),
            problem.semantic_maps.reshape(-1), HW)
    if soft:
        lo, hi = _range(problem, pd)
        return _pair_residual_soft(
            *args, problem.pix_xy, problem.src_depth[ps],
            problem.src_label[ps], opt, pair_packed=problem.pair_packed,
            base=_base(problem, pd), depth_lo=lo, depth_hi=hi,
            joint_packed=problem.joint_packed,
            src_code=None if problem.src_code is None
            else problem.src_code[ps])
    return _pair_residual_hard(*args, _base(problem, pd), problem.pix_xy,
                               problem.src_depth[ps], problem.src_label[ps],
                               opt)[0]


def _all_residuals(qvecs, tvecs, problem: SBAProblem, opt: SBAOptions,
                   soft: bool):
    r = _residuals(problem, opt, soft, problem.pair_src, problem.pair_dst,
                   qvecs, tvecs)
    return r * problem.pair_mask[:, None]


def evaluate_hard(problem: SBAProblem, opt: Optional[SBAOptions] = None):
    """Reference-parity evaluation: robust cost + status counts."""
    opt = opt or SBAOptions()
    HW = _hw(problem)
    ps, pd = problem.pair_src, problem.pair_dst
    r, status = _pair_residual_hard(
        problem.qvecs[ps], problem.tvecs[ps], problem.qvecs[pd],
        problem.tvecs[pd], problem.cam_params[ps], problem.cam_params[pd],
        problem.depth_maps.reshape(-1), problem.semantic_maps.reshape(-1),
        HW, _base(problem, pd), problem.pix_xy, problem.src_depth[ps],
        problem.src_label[ps], opt)
    m = problem.pair_mask[:, None]
    r = r * m
    s = r * r
    cost = 0.5 * torch.sum(loss_value(opt.loss, s, opt.loss_scale) * m)
    mb = m > 0
    return dict(
        cost=cost,
        num_valid=torch.sum((status == VALID) & mb),
        num_out_of_bounds=torch.sum((status == OUT_OF_BOUNDS) & mb),
        num_invalid_depth=torch.sum((status == INVALID_DEPTH) & mb),
        num_label_mismatch=torch.sum((r > 0.5) & mb),
        residuals=r,
        status=status,
    )


# ---------------------------------------------------------------------------
# Pose-only LM with dense normal equations from per-pair 12x12 blocks
# ---------------------------------------------------------------------------

def _pair_jacobians(problem: SBAProblem, opt: SBAOptions,
                    pair_src=None, pair_dst=None, pair_mask=None):
    """r [Q,S] and J [Q,S,12] wrt the 12 local DoF (src 6, dst 6), and
    the robust cost at the linearization point. Soft mode: forward-mode
    AD, one tangent per pass; hard mode: numeric central differences
    (the reference's NumericDiffCostFunction<..., CENTRAL>)."""
    if pair_src is None:
        pair_src, pair_dst = problem.pair_src, problem.pair_dst
        pair_mask = problem.pair_mask
    ps, pd = pair_src, pair_dst
    Q = ps.shape[0]
    dt = problem.tvecs.dtype
    dev = problem.tvecs.device
    soft = opt.mode == "soft"

    def pair_fn(d, reps=1):
        return _residuals(problem, opt, soft, ps.repeat(reps),
                          pd.repeat(reps), d_src=d[:, :6], d_dst=d[:, 6:])

    z = torch.zeros(Q, 12, dtype=dt, device=dev)
    cols = []
    if soft:
        # One tangent per pass; up to 12 passes share one batched call
        # (the pairs repeated once per tangent) while the batch stays
        # within one chunk's sample budget.
        S = problem.pix_xy.shape[0]
        group = max(1, min(12, _SBA_CHUNK_SAMPLES // max(Q * S, 1)))
        with fwAD.dual_level():
            for i0 in range(0, 12, group):
                k = min(group, 12 - i0)
                tangent = torch.zeros(k, Q, 12, dtype=dt, device=dev)
                for j in range(k):
                    tangent[j, :, i0 + j] = 1.0
                out = pair_fn(fwAD.make_dual(z.repeat(k, 1),
                                             tangent.reshape(k * Q, 12)), k)
                r, jt = fwAD.unpack_dual(out)
                if jt is None:
                    jt = torch.zeros_like(r)
                cols.extend(jt.reshape(k, Q, -1).unbind(0))
                r = r[:Q]
    else:
        h = opt.numeric_step
        r = pair_fn(z)
        for i in range(12):
            e = torch.zeros_like(z)
            e[:, i] = h
            cols.append((pair_fn(e) - pair_fn(-e)) / (2.0 * h))
    J = torch.stack(cols, dim=-1)                     # [Q, S, 12]
    s = r * r
    cost = 0.5 * torch.sum(loss_value(opt.loss, s, opt.loss_scale)
                           * pair_mask[:, None])
    w = pair_mask[:, None] * loss_weight(opt.loss, s, opt.loss_scale)
    sw = torch.sqrt(w)
    r = r * sw
    J = J * sw[..., None]
    free_pose = _free_pose(problem)
    J = J * torch.cat([free_pose[ps], free_pose[pd]], dim=1)[:, None, :]
    return r, J, cost


def _assemble_from_blocks(problem: SBAProblem, Hq, gq, pair_src=None,
                          pair_dst=None):
    """Scatter per-pair 12x12 blocks into dense H [6N,6N], g [6N]."""
    N = problem.qvecs.shape[0]
    ps = problem.pair_src if pair_src is None else pair_src
    pd = problem.pair_dst if pair_dst is None else pair_dst
    H = torch.zeros(N, N, 6, 6, dtype=Hq.dtype, device=Hq.device)
    g = torch.zeros(N, 6, dtype=Hq.dtype, device=Hq.device)
    H.index_put_((ps, ps), Hq[:, :6, :6], accumulate=True)
    H.index_put_((ps, pd), Hq[:, :6, 6:], accumulate=True)
    H.index_put_((pd, ps), Hq[:, 6:, :6], accumulate=True)
    H.index_put_((pd, pd), Hq[:, 6:, 6:], accumulate=True)
    g.index_put_((ps,), gq[:, :6], accumulate=True)
    g.index_put_((pd,), gq[:, 6:], accumulate=True)
    return H.permute(0, 2, 1, 3).reshape(6 * N, 6 * N), g.reshape(6 * N)


# One chunk of the linearization holds ~4M (pair, pixel) samples, so that
# peak memory stays ~1-2 GB whatever the pair count (the 50-image scene,
# Q = 2450 pairs x S = 3072 pixels, takes 2 chunks).
_SBA_CHUNK_SAMPLES = 4_000_000


def _chunk_size(problem: SBAProblem, opt: SBAOptions) -> int:
    chunk = opt.pair_chunk
    if chunk <= 0:
        chunk = max(1, _SBA_CHUNK_SAMPLES // max(problem.pix_xy.shape[0], 1))
    return chunk


def _linearize_system(problem: SBAProblem, opt: SBAOptions):
    """(H [6N,6N], g [6N], cost), accumulated over chunks of pairs."""
    if opt.axis_name is not None:
        raise NotImplementedError(
            "SBAOptions.axis_name: pairs sharded over devices come with "
            "the multi-GPU slice of the port")
    Q = problem.pair_src.shape[0]
    analytic = _use_analytic(problem, opt)
    chunk = _chunk_size(problem, opt)
    H = g = cost = None
    for lo in range(0, Q, chunk):
        sl = slice(lo, lo + chunk)
        src, dst = problem.pair_src[sl], problem.pair_dst[sl]
        msk = problem.pair_mask[sl]
        if analytic:
            Hq, gq, c = _pair_blocks_analytic(problem, opt, src, dst, msk)
        else:
            r, J, c = _pair_jacobians(problem, opt, src, dst, msk)
            Hq = torch.einsum("qsi,qsj->qij", J, J)
            gq = torch.einsum("qsi,qs->qi", J, r)
        Hb, gb = _assemble_from_blocks(problem, Hq, gq, src, dst)
        if H is None:
            H, g, cost = Hb, gb, c
        else:
            H, g, cost = H + Hb, g + gb, cost + c
    return H, g, cost


def _sba_solve(problem: SBAProblem, opt: SBAOptions):
    """Evaluate-at-proposal LM: each iteration runs ONE linearization (at
    the pending proposal) whose cost doubles as the trial cost; on
    acceptance its (H, g) seed the next solve, on rejection the base
    linearization is reused with a larger lambda (legal because lambda
    enters at solve time only)."""
    N = problem.qvecs.shape[0]
    max_it = opt.max_iterations
    free_pose = _free_pose(problem).reshape(-1)

    def solve(H, g, lam):
        d = torch.clamp(torch.diagonal(H), 1e-6, 1e32)
        Hd = H + torch.diag(lam * d + (1.0 - free_pose))
        L, info = torch.linalg.cholesky_ex(Hd)
        delta = -torch.cholesky_solve(g[:, None], L)[:, 0] * free_pose
        # A failed factorization yields NaN, which the LM test rejects.
        delta = _where(info == 0, delta, float("nan"))
        predicted = -(torch.dot(g, delta)
                      + 0.5 * torch.dot(delta, H @ delta)
                      + 0.5 * torch.sum(lam * d * delta * delta))
        return delta, predicted

    def propose(q, t, delta):
        du = delta.reshape(N, 6)
        return quat_retract(q, du[:, :3]), t + du[:, 3:]

    q, t = problem.qvecs, problem.tvecs
    lam = torch.as_tensor(1.0 / opt.initial_trust_radius, dtype=t.dtype,
                          device=t.device)
    H, g, cost0 = _linearize_system(problem, opt)
    delta, pred = solve(H, g, lam)
    qp, tp = propose(q, t, delta)
    step_norm = torch.linalg.norm(delta)
    nu = torch.full_like(cost0, 2.0)
    cost = cost0
    trace = torch.full((max_it + 1,), float("nan"), dtype=cost0.dtype,
                       device=cost0.device)
    trace[0] = cost0
    it = 0
    done = False
    while it < max_it and not done:
        Hn, gn, cost_prop = _linearize_system(
            problem._replace(qvecs=qp, tvecs=tp), opt)
        actual = cost - cost_prop
        rho = actual / torch.clamp(pred, min=1e-30)
        accept = (actual > 0) & (pred > 0)
        lam = torch.where(
            accept,
            torch.clamp(lam * torch.clamp(1.0 - (2 * rho - 1.0) ** 3,
                                          min=1.0 / 3.0), min=1e-14),
            torch.clamp(lam * nu, max=1e10))
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        H = torch.where(accept, Hn, H)
        g = torch.where(accept, gn, g)
        q = torch.where(accept, qp, q)
        t = torch.where(accept, tp, t)
        cost_new = torch.where(accept, cost_prop, cost)
        g_inf = torch.max(torch.abs(g))
        done_t = ((accept & (torch.abs(actual) < opt.function_tolerance
                             * torch.clamp(cost, min=1e-30)))
                  | (g_inf < opt.gradient_tolerance)
                  | (accept & (step_norm < opt.parameter_tolerance
                               * (1.0 + torch.linalg.norm(t))))
                  | (lam >= 1e10))
        delta, pred = solve(H, g, lam)
        qp, tp = propose(q, t, delta)
        step_norm = torch.linalg.norm(delta)
        cost = cost_new
        it += 1
        trace[it] = cost
        done = bool(done_t)

    out = problem._replace(qvecs=q, tvecs=t)
    hard = evaluate_hard(out, opt)
    num_res = (torch.sum(problem.pair_mask)
               * problem.pix_xy.shape[0]).to(torch.int32)
    summary = SBASummary(
        initial_cost=cost0, final_cost=cost, num_iterations=it,
        num_residuals=num_res, cost_trace=trace,
        num_valid=hard["num_valid"],
        num_out_of_bounds=hard["num_out_of_bounds"],
        num_invalid_depth=hard["num_invalid_depth"],
        num_label_mismatch=hard["num_label_mismatch"])
    return out, summary


def semantic_bundle_adjust(problem: SBAProblem,
                           options: Optional[SBAOptions] = None):
    """Solve; returns (refined problem, SBASummary)."""
    return _sba_solve(problem, options or SBAOptions())


# ---------------------------------------------------------------------------
# Problem construction
# ---------------------------------------------------------------------------

def sba_problem_from_numpy(fields, device="cuda") -> SBAProblem:
    """The port's problem from sba_tpu's `SBAProblem` fields as numpy
    arrays (``{name: np.asarray(value)}``, absent or None fields
    skipped), on `device`. Float fields keep their dtype (that of
    `qvecs` sets the problem's); packed u32 maps become int32 words,
    and sba_tpu's two u8 tables (depth_packed, label_packed) become the
    interleaved `pair_table`."""
    def tensor(a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    dt = torch.from_numpy(np.zeros(0, np.asarray(fields["qvecs"]).dtype)
                          ).dtype
    out = {}
    for name in SBAProblem._fields:
        v = fields.get(name)
        if v is None or name in ("pair_packed", "joint_packed"):
            continue
        if name in ("pair_src", "pair_dst"):
            out[name] = tensor(np.asarray(v, np.int64))
        elif name == "src_code":
            out[name] = tensor(np.asarray(v, np.int32))
        elif name == "depth_range":
            out[name] = tensor(np.asarray(v, np.float32))
        else:
            out[name] = tensor(np.asarray(v), dt)
    if fields.get("joint_packed") is not None:
        out["joint_packed"] = tensor(as_int32_words(fields["joint_packed"]))
    if fields.get("depth_packed") is not None \
            and fields.get("label_packed") is not None:
        out["pair_packed"] = tensor(pair_table(fields["depth_packed"],
                                               fields["label_packed"]))
    return SBAProblem(**out)


def _np_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def build_sba_problem(qvecs, tvecs, cam_params, depth_maps, semantic_maps,
                      options: Optional[SBAOptions] = None, pairs=None,
                      dtype=torch.float64, device="cuda") -> SBAProblem:
    """Assemble from pose arrays + stacked maps (numpy), on `device`.

    The pixel grid mirrors the reference's strided double loop: x, y in
    steps of `pixel_step` over the full map. Gauge: pose 0 constant, tvec
    x of image 1 constant. In float32, maps whose labels lie in [0, 255]
    are packed: the joint table when the label palette has <= 8 values,
    else the two-map pair table; float64 keeps the exact unpacked maps.
    """
    opt = options or SBAOptions()
    npdt = _np_dtype(dtype)
    qvecs = np.asarray(qvecs)
    N = qvecs.shape[0]
    depth_np = np.asarray(depth_maps)
    sem_np = np.asarray(semantic_maps)
    Hm, Wm = depth_np.shape[-2:]

    ys = np.arange(0, Hm, opt.pixel_step)
    xs = np.arange(0, Wm, opt.pixel_step)
    gx, gy = np.meshgrid(xs, ys)
    pix = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)  # [S, 2]
    src_depth = depth_np[:, pix[:, 1], pix[:, 0]]
    src_label = sem_np[:, pix[:, 1], pix[:, 0]]

    if pairs is None:
        pairs = [(i, j) for i in range(N) for j in range(N) if i != j]
    free_rot = np.ones(N)
    free_trans = np.ones((N, 3))
    free_rot[0] = 0.0
    free_trans[0] = 0.0
    if N > 1:
        free_trans[1, 0] = 0.0

    def f(a):
        return np.asarray(a, npdt)

    fields = dict(
        qvecs=f(qvecs), tvecs=f(tvecs), cam_params=f(cam_params),
        depth_maps=f(depth_np), semantic_maps=f(sem_np), pix_xy=f(pix),
        src_depth=f(src_depth), src_label=f(src_label),
        pair_src=np.array([p[0] for p in pairs], np.int64),
        pair_dst=np.array([p[1] for p in pairs], np.int64),
        pair_mask=np.ones(len(pairs), npdt), free_rot=f(free_rot),
        free_trans=f(free_trans))

    packed_ok = (npdt == np.float32 and sem_np.min() >= 0
                 and sem_np.max() <= 255)
    palette = np.unique(sem_np)
    if packed_ok and palette.size <= JOINT_MAX_LABELS:
        code_maps = np.searchsorted(palette, sem_np)
        packs = [pack_joint_nbhd(depth_np[i], code_maps[i])
                 for i in range(N)]
        fields["joint_packed"] = np.stack([p[0] for p in packs]).reshape(-1)
        fields["depth_range"] = np.array([[p[1], p[2]] for p in packs],
                                         np.float32)
        fields["src_code"] = code_maps[:, pix[:, 1], pix[:, 0]].astype(
            np.int32)
    elif packed_ok:
        packs = [pack_depth_nbhd_u8(depth_np[i]) for i in range(N)]
        fields["depth_packed"] = np.stack([p[0] for p in packs]).reshape(-1)
        fields["depth_range"] = np.array([[p[1], p[2]] for p in packs],
                                         np.float32)
        fields["label_packed"] = np.stack(
            [pack_label_neighborhood(sem_np[i].astype(np.int64))
             for i in range(N)]).reshape(-1)
    return sba_problem_from_numpy(fields, device)
