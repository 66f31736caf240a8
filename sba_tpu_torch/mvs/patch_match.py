"""PatchMatch multi-view stereo as dense checkerboard sweeps on device.

Port of ``sba_tpu/mvs/patch_match.py`` (ref: src/mvs/patch_match.{h,cc}
and the CUDA kernels of src/mvs/patch_match_cuda.cu). The formulation
is sba_tpu's, not the reference's per-tap CUDA sweep:

- One iteration is a red-black checkerboard update: every pixel of one
  parity tests the planes of 8 neighbours (distance 1 and 3, wrapping
  across the border as ``torch.roll`` does) and a few random
  perturbations at once, then the other parity does the same.
- A hypothesis (depth, normal) is scored by warping each pixel ONCE
  through ``d * A xh + b`` (the plane-induced homography collapses to
  this for a plane anchored at the pixel's own back-projection) and
  taking bilateral-weighted NCC moments over static shifts of the warped
  source: K6, `ops.patch_match_kernels.ncc_cost` (hand-written CUDA on
  the card, its plain twin on the CPU).
- Views are aggregated by the mean of the best half of the per-source
  costs; the geometric-consistency pass adds a forward-backward
  reprojection term.

On CUDA the sources are sampled through packed 2x2 u8 neighbourhoods
(`_pack_intensity_nbhd`, lossless on 8-bit images) and every cost goes
through the kernel, at every image size. On the CPU the sources are
sampled exactly and the twin runs: sba_tpu's CPU route. Every random
draw goes through `random_draw`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat
from sba_tpu_torch.ops.patch_match_kernels import ncc_cost


@dataclass(frozen=True)
class PatchMatchOptions:
    """Mirrors ref: mvs/patch_match.h:52 Options (sba_tpu's subset)."""

    depth_min: float = 0.1
    depth_max: float = 100.0
    window_radius: int = 3
    window_step: int = 1
    sigma_color: float = 0.2       # bilateral weight (intensity in [0,1])
    sigma_spatial: float = 3.0
    num_iterations: int = 8
    num_random_samples: int = 2    # random refinements per iteration
    ncc_sigma: float = 0.6
    min_triangulation_angle: float = 1.0   # deg (unused in kernel; fusion)
    incident_angle_sigma: float = 0.9
    geom_consistency: bool = True   # (ref default; needs src_depths)
    geom_consistency_regularizer: float = 0.3
    geom_consistency_max_cost: float = 3.0
    filter: bool = True
    filter_min_ncc: float = 0.1
    filter_min_num_consistent: int = 2
    filter_geom_consistency_max_cost: float = 1.0


class PatchMatchResult(NamedTuple):
    depth: torch.Tensor    # [H, W]
    normal: torch.Tensor   # [H, W, 3] (camera frame, unit, z<0 facing cam)
    cost: torch.Tensor     # [H, W] best matching cost (1 - NCC in [0, 2])


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------


def _plane_homographies(K_ref_inv, K_src, R, t, depth, normal, xy):
    """Per-pixel plane-induced homography H = K_src (R + t n^T / (n.X))
    K_ref^-1 for the plane (depth, normal) through the back-projection of
    xy. Shapes: depth [...], normal [..., 3], xy [..., 2] -> [..., 3, 3].
    (Not on the solver's path: `_cost_for_hypothesis` uses its collapsed
    form d * A xh + b.)"""
    xh = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    ray = torch.einsum("ij,...j->...i", K_ref_inv, xh)
    X = depth[..., None] * ray
    d_plane = torch.sum(normal * X, -1)
    tn = t[..., :, None] * normal[..., None, :]
    safe = torch.where(torch.abs(d_plane) > 1e-9, d_plane,
                       torch.full_like(d_plane, 1e-9))
    M = R + tn / safe[..., None, None]
    return torch.einsum("ij,...jk,kl->...il", K_src, M, K_ref_inv)


def _bilinear(img, xy):
    """Sample [H, W] at xy [..., 2] (pixel-centre origin 0.5). Returns
    (value, inb); taps outside the image contribute 0."""
    H, W = img.shape
    x = xy[..., 0] - 0.5
    y = xy[..., 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape(-1)

    def tap(yi, xi, w):
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        fi = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat[fi]
        return torch.where(ok, v, torch.zeros_like(v)) * w

    v = (tap(y0i, x0i, (1 - fy) * (1 - fx))
         + tap(y0i, x0i + 1, (1 - fy) * fx)
         + tap(y0i + 1, x0i, fy * (1 - fx))
         + tap(y0i + 1, x0i + 1, fy * fx))
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return v, inb


# ---------------------------------------------------------------------------
# cost: bilateral-weighted NCC over the window
# ---------------------------------------------------------------------------


def _pack_intensity_nbhd(img):
    """[H, W] intensities in [0, 1] -> flat [H*W] int32 holding the 2x2
    bilinear patch as 4 x u8 (edge-clamped; the bits of sba_tpu's u32):
    one gather then yields the whole bilinear sample. Source images are
    natively 8-bit, so u8 quantization loses nothing real."""
    u8 = torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.int64)
    r = torch.cat([u8, u8[-1:]], 0)
    r = torch.cat([r, r[:, -1:]], 1)
    packed = (r[:-1, :-1] | (r[:-1, 1:] << 8) | (r[1:, :-1] << 16)
              | (r[1:, 1:] << 24))
    # Two's-complement wrap into int32 (torch has no full uint32).
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return packed.to(torch.int32).reshape(-1)


def _bilinear_packed(flat_packed, H, W, xy):
    """Packed-patch counterpart of `_bilinear`: one gather per sample.
    Returns (v in [0, 1] as float32, inb)."""
    x = xy[..., 0] - 0.5
    y = xy[..., 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).to(torch.float32)
    fy = (y - y0).to(torch.float32)
    x0c = x0.to(torch.int64).clamp(0, W - 1)
    y0c = y0.to(torch.int64).clamp(0, H - 1)
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    u = flat_packed[y0c * W + x0c]
    v00 = (u & 0xFF).to(torch.float32)
    v01 = ((u >> 8) & 0xFF).to(torch.float32)
    v10 = ((u >> 16) & 0xFF).to(torch.float32)
    v11 = ((u >> 24) & 0xFF).to(torch.float32)
    v = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
         + fy * ((1 - fx) * v10 + fx * v11)) * (1.0 / 255.0)
    return torch.where(inb, v, torch.zeros_like(v)), inb


def _pixel_grid(H, W, dtype, device):
    """(yy, xx) pixel centres [H, W]."""
    return torch.meshgrid(
        torch.arange(H, dtype=dtype, device=device) + 0.5,
        torch.arange(W, dtype=dtype, device=device) + 0.5, indexing="ij")


def _nonzero(a, eps):
    """a where |a| > eps, else eps (sba_tpu's division guard)."""
    return torch.where(torch.abs(a) > eps, a, torch.full_like(a, eps))


def _geom_costs(depth, K_ref, K_ref_inv, K_srcs, Rs, ts, src_depths,
                max_cost):
    """Forward-backward reprojection error per source [S, H, W]
    (ref: patch_match_cuda.cu:534-585 ComputeGeomConsistencyCost):
    ref pixel -> world at `depth` -> src pixel -> src depth map ->
    world -> back into ref; cost = pixel distance, capped at max_cost;
    missing src depth = max_cost."""
    H, W = depth.shape
    yy, xx = _pixel_grid(H, W, depth.dtype, depth.device)
    ones = torch.ones_like(xx)
    ray = torch.einsum("ij,hwj->hwi", K_ref_inv,
                       torch.stack([xx, yy, ones], -1))
    p_ref = depth[..., None] * ray

    costs = []
    for s in range(src_depths.shape[0]):
        p_src = torch.einsum("ij,hwj->hwi", Rs[s], p_ref) + ts[s]
        z = p_src[..., 2]
        safe_z = _nonzero(z, 1e-9)
        uv = torch.einsum("ij,hwj->hwi", K_srcs[s],
                          p_src / safe_z[..., None])
        src_xy = uv[..., :2]
        src_d, inb = _bilinear(src_depths[s], src_xy)
        ok = inb & (src_d > 1e-9) & (z > 0)
        Ks_inv = torch.linalg.inv(K_srcs[s])
        p_src2 = src_d[..., None] * torch.einsum(
            "ij,hwj->hwi", Ks_inv,
            torch.cat([src_xy, torch.ones_like(src_xy[..., :1])], -1))
        p_ref2 = torch.einsum("ji,hwj->hwi", Rs[s], p_src2 - ts[s])
        z2 = p_ref2[..., 2]
        safe_z2 = _nonzero(z2, 1e-9)
        uv2 = torch.einsum("ij,hwj->hwi", K_ref,
                           p_ref2 / safe_z2[..., None])[..., :2]
        err = torch.sqrt((uv2[..., 0] - xx) ** 2 + (uv2[..., 1] - yy) ** 2)
        cap = torch.full_like(err, max_cost)
        costs.append(torch.where(ok, torch.minimum(err, cap), cap))
    return torch.stack(costs)


def _warp_sources(ref_img, src_imgs, K_ref_inv, K_srcs, Rs, ts, depth,
                  src_packed=None):
    """Warp every source once onto the reference grid through each
    pixel's own hypothesis: x_src ~ d * A xh + b with A = K_s R K_ref^-1
    and b = K_s t (the plane-induced homography of a plane anchored at
    the pixel's own back-projection; the normal cancels). Returns
    (v [S, H, W] in ref_img's dtype, 0 outside, inb [S, H, W] bool);
    packed u8 sampling where `src_packed` is given."""
    H, W = ref_img.shape
    yy, xx = _pixel_grid(H, W, ref_img.dtype, ref_img.device)
    xh = torch.stack([xx, yy, torch.ones_like(xx)], -1)   # [H, W, 3]
    vs, inbs = [], []
    for s in range(len(src_imgs)):
        A = K_srcs[s] @ Rs[s] @ K_ref_inv
        Axh = torch.einsum("ij,hwj->hwi", A, xh)   # hyp-independent
        b = K_srcs[s] @ ts[s]
        wh = depth[..., None] * Axh + b
        src_xy = wh[..., :2] / _nonzero(wh[..., 2:], 1e-9)
        if src_packed is not None:
            Hs, Ws = src_imgs[s].shape
            v, inb = _bilinear_packed(src_packed[s], Hs, Ws, src_xy)
            v = v.to(ref_img.dtype)
        else:
            v, inb = _bilinear(src_imgs[s], src_xy)
            v = torch.where(inb, v, torch.zeros_like(v))
        vs.append(v)
        inbs.append(inb)
    return torch.stack(vs), torch.stack(inbs)


def _cost_for_hypothesis(ref_img, src_imgs, K_ref_inv, K_srcs, Rs, ts,
                         depth, normal, opt: PatchMatchOptions,
                         K_ref=None, src_depths=None, src_packed=None):
    """Matching cost [H, W] of plane hypotheses (depth [H,W],
    normal [H,W,3]) against all sources, averaged over the best views.

    Each pixel is warped once through its own hypothesis
    (`_warp_sources`; normals steer the search through propagation), and
    K6 forms the bilateral-NCC moments over static shifts of the warped
    sources, all S in one call. Out-of-source taps contribute v = 0 with
    full weight; windows more than half outside get cost 2.0.
    """
    v, inb = _warp_sources(ref_img, src_imgs, K_ref_inv, K_srcs, Rs, ts,
                           depth, src_packed)
    costs = ncc_cost(ref_img, v, inb, opt.window_radius, opt.window_step,
                     opt.sigma_spatial, opt.sigma_color).to(ref_img.dtype)
    if src_depths is not None and opt.geom_consistency:
        # Geometric consistency regularizer on the per-view cost
        # (ref: patch_match_cuda.cu:1038-1052).
        costs = costs + opt.geom_consistency_regularizer * _geom_costs(
            depth, K_ref, K_ref_inv, K_srcs, Rs, ts, src_depths,
            opt.geom_consistency_max_cost)
    # View aggregation: mean of the per-pixel best half of the views.
    S = costs.shape[0]
    k_best = max(1, S // 2 + (S % 2))
    best = torch.sort(costs, dim=0).values[:k_best]
    return torch.mean(best, dim=0)


# ---------------------------------------------------------------------------
# main solver
# ---------------------------------------------------------------------------


def random_draw(generator: torch.Generator, tag: str, shape, dtype,
                lo: float = 0.0, hi: float = 1.0):
    """Every random draw of `patch_match_stereo`, on the generator's
    device. `tag` names the draw:

    - ``init_depth``: uniform inverse depth in [lo, hi) [H, W];
    - ``init_normal_q1``, ``init_normal_q2``: uniform [0, 1) [H, W], the
      two draws of `_random_normals`;
    - ``refine_depth`` [H, W], ``refine_normal`` [H, W, 3]: standard
      normals, one pair per random sample per parity per iteration.

    Tests replace this function to feed sba_tpu's own draws in."""
    if tag.startswith("refine"):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device)
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return u * (hi - lo) + lo


def _random_normals(generator, shape, dtype):
    """Random unit normals facing the camera (z < 0), cosine-weighted
    over the hemisphere (ref: patch_match_cuda.cu GenerateRandomNormal)."""
    q1 = random_draw(generator, "init_normal_q1", shape, dtype)
    q2 = random_draw(generator, "init_normal_q2", shape, dtype)
    theta = torch.arccos(torch.sqrt(torch.clamp(q1, 1e-6, 1.0)))
    phi = 2 * math.pi * q2
    return torch.stack([torch.sin(theta) * torch.cos(phi),
                        torch.sin(theta) * torch.sin(phi),
                        -torch.cos(theta)], -1)


def _checkerboard_mask(H, W, parity, device=None):
    yy, xx = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    return ((yy + xx) % 2) == parity


def patch_match_stereo(
    ref_img,            # [H, W] grayscale in [0, 1]
    src_imgs,           # [S, H', W'] source images
    K_ref,              # [3, 3] ref intrinsics
    K_srcs,             # [S, 3, 3]
    Rs,                 # [S, 3, 3] ref-cam -> src-cam rotation
    ts,                 # [S, 3]    x_src = R x_ref + t
    generator: Optional[torch.Generator] = None,
    options: PatchMatchOptions = PatchMatchOptions(),
    src_depths=None,    # [S, H', W'] source depth maps -> enables the
    #                     geometric-consistency second pass
    init_depth=None,    # [H, W] warm start (the photometric result in
    init_normal=None,   # the reference's second pass)
) -> PatchMatchResult:
    """Estimate a depth/normal map for the reference view.

    Random init, then num_iterations x (red update, black update), each
    update testing 8 neighbour planes and `num_random_samples` random
    perturbations for all pixels of its parity. All tensors share
    `ref_img`'s device and dtype; `generator` (default: seed 0 on that
    device) feeds `random_draw`. With `src_depths` given and
    `options.geom_consistency`, every hypothesis cost carries the
    forward-backward reprojection regularizer and the final filter also
    requires `filter_min_num_consistent` geometrically consistent views.
    """
    opt = options
    device = ref_img.device
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    H, W = ref_img.shape
    dtype = ref_img.dtype
    K_ref_inv = torch.linalg.inv(K_ref)

    src_packed = None
    if ref_img.is_cuda:
        src_packed = [_pack_intensity_nbhd(src_imgs[s])
                      for s in range(src_imgs.shape[0])]

    def cost_of(d, n):
        return _cost_for_hypothesis(
            ref_img, src_imgs, K_ref_inv, K_srcs, Rs, ts, d, n, opt,
            K_ref=K_ref, src_depths=src_depths, src_packed=src_packed)

    if init_depth is not None:
        mid = torch.full_like(init_depth, 0.5 * (opt.depth_min
                                                 + opt.depth_max))
        depth = torch.clamp(torch.where(init_depth > 0, init_depth, mid),
                            opt.depth_min, opt.depth_max)
        normal = init_normal if init_normal is not None else \
            _random_normals(generator, (H, W), dtype)
    else:
        # Random init in 1/depth (uniform inverse depth, ref random init).
        inv_d = random_draw(generator, "init_depth", (H, W), dtype,
                            1.0 / opt.depth_max, 1.0 / opt.depth_min)
        depth = 1.0 / inv_d
        normal = _random_normals(generator, (H, W), dtype)
    cost = cost_of(depth, normal)

    yy, xx = _pixel_grid(H, W, dtype, device)
    ray = torch.einsum("ij,hwj->hwi", K_ref_inv,
                       torch.stack([xx, yy, torch.ones_like(xx)], -1))
    masks = [_checkerboard_mask(H, W, p, device) for p in (0, 1)]

    def consider(d_new, n_new, mask):
        nonlocal depth, normal, cost
        c_new = cost_of(d_new, n_new)
        better = (c_new < cost) & mask
        depth = torch.where(better, d_new, depth)
        normal = torch.where(better[..., None], n_new, normal)
        cost = torch.where(better, c_new, cost)

    for it in range(opt.num_iterations):
        for parity in (0, 1):
            mask = masks[parity]
            # Propagation: evaluate each neighbour's PLANE at this pixel:
            # the plane through X_q = d_q ray_q with normal n_q induces
            # d_p = (n_q . X_q) / (n_q . ray_p); distance-3 jumps speed
            # up information travel. Neighbours wrap across the border.
            for (dy, dx) in ((0, 1), (0, -1), (1, 0), (-1, 0),
                             (0, 3), (0, -3), (3, 0), (-3, 0)):
                def roll(a):
                    return torch.roll(torch.roll(a, dy, 0), dx, 1)
                ndX = roll(depth * torch.sum(normal * ray, -1))
                n_n = roll(normal)
                den = torch.sum(n_n * ray, -1)
                den = torch.where(
                    torch.abs(den) > 1e-6, den,
                    torch.where(den < 0, torch.full_like(den, -1e-6),
                                torch.full_like(den, 1e-6)))
                d_n = torch.clamp(ndX / den, opt.depth_min, opt.depth_max)
                consider(d_n, n_n, mask)
            # Random refinement: perturb depth multiplicatively + jitter
            # the normal, with shrinking radius.
            for r in range(opt.num_random_samples):
                scale = 0.5 ** (it / 2.0 + r)
                pd = random_draw(generator, "refine_depth", (H, W), dtype)
                pn = random_draw(generator, "refine_normal", (H, W, 3),
                                 dtype)
                pert = torch.exp(pd * 0.3 * scale)
                d_new = torch.clamp(depth * pert, opt.depth_min,
                                    opt.depth_max)
                n_jit = normal + scale * 0.5 * pn
                n_jit = n_jit / torch.linalg.norm(
                    n_jit, dim=-1, keepdim=True).clamp(min=1e-9)
                n_new = torch.where(n_jit[..., 2:] < -0.05, n_jit, normal)
                consider(d_new, n_new, mask)

    if opt.filter:
        max_photo = 2.0 - 2.0 * opt.filter_min_ncc
        if src_depths is not None and opt.geom_consistency:
            max_photo += (opt.geom_consistency_regularizer
                          * opt.geom_consistency_max_cost)
            # Require enough geometrically consistent views
            # (ref: patch_match_cuda.cu:1114-1124 filter).
            g = _geom_costs(depth, K_ref, K_ref_inv, K_srcs, Rs, ts,
                            src_depths, opt.geom_consistency_max_cost)
            n_consistent = torch.sum(
                g <= opt.filter_geom_consistency_max_cost, dim=0)
            depth = torch.where(
                n_consistent >= opt.filter_min_num_consistent, depth,
                torch.zeros_like(depth))
        depth = torch.where(cost > max_photo, torch.zeros_like(depth),
                            depth)
    return PatchMatchResult(depth=depth, normal=normal, cost=cost)


def relative_pose(q_ref, t_ref, q_src, t_src):
    """World poses (x_cam = R x_world + t) -> relative (R, t) with
    x_src = R x_ref + t. Host helper for building PatchMatch inputs."""
    R_ref = np_quat_to_rotmat(q_ref)
    R_src = np_quat_to_rotmat(q_src)
    R = R_src @ R_ref.T
    t = np.asarray(t_src) - R @ np.asarray(t_ref)
    return R, t
