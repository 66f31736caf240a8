"""SIFT feature extraction, batched over same-shape images.

Port of ``sba_tpu/features/sift.py`` (ref: src/feature/sift.{h,cc},
lib/VLFeat/sift.c) at its default options:

- the scale-space octave is blurred from its base by two banded
  matmuls (every level directly, Gaussian semigroup), in true float32;
- DoG extrema are a dense 26-neighbour test, refined by one Newton step
  of the 3D quadratic and gated on peak and edge response;
- the per-octave and global candidate cuts are `top_k`s with sba_tpu's
  order (``ops/topk.py``);
- the gradient magnitude and angle of each inner level are packed into
  one 32-bit word (bf16 magnitude low, bf16 angle high, both rounded to
  nearest even), and the orientation and descriptor stages sample that
  flat buffer through ``ops/map_gather.map_gather``: the hand-written
  CUDA kernel on the card, its plain twin on the CPU;
- 36-bin orientation histograms, the 4x4x8 descriptor, L1_ROOT or L2
  normalization and sba_tpu's uint8 quantization;
- the options: `first_octave = -1` (a bilinear 2x upsampled base, so
  the gradient table is about 4x larger), `estimate_affine_shape`
  (Baumberg iterations of 256 taps per keypoint, then orientation
  windows and descriptors sampled through each keypoint's 2x2 shape,
  and `[K, 4]` affine rows), `domain_size_pooling` (the descriptor
  averaged over `dsp_num_scales` window sizes, all scales in one
  gather) and `build_octave(impl="conv")` (the incremental conv chain).
  Every tap of these goes through `map_gather` as well. As in sba_tpu,
  pooled descriptors ignore the affine shape when both options are on.

Keypoints follow COLMAP (`src/feature/types.h:43-83`): (x, y, scale,
orientation) in pixels of the input image with the (0.5, 0.5)
pixel-center origin.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from sba_tpu_torch.ops.map_gather import map_gather
from sba_tpu_torch.ops.topk import top_k


@dataclass(frozen=True)
class SiftExtractionOptions:
    """Mirrors ref: src/feature/sift.h:44 `SiftExtractionOptions` (the
    subset sba_tpu keeps, with its static shape budgets)."""

    max_image_size: int = 3200
    max_num_features: int = 8192
    first_octave: int = 0
    num_octaves: int = 4
    octave_resolution: int = 3
    peak_threshold: float = 0.02 / 3.0
    edge_threshold: float = 10.0
    max_num_orientations: int = 2
    upright: bool = False
    darkness_adaptivity: bool = False
    normalization: str = "L1_ROOT"   # or "L2"
    domain_size_pooling: bool = False
    dsp_min_scale: float = 1.0 / 6.0
    dsp_max_scale: float = 3.0
    dsp_num_scales: int = 10
    candidates_per_octave: int = 4096
    desc_candidates_per_octave: int = 1536
    grad_sampling: str = "nearest"   # or "bilinear"
    estimate_affine_shape: bool = False
    affine_shape_iters: int = 6
    sigma0: float = 1.6
    init_sigma: float = 0.5


class SiftFeatures(NamedTuple):
    """Struct-of-arrays features, K rows (a leading batch axis where the
    input had one): keypoints [K, 4] (x, y, scale, orientation),
    descriptors [K, 128] f32 normalized, mask [K] bool, response [K]."""

    keypoints: torch.Tensor
    descriptors: torch.Tensor
    mask: torch.Tensor
    response: torch.Tensor
    affine: Optional[torch.Tensor] = None

    @property
    def num_features(self):
        return torch.sum(self.mask, -1)


def require_fp32_matmul(t) -> None:
    """The blur and the matcher's distances are float32 products whose
    results decide extrema and ratio tests: TF32 must be off on CUDA."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 matmuls must run in full precision here: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


# ---------------------------------------------------------------------------
# Gaussian pyramid (banded matmuls)
# ---------------------------------------------------------------------------


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(sigma, 1e-8)) ** 2)
    return (k / k.sum()).astype(np.float32)


def _band_matrix_np(size: int, sigma: float) -> np.ndarray:
    """[size, size] edge-clamped Gaussian blur operator: out = M @ in."""
    if sigma < 1e-4:
        return np.eye(size, dtype=np.float32)
    r = max(1, int(math.ceil(4.0 * sigma)))
    k = _gaussian_kernel1d(sigma, r)
    M = np.zeros((size, size), np.float32)
    idx = np.arange(size)
    for t in range(-r, r + 1):
        j = np.clip(idx + t, 0, size - 1)
        np.add.at(M, (idx, j), k[t + r])
    return M


_BAND_CACHE: dict = {}


def _blur_banks(H: int, W: int, sigmas: tuple, device):
    """(rowM [W, L*W], colM [L, H, H]) float32 tensors on `device`."""
    key = (H, W, sigmas, str(device))
    hit = _BAND_CACHE.get(key)
    if hit is None:
        rowM = np.concatenate([_band_matrix_np(W, s).T for s in sigmas],
                              axis=1)
        colM = np.stack([_band_matrix_np(H, s) for s in sigmas])
        if len(_BAND_CACHE) > 64:
            _BAND_CACHE.clear()
        hit = _BAND_CACHE[key] = (torch.as_tensor(rowM, device=device),
                                  torch.as_tensor(colM, device=device))
    return hit


def _blur_multi(img, sigmas: tuple):
    """[..., H, W] -> [..., L, H, W]: every sigma applied directly to img
    (row pass one matmul against the concatenated banks, column pass one
    batched matmul)."""
    require_fp32_matmul(img)
    H, W = img.shape[-2:]
    L = len(sigmas)
    rowM, colM = _blur_banks(H, W, sigmas, img.device)
    rows = (img @ rowM).reshape(img.shape[:-2] + (H, L, W)).transpose(-3, -2)
    return colM @ rows


def _blur_matmul(img, sigma: float):
    """Single-sigma banded-matmul blur (the pre-blur of the base)."""
    if sigma < 1e-4:
        return img
    return _blur_multi(img, (float(sigma),))[..., 0, :, :]


def _blur(img, sigma: float):
    """Separable Gaussian blur of [..., H, W] by a static sigma: radius
    ceil(3 sigma), edge padding, rows then columns (the conv chain)."""
    if sigma < 1e-4:
        return img
    radius = max(1, int(math.ceil(3.0 * sigma)))
    k = torch.as_tensor(_gaussian_kernel1d(sigma, radius), device=img.device)
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    x = torch.nn.functional.pad(x, (radius, radius, radius, radius),
                                mode="replicate")
    x = torch.nn.functional.conv2d(x, k.reshape(1, 1, -1, 1))
    x = torch.nn.functional.conv2d(x, k.reshape(1, 1, 1, -1))
    return x.reshape(*lead, *x.shape[-2:])


def _downsample2(img):
    return img[..., ::2, ::2].contiguous()


def _upsample2(img):
    """Bilinear 2x upsample of [..., h, w] (first_octave = -1): half-pixel
    centres, the edge row and column repeated (jax.image.resize's
    "bilinear"). Output pixel 2k samples k - 1/4, pixel 2k+1 samples
    k + 1/4."""
    def axis(x, dim):
        n = x.shape[dim]
        lo = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        hi = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)],
                       dim)
        even = 0.75 * x + 0.25 * lo
        odd = 0.75 * x + 0.25 * hi
        even.narrow(dim, 0, 1).copy_(x.narrow(dim, 0, 1))
        odd.narrow(dim, n - 1, 1).copy_(x.narrow(dim, n - 1, 1))
        out = torch.stack([even, odd], dim + 1 if dim >= 0 else dim)
        shape = list(x.shape)
        shape[dim] = 2 * n
        return out.reshape(shape)
    return axis(axis(img, -2), -1)


def build_octave(img, opt: SiftExtractionOptions, impl: str = "matmul"):
    """One octave of [..., H, W]: (gauss [..., S+3, H, W], dog [..., S+2,
    H, W], next_base [..., H/2, W/2]). impl="matmul": every level blurred
    directly from the base by the banded matmuls; impl="conv": sba_tpu's
    incremental conv chain (each level from the one before)."""
    s_levels = opt.octave_resolution
    k = 2.0 ** (1.0 / s_levels)
    if impl == "matmul":
        sig_dir = tuple(
            math.sqrt(max((opt.sigma0 * k ** s) ** 2 - opt.sigma0 ** 2,
                          0.0))
            for s in range(1, s_levels + 3))
        gauss = torch.cat([img[..., None, :, :], _blur_multi(img, sig_dir)],
                          -3)
    elif impl == "conv":
        levels = [img]
        sigma_prev = opt.sigma0
        for s in range(1, s_levels + 3):
            sigma_total = opt.sigma0 * (k ** s)
            levels.append(_blur(levels[-1], math.sqrt(
                max(sigma_total ** 2 - sigma_prev ** 2, 1e-8))))
            sigma_prev = sigma_total
        gauss = torch.stack(levels, -3)
    else:
        raise ValueError(f"build_octave: impl {impl!r}")
    dog = gauss[..., 1:, :, :] - gauss[..., :-1, :, :]
    next_base = _downsample2(gauss[..., s_levels, :, :])
    return gauss, dog, next_base


# ---------------------------------------------------------------------------
# DoG extrema and refinement
# ---------------------------------------------------------------------------


def _neighbor_extrema(dog):
    """dog [..., L, H, W] -> (is_max, is_min) [..., L-2, H, W]: strictly
    above (below) all 26 neighbours; neighbours past the border count as
    -inf (+inf)."""
    L, H, W = dog.shape[-3:]
    c = dog[..., 1:-1, :, :]
    pad_hi = torch.nn.functional.pad(dog, (1, 1, 1, 1), value=-math.inf)
    pad_lo = torch.nn.functional.pad(dog, (1, 1, 1, 1), value=math.inf)
    max_n = torch.full_like(c, -math.inf)
    min_n = torch.full_like(c, math.inf)
    for dl in (-1, 0, 1):
        ls = slice(1 + dl, L - 1 + dl)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dl == 0 and dy == 0 and dx == 0:
                    continue
                ys = slice(1 - dy, 1 - dy + H)
                xs = slice(1 - dx, 1 - dx + W)
                max_n = torch.maximum(max_n, pad_hi[..., ls, ys, xs])
                min_n = torch.minimum(min_n, pad_lo[..., ls, ys, xs])
    return c > max_n, c < min_n


def _taps(flat, L, H, W, lvl, yy, xx):
    """at(dl, dy, dx): flat [B, L*H*W] at the clipped neighbours of
    (lvl, yy, xx) [B, C]."""
    def at(dl, dy, dx):
        l = torch.clamp(lvl + dl, 0, L - 1)
        y = torch.clamp(yy + dy, 0, H - 1)
        x = torch.clamp(xx + dx, 0, W - 1)
        return torch.gather(flat, -1, (l * H + y) * W + x)
    return at


def _quadratic_refine(dog, lvl, yy, xx):
    """One Newton step of the 3D quadratic fit at the integer extrema
    (lvl, yy, xx) [B, C] of dog [B, L, H, W]: (offset [B, C, 3] (dl, dy,
    dx) clipped to +-0.5, refined value [B, C]); the 3x3 solve in closed
    form (adjugate)."""
    L, H, W = dog.shape[-3:]
    at = _taps(dog.reshape(dog.shape[0], -1), L, H, W, lvl, yy, xx)
    v = at(0, 0, 0)
    g = torch.stack([
        0.5 * (at(1, 0, 0) - at(-1, 0, 0)),
        0.5 * (at(0, 1, 0) - at(0, -1, 0)),
        0.5 * (at(0, 0, 1) - at(0, 0, -1)),
    ], -1)
    hll = at(1, 0, 0) + at(-1, 0, 0) - 2 * v
    hyy = at(0, 1, 0) + at(0, -1, 0) - 2 * v
    hxx = at(0, 0, 1) + at(0, 0, -1) - 2 * v
    hly = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0))
    hlx = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1))
    hyx = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))
    a, b_, c_ = hll + 1e-12, hly, hlx
    d_, e_ = hyy + 1e-12, hyx
    f_ = hxx + 1e-12
    A00 = d_ * f_ - e_ * e_
    A01 = c_ * e_ - b_ * f_
    A02 = b_ * e_ - c_ * d_
    A11 = a * f_ - c_ * c_
    A12 = b_ * c_ - a * e_
    A22 = a * d_ - b_ * b_
    det = a * A00 + b_ * A01 + c_ * A02
    inv_det = torch.where(torch.abs(det) > 1e-30, 1.0 / det,
                          torch.zeros_like(det))
    g0, g1, g2 = g.unbind(-1)
    off = -inv_det[..., None] * torch.stack([
        A00 * g0 + A01 * g1 + A02 * g2,
        A01 * g0 + A11 * g1 + A12 * g2,
        A02 * g0 + A12 * g1 + A22 * g2,
    ], -1)
    off = torch.clamp(off, -0.5, 0.5)
    o0, o1, o2 = off.unbind(-1)
    refined = v + 0.5 * (g0 * o0 + g1 * o1 + g2 * o2)
    return off, refined


def _edge_score(dog, lvl, yy, xx):
    """Spatial Hessian edge score tr^2 / det at (lvl, yy, xx) [B, C] of
    dog [B, L, H, W]: (score, det)."""
    L, H, W = dog.shape[-3:]
    at = _taps(dog.reshape(dog.shape[0], -1), L, H, W, lvl, yy, xx)
    v = at(0, 0, 0)
    dyy = at(0, 1, 0) + at(0, -1, 0) - 2 * v
    dxx = at(0, 0, 1) + at(0, 0, -1) - 2 * v
    dxy = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))
    det = dxx * dyy - dxy * dxy
    tr = dxx + dyy
    return tr * tr / torch.where(torch.abs(det) < 1e-20,
                                 torch.full_like(det, 1e-20), det), det


# ---------------------------------------------------------------------------
# Gradients, packing and sampling
# ---------------------------------------------------------------------------


def _gradients(img):
    """Central differences with wrap-around (roll) -> (magnitude, angle)."""
    gx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    gy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    mag = torch.sqrt(gx * gx + gy * gy + 1e-24)
    return mag, torch.atan2(gy, gx)


def _bf16_bits(x):
    """float32 -> its bfloat16 bits (round to nearest even) in the low 16
    bits of an int32."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def _pack_mag_ang(mags, angs):
    """(magnitude, angle) -> one 32-bit word each, as int32 bits: bf16
    magnitude in the low half, bf16 angle in the high half."""
    return _bf16_bits(mags) | (_bf16_bits(angs) << 16)


def _unpack(u):
    """Packed words -> (magnitude, angle) float32."""
    return (u << 16).view(torch.float32), (u & -65536).view(torch.float32)


def _nearest_gather_ma(flat, ys, xs, base, H, W):
    """Nearest-pixel (magnitude, angle) of the flat packed buffer through
    the map_gather kernel: taps clipped into the keypoint's own plane
    (`base` its offset, `H`/`W` its bounds), magnitude 0 outside it.
    Returns ([1, ...], [1, ...]) (one tap)."""
    yi = torch.round(ys).to(torch.int32)
    xi = torch.round(xs).to(torch.int32)
    ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    idx = base + torch.minimum(torch.clamp(yi, min=0), H - 1) * W \
        + torch.minimum(torch.clamp(xi, min=0), W - 1)
    m, a = _unpack(map_gather(flat, idx.to(torch.int32).contiguous()))
    return torch.where(ok, m, torch.zeros_like(m))[None], a[None]


def _bilinear_gather_ma(flat, ys, xs, base, H, W):
    """Bilinear (weighted magnitude, angle) taps: [4, ...] each, every
    tap binned with its own angle and bilinear weight."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = ys - y0
    fx = xs - x0
    y0i = y0.to(torch.int32)
    x0i = x0.to(torch.int32)
    wms, angs = [], []
    for dy, dx, w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                      (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi = y0i + dy
        xi = x0i + dx
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = base + torch.minimum(torch.clamp(yi, min=0), H - 1) * W \
            + torch.minimum(torch.clamp(xi, min=0), W - 1)
        m, a = _unpack(map_gather(flat, idx.to(torch.int32).contiguous()))
        wms.append(torch.where(ok, m, torch.zeros_like(m)) * w)
        angs.append(a)
    return torch.stack(wms), torch.stack(angs)


def _gather_ma(flat, ys, xs, base, H, W, sampling):
    if sampling == "nearest":
        return _nearest_gather_ma(flat, ys, xs, base, H, W)
    return _bilinear_gather_ma(flat, ys, xs, base, H, W)


# ---------------------------------------------------------------------------
# Orientation and descriptor
# ---------------------------------------------------------------------------

_N_ORI_BINS = 36
_TWO_PI = 2 * math.pi
# sba_tpu's float32 jnp.linspace(-1, 1, 16), value for value.
_LIN16 = (-1.0, -0.8666666746139526, -0.7333333492279053,
          -0.5999999642372131, -0.46666666865348816, -0.333333283662796,
          -0.19999994337558746, -0.0666666105389595, 0.06666672229766846,
          0.20000004768371582, 0.3333333730697632, 0.46666672825813293,
          0.6000001430511475, 0.7333334684371948, 0.8666667938232422, 1.0)


def _grid(values, device):
    lin = torch.tensor(values, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    return gy.reshape(-1), gx.reshape(-1)


def _spd2_inv_sqrt(a, b, c):
    """Inverse square root of the SPD 2x2 [[a, b], [b, c]] in closed form
    (sqrt(M) = (M + sqrt(det) I) / sqrt(tr + 2 sqrt(det)), then the
    adjugate inverse), normalized to det = 1."""
    det = torch.clamp(a * c - b * b, min=1e-20)
    sd = torch.sqrt(det)
    s = torch.sqrt(torch.clamp(a + c + 2.0 * sd, min=1e-20))
    ra = (a + sd) / s
    rb = b / s
    rc = (c + sd) / s
    rdet = torch.clamp(ra * rc - rb * rb, min=1e-20)
    ia = rc / rdet
    ib = -rb / rdet
    ic = ra / rdet
    n = torch.sqrt(torch.sqrt(torch.clamp(ia * ic - ib * ib, min=1e-20)))
    return ia / n, ib / n, ic / n


def _affine_adapt(flat, kx, ky, ksigma, base, kh, kw, iters: int,
                  sampling: str):
    """Baumberg iteration over all keypoints [...] at once: adapt each
    measurement region until the gradient second-moment matrix in it is
    isotropic (VLFeat covdet's affine shape, lib/VLFeat/covdet.c). Each
    iteration samples a 16x16 grid over radius 3 sigma through the
    current shape, one `map_gather` launch for every keypoint. Returns
    the symmetric shape S [..., 2, 2] with det S = 1 and the anisotropy
    (eigenvalue ratio) of the last moment matrix."""
    oy, ox = _grid(_LIN16, kx.device)
    w_g = torch.exp(-(ox * ox + oy * oy) / (2 * 0.66 ** 2))
    sa = torch.ones_like(kx)
    sb = torch.zeros_like(kx)
    sc = torch.ones_like(kx)
    aniso = torch.ones_like(kx)
    rad = (3.0 * ksigma)[..., None]
    ky_, kx_ = ky[..., None], kx[..., None]
    b_, h_, w_ = base[..., None], kh[..., None], kw[..., None]
    for _ in range(iters):
        a_, b2, c_ = sa[..., None], sb[..., None], sc[..., None]
        dx = rad * (a_ * ox + b2 * oy)
        dy = rad * (b2 * ox + c_ * oy)
        wm, ang = _gather_ma(flat, ky_ + dy, kx_ + dx, b_, h_, w_, sampling)
        gx = (wm * torch.cos(ang)).sum(0)
        gy = (wm * torch.sin(ang)).sum(0)
        ixx = torch.sum(w_g * gx * gx, -1)
        ixy = torch.sum(w_g * gx * gy, -1)
        iyy = torch.sum(w_g * gy * gy, -1)
        # The moment matrix in the normalized frame: mu_n = S^T mu S.
        mxx = sa * (sa * ixx + sb * ixy) + sb * (sa * ixy + sb * iyy)
        mxy = sa * (sb * ixx + sc * ixy) + sb * (sb * ixy + sc * iyy)
        myy = sb * (sb * ixx + sc * ixy) + sc * (sb * ixy + sc * iyy)
        tr = mxx + myy + 1e-20
        det = torch.clamp(mxx * myy - mxy * mxy, min=1e-24)
        disc = torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))
        aniso = (tr + disc) / torch.clamp(tr - disc, min=1e-20)
        wa, wb, wc = _spd2_inv_sqrt(mxx / tr, mxy / tr, myy / tr)
        # S <- S W, symmetrized (keeping S symmetric fixes the shape's
        # rotation, as covdet does), back to det 1.
        na = sa * wa + sb * wb
        nb = 0.5 * ((sb * wa + sc * wb) + (sa * wb + sb * wc))
        nc = sb * wb + sc * wc
        d = torch.sqrt(torch.clamp(na * nc - nb * nb, min=1e-20))
        sa, sb, sc = na / torch.sqrt(d), nb / torch.sqrt(d), \
            nc / torch.sqrt(d)
    S = torch.stack([torch.stack([sa, sb], -1), torch.stack([sb, sc], -1)],
                    -2)
    return S, aniso


def _orientation_histograms(flat, kx, ky, ksigma, base, kh, kw,
                            sampling="nearest", shape=None):
    """36-bin gaussian-weighted orientation histograms, [..., 36], of the
    keypoints [...] (octave pixels, level-relative sigma, plane offset
    `base` into the flat buffer and plane bounds kh/kw): a 16x16 grid
    over radius 4.5 sigma (through the keypoint's affine `shape` [...,
    2, 2] when given; the weights stay those of the unshaped grid),
    linear binning, six circular box passes (lib/VLFeat/sift.c
    vl_sift_calc_keypoint_orientations)."""
    oy, ox = _grid(_LIN16, kx.device)
    rad = (3.0 * 1.5 * ksigma)[..., None]
    dy = oy * rad
    dx = ox * rad
    if shape is None:
        sy, sx = dy, dx
    else:
        sx = rad * (shape[..., 0, 0, None] * ox + shape[..., 0, 1, None] * oy)
        sy = rad * (shape[..., 1, 0, None] * ox + shape[..., 1, 1, None] * oy)
    wm, a = _gather_ma(flat, ky[..., None] + sy, kx[..., None] + sx,
                       base[..., None], kh[..., None], kw[..., None],
                       sampling)
    s = 1.5 * ksigma[..., None] + 1e-9
    w = torch.exp(-0.5 * (dy * dy + dx * dx) / (s * s))
    binf = torch.remainder(a, _TWO_PI) / _TWO_PI * _N_ORI_BINS
    b0 = torch.floor(binf)
    fb = binf - b0
    b0i = torch.remainder(b0.to(torch.int32), _N_ORI_BINS)
    b1i = torch.remainder(b0i + 1, _N_ORI_BINS)
    wm = w * wm
    w0, w1 = wm * (1 - fb), wm * fb
    # 36 masked sums (sba_tpu's formulation; deterministic, no atomics).
    hists = torch.stack([
        torch.where(b0i == b, w0, 0.0).sum(dim=(0, -1))
        + torch.where(b1i == b, w1, 0.0).sum(dim=(0, -1))
        for b in range(_N_ORI_BINS)], -1)
    for _ in range(6):
        hists = (torch.roll(hists, 1, dims=-1) + hists
                 + torch.roll(hists, -1, dims=-1)) / 3.0
    return hists


def _histogram_peaks(hists, max_peaks: int):
    """Peak orientations of [..., 36] histograms: local maxima at >= 80%
    of the highest, the `max_peaks` largest, parabolic refinement.
    Returns (orients [..., max_peaks], valid [..., max_peaks])."""
    left = torch.roll(hists, 1, dims=-1)
    right = torch.roll(hists, -1, dims=-1)
    is_peak = (hists > left) & (hists > right)
    peak_max = torch.amax(hists, dim=-1, keepdim=True)
    strong = is_peak & (hists >= 0.8 * peak_max)
    score = torch.where(strong, hists, torch.full_like(hists, -math.inf))
    vals, idx = top_k(score, max_peaks)
    valid = torch.isfinite(vals) & (vals > 0)
    l = torch.gather(left, -1, idx)
    r = torch.gather(right, -1, idx)
    denom = l - 2 * vals + r
    dbin = torch.where(torch.abs(denom) > 1e-12, 0.5 * (l - r) / denom,
                       torch.zeros_like(denom))
    orient = (idx.to(hists.dtype) + dbin + 0.5) * (_TWO_PI / _N_ORI_BINS)
    return torch.remainder(orient, _TWO_PI), valid


_D_SPATIAL = 4
_D_ORI = 8
_D_GRID = 16
# Keypoint rows binned at once in the descriptor's one-hot product.
DESC_CHUNK = 16384


def _descriptors(flat, kx, ky, ksigma, korient, base, kh, kw, opt=None,
                 shape=None):
    """128-D SIFT descriptors of keypoints [...]: a rotated 16x16 grid
    over 4x4 spatial bins of 3 sigma each (then through the keypoint's
    affine `shape` [..., 2, 2] when given; the gradient angles keep the
    rotation-only correction), trilinear binning into 4x4x8 as one
    product per keypoint (lib/VLFeat/sift.c
    vl_sift_calc_keypoint_descriptor). With `opt.domain_size_pooling`
    the descriptor is the mean over `dsp_num_scales` window sizes,
    sampled in one gather; as in sba_tpu, that branch ignores `shape`."""
    sampling = getattr(opt, "grad_sampling", "nearest") if opt else "nearest"
    if opt is not None and opt.domain_size_pooling:
        scales = torch.as_tensor(
            np.linspace(opt.dsp_min_scale, opt.dsp_max_scale,
                        opt.dsp_num_scales).astype(np.float32),
            device=kx.device)
        sc = scales.reshape(-1, *([1] * kx.dim()))
        rep = lambda a: a.expand(sc.shape[:1] + a.shape)
        single = dataclasses.replace(opt, domain_size_pooling=False)
        return torch.mean(_descriptors(
            flat, rep(kx), rep(ky), ksigma * sc, rep(korient), rep(base),
            rep(kh), rep(kw), single), 0)
    dev = kx.device
    lin = [(i + 0.5) / _D_GRID * 4.0 - 2.0 for i in range(_D_GRID)]
    by, bx = _grid(lin, dev)
    spb = (3.0 * ksigma)[..., None]
    ca = torch.cos(korient)[..., None]
    sa = torch.sin(korient)[..., None]
    rx = ca * bx - sa * by
    ry = sa * bx + ca * by
    if shape is not None:
        rx, ry = (shape[..., 0, 0, None] * rx + shape[..., 0, 1, None] * ry,
                  shape[..., 1, 0, None] * rx + shape[..., 1, 1, None] * ry)
    wm_t, a_t = _gather_ma(flat, ky[..., None] + ry * spb,
                           kx[..., None] + rx * spb, base[..., None],
                           kh[..., None], kw[..., None], sampling)
    a_t = a_t - korient[..., None]
    w = torch.exp(-(bx * bx + by * by) / 8.0)
    wm_t = wm_t * w

    centers = torch.arange(_D_SPATIAL, device=dev) - 1.5

    def spatial(v):
        return torch.clamp(1.0 - torch.abs(v[:, None] - centers[None, :]),
                           min=0.0)

    wyx = (spatial(by)[:, :, None] * spatial(bx)[:, None, :]).reshape(256, 16)
    binf = torch.remainder(a_t, _TWO_PI) / _TWO_PI * _D_ORI
    b0 = torch.floor(binf)
    fb = binf - b0
    b0i = torch.remainder(b0.to(torch.int64), _D_ORI)
    T = a_t.shape[0]
    lead = a_t.shape[1:-1]
    fb = fb.reshape(T, -1, 256)
    b0i = b0i.reshape(T, -1, 256)
    wm_t = wm_t.reshape(T, -1, 256)
    out = []
    eye = torch.eye(_D_ORI, dtype=torch.float32, device=dev)
    for k0 in range(0, fb.shape[1], DESC_CHUNK):
        ks = slice(k0, k0 + DESC_CHUNK)
        wo = (eye[b0i[:, ks]] * (1 - fb[:, ks])[..., None]
              + eye[(b0i[:, ks] + 1) % _D_ORI] * fb[:, ks][..., None])
        # desc[k, yx, o] = sum_t,s wyx[s, yx] wm[t, k, s] wo[t, k, s, o]
        weighted = (wo * wm_t[:, ks][..., None]).sum(0)       # [k, 256, 8]
        out.append(wyx.t() @ weighted)                        # [k, 16, 8]
    return torch.cat(out).reshape(lead + (128,))


def _normalize_descriptors(desc, normalization: str):
    """L2 -> clip 0.2 -> renorm; then L1_ROOT if requested
    (ref: feature/utils.cc)."""
    n = torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-12
    d = torch.clamp(desc / n, 0.0, 0.2)
    n2 = torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12
    d = d / n2
    if normalization.upper() == "L1_ROOT":
        s = torch.sum(torch.abs(d), dim=-1, keepdim=True) + 1e-12
        d = torch.sqrt(d / s)
    return d


def descriptors_to_uint8(desc):
    """f32 descriptors -> COLMAP-database uint8 (x512, clamp 255)."""
    return torch.clamp(torch.round(512.0 * desc), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------


def _detect_octave(base, opt: SiftExtractionOptions):
    """Detection of one octave of base [B, H, W]: pyramid, DoG extrema,
    refinement, peak/edge/border gates and the per-octave candidate cut.
    Returns (cand dict of [B, D] tensors in octave pixels, packed
    gradients [B, S*H*W] int32, (H, W), next_base)."""
    S = opt.octave_resolution
    gauss, dog, next_base = build_octave(base, opt)
    B = base.shape[0]
    L, H, W = dog.shape[-3:]
    C = min(opt.candidates_per_octave, (L - 2) * H * W)

    is_max, is_min = _neighbor_extrema(dog)
    c = dog[:, 1:-1]
    extremum = (is_max | is_min) & (torch.abs(c) > 0.8 * opt.peak_threshold)
    score = torch.where(extremum, torch.abs(c), torch.zeros_like(c))
    vals, idx = top_k(score.reshape(B, -1), C)
    lvl = idx // (H * W) + 1
    rem = idx % (H * W)
    yy = rem // W
    xx = rem % W
    cand_valid = vals > 0

    off, refined = _quadratic_refine(dog, lvl, yy, xx)
    peak_ok = torch.abs(refined) > opt.peak_threshold
    edge, det = _edge_score(dog, lvl, yy, xx)
    et = opt.edge_threshold
    edge_ok = (det > 0) & (edge < (et + 1.0) ** 2 / et)
    border = 4
    inside = ((yy >= border) & (yy < H - border)
              & (xx >= border) & (xx < W - border))
    valid = cand_valid & peak_ok & edge_ok & inside

    D = min(opt.desc_candidates_per_octave, C)
    dscore = torch.where(valid, torch.abs(refined),
                         torch.full_like(refined, -math.inf))
    _, keep = top_k(dscore, D)
    take = lambda a: torch.gather(a, 1, keep)
    lvl, refined, valid, yy, xx = map(take, (lvl, refined, valid, yy, xx))
    off = torch.gather(off, 1, keep[..., None].expand(B, D, 3))

    fl = lvl.to(dog.dtype) + off[..., 0]
    fy = yy.to(dog.dtype) + off[..., 1]
    fx = xx.to(dog.dtype) + off[..., 2]
    sigma_level = opt.sigma0 * 2.0 ** (fl / S)

    mag, ang = _gradients(gauss[:, 1:S + 1])
    packed = _pack_mag_ang(mag, ang)
    cand = dict(fx=fx, fy=fy, sigma=sigma_level, resp=torch.abs(refined),
                valid=valid, base=(lvl - 1) * (H * W))
    return cand, packed.reshape(B, -1), (H, W), next_base


def extract_sift_tensor(images, options: Optional[SiftExtractionOptions]
                        = None) -> SiftFeatures:
    """SIFT of a [B, H, W] (or [H, W]) float32 image tensor in [0, 1] on
    its own device; SiftFeatures with a leading batch axis (none for a
    single [H, W] image). `affine` holds the [..., K, 4] rows (a11, a12,
    a21, a22) of scale * S @ R(orientation) in input pixels when
    `estimate_affine_shape` is on, else None."""
    opt = options or SiftExtractionOptions()
    single = images.dim() == 2
    img = (images[None] if single else images).to(torch.float32)
    B = img.shape[0]
    dev = img.device

    if opt.first_octave <= -1:
        img = _upsample2(img)
        octave_scale0 = 0.5
        # The upsampled image carries about 2 * init_sigma of blur.
        pre = math.sqrt(max(opt.sigma0 ** 2 - (2 * opt.init_sigma) ** 2,
                            0.01))
    else:
        octave_scale0 = 1.0
        pre = math.sqrt(max(opt.sigma0 ** 2 - opt.init_sigma ** 2, 0.01))
    base = _blur_matmul(img, pre)
    h, w = base.shape[-2:]
    n_oct = min(opt.num_octaves,
                max(1, int(math.floor(math.log2(min(h, w) / 16.0))) + 1))

    parts, flats = [], []
    offset = 0
    for o in range(n_oct):
        cand, pflat, (H, W), base = _detect_octave(base, opt)
        D = cand["fx"].shape[1]
        cand["base"] = cand["base"] + offset
        cand["ph"] = torch.full((B, D), H, dtype=torch.int64, device=dev)
        cand["pw"] = torch.full((B, D), W, dtype=torch.int64, device=dev)
        cand["oscale"] = torch.full((B, D), octave_scale0 * 2.0 ** o,
                                    dtype=torch.float32, device=dev)
        offset += pflat.shape[1]
        parts.append(cand)
        flats.append(pflat)

    # One flat table over the batch: image b's words start at b * offset.
    # The gather's indices are int32: the whole table stays below 2^31.
    flat_all = torch.cat(flats, 1).reshape(-1)
    if flat_all.numel() >= 1 << 31:
        raise ValueError("extract_sift: gradient table past 2^31 words; "
                         "use a smaller batch")
    cat = {k: torch.cat([p[k] for p in parts], 1) for k in parts[0]}
    cat["base"] = cat["base"] + offset * torch.arange(
        B, device=dev)[:, None]

    K = opt.max_num_features
    total = cat["resp"].shape[1]
    k_eff = min(K, total)
    cscore = torch.where(cat["valid"], cat["resp"],
                         torch.full_like(cat["resp"], -math.inf))
    _, cidx = top_k(cscore, k_eff)
    cat = {k: torch.gather(v, 1, cidx) for k, v in cat.items()}

    shapes = None
    if opt.estimate_affine_shape:
        shapes, _aniso = _affine_adapt(
            flat_all, cat["fx"], cat["fy"], cat["sigma"], cat["base"],
            cat["ph"], cat["pw"], opt.affine_shape_iters, opt.grad_sampling)
        # Near the border the iteration can overflow (a window with few
        # in-plane taps has a rank-deficient moment matrix): such a
        # keypoint's shape is not finite, and it is dropped (sba_tpu
        # writes its NaN row).
        cat["valid"] = cat["valid"] & torch.isfinite(shapes).all(-1).all(-1)

    if opt.upright:
        orients = torch.zeros((B, k_eff, 1), dtype=torch.float32, device=dev)
        ovalid = torch.ones((B, k_eff, 1), dtype=torch.bool, device=dev)
    else:
        hists = _orientation_histograms(flat_all, cat["fx"], cat["fy"],
                                        cat["sigma"], cat["base"], cat["ph"],
                                        cat["pw"], opt.grad_sampling,
                                        shape=shapes)
        orients, ovalid = _histogram_peaks(hists, opt.max_num_orientations)

    n_ori = orients.shape[-1]
    rep = lambda a: a[..., None].expand(B, k_eff, n_ori).reshape(B, -1)
    kv = (cat["valid"][..., None] & ovalid).reshape(B, -1)
    score = torch.where(kv, rep(cat["resp"]),
                        torch.full((B, k_eff * n_ori), -math.inf,
                                   device=dev))
    vals, idx = top_k(score, k_eff)
    row = {k: torch.gather(rep(cat[k]), 1, idx) for k in
           ("fx", "fy", "sigma", "base", "ph", "pw", "oscale")}
    ko = torch.gather(orients.reshape(B, -1), 1, idx)
    row_shape = None
    if shapes is not None:
        rs = shapes[:, :, None].expand(B, k_eff, n_ori, 2, 2).reshape(
            B, -1, 4)
        row_shape = torch.gather(rs, 1, idx[..., None].expand(
            B, k_eff, 4)).reshape(B, k_eff, 2, 2)
    descs = _descriptors(flat_all, row["fx"], row["fy"], row["sigma"], ko,
                         row["base"], row["ph"], row["pw"], opt,
                         shape=row_shape)

    keypoints = torch.stack([row["fx"] * row["oscale"] + 0.5,
                             row["fy"] * row["oscale"] + 0.5,
                             row["sigma"] * row["oscale"], ko], -1)
    affine = None
    if row_shape is not None:
        # scale * S @ R(ori) in input pixels (COLMAP's affine keypoint).
        sc = row["sigma"] * row["oscale"]
        ca, sa = torch.cos(ko), torch.sin(ko)
        R = torch.stack([torch.stack([ca, -sa], -1),
                         torch.stack([sa, ca], -1)], -2)
        affine = (sc[..., None, None] * (row_shape @ R)).reshape(B, k_eff, 4)
    desc = _normalize_descriptors(descs, opt.normalization)
    mask = torch.isfinite(vals)
    if k_eff < K:
        def pad(a, fill=0):
            return torch.cat([a, torch.full((B, K - k_eff) + a.shape[2:],
                                            fill, dtype=a.dtype,
                                            device=dev)], 1)
        keypoints, desc, mask = pad(keypoints), pad(desc), pad(mask)
        vals = pad(vals, -math.inf)
        if affine is not None:
            affine = pad(affine)
    resp = torch.where(mask, vals, torch.zeros_like(vals))
    out = SiftFeatures(keypoints=keypoints, descriptors=desc, mask=mask,
                       response=resp, affine=affine)
    if single:
        return SiftFeatures(*(None if a is None else a[0] for a in out))
    return out


def extract_sift(image, options: Optional[SiftExtractionOptions] = None,
                 device="cuda") -> SiftFeatures:
    """SIFT of one [H, W] grayscale float32 image in [0, 1] (numpy or a
    tensor) on `device`; tensors of K = max_num_features rows."""
    img = torch.as_tensor(np.asarray(image, np.float32)
                          if not torch.is_tensor(image) else image,
                          device=device)
    return extract_sift_tensor(img, options)


def extract_sift_batch(images, options: Optional[SiftExtractionOptions]
                       = None, device="cuda"):
    """Extraction of a [B, H, W] float32 image stack in one pass on
    `device`, quantized there; one read back. Returns host numpy
    (keypoints [B, K, 4] f32 -- or [B, K, 6] COLMAP affine rows (x, y,
    a11, a12, a21, a22) with `estimate_affine_shape` --, descriptors
    [B, K, 128] u8, mask [B, K])."""
    opt = options or SiftExtractionOptions()
    imgs = torch.as_tensor(np.asarray(images, np.float32), device=device)
    ft = extract_sift_tensor(imgs, opt)
    kp = ft.keypoints
    if ft.affine is not None:
        kp = torch.cat([kp[..., :2], ft.affine], -1)
    return (kp.cpu().numpy(),
            descriptors_to_uint8(ft.descriptors).cpu().numpy(),
            ft.mask.cpu().numpy())


def load_image_gray(path, max_size: Optional[int] = None) -> np.ndarray:
    """Host-side image loading -> [H, W] f32 in [0, 1] (replaces the
    reference's FreeImage Bitmap, ref: util/bitmap.h)."""
    from PIL import Image as PILImage

    im = PILImage.open(path).convert("L")
    if max_size is not None and max(im.size) > max_size:
        sc = max_size / max(im.size)
        im = im.resize((max(1, int(im.width * sc)),
                        max(1, int(im.height * sc))), PILImage.BILINEAR)
    return np.asarray(im, dtype=np.float32) / 255.0
