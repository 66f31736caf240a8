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
  normalization and sba_tpu's uint8 quantization.

`estimate_affine_shape`, `domain_size_pooling`, `first_octave = -1` and
`build_octave(impl="conv")` are not ported yet: each raises
``NotImplementedError``.

Keypoints follow COLMAP (`src/feature/types.h:43-83`): (x, y, scale,
orientation) in pixels of the input image with the (0.5, 0.5)
pixel-center origin.
"""

from __future__ import annotations

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


def _unported(what: str):
    raise NotImplementedError(f"SIFT {what} is not ported yet")


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


def build_octave(img, opt: SiftExtractionOptions, impl: str = "matmul"):
    """One octave of [..., H, W]: (gauss [..., S+3, H, W], dog [..., S+2,
    H, W], next_base [..., H/2, W/2])."""
    if impl != "matmul":
        _unported('build_octave(impl="conv")')
    s_levels = opt.octave_resolution
    k = 2.0 ** (1.0 / s_levels)
    sig_dir = tuple(
        math.sqrt(max((opt.sigma0 * k ** s) ** 2 - opt.sigma0 ** 2, 0.0))
        for s in range(1, s_levels + 3))
    gauss = torch.cat([img[..., None, :, :], _blur_multi(img, sig_dir)], -3)
    dog = gauss[..., 1:, :, :] - gauss[..., :-1, :, :]
    next_base = gauss[..., s_levels, ::2, ::2].contiguous()
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


def _orientation_histograms(flat, kx, ky, ksigma, base, kh, kw,
                            sampling="nearest"):
    """36-bin gaussian-weighted orientation histograms, [..., 36], of the
    keypoints [...] (octave pixels, level-relative sigma, plane offset
    `base` into the flat buffer and plane bounds kh/kw): a 16x16 grid
    over radius 4.5 sigma, linear binning, six circular box passes
    (lib/VLFeat/sift.c vl_sift_calc_keypoint_orientations)."""
    oy, ox = _grid(_LIN16, kx.device)
    rad = (3.0 * 1.5 * ksigma)[..., None]
    dy = oy * rad
    dx = ox * rad
    wm, a = _gather_ma(flat, ky[..., None] + dy, kx[..., None] + dx,
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


def _descriptors(flat, kx, ky, ksigma, korient, base, kh, kw, opt=None):
    """128-D SIFT descriptors of keypoints [B, K]: a rotated 16x16 grid
    over 4x4 spatial bins of 3 sigma each, trilinear binning into 4x4x8
    as one product per keypoint (lib/VLFeat/sift.c
    vl_sift_calc_keypoint_descriptor)."""
    sampling = getattr(opt, "grad_sampling", "nearest") if opt else "nearest"
    if opt is not None and opt.domain_size_pooling:
        _unported("domain_size_pooling")
    dev = kx.device
    lin = [(i + 0.5) / _D_GRID * 4.0 - 2.0 for i in range(_D_GRID)]
    by, bx = _grid(lin, dev)
    spb = (3.0 * ksigma)[..., None]
    ca = torch.cos(korient)[..., None]
    sa = torch.sin(korient)[..., None]
    rx = ca * bx - sa * by
    ry = sa * bx + ca * by
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


def _check_options(opt: SiftExtractionOptions):
    if opt.first_octave <= -1:
        _unported("first_octave = -1")
    if opt.estimate_affine_shape:
        _unported("estimate_affine_shape")
    if opt.domain_size_pooling:
        _unported("domain_size_pooling")


def extract_sift_tensor(images, options: Optional[SiftExtractionOptions]
                        = None) -> SiftFeatures:
    """SIFT of a [B, H, W] (or [H, W]) float32 image tensor in [0, 1] on
    its own device; SiftFeatures with a leading batch axis (none for a
    single [H, W] image)."""
    opt = options or SiftExtractionOptions()
    _check_options(opt)
    single = images.dim() == 2
    img = (images[None] if single else images).to(torch.float32)
    B = img.shape[0]
    dev = img.device

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
        cand["oscale"] = torch.full((B, D), 2.0 ** o, dtype=torch.float32,
                                    device=dev)
        offset += pflat.shape[1]
        parts.append(cand)
        flats.append(pflat)

    # One flat table over the batch: image b's words start at b * offset.
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

    if opt.upright:
        orients = torch.zeros((B, k_eff, 1), dtype=torch.float32, device=dev)
        ovalid = torch.ones((B, k_eff, 1), dtype=torch.bool, device=dev)
    else:
        hists = _orientation_histograms(flat_all, cat["fx"], cat["fy"],
                                        cat["sigma"], cat["base"], cat["ph"],
                                        cat["pw"], opt.grad_sampling)
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
    descs = _descriptors(flat_all, row["fx"], row["fy"], row["sigma"], ko,
                         row["base"], row["ph"], row["pw"], opt)

    keypoints = torch.stack([row["fx"] * row["oscale"] + 0.5,
                             row["fy"] * row["oscale"] + 0.5,
                             row["sigma"] * row["oscale"], ko], -1)
    desc = _normalize_descriptors(descs, opt.normalization)
    mask = torch.isfinite(vals)
    if k_eff < K:
        def pad(a, fill=0):
            return torch.cat([a, torch.full((B, K - k_eff) + a.shape[2:],
                                            fill, dtype=a.dtype,
                                            device=dev)], 1)
        keypoints, desc, mask = pad(keypoints), pad(desc), pad(mask)
        vals = pad(vals, -math.inf)
    resp = torch.where(mask, vals, torch.zeros_like(vals))
    out = SiftFeatures(keypoints=keypoints, descriptors=desc, mask=mask,
                       response=resp)
    return SiftFeatures(*(a[0] for a in out[:4])) if single else out


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
    (keypoints [B, K, 4] f32, descriptors [B, K, 128] u8, mask [B, K])."""
    opt = options or SiftExtractionOptions()
    imgs = torch.as_tensor(np.asarray(images, np.float32), device=device)
    ft = extract_sift_tensor(imgs, opt)
    return (ft.keypoints.cpu().numpy(),
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
