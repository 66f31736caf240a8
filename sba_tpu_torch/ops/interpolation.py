"""Map sampling: nearest (reference parity), bilinear (soft), and the
packed-neighbourhood samplers of semantic bundle adjustment.

Port of ``sba_tpu/ops/interpolation.py``. Every sample of an SBA map
goes through `sba_tpu_torch.ops.map_gather` (the CUDA kernels on the
card, plain indexing on the CPU); sba_tpu's `_take_u32_rowsel` is a TPU
lane-select layout and has no counterpart here. Samplers over map
stacks take the FLAT ``[N*H*W]`` stack and a per-sample map offset
`base` (int32, broadcast against x and y, e.g. ``[Q, 1]``), and x, y as
separate component tensors (``[Q, S]``).

Packed maps hold u32 words as int32 bit patterns (PyTorch's uint32 has
no shifts on every backend): an arithmetic right shift drags in the sign
bit, so every shift is masked before use. The packers are host numpy and
bit-identical to sba_tpu's.

The samplers run under `torch.autograd.forward_ad`: the gathered words
carry no tangent (an integer-indexed take has a zero derivative, as in
the reference), and the tangent flows through the bilinear weights.
"""

from __future__ import annotations

import numpy as np
import torch

from sba_tpu_torch.ops.map_gather import map_gather, map_gather_pair

JOINT_DEPTH_BITS = 5
JOINT_LABEL_BITS = 3
JOINT_MAX_LABELS = 1 << JOINT_LABEL_BITS


def _gather2d(map2d, yi, xi):
    """map2d [H, W]; yi/xi integer tensors (clipped by caller)."""
    H, W = map2d.shape
    return map2d.reshape(-1)[yi * W + xi]


def to_index(v, lo, hi):
    """Float indices -> int32 after a clamp to [lo, hi] in float (NaN to
    lo): values outside are out of bounds either way, and the clamp keeps
    every cast defined and every gather inside its table (the reference's
    int32 cast of a huge or NaN float is not defined)."""
    return torch.clamp(torch.nan_to_num(v, nan=float(lo)), lo, hi).to(
        torch.int32)


def nearest_sample2d(map2d, xy, fill=0.0):
    """Single-map variant: map2d [H, W], xy [..., 2] -> [...]."""
    H, W = map2d.shape
    xi = to_index(torch.round(xy[..., 0]), -1, W)
    yi = to_index(torch.round(xy[..., 1]), -1, H)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    v = _gather2d(map2d, yi.clamp(0, H - 1), xi.clamp(0, W - 1))
    return torch.where(inb, v, torch.as_tensor(fill, dtype=v.dtype,
                                               device=v.device))


def bilinear_sample2d(map2d, xy, fill=0.0):
    """Bilinear sampling. map2d [H, W], xy [..., 2] -> [...].
    Out-of-bounds (outside the valid interpolation square) -> fill."""
    H, W = map2d.shape
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x0c = x0.clamp(0, W - 1)
    y0c = y0.clamp(0, H - 1)
    x1c = (x0 + 1).clamp(0, W - 1)
    y1c = (y0 + 1).clamp(0, H - 1)
    v00 = _gather2d(map2d, y0c, x0c)
    v01 = _gather2d(map2d, y0c, x1c)
    v10 = _gather2d(map2d, y1c, x0c)
    v11 = _gather2d(map2d, y1c, x1c)
    v = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
         + fy * ((1 - fx) * v10 + fx * v11))
    return torch.where(inb, v, torch.as_tensor(fill, dtype=v.dtype,
                                               device=v.device))


def bilinear_label_agreement(map2d, xy, label, fill=0.0):
    """Differentiable probability that the (integer-valued) label map
    equals `label` at continuous position xy: bilinear blend of the 0/1
    agreement at the four neighbours. map2d [H, W], xy [..., 2]."""
    H, W = map2d.shape
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x0c = x0.clamp(0, W - 1)
    y0c = y0.clamp(0, H - 1)
    x1c = (x0 + 1).clamp(0, W - 1)
    y1c = (y0 + 1).clamp(0, H - 1)
    a00 = (_gather2d(map2d, y0c, x0c) == label).to(x.dtype)
    a01 = (_gather2d(map2d, y0c, x1c) == label).to(x.dtype)
    a10 = (_gather2d(map2d, y1c, x0c) == label).to(x.dtype)
    a11 = (_gather2d(map2d, y1c, x1c) == label).to(x.dtype)
    p = ((1 - fy) * ((1 - fx) * a00 + fx * a01)
         + fy * ((1 - fx) * a10 + fx * a11))
    return torch.where(inb, p, torch.as_tensor(fill, dtype=p.dtype,
                                               device=p.device))


# ---------------------------------------------------------------------------
# Samplers over flat map stacks (the SBA path).
# ---------------------------------------------------------------------------

def _bilinear_setup_xy(H, W, x, y):
    """(x0c, y0c int32, fxe, fye, inb): the clamped top-left corner, the
    fractions (zero across the far edge clamp) and the in-bounds mask."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x0c = to_index(x0, 0, W - 1)
    y0c = to_index(y0, 0, H - 1)
    fxe = torch.where(x0c >= W - 1, torch.zeros_like(fx), fx)
    fye = torch.where(y0c >= H - 1, torch.zeros_like(fy), fy)
    return x0c, y0c, fxe, fye, inb


def _fill(inb, v, fill):
    return torch.where(inb, v, torch.as_tensor(fill, dtype=v.dtype,
                                               device=v.device))


def _blend(fxe, fye, v00, v01, v10, v11):
    return ((1 - fye) * ((1 - fxe) * v00 + fxe * v01)
            + fye * ((1 - fxe) * v10 + fxe * v11))


def _corners(H, W, base, x0c, y0c):
    """Flat int32 indices of the four bilinear corners."""
    x1c = torch.clamp(x0c + 1, 0, W - 1)
    y1c = torch.clamp(y0c + 1, 0, H - 1)
    return (base + y0c * W + x0c, base + y0c * W + x1c,
            base + y1c * W + x0c, base + y1c * W + x1c)


def bilinear_flat(flat_map, H, W, base, x, y, fill=0.0):
    """Bilinear sampling from a FLAT [N*H*W] map stack at offset `base`:
    exact unpacked values (the f64 path), four gathers per sample."""
    x0c, y0c, fxe, fye, inb = _bilinear_setup_xy(H, W, x, y)
    v = [map_gather(flat_map, i.contiguous())
         for i in _corners(H, W, base, x0c, y0c)]
    return _fill(inb, _blend(fxe, fye, *v), fill)


def bilinear_label_agreement_flat_raw(flat_map, H, W, base, x, y, label,
                                      fill=0.0):
    """Unpacked-flat counterpart of `bilinear_label_agreement`."""
    x0c, y0c, fxe, fye, inb = _bilinear_setup_xy(H, W, x, y)
    a = [(map_gather(flat_map, i.contiguous()) == label).to(x.dtype)
         for i in _corners(H, W, base, x0c, y0c)]
    return _fill(inb, _blend(fxe, fye, *a), fill)


# ---------------------------------------------------------------------------
# Packed neighbourhoods: each pixel's 2x2 bilinear patch in one u32 word,
# so that one gather yields a whole patch.
# ---------------------------------------------------------------------------

def pack_label_neighborhood(label_map) -> np.ndarray:
    """[H, W] integer labels (0..255) -> u32 map where bits
    [0:8]=l(y,x), [8:16]=l(y,x+1), [16:24]=l(y+1,x), [24:32]=l(y+1,x+1)
    (edge-clamped). Host-side numpy; done once per solve."""
    m = np.asarray(label_map)
    if m.min() < 0 or m.max() > 255:
        raise ValueError("packed labels require values in [0, 255]")
    m = m.astype(np.uint32)
    r = np.pad(m, ((0, 1), (0, 1)), mode="edge")
    return (r[:-1, :-1] | (r[:-1, 1:] << 8)
            | (r[1:, :-1] << 16) | (r[1:, 1:] << 24))


def pack_depth_nbhd_u8(depth_map, lo=None, hi=None):
    """[H, W] f32 depths -> (u32 map, lo, hi): the 2x2 patch d(y,x),
    d(y,x+1), d(y+1,x), d(y+1,x+1) quantized to u8 against [lo, hi]
    (edge-clamped), one byte per neighbour."""
    m = np.asarray(depth_map, np.float32)
    if lo is None:
        lo = float(m.min())
    if hi is None:
        hi = float(m.max())
    scale = 255.0 / max(hi - lo, 1e-12)
    q = np.clip(np.round((m - lo) * scale), 0, 255).astype(np.uint32)
    r = np.pad(q, ((0, 1), (0, 1)), mode="edge")
    packed = (r[:-1, :-1] | (r[:-1, 1:] << 8)
              | (r[1:, :-1] << 16) | (r[1:, 1:] << 24))
    return packed, np.float32(lo), np.float32(hi)


def pack_joint_nbhd(depth_map, label_code_map, lo=None, hi=None):
    """[H, W] f32 depth + [H, W] palette codes (0..7) -> (u32 map, lo,
    hi) holding the 2x2 patch of BOTH maps (edge-clamped): per corner k
    in (00, 01, 10, 11), bits [5k:5k+5] the 5-bit quantized depth and
    bits [20+3k:23+3k] the 3-bit label code."""
    D, L = JOINT_DEPTH_BITS, JOINT_LABEL_BITS
    m = np.asarray(depth_map, np.float32)
    if lo is None:
        lo = float(m.min())
    if hi is None:
        hi = float(m.max())
    qmax = (1 << D) - 1
    scale = qmax / max(hi - lo, 1e-12)
    q = np.clip(np.round((m - lo) * scale), 0, qmax).astype(np.uint32)
    c = np.asarray(label_code_map).astype(np.uint32)
    if c.max(initial=0) >= JOINT_MAX_LABELS:
        raise ValueError("joint packing requires palette codes < 8")
    rq = np.pad(q, ((0, 1), (0, 1)), mode="edge")
    rc = np.pad(c, ((0, 1), (0, 1)), mode="edge")
    cq = [rq[:-1, :-1], rq[:-1, 1:], rq[1:, :-1], rq[1:, 1:]]
    cc = [rc[:-1, :-1], rc[:-1, 1:], rc[1:, :-1], rc[1:, 1:]]
    out = np.zeros_like(q)
    for k in range(4):
        out |= cq[k] << np.uint32(k * D)
        out |= cc[k] << np.uint32(4 * D + k * L)
    return out, np.float32(lo), np.float32(hi)


def as_int32_words(u32) -> np.ndarray:
    """u32 numpy words -> their int32 bit patterns (the port's storage)."""
    return np.ascontiguousarray(u32, dtype=np.uint32).view(np.int32)


def _fields(u, shift0, step, mask, dtype):
    """The four masked fields of packed words u at shift0 + k * step."""
    return [((u >> (shift0 + k * step)) & mask).to(dtype) for k in range(4)]


def _edge_masks(H, W, x0c, y0c, inb, like):
    """1 where the x (y) derivative of a bilinear sample exists: inside
    the bounds and not across the far edge clamp; else 0."""
    one, zero = torch.ones_like(like), torch.zeros_like(like)
    return (torch.where(inb & (x0c < W - 1), one, zero),
            torch.where(inb & (y0c < H - 1), one, zero))


def _depth_u8(u, fxe, fye, inb, lo, hi, fill):
    """Bilinear depth of u8 depth patches (int32 words u)."""
    v = _blend(fxe, fye, *_fields(u, 0, 8, 0xFF, fxe.dtype))
    return _fill(inb, v * ((hi - lo) / 255.0) + lo, fill)


def _depth_u8_grad(u, H, W, x0c, y0c, fxe, fye, inb, lo, hi, fill):
    """(depth, d/dx, d/dy) of u8 depth patches."""
    dq = (hi - lo) / 255.0
    v00, v01, v10, v11 = _fields(u, 0, 8, 0xFF, fxe.dtype)
    v = _blend(fxe, fye, v00, v01, v10, v11) * dq + lo
    mx, my = _edge_masks(H, W, x0c, y0c, inb, v)
    ddx = ((1 - fye) * (v01 - v00) + fye * (v11 - v10)) * (mx * dq)
    ddy = ((1 - fxe) * (v10 - v00) + fxe * (v11 - v01)) * (my * dq)
    return _fill(inb, v, fill), ddx, ddy


def _label_hits(u, label, shift0, step, mask, dtype):
    """0/1 agreement of the four packed label fields with `label`."""
    lab = label.to(torch.int32)
    return [(f == lab).to(dtype)
            for f in _fields(u, shift0, step, mask, torch.int32)]


def _agreement(u, fxe, fye, inb, label, fill):
    """Bilinear agreement of u8 label patches with `label`."""
    return _fill(inb, _blend(fxe, fye, *_label_hits(u, label, 0, 8, 0xFF,
                                                     fxe.dtype)), fill)


def _agreement_grad(u, H, W, x0c, y0c, fxe, fye, inb, label, fill):
    """(agreement, d/dx, d/dy) of u8 label patches."""
    a00, a01, a10, a11 = _label_hits(u, label, 0, 8, 0xFF, fxe.dtype)
    p = _blend(fxe, fye, a00, a01, a10, a11)
    mx, my = _edge_masks(H, W, x0c, y0c, inb, p)
    ddx = ((1 - fye) * (a01 - a00) + fye * (a11 - a10)) * mx
    ddy = ((1 - fxe) * (a10 - a00) + fxe * (a11 - a01)) * my
    return _fill(inb, p, fill), ddx, ddy


def _flat_index(H, W, base, x, y):
    s = _bilinear_setup_xy(H, W, x, y)
    return s, (base + s[1] * W + s[0]).contiguous()


def bilinear_depth_u8_flat(flat_u32, H, W, base, x, y, lo, hi, fill=0.0):
    """Bilinear depth from a flattened stack of `pack_depth_nbhd_u8`
    maps (int32 words): one gather per sample. `base` is the sample's
    map offset, lo/hi its dequantization range."""
    (x0c, y0c, fxe, fye, inb), i = _flat_index(H, W, base, x, y)
    return _depth_u8(map_gather(flat_u32, i), fxe, fye, inb, lo, hi, fill)


def bilinear_depth_u8_grad(flat_u32, H, W, base, x, y, lo, hi, fill=0.0):
    """`bilinear_depth_u8_flat` + analytic screen-space derivatives:
    (value, d/dx, d/dy), zero outside the bounds and across the edge
    clamp, as forward-mode AD of the flat sampler gives them."""
    (x0c, y0c, fxe, fye, inb), i = _flat_index(H, W, base, x, y)
    return _depth_u8_grad(map_gather(flat_u32, i), H, W, x0c, y0c, fxe,
                          fye, inb, lo, hi, fill)


def bilinear_label_agreement_flat(flat_u32, H, W, base, x, y, label,
                                  fill=0.0):
    """Label agreement against a flattened `pack_label_neighborhood`
    stack: one gather per sample."""
    (x0c, y0c, fxe, fye, inb), i = _flat_index(H, W, base, x, y)
    return _agreement(map_gather(flat_u32, i), fxe, fye, inb, label, fill)


def bilinear_label_agreement_grad(flat_u32, H, W, base, x, y, label,
                                  fill=0.0):
    """`bilinear_label_agreement_flat` + analytic screen derivatives."""
    (x0c, y0c, fxe, fye, inb), i = _flat_index(H, W, base, x, y)
    return _agreement_grad(map_gather(flat_u32, i), H, W, x0c, y0c, fxe,
                           fye, inb, label, fill)


def pair_table(depth_packed, label_packed) -> np.ndarray:
    """The two-map path's interleaved table: [N*H*W, 2] int32 words, a
    pixel's u8 depth patch beside its u8 label patch, so that one 8-byte
    load serves both maps (sba_tpu keeps two tables, two gathers)."""
    return np.stack([as_int32_words(depth_packed).reshape(-1),
                     as_int32_words(label_packed).reshape(-1)], axis=-1)


def bilinear_depth_label_flat(table2, H, W, base, x, y, label, lo, hi,
                              depth_fill=0.0):
    """Primal two-map sampler: (depth2, agree) from ONE gather of the
    interleaved `pair_table`; the same values as `bilinear_depth_u8_flat`
    + `bilinear_label_agreement_flat` on the separate tables."""
    (x0c, y0c, fxe, fye, inb), i = _flat_index(H, W, base, x, y)
    w = map_gather_pair(table2, i)
    return (_depth_u8(w[..., 0], fxe, fye, inb, lo, hi, depth_fill),
            _agreement(w[..., 1], fxe, fye, inb, label, 0.0))


def bilinear_depth_label_grad(table2, H, W, base, x, y, label, lo, hi,
                              depth_fill=0.0):
    """ONE pair gather -> (depth2, dD/dx, dD/dy, agree, dA/dx, dA/dy):
    `bilinear_depth_u8_grad` + `bilinear_label_agreement_grad` on the
    interleaved `pair_table`."""
    (x0c, y0c, fxe, fye, inb), i = _flat_index(H, W, base, x, y)
    w = map_gather_pair(table2, i)
    d = _depth_u8_grad(w[..., 0], H, W, x0c, y0c, fxe, fye, inb, lo, hi,
                       depth_fill)
    a = _agreement_grad(w[..., 1], H, W, x0c, y0c, fxe, fye, inb, label,
                        0.0)
    return (*d, *a)


def bilinear_joint_grad(flat_u32, H, W, base, x, y, src_code, lo, hi,
                        depth_fill=0.0):
    """ONE gather of `pack_joint_nbhd` words -> (depth2, dD/dx, dD/dy,
    agree, dA/dx, dA/dy); derivatives zero outside the bounds and across
    the edge clamp."""
    D, L = JOINT_DEPTH_BITS, JOINT_LABEL_BITS
    (x0c, y0c, fxe, fye, inb), i = _flat_index(H, W, base, x, y)
    u = map_gather(flat_u32, i)
    qmax = (1 << D) - 1
    dq = (hi - lo) / qmax
    v00, v01, v10, v11 = _fields(u, 0, D, qmax, x.dtype)
    a00, a01, a10, a11 = _label_hits(u, src_code, 4 * D, L, (1 << L) - 1,
                                     x.dtype)
    v = _blend(fxe, fye, v00, v01, v10, v11) * dq + lo
    p = _blend(fxe, fye, a00, a01, a10, a11)
    mx, my = _edge_masks(H, W, x0c, y0c, inb, p)
    dDx = ((1 - fye) * (v01 - v00) + fye * (v11 - v10)) * mx * dq
    dDy = ((1 - fxe) * (v10 - v00) + fxe * (v11 - v01)) * my * dq
    dAx = ((1 - fye) * (a01 - a00) + fye * (a11 - a10)) * mx
    dAy = ((1 - fxe) * (a10 - a00) + fxe * (a11 - a01)) * my
    return (_fill(inb, v, depth_fill), dDx, dDy, _fill(inb, p, 0.0), dAx,
            dAy)


def bilinear_joint_flat(flat_u32, H, W, base, x, y, src_code, lo, hi,
                        depth_fill=0.0):
    """Primal-only joint sampler: (depth2, agree) from one gather."""
    D, L = JOINT_DEPTH_BITS, JOINT_LABEL_BITS
    (x0c, y0c, fxe, fye, inb), i = _flat_index(H, W, base, x, y)
    u = map_gather(flat_u32, i)
    qmax = (1 << D) - 1
    v = _blend(fxe, fye, *_fields(u, 0, D, qmax, x.dtype))
    p = _blend(fxe, fye, *_label_hits(u, src_code, 4 * D, L, (1 << L) - 1,
                                      x.dtype))
    return (_fill(inb, v * ((hi - lo) / qmax) + lo, depth_fill),
            _fill(inb, p, 0.0))
