"""SIFT descriptor matching: one float32 product, ratio and cross checks.

Port of ``sba_tpu/features/matching.py`` (ref: src/feature/sift.cc
`MatchSiftFeaturesCPUBruteForce` :973, `MatchGuidedSiftFeaturesGPU`
:1024): the [N1, N2] dot products of normalized descriptors are one
matmul in true float32 (TF32 off), distances are their arccos
(radians), and each row keeps its best column if it passes the
distance, ratio and mutual checks (`max_distance` 0.7, `max_ratio` 0.8;
ref: sift.h:116-140).

`_best_two` takes the first minimum (``torch.argmin``'s documented
order, and the lower index that ``lax.top_k`` puts first among ties), so
masked (+inf) columns and equal distances resolve as in sba_tpu.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from sba_tpu_torch.features.sift import require_fp32_matmul


@dataclass(frozen=True)
class SiftMatchingOptions:
    """Mirrors ref: src/feature/sift.h:116 `SiftMatchingOptions` (subset)."""

    max_ratio: float = 0.8
    max_distance: float = 0.7
    cross_check: bool = True
    max_error: float = 4.0        # guided matching epipolar threshold (px)
    block_size: int = 16384


class MatchResult(NamedTuple):
    """matches12 [..., N1] int32 index into features2 or -1; distances in
    arccos radians (+inf where unmatched)."""

    matches12: torch.Tensor
    distances: torch.Tensor

    @property
    def num_matches(self):
        return torch.sum(self.matches12 >= 0, -1)


def _acos_distance(d1, d2):
    """[..., N1, N2] arccos of the float32 dot products."""
    require_fp32_matmul(d1)
    sim = d1 @ d2.transpose(-1, -2)
    return torch.arccos(torch.clamp(sim, -1.0, 1.0))


def _best_two(dist, valid_cols):
    """Per row of [..., N1, N2]: (first best column, best, second best)
    over the valid columns (+inf elsewhere)."""
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    masked = torch.where(valid_cols[..., None, :], dist, inf)
    best = torch.argmin(masked, dim=-1)
    d1 = torch.gather(masked, -1, best[..., None])
    if masked.shape[-1] < 2:
        return best, d1[..., 0], torch.full_like(d1[..., 0], float("inf"))
    rest = masked.scatter(-1, best[..., None], float("inf"))
    return best, d1[..., 0], torch.amin(rest, dim=-1)


def _ratio_match(dist, v1, v2, opt):
    """Ratio and distance tests plus the mutual check on dist [..., N1,
    N2] with row/column validity v1 [..., N1], v2 [..., N2]."""
    n1 = dist.shape[-2]
    best12, d12, s12 = _best_two(dist, v2)
    ok = (d12 <= opt.max_distance) & (d12 < opt.max_ratio * s12) & v1
    if opt.cross_check:
        best21, _, _ = _best_two(dist.transpose(-1, -2), v1)
        back = torch.gather(best21, -1, best12)
        ok = ok & (back == torch.arange(n1, device=dist.device))
    matches = torch.where(ok, best12, torch.full_like(best12, -1))
    return MatchResult(matches12=matches.to(torch.int32),
                       distances=torch.where(ok, d12, torch.full_like(
                           d12, float("inf"))))


def _valid(mask, n, like):
    if mask is None:
        return torch.ones(n, dtype=torch.bool, device=like.device)
    return torch.as_tensor(mask, device=like.device).to(torch.bool)


def match_descriptors(desc1, desc2, mask1=None, mask2=None,
                      options: Optional[SiftMatchingOptions] = None
                      ) -> MatchResult:
    """Ratio-test and cross-check matching of [N1, 128] and [N2, 128]
    normalized float32 descriptors (rows outside mask* are invalid)."""
    opt = options or SiftMatchingOptions()
    v1 = _valid(mask1, desc1.shape[0], desc1)
    v2 = _valid(mask2, desc2.shape[0], desc2)
    return _ratio_match(_acos_distance(desc1, desc2), v1, v2, opt)


def match_guided(desc1, desc2, xy1, xy2, F, mask1=None, mask2=None,
                 options: Optional[SiftMatchingOptions] = None
                 ) -> MatchResult:
    """Ratio matching restricted to pairs whose epipolar distances under
    F (image 1 -> lines in image 2) are both within `max_error` px."""
    opt = options or SiftMatchingOptions()
    v1 = _valid(mask1, desc1.shape[0], desc1)
    v2 = _valid(mask2, desc2.shape[0], desc2)
    h1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], -1)
    h2 = torch.cat([xy2, torch.ones_like(xy2[:, :1])], -1)
    l2 = h1 @ F.T
    l1 = h2 @ F
    num = torch.abs(l2 @ h2.T)
    d_a = num / (torch.linalg.norm(l2[:, :2], dim=-1, keepdim=True) + 1e-12)
    d_b = num / (torch.linalg.norm(l1[:, :2], dim=-1)[None, :] + 1e-12)
    epi_ok = torch.maximum(d_a, d_b) <= opt.max_error
    dist = _acos_distance(desc1, desc2)
    dist = torch.where(epi_ok, dist, torch.full_like(dist, float("inf")))
    return _ratio_match(dist, v1, v2, opt)


# Pairs matched at once by `match_pairs_batched` (their [N, N] distance
# blocks are the memory).
PAIR_CHUNK = 8


def match_pairs_batched(desc_u8_stack, nvalid, pair_idx,
                        options: Optional[SiftMatchingOptions] = None):
    """Match a batch of image pairs against a device-resident descriptor
    stack: desc_u8_stack [I, N, 128] uint8 (rows past nvalid[i] zero),
    nvalid [I], pair_idx [Bp, 2]. Returns (matches12 [Bp, N] int32,
    num_matches [Bp]) on the stack's device."""
    opt = options or SiftMatchingOptions()
    stack = desc_u8_stack
    dev = stack.device
    N = stack.shape[1]
    nv = torch.as_tensor(nvalid, device=dev)
    pidx = torch.as_tensor(np.asarray(pair_idx), device=dev).to(torch.int64)
    ar = torch.arange(N, device=dev)
    out = []
    for p0 in range(0, pidx.shape[0], PAIR_CHUNK):
        p = pidx[p0:p0 + PAIR_CHUNK]
        d1 = stack[p[:, 0]].to(torch.float32)
        d2 = stack[p[:, 1]].to(torch.float32)
        d1 = d1 / (torch.linalg.norm(d1, dim=-1, keepdim=True) + 1e-12)
        d2 = d2 / (torch.linalg.norm(d2, dim=-1, keepdim=True) + 1e-12)
        m1 = ar[None] < nv[p[:, 0]][:, None]
        m2 = ar[None] < nv[p[:, 1]][:, None]
        out.append(_ratio_match(_acos_distance(d1, d2), m1, m2, opt)
                   .matches12)
    m = torch.cat(out)
    return m, torch.sum(m >= 0, -1).to(torch.int32)


def matches_to_pairs(result: MatchResult):
    """Host-side: MatchResult -> [M, 2] numpy index pairs (i1, i2)."""
    m = result.matches12.cpu().numpy()
    i1 = np.nonzero(m >= 0)[0]
    return np.stack([i1, m[i1]], axis=-1).astype(np.int32)
