"""Vote-and-Verify spatial re-ranking for image retrieval.

Port of ``sba_tpu/retrieval/vote_and_verify.py`` (ref:
src/retrieval/vote_and_verify.{h,cc}, Schonberger et al., ACCV 2016):
each tentative match (keypoints carry x, y, scale, orientation) implies
a 4-DoF similarity; votes go into a dense (tx, ty, log-scale, angle)
histogram (one bincount), the strongest bins become hypotheses (one
`top_k` with `lax.top_k`'s order: the votes are integers and tie
often), and each hypothesis is verified against every match in one
[K, M] broadcast, in float32 on the matches' device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from sba_tpu_torch.ops.topk import top_k


@dataclass(frozen=True)
class VoteAndVerifyOptions:
    """Mirrors ref vote_and_verify.h:40 defaults."""

    num_transformations: int = 30
    num_trans_bins: int = 64
    num_scale_bins: int = 32
    num_angle_bins: int = 8
    max_image_size: int = 4096
    min_num_votes: int = 1
    max_transfer_error: float = 100.0 ** 2
    max_scale_error: float = 2.0


def _match_transforms(g1, g2):
    """Per-match similarity g1 -> g2: (scale, cos a, sin a, a, tx, ty).
    g: [M, 4] = (x, y, scale, orientation)."""
    s = g2[:, 2] / torch.clamp(g1[:, 2], min=1e-12)
    da = g2[:, 3] - g1[:, 3]
    ca, sa = torch.cos(da), torch.sin(da)
    tx = g2[:, 0] - s * (ca * g1[:, 0] - sa * g1[:, 1])
    ty = g2[:, 1] - s * (sa * g1[:, 0] + ca * g1[:, 1])
    return s, ca, sa, da, tx, ty


def _bin(v, n):
    """clip(int32(v), 0, n - 1), the cast of a value clamped in float
    first (so that it is defined; the same bin after the clip)."""
    v = torch.clamp(torch.nan_to_num(v, nan=0.0), -1.0, float(n))
    return v.to(torch.int64).clamp_(0, n - 1)


def _mod(x, m: float):
    """`jnp.mod`: fmod, then shifted to the sign of the divisor."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def vote_and_verify(g1, g2, mask=None,
                    options: VoteAndVerifyOptions = VoteAndVerifyOptions(),
                    device="cuda") -> int:
    """Effective inlier count for tentative matches g1[i] <-> g2[i].

    g1, g2: [M, 4] keypoint geometries (x, y, scale, orientation), numpy
    (moved to `device`) or tensors (on their own device); mask: [M]
    valid-match mask. Returns an int (0 when nothing verifies, as the
    reference returns 0 for fewer than min_num_votes votes).
    """
    opt = options
    M = g1.shape[0]
    if M == 0:
        return 0
    if torch.is_tensor(g1):
        device = g1.device
    g1 = torch.as_tensor(np.asarray(g1, np.float32) if not torch.is_tensor(
        g1) else g1, dtype=torch.float32, device=device)
    g2 = torch.as_tensor(np.asarray(g2, np.float32) if not torch.is_tensor(
        g2) else g2, dtype=torch.float32, device=device)
    valid = (torch.ones(M, dtype=torch.bool, device=device) if mask is None
             else torch.as_tensor(np.asarray(mask), device=device) > 0)

    s, ca, sa, da, tx, ty = _match_transforms(g1, g2)

    # --- vote ---
    nt, ns, na = opt.num_trans_bins, opt.num_scale_bins, opt.num_angle_bins
    half = float(opt.max_image_size)
    bx = _bin((tx + half) / (2 * half) * nt, nt)
    by = _bin((ty + half) / (2 * half) * nt, nt)
    # log2 scale in [-4, 4) -> ns bins.
    ls = torch.log2(torch.clamp(s, min=1e-12))
    bs = _bin((ls + 4.0) / 8.0 * ns, ns)
    ang = _mod(da, 2 * math.pi)
    ba = _bin(ang / (2 * math.pi) * na, na)
    flat = ((bx * nt + by) * ns + bs) * na + ba
    nbins = nt * nt * ns * na
    flat = torch.where(valid, flat, torch.full_like(flat, nbins))  # spill
    votes = torch.bincount(flat, minlength=nbins + 1)[:-1]

    top_v, top_i = top_k(votes.to(torch.float32), opt.num_transformations)

    # --- hypothesis transforms: vote-weighted means per top bin ---
    in_bin = flat[None, :] == top_i[:, None]              # [K, M]
    w = (in_bin & valid[None, :]).to(torch.float32)
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    h_s = torch.sum(w * s[None, :], dim=1) / cnt
    h_ca = torch.sum(w * ca[None, :], dim=1) / cnt
    h_sa = torch.sum(w * sa[None, :], dim=1) / cnt
    h_tx = torch.sum(w * tx[None, :], dim=1) / cnt
    h_ty = torch.sum(w * ty[None, :], dim=1) / cnt
    nrm = torch.clamp(torch.sqrt(h_ca ** 2 + h_sa ** 2), min=1e-12)
    h_ca, h_sa = h_ca / nrm, h_sa / nrm

    # --- verify: transfer + scale error of every match under each hyp ---
    px = h_s[:, None] * (h_ca[:, None] * g1[None, :, 0]
                         - h_sa[:, None] * g1[None, :, 1]) + h_tx[:, None]
    py = h_s[:, None] * (h_sa[:, None] * g1[None, :, 0]
                         + h_ca[:, None] * g1[None, :, 1]) + h_ty[:, None]
    terr = (px - g2[None, :, 0]) ** 2 + (py - g2[None, :, 1]) ** 2
    sratio = s[None, :] / torch.clamp(h_s[:, None], min=1e-12)
    serr = torch.maximum(sratio, 1.0 / torch.clamp(sratio, min=1e-12))
    inl = (terr <= opt.max_transfer_error) & \
        (serr <= opt.max_scale_error) & valid[None, :]
    counts = torch.sum(inl, dim=1)
    counts = torch.where(top_v >= opt.min_num_votes, counts,
                         torch.zeros_like(counts))
    return int(torch.max(counts))


def word_matches(words_q, geoms_q, words_db, geoms_db, max_matches=4096):
    """Tentative matches by shared visual word (host-side join, as the
    index lives on the host). Returns (g1 [M,4], g2 [M,4]) numpy arrays,
    capped at max_matches."""
    words_q = np.asarray(words_q)
    words_db = np.asarray(words_db)
    order_db = np.argsort(words_db, kind="stable")
    sorted_db = words_db[order_db]
    lo = np.searchsorted(sorted_db, words_q, side="left")
    hi = np.searchsorted(sorted_db, words_q, side="right")
    g1, g2 = [], []
    total = 0
    for i in range(len(words_q)):
        for k in range(lo[i], hi[i]):
            g1.append(geoms_q[i])
            g2.append(geoms_db[order_db[k]])
            total += 1
            if total >= max_matches:
                break
        if total >= max_matches:
            break
    if not g1:
        return (np.zeros((0, 4), np.float32), np.zeros((0, 4), np.float32))
    return np.asarray(g1, np.float32), np.asarray(g2, np.float32)
