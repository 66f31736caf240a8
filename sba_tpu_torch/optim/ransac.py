"""RANSAC / LO-RANSAC as fixed-size batched hypothesis evaluation.

Port of ``sba_tpu/optim/ransac.py`` (ref: src/optim/ransac.h:80,
loransac.h:54, support_measurement.h). K minimal samples are drawn up
front, all hypotheses are solved at once, every hypothesis is scored
over all points (MSAC by default), the first maximum wins, and the LO
rounds refit the winner on its inliers.

The port's core, `_ransac_impl`, is batched over a leading axis of
independent problems (the image pairs of one verification batch), where
sba_tpu vmaps a one-problem function. Draws come from a
``torch.Generator`` (uniform scores, then a top-k), so they are not
sba_tpu's; every entry point also takes a precomputed ``samples`` tensor,
which is how a test hands both packages the same draws. sba_tpu's jit
cache has no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


@dataclass(frozen=True)
class RANSACOptions:
    """Mirrors ref: src/optim/ransac.h RANSACOptions."""

    max_error: float = 4.0           # inlier threshold on sqrt(residual)
    min_inlier_ratio: float = 0.25   # pessimistic prior -> batch size
    confidence: float = 0.999
    min_num_trials: int = 32
    max_num_trials: int = 4096
    num_lo_steps: int = 2            # LO-RANSAC refinement rounds
    scoring: str = "msac"            # "msac" or "inlier_count"


def num_required_trials(sample_size: int, opt: RANSACOptions) -> int:
    """Static trial count from the reference's stopping criterion
    (ref: ransac.h:143-182), evaluated at the prior inlier ratio."""
    w = max(opt.min_inlier_ratio, 1e-3) ** sample_size
    if w >= 1.0:
        return opt.min_num_trials
    n = math.log(max(1.0 - opt.confidence, 1e-12)) / math.log(1.0 - w + 1e-300)
    return int(min(max(n, opt.min_num_trials), opt.max_num_trials))


class RANSACReport(NamedTuple):
    model: torch.Tensor          # best model [..., *model shape]
    num_inliers: torch.Tensor    # [...] int
    inlier_mask: torch.Tensor    # [..., N] bool
    support_trace: torch.Tensor  # [..., trials * models] scores


def draw_samples(num_points: int, num_trials: int, sample_size: int,
                 mask=None, progressive: bool = False,
                 generator: Optional[torch.Generator] = None,
                 batch: tuple = ()):
    """[*batch, num_trials, sample_size] int64 index samples: per trial
    uniform scores, invalid points (mask [*batch, N] false) at -inf, the
    top `sample_size` indices (no duplicates within a sample).
    `progressive=True` restricts trial t to a prefix growing from
    2 * sample_size to all points (the PROSAC idea). The draws lie on the
    generator's device, else on the mask's."""
    if generator is not None:
        device = generator.device
    elif mask is not None:
        device = mask.device
    else:
        raise ValueError("draw_samples needs a generator or a mask")
    scores = torch.rand(tuple(batch) + (num_trials, num_points),
                        generator=generator, device=device)
    if mask is not None:
        scores = scores.masked_fill(~(mask[..., None, :] > 0), -math.inf)
    if progressive:
        t = torch.arange(num_trials, device=scores.device)[:, None]
        frac = torch.clamp((t + 1) / max(num_trials * 0.7, 1.0), max=1.0)
        prefix = torch.clamp(frac * num_points, min=2 * sample_size).to(
            torch.int64)
        idx = torch.arange(num_points, device=scores.device)[None, :]
        scores = scores.masked_fill(~(idx < prefix), -math.inf)
    return torch.topk(scores, sample_size, dim=-1).indices


def _take_samples(d, samples):
    """d [B, N, ...] at samples [B, T, s] -> [B, T, s, ...]."""
    B, T, s = samples.shape
    flat = samples.reshape(B, T * s)
    idx = flat.reshape(B, T * s, *([1] * (d.dim() - 2))).expand(
        B, T * s, *d.shape[2:])
    return torch.gather(d, 1, idx).reshape(B, T, s, *d.shape[2:])


# Elements of the [B, models, N] residual block scored at once (the
# intermediates of a residual hold ~3x that).
SCORE_CHUNK_ELEMS = 1 << 24


def _scores(models, valid, data, residual_fn, valid_mask, thr2, use_msac):
    """[B, K] scores of models [B, K, ...] (higher is better; -inf where
    not valid), in chunks of models."""
    B, K = valid.shape
    N = data[0].shape[1]
    step = max(1, SCORE_CHUNK_ELEMS // max(B * N, 1))
    exp = tuple(d[:, None] for d in data)
    t2 = thr2[:, None, None]
    out = []
    for k0 in range(0, K, step):
        r = residual_fn(models[:, k0:k0 + step], *exp)     # [B, c, N]
        if use_msac:
            s = -torch.sum(torch.where(valid_mask[:, None, :],
                                       torch.minimum(r, t2),
                                       torch.zeros_like(r)), -1)
        else:
            s = torch.sum((r <= t2) & valid_mask[:, None, :], -1).to(r.dtype)
        out.append(s)
    s = torch.cat(out, 1)
    return torch.where(valid, s, torch.full_like(s, -math.inf))


def _select(a, idx):
    """a [B, K, ...] at idx [B] -> [B, ...]."""
    g = idx.reshape(-1, 1, *([1] * (a.dim() - 2))).expand(
        a.shape[0], 1, *a.shape[2:])
    return torch.gather(a, 1, g)[:, 0]


def _ransac_impl(data, solve_fn: Callable, residual_fn: Callable,
                 sample_size: int, opt: RANSACOptions, mask, refit_fn,
                 samples, max_error=None) -> RANSACReport:
    """Batched (LO-)RANSAC over B independent problems.

    data: tuple of [B, N, ...] tensors; mask [B, N] (None: all valid);
    samples [B, T, sample_size] indices; solve_fn(*sampled [B, T, s, ...])
    -> (models [B, T, M, ...], valid [B, T, M]); residual_fn(models
    [B, K, ...], *data [B, 1, N, ...]) -> squared residuals [B, K, N];
    refit_fn(weights [B, N], *data) -> models [B, ...]. max_error: a
    float or a [B] tensor (per-problem threshold)."""
    B, N = data[0].shape[:2]
    dtype, device = data[0].dtype, data[0].device
    me = opt.max_error if max_error is None else max_error
    thr2 = torch.as_tensor(me, dtype=dtype, device=device) ** 2
    thr2 = thr2.expand(B) if thr2.dim() == 0 else thr2
    valid_mask = torch.ones(B, N, dtype=torch.bool, device=device) \
        if mask is None else (mask > 0)
    use_msac = opt.scoring == "msac"

    models, valid = solve_fn(*(_take_samples(d, samples) for d in data))
    T, M = valid.shape[1:3]
    flat_models = models.reshape(B, T * M, *models.shape[3:])
    support = _scores(flat_models, valid.reshape(B, T * M), data,
                      residual_fn, valid_mask, thr2, use_msac)
    best = torch.argmax(support, dim=1)
    best_model = _select(flat_models, best)
    best_support = _select(support[..., None], best)[:, 0]

    if refit_fn is not None:
        true_ = torch.ones(B, 1, dtype=torch.bool, device=device)
        for _ in range(opt.num_lo_steps):
            r = residual_fn(best_model[:, None], *(d[:, None] for d in data))
            w = ((r[:, 0] <= thr2[:, None]) & valid_mask).to(dtype)
            refined = refit_fn(w, *data)
            sup2 = _scores(refined[:, None], true_, data, residual_fn,
                           valid_mask, thr2, use_msac)[:, 0]
            better = sup2 >= best_support
            best_model = torch.where(
                better.reshape(-1, *([1] * (refined.dim() - 1))), refined,
                best_model)
            best_support = torch.maximum(best_support, sup2)

    r = residual_fn(best_model[:, None], *(d[:, None] for d in data))[:, 0]
    inlier_mask = (r <= thr2[:, None]) & valid_mask
    return RANSACReport(model=best_model,
                        num_inliers=torch.sum(inlier_mask, -1),
                        inlier_mask=inlier_mask, support_trace=support)


def ransac(data, solve_fn: Callable, residual_fn: Callable,
           sample_size: int, options: Optional[RANSACOptions] = None,
           mask=None, refit_fn: Optional[Callable] = None,
           progressive: bool = False, max_error=None,
           generator: Optional[torch.Generator] = None, samples=None
           ) -> RANSACReport:
    """(LO-)RANSAC on one problem: data a tuple of [N, ...] tensors.

    The functions are those of `_ransac_impl` (batched over a leading
    axis of one here). `samples` [T, sample_size] replaces the draws;
    else T = `num_required_trials` samples are drawn from `generator`
    (a fresh one seeded 0 if None)."""
    opt = options or RANSACOptions()
    if max_error is not None:
        opt = dataclasses.replace(opt, max_error=float(max_error))
    n = data[0].shape[0]
    device = data[0].device
    if samples is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        samples = draw_samples(n, num_required_trials(sample_size, opt),
                               sample_size, mask=mask,
                               progressive=progressive, generator=generator)
    samples = torch.as_tensor(samples, device=device).to(torch.int64)
    rep = _ransac_impl(tuple(d[None] for d in data), solve_fn, residual_fn,
                       sample_size, opt,
                       None if mask is None else mask[None], refit_fn,
                       samples[None])
    return RANSACReport(*(a[0] for a in rep))
