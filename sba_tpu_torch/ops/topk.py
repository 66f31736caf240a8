"""`top_k` with ``jax.lax.top_k``'s order.

``lax.top_k`` returns the k largest values in descending order and puts
the lower index first among equal values. ``torch.topk`` makes no such
promise on CUDA. Here each float32 value becomes an int32 key in the
same total order (-inf < finite < inf, -0.0 < 0.0), the key is widened
to int64 with the complement of the index below it, and ``torch.topk``
runs on those keys, which are all distinct.
"""

from __future__ import annotations

import torch


def top_k(x, k: int):
    """(values, indices) of the k largest entries along the last axis of
    float32 `x`, descending, lower index first among equal values."""
    if x.dtype != torch.float32:
        raise ValueError(f"top_k: float32 only, got {x.dtype}")
    n = x.shape[-1]
    if n >= 1 << 31:
        raise ValueError("top_k: axis longer than 2^31")
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    low = (1 << 32) - 1 - torch.arange(n, device=x.device, dtype=torch.int64)
    idx = torch.topk(key * (1 << 32) + low, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx
