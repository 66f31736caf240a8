"""Segment sums in a fixed order.

`index_add_` on CUDA adds floats with atomics, in no fixed order, so two
runs (or two ranks that compute the same replicated sum) can differ in
the last bits. A sum whose result every rank must hold bit-equal, or
that must repeat itself from run to run, goes through `segment_sum`:
each segment's rows in row order.
"""

from __future__ import annotations

import torch


def segment_table(idx: torch.Tensor, n: int):
    """CSR form of n segments keyed by `idx`: (the rows sorted by segment
    id, stably, and each segment's row count)."""
    idx = idx.long()
    return (torch.argsort(idx, stable=True),
            torch.bincount(idx, minlength=n))


def segment_sum(x: torch.Tensor, table) -> torch.Tensor:
    """Rows of x summed by segment (a `segment_table`), each segment's
    rows in row order: the same bits from run to run on every device,
    with no padding to the largest segment. Empty segments are 0."""
    order, counts = table
    return torch.segment_reduce(x[order], "sum", lengths=counts, axis=0)
