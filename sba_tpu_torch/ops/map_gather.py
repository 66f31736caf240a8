"""Map gathers of semantic bundle adjustment: CUDA wrappers and their
plain twins.

Port of the four Pallas TPU gather probes B1-B4 (``benchmarks/
gather_micro.py::f4, f4b`` and ``benchmarks/gather_micro2.py::fD, fE``)
and of the gather they stand for, ``sba_tpu/ops/interpolation.py::
_take_u32_rowsel``. Two functions:

- `map_gather(table, idx, per, hw)`: ``out[k] = table.flat[base(k) +
  idx[k]]`` over 4-byte words (u32 packed maps stored as int32, f32
  maps) or 8-byte words (f64 maps). ``base(k) = (k // per) * hw`` in the
  probes' form (``per`` samples of each map, ``hw`` words per map,
  indices local to their map); ``per = 0`` is the SBA path's form, where
  the indices are already flat. B1, B2 and B4 compute this function.
- `map_gather_pair(table, idx, per, hw, summed)`: the table is
  ``[K, 2]`` 4-byte words, a pixel's depth word beside its label word;
  one 8-byte load per sample yields both. ``summed=True`` returns their
  u32 sum (B3's epilogue), else both words ``[..., 2]`` (the two-map
  SBA sampler).

CUDA tensors go through the hand-written kernels of
``csrc/map_gather.cu``; CPU tensors through the twins (plain indexing).
Indices are int32 and must lie inside their table: the twins raise on
one that does not, the kernels do not check.
"""

from __future__ import annotations

import torch

from sba_tpu_torch.ops import cuda_build

# Launch counts of the CUDA kernels (each wrapper adds one per launch).
LAUNCHES = {"map_gather": 0, "map_gather_pair": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _flat_index(idx, per: int, hw: int):
    """int64 global indices: idx + (k // per) * hw (per = 0: idx)."""
    i = idx.reshape(-1).to(torch.int64)
    if per:
        k = torch.arange(i.numel(), device=i.device)
        i = i + (k // per) * hw
    return i


def map_gather_plain(table, idx, per: int = 0, hw: int = 0):
    """Plain twin of `map_gather`: one indexing of the flat table."""
    return table.reshape(-1)[_flat_index(idx, per, hw)].reshape(idx.shape)


def map_gather_pair_plain(table, idx, per: int = 0, hw: int = 0,
                          summed: bool = False):
    """Plain twin of `map_gather_pair`."""
    rows = table.reshape(-1, 2)[_flat_index(idx, per, hw)]
    if not summed:
        return rows.reshape(*idx.shape, 2)
    s = (rows[:, 0].to(torch.int64) + rows[:, 1].to(torch.int64)) \
        & 0xFFFFFFFF
    return (s - ((s >> 31) << 32)).to(torch.int32).reshape(idx.shape)


def _check(table, idx, name):
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: table and idx must be contiguous")
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"{name}: idx on {idx.device}, table on "
                         f"{table.device}")


def map_gather(table, idx, per: int = 0, hw: int = 0):
    """``out[k] = table.flat[base(k) + idx[k]]``, shaped like `idx`, of
    the table's dtype (see the module docstring). A CUDA table goes
    through the kernel (4- or 8-byte words), a CPU table through
    `map_gather_plain`."""
    if not table.is_cuda:
        return map_gather_plain(table, idx, per, hw)
    _check(table, idx, "map_gather")
    word = table.element_size()
    if word not in (4, 8):
        raise ValueError(f"map_gather: 4- or 8-byte words, got "
                         f"{table.dtype}")
    out = torch.empty(idx.shape, dtype=table.dtype, device=table.device)
    if idx.numel() == 0:
        return out
    err = cuda_build.lib().sba_map_gather(
        word, idx.numel(), per, hw, table.data_ptr(), idx.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream)
    cuda_build.check(err, "sba_map_gather")
    LAUNCHES["map_gather"] += 1
    return out


def map_gather_pair(table, idx, per: int = 0, hw: int = 0,
                    summed: bool = False):
    """Both words of ``table.reshape(-1, 2)[base(k) + idx[k]]``:
    ``[*idx.shape, 2]``, or their u32 sum ``[*idx.shape]`` (int32 bits)
    when `summed`. The table holds 4-byte words (int32)."""
    if not table.is_cuda:
        return map_gather_pair_plain(table, idx, per, hw, summed)
    _check(table, idx, "map_gather_pair")
    if table.dtype != torch.int32 or table.numel() % 2 \
            or table.data_ptr() % 8:
        raise ValueError("map_gather_pair: table must be int32 [K, 2], "
                         "8-byte aligned")
    shape = tuple(idx.shape) if summed else (*idx.shape, 2)
    out = torch.empty(shape, dtype=torch.int32, device=table.device)
    if idx.numel() == 0:
        return out
    err = cuda_build.lib().sba_map_gather_pair(
        idx.numel(), per, hw, int(summed), table.data_ptr(),
        idx.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    cuda_build.check(err, "sba_map_gather_pair")
    LAUNCHES["map_gather_pair"] += 1
    return out


# ---------------------------------------------------------------------------
# The probes' own entries, one per TPU kernel, on their tables and index
# layouts (u32 words as int32). Each returns the kernel's output, before
# the probe's `.max()`.
# ---------------------------------------------------------------------------

def probe_flat(tab, il):
    """B1 (`f4`): tab [maps * HW], il [maps, per] local -> [maps, per]."""
    return map_gather(tab, il, il.shape[-1], tab.numel() // il.shape[0])


def probe_rows(tab, il):
    """B2 (`f4b`): tab [maps * HW / 128, 128], il [maps, per] local."""
    return map_gather(tab, il, il.shape[-1], tab.numel() // il.shape[0])


def probe_pair(tab, il):
    """B3 (`fD`): tab [maps, HW / 64, 128], depth and label words
    interleaved per pixel; il [maps, 8, per / 8] local -> the u32 sum of
    each sample's two words."""
    per = il[0].numel()
    return map_gather_pair(tab, il, per, tab[0].numel() // 2, summed=True)


def probe_take(tab, il):
    """B4 (`fE`): tab [maps, HW / 128, 128], il [maps, 8, per / 8]."""
    return map_gather(tab, il, il[0].numel(), tab[0].numel())
