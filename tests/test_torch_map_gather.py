"""The map-gather twins of the port against the four Pallas gather probes
B1-B4 of sba_tpu's benchmarks (interpret mode on the CPU).

The probes are closures inside `main()` of ``benchmarks/gather_micro.py``
(f4, f4b) and ``benchmarks/gather_micro2.py`` (fD, fE); each test here
rebuilds its probe's `pl.pallas_call` with the probe's kernel body, at a
small shape (3 maps of 1,024 words, 64 samples per map), and holds the
port's probe entry (`sba_tpu_torch.ops.map_gather.probe_*`, the plain
twins on CPU tensors) to its output bit for bit: a gather is exact.
B1's kernel also runs at odd lengths (1 to 5 and 4097 samples, one or
more per map), on an index view offset by one element and on 8-byte
words; tests/test_torch_cuda.py holds the CUDA kernel to the twin at the
same cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sba_tpu_torch.ops import map_gather as mg

torch.set_num_threads(2)

HW = 1024        # one map: 8 rows of 128 lanes
NMAPS = 3
PER = 64         # samples per map


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, 2 ** 32, size=NMAPS * HW,
                         dtype=np.uint64).astype(np.uint32)
    label = rng.integers(0, 2 ** 32, size=NMAPS * HW,
                         dtype=np.uint64).astype(np.uint32)
    il = rng.integers(0, HW, size=(NMAPS, PER), dtype=np.int64).astype(
        np.int32)
    return depth, label, il


def _words(u32):
    """u32 numpy words -> the port's int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


def _b1_f4(tab, il):
    """benchmarks/gather_micro.py::f4 with its kernel `kern`."""
    per = il.shape[1]

    def kern(tab_ref, idx_ref, out_ref):
        t = tab_ref[:]
        i = idx_ref[:]
        out_ref[:] = jnp.take(t, i)

    return pl.pallas_call(
        kern, grid=(NMAPS,),
        in_specs=[_vmem((HW,), lambda m: (m,)),
                  _vmem((1, per), lambda m: (m, 0))],
        out_specs=_vmem((1, per), lambda m: (m, 0)),
        out_shape=jax.ShapeDtypeStruct((NMAPS, per), jnp.uint32),
        interpret=True)(tab.reshape(NMAPS * HW), il)


def _b2_f4b(tab, il):
    """benchmarks/gather_micro.py::f4b with its kernel `kern4b`."""
    per = il.shape[1]

    def kern4b(tab_ref, idx_ref, out_ref):
        t = tab_ref[:]
        i = idx_ref[:]
        rows = jnp.take(t, i[0] // 128, axis=0)
        out_ref[0] = jnp.take_along_axis(
            rows, (i[0] % 128)[:, None], axis=1)[:, 0]

    return pl.pallas_call(
        kern4b, grid=(NMAPS,),
        in_specs=[_vmem((HW // 128, 128), lambda m: (m, 0)),
                  _vmem((1, per), lambda m: (m, 0))],
        out_specs=_vmem((1, per), lambda m: (m, 0)),
        out_shape=jax.ShapeDtypeStruct((NMAPS, per), jnp.uint32),
        interpret=True)(tab.reshape(NMAPS * HW // 128, 128), il)


def _b3_fD(inter3, il3):
    """benchmarks/gather_micro2.py::fD with its kernel `kernD`."""
    per = il3.shape[1] * il3.shape[2]

    def kernD(tab_ref, idx_ref, out_ref):
        t = tab_ref[0]
        i = idx_ref[0].reshape(-1)
        rows = jnp.take(t, i // 64, axis=0)
        lane = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1)
        tgt = 2 * (i % 64)
        d = jnp.where(lane == tgt[:, None], rows, 0).sum(1)
        lab = jnp.where(lane == tgt[:, None] + 1, rows, 0).sum(1)
        out_ref[0] = (d + lab).reshape(8, per // 8)

    return pl.pallas_call(
        kernD, grid=(NMAPS,),
        in_specs=[_vmem((1, HW // 64, 128), lambda m: (m, 0, 0)),
                  _vmem((1, 8, per // 8), lambda m: (m, 0, 0))],
        out_specs=_vmem((1, 8, per // 8), lambda m: (m, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((NMAPS, 8, per // 8), jnp.uint32),
        interpret=True)(inter3, il3)


def _b4_fE(dep3, il3):
    """benchmarks/gather_micro2.py::fE with its kernel `kernE`."""
    per = il3.shape[1] * il3.shape[2]

    def kernE(tab_ref, idx_ref, out_ref):
        t = tab_ref[0].reshape(-1)
        i = idx_ref[0].reshape(-1)
        out_ref[0] = jnp.take(t, i).reshape(8, per // 8)

    return pl.pallas_call(
        kernE, grid=(NMAPS,),
        in_specs=[_vmem((1, HW // 128, 128), lambda m: (m, 0, 0)),
                  _vmem((1, 8, per // 8), lambda m: (m, 0, 0))],
        out_specs=_vmem((1, 8, per // 8), lambda m: (m, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((NMAPS, 8, per // 8), jnp.uint32),
        interpret=True)(dep3, il3)


# Odd lengths n as (maps, samples per map); tests/test_torch_cuda.py holds
# the kernel at the same.
ODD_LENGTHS = {1: (1, 1), 3: (3, 1), 4: (2, 2), 5: (5, 1), 4097: (17, 241)}


def _flat_take_probe(tab, il, hw):
    """B1's kernel `kern` (benchmarks/gather_micro.py::f4) over il.shape[0]
    maps of hw words of any dtype: one grid step per map."""
    maps, per = il.shape

    def kern(tab_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take(tab_ref[:], idx_ref[:])

    return pl.pallas_call(
        kern, grid=(maps,),
        in_specs=[_vmem((hw,), lambda m: (m,)),
                  _vmem((1, per), lambda m: (m, 0))],
        out_specs=_vmem((1, per), lambda m: (m, 0)),
        out_shape=jax.ShapeDtypeStruct((maps, per), tab.dtype),
        interpret=True)(tab, il)


@pytest.mark.parametrize("word", ["u32", "f64"])
@pytest.mark.parametrize("n", sorted(ODD_LENGTHS))
def test_twin_matches_probe_at_odd_lengths_and_offset_views(n, word):
    """Both forms of map_gather_plain on an int32 index view that starts
    one element into its storage, against B1's kernel, bit for bit."""
    maps, per = ODD_LENGTHS[n]
    rng = np.random.default_rng(n)
    if word == "u32":
        tab = rng.integers(0, 2 ** 32, size=maps * HW,
                           dtype=np.uint64).astype(np.uint32)
        tab_t = _words(tab)
    else:
        tab = rng.normal(size=maps * HW)
        tab_t = torch.from_numpy(tab)
    il = rng.integers(0, HW, size=n + 1).astype(np.int32)
    ref = np.asarray(_flat_take_probe(jnp.asarray(tab),
                                      jnp.asarray(il[1:].reshape(maps, per)),
                                      HW))
    local = torch.from_numpy(il)[1:].view(maps, per)
    glob = (torch.from_numpy(il).long()[1:].view(maps, per)
            + HW * torch.arange(maps)[:, None]).int()
    glob = torch.cat([glob.new_zeros(1), glob.reshape(-1)])[1:]
    assert local.storage_offset() == 1 and glob.storage_offset() == 1
    for got in (mg.map_gather(tab_t, local, per, HW),
                mg.map_gather(tab_t, glob).view(maps, per)):
        assert got.dtype == tab_t.dtype and tuple(got.shape) == (maps, per)
        if word == "u32":
            np.testing.assert_array_equal(_u32(got), ref)
        else:
            np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("probe", ["B1", "B2", "B3", "B4"])
def test_twin_matches_probe_bit_for_bit(probe):
    depth, label, il = _inputs()
    il3 = il.reshape(NMAPS, 8, PER // 8)
    if probe == "B1":
        ref = _b1_f4(jnp.asarray(depth), jnp.asarray(il))
        got = mg.probe_flat(_words(depth), torch.from_numpy(il))
    elif probe == "B2":
        ref = _b2_f4b(jnp.asarray(depth), jnp.asarray(il))
        got = mg.probe_rows(_words(depth).view(-1, 128),
                            torch.from_numpy(il))
    elif probe == "B3":
        inter = np.stack([depth, label], -1).reshape(NMAPS, HW // 64, 128)
        ref = _b3_fD(jnp.asarray(inter), jnp.asarray(il3))
        got = mg.probe_pair(_words(inter), torch.from_numpy(il3))
    else:
        dep3 = depth.reshape(NMAPS, HW // 128, 128)
        ref = _b4_fE(jnp.asarray(dep3), jnp.asarray(il3))
        got = mg.probe_take(_words(dep3), torch.from_numpy(il3))
    ref = np.asarray(ref)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(_u32(got), ref)
    # The probe's own epilogue: the u32 maximum over all samples.
    assert _u32(got).max() == ref.max()


def test_flat_and_probe_forms_agree():
    """The path's flat-index form (per = 0) on global indices gives the
    probes' form on local ones, in 4- and 8-byte words."""
    depth, label, il = _inputs(1)
    gi = (il + HW * np.arange(NMAPS)[:, None]).astype(np.int32)
    tab = _words(depth)
    np.testing.assert_array_equal(
        mg.map_gather(tab, torch.from_numpy(gi)).numpy(),
        mg.map_gather(tab, torch.from_numpy(il), PER, HW).numpy())
    f64 = torch.from_numpy(np.random.default_rng(2).normal(
        size=NMAPS * HW))
    got = mg.map_gather(f64, torch.from_numpy(gi))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), f64.numpy()[gi])


def test_pair_gather_returns_both_words_and_wrapping_sum():
    depth, label, il = _inputs(3)
    gi = torch.from_numpy((il + HW * np.arange(NMAPS)[:, None]).astype(
        np.int32))
    inter = _words(np.stack([depth, label], -1))
    both = mg.map_gather_pair(inter, gi)
    assert tuple(both.shape) == (NMAPS, PER, 2)
    np.testing.assert_array_equal(_u32(both[..., 0]), depth[gi.numpy()])
    np.testing.assert_array_equal(_u32(both[..., 1]), label[gi.numpy()])
    s = mg.map_gather_pair(inter, gi, summed=True)
    np.testing.assert_array_equal(
        _u32(s), (depth[gi.numpy()].astype(np.uint64)
                  + label[gi.numpy()]).astype(np.uint32))


def test_cpu_wrappers_count_no_launch_and_twins_raise_out_of_range():
    depth, _, il = _inputs()
    mg.reset_launches()
    mg.map_gather(_words(depth), torch.from_numpy(il), PER, HW)
    mg.map_gather_pair(_words(np.stack([depth, depth], -1)),
                       torch.from_numpy(il), PER, HW)
    assert mg.LAUNCHES == {"map_gather": 0, "map_gather_pair": 0}
    with pytest.raises(IndexError):
        mg.map_gather(_words(depth),
                      torch.tensor([NMAPS * HW], dtype=torch.int32))
