"""K3's block windows (`sba_tpu_torch.ops.ba_kernels.schur_matvec_windows`)
on the CPU.

The CUDA matvec sums each block's scatter in shared memory over the image
window of its live lanes, in chunks of K3_WINDOW images. The helper
reports those windows; these tests hold it to the kernel's block shape
and to the lanes it must cover, on the sequential scene's sorted point
order (narrow windows) and with its image ids permuted (wide ones).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sba_tpu_torch.ops import ba_kernels as bk
from sba_tpu_torch.optim import ba_fused
from sba_tpu_torch.optim.ba import BAOptions, problem_from_numpy
from sba_tpu_torch.utils.synthetic import (make_sequential_ba_problem_numpy,
                                           spread_image_ids)

torch.set_num_threads(1)

CSRC = Path(bk.__file__).resolve().parent.parent / "csrc" / "ba_kernels.cuh"


def _bucket(order):
    f, _ = make_sequential_ba_problem_numpy(
        num_images=600, num_points=3000, track_len=7, seed=3)
    problem = problem_from_numpy(f, "cpu", torch.float32)
    opt = BAOptions(dtype="float32", fused_mode="implicit")
    statics, lays, _, _, _, _, _ = ba_fused.prepare(problem, opt)
    st, lay = statics[0], lays[0]
    perm = None
    if order == "permuted":
        perm = torch.as_tensor(spread_image_ids(lay.N))
        st = st._replace(obs_img=perm[st.obs_img.long()].contiguous())
    return st, lay, opt, perm


def test_spread_image_ids_is_a_wide_permutation():
    for n in (1, 2, 7, 600, 1024, 10_240):
        ids = spread_image_ids(n)
        assert ids.dtype == np.int32 and sorted(ids) == list(range(n))
    ids = spread_image_ids(1024).astype(np.int64)
    # Neighbouring images land more than a window chunk apart.
    assert np.abs(np.diff(ids)).min() > bk.K3_WINDOW


def test_block_shape_matches_cuda_source():
    src = CSRC.read_text()
    for name, value in (("kK3Points", bk.K3_POINTS_PER_BLOCK),
                        ("kK3Window", bk.K3_WINDOW)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name


@pytest.mark.parametrize("order", ["sorted", "permuted"])
def test_windows_cover_every_live_lane(order):
    st, lay, _, _ = _bucket(order)
    lo, hi, chunks = bk.schur_matvec_windows(st, lay)
    groups = -(-lay.TP // bk.K3_POINTS_PER_BLOCK)
    assert lo.shape == hi.shape == chunks.shape == (lay.nb * groups,)

    lane = np.arange(lay.Pp * lay.K)
    b, p = lane // (lay.TP * lay.K), lane % lay.TP
    block = b * groups + p // bk.K3_POINTS_PER_BLOCK
    live = st.obs_sta[2].numpy() != 0
    img = st.obs_img.numpy()
    lo, hi, chunks = lo.numpy(), hi.numpy(), chunks.numpy()
    assert live.sum() > 0
    assert np.all(lo[block[live]] <= img[live])
    assert np.all(img[live] <= hi[block[live]])
    # The window is tight: its ends are live images of the block.
    for k in np.unique(block[live]):
        sel = live & (block == k)
        assert lo[k] == img[sel].min() and hi[k] == img[sel].max()
    has = np.isin(np.arange(len(lo)), block[live])
    assert np.all(chunks[has] == -(-(hi[has] - lo[has] + 1) // bk.K3_WINDOW))
    assert np.all(chunks[~has] == 0) and np.all(hi[~has] == -1)
    if order == "sorted":
        # Points sorted by mean observing image: ~10-image windows.
        assert chunks[has].max() == 1 and (hi - lo)[has].max() < 40
    else:
        assert np.all(chunks[has] > 1)


def test_twin_commutes_with_image_permutation():
    """The permuted bucket is the same product with renamed images: the
    twin's rows follow the permutation (the card test's second order is
    a faithful input)."""
    st, lay, opt, _ = _bucket("sorted")
    stp, _, _, perm = _bucket("permuted")
    gen = torch.Generator().manual_seed(1)
    jc = 1e-2 * torch.randn(lay.JC, lay.Pp * lay.K, generator=gen)
    dup = torch.zeros(6, lay.Npad)
    dup[:, :lay.N] = torch.randn(6, lay.N, generator=gen)
    duc = torch.zeros(12, lay.C)
    duc[:lay.nparams] = torch.randn(lay.nparams, lay.C, generator=gen)
    dup_p = dup.clone()
    dup_p[:, perm.long()] = dup[:, :lay.N]
    out = bk.schur_matvec(st, dup, duc, jc, lay, opt)
    out_p = bk.schur_matvec(stp, dup_p, duc, jc, lay, opt)
    torch.testing.assert_close(out_p[perm.long()], out[:lay.N], rtol=0,
                               atol=1e-6 * float(out.abs().max()))
