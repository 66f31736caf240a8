"""K1's Schur work list and K1/K2's payload windows on the CPU.

The CUDA K1 computes S_corr = EL EL^T from a work list built once per
solve (`sba_tpu_torch.ops.ba_kernels.build_schur_tiles`): one item per
(point, node, node') pair, node <= node', where a point's nodes are its
distinct images and cameras. K1's and K2's linearize-and-reduce kernel
sums each block's image payload in shared memory over the image window
of its live lanes (`fused_reduce_windows`). The kernels run only on the
card; these tests hold the host-side tables and the block shape mirrored
from the CUDA source to what the kernels assume.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sba_tpu_torch.ops import ba_kernels as bk
from sba_tpu_torch.optim import ba_fused
from sba_tpu_torch.optim.ba import BAOptions, problem_from_numpy
from sba_tpu_torch.utils.synthetic import (make_ba_problem_numpy,
                                           make_sequential_ba_problem_numpy,
                                           rename_images, spread_image_ids)

torch.set_num_threads(1)

CSRC = Path(bk.__file__).resolve().parent.parent / "csrc" / "ba_kernels.cu"


def _scene():
    """The headline's random-track layout cut to 16 images and 300 points,
    two cameras, plus: point 0 sees its first image in a second slot, one
    of point 2's lanes is masked, and point 1 is seen by every image (a
    bucket with K = 16 > K12_SLOTS)."""
    f, _ = make_ba_problem_numpy(num_images=16, num_points=300,
                                 observations_per_point=4, pose_noise=0.01,
                                 point_noise=0.05, pixel_noise=0.5, seed=5)
    n = 16
    f["cam_params"] = np.tile(f["cam_params"], (2, 1))
    f["cam_params"][1, 0] = 520.0
    f["image_cam"] = np.arange(n, dtype=np.int32) % 2
    f["free_cam"] = np.ones((2, 12))
    op, oi = f["obs_point"], f["obs_image"]
    first0 = np.nonzero(op == 0)[0][0]
    seen1 = set(oi[op == 1].tolist())
    extra_img = [oi[first0]] + [i for i in range(n) if i not in seen1]
    extra_pt = [0] + [1] * (len(extra_img) - 1)
    xy1 = f["obs_xy"][np.nonzero(op == 1)[0][0]]
    extra_xy = [f["obs_xy"][first0] + 1.5] + [xy1 + 3.0 * k for k in
                                              range(len(extra_img) - 1)]
    f["obs_point"] = np.concatenate([op, extra_pt]).astype(np.int32)
    f["obs_image"] = np.concatenate([oi, extra_img]).astype(np.int32)
    f["obs_xy"] = np.concatenate([f["obs_xy"], extra_xy])
    f["obs_mask"] = np.concatenate([f["obs_mask"], np.ones(len(extra_img))])
    f["obs_mask"][np.nonzero(f["obs_point"] == 2)[0][0]] = 0.0
    f["obs_cam"] = f["image_cam"][f["obs_image"]]
    problem = problem_from_numpy(f, "cpu", torch.float32)
    opt = BAOptions(dtype="float32", fused_mode="dense")
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    return statics, lays, pts0, par


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _unpack(t):
    """The tile table's arrays (see `SchurTiles`), int64."""
    tab = t.table.long()
    sizes = dict(items=2 * t.n_items, pair_node=2 * t.n_pairs,
                 grp_off=t.n_groups + 1, grp_lane=t.n_members,
                 unit_off=t.n_units + 1, unit_pair=t.n_units,
                 pair_unit=t.n_pairs + 1)
    assert tab.numel() == sum(sizes.values())
    out = dict(zip(sizes, torch.split(tab, list(sizes.values()))))
    out["items"] = out["items"].view(-1, 2)
    out["pair_node"] = out["pair_node"].view(-1, 2)
    return out


def _lane_nodes(st, lay):
    """Live lanes, their points and their (image, camera) node ids."""
    live = torch.nonzero(st.obs_sta[2] != 0)[:, 0]
    point = (live // (lay.TP * lay.K)) * lay.TP + live % lay.TP
    return (live, point, st.obs_img.long()[live],
            lay.Npad + st.obs_cam.long()[live])


def test_scene_has_the_edge_cases(scene):
    statics, lays, _, _ = scene
    assert len(lays) == 3 and max(lay.K for lay in lays) > bk.K12_SLOTS
    dup = masked = False
    for st, lay in zip(statics, lays):
        live, point, img, _ = _lane_nodes(st, lay)
        key = point * lay.Npad + img
        dup |= len(torch.unique(key)) < len(key)
        # A masked observation (padding lanes carry x = 0).
        masked |= bool(((st.obs_sta[2] == 0) & (st.obs_sta[0] != 0)).any())
    assert dup and masked


@pytest.mark.parametrize("bucket", [0, 1, 2])
def test_items_cover_each_point_node_pair_once(scene, bucket):
    statics, lays, _, _ = scene
    st, lay = statics[bucket], lays[bucket]
    t = bk.build_schur_tiles(st, lay)
    u = _unpack(t)
    live, point, img, cam = _lane_nodes(st, lay)

    # Groups: every live lane in one image group and one camera group;
    # a group's lanes share its point and node and come in slot order.
    sizes = u["grp_off"].diff()
    assert int(sizes.min()) > 0 and t.n_members == 2 * len(live)
    gid = torch.repeat_interleave(torch.arange(t.n_groups), sizes)
    lanes = u["grp_lane"]
    pos = torch.searchsorted(live, lanes)
    assert torch.equal(live[pos], lanes)
    is_img = gid < t.n_img_groups
    node = torch.where(is_img, img[pos], cam[pos])
    g_point = torch.full((t.n_groups,), -1, dtype=torch.long)
    g_point[gid] = point[pos]
    g_node = torch.full((t.n_groups,), -1, dtype=torch.long)
    g_node[gid] = node
    assert torch.equal(g_point[gid], point[pos])
    assert torch.equal(g_node[gid], node)
    assert bool((g_node[:t.n_img_groups] < lay.Npad).all())
    assert bool((g_node[t.n_img_groups:] >= lay.Npad).all())
    for kind in (is_img, ~is_img):
        assert sorted(lanes[kind].tolist()) == live.tolist()
    assert bool((lanes[1:] > lanes[:-1])[gid[1:] == gid[:-1]].all())
    first = lanes[u["grp_off"][:-1]]
    for a, b in ((0, t.n_img_groups), (t.n_img_groups, t.n_groups)):
        assert bool((first[a + 1:b] > first[a:b - 1]).all())

    # Items: one per (point, node <= node') pair, under its node pair.
    expect = set()
    for p in torch.unique(point).tolist():
        nodes = sorted(set(img[point == p].tolist())
                       | set(cam[point == p].tolist()))
        expect |= {(p, a, b) for i, a in enumerate(nodes) for b in nodes[i:]}
    ga, gb = u["items"].T
    assert torch.equal(g_point[ga], g_point[gb])
    got = list(zip(g_point[ga].tolist(), g_node[ga].tolist(),
                   g_node[gb].tolist()))
    assert len(got) == len(set(got)) == t.n_items
    assert set(got) == expect

    # Units: at most K1B_UNIT_ITEMS items of one pair, in pair order.
    usize = u["unit_off"].diff()
    assert int(usize.min()) > 0 and int(usize.max()) <= bk.K1B_UNIT_ITEMS
    assert int(u["unit_off"][0]) == 0 and int(u["unit_off"][-1]) == t.n_items
    assert torch.equal(u["pair_unit"].diff(),
                       torch.bincount(u["unit_pair"], minlength=t.n_pairs))
    item_pair = torch.repeat_interleave(u["unit_pair"], usize)
    assert torch.equal(u["pair_node"][item_pair][:, 0], g_node[ga])
    assert torch.equal(u["pair_node"][item_pair][:, 1], g_node[gb])
    pn = u["pair_node"]
    key = pn[:, 0] * (lay.Npad + lay.C) + pn[:, 1]
    assert bool((key[1:] > key[:-1]).all()) and bool((pn[:, 0] <= pn[:, 1])
                                                     .all())


def _s_from_tiles(t, jw, lay, bf16):
    """S_corr assembled in float64 from the work list: each group's block
    is the sum of its lanes' WL rows of `jw` (in lane order, rounded to
    bfloat16 when `bf16`), each item adds its two blocks' product to its
    node pair's rows and, off the diagonal, the mirror."""
    u = _unpack(t)
    NP, Npad, C = lay.nparams, lay.Npad, lay.C
    o = 18 + 2 * NP
    gid = torch.repeat_interleave(torch.arange(t.n_groups),
                                  u["grp_off"].diff())
    lanes = u["grp_lane"]
    wl = torch.where((gid < t.n_img_groups)[:, None],
                     jw[o:o + 18][:, lanes].T,
                     F.pad(jw[o + 18:o + 18 + 3 * NP][:, lanes].T,
                           (0, 18 - 3 * NP)))
    blocks = torch.zeros(t.n_groups, 18).index_add_(0, gid, wl)
    if bf16:
        blocks = blocks.to(torch.bfloat16).float()
    blocks = blocks.double().view(-1, 6, 3)
    ga, gb = u["items"].T
    prod = blocks[ga] @ blocks[gb].transpose(1, 2)             # [I, 6, 6]
    item_pair = torch.repeat_interleave(u["unit_pair"], u["unit_off"].diff())
    na, nb = u["pair_node"][item_pair].T
    i6 = torch.arange(6)

    def rows(node):
        c = node >= Npad
        r = torch.where(c[:, None], 6 * Npad + i6 * C + (node - Npad)[:, None],
                        i6 * Npad + node[:, None])
        return r, torch.where(c[:, None], i6 < NP,
                              torch.ones_like(r, dtype=bool))

    ra, va = rows(na)
    rb, vb = rows(nb)
    r = ra[:, :, None].expand(-1, 6, 6)
    c = rb[:, None, :].expand(-1, 6, 6)
    valid = va[:, :, None] & vb[:, None, :]
    S = torch.zeros(lay.Dk, lay.Dk, dtype=torch.float64)
    S.index_put_((r[valid], c[valid]), prod[valid], accumulate=True)
    off = valid & (na != nb)[:, None, None]
    S.index_put_((c[off], r[off]), prod[off], accumulate=True)
    return S


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_s_from_tiles_matches_twin(scene, bf16):
    statics, lays, pts0, par = scene
    opt = BAOptions(dtype="float32", schur_bf16=bf16)
    lam = torch.tensor(1e-3)
    for st, lay, pts in zip(statics, lays, pts0):
        S, _, _, _, jw = bk.fused_schur_plain(st, par, pts, lam, lay, opt)
        got = _s_from_tiles(bk.build_schur_tiles(st, lay), jw, lay, bf16)
        np.testing.assert_allclose(got.numpy(), S.double().numpy(), rtol=0,
                                   atol=1e-6 * float(S.abs().max()))


def _sequential(order):
    f, _ = make_sequential_ba_problem_numpy(
        num_images=600, num_points=3000, track_len=7, seed=3)
    problem = problem_from_numpy(f, "cpu", torch.float32)
    opt = BAOptions(dtype="float32", fused_mode="implicit")
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    st, lay, pts = statics[0], lays[0], pts0[0]
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         st.image_cam, lay)
    perm = torch.as_tensor(spread_image_ids(lay.N))
    if order == "spread":
        st, par = rename_images(st, par, perm)
    return st, lay, pts, par, opt, perm


@pytest.mark.parametrize("order", ["sorted", "spread"])
def test_payload_windows_cover_every_live_lane(order):
    st, lay, _, _, _, _ = _sequential(order)
    lo, hi, chunks = bk.fused_reduce_windows(st, lay)
    groups = -(-lay.TP // bk.K12_POINTS_PER_BLOCK)
    assert lo.shape == hi.shape == chunks.shape == (lay.nb * groups,)
    lane = np.arange(lay.Pp * lay.K)
    b, p = lane // (lay.TP * lay.K), lane % lay.TP
    block = b * groups + p // bk.K12_POINTS_PER_BLOCK
    live = st.obs_sta[2].numpy() != 0
    img = st.obs_img.numpy()
    lo, hi, chunks = lo.numpy(), hi.numpy(), chunks.numpy()
    assert np.all(lo[block[live]] <= img[live])
    assert np.all(img[live] <= hi[block[live]])
    for k in np.unique(block[live]):
        sel = live & (block == k)
        assert lo[k] == img[sel].min() and hi[k] == img[sel].max()
    has = np.isin(np.arange(len(lo)), block[live])
    assert np.all(chunks[has] == -(-(hi[has] - lo[has] + 1) // bk.K12_WINDOW))
    assert np.all(chunks[~has] == 0)
    if order == "sorted":
        assert chunks[has].max() == 1
    else:
        assert np.all(chunks[has] > 1)


def test_k2_twin_commutes_with_rename_images():
    """The spread bucket is the same function with renamed images: the
    twin's image rows follow the permutation and the rest is unchanged
    (the card's spread-id check is a faithful input)."""
    st, lay, pts, par, opt, perm = _sequential("sorted")
    sts, _, _, pars, _, _ = _sequential("spread")
    lam = torch.tensor(1e-3)
    out = bk.fused_reduce_plain(st, par, pts, lam, lay, opt)
    out_s = bk.fused_reduce_plain(sts, pars, pts, lam, lay, opt)
    torch.testing.assert_close(out_s[0][perm.long()], out[0][:lay.N])
    for a, b in zip(out[1:], out_s[1:]):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("name,value", [
    ("kK12Points", bk.K12_POINTS_PER_BLOCK), ("kK12Slots", bk.K12_SLOTS),
    ("kK12Window", bk.K12_WINDOW), ("kK1bUnit", bk.K1B_UNIT_ITEMS),
    ("kK1bGroupWords", bk.K1B_GROUP_WORDS), ("kK1bEntries", bk.K1B_ENTRIES)])
def test_block_shape_matches_cuda_source(name, value):
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m is not None and int(m.group(1)) == value, name
