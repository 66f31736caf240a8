"""The bundle-adjustment LM kernels: CUDA wrappers and their plain twins.

Port of the five kernels of ``sba_tpu/ops/ba_kernels.py``: K1
`fused_schur` (dense path), K2 `fused_reduce` and K3 `schur_matvec`
(implicit path), K4 `backsub` and K5 `fused_cost` (one bucket) /
`fused_cost_buckets` (all buckets of a cost evaluation in one launch).
Each wrapper launches the hand-written kernel of ``csrc/ba_kernels.cuh``
when its tensors are on CUDA, and runs the plain PyTorch twin beside it
only when they lie on the CPU. The twins repeat the kernels' arithmetic
on whole lane arrays, camera heads included: sba_tpu's analytic heads
for all 11 camera models (`_head`; K5's twin projects through
``geometry.camera_models``).

Layout (the TPU kernel's, kept so that outputs compare entry by entry):
observations are point-major and slot-major within a block of TP points:
lane ``c = b*TP*K + s*TP + p_local`` holds slot s of point b*TP+p_local.
Per-lane data is stored as ``[field, lane]`` rows.

- ``par`` [7+np, Npad]: q(4), t(3), intrinsics(np) per image.
- ``jw`` [JW, O']: Jc(12) | Jx(6) | Jk(2np) | WLp(18) | WLc(3np) per lane.
- ``jcorr`` [18+3np, O']: WLp(18) | WLc(3np), the implicit matvec's
  couplings: a view of jw's WL rows in float32, or their bfloat16 copy
  when `matvec_bf16` and `ranged`. (The reference stores JCW rows, the
  couplings padded with zero rows to its 16-row tile, in both types.)
- ``pt_pay`` [19, Pp]: g_p(3) | diag Hpp(3) | Hpp^-1(6) | Lp(6) | free(1).
- ``img_red`` [Npad, DI]: g_pose(6) | Hcc_pose(36) | Hpc(6np) | g_cam(np)
  | Hcc_cam(np^2) per image; the implicit path's [Npad, DI_implicit]
  adds ey_pose(6) | ey_cam(np) | the pose block of EL EL^T (21 upper
  triangle rows when BJ, else its diagonal, 6) | its camera diagonal(np).
  The camera rows are keyed by image; the epilogue sums them by camera.
- ``S`` [Dk, Dk] / ``ey`` [Dk]: reduced rows ``i*Npad + n`` (pose i of
  image n) and ``6*Npad + m*C + c`` (intrinsic m of camera c).

"Ranged" (Npad >= RANGED_MIN_NPAD, or forced by `fused_ranged`) is an
indexing scheme of the TPU kernels: their per-block image-sub-block loops
stand in for a one-hot contraction that no longer fits VMEM. The CUDA
kernels gather and scatter by index at every size, so the port keeps the
flag for its two effects on the numbers only: `jcorr` is bfloat16 iff
`matvec_bf16 and ranged`, and a ranged layout forces the implicit solve.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.ops import cuda_build
from sba_tpu_torch.optim.losses import LOSS_IDS, loss_value, loss_weight

PT_ROWS = 19
CUDA_MODELS = tuple(range(11))   # camera heads the CUDA kernels implement

# The ranged regime starts here (see the module docstring).
RANGED_MIN_NPAD = 2048

# K3's block shape in csrc/ba_kernels.cuh: points per block (kK3Points)
# and images per shared-memory window chunk (kK3Window).
K3_POINTS_PER_BLOCK = 64
K3_WINDOW = 256
# The block shape of K1's and K2's linearize-and-reduce kernel
# (kK12Points, kK12Slots, kK12Window): points per block, slots per pass,
# images per shared-memory window chunk.
K12_POINTS_PER_BLOCK = 64
K12_SLOTS = 8
K12_WINDOW = 128
# K1's Schur-correction kernels (csrc/ba_kernels.cuh kK1bUnit,
# kK1bGroupWords, kK1bEntries): work items per unit, and the floats per
# merged group block and per unit partial block while the model has at
# most 6 parameters; `k1b_group_words` and `k1b_entries` give them for
# any parameter count.
K1B_UNIT_ITEMS = 128
K1B_GROUP_WORDS = 20
K1B_ENTRIES = 36

# K5's buckets per launch (csrc kK5MaxBuckets).
K5_MAX_BUCKETS = 3

# Launch counts of the CUDA kernels (a wrapper adds one per launch).
LAUNCHES = {"fused_schur": 0, "fused_reduce": 0, "schur_matvec": 0,
            "backsub": 0, "fused_cost": 0}


def k1b_group_words(nparams: int) -> int:
    """Floats per merged group block of K1b: a 6x3 or NPx3 block of EL,
    padded to a multiple of 4 (csrc k1b_group_words)."""
    return _round_up(3 * nparams, 4) if nparams > 6 else K1B_GROUP_WORDS


def k1b_entries(nparams: int) -> int:
    """Floats per unit partial block of K1b: the largest of a 6x6, 6xNP
    and NPxNP node-pair block (csrc k1b_entries)."""
    return nparams * nparams if nparams > 6 else K1B_ENTRIES


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x, m):
    return (x + m - 1) // m * m


class KernelLayout(NamedTuple):
    TP: int        # points per block
    K: int         # slots (max track length of the bucket)
    nb: int        # number of blocks
    Pp: int        # padded point count (nb * TP)
    N: int         # real images
    Npad: int      # padded images (multiple of 128)
    C: int         # cameras
    nparams: int   # camera model parameter count
    Dk: int        # reduced dim: 6*Npad + round_up(12*C, 128)
    DI: int        # image payload columns (dense path)
    JW: int        # stored per-lane rows
    ranged: bool   # bf16 jcorr (with matvec_bf16) and implicit solve
    BJ: bool       # implicit payload carries the 6x6 pose block (else
    #                its diagonal): block- vs scalar-Jacobi PCG
    JCW: int       # the reference's jcorr rows (18 + 3np padded to 16);
    #                the port's jcorr has JC = 18 + 3np rows

    @property
    def JC(self) -> int:
        """Coupling rows WLp | WLc of `jw` and `jcorr`."""
        return 18 + 3 * self.nparams

    @property
    def DI_implicit(self) -> int:
        """Image payload columns of the implicit path."""
        return (self.DI + 6 + 2 * self.nparams
                + (21 if self.BJ else 6))


class SchurTiles(NamedTuple):
    """K1's Schur-correction work list (`build_schur_tiles`): one int32
    `table` on the kernels' device, the concatenation of

    - items [n_items, 2]: the group pair (a, b) of each work item, by
      node pair, within a pair by point;
    - pair_node [n_pairs, 2]: the pair's node ids (image n, or camera c
      as Npad + c), a <= b;
    - grp_off [n_groups + 1], grp_lane [n_members]: each group's live
      lanes in slot order; groups [0, n_img_groups) are (point, image)
      groups, the rest (point, camera) groups;
    - unit_off [n_units + 1]: each unit's items (at most K1B_UNIT_ITEMS
      of one pair); unit_pair [n_units]: its pair;
    - pair_unit [n_pairs + 1]: each pair's units.
    """

    table: torch.Tensor
    n_groups: int
    n_img_groups: int
    n_members: int
    n_units: int
    n_pairs: int
    n_items: int


class KernelStatic(NamedTuple):
    """Per-solve device tensors in kernel (slot-major) order. `tiles` is
    the dense path's Schur work list, built from obs_img, obs_cam and the
    mask (rebuild it after replacing them); the CUDA K1 needs it."""

    obs_sta: torch.Tensor   # [3, O'] f32: x, y, mask
    obs_img: torch.Tensor   # [O'] i32
    obs_cam: torch.Tensor   # [O'] i32
    free_sta: torch.Tensor  # [4+np, Npad] f32: rot(1), trans(3), cam(np)
    free_pts: torch.Tensor  # [Pp] f32
    image_cam: torch.Tensor  # [Npad] i32
    tiles: SchurTiles | None = None


def intrinsic_refine_mask(opt) -> np.ndarray:
    """[12] multiplier from the refine_{focal,principal,extra} flags."""
    spec = camera_models.model_by_id(opt.model_id)
    m = np.zeros(camera_models.MAX_NUM_PARAMS)
    if opt.refine_focal_length:
        m[list(spec.focal_idxs)] = 1.0
    if opt.refine_principal_point:
        m[list(spec.principal_idxs)] = 1.0
    if opt.refine_extra_params:
        m[list(spec.extra_idxs)] = 1.0
    return m


def plan_layout(problem, opt, TP: int = 128) -> KernelLayout:
    """Layout of a point-major problem (obs row = p*K + s), given as a
    mapping of `BAProblem` field names to arrays."""
    P = problem["points"].shape[0]
    K = problem["obs_image"].shape[0] // P
    N = problem["qvecs"].shape[0]
    C = problem["cam_params"].shape[0]
    nparams = camera_models.model_by_id(opt.model_id).num_params
    Pp = _round_up(P, TP)
    Npad = _round_up(N, 128)
    base = 42 + 7 * nparams + nparams * nparams
    mode = opt.fused_ranged
    # BJ: the reference's rule against its 128-padded payload width.
    return KernelLayout(
        TP=TP, K=K, nb=Pp // TP, Pp=Pp, N=N, Npad=Npad, C=C,
        nparams=nparams, Dk=6 * Npad + _round_up(12 * C, 128),
        DI=base, JW=36 + 5 * nparams,
        ranged=mode == "on" or (mode == "auto" and Npad >= RANGED_MIN_NPAD),
        BJ=base + 27 + 2 * nparams <= _round_up(base, 128),
        JCW=_round_up(18 + 3 * nparams, 16))


def jcorr_dtype(lay: KernelLayout, opt):
    """The coupling store's type: bfloat16 iff matvec_bf16 and ranged."""
    return torch.bfloat16 if (opt.matvec_bf16 and lay.ranged) \
        else torch.float32


def build_static(problem, opt, lay: KernelLayout, device) -> KernelStatic:
    """Host-side reorder of a point-major numpy problem (a mapping of
    `BAProblem` fields) into kernel lane order, uploaded to `device`."""
    TP, K, Pp = lay.TP, lay.K, lay.Pp
    P = problem["points"].shape[0]
    Op = Pp * K
    p_of = np.repeat(np.arange(Pp), K).reshape(Pp, K)
    s_of = np.tile(np.arange(K), (Pp, 1))
    lane = (p_of // TP) * (TP * K) + s_of * TP + p_of % TP
    src = p_of * K + s_of
    perm = np.full(Op, -1, np.int64)
    valid = (p_of < P).reshape(-1)
    perm[lane.reshape(-1)[valid]] = src.reshape(-1)[valid]
    m = perm >= 0

    def take(a, dtype):
        a = np.asarray(a, dtype)
        out = np.zeros((Op,) + a.shape[1:], dtype)
        out[m] = a[perm[m]]
        return out

    xy = take(problem["obs_xy"], np.float32)
    obs_sta = np.stack([xy[:, 0], xy[:, 1],
                        take(problem["obs_mask"], np.float32)])
    obs_img = take(problem["obs_image"], np.int32)
    obs_cam = take(problem["obs_cam"], np.int32)

    nparams, N = lay.nparams, lay.N
    free_sta = np.zeros((4 + nparams, lay.Npad), np.float32)
    free_sta[0, :N] = problem["free_rot"]
    free_sta[1:4, :N] = np.asarray(problem["free_trans"]).T
    image_cam = np.zeros(lay.Npad, np.int32)
    image_cam[:N] = problem["image_cam"]
    refine = intrinsic_refine_mask(opt)[:nparams]
    fc = np.asarray(problem["free_cam"], np.float32)[:, :nparams] * refine
    free_sta[4:, :N] = fc[image_cam[:N]].T
    if not opt.refine_extrinsics:
        free_sta[:4] = 0.0
    free_pts = np.zeros(Pp, np.float32)
    free_pts[:P] = problem["free_points"]

    def dev(a):
        return torch.as_tensor(a, device=device)

    return KernelStatic(obs_sta=dev(obs_sta), obs_img=dev(obs_img),
                        obs_cam=dev(obs_cam), free_sta=dev(free_sta),
                        free_pts=dev(free_pts), image_cam=dev(image_cam))


def _block_windows(static: KernelStatic, lay: KernelLayout, points: int,
                   window: int):
    """Image windows of blocks that each cover `points` points of one
    TP-point block (all their slots): [lo, hi], the least and greatest
    image of the block's live lanes, summed in chunks of `window` images.
    Returns (lo, hi, chunks), each [blocks] int64 in block order; a block
    without live lanes has lo = 2^31 - 1, hi = -1 and 0 chunks."""
    TP, K, nb = lay.TP, lay.K, lay.nb
    groups = -(-TP // points)
    pad = groups * points - TP
    img = static.obs_img.long().reshape(nb, K, TP)
    live = static.obs_sta[2].reshape(nb, K, TP) != 0
    big = torch.full_like(img, 2 ** 31 - 1)
    lo = torch.where(live, img, big)
    hi = torch.where(live, img, torch.full_like(img, -1))
    lo = F.pad(lo, (0, pad), value=2 ** 31 - 1)
    hi = F.pad(hi, (0, pad), value=-1)
    shape = (nb, K, groups, points)
    lo = lo.reshape(shape).amin(dim=(1, 3)).reshape(-1)
    hi = hi.reshape(shape).amax(dim=(1, 3)).reshape(-1)
    chunks = torch.clamp(hi - lo + window, min=0) // window
    return lo, hi, chunks


def schur_matvec_windows(static: KernelStatic, lay: KernelLayout):
    """The image windows of K3's blocks (K3_POINTS_PER_BLOCK points,
    chunks of K3_WINDOW images), as `_block_windows` returns them."""
    return _block_windows(static, lay, K3_POINTS_PER_BLOCK, K3_WINDOW)


def fused_reduce_windows(static: KernelStatic, lay: KernelLayout):
    """The image-payload windows of K1's and K2's linearize-and-reduce
    blocks (K12_POINTS_PER_BLOCK points, chunks of K12_WINDOW images),
    as `_block_windows` returns them."""
    return _block_windows(static, lay, K12_POINTS_PER_BLOCK, K12_WINDOW)


def build_schur_tiles(static: KernelStatic, lay: KernelLayout) -> SchurTiles:
    """K1's Schur work list for one bucket, built in torch on the
    bucket's device (see `SchurTiles` and csrc/ba_kernels.cuh, K1b).

    A point's nodes are its distinct images and cameras over its live
    lanes; a group is a (point, node) pair, whose block of EL is the sum
    of the WL blocks of its lanes. S's block of a node pair a <= b sums,
    over the points that see both, the product of their two groups'
    blocks: one work item each. Groups are numbered image groups first,
    each kind by its first lane (so the group kernel's reads of jw
    coalesce); items are sorted by node pair, then by point, and each
    pair's list is cut into units of at most K1B_UNIT_ITEMS items."""
    TP, K, Npad = lay.TP, lay.K, lay.Npad
    NN = Npad + lay.C
    L = static.obs_img.numel()                # lanes; sort keys x * L + lane
    live = torch.nonzero(static.obs_sta[2] != 0)[:, 0]
    point = (live // (TP * K)) * TP + live % TP
    node = torch.cat([static.obs_img.long()[live],
                      Npad + static.obs_cam.long()[live]])
    lanes = torch.cat([live, live])
    key = torch.cat([point, point]) * NN + node
    ukey, grp, size = torch.unique(key, return_inverse=True,
                                   return_counts=True)   # by (point, node)
    G = ukey.numel()
    by_grp = torch.argsort(grp * L + lanes)
    first = lanes[by_grp][torch.cumsum(size, 0) - size]
    is_cam = ukey % NN >= Npad
    order = torch.argsort(is_cam.long() * L + first)
    new_id = torch.empty_like(order)
    new_id[order] = torch.arange(G, device=order.device)
    grp_off = F.pad(torch.cumsum(size[order], 0), (1, 0))
    grp_lane = lanes[torch.argsort(new_id[grp] * L + lanes)]

    # Items: every pair of groups (g, h), g <= h, of one point. Groups of
    # one point are consecutive in `ukey` order, nodes ascending.
    gpt = ukey // NN
    ar = torch.arange(G, device=ukey.device)
    cnt = torch.searchsorted(gpt, gpt, right=True) - ar
    a = torch.repeat_interleave(ar, cnt)
    b = (a + torch.arange(a.numel(), device=a.device)
         - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt))
    gnode = ukey % NN
    pair_key = gnode[a] * NN + gnode[b]
    pair_key, by_pair = torch.sort(pair_key, stable=True)
    items = torch.stack([new_id[a[by_pair]], new_id[b[by_pair]]], dim=1)
    pkeys, pcount = torch.unique_consecutive(pair_key, return_counts=True)
    pstart = torch.cumsum(pcount, 0) - pcount
    pair_node = torch.stack([pkeys // NN, pkeys % NN], dim=1)
    n_units = (pcount + K1B_UNIT_ITEMS - 1) // K1B_UNIT_ITEMS
    pair_unit = F.pad(torch.cumsum(n_units, 0), (1, 0))
    unit_pair = torch.repeat_interleave(
        torch.arange(pkeys.numel(), device=pkeys.device), n_units)
    unit_rank = (torch.arange(unit_pair.numel(), device=pkeys.device)
                 - pair_unit[unit_pair])
    unit_off = torch.cat([pstart[unit_pair] + unit_rank * K1B_UNIT_ITEMS,
                          pcount.new_tensor([items.shape[0]])])
    table = torch.cat([items.reshape(-1), pair_node.reshape(-1), grp_off,
                       grp_lane, unit_off, unit_pair, pair_unit]).int()
    return SchurTiles(
        table=table, n_groups=G, n_img_groups=G - int(is_cam.sum()),
        n_members=grp_lane.numel(), n_units=unit_pair.numel(),
        n_pairs=pkeys.numel(), n_items=items.shape[0])


def pack_params(qvecs, tvecs, cam_params, image_cam, lay: KernelLayout):
    """[7+np, Npad] per-image parameter rows (q, t, k); padded images get
    the identity quaternion."""
    k_img = cam_params[image_cam[:lay.N].long(), :lay.nparams]
    par = torch.zeros(7 + lay.nparams, lay.Npad, dtype=torch.float32,
                      device=qvecs.device)
    par[:, :lay.N] = torch.cat([qvecs, tvecs, k_img], dim=1).T
    par[0, lay.N:] = 1.0
    return par


def pack_points(points, lay: KernelLayout):
    """[3, Pp] transposed, zero-padded."""
    pts = torch.zeros(3, lay.Pp, dtype=torch.float32, device=points.device)
    pts[:, :points.shape[0]] = points.T
    return pts


# ---------------------------------------------------------------------------
# Plain twins: the kernels' arithmetic on whole [rows, O'] lane arrays.
# ---------------------------------------------------------------------------

def _slot_sum(rows, lay):
    """[R, O'] -> [R, Pp]: sum over the K slots of each point, in slot
    order (as the kernels sum them)."""
    R = rows.shape[0]
    r = rows.reshape(R, lay.nb, lay.K, lay.TP)
    out = r[:, :, 0]
    for s in range(1, lay.K):
        out = out + r[:, :, s]
    return out.reshape(R, lay.Pp)


def _tile(rows, lay):
    """[R, Pp] -> [R, O']: per-point rows repeated over the K slots."""
    R = rows.shape[0]
    return (rows.reshape(R, lay.nb, 1, lay.TP)
            .expand(R, lay.nb, lay.K, lay.TP).reshape(R, -1))


def _rot_rows(q):
    """Rotation entries R[i][j] of the quaternion rows q [4, O']."""
    n = torch.rsqrt(torch.sum(q * q, dim=0) + 1e-30)
    w, x, y, z = q[0] * n, q[1] * n, q[2] * n, q[3] * n
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)))


def _camera_uv(par, pts, static, lay):
    """Per-lane gathered params g [7+np, O'], rotation, tiled points and
    the normalized coordinates u, v and 1/z."""
    g = par[:, static.obs_img.long()]
    x = _tile(pts, lay)
    R = _rot_rows(g[0:4])
    pc = [R[i][0] * x[0] + R[i][1] * x[1] + R[i][2] * x[2] + g[4 + i]
          for i in range(3)]
    z = pc[2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    iz = 1.0 / safe_z
    u = torch.clamp(pc[0] * iz, -1e6, 1e6)
    v = torch.clamp(pc[1] * iz, -1e6, 1e6)
    return g, R, x, u, v, iz


def _head(model_id, k, u, v):
    """Projection (px, py), A2 = d(px,py)/d(u,v) [2][2] and
    dk[m] = (dpx, dpy)/dk_m of lane rows u, v [O'] with intrinsics rows
    k [np, O']: sba_tpu's analytic heads (sba_tpu/ops/ba_kernels.py::
    _head), with their guards, operation for operation as the CUDA
    kernels compute them (csrc/ba_kernels.cuh, Head<M>)."""
    zero = torch.zeros_like(u)
    one = torch.ones_like(u)

    def f2_rows(xp, yp):        # fx, fy, cx, cy models
        return [(xp, zero), (zero, yp), (one, zero), (zero, one)]

    if model_id == 0:       # SIMPLE_PINHOLE: f, cx, cy
        f, cx, cy = k
        return (f * u + cx, f * v + cy, ((f, zero), (zero, f)),
                [(u, v), (one, zero), (zero, one)])
    if model_id == 1:       # PINHOLE: fx, fy, cx, cy
        fx, fy, cx, cy = k
        return (fx * u + cx, fy * v + cy, ((fx, zero), (zero, fy)),
                [(u, zero), (zero, v), (one, zero), (zero, one)])
    if model_id == 2:       # SIMPLE_RADIAL: f, cx, cy, k1
        f, cx, cy, k1 = k
        r2 = u * u + v * v
        d = 1.0 + k1 * r2
        a = ((f * (d + 2 * k1 * u * u), f * (2 * k1 * u * v)),
             (f * (2 * k1 * u * v), f * (d + 2 * k1 * v * v)))
        return (f * (u * d) + cx, f * (v * d) + cy, a,
                [(u * d, v * d), (one, zero), (zero, one),
                 (f * u * r2, f * v * r2)])
    if model_id == 3:       # RADIAL: f, cx, cy, k1, k2
        f, cx, cy, k1, k2 = k
        r2 = u * u + v * v
        d = 1.0 + k1 * r2 + k2 * r2 * r2
        dd = 2.0 * (k1 + 2.0 * k2 * r2)
        a = ((f * (d + dd * u * u), f * (dd * u * v)),
             (f * (dd * u * v), f * (d + dd * v * v)))
        return (f * (u * d) + cx, f * (v * d) + cy, a,
                [(u * d, v * d), (one, zero), (zero, one),
                 (f * u * r2, f * v * r2), (f * u * r2 * r2, f * v * r2 * r2)])
    if model_id in (4, 6):  # OPENCV: fx, fy, cx, cy, k1, k2, p1, p2;
        #                     FULL_OPENCV adds k3, k4, k5, k6
        fx, fy, cx, cy, k1, k2, p1, p2 = k[:8]
        u2, v2, uv = u * u, v * v, u * v
        r2 = u2 + v2
        r4 = r2 * r2
        if model_id == 4:
            radial = k1 * r2 + k2 * r4
            drad = 2.0 * (k1 + 2.0 * k2 * r2)
            rad1 = 1.0 + radial
        else:
            k3, k4, k5, k6 = k[8:]
            r6 = r4 * r2
            num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
            den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
            inv_d = 1.0 / den
            radial = num * inv_d
            dnum = k1 + 2.0 * k2 * r2 + 3.0 * k3 * r4
            dden = k4 + 2.0 * k5 * r2 + 3.0 * k6 * r4
            drad = 2.0 * (dnum - radial * dden) * inv_d
            rad1 = radial
        xp = u * rad1 + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2)
        yp = v * rad1 + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2)
        dxp_du = rad1 + u2 * drad + 2.0 * p1 * v + 6.0 * p2 * u
        dxy = uv * drad + 2.0 * p1 * u + 2.0 * p2 * v
        dyp_dv = rad1 + v2 * drad + 2.0 * p2 * u + 6.0 * p1 * v
        a = ((fx * dxp_du, fx * dxy), (fy * dxy, fy * dyp_dv))
        tang = [(fx * 2.0 * uv, fy * (r2 + 2.0 * v2)),
                (fx * (r2 + 2.0 * u2), fy * 2.0 * uv)]
        if model_id == 4:
            dk = f2_rows(xp, yp) + [(fx * u * r2, fy * v * r2),
                                    (fx * u * r4, fy * v * r4)] + tang
        else:
            nd2 = radial * inv_d
            dk = f2_rows(xp, yp) + [
                (fx * u * r2 * inv_d, fy * v * r2 * inv_d),
                (fx * u * r4 * inv_d, fy * v * r4 * inv_d)] + tang + [
                (fx * u * r6 * inv_d, fy * v * r6 * inv_d),
                (-fx * u * r2 * nd2, -fy * v * r2 * nd2),
                (-fx * u * r4 * nd2, -fy * v * r4 * nd2),
                (-fx * u * r6 * nd2, -fy * v * r6 * nd2)]
        return fx * xp + cx, fy * yp + cy, a, dk
    if model_id in (5, 8, 9):  # OPENCV_FISHEYE: fx, fy, cx, cy, k1..k4;
        #                        SIMPLE_RADIAL_FISHEYE: f, cx, cy, k1;
        #                        RADIAL_FISHEYE: f, cx, cy, k1, k2
        if model_id == 5:
            fx, fy, cx, cy, k1, k2, k3, k4 = k
        else:
            fx, cx, cy, k1 = k[:4]
            fy = fx
            k2 = k[4] if model_id == 9 else zero
        u2, v2, uv = u * u, v * v, u * v
        r2 = u2 + v2
        r = torch.sqrt(r2)
        safe_r = torch.clamp(r, min=1e-12)
        small = r < 1e-8
        theta = torch.atan(r)
        t2 = theta * theta
        t4 = t2 * t2
        if model_id == 5:
            poly = 1.0 + k1 * t2 + k2 * t4 + k3 * t4 * t2 + k4 * t4 * t4
            dpoly = (2.0 * k1 + 4.0 * k2 * t2 + 6.0 * k3 * t4
                     + 8.0 * k4 * t4 * t2)
            dthetad = poly + t2 * dpoly
        else:
            poly = 1.0 + k1 * t2 + k2 * t4
            dthetad = 1.0 + 3.0 * k1 * t2 + 5.0 * k2 * t4
        s = torch.where(small, one, theta * poly / safe_r)
        g = torch.where(small, 2.0 * (k1 - 1.0 / 3.0),
                        (dthetad / (1.0 + r2) - s)
                        / torch.clamp(r2, min=1e-24))
        xp, yp = u * s, v * s
        a = ((fx * (s + u2 * g), fx * uv * g),
             (fy * uv * g, fy * (s + v2 * g)))
        t1r = torch.where(small, r2, theta * t2 / safe_r)
        if model_id == 5:
            dk = f2_rows(xp, yp) + [(fx * u * d, fy * v * d) for d in (
                t1r, t1r * t2, t1r * t4, t1r * t4 * t2)]
        else:
            dk = [(xp, yp), (one, zero), (zero, one),
                  (fx * u * t1r, fx * v * t1r)]
            if model_id == 9:
                dk.append((fx * u * t1r * t2, fx * v * t1r * t2))
        return fx * xp + cx, fy * yp + cy, a, dk
    if model_id == 7:       # FOV: fx, fy, cx, cy, omega
        fx, fy, cx, cy, omega = k
        u2, v2, uv = u * u, v * v, u * v
        r2 = u2 + v2
        r = torch.sqrt(r2)
        small_r = r2 < 1e-4
        tanh = torch.tan(omega * 0.5)
        aa = 2.0 * tanh
        safe_om = torch.where(torch.abs(omega) > 1e-12, omega, one)
        small_om = omega * omega < 1e-4
        s_main = torch.atan(aa * r) / (torch.clamp(r, min=1e-12) * safe_om)
        s_small = ((-2.0 * tanh * (4.0 * r2 * tanh * tanh - 3.0))
                   / (3.0 * safe_om))
        s_om = omega * omega * r2 / 3.0 - omega * omega / 12.0 + 1.0
        s = torch.where(small_om, s_om, torch.where(small_r, s_small, s_main))
        # g's main branch and d(s)/d(omega) as csrc Head<7> evaluates
        # them: in double, from tan(omega / 2) in double (the reference's
        # float32 forms cancel).
        td = torch.tan(omega.double() * 0.5)
        ad = 2.0 * td
        x = ad * r.double()
        g_main = (ad * ad * ad / safe_om * (
            (x / (1.0 + x * x) - torch.atan(x)) / (x * x * x))).float()
        g_small = -2.0 * aa * aa * aa / (3.0 * safe_om)
        g = torch.where(small_om, 2.0 * omega * omega / 3.0,
                        torch.where(small_r, g_small, g_main))
        sd = torch.where(
            small_r, -2.0 * td * (4.0 * r2.double() * td * td - 3.0)
            / (3.0 * safe_om.double()),
            torch.atan(x) / (torch.clamp(r, min=1e-12).double() * safe_om))
        dsdo_main = ((1.0 + 0.25 * ad * ad)
                     / (safe_om.double() * (1.0 + ad * ad * r2))
                     - sd / safe_om).float()
        dsdo = torch.where(small_om, 2.0 * omega * r2 / 3.0 - omega / 6.0,
                           dsdo_main)
        xp, yp = u * s, v * s
        a = ((fx * (s + u2 * g), fx * uv * g),
             (fy * uv * g, fy * (s + v2 * g)))
        return (fx * xp + cx, fy * yp + cy, a,
                f2_rows(xp, yp) + [(fx * u * dsdo, fy * v * dsdo)])
    if model_id == 10:      # THIN_PRISM_FISHEYE:
        #                     fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1
        fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1 = k
        r2 = u * u + v * v
        r = torch.sqrt(r2)
        safe_r = torch.clamp(r, min=1e-12)
        small = r < 1e-8
        theta = torch.atan(r)
        s = torch.where(small, one, theta / safe_r)   # equidistant pre-map
        gs = torch.where(small, torch.full_like(u, -2.0 / 3.0),
                         (1.0 / (1.0 + r2) - s)
                         / torch.clamp(r2, min=1e-24))
        up, vp = u * s, v * s
        j00 = s + u * u * gs
        j01 = u * v * gs
        j11 = s + v * v * gs
        q2 = up * up + vp * vp
        q4 = q2 * q2
        q6 = q4 * q2
        q8 = q6 * q2
        uvp = up * vp
        radial = k1 * q2 + k2 * q4 + k3 * q6 + k4 * q8
        drad = 2.0 * (k1 + 2.0 * k2 * q2 + 3.0 * k3 * q4 + 4.0 * k4 * q6)
        xp = (up * (1.0 + radial) + 2.0 * p1 * uvp
              + p2 * (q2 + 2.0 * up * up) + sx1 * q2)
        yp = (vp * (1.0 + radial) + 2.0 * p2 * uvp
              + p1 * (q2 + 2.0 * vp * vp) + sy1 * q2)
        b00 = (1.0 + radial + up * up * drad + 2.0 * p1 * vp + 6.0 * p2 * up
               + 2.0 * sx1 * up)
        b01 = uvp * drad + 2.0 * p1 * up + 2.0 * p2 * vp + 2.0 * sx1 * vp
        b10 = uvp * drad + 2.0 * p2 * vp + 2.0 * p1 * up + 2.0 * sy1 * up
        b11 = (1.0 + radial + vp * vp * drad + 2.0 * p2 * up + 6.0 * p1 * vp
               + 2.0 * sy1 * vp)
        a = ((fx * (b00 * j00 + b01 * j01), fx * (b00 * j01 + b01 * j11)),
             (fy * (b10 * j00 + b11 * j01), fy * (b10 * j01 + b11 * j11)))
        dk = f2_rows(xp, yp) + [
            (fx * up * q2, fy * vp * q2), (fx * up * q4, fy * vp * q4),
            (fx * 2.0 * uvp, fy * (q2 + 2.0 * vp * vp)),
            (fx * (q2 + 2.0 * up * up), fy * 2.0 * uvp),
            (fx * up * q6, fy * vp * q6), (fx * up * q8, fy * vp * q8),
            (fx * q2, zero), (zero, fy * q2)]
        return fx * xp + cx, fy * yp + cy, a, dk
    raise ValueError(f"camera model {model_id}")


def _linearize_lanes(static, par, pts, lay, opt):
    """Residual and masked, IRLS-weighted Jacobian rows of every lane:
    r [2, O'], Jc [12, O'] (rows kk*6 + i, rotation then translation),
    Jx [6, O'] (kk*3 + j), Jk [2np, O'] (kk*np + m)."""
    nparams = lay.nparams
    g, R, x, u, v, iz = _camera_uv(par, pts, static, lay)
    fr = static.free_sta[:, static.obs_img.long()]
    free_p = _tile(static.free_pts[None], lay)[0]
    px, py, A2, dk = _head(opt.model_id, g[7:7 + nparams], u, v)
    r0 = px - static.obs_sta[0]
    r1 = py - static.obs_sta[1]
    s = r0 * r0 + r1 * r1
    w = static.obs_sta[2] * loss_weight(opt.loss, s, opt.loss_scale)
    sw = torch.sqrt(w)
    A = [[A2[kk][0] * iz, A2[kk][1] * iz,
          -(A2[kk][0] * u + A2[kk][1] * v) * iz] for kk in range(2)]
    Jx = [[A[kk][0] * R[0][j] + A[kk][1] * R[1][j] + A[kk][2] * R[2][j]
           for j in range(3)] for kk in range(2)]
    Jq = [[Jx[kk][2] * x[1] - Jx[kk][1] * x[2],
           Jx[kk][0] * x[2] - Jx[kk][2] * x[0],
           Jx[kk][1] * x[0] - Jx[kk][0] * x[1]] for kk in range(2)]
    rot_m = fr[0] * sw
    Jc = []
    for kk in range(2):
        Jc += [Jq[kk][i] * rot_m for i in range(3)]
        Jc += [A[kk][i] * fr[1 + i] * sw for i in range(3)]
    Jx_rows = [Jx[kk][j] * free_p * sw for kk in range(2) for j in range(3)]
    Jk = [dk[m][kk] * fr[4 + m] * sw
          for kk in range(2) for m in range(nparams)]
    return (torch.stack([r0 * sw, r1 * sw]), torch.stack(Jc),
            torch.stack(Jx_rows), torch.stack(Jk))


def _sym3_inv_rows(h, eps=1e-12):
    a, b, c, d, e, f = h
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / torch.where(torch.abs(det) > eps, det,
                                torch.full_like(det, eps))
    return [co00 * inv_det, co01 * inv_det, co02 * inv_det,
            co11 * inv_det, co12 * inv_det, co22 * inv_det]


def _chol3_rows(a, eps=1e-20):
    """Lower Cholesky rows (l00, l10, l20, l11, l21, l22) of a symmetric
    3x3 given as (a00, a01, a02, a11, a12, a22)."""
    a00, a01, a02, a11, a12, a22 = a
    l00 = torch.sqrt(torch.clamp(a00, min=eps))
    l10 = a01 / l00
    l20 = a02 / l00
    l11 = torch.sqrt(torch.clamp(a11 - l10 * l10, min=eps))
    l21 = (a12 - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(a22 - l20 * l20 - l21 * l21, min=eps))
    return [l00, l10, l20, l11, l21, l22]


def _whiten(Wrow, L):
    """(W @ Lp)[j] for one row W (3 lane rows) and lower Lp rows L."""
    return [Wrow[0] * L[0] + Wrow[1] * L[1] + Wrow[2] * L[2],
            Wrow[1] * L[3] + Wrow[2] * L[4],
            Wrow[2] * L[5]]


def _reduce_lanes(static, par, pts, lam, lay: KernelLayout, opt):
    """The linearize-and-reduce body shared by K1 and K2: point payload,
    whitened couplings, the dense image payload rows per lane and jw."""
    nparams = lay.nparams
    r, Jc, Jx, Jk = _linearize_lanes(static, par, pts, lay, opt)

    g_pts = _slot_sum(torch.stack([Jx[j] * r[0] + Jx[3 + j] * r[1]
                                   for j in range(3)]), lay)
    hidx = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    Hpp = _slot_sum(torch.stack([Jx[i] * Jx[j] + Jx[3 + i] * Jx[3 + j]
                                 for i, j in hidx]), lay)
    hdiag = Hpp[[0, 3, 5]]
    d_l = lam * torch.clamp(hdiag, 1e-6, 1e32)
    Hd = [Hpp[0] + d_l[0] + 1e-12, Hpp[1], Hpp[2],
          Hpp[3] + d_l[1] + 1e-12, Hpp[4], Hpp[5] + d_l[2] + 1e-12]
    # The damped inverse in double, rounded once (a point seen once has
    # a rank-2 Hpp, and its float32 inverse cancels by up to 1/lambda);
    # Lp is the Cholesky factor of that stored inverse, in float32.
    Hinv = [h.float() for h in _sym3_inv_rows([h.double() for h in Hd])]
    Lp = _chol3_rows(Hinv)
    pt_pay = torch.cat([g_pts, hdiag, torch.stack(Hinv), torch.stack(Lp),
                        static.free_pts[None]])

    LpB = _tile(torch.stack(Lp), lay)
    WLp = []
    for i in range(6):
        WLp += _whiten([Jc[i] * Jx[j] + Jc[6 + i] * Jx[3 + j]
                        for j in range(3)], LpB)
    WLc = []
    for m in range(nparams):
        WLc += _whiten([Jk[m] * Jx[j] + Jk[nparams + m] * Jx[3 + j]
                        for j in range(3)], LpB)
    WLp, WLc = torch.stack(WLp), torch.stack(WLc)

    pay = [Jc[i] * r[0] + Jc[6 + i] * r[1] for i in range(6)]
    pay += [Jc[i] * Jc[j] + Jc[6 + i] * Jc[6 + j]
            for i in range(6) for j in range(6)]
    pay += [Jc[i] * Jk[m] + Jc[6 + i] * Jk[nparams + m]
            for i in range(6) for m in range(nparams)]
    pay += [Jk[m] * r[0] + Jk[nparams + m] * r[1] for m in range(nparams)]
    pay += [Jk[m] * Jk[m2] + Jk[nparams + m] * Jk[nparams + m2]
            for m in range(nparams) for m2 in range(nparams)]
    jw = torch.cat([Jc, Jx, Jk, WLp, WLc])
    # y = Lp^T g_p per point [3, Pp], the point side of Ey = EL y.
    y = torch.stack([Lp[0] * g_pts[0] + Lp[1] * g_pts[1] + Lp[2] * g_pts[2],
                     Lp[3] * g_pts[1] + Lp[4] * g_pts[2],
                     Lp[5] * g_pts[2]])
    return pay, pt_pay, jw, WLp, WLc, y


def _dot3(a, i, b):
    """sum_j a[i*3 + j] * b[j] over lane rows, left to right."""
    return a[i * 3] * b[0] + a[i * 3 + 1] * b[1] + a[i * 3 + 2] * b[2]


def _image_sum(rows, static, lay, width):
    """Per-lane rows (a list of [O'] tensors) summed into [Npad, width]
    by observing image."""
    out = torch.zeros(lay.Npad, width, dtype=torch.float32,
                      device=rows[0].device)
    return out.index_add_(0, static.obs_img.long(), torch.stack(rows).T)


def fused_schur_plain(static, par, pts, lam, lay: KernelLayout, opt):
    """Plain twin of K1; see `fused_schur`."""
    nparams, Npad, C = lay.nparams, lay.Npad, lay.C
    pay, pt_pay, jw, WLp, WLc, y = _reduce_lanes(static, par, pts, lam,
                                                  lay, opt)
    img_red = _image_sum(pay, static, lay, lay.DI)

    # Dense whitened coupling EL [Dk, 3*Pp] (column p*3 + j), summed over
    # the slots of a point before the optional bf16 rounding.
    img = static.obs_img.long()
    cam = static.obs_cam.long()
    lane_pt = _tile(torch.arange(lay.Pp, device=par.device)[None], lay)[0]
    j3 = torch.arange(3, device=par.device)
    cols = lane_pt[None, :] * 3 + j3[:, None]                     # [3, O']
    i6 = torch.arange(6, device=par.device)
    prow = i6[:, None, None] * Npad + img[None, None, :]          # [6,1,O']
    mnp = torch.arange(nparams, device=par.device)
    crow = 6 * Npad + mnp[:, None, None] * C + cam[None, None, :]
    EL = torch.zeros(lay.Dk, 3 * lay.Pp, dtype=torch.float32,
                     device=par.device)
    EL.index_put_((prow.expand(6, 3, -1), cols.expand(6, 3, -1)),
                  WLp.reshape(6, 3, -1), accumulate=True)
    EL.index_put_((crow.expand(nparams, 3, -1), cols.expand(nparams, 3, -1)),
                  WLc.reshape(nparams, 3, -1), accumulate=True)
    EL_mm = (EL.to(torch.bfloat16).to(torch.float32)
             if opt.schur_bf16 else EL)
    s_corr = EL_mm @ EL_mm.T
    ey = EL @ y.T.reshape(-1)
    return s_corr, img_red, ey, pt_pay, jw


def fused_reduce_plain(static, par, pts, lam, lay: KernelLayout, opt):
    """Plain twin of K2; see `fused_reduce`."""
    nparams = lay.nparams
    pay, pt_pay, jw, WLp, WLc, y = _reduce_lanes(static, par, pts, lam,
                                                  lay, opt)
    yB = _tile(y, lay)
    pay += [_dot3(WLp, i, yB) for i in range(6)]                  # ey_pose
    pay += [_dot3(WLc, m, yB) for m in range(nparams)]            # ey_cam
    if lay.BJ:                                                    # 6x6 tri
        pay += [_dot3(WLp, i, WLp[j * 3:j * 3 + 3])
                for i in range(6) for j in range(i, 6)]
    else:                                                         # diag
        pay += [_dot3(WLp, i, WLp[i * 3:i * 3 + 3]) for i in range(6)]
    pay += [_dot3(WLc, m, WLc[m * 3:m * 3 + 3]) for m in range(nparams)]
    img_red = _image_sum(pay, static, lay, lay.DI_implicit)
    return img_red, pt_pay, jw, _jcorr_of(jw, lay, opt)


def _jcorr_of(jw, lay: KernelLayout, opt):
    """K3's couplings: jw's WL rows (a view in float32, else rounded to
    bfloat16)."""
    n_jac = 18 + 2 * lay.nparams
    return jw[n_jac:n_jac + lay.JC].to(jcorr_dtype(lay, opt))


def schur_matvec_plain(static, du_pose_t, du_cam_t, jcorr,
                       lay: KernelLayout, opt):
    """Plain twin of K3; see `schur_matvec`."""
    nparams = lay.nparams
    du_p = du_pose_t[:, static.obs_img.long()]                   # [6, O']
    du_c = du_cam_t[:, static.obs_cam.long()]                    # [12, O']
    jc = jcorr.float()
    WLp, WLc = jc[0:18], jc[18:18 + 3 * nparams]
    etu = _slot_sum(torch.stack([
        sum(WLp[i * 3 + j] * du_p[i] for i in range(6))
        + sum(WLc[m * 3 + j] * du_c[m] for m in range(nparams))
        for j in range(3)]), lay)
    etuB = _tile(etu, lay)
    pay = [_dot3(jc, i, etuB) for i in range(6 + nparams)]
    return _image_sum(pay, static, lay, 6 + nparams)


def backsub_plain(static, du_pose_t, du_cam_t, pt_pay, jw, lam,
                  lay: KernelLayout, opt):
    """Plain twin of K4; see `backsub`."""
    nparams = lay.nparams
    du_p = du_pose_t[:, static.obs_img.long()]                   # [6, O']
    du_c = du_cam_t[:, static.obs_cam.long()]                    # [12, O']
    Jc, Jx = jw[0:12], jw[12:18]
    Jk = jw[18:18 + 2 * nparams]
    o = 18 + 2 * nparams
    WLp, WLc = jw[o:o + 18], jw[o + 18:o + 18 + 3 * nparams]
    etu = _slot_sum(torch.stack([
        sum(WLp[i * 3 + j] * du_p[i] for i in range(6))
        + sum(WLc[m * 3 + j] * du_c[m] for m in range(nparams))
        for j in range(3)]), lay)
    g, hdiag, hi, lp, free_p = (pt_pay[0:3], pt_pay[3:6], pt_pay[6:12],
                                pt_pay[12:18], pt_pay[18])
    him = ((hi[0], hi[1], hi[2]), (hi[1], hi[3], hi[4]),
           (hi[2], hi[4], hi[5]))
    lpm = ((lp[0],), (lp[1], lp[3]), (lp[2], lp[4], lp[5]))
    dp = []
    for j in range(3):
        a = -(him[j][0] * g[0] + him[j][1] * g[1] + him[j][2] * g[2])
        for i in range(j + 1):
            a = a - lpm[j][i] * etu[i]
        dp.append(a * free_p)
    dp = torch.stack(dp)
    dpB = _tile(dp, lay)
    t2 = 0.0
    for kk in range(2):
        t = (sum(Jc[kk * 6 + i] * du_p[i] for i in range(6))
             + sum(Jk[kk * nparams + m] * du_c[m] for m in range(nparams))
             + sum(Jx[kk * 3 + j] * dpB[j] for j in range(3)))
        t2 = t2 + torch.sum(t * t)
    g_dp = torch.sum(g * dp)
    d_dp2 = torch.sum(lam * torch.clamp(hdiag, 1e-6, 1e32) * dp * dp)
    return dp, torch.stack([t2, g_dp, d_dp2])


def fused_cost_plain(static, par, pts, lay: KernelLayout, opt):
    """Plain twin of K5; see `fused_cost`."""
    g, _, _, u, v, _ = _camera_uv(par, pts, static, lay)
    px, py = camera_models.world_to_image(
        opt.model_id, g[7:7 + lay.nparams].T,
        torch.stack([u, v], dim=-1)).unbind(-1)
    r0 = px - static.obs_sta[0]
    r1 = py - static.obs_sta[1]
    c = 0.5 * static.obs_sta[2] * loss_value(opt.loss, r0 * r0 + r1 * r1,
                                             opt.loss_scale)
    return torch.sum(c)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check(t, name, shape, dtype=torch.float32):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_static(static, lay):
    Op = lay.Pp * lay.K
    _check(static.obs_sta, "obs_sta", (3, Op))
    _check(static.obs_img, "obs_img", (Op,), torch.int32)
    _check(static.obs_cam, "obs_cam", (Op,), torch.int32)
    _check(static.free_sta, "free_sta", (4 + lay.nparams, lay.Npad))
    _check(static.free_pts, "free_pts", (lay.Pp,))


def _check_model(opt):
    if opt.model_id not in CUDA_MODELS:
        raise ValueError(f"camera model {opt.model_id}: the CUDA kernels "
                         f"carry models {CUDA_MODELS[0]}-{CUDA_MODELS[-1]}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def fused_schur(static: KernelStatic, par, pts, lam, lay: KernelLayout,
                opt):
    """K1: linearize every observation, reduce per point and per image,
    and accumulate the Schur correction.

    Returns (S_corr [Dk, Dk], img_red [Npad, DI], ey [Dk],
    pt_pay [19, Pp], jw [JW, O']). `lam` is a 0-d float32 tensor. On
    CUDA, `static.tiles` must hold the bucket's `build_schur_tiles`.
    """
    if not par.is_cuda:
        return fused_schur_plain(static, par, pts, lam, lay, opt)
    _check_model(opt)
    _check_static(static, lay)
    _check(par, "par", (7 + lay.nparams, lay.Npad))
    _check(pts, "pts", (3, lay.Pp))
    _check(lam, "lam", ())
    t = static.tiles
    if t is None:
        raise ValueError("static.tiles: the CUDA K1 needs the bucket's "
                         "build_schur_tiles")
    _check(t.table, "tiles.table",
           (2 * t.n_items + 2 * t.n_pairs + t.n_groups + 1 + t.n_members
            + 2 * t.n_units + 1 + t.n_pairs + 1,), torch.int32)
    dev = par.device
    f32 = dict(dtype=torch.float32, device=dev)
    # One zeroed and one uninitialised allocation per call, cut into the
    # outputs (host time per launch is within reach of the device's).
    # S entries of node pairs that no point links stay zero; the scratch
    # comes first, 16-byte aligned for the kernel's vector loads.
    sizes0 = (lay.Dk * lay.Dk, lay.Npad * lay.DI, lay.Dk)
    s_corr, img_red, ey = torch.zeros(sum(sizes0), **f32).split(sizes0)
    s_corr = s_corr.view(lay.Dk, lay.Dk)
    img_red = img_red.view(lay.Npad, lay.DI)
    sizes1 = (t.n_groups * k1b_group_words(lay.nparams)
              + t.n_units * k1b_entries(lay.nparams),
              lay.JW * lay.Pp * lay.K, PT_ROWS * lay.Pp)
    scratch, jw, pt_pay = torch.empty(sum(sizes1), **f32).split(sizes1)
    jw = jw.view(lay.JW, lay.Pp * lay.K)
    pt_pay = pt_pay.view(PT_ROWS, lay.Pp)
    err = cuda_build.lib().sba_fused_schur(
        opt.model_id, LOSS_IDS[opt.loss], opt.loss_scale,
        int(bool(opt.schur_bf16)), lay.TP, lay.K, lay.Pp, lay.Npad, lay.C,
        lay.Dk, lam.data_ptr(), par.data_ptr(), static.free_sta.data_ptr(),
        pts.data_ptr(), static.free_pts.data_ptr(),
        static.obs_sta.data_ptr(), static.obs_img.data_ptr(),
        static.obs_cam.data_ptr(), t.table.data_ptr(), t.n_groups,
        t.n_img_groups, t.n_members, t.n_units, t.n_pairs, t.n_items,
        scratch.data_ptr(), s_corr.data_ptr(), img_red.data_ptr(),
        ey.data_ptr(), pt_pay.data_ptr(), jw.data_ptr(), _stream())
    cuda_build.check(err, "sba_fused_schur")
    LAUNCHES["fused_schur"] += 1
    return s_corr, img_red, ey, pt_pay, jw


def fused_reduce(static: KernelStatic, par, pts, lam, lay: KernelLayout,
                 opt):
    """K2: K1's linearize and reduce without S_corr, for the implicit
    path. The image payload also carries the Ey rows and the Jacobi
    blocks of EL EL^T (module docstring); in bf16 it also stores the
    couplings once more as `jcorr` for the PCG matvec K3, in f32 `jcorr`
    is a view of jw's WL rows.

    Returns (img_red [Npad, DI_implicit], pt_pay [19, Pp],
    jw [JW, O'], jcorr [JC, O'] f32 or bf16). `lam` is 0-d float32.
    """
    if not par.is_cuda:
        return fused_reduce_plain(static, par, pts, lam, lay, opt)
    _check_model(opt)
    _check_static(static, lay)
    _check(par, "par", (7 + lay.nparams, lay.Npad))
    _check(pts, "pts", (3, lay.Pp))
    _check(lam, "lam", ())
    dev = par.device
    f32 = dict(dtype=torch.float32, device=dev)
    img_red = torch.zeros(lay.Npad, lay.DI_implicit, **f32)
    pt_pay = torch.empty(PT_ROWS, lay.Pp, **f32)
    jw = torch.empty(lay.JW, lay.Pp * lay.K, **f32)
    bf16 = jcorr_dtype(lay, opt) == torch.bfloat16
    jc16 = (torch.empty(lay.JC, lay.Pp * lay.K, dtype=torch.bfloat16,
                        device=dev) if bf16 else None)
    err = cuda_build.lib().sba_fused_reduce(
        opt.model_id, LOSS_IDS[opt.loss], opt.loss_scale, int(lay.BJ),
        int(bf16), lay.TP, lay.K, lay.Pp, lay.Npad, lay.C, lam.data_ptr(),
        par.data_ptr(),
        static.free_sta.data_ptr(), pts.data_ptr(),
        static.free_pts.data_ptr(), static.obs_sta.data_ptr(),
        static.obs_img.data_ptr(), static.obs_cam.data_ptr(),
        img_red.data_ptr(), pt_pay.data_ptr(), jw.data_ptr(),
        jc16.data_ptr() if bf16 else None, _stream())
    cuda_build.check(err, "sba_fused_reduce")
    LAUNCHES["fused_reduce"] += 1
    return img_red, pt_pay, jw, jc16 if bf16 else _jcorr_of(jw, lay, opt)


def schur_matvec(static: KernelStatic, du_pose_t, du_cam_t, jcorr,
                 lay: KernelLayout, opt):
    """K3: the implicit PCG's correction matvec over one bucket,
    out[img, :] += EL (EL^T p) per point, read from `jcorr` [JC, O'].

    p arrives as (du_pose_t [6, Npad], du_cam_t [12, C]). Returns
    [Npad, 6+np] f32: pose rows, then camera rows keyed by image (the
    epilogue sums them by camera). The reference pads the columns to 128
    lanes; the port does not.
    """
    if not jcorr.is_cuda:
        return schur_matvec_plain(static, du_pose_t, du_cam_t, jcorr, lay,
                                  opt)
    _check_model(opt)
    _check_static(static, lay)
    _check(du_pose_t, "du_pose_t", (6, lay.Npad))
    _check(du_cam_t, "du_cam_t", (12, lay.C))
    jc_type = jcorr_dtype(lay, opt)
    _check(jcorr, "jcorr", (lay.JC, lay.Pp * lay.K), jc_type)
    out = torch.zeros(lay.Npad, 6 + lay.nparams, dtype=torch.float32,
                      device=jcorr.device)
    err = cuda_build.lib().sba_schur_matvec(
        opt.model_id, int(jc_type == torch.bfloat16), lay.TP, lay.K, lay.Pp,
        lay.Npad, lay.C, du_pose_t.data_ptr(), du_cam_t.data_ptr(),
        jcorr.data_ptr(), static.obs_sta.data_ptr(),
        static.obs_img.data_ptr(), static.obs_cam.data_ptr(),
        out.data_ptr(), _stream())
    cuda_build.check(err, "sba_schur_matvec")
    LAUNCHES["schur_matvec"] += 1
    return out


def backsub(static: KernelStatic, du_pose_t, du_cam_t, pt_pay, jw, lam,
            lay: KernelLayout, opt):
    """K4: point step dp = -Hpp^-1 g_p - Lp (EL^T du), masked by the free
    points, and the predicted-reduction sums.

    Returns (dp [3, Pp], acc [3] = (||J d||^2, g_p.dp, lam D dp^2)).
    """
    if not jw.is_cuda:
        return backsub_plain(static, du_pose_t, du_cam_t, pt_pay, jw, lam,
                             lay, opt)
    _check_model(opt)
    _check_static(static, lay)
    _check(du_pose_t, "du_pose_t", (6, lay.Npad))
    _check(du_cam_t, "du_cam_t", (12, lay.C))
    _check(pt_pay, "pt_pay", (PT_ROWS, lay.Pp))
    _check(jw, "jw", (lay.JW, lay.Pp * lay.K))
    _check(lam, "lam", ())
    dp = torch.empty(3, lay.Pp, dtype=torch.float32, device=jw.device)
    acc = torch.zeros(3, dtype=torch.float32, device=jw.device)
    err = cuda_build.lib().sba_backsub(
        opt.model_id, lay.TP, lay.K, lay.Pp, lay.Npad, lay.C,
        lam.data_ptr(), du_pose_t.data_ptr(), du_cam_t.data_ptr(),
        pt_pay.data_ptr(), jw.data_ptr(), static.obs_sta.data_ptr(),
        static.obs_img.data_ptr(), static.obs_cam.data_ptr(),
        dp.data_ptr(), acc.data_ptr(), _stream())
    cuda_build.check(err, "sba_backsub")
    LAUNCHES["backsub"] += 1
    return dp, acc


def fused_cost(static: KernelStatic, par, pts, lay: KernelLayout, opt):
    """K5: sum of 1/2 mask rho(||r||^2) at the given parameters (0-d), on
    one bucket: a one-bucket launch of `fused_cost_buckets`."""
    return fused_cost_buckets([static], par, [pts], [lay], opt)


def fused_cost_buckets_plain(statics, par, pts_list, lays, opt):
    """Plain twin of `fused_cost_buckets`: the buckets' twin costs, added
    in bucket order."""
    return sum(fused_cost_plain(st, par, p, lay, opt)
               for st, p, lay in zip(statics, pts_list, lays))


def fused_cost_buckets(statics, par, pts_list, lays, opt):
    """K5 over every bucket of a cost evaluation in ONE launch (at most
    K5_MAX_BUCKETS buckets sharing `par`): the 0-d total, written by the
    kernel with no fill beforehand and the same bits on every call."""
    if not par.is_cuda:
        return fused_cost_buckets_plain(statics, par, pts_list, lays, opt)
    nb = len(lays)
    if not 1 <= nb <= K5_MAX_BUCKETS or len(statics) != nb \
            or len(pts_list) != nb:
        raise ValueError(f"fused_cost_buckets: 1 to {K5_MAX_BUCKETS} "
                         f"buckets, got {len(statics)} / {len(pts_list)} / "
                         f"{nb}")
    for st, p, lay in zip(statics, pts_list, lays):
        if (lay.Npad, lay.nparams) != (lays[0].Npad, lays[0].nparams):
            raise ValueError("fused_cost_buckets: buckets differ in Npad "
                             "or nparams")
        _check_cost_inputs(st, par, p, lay, opt)
    dims = (ctypes.c_int * (3 * nb))(
        *[v for lay in lays for v in (lay.TP, lay.K, lay.Pp)])
    ptrs = (ctypes.c_void_p * (3 * nb))(
        *[t.data_ptr() for st, p in zip(statics, pts_list)
          for t in (p, st.obs_sta, st.obs_img)])
    work = _k5_work(par.device)
    out = torch.empty((), dtype=torch.float32, device=par.device)
    err = cuda_build.lib().sba_fused_cost_buckets(
        opt.model_id, LOSS_IDS[opt.loss], opt.loss_scale, nb, lays[0].Npad,
        par.data_ptr(), dims, ptrs, work.data_ptr(), work.numel(),
        out.data_ptr(), _stream())
    cuda_build.check(err, "sba_fused_cost_buckets")
    LAUNCHES["fused_cost"] += 1
    return out


# K5's cross-block workspaces (its blocks' partial sums and a ticket),
# one for each (device, stream): launches that share one must not
# overlap, and launches on one stream never do. Each is zeroed once, on
# its stream, and every launch leaves its ticket at zero.
_K5_WORK = {}


def _k5_work(device):
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    work = _K5_WORK.get(key)
    if work is None:
        work = _K5_WORK[key] = torch.zeros(
            cuda_build.lib().sba_fused_cost_work_words(), dtype=torch.int32,
            device=device)
    return work


def k5_stages_par(par, lay: KernelLayout) -> bool:
    """Whether K5 stages the parameter table `par` [7+np, Npad] in shared
    memory, else reads it in place: the kernel launcher's own rule."""
    return bool(cuda_build.lib().sba_fused_cost_stages(
        lay.nparams, lay.Npad, par.data_ptr()))


def _check_cost_inputs(static, par, pts, lay, opt):
    _check_model(opt)
    _check(static.obs_sta, "obs_sta", (3, lay.Pp * lay.K))
    _check(static.obs_img, "obs_img", (lay.Pp * lay.K,), torch.int32)
    _check(par, "par", (7 + lay.nparams, lay.Npad))
    _check(pts, "pts", (3, lay.Pp))
