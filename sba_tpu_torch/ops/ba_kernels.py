"""The bundle-adjustment LM kernels: CUDA wrappers and their plain twins.

Port of the five kernels of ``sba_tpu/ops/ba_kernels.py``: K1
`fused_schur` (dense path), K2 `fused_reduce` and K3 `schur_matvec`
(implicit path), K4 `backsub` and K5 `fused_cost`. Each wrapper launches
the hand-written kernel of ``csrc/ba_kernels.cu`` when its tensors are on
CUDA, and runs the plain PyTorch twin beside it only when they lie on
the CPU. The twins repeat the kernels' arithmetic on whole lane arrays;
their camera heads go through ``geometry.camera_models`` (all 11
models, derivatives by forward-mode jvp) while the CUDA kernels carry
analytic heads for SIMPLE_PINHOLE, PINHOLE and SIMPLE_RADIAL only.

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

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sba_tpu_torch.geometry import camera_models
from sba_tpu_torch.ops import cuda_build
from sba_tpu_torch.optim.losses import LOSS_IDS, loss_value, loss_weight

PT_ROWS = 19
CUDA_MODELS = (0, 1, 2)   # camera heads the CUDA kernels implement
# Largest track length the K1 S_corr kernel keeps per point in shared
# memory (one warp per point).
CUDA_MAX_K = 1024

# The ranged regime starts here (see the module docstring).
RANGED_MIN_NPAD = 2048

# K3's block shape in csrc/ba_kernels.cu: points per block (kK3Points)
# and images per shared-memory window chunk (kK3Window).
K3_POINTS_PER_BLOCK = 64
K3_WINDOW = 256

# Launch counts of the CUDA kernels (a wrapper adds one per launch).
LAUNCHES = {"fused_schur": 0, "fused_reduce": 0, "schur_matvec": 0,
            "backsub": 0, "fused_cost": 0}


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


class KernelStatic(NamedTuple):
    """Per-solve device tensors in kernel (slot-major) order."""

    obs_sta: torch.Tensor   # [3, O'] f32: x, y, mask
    obs_img: torch.Tensor   # [O'] i32
    obs_cam: torch.Tensor   # [O'] i32
    free_sta: torch.Tensor  # [4+np, Npad] f32: rot(1), trans(3), cam(np)
    free_pts: torch.Tensor  # [Pp] f32
    image_cam: torch.Tensor  # [Npad] i32


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


def schur_matvec_windows(static: KernelStatic, lay: KernelLayout):
    """The image windows of K3's blocks, as the kernel takes them.

    A block covers K3_POINTS_PER_BLOCK points of one TP-point block (all
    their slots); its window is [lo, hi], the least and greatest image of
    its live lanes, summed in chunks of K3_WINDOW images. Returns (lo, hi,
    chunks), each [blocks] int64 in block order; a block without live
    lanes has lo = 2^31 - 1, hi = -1 and 0 chunks."""
    TP, K, nb = lay.TP, lay.K, lay.nb
    groups = -(-TP // K3_POINTS_PER_BLOCK)
    pad = groups * K3_POINTS_PER_BLOCK - TP
    img = static.obs_img.long().reshape(nb, K, TP)
    live = static.obs_sta[2].reshape(nb, K, TP) != 0
    big = torch.full_like(img, 2 ** 31 - 1)
    lo = torch.where(live, img, big)
    hi = torch.where(live, img, torch.full_like(img, -1))
    lo = F.pad(lo, (0, pad), value=2 ** 31 - 1)
    hi = F.pad(hi, (0, pad), value=-1)
    shape = (nb, K, groups, K3_POINTS_PER_BLOCK)
    lo = lo.reshape(shape).amin(dim=(1, 3)).reshape(-1)
    hi = hi.reshape(shape).amax(dim=(1, 3)).reshape(-1)
    chunks = torch.clamp(hi - lo + K3_WINDOW, min=0) // K3_WINDOW
    return lo, hi, chunks


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
    """[R, O'] -> [R, Pp]: sum over the K slots of each point."""
    R = rows.shape[0]
    return rows.reshape(R, lay.nb, lay.K, lay.TP).sum(2).reshape(R, lay.Pp)


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
    dk[m] = (dpx, dpy)/dk_m through the plain camera model."""
    spec = camera_models.model_by_id(model_id)
    kk = k.T                                            # [O', np]
    uv = torch.stack([u, v], dim=-1)

    def proj(uv_, k_):
        return spec.world_to_image(k_, uv_)

    def jvp(t_uv, t_k):
        return torch.func.jvp(proj, (uv, kk), (t_uv, t_k))

    pxy, _ = jvp(torch.zeros_like(uv), torch.zeros_like(kk))
    a = []
    for j in range(2):
        t = torch.zeros_like(uv)
        t[:, j] = 1.0
        a.append(jvp(t, torch.zeros_like(kk))[1])       # d/du_j: [O', 2]
    dk = []
    for m in range(k.shape[0]):
        t = torch.zeros_like(kk)
        t[:, m] = 1.0
        d = jvp(torch.zeros_like(uv), t)[1]
        dk.append((d[:, 0], d[:, 1]))
    A2 = ((a[0][:, 0], a[1][:, 0]), (a[0][:, 1], a[1][:, 1]))
    return pxy[:, 0], pxy[:, 1], A2, dk


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
    Hinv = _sym3_inv_rows(Hd)
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
        raise NotImplementedError(
            f"camera model {opt.model_id}: CUDA kernel head not yet ported "
            f"(ported: {CUDA_MODELS})")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def fused_schur(static: KernelStatic, par, pts, lam, lay: KernelLayout,
                opt):
    """K1: linearize every observation, reduce per point and per image,
    and accumulate the Schur correction.

    Returns (S_corr [Dk, Dk], img_red [Npad, DI], ey [Dk],
    pt_pay [19, Pp], jw [JW, O']). `lam` is a 0-d float32 tensor.
    """
    if not par.is_cuda:
        return fused_schur_plain(static, par, pts, lam, lay, opt)
    _check_model(opt)
    if lay.K > CUDA_MAX_K:
        raise NotImplementedError(
            f"track length {lay.K} > {CUDA_MAX_K} in the CUDA K1 kernel")
    _check_static(static, lay)
    _check(par, "par", (7 + lay.nparams, lay.Npad))
    _check(pts, "pts", (3, lay.Pp))
    _check(lam, "lam", ())
    dev = par.device
    f32 = dict(dtype=torch.float32, device=dev)
    s_corr = torch.zeros(lay.Dk, lay.Dk, **f32)
    img_red = torch.zeros(lay.Npad, lay.DI, **f32)
    ey = torch.zeros(lay.Dk, **f32)
    pt_pay = torch.empty(PT_ROWS, lay.Pp, **f32)
    jw = torch.empty(lay.JW, lay.Pp * lay.K, **f32)
    err = cuda_build.lib().sba_fused_schur(
        opt.model_id, LOSS_IDS[opt.loss], opt.loss_scale,
        int(bool(opt.schur_bf16)), lay.TP, lay.K, lay.Pp, lay.Npad, lay.C,
        lay.Dk, lam.data_ptr(), par.data_ptr(), static.free_sta.data_ptr(),
        pts.data_ptr(), static.free_pts.data_ptr(),
        static.obs_sta.data_ptr(), static.obs_img.data_ptr(),
        static.obs_cam.data_ptr(), s_corr.data_ptr(), img_red.data_ptr(),
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
    """K5: sum of 1/2 mask rho(||r||^2) at the given parameters (0-d)."""
    if not par.is_cuda:
        return fused_cost_plain(static, par, pts, lay, opt)
    _check_model(opt)
    _check(static.obs_sta, "obs_sta", (3, lay.Pp * lay.K))
    _check(static.obs_img, "obs_img", (lay.Pp * lay.K,), torch.int32)
    _check(par, "par", (7 + lay.nparams, lay.Npad))
    _check(pts, "pts", (3, lay.Pp))
    acc = torch.zeros(1, dtype=torch.float32, device=par.device)
    err = cuda_build.lib().sba_fused_cost(
        opt.model_id, LOSS_IDS[opt.loss], opt.loss_scale, lay.TP, lay.K,
        lay.Pp, lay.Npad, par.data_ptr(), pts.data_ptr(),
        static.obs_sta.data_ptr(), static.obs_img.data_ptr(),
        acc.data_ptr(), _stream())
    cuda_build.check(err, "sba_fused_cost")
    LAUNCHES["fused_cost"] += 1
    return acc[0]
