"""Stereo fusion: merge per-view depth/normal maps into a dense cloud.

Port of ``sba_tpu/mvs/fusion.py`` (ref: src/mvs/fusion.{h,cc}): for each
pixel of each view, check geometric consistency against the other views
(relative depth error, normal agreement), and fuse consistent samples
into one 3D point. The consistency of all pixels of a view against all
other views runs as tensor code on the maps' device; the variable-size
compaction runs on the host, as in sba_tpu.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from sba_tpu_torch.geometry.quaternions import quat_to_rotmat


@dataclass(frozen=True)
class StereoFusionOptions:
    """Mirrors ref: mvs/fusion.h:54 Options."""

    min_num_pixels: int = 3          # consistent views required (incl. self)
    max_reproj_error: float = 2.0    # px
    max_depth_error: float = 0.01    # relative
    max_normal_error: float = 10.0   # deg
    check_num_images: int = 50
    use_cache: bool = False          # obsolete (host-RAM bound in ref)


class FusedPointCloud(NamedTuple):
    xyz: np.ndarray       # [M, 3]
    normal: np.ndarray    # [M, 3]
    color: np.ndarray     # [M] grayscale in [0,1] (or [M,3] if rgb given)
    num_views: np.ndarray  # [M]
    # Per-point visibility (ragged, CSR-style): which views fused into
    # each point — written to fused.ply.vis.
    vis_counts: np.ndarray = None   # [M] uint32
    vis_idxs: np.ndarray = None     # [sum(vis_counts)] uint32


def fuse_depth_maps(
    depths,           # [N, H, W] (0 = invalid)
    normals,          # [N, H, W, 3] camera-frame normals
    images,           # [N, H, W] grayscale (colors for the cloud)
    Ks,               # [N, 3, 3]
    qvecs,            # [N, 4] world->cam
    tvecs,            # [N, 3]
    options: Optional[StereoFusionOptions] = None,
    device="cuda",
) -> FusedPointCloud:
    """Fuse all views. The all-pairs consistency votes run on `device`
    (numpy inputs are moved there); the compaction runs on the host.
    Geometry runs in the promoted type of the maps and the cameras (as
    sba_tpu's type promotion does), colours in the images' type."""
    opt = options or StereoFusionOptions()
    depths_np = np.asarray(depths)
    N, H, W = depths_np.shape
    Ks_np = np.asarray(Ks)
    gdt = getattr(torch, np.promote_types(depths_np.dtype,
                                          Ks_np.dtype).name)
    depths = torch.as_tensor(depths_np, device=device)
    normals = torch.as_tensor(np.asarray(normals), device=device)
    images = torch.as_tensor(np.asarray(images), device=device)
    Ks = torch.as_tensor(Ks_np, device=device)
    q = torch.as_tensor(np.asarray(qvecs), device=device)
    Rs = torch.stack([quat_to_rotmat(q[i]) for i in range(N)])
    ts = torch.as_tensor(np.asarray(tvecs), device=device)
    Ks, Rs, ts = Ks.to(gdt), Rs.to(gdt), ts.to(gdt)

    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=depths.dtype, device=device) + 0.5,
        torch.arange(W, dtype=depths.dtype, device=device) + 0.5,
        indexing="ij")
    xh = torch.stack([xx, yy, torch.ones_like(xx)], -1).to(gdt)
    cos_thr = math.cos(math.radians(opt.max_normal_error))

    def backproject(i):
        """Pixels of view i -> world points + world normals."""
        Kinv = torch.linalg.inv(Ks[i])
        ray = torch.einsum("ij,hwj->hwi", Kinv, xh)
        p_cam = ray * depths[i][..., None]
        p_world = torch.einsum("ji,hwj->hwi", Rs[i],
                               p_cam - ts[i][None, None])
        n_world = torch.einsum("ji,hwj->hwi", Rs[i], normals[i].to(gdt))
        return p_world, n_world

    def consistency(i):
        """[H, W] count of views consistent with view i's pixels, plus
        accumulated world positions/normals for averaging."""
        p_world, n_world = backproject(i)
        votes = torch.ones((H, W), dtype=torch.int32, device=device)
        acc_p = p_world
        acc_n = n_world
        acc_c = images[i]
        vis_bits = [None] * N   # per-view consistency masks [H, W]
        vis_bits[i] = depths[i] > 0
        for j in range(N):
            if j == i:
                continue
            p_j = torch.einsum("ij,hwj->hwi", Rs[j], p_world) + ts[j]
            z_j = p_j[..., 2]
            uv = torch.einsum("ij,hwj->hwi", Ks[j], p_j)
            den = uv[..., 2:]
            xy_j = uv[..., :2] / torch.where(torch.abs(den) > 1e-9, den,
                                             torch.full_like(den, 1e-9))
            # Truncation toward zero, as sba_tpu's astype(int32).
            xi = (xy_j[..., 0] - 0.5).to(torch.int32).clamp(0, W - 1)
            yi = (xy_j[..., 1] - 0.5).to(torch.int32).clamp(0, H - 1)
            xi, yi = xi.long(), yi.long()
            d_j = depths[j][yi, xi]
            nrm_j = normals[j][yi, xi].to(gdt)
            inb = ((xy_j[..., 0] >= 0) & (xy_j[..., 0] < W)
                   & (xy_j[..., 1] >= 0) & (xy_j[..., 1] < H))
            depth_ok = torch.abs(d_j - z_j) \
                < opt.max_depth_error * torch.clamp(z_j, min=1e-6)
            # Normal agreement in world frame.
            n_j_world = torch.einsum("ji,hwj->hwi", Rs[j], nrm_j)
            dotp = torch.sum(n_world * n_j_world, -1)
            normal_ok = dotp > cos_thr
            ok = inb & (z_j > 0) & (d_j > 0) & depth_ok & normal_ok \
                & (depths[i] > 0)
            vis_bits[j] = ok
            votes = votes + ok.to(torch.int32)
            # Accumulate the consistent sample's world position.
            Kinv_j = torch.linalg.inv(Ks[j])
            xh_j = torch.cat([xy_j, torch.ones_like(xy_j[..., :1])], -1)
            p_j_cam = torch.einsum("ij,hwj->hwi", Kinv_j, xh_j) \
                * d_j[..., None]
            p_j_world = torch.einsum(
                "ji,hwj->hwi", Rs[j], p_j_cam - ts[j][None, None])
            okk = ok[..., None]
            acc_p = acc_p + torch.where(okk, p_j_world,
                                        torch.zeros_like(p_j_world))
            acc_n = acc_n + torch.where(okk, n_j_world,
                                        torch.zeros_like(n_j_world))
            c_j = images[j][yi, xi]
            acc_c = acc_c + torch.where(ok, c_j, torch.zeros_like(c_j))
        cnt = votes.to(depths.dtype)[..., None]
        return (votes, acc_p / cnt, acc_n / cnt, acc_c / cnt[..., 0],
                torch.stack(vis_bits))

    # Device pass per view; host compaction (variable-size output).
    all_xyz, all_n, all_c, all_v = [], [], [], []
    all_vis_cnt, all_vis_idx = [], []
    used = np.zeros((N, H, W), bool)  # avoid duplicating fused pixels
    Rs_np = Rs.cpu().numpy()
    ts_np = ts.cpu().numpy()
    Ks_h = Ks.cpu().numpy()
    for i in range(N):
        votes, p_avg, n_avg, c_avg, vis = (t.cpu().numpy()
                                           for t in consistency(i))
        keep = (votes >= opt.min_num_pixels) & (depths_np[i] > 0) \
            & ~used[i]
        ys, xs = np.nonzero(keep)
        if len(ys) == 0:
            continue
        all_xyz.append(p_avg[ys, xs])
        nn = n_avg[ys, xs]
        nn /= np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-9)
        all_n.append(nn)
        all_c.append(c_avg[ys, xs])
        all_v.append(votes[ys, xs])
        # Visibility lists (CSR): views whose samples fused into the point.
        okk = vis[:, ys, xs]          # [N, M_i] bool
        all_vis_cnt.append(okk.sum(0).astype(np.uint32))
        all_vis_idx.append(np.nonzero(okk.T)[1].astype(np.uint32))
        # Mark source pixels of other views as consumed: project fused
        # points into each later view and invalidate hits.
        pts = all_xyz[-1]
        for j in range(i + 1, N):
            pc = pts @ Rs_np[j].T + ts_np[j]
            z = pc[:, 2]
            uv = pc @ Ks_h[j].T
            xyj = uv[:, :2] / np.where(np.abs(uv[:, 2:]) > 1e-9,
                                       uv[:, 2:], 1e-9)
            xi = np.clip((xyj[:, 0] - 0.5).astype(int), 0, W - 1)
            yi = np.clip((xyj[:, 1] - 0.5).astype(int), 0, H - 1)
            dj = depths_np[j][yi, xi]
            hit = (z > 0) & (np.abs(dj - z)
                             < opt.max_depth_error * np.maximum(z, 1e-6))
            used[j, yi[hit], xi[hit]] = True

    if not all_xyz:
        return FusedPointCloud(np.zeros((0, 3)), np.zeros((0, 3)),
                               np.zeros(0), np.zeros(0, int),
                               np.zeros(0, np.uint32),
                               np.zeros(0, np.uint32))
    return FusedPointCloud(
        xyz=np.concatenate(all_xyz),
        normal=np.concatenate(all_n),
        color=np.concatenate(all_c),
        num_views=np.concatenate(all_v),
        vis_counts=np.concatenate(all_vis_cnt),
        vis_idxs=np.concatenate(all_vis_idx))


def write_fused_ply(cloud: FusedPointCloud, path):
    """PLY export of the fused cloud (ref: fusion.cc WritePlyText /
    util/ply.cc)."""
    xyz = cloud.xyz
    nrm = cloud.normal
    col = cloud.color
    if col.ndim == 1:
        col = np.stack([col] * 3, -1)
    col8 = np.clip(col * 255, 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write("end_header\n")
        for p, n, c in zip(xyz, nrm, col8):
            f.write(f"{p[0]} {p[1]} {p[2]} {n[0]} {n[1]} {n[2]} "
                    f"{c[0]} {c[1]} {c[2]}\n")


def write_fused_vis(cloud: FusedPointCloud, path):
    """Binary fused.ply.vis: uint64 num_points, then per point a uint32
    count followed by count uint32 image indices (format of
    ref: scripts/python/read_write_fused_vis.py)."""
    counts = cloud.vis_counts
    idxs = cloud.vis_idxs
    if counts is None:
        counts = np.asarray(cloud.num_views, np.uint32) * 0
        idxs = np.zeros(0, np.uint32)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cloud.xyz)))
        off = 0
        for c in counts:
            c = int(c)
            f.write(struct.pack("<I", c))
            f.write(np.asarray(idxs[off:off + c], "<u4").tobytes())
            off += c


def read_fused_vis(path):
    """-> (counts [M] uint32, idxs flat uint32) from a fused.ply.vis."""
    with open(path, "rb") as f:
        (m,) = struct.unpack("<Q", f.read(8))
        counts = np.empty(m, np.uint32)
        idxs = []
        for i in range(m):
            (c,) = struct.unpack("<I", f.read(4))
            counts[i] = c
            idxs.append(np.frombuffer(f.read(4 * c), "<u4"))
    return counts, (np.concatenate(idxs) if idxs
                    else np.zeros(0, np.uint32))
