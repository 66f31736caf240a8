"""Surface meshing from fused depth: TSDF integration + surface nets.

Port of ``sba_tpu/mvs/meshing.py`` (ref: src/mvs/meshing.{h,cc}
`PoissonMeshing`, `DelaunayMeshing`; the capability is "depth maps ->
surface mesh", realized with the volumetric pipeline):

1. TSDF fusion on the maps' device: every voxel centre projects into
   each depth map in turn (truncated signed distance, running weighted
   average over the views), one pass of tensor code per view in place of
   sba_tpu's `lax.scan`.
2. Surface nets on the host (numpy, as in sba_tpu: the vertex and face
   lists have a data-dependent size): one vertex per zero-crossing cell
   (centroid of the edge crossings), two triangles across the four
   cells around each crossing edge.

Outputs a triangle mesh (vertices [V, 3], faces [F, 3]) and its PLY.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat


@dataclass(frozen=True)
class TSDFOptions:
    voxel_size: float = 0.05
    truncation: float = 0.15       # truncation distance (world units)
    min_weight: float = 1.0        # voxels below are empty


class Mesh(NamedTuple):
    vertices: np.ndarray  # [V, 3]
    faces: np.ndarray     # [F, 3] int
    normals: Optional[np.ndarray] = None


def tsdf_fuse(depths, Ks, qvecs, tvecs, origin, dims,
              options: Optional[TSDFOptions] = None, device="cuda"):
    """Fuse [N, H, W] depth maps into a TSDF volume on `device`.

    origin: [3] world position of voxel (0,0,0) centre; dims: (X, Y, Z)
    voxel counts. Voxel centres are computed in float64 and cast to the
    depth maps' type, as are the cameras. Returns host numpy
    (tsdf [X,Y,Z], weight [X,Y,Z]) in the depth maps' type.
    """
    opt = options or TSDFOptions()
    depths = torch.as_tensor(np.asarray(depths), device=device)
    N, H, W = depths.shape
    dt = depths.dtype
    Ks = torch.as_tensor(np.asarray(Ks, np.float64), device=device).to(dt)
    Rs = torch.as_tensor(np.stack([np_quat_to_rotmat(q) for q in qvecs]),
                         device=device).to(dt)
    ts = torch.as_tensor(np.asarray(tvecs, np.float64), device=device).to(dt)
    origin = np.asarray(origin, np.float64)
    X, Y, Z = (int(v) for v in dims)
    axes = [torch.arange(n, dtype=torch.float64, device=device)
            * opt.voxel_size + float(origin[k])
            for k, n in enumerate((X, Y, Z))]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([gx, gy, gz], -1).reshape(-1, 3).to(dt)  # [V, 3]
    del gx, gy, gz

    tsdf = torch.zeros(pts.shape[0], dtype=dt, device=device)
    wsum = torch.zeros(pts.shape[0], dtype=dt, device=device)
    for i in range(N):
        pc = pts @ Rs[i].T + ts[i]
        z = pc[:, 2]
        uv = pc @ Ks[i].T
        den = uv[:, 2:]
        xy = uv[:, :2] / torch.where(den.abs() > 1e-9, den,
                                     den.new_tensor(1e-9))
        del pc, uv, den
        # (xy - 0.5) truncated toward zero, then clipped; the float clamp
        # first keeps the integer cast defined (same index after the clip).
        xi = torch.clamp(torch.nan_to_num(xy[:, 0] - 0.5, nan=0.0), -1.0,
                         float(W)).to(torch.int64).clamp_(0, W - 1)
        yi = torch.clamp(torch.nan_to_num(xy[:, 1] - 0.5, nan=0.0), -1.0,
                         float(H)).to(torch.int64).clamp_(0, H - 1)
        d = depths[i].reshape(-1)[yi * W + xi]
        del xi, yi
        inb = ((xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0)
               & (xy[:, 1] < H) & (z > 0) & (d > 0))
        sdf = d - z
        valid = inb & (sdf > -opt.truncation)
        tsdf_new = torch.clamp(sdf / opt.truncation, -1.0, 1.0)
        w = valid.to(dt)
        tsdf = (tsdf * wsum + tsdf_new * w) / torch.clamp(wsum + w, min=1e-9)
        wsum = wsum + w
        del xy, z, d, inb, sdf, valid, tsdf_new, w
    return (tsdf.cpu().numpy().reshape(X, Y, Z),
            wsum.cpu().numpy().reshape(X, Y, Z))


def surface_nets(tsdf: np.ndarray, weight: np.ndarray, origin,
                 voxel_size: float, min_weight: float = 1.0) -> Mesh:
    """Extract the zero isosurface with naive surface nets (host numpy:
    the vertex and face lists have a data-dependent size)."""
    X, Y, Z = tsdf.shape
    valid = weight >= min_weight
    sdf = np.where(valid, tsdf, np.nan)

    # Cells: [X-1, Y-1, Z-1] with 8 corner samples each.
    corners = np.empty((8,) + tuple(np.array([X, Y, Z]) - 1))
    corner_offsets = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                      for dz in (0, 1)]
    for idx, (dx, dy, dz) in enumerate(corner_offsets):
        corners[idx] = sdf[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
    all_valid = ~np.isnan(corners).any(axis=0)
    smin = np.nanmin(corners, axis=0)
    smax = np.nanmax(corners, axis=0)
    crossing = all_valid & (smin < 0) & (smax > 0)
    cells = np.argwhere(crossing)           # [C, 3]
    if len(cells) == 0:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 3), int))

    # Vertex per crossing cell: centroid of sign-change edge crossings.
    cell_vertex_index = -np.ones((X - 1, Y - 1, Z - 1), int)
    cell_vertex_index[tuple(cells.T)] = np.arange(len(cells))

    edges = []
    for a in range(8):
        for b in range(a + 1, 8):
            da = np.array(corner_offsets[a])
            db = np.array(corner_offsets[b])
            if np.abs(da - db).sum() == 1:
                edges.append((a, b))
    cs = corners[:, crossing]               # [8, C]
    verts = np.zeros((len(cells), 3))
    wsum = np.zeros(len(cells))
    for (a, b) in edges:
        sa, sb = cs[a], cs[b]
        cross = (sa < 0) != (sb < 0)
        t = np.where(cross, sa / np.where(np.abs(sa - sb) > 1e-12,
                                          sa - sb, 1e-12), 0.0)
        pa = np.array(corner_offsets[a], float)
        pb = np.array(corner_offsets[b], float)
        pos = pa[None, :] + t[:, None] * (pb - pa)[None, :]
        verts += np.where(cross[:, None], pos, 0.0)
        wsum += cross
    verts = cells + verts / np.maximum(wsum[:, None], 1.0)
    verts = verts * voxel_size + np.asarray(origin)[None, :]

    # Faces: for each SDF edge along axis k crossing zero, connect the 4
    # cells sharing that edge (two triangles, winding by sign).
    faces = []
    for axis in range(3):
        s1 = np.roll(sdf, -1, axis=axis)
        # Edge grid points: need the 4 adjacent cells to exist -> interior.
        inner = [slice(1, X - 1), slice(1, Y - 1), slice(1, Z - 1)]
        inner[axis] = slice(0, [X, Y, Z][axis] - 1)
        e0 = sdf[tuple(inner)]
        e1 = s1[tuple(inner)]
        cross = (~np.isnan(e0)) & (~np.isnan(e1)) & ((e0 < 0) != (e1 < 0))
        pts_e = np.argwhere(cross)
        if len(pts_e) == 0:
            continue
        offs = np.array([1, 1, 1])
        offs[axis] = 0
        pe = pts_e + offs[None, :]
        # The 4 cells around the edge: subtract 1 along the two other axes.
        o1, o2 = [ax for ax in range(3) if ax != axis]
        quads = []
        for (d1, d2) in ((0, 0), (1, 0), (1, 1), (0, 1)):
            c = pe.copy()
            c[:, o1] -= d1
            c[:, o2] -= d2
            quads.append(cell_vertex_index[tuple(c.T)])
        quads = np.stack(quads, -1)          # [E, 4]
        ok = (quads >= 0).all(axis=1)
        quads = quads[ok]
        flip = (e0[tuple(pts_e[ok].T)] > 0)
        t1 = np.where(flip[:, None], quads[:, [0, 1, 2]],
                      quads[:, [0, 2, 1]])
        t2 = np.where(flip[:, None], quads[:, [0, 2, 3]],
                      quads[:, [0, 3, 2]])
        faces.append(t1)
        faces.append(t2)
    faces = np.concatenate(faces) if faces else np.zeros((0, 3), int)

    # Vertex normals from the SDF gradient (SDF increases outward, so
    # the outward normal is +gradient).
    gx, gy, gz = np.gradient(np.nan_to_num(sdf, nan=1.0))
    vi = np.clip(np.round((verts - np.asarray(origin)) / voxel_size)
                 .astype(int), 0, np.array([X, Y, Z]) - 1)
    normals = np.stack([gx[tuple(vi.T)], gy[tuple(vi.T)],
                        gz[tuple(vi.T)]], -1)
    n = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(n, 1e-9)
    return Mesh(vertices=verts, faces=faces, normals=normals)


def grid_bounds(depths, Ks, qvecs, tvecs,
                options: Optional[TSDFOptions] = None, margin: float = 0.2):
    """(origin [3], dims (X, Y, Z)) of the voxel grid around the
    back-projected depth samples (every 4th pixel), or None when no map
    has a valid pixel (host float64, as sba_tpu's)."""
    opt = options or TSDFOptions()
    depths_np = np.asarray(depths)
    pts = []
    for i in range(depths_np.shape[0]):
        R = np_quat_to_rotmat(qvecs[i])
        Kinv = np.linalg.inv(np.asarray(Ks[i]))
        ys, xs = np.nonzero(depths_np[i, ::4, ::4] > 0)
        if len(ys) == 0:
            continue
        d = depths_np[i, ::4, ::4][ys, xs]
        xh = np.stack([xs * 4 + 0.5, ys * 4 + 0.5, np.ones_like(d)], -1)
        pc = (xh @ Kinv.T) * d[:, None]
        pts.append((pc - np.asarray(tvecs[i])) @ R)
    if not pts:
        return None
    pts = np.concatenate(pts)
    lo = pts.min(0) - margin
    hi = pts.max(0) + margin
    dims = tuple(np.maximum(np.ceil((hi - lo) / opt.voxel_size)
                            .astype(int) + 1, 4))
    return lo, dims


def mesh_from_depth_maps(depths, Ks, qvecs, tvecs,
                         options: Optional[TSDFOptions] = None,
                         margin: float = 0.2, device="cuda") -> Mesh:
    """Full pipeline: depth maps -> TSDF (on `device`) -> mesh (host).
    Voxel grid bounds from the back-projected depth samples (strided)."""
    opt = options or TSDFOptions()
    bounds = grid_bounds(depths, Ks, qvecs, tvecs, opt, margin)
    if bounds is None:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 3), int))
    lo, dims = bounds
    tsdf, wts = tsdf_fuse(depths, Ks, qvecs, tvecs, lo, dims, opt,
                          device=device)
    return surface_nets(tsdf, wts, lo, opt.voxel_size, opt.min_weight)


def write_mesh_ply(mesh: Mesh, path):
    """PLY export (ref: PoissonMeshing output format)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(mesh.vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(mesh.faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in mesh.vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in mesh.faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
