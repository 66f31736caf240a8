"""Accuracy of the dense MVS chain on a rendered scene.

The scenes of `sba_tpu_torch.utils.render.render_scene` are a heightfield
known in closed form, so the chain's outputs can be held against it:

- `depth_map_accuracy`: each pass's depth maps (photometric, geometric)
  against the true depth of every pixel of the undistorted views: the
  valid share, the median and 80th percentile of |d - truth| / truth
  over the valid pixels and the share of them within 1%, each a mean
  over the views;
- `cloud_accuracy`: a fused cloud's size and the median and 80th
  percentile of its points' vertical distance to the heightfield.

Run as a script it renders a scene, runs the three dense commands of
`sba_tpu_torch.cli` on it, prints both measures, the cloud once for each
of `FUSION_SETS`, and as its last line all of them as one JSON object.
Flags it does not know go to `patch_match_stereo`:

    python -m sba_tpu_torch.utils.mvs_accuracy [--size 1600 1200] \
        [--texture_scale 0.55] [--device cuda] \
        [--PatchMatchStereo.num_iterations 24]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np

# Fusion's options as the CLI takes them: its defaults (normals within
# 10 degrees, 3 views), the normal test opened, and 2 views suffice.
FUSION_SETS = ({}, {"StereoFusion.max_normal_error": "180"},
               {"StereoFusion.max_normal_error": "180",
                "StereoFusion.min_num_pixels": "2"})


def true_depth(field, rec, iid, device="cpu"):
    """Depth of the heightfield at every pixel of an undistorted
    (pinhole) view of `rec`, [H, W] float64 numpy."""
    import torch

    from sba_tpu_torch.cli import _pinhole_K
    from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat
    from sba_tpu_torch.utils.render import _march

    im = rec.images[iid]
    cam = rec.cameras[im.camera_id]
    f64 = dict(dtype=torch.float64, device=device)
    Kinv = torch.as_tensor(np.linalg.inv(_pinhole_K(rec, iid)), **f64)
    yy, xx = torch.meshgrid(torch.arange(cam.height, **f64) + 0.5,
                            torch.arange(cam.width, **f64) + 0.5,
                            indexing="ij")
    d_cam = torch.stack([xx, yy, torch.ones_like(xx)], -1).reshape(
        -1, 3) @ Kinv.T
    R = torch.as_tensor(np_quat_to_rotmat(im.qvec), **f64)
    C = -R.T @ torch.as_tensor(im.tvec, **f64)
    return _march(field, C, d_cam @ R).reshape(
        cam.height, cam.width).cpu().numpy()


def depth_map_accuracy(ws, field, device="cpu"):
    """{pass: {"valid", "median", "p80", "within1"}} of the workspace's
    depth maps against the heightfield, means over the views that have a
    map of that pass."""
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.mvs import read_colmap_map

    ws = Path(ws)
    rec = Reconstruction.read(str(ws / "sparse"))
    rows = {"photometric": [], "geometric": []}
    for iid, im in sorted(rec.images.items()):
        truth = None
        for kind, acc in rows.items():
            path = ws / "stereo" / "depth_maps" / f"{im.name}.{kind}.bin"
            if not path.exists():
                continue
            if truth is None:
                truth = true_depth(field, rec, iid, device)
            d = read_colmap_map(path)
            m = d > 0
            rel = np.abs(d[m] - truth[m]) / truth[m]
            acc.append((m.mean(), np.median(rel), np.quantile(rel, 0.8),
                        (rel < 0.01).mean()) if m.any()
                       else (0.0, np.inf, np.inf, 0.0))
    return {kind: dict(zip(("valid", "median", "p80", "within1"),
                           map(float, np.mean(acc, 0))))
            for kind, acc in rows.items() if acc}


def read_ply_xyz(path):
    """The xyz columns of an ASCII .ply written by `write_fused_ply`."""
    body = Path(path).read_text().split("end_header\n", 1)[1]
    rows = [line.split()[:3] for line in body.splitlines() if line]
    return np.array(rows, np.float64).reshape(-1, 3)


def cloud_accuracy(xyz, field):
    """{"points", "median", "p80"}: the cloud's size and its points'
    vertical distance to the heightfield (nan for an empty cloud)."""
    import torch

    if not len(xyz):
        return dict(points=0, median=float("nan"), p80=float("nan"))
    pts = torch.as_tensor(xyz, dtype=torch.float64)
    dz = (pts[:, 2] - field.z(pts[:, 0], pts[:, 1])).abs().numpy()
    return dict(points=len(xyz), median=float(np.median(dz)),
                p80=float(np.quantile(dz, 0.8)))


def _cli(*args):
    """One command of `sba_tpu_torch.cli` in this process; its output."""
    from sba_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main([str(a) for a in args])
    if code != 0:
        raise RuntimeError(f"{args[0]} exit {code}:\n{out.getvalue()}")
    return out.getvalue()


def main(argv=None) -> int:
    from sba_tpu_torch.ops import cuda_build
    from sba_tpu_torch.utils.render import (_Heightfield,
                                            gt_sparse_reconstruction,
                                            render_scene,
                                            write_scene_images)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_images", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(1600, 1200),
                    metavar=("W", "H"))
    ap.add_argument("--texture_scale", type=float, default=0.55)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sparse_stride", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args, pm_flags = ap.parse_known_args(argv)

    scene = render_scene(num_images=args.num_images,
                         image_size=tuple(args.size),
                         model_name="SIMPLE_RADIAL", extra_params=(-0.05,),
                         texture_scale=args.texture_scale, seed=args.seed,
                         device=args.device)
    field = _Heightfield(5.0, 0.55, args.seed)   # render_scene's relief
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="mvs_accuracy_",
                                 dir=cuda_build.BUILD_DIR))
    try:
        names = write_scene_images(scene, str(work / "images"))
        gt_sparse_reconstruction(scene, names, stride=args.sparse_stride
                                 ).write(str(work / "sparse"))
        ws = work / "dense"
        dev = ("--device", args.device)
        _cli("image_undistorter", "--image_path", work / "images",
             "--input_path", work / "sparse", "--output_path", ws, *dev)
        _cli("patch_match_stereo", "--workspace_path", ws, *pm_flags, *dev)
        record = dict(vars(args), patch_match=pm_flags,
                      median_depth=float(np.median(scene["depths"])),
                      maps=depth_map_accuracy(ws, field, args.device),
                      clouds=[])
        for kind, a in record["maps"].items():
            print(f"{kind} depth maps: valid {a['valid']:.4f}, median "
                  f"|err| {a['median']:.4f}, p80 {a['p80']:.4f}, within "
                  f"1% {a['within1']:.4f} (of the valid pixels)")
        for fuse in FUSION_SETS:
            ply = ws / "fused.ply"
            _cli("stereo_fuser", "--workspace_path", ws, "--output_path",
                 ply, *[x for kv in fuse.items() for x in ("--" + kv[0],
                                                          kv[1])], *dev)
            c = dict(cloud_accuracy(read_ply_xyz(ply), field), fusion=fuse)
            record["clouds"].append(c)
            print(f"fusion {fuse}: {c['points']} points, vertical distance "
                  f"median {c['median']:.5f}, p80 {c['p80']:.5f}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
