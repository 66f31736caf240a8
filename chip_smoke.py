"""On-card smoke run of the PyTorch/CUDA port (sba_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (found through torch's CUDA_HOME, else
/usr/local/cuda). It builds the hand-written kernels from csrc/, then:

1. build          -- nvcc version and path, build time, ptxas lines;
2. twins          -- K1/K4/K5 against their plain PyTorch twins on the
                     same CUDA tensors at the headline shapes (128 images,
                     30,000 points, ~7 observations per point), models 0
                     and 2 (K1's S_corr exactly symmetric); a small solve
                     through the kernels against the same solve through
                     the twins on the CPU, and bf16 against f32 S_corr;
3. twins-implicit -- K2-K5 against their twins at the 1024-image
                     sequential scene (f32 and bf16 coupling stores), K3
                     also with the scene's image ids permuted and K2 with
                     its images renamed by `spread_image_ids` (every
                     block's window spans several chunks; the count of
                     such blocks is printed), and on a two-camera scene,
                     whose implicit step on the card is held against the
                     same step on the CPU;
4. twins-heads    -- camera models 3-10, each observed through a small
                     distortion (DISTORT) with its intrinsics free: K1,
                     K4 and K5 against their twins at the headline
                     shapes, K2-K5 on an implicit bucket (the 1024-image
                     scene for RADIAL and FULL_OPENCV, K2's diagonal and
                     block payload modes; 160 images for the rest);
5. main           -- `bundle_adjust` on the headline problem in float32
                     (dense path: K1, K4, K5 must launch), cost must
                     fall; host prep (`ba_fused.prepare`) and LM it/s
                     of a warm `solve_prepared`;
6. main-implicit  -- `bundle_adjust` on the 1024-image scene (implicit
                     path: K2, K3, K4, K5 must launch, K1 must not); LM
                     it/s, K3 launches per LM iteration, peak memory;
7. main-opencv    -- `bundle_adjust` with OPENCV cameras (intrinsics
                     free): the headline (K1, K4, K5; host prep and warm
                     LM it/s), the 1024-image scene (10 LM iterations:
                     K2-K5; LM it/s, K3 launches per LM iteration), and
                     5 LM iterations each of the FULL_OPENCV and
                     THIN_PRISM_FISHEYE headlines; every cost must fall;
8. large-ranged   -- 3 LM iterations at 10,240 images / 1.2M points
                     (ranged, bf16 couplings); host prep timed apart;
                     K2-K5 against their twins at these shapes;
9. cli            -- `python -m sba_tpu_torch.cli bundle_adjuster` in
                     float32 on a 20-image (dense), a 160-image
                     (implicit) and a 20-image OPENCV model
                     (`--BundleAdjustment.model_id 4`), then at its
                     defaults (float64) on a 256-image model whose
                     couplings pass the explicit step's 2 GiB: 2 LM
                     iterations of the plain PCG step, no kernel;
10. twins-mvs      -- K6 (ncc_cost) against its twin on the same CUDA
                     tensors, bit for bit, at 1600x1200 x 4 sources (r=3
                     and r=5 with step 1, r=3 with step 2; one source
                     with a band outside its image) and x 7 sources (past
                     the kernel's chunk of 4), and the card's hypothesis cost
                     (packed sampling + K6) against the CPU twins' at
                     240x320;
11. mvs           -- the dense chain at full width: an 8-view 1600x1200
                     SIMPLE_RADIAL scene rendered on the card, written as
                     images + a sparse model, then `image_undistorter`,
                     `patch_match_stereo` and `stereo_fuser` of
                     `python -m sba_tpu_torch.cli` with `--device cuda`;
                     K6 must launch, each pass's depth maps must meet
                     MAP_LIMITS against the analytic heightfield, the
                     cloud must hold MIN_FUSED_POINTS and lie on the
                     heightfield (median vertical error under 1%, 80th
                     percentile under 3% of the median depth); then one
                     warm photometric solve in process
                     (Mpix*iterations/s, peak device memory);
12. twins-sba     -- the map-gather kernels against their twins on the
                     same CUDA tensors, bit for bit: B1-B4's probe entries
                     at the probes' shapes (50 maps of 640x480 u32 words,
                     7,526,400 samples) and the SBA path's flat form in
                     4- and 8-byte words; the forward-mode tangent of the
                     f64 samplers through the kernels against the CPU
                     twins';
13. sba           -- semantic BA at the bench_sba width (bench.py:94: 50
                     images, 640x480, pixel step 10, soft, float32, 10
                     LM iterations, tolerances off): the cost, the
                     rotation error against the truth and the hard label
                     mismatches must fall, map_gather must launch in
                     every linearization; warm LM it/s,
                     launches per LM iteration, peak memory; then the
                     same scene at 12 labels (the two-map path:
                     map_gather_pair must launch), and a small solve
                     through the kernels against the CPU twins';
14. cli-sba       -- `python -m sba_tpu_torch.cli semantic_bundle_adjuster`
                     on an 8-image 640x480 model with TIFF maps, at its
                     defaults (float64, forward mode) and in hard_numeric
                     mode;
15. timing        -- per-kernel CUDA-event times (the stream sleeps
                     while the host enqueues the timed calls, so they are
                     the device's) against the twins, the
                     memory/compute bound and, for B1-B4, the PyTorch
                     library call of the same function (K1-K4, K6 and
                     map_gather also beside their first designs' times,
                     "was"); K4 with random du, also at the 1024-image
                     bucket; B1-B4 also beside the least time over the
                     32-byte sectors their samples touch;
16. profile       -- device time by kernel over one warm solve of the
                     headline (with K1's split between its linearize-and-
                     reduce kernel and its three Schur kernels, and its
                     share of its bound), of the
                     1024-image scene, of one 1600x1200 photometric
                     PatchMatch solve and of the bench_sba SBA solve
                     (torch.profiler), and the device's busy share.

Prints one progress line per phase, a `{"kernels": [...]}` line, the
card's name and power limit, and as its last line
`{"ok": true, "device": {...}}`. Any failure exits non-zero without that
line; a run that outlives its deadline dumps its stacks and exits.
"""

from __future__ import annotations

import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEADLINE_S = 600
T0 = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BA_SOURCE = "sba_tpu_torch/csrc/ba_kernels.cuh"
REPLACES = {
    "fused_schur": "sba_tpu/ops/ba_kernels.py:945",
    "fused_reduce": "sba_tpu/ops/ba_kernels.py:1035",
    "schur_matvec": "sba_tpu/ops/ba_kernels.py:1171",
    "backsub": "sba_tpu/ops/ba_kernels.py:1298",
    "fused_cost": "sba_tpu/ops/ba_kernels.py:1381",
    "ncc_cost": "sba_tpu/mvs/patch_match.py:253",
    # B1-B4, the SBA map-gather probes: B1, B2 and B4 compute one
    # function (map_gather), B3 another (map_gather_pair).
    "map_gather_b1": "benchmarks/gather_micro.py:90",
    "map_gather_b2": "benchmarks/gather_micro.py:121",
    "map_gather_pair_b3": "benchmarks/gather_micro2.py:113",
    "map_gather_b4": "benchmarks/gather_micro2.py:145",
}
GATHER_SOURCE = "sba_tpu_torch/csrc/map_gather.cu"
SOURCES = dict({k: BA_SOURCE for k in REPLACES},
               ncc_cost="sba_tpu_torch/csrc/patch_match_kernels.cu",
               **{k: GATHER_SOURCE for k in REPLACES if "gather" in k})
# The kernel each B row times, and the probe entry that drives it.
PROBES = {"map_gather_b1": ("map_gather", "probe_flat"),
          "map_gather_b2": ("map_gather", "probe_rows"),
          "map_gather_pair_b3": ("map_gather_pair", "probe_pair"),
          "map_gather_b4": ("map_gather", "probe_take")}
# The probes' shape: 50 maps of 640x480 words, 7,526,400 samples.
PROBE_MAPS, PROBE_HW, PROBE_PER = 50, 640 * 480, 150_528
# bench.py:94 bench_sba: the scene and the solve (10 LM iterations,
# tolerances off).
SBA_SCENE = dict(num_images=50, image_size=(640, 480), focal=500.0,
                 pose_noise=0.003, seed=0)
SBA_OPT = dict(pixel_step=10, max_iterations=10, mode="soft",
               function_tolerance=0.0, gradient_tolerance=0.0,
               parameter_tolerance=0.0)
# The two-map path: the same scene at 12 labels (a palette over 8),
# cut to 20 images for time.
SBA_PAIR_SCENE = dict(SBA_SCENE, num_images=20, num_labels=12)
# The CLI's model: 8 images of the bench_sba scene.
SBA_CLI_SCENE = dict(SBA_SCENE, num_images=8)
# tests/test_ba_fused.py:28-40: a small distortion per camera model, so
# that every analytic head runs off its pinhole special case.
DISTORT = {
    2: {3: 0.02},
    3: {3: 0.02, 4: -0.005},
    4: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3},
    5: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3},
    6: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3, 8: 1e-3,
        9: 0.01, 10: -2e-3, 11: 5e-4},
    7: {4: 0.08},
    8: {3: 0.02},
    9: {3: 0.02, 4: -0.005},
    10: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3, 8: 1e-3, 9: -5e-4,
         10: 8e-4, 11: -6e-4},
}
HEAD_MODELS = tuple(range(3, 11))  # the heads after SIMPLE_RADIAL
# K2 at the 1024-image scene in both payload modes: RADIAL (5 parameters,
# the diagonal mode) and FULL_OPENCV (12, the 6x6 block mode); the other
# heads' implicit kernels run on MID.
K2_WIDE_MODELS = (3, 6)
OPENCV, FULL_OPENCV, THIN_PRISM_FISHEYE = 4, 6, 10
DENSE_KERNELS = ("fused_schur", "backsub", "fused_cost")
IMPLICIT_KERNELS = ("fused_reduce", "schur_matvec", "backsub", "fused_cost")
HEADLINE = dict(num_images=128, num_points=30_000, observations_per_point=7,
                pose_noise=0.005, point_noise=0.02, pixel_noise=0.5, seed=0)
# bench.py:195 bench_ba_large and bench.py:223 bench_ba_10k.
LARGE = dict(num_images=1024, num_points=120_000, track_len=7,
             pose_noise=0.005, point_noise=0.02, pixel_noise=0.5, seed=0)
HUGE = dict(LARGE, num_images=10_240, num_points=1_200_000)
# More than 128 images (the implicit path) at the 1024-image scene's
# points per image.
MID = dict(LARGE, num_images=160, num_points=18_750)
# The CLI's float64 model: 256 images and 60,000 points, whose whitened
# couplings (6*256 + 12) * 3 * 60,000 * 8 B = 2.23 GB pass the explicit
# step's 2 GiB (optim/ba.py EXPLICIT_SCHUR_MAX_BYTES): the PCG step.
CLI_F64 = dict(num_images=256, num_points=60_000, observations_per_point=6,
               seed=5)
# The dense MVS scene: 8 rendered views at the PatchMatch image cap of
# COLMAP's medium-quality preset (1600 px), SIMPLE_RADIAL lens; sba_tpu's
# PatchMatch defaults (window radius 3, 8 iterations, 2 random samples,
# 4 sources per view, photometric then geometric pass).
MVS_SCENE = dict(num_images=8, image_size=(1600, 1200),
                 model_name="SIMPLE_RADIAL", extra_params=(-0.05,), seed=0)
NCC_CASES = ((3, 1), (5, 1), (3, 2))      # (window radius, window step)
NCC_SOURCE_CHUNK = 4     # sources K6 stages per chunk (csrc kSrc)
# Times of the kernels' first designs (a block per tile and source for
# K6; a thread per point with a float atomic per lane and row for K1, K2
# and K3, and per outer-product entry for K1's S_corr; a thread per point
# walking its slots for K4; a thread per sample with the default cache
# policy for map_gather) at the timing phase's shapes, on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md kernel table), printed beside the current
# times.
WAS_MS = {"ncc_cost": 0.6771, "schur_matvec": 0.2602, "fused_schur": 2.3427,
          "fused_reduce": 1.7302, "backsub": 0.2238, "map_gather": 0.0750}
# K1's CUDA kernels by part, for the profile phase's split; its device
# time in all is held against its bound there.
K1_PARTS = {"K1a linearize-and-reduce": r"k12_reduce_kernel",
            "K1b Schur": r"k1b_\w+_kernel",
            "K1": r"k12_reduce_kernel|k1b_\w+_kernel"}
# sba_tpu's PatchMatch scores a hypothesis by its depth alone (the normal
# cancels in the collapsed warp), so its normals are not fitted and
# fusion's 10-degree normal test leaves next to no points; the smoke
# fuses on depth consistency across 3 views alone.
FUSION_FLAGS = ("--StereoFusion.max_normal_error", "180")
# Limits on the scene's depth maps against the heightfield (means over
# the views, utils/mvs_accuracy.py) and on the fused cloud's size, set
# from the maps measured on an H100 with a margin. At sba_tpu's defaults
# the search does not converge (PERF.md section 6): the median and p80
# errors of its maps are no better than those of its random initial
# maps, so those two limits only cap a regression. The valid shares,
# the shares within 1% and the cloud's size are what the solve gains
# over its start; their limits lie between the measured maps and the
# random initial ones (0 iterations), which fail them.
MAP_LIMITS = {
    "photometric": dict(valid=0.97, median=0.385, p80=0.545, within1=0.012),
    "geometric": dict(valid=0.002, median=0.25, p80=0.40, within1=0.04),
}
MIN_FUSED_POINTS = 30
# bench.py's solve settings: a fixed iteration count.
FIXED_IT = dict(dtype="float32", cg_iterations=100, function_tolerance=0.0,
                gradient_tolerance=0.0, parameter_tolerance=0.0)


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


# Largest err / (tol * scale) over all twin comparisons, and where.
WORST = {"ratio": 0.0, "name": ""}


def close(name, got, ref, tol):
    """|got - ref| <= tol * max|ref|; returns the absolute error."""
    err = max_err(got, ref)
    scale = float(ref.double().abs().max())
    ratio = err / (tol * max(scale, 1e-30))
    if ratio > WORST["ratio"]:
        WORST.update(ratio=ratio, name=name)
    require(ratio <= 1.0,
            f"{name}: max |err| {err:.3e} > {tol:g} * {scale:.3e}")
    return err


def model_params(model_id):
    """Camera model `model_id`'s parameters at the scenes' focal length
    and image size, with DISTORT's terms."""
    import numpy as np

    from sba_tpu_torch.geometry import camera_models

    p = np.array(camera_models.model_by_id(model_id).init_params(
        500.0, 640, 480), np.float64)
    for i, val in DISTORT.get(model_id, {}).items():
        p[i] = val
    return p


def headline_problem(model_id, device):
    """The headline scene seen through camera model `model_id` (models
    3-10 observe through DISTORT's terms)."""
    import torch

    from sba_tpu_torch.utils.synthetic import make_ba_problem

    params = model_params(model_id) if model_id >= 3 else None
    problem, _ = make_ba_problem(model_id=model_id, dtype=torch.float32,
                                 device=device, params=params, **HEADLINE)
    if model_id == 2:  # a small radial term, so the head's k1 path runs
        cam = problem.cam_params.clone()
        cam[:, 3] = 0.02
        problem = problem._replace(cam_params=cam)
    return problem


def free_intrinsics(problem):
    """`problem` with every camera parameter free (the focal length and
    the extra parameters are then refined, as bundle_adjuster does), so
    that the kernels' camera rows carry the heads' derivatives."""
    import torch

    return problem._replace(free_cam=torch.ones_like(problem.free_cam))


def require_path(launches, kernels, other):
    """Every kernel of the path launched, and none of the other path."""
    require(all(launches[k] > 0 for k in kernels),
            f"a kernel of the path never launched: {launches}")
    require(all(launches[k] == 0 for k in other if k not in kernels),
            f"a kernel of the other path launched: {launches}")


def large_problem(spec=LARGE, model_id=0):
    """A sequential scene (SIMPLE_PINHOLE, or camera model `model_id`
    with `model_params`)."""
    from sba_tpu_torch.utils.synthetic import make_sequential_ba_problem

    params = model_params(model_id) if model_id else None
    problem, _ = make_sequential_ba_problem(device="cuda", model_id=model_id,
                                            params=params, **spec)
    return problem


def phase_build():
    from sba_tpu_torch.ops import cuda_build

    nvcc = cuda_build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log("build", f"nvcc {nvcc}: {ver[-1] if ver else '?'}")
    t = time.perf_counter()
    path, compiler_log = cuda_build.build()
    dt = time.perf_counter() - t
    # One line per kernel: its registers and spills (ptxas -v), the BA
    # kernels by template arguments (model or NP, then mode or type).
    entry, spill = None, ""
    for line in compiler_log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            k = re.search(r"(k12_reduce|k1b_\w+?|k3_matvec|k4_backsub|"
                          r"k5_cost)_kernel(.*)", entry)
            if k:
                entry = (f"{k.group(1)}<"
                         + ",".join(re.findall(r"Li(\d+)E", k.group(2))
                                    + ["bf16"] * ("bfloat16" in k.group(2)))
                         + ">")
        elif "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "registers" in line and entry:
            log("build", f"ptxas {entry}: {line.split(':', 1)[-1].strip()}; "
                f"{spill}")
            entry = None
    cuda_build.lib()
    log("build", f"built {path.name} in {dt:.1f} s")


def _bucket_inputs(problem, opt, lam_value=1e-3):
    """Prepared buckets + the per-iteration inputs of the kernels."""
    from sba_tpu_torch.optim import ba_fused

    return _step_inputs(ba_fused.prepare(problem, opt), lam_value)


def _step_inputs(ctx, lam_value=1e-3):
    """(ctx, par, lam, du_pose_t, du_cam_t) of a prepared context: the
    kernels' inputs at the problem's parameters, with a random step."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk

    statics, lays, pts0, idxs, prob, _, _ = ctx
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    lam = torch.tensor(lam_value, dtype=torch.float32, device=par.device)
    gen = torch.Generator(device="cpu").manual_seed(1)
    lay0 = lays[0]
    du_pose_t = torch.zeros(6, lay0.Npad)
    du_pose_t[:, :lay0.N] = 1e-3 * torch.randn(6, lay0.N, generator=gen)
    du_cam_t = torch.zeros(12, lay0.C)
    du_cam_t[:lay0.nparams] = 1e-2 * torch.randn(lay0.nparams, lay0.C,
                                                 generator=gen)
    return (ctx, par, lam, du_pose_t.to(par.device),
            du_cam_t.to(par.device))


def _check_dense_twins(tag, st, lay, par, pts, lam, dup, duc, opt):
    """The dense path's kernels against their twins on one bucket: K1,
    K4 on K1's point payload and jw, and K5. Returns the max abs errors
    (S_corr, dp, cost)."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk

    out_k = bk.fused_schur(st, par, pts, lam, lay, opt)
    out_p = bk.fused_schur_plain(st, par, pts, lam, lay, opt)
    torch.cuda.synchronize()
    s_k, img_k, ey_k, pt_k, jw_k = out_k
    s_p, img_p, ey_p, pt_p, jw_p = out_p
    # Payloads: 1e-5 of each row group's scale; S/Ey 3e-5 (the f32
    # tolerances of tests/test_ba_fused.py). Rows through the damped 3x3
    # point inverse (Hpp^-1, Lp, WL, dp): 1e-4, since a point seen once
    # has a rank-2 Hpp whose inverse amplifies f32 rounding by up to
    # 1/lambda (tests/test_torch_ba_kernels).
    for r0, r1, tol in ((0, 3, 1e-5), (3, 6, 1e-5), (6, 12, 1e-4),
                        (12, 18, 1e-4), (18, 19, 1e-5)):
        close(f"{tag} pt_pay[{r0}:{r1}]", pt_k[r0:r1], pt_p[r0:r1], tol)
    n_jac = 18 + 2 * lay.nparams
    for r in range(lay.JW):
        close(f"{tag} jw[{r}]", jw_k[r], jw_p[r],
              1e-5 if r < n_jac else 1e-4)
    np_ = lay.nparams
    ofs = [0, 6, 42, 42 + 6 * np_, 42 + 7 * np_, lay.DI]
    for a0, a1 in zip(ofs[:-1], ofs[1:]):
        close(f"{tag} img_red[:, {a0}:{a1}]", img_k[:, a0:a1],
              img_p[:, a0:a1], 1e-5)
    e1 = close(f"{tag} S_corr", s_k, s_p, 3e-5)
    require(torch.equal(s_k, s_k.T), f"{tag} S_corr is not exactly symmetric")
    close(f"{tag} ey", ey_k, ey_p, 3e-5)
    del out_p, s_p, s_k
    dp_k, acc_k = bk.backsub(st, dup, duc, pt_k, jw_k, lam, lay, opt)
    dp_p, acc_p = bk.backsub_plain(st, dup, duc, pt_k, jw_k, lam, lay, opt)
    torch.cuda.synchronize()
    e4 = close(f"{tag} dp", dp_k, dp_p, 1e-4)
    for i in range(3):
        close(f"{tag} acc[{i}]", acc_k[i:i + 1], acc_p[i:i + 1], 1e-4)
    c_k = bk.fused_cost(st, par, pts, lay, opt)
    c_p = bk.fused_cost_plain(st, par, pts, lay, opt)
    e5 = close(f"{tag} cost", c_k.reshape(1), c_p.reshape(1), 1e-4)
    return e1, e4, e5


def phase_twins():
    """Each kernel against its twin on identical CUDA inputs."""
    import torch

    from sba_tpu_torch.optim import ba_fused
    from sba_tpu_torch.optim.ba import BAOptions
    from sba_tpu_torch.utils.synthetic import make_ba_problem

    errs = {"fused_schur": 0.0, "backsub": 0.0, "fused_cost": 0.0}
    for model_id in (0, 2):
        opt = BAOptions(model_id=model_id, dtype="float32", schur_bf16=False)
        problem = headline_problem(model_id, "cuda")
        ctx, par, lam, dup, duc = _bucket_inputs(problem, opt)
        statics, lays, pts0 = ctx[0], ctx[1], ctx[2]
        for b, (st, lay, pts) in enumerate(zip(statics, lays, pts0)):
            e1, e4, e5 = _check_dense_twins(f"m{model_id} b{b}", st, lay,
                                            par, pts, lam, dup, duc, opt)
            for name, e in zip(DENSE_KERNELS, (e1, e4, e5)):
                errs[name] = max(errs[name], e)
            log("twins", f"model {model_id} bucket {b} (K={lay.K}, "
                f"Pp={lay.Pp}): K1/K4/K5 match their twins; |dS| "
                f"{e1:.2e} |ddp| {e4:.2e} |dcost| {e5:.2e}")

    # A small solve through the kernels against the same solve through
    # the twins on the CPU (the port's parity tolerance with sba_tpu).
    small = dict(num_images=6, num_points=150, observations_per_point=4,
                 pose_noise=0.01, point_noise=0.05, pixel_noise=0.5, seed=0)
    opt = BAOptions(max_iterations=25, dtype="float32", schur_bf16=False)
    res = {}
    for dev in ("cuda", "cpu"):
        problem, _ = make_ba_problem(dtype=torch.float32, device=dev,
                                     **small)
        out, s = ba_fused.bundle_adjust_fused(problem, opt)
        res[dev] = (float(s.final_cost), out.qvecs.cpu(), out.tvecs.cpu())
    rel = abs(res["cuda"][0] - res["cpu"][0]) / res["cpu"][0]
    dq = max_err(res["cuda"][1], res["cpu"][1])
    dt = max_err(res["cuda"][2], res["cpu"][2])
    require(rel <= 1e-3 and dq <= 5e-3 and dt <= 5e-3,
            f"small solve kernels vs twins: cost rel {rel:.2e}, "
            f"|dq| {dq:.2e}, |dt| {dt:.2e}")
    # bf16 S_corr (the default) must reach the f32 optimum
    # (tests/test_ba_fused.py::test_fused_converges_bf16 level).
    problem, _ = make_ba_problem(dtype=torch.float32, device="cuda", **small)
    out16, s16 = ba_fused.bundle_adjust_fused(
        problem, BAOptions(max_iterations=25, dtype="float32"))
    d16 = max_err(out16.tvecs, res["cuda"][2].cuda())
    require(float(s16.final_cost) < float(s16.initial_cost) and d16 <= 5e-3,
            f"bf16 solve: tvecs differ from f32 by {d16:.2e}")
    log("twins", f"small solve cuda vs cpu twins: cost rel {rel:.2e}, "
        f"|dq| {dq:.2e}, |dt| {dt:.2e}; bf16 vs f32 |dt| {d16:.2e}")
    log("twins", f"closest to its tolerance: {WORST['name']} at "
        f"{WORST['ratio']:.3f} of it")
    return errs


def _check_implicit_twins(tag, st, lay, par, pts, lam, dup, duc, opt):
    """The implicit path's kernels against their twins on one bucket:
    K2, then K3 on K2's couplings, K4 on K2's point payload and jw, and
    K5. Returns the max abs errors (image payload, matvec, dp, cost)."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk

    img_k, pt_k, jw_k, jc_k = bk.fused_reduce(st, par, pts, lam, lay, opt)
    img_p, pt_p, jw_p, jc_p = bk.fused_reduce_plain(st, par, pts, lam, lay,
                                                    opt)
    torch.cuda.synchronize()
    # Tolerances of tests/test_torch_ba_implicit.py: 1e-5 of scale, 1e-4
    # for rows computed through the damped 3x3 point inverse.
    for r0, r1, tol in ((0, 3, 1e-5), (3, 6, 1e-5), (6, 12, 1e-4),
                        (12, 18, 1e-4), (18, 19, 1e-5)):
        close(f"{tag} pt_pay[{r0}:{r1}]", pt_k[r0:r1], pt_p[r0:r1], tol)
    n_jac = 18 + 2 * lay.nparams
    for r in range(lay.JW):
        close(f"{tag} jw[{r}]", jw_k[r], jw_p[r], 1e-5 if r < n_jac else 1e-4)
    np_ = lay.nparams
    ofs = [0, 6, 42, 42 + 6 * np_, 42 + 7 * np_, lay.DI, lay.DI + 6,
           lay.DI + 6 + np_, lay.DI_implicit - np_, lay.DI_implicit]
    e2 = 0.0
    for k, (a0, a1) in enumerate(zip(ofs[:-1], ofs[1:])):
        e2 = max(e2, close(f"{tag} img_red[:, {a0}:{a1}]", img_k[:, a0:a1],
                           img_p[:, a0:a1], 1e-5 if k < 5 else 1e-4))
    # jcorr is the kernel's own couplings (jw's WL rows, held against the
    # twin above): in f32 a view of those rows, in bf16 their round to
    # nearest even, which it must equal exactly.
    require(jc_k.dtype == bk.jcorr_dtype(lay, opt) == jc_p.dtype
            and tuple(jc_k.shape) == (lay.JC, lay.Pp * lay.K),
            f"{tag} jcorr {jc_k.dtype} {tuple(jc_k.shape)}")
    wl = jw_k[n_jac:n_jac + lay.JC]
    require(torch.equal(jc_k, wl.to(jc_k.dtype))
            and (jc_k.dtype == torch.bfloat16
                 or jc_k.data_ptr() == wl.data_ptr()),
            f"{tag} jcorr is not jw's couplings")
    m_k = bk.schur_matvec(st, dup, duc, jc_k, lay, opt)
    m_p = bk.schur_matvec_plain(st, dup, duc, jc_k, lay, opt)
    torch.cuda.synchronize()
    e3 = close(f"{tag} matvec", m_k, m_p, 3e-5)
    del m_k, m_p, jc_p, jw_p, img_p, img_k
    # K4 on the point payload and jw that K2 wrote, K5 at the same
    # parameters: phase twins' tolerances.
    dp_k, acc_k = bk.backsub(st, dup, duc, pt_k, jw_k, lam, lay, opt)
    dp_p, acc_p = bk.backsub_plain(st, dup, duc, pt_k, jw_k, lam, lay, opt)
    torch.cuda.synchronize()
    e4 = close(f"{tag} dp", dp_k, dp_p, 1e-4)
    for i in range(3):
        close(f"{tag} acc[{i}]", acc_k[i:i + 1], acc_p[i:i + 1], 1e-4)
    c_k = bk.fused_cost(st, par, pts, lay, opt)
    c_p = bk.fused_cost_plain(st, par, pts, lay, opt)
    e5 = close(f"{tag} cost", c_k.reshape(1), c_p.reshape(1), 1e-4)
    return e2, e3, e4, e5


def _k3_windows(st, lay):
    """K3's block windows on a bucket, as a phrase (the kernel sums each
    block's scatter over chunks of K3_WINDOW images)."""
    from sba_tpu_torch.ops import ba_kernels as bk

    _, _, chunks = bk.schur_matvec_windows(st, lay)
    n = int((chunks > 0).sum())
    multi = int((chunks > 1).sum())
    return (f"blocks {n}, of which {multi} needed more than one window "
            f"chunk of {bk.K3_WINDOW} images (at most {int(chunks.max())})")


def _check_k3_permuted(tag, st, lay, par, pts, lam, dup, duc, opt):
    """K3 against its twin on the bucket with its image ids permuted: no
    locality, so every block's window spans several chunks."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.utils.synthetic import spread_image_ids

    jc = bk.fused_reduce(st, par, pts, lam, lay, opt)[3]
    perm = torch.as_tensor(spread_image_ids(lay.N), device="cuda")
    stp = st._replace(obs_img=perm[st.obs_img.long()].contiguous())
    _, _, chunks = bk.schur_matvec_windows(stp, lay)
    require(bool((chunks[chunks > 0] > 1).all()),
            f"{tag} permuted: a block's window fits one chunk")
    m_k = bk.schur_matvec(stp, dup, duc, jc, lay, opt)
    m_p = bk.schur_matvec_plain(stp, dup, duc, jc, lay, opt)
    torch.cuda.synchronize()
    e = close(f"{tag} permuted matvec", m_k, m_p, 3e-5)
    log("twins-implicit", f"{tag} image ids permuted: K3 matches its twin, "
        f"|dmatvec| {e:.2e}; {_k3_windows(stp, lay)}")
    return e


def _check_k2_spread(tag, st, lay, par, pts, lam, opt):
    """K2 against its twin on the bucket with its images renamed by
    `spread_image_ids` (the same function, no image locality): every
    block's payload window spans several chunks. Returns the image
    payload's max abs error."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.utils.synthetic import (rename_images,
                                               spread_image_ids)

    sts, pars = rename_images(st, par, spread_image_ids(lay.N))
    _, _, chunks = bk.fused_reduce_windows(sts, lay)
    live = chunks > 0
    require(bool((chunks[live] > 1).all()),
            f"{tag} spread: a block's payload window fits one chunk")
    img_k, pt_k, jw_k, jc_k = bk.fused_reduce(sts, pars, pts, lam, lay, opt)
    img_p, pt_p, jw_p, jc_p = bk.fused_reduce_plain(sts, pars, pts, lam, lay,
                                                    opt)
    torch.cuda.synchronize()
    e = close(f"{tag} spread img_red", img_k, img_p, 1e-4)
    close(f"{tag} spread pt_pay", pt_k, pt_p, 1e-4)
    close(f"{tag} spread jw", jw_k, jw_p, 1e-4)
    close(f"{tag} spread jcorr", jc_k.float(), jc_p.float(),
          2.0 ** -8 if jc_k.dtype == torch.bfloat16 else 1e-4)
    log("twins-implicit", f"{tag} images renamed by spread_image_ids: K2 "
        f"matches its twin, |dimg_red| {e:.2e}; blocks {int(live.sum())}, "
        f"of which {int((chunks > 1).sum())} took more than one payload "
        f"window chunk of {bk.K12_WINDOW} images (at most "
        f"{int(chunks.max())})")
    return e


def _fold(errs, e2345):
    for name, e in zip(IMPLICIT_KERNELS, e2345):
        errs[name] = max(errs[name], e)


def two_camera_problem(device):
    """Odd images use a second camera that starts off-truth
    (tests/test_ba_fused.py::_two_camera_problem)."""
    import numpy as np
    import torch

    from sba_tpu_torch.optim.ba import problem_from_numpy
    from sba_tpu_torch.utils.synthetic import make_ba_problem_numpy

    f, _ = make_ba_problem_numpy(
        num_images=6, num_points=120, observations_per_point=4,
        pose_noise=0.01, point_noise=0.05, seed=9)
    f["cam_params"] = np.tile(f["cam_params"], (2, 1))
    f["cam_params"][1, 0] = 520.0
    f["image_cam"] = np.arange(6, dtype=np.int32) % 2
    f["obs_cam"] = f["image_cam"][f["obs_image"]]
    f["free_cam"] = np.ones((2, 12))
    return problem_from_numpy(f, device, torch.float32)


def phase_twins_implicit(errs):
    """K2-K5 against their twins at the 1024-image scene, f32 and bf16
    coupling stores, and on a two-camera scene."""
    import torch

    from sba_tpu_torch.optim import ba_fused
    from sba_tpu_torch.optim.ba import BAOptions

    problem = large_problem()
    errs.update(fused_reduce=0.0, schur_matvec=0.0)
    for ranged in ("off", "on"):
        opt = BAOptions(dtype="float32", fused_ranged=ranged)
        ctx, par, lam, dup, duc = _bucket_inputs(problem, opt)
        for b, (st, lay, pts) in enumerate(zip(ctx[0], ctx[1], ctx[2])):
            tag = f"1024 ranged={ranged} b{b}"
            e = _check_implicit_twins(tag, st, lay, par, pts, lam, dup,
                                      duc, opt)
            _fold(errs, e)
            log("twins-implicit", f"{tag} (K={lay.K}, Pp={lay.Pp}, jcorr "
                f"{str(ba_fused.bk.jcorr_dtype(lay, opt))[6:]}): K2-K5 match "
                f"their twins; |dimg_red| {e[0]:.2e} |dmatvec| {e[1]:.2e} "
                f"|ddp| {e[2]:.2e} |dcost| {e[3]:.2e}; K3 "
                f"{_k3_windows(st, lay)}")
            e3 = _check_k3_permuted(tag, st, lay, par, pts, lam, dup, duc,
                                    opt)
            errs["schur_matvec"] = max(errs["schur_matvec"], e3)
            e2 = _check_k2_spread(tag, st, lay, par, pts, lam, opt)
            errs["fused_reduce"] = max(errs["fused_reduce"], e2)
    del problem, ctx
    # Two cameras: the camera rows of the payload and of the matvec are
    # keyed by image and summed by camera in the epilogue.
    opt = BAOptions(dtype="float32", schur_bf16=False, matvec_bf16=False,
                    fused_mode="implicit", cg_iterations=200,
                    cg_tolerance=1e-9)
    steps = {}
    for dev in ("cuda", "cpu"):
        problem = two_camera_problem(dev)
        ctx, par, lam, dup, duc = _bucket_inputs(problem, opt)
        statics, lays, pts0, _, prob, _, free_arrays = ctx
        if dev == "cuda":
            for b, (st, lay, pts) in enumerate(zip(statics, lays, pts0)):
                _fold(errs, _check_implicit_twins(
                    f"2-camera b{b}", st, lay, par, pts, lam, dup, duc,
                    opt))
        steps[dev] = [v.cpu() if torch.is_tensor(v) else v for v in
                      ba_fused._fused_step(statics, lays, opt, prob.qvecs,
                                           prob.tvecs, pts0, prob.cam_params,
                                           lam, free_arrays)]
    for i, name, tol in ((0, "u_pose", 1e-3), (1, "u_cam", 1e-3)):
        close(f"2-camera step {name}", steps["cuda"][i], steps["cpu"][i],
              tol)
    for i, name in ((3, "predicted"), (4, "g_inf")):
        close(f"2-camera step {name}", steps["cuda"][i].reshape(1),
              steps["cpu"][i].reshape(1), 1e-4)
    log("twins-implicit", "2-camera scene: K2-K5 match their twins; the "
        "implicit step on the card matches the CPU twins' step; closest "
        f"to its tolerance so far: {WORST['name']} at {WORST['ratio']:.3f}")


def phase_main():
    """The fused path at full width through `bundle_adjust`."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.optim import ba_fused
    from sba_tpu_torch.optim.ba import BAOptions, bundle_adjust

    problem = headline_problem(0, "cuda")
    opt = BAOptions(max_iterations=10, dtype="float32",
                    function_tolerance=0.0, gradient_tolerance=0.0,
                    parameter_tolerance=0.0)
    torch.cuda.reset_peak_memory_stats()
    bk.reset_launches()
    t = time.perf_counter()
    out, s = bundle_adjust(problem, opt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(bk.LAUNCHES)
    c0, c1 = float(s.initial_cost), float(s.final_cost)
    require_path(launches, DENSE_KERNELS, IMPLICIT_KERNELS)
    require(c1 < c0, f"cost did not decrease: {c0} -> {c1}")
    for name, v in (("qvecs", out.qvecs), ("tvecs", out.tvecs),
                    ("points", out.points)):
        require(bool(torch.isfinite(v).all()), f"non-finite {name}")
    require(tuple(out.points.shape) == (HEADLINE["num_points"], 3),
            f"points shape {tuple(out.points.shape)}")
    log("main", f"bundle_adjust 128 img / {problem.points.shape[0]} pts / "
        f"{problem.obs_image.shape[0]} obs: cost {c0:.6g} -> {c1:.6g} in "
        f"{s.num_iterations} it, {wall:.2f} s incl. prep; launches "
        f"{json.dumps(launches)}")

    torch.cuda.synchronize()
    t = time.perf_counter()
    ctx = ba_fused.prepare(problem, opt)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t
    ba_fused.solve_prepared(ctx)            # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, s2 = ba_fused.solve_prepared(ctx)
    float(s2.final_cost)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    its = s2.num_iterations
    log("main", f"host prep (ba_fused.prepare) {t_prep * 1e3:.1f} ms; "
        f"warm solve_prepared: {its} LM it in {dt * 1e3:.1f} ms = "
        f"{its / dt:.2f} LM it/s, {dt * 1e3 / its:.2f} ms/it; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches, ctx, dt * 1e3 / its


def phase_main_implicit():
    """The implicit path at full width (bench.py:195) through
    `bundle_adjust`: 1024 images, 120,000 points, track 7."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.optim import ba_fused
    from sba_tpu_torch.optim.ba import BAOptions, bundle_adjust

    problem = large_problem()
    opt = BAOptions(max_iterations=10, **FIXED_IT)
    torch.cuda.reset_peak_memory_stats()
    bk.reset_launches()
    t = time.perf_counter()
    out, s = bundle_adjust(problem, opt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(bk.LAUNCHES)
    c0, c1 = float(s.initial_cost), float(s.final_cost)
    require_path(launches, IMPLICIT_KERNELS, DENSE_KERNELS)
    require(c1 < c0, f"cost did not decrease: {c0} -> {c1}")
    for name, v in (("qvecs", out.qvecs), ("tvecs", out.tvecs),
                    ("points", out.points)):
        require(bool(torch.isfinite(v).all()), f"non-finite {name}")
    require(tuple(out.points.shape) == (LARGE["num_points"], 3),
            f"points shape {tuple(out.points.shape)}")
    its = s.num_iterations
    log("main-implicit", f"bundle_adjust 1024 img / "
        f"{problem.points.shape[0]} pts / {int(problem.obs_mask.sum())} "
        f"live obs: cost {c0:.6g} -> {c1:.6g} in {its} it, {wall:.2f} s "
        f"incl. prep; launches {json.dumps(launches)}; K3 launches per LM "
        f"iteration {launches['schur_matvec'] / its:.1f}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    ctx = ba_fused.prepare(problem, opt)
    ba_fused.solve_prepared(ctx)            # warm
    torch.cuda.synchronize()
    bk.reset_launches()
    t = time.perf_counter()
    _, s2 = ba_fused.solve_prepared(ctx)
    float(s2.final_cost)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    its = s2.num_iterations
    k3_per_it = bk.LAUNCHES["schur_matvec"] / its
    log("main-implicit", f"warm solve_prepared: {its} LM it in "
        f"{dt * 1e3:.1f} ms = {its / dt:.2f} LM it/s, {dt * 1e3 / its:.2f} "
        f"ms/it; K3 launches per LM iteration {k3_per_it:.1f}")
    return launches, ctx, dt * 1e3 / its, k3_per_it


def phase_large_ranged(errs):
    """bench.py:223 bench_ba_10k: 10,240 images, 1.2M points, track 7;
    Npad >= 2048, so ranged and bf16 couplings come on by themselves.
    K2-K5 are also held against their twins at these shapes."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.optim import ba_fused
    from sba_tpu_torch.optim.ba import BAOptions

    t = time.perf_counter()
    problem = large_problem(HUGE)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t
    opt = BAOptions(max_iterations=3, **FIXED_IT)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ctx = ba_fused.prepare(problem, opt)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t
    lay = ctx[1][0]
    require(lay.ranged and ba_fused.use_implicit(lay, opt)
            and bk.jcorr_dtype(lay, opt) == torch.bfloat16,
            f"10k scene not ranged/bf16: {lay}")
    bk.reset_launches()
    t = time.perf_counter()
    out, s = ba_fused.solve_prepared(ctx)
    c0, c1 = float(s.initial_cost), float(s.final_cost)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t
    launches = dict(bk.LAUNCHES)
    require_path(launches, IMPLICIT_KERNELS, DENSE_KERNELS)
    require(c1 < c0, f"10k cost did not decrease: {c0} -> {c1}")
    require(bool(torch.isfinite(out.tvecs).all()
                 and torch.isfinite(out.points).all()), "10k: non-finite")
    its = s.num_iterations
    log("large-ranged", f"10240 img / {problem.points.shape[0]} pts / "
        f"{problem.obs_image.shape[0]} obs (Npad {lay.Npad}, ranged, bf16 "
        f"jcorr): scene {t_gen:.1f} s, host prep {t_prep:.1f} s, solve "
        f"{its} LM it in {t_solve:.2f} s (first call) = "
        f"{its / t_solve:.2f} LM it/s; cost {c0:.6g} -> {c1:.6g}; K3 "
        f"launches per LM iteration {launches['schur_matvec'] / its:.1f}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
        f" MiB")
    del out, s
    ctx, par, lam, dup, duc = _step_inputs(ctx)
    for b, (st, lay, pts) in enumerate(zip(ctx[0], ctx[1], ctx[2])):
        tag = f"10240 b{b}"
        e = _check_implicit_twins(tag, st, lay, par, pts, lam, dup, duc, opt)
        _fold(errs, e)
        log("large-ranged", f"{tag} (K={lay.K}, Pp={lay.Pp}, "
            f"{lay.Pp * lay.K} lanes, jcorr bf16): K2-K5 match their twins; "
            f"|dimg_red| {e[0]:.2e} |dmatvec| {e[1]:.2e} |ddp| {e[2]:.2e} "
            f"|dcost| {e[3]:.2e}; K3 {_k3_windows(st, lay)}; closest to "
            f"its tolerance so far: {WORST['name']} at "
            f"{WORST['ratio']:.3f}")


def phase_twins_heads(errs):
    """Camera models 3-10 (sba_tpu's analytic heads, DISTORT's terms):
    K1, K4 and K5 against their twins at the headline shapes; K2-K5 on
    an implicit bucket, the 1024-image scene for K2_WIDE_MODELS (both of
    K2's payload modes) and MID for the rest."""
    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.optim.ba import BAOptions

    for m in HEAD_MODELS:
        opt = BAOptions(model_id=m, dtype="float32", schur_bf16=False)
        ctx, par, lam, dup, duc = _bucket_inputs(
            free_intrinsics(headline_problem(m, "cuda")), opt)
        e = (0.0, 0.0, 0.0)
        for b, (st, lay, pts) in enumerate(zip(ctx[0], ctx[1], ctx[2])):
            eb = _check_dense_twins(f"m{m} b{b}", st, lay, par, pts, lam,
                                    dup, duc, opt)
            e = tuple(max(x, y) for x, y in zip(e, eb))
        for name, x in zip(DENSE_KERNELS, e):
            errs[name] = max(errs[name], x)
        log("twins-heads", f"model {m} (np {lay.nparams}) headline, "
            f"{len(ctx[1])} buckets: K1/K4/K5 match their twins; |dS| "
            f"{e[0]:.2e} |ddp| {e[1]:.2e} |dcost| {e[2]:.2e}")
        del ctx, par
        spec = LARGE if m in K2_WIDE_MODELS else MID
        opt = BAOptions(model_id=m, dtype="float32")
        ctx, par, lam, dup, duc = _bucket_inputs(
            free_intrinsics(large_problem(spec, m)), opt)
        for b, (st, lay, pts) in enumerate(zip(ctx[0], ctx[1], ctx[2])):
            e = _check_implicit_twins(f"m{m} {spec['num_images']} b{b}", st,
                                      lay, par, pts, lam, dup, duc, opt)
            _fold(errs, e)
        require(lay.BJ == (lay.nparams != 5),
                f"model {m}: K2 mode BJ={lay.BJ} at np {lay.nparams}")
        log("twins-heads", f"model {m} {spec['num_images']} images "
            f"(K2 {'block' if lay.BJ else 'diagonal'} mode, jcorr "
            f"{str(bk.jcorr_dtype(lay, opt))[6:]}): K2-K5 match their "
            f"twins; |dimg_red| {e[0]:.2e} |dmatvec| {e[1]:.2e} |ddp| "
            f"{e[2]:.2e} |dcost| {e[3]:.2e}")
        del ctx, par
    log("twins-heads", f"closest to its tolerance so far: {WORST['name']} "
        f"at {WORST['ratio']:.3f} of it")


def _solve_checked(tag, problem, opt, kernels, other):
    """`bundle_adjust` with the launch counts reset just before it: the
    path's kernels launch, the cost falls, every output is finite.
    Returns (summary, launches, seconds)."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.optim.ba import bundle_adjust

    torch.cuda.synchronize()
    bk.reset_launches()
    t = time.perf_counter()
    out, s = bundle_adjust(problem, opt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(bk.LAUNCHES)
    c0, c1 = float(s.initial_cost), float(s.final_cost)
    require_path(launches, kernels, other)
    require(c1 < c0, f"{tag}: cost did not decrease: {c0} -> {c1}")
    for name, v in (("qvecs", out.qvecs), ("tvecs", out.tvecs),
                    ("points", out.points), ("cam_params", out.cam_params)):
        require(bool(torch.isfinite(v).all()), f"{tag}: non-finite {name}")
    require(tuple(out.points.shape) == tuple(problem.points.shape),
            f"{tag}: points shape {tuple(out.points.shape)}")
    log("main-opencv", f"{tag}: bundle_adjust {problem.qvecs.shape[0]} img "
        f"/ {problem.points.shape[0]} pts / {int(problem.obs_mask.sum())} "
        f"live obs: cost {c0:.6g} -> {c1:.6g} in {s.num_iterations} it, "
        f"{wall:.2f} s incl. prep; launches {json.dumps(launches)}")
    return s, launches, wall


def phase_main_opencv():
    """The fused path through `bundle_adjust` with real-lens models: the
    OPENCV headline (dense: K1, K4, K5), the 1024-image OPENCV scene (10
    LM iterations, tolerances off; implicit: K2-K5) and short solves of
    the 12-parameter FULL_OPENCV and THIN_PRISM_FISHEYE headlines."""
    import torch

    from sba_tpu_torch.optim import ba_fused
    from sba_tpu_torch.optim.ba import BAOptions

    problem = free_intrinsics(headline_problem(OPENCV, "cuda"))
    opt = BAOptions(model_id=OPENCV, max_iterations=10, **FIXED_IT)
    _, launches, _ = _solve_checked("OPENCV headline", problem, opt,
                                    DENSE_KERNELS, IMPLICIT_KERNELS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ctx = ba_fused.prepare(problem, opt)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t
    ba_fused.solve_prepared(ctx)            # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, s2 = ba_fused.solve_prepared(ctx)
    float(s2.final_cost)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    its = s2.num_iterations
    log("main-opencv", f"OPENCV headline: host prep (ba_fused.prepare) "
        f"{t_prep * 1e3:.1f} ms; warm solve_prepared: {its} LM it in "
        f"{dt * 1e3:.1f} ms = {its / dt:.2f} LM it/s")
    del ctx

    problem = free_intrinsics(large_problem(LARGE, OPENCV))
    s, launches_i, _ = _solve_checked(
        "OPENCV 1024 images", problem, opt, IMPLICIT_KERNELS, DENSE_KERNELS)
    ctx = ba_fused.prepare(problem, opt)
    ba_fused.solve_prepared(ctx)            # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, s2 = ba_fused.solve_prepared(ctx)
    float(s2.final_cost)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    log("main-opencv", f"OPENCV 1024 images: warm solve_prepared: "
        f"{s2.num_iterations} LM it in {dt * 1e3:.1f} ms = "
        f"{s2.num_iterations / dt:.2f} LM it/s; K3 launches per LM "
        f"iteration {launches_i['schur_matvec'] / s.num_iterations:.1f}")
    del problem, ctx
    for m in (FULL_OPENCV, THIN_PRISM_FISHEYE):
        _solve_checked(f"model {m} headline",
                       free_intrinsics(headline_problem(m, "cuda")),
                       BAOptions(model_id=m, max_iterations=5, **FIXED_IT),
                       DENSE_KERNELS, IMPLICIT_KERNELS)
    return launches, launches_i


def phase_timing_heads():
    """K1 and K5 at the headline and K2 at the 1024-image scene, per LM
    iteration (all buckets), for OPENCV and FULL_OPENCV, each beside its
    bound (`_bounds`: the rows per lane, JW = 36 + 5 np, grow with np)."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.optim.ba import BAOptions
    from sba_tpu_torch.utils.kernel_timing import time_ms

    out = {}
    for m in (OPENCV, FULL_OPENCV):
        opt = BAOptions(model_id=m, dtype="float32")
        for scene, names in ((HEADLINE, ("fused_schur", "fused_cost")),
                             (LARGE, ("fused_reduce",))):
            problem = free_intrinsics(
                headline_problem(m, "cuda") if scene is HEADLINE
                else large_problem(LARGE, m))
            ctx, par, lam, _, _ = _bucket_inputs(problem, opt)
            groups = list(zip(ctx[0], ctx[1], ctx[2]))
            fns = {
                "fused_schur": lambda: [bk.fused_schur(st, par, p, lam, lay,
                                                       opt)
                                        for st, lay, p in groups],
                "fused_reduce": lambda: [bk.fused_reduce(st, par, p, lam,
                                                         lay, opt)
                                         for st, lay, p in groups],
                "fused_cost": lambda: [bk.fused_cost(st, par, p, lay, opt)
                                       for st, lay, p in groups]}
            bounds = _bounds(ctx[0], ctx[1], opt, names)
            for name in names:
                ms = time_ms(fns[name], 20)
                out[(m, name)] = (ms, bounds[name])
                log("timing", f"model {m} (np {ctx[1][0].nparams}, JW "
                    f"{ctx[1][0].JW}) {name} at {scene['num_images']} "
                    f"images: {ms:.4f} ms per LM iteration ({len(groups)} "
                    f"bucket launches), bound {bounds[name][0]:.4f} ms "
                    f"({bounds[name][1]}), {100 * bounds[name][0] / ms:.1f}% "
                    f"of it")
            del ctx, par, groups, fns
            torch.cuda.empty_cache()
    return out


def _run_cli(rec, tag, flags, kernels, other):
    """bundle_adjuster with `flags` in a subprocess on `rec`; checks the
    cost, the mean reprojection error and that the path's kernels (and
    no other) launched."""
    import numpy as np

    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.ops import cuda_build

    err0 = rec.compute_mean_reprojection_error()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="cli_smoke_",
                                 dir=cuda_build.BUILD_DIR))
    try:
        rec.write(str(work / "in"))
        cmd = [sys.executable, "-m", "sba_tpu_torch.cli", "bundle_adjuster",
               "--input_path", str(work / "in"),
               "--output_path", str(work / "out"), *flags]
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        budget = max(30.0, DEADLINE_S - (time.perf_counter() - T0) - 60.0)
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=budget)
        require(res.returncode == 0,
                f"CLI exit {res.returncode}:\n{res.stdout}\n{res.stderr}")
        m = re.search(r"BA: cost (\S+) -> (\S+) in (\d+) iters", res.stdout)
        k = re.search(r"kernel launches: (\{.*\})", res.stdout)
        require(m is not None and k is not None,
                f"unexpected CLI output:\n{res.stdout}")
        c0, c1 = float(m.group(1)), float(m.group(2))
        launches = json.loads(k.group(1))
        require(c1 < c0, f"CLI cost did not decrease: {c0} -> {c1}")
        require_path(launches, kernels, other)
        out = Reconstruction.read(str(work / "out"))
        out.update_point_errors()   # the file keeps the input's errors
        err1 = out.compute_mean_reprojection_error()
        require(len(out.images) == len(rec.images) and np.isfinite(err1)
                and err1 < err0,
                f"CLI model: mean reprojection error {err0} -> {err1}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("cli", f"{tag}: bundle_adjuster cost {c0:.6g} -> {c1:.6g} in "
        f"{m.group(3)} it; launches {json.dumps(launches)}; mean "
        f"reprojection error {err0:.4f} -> {err1:.4f} px")


def phase_cli():
    """The CLI in float32 on a 20-image model (dense path), a 160-image
    model (more than 128 images: the implicit path) and a 20-image
    OPENCV model (`--BundleAdjustment.model_id 4`: sba_tpu's CLI takes
    the camera model from that flag); then at its defaults (float64) on
    CLI_F64, whose couplings pass the explicit step's limit: 2 LM
    iterations of the PCG step, no kernel."""
    import numpy as np

    from sba_tpu_torch.optim import ba as ba_mod
    from sba_tpu_torch.utils.synthetic import make_synthetic_reconstruction

    f32 = ("--BundleAdjustment.dtype", "float32",
           "--BundleAdjustment.max_iterations", "20")
    for n_img, n_pts, model_id, kernels, other in (
            (20, 400, 0, DENSE_KERNELS, IMPLICIT_KERNELS),
            (160, 600, 0, IMPLICIT_KERNELS, DENSE_KERNELS),
            (20, 400, OPENCV, DENSE_KERNELS, IMPLICIT_KERNELS)):
        rec = make_synthetic_reconstruction(
            num_images=n_img, num_points=n_pts, seed=3, model_id=model_id,
            params=model_params(model_id) if model_id else None)
        rng = np.random.default_rng(3)
        for p in rec.points3D.values():
            p.xyz = p.xyz + rng.normal(scale=0.05, size=3)
        _run_cli(rec, f"{n_img} images, model {model_id}",
                 (*f32, "--BundleAdjustment.model_id", str(model_id)),
                 kernels, other)
    t = time.perf_counter()
    rec = make_synthetic_reconstruction(**CLI_F64)
    rng = np.random.default_rng(5)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(scale=0.05, size=3)
    arr = rec.to_arrays()
    need = ((6 * arr.num_images + 12 * len(arr.camera_ids)) * 3
            * arr.num_points * 8)
    require(need > ba_mod.EXPLICIT_SCHUR_MAX_BYTES,
            f"CLI_F64 couplings {need} B fit the explicit step")
    log("cli", f"float64 model: {arr.num_images} images, {arr.num_points} "
        f"points, {arr.num_observations} observations (built in "
        f"{time.perf_counter() - t:.1f} s); couplings {need / 1e9:.2f} GB "
        f"> {ba_mod.EXPLICIT_SCHUR_MAX_BYTES / 2**30:.0f} GiB: the PCG step")
    _run_cli(rec, "float64 PCG", ("--BundleAdjustment.max_iterations", "2"),
             (), IMPLICIT_KERNELS + DENSE_KERNELS)


def _mvs_problem(scene, ref, srcs, device):
    """One PatchMatch problem of a rendered scene as float32 tensors:
    (ref image, source images, K, Ks, Rs, ts, true depth of ref), with
    K the pinhole part of the lens."""
    import numpy as np
    import torch

    from sba_tpu_torch.mvs.patch_match import relative_pose

    p = scene["camera"]["params"]
    K = np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1.0]])
    imgs = scene["images"].astype(np.float32) / 255.0
    Rs, ts = zip(*[relative_pose(scene["qvecs"][ref], scene["tvecs"][ref],
                                 scene["qvecs"][s], scene["tvecs"][s])
                   for s in srcs])

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    return (f32(imgs[ref]), f32(imgs[list(srcs)]), f32(K),
            f32(np.stack([K] * len(srcs))), f32(np.stack(Rs)),
            f32(np.stack(ts)), f32(scene["depths"][ref]))


def phase_twins_mvs(scene):
    """K6 against its twin at the full shape; the card's hypothesis cost
    against the CPU twins'. Returns (max abs K6 error, K6's inputs)."""
    import torch

    from sba_tpu_torch.mvs import patch_match as pm
    from sba_tpu_torch.ops import patch_match_kernels as pk
    from sba_tpu_torch.utils.render import render_scene

    def warped(srcs_idx):
        ref, srcs, K, Ks, Rs, ts, depth = _mvs_problem(scene, 0, srcs_idx,
                                                       "cuda")
        packed = [pm._pack_intensity_nbhd(s) for s in srcs]
        v, inb = pm._warp_sources(ref, srcs, torch.linalg.inv(K), Ks, Rs,
                                  ts, depth, packed)
        v[3, :, :240] = 0.0        # one source with a band outside it
        inb[3, :, :240] = False
        return ref, v, inb

    # The main path's 4 sources at each window, then 7 sources (past
    # K6's chunk of NCC_SOURCE_CHUNK) at the main path's window. Bit for
    # bit, and within the reference's kernel-vs-XLA tolerance.
    ref, v, inb = warped((1, 2, 3, 4))
    err = 0.0
    cases = [(v, inb, r, step) for r, step in NCC_CASES]
    v7, inb7 = warped(tuple(range(1, 8)))[1:]
    require(v7.shape[0] > NCC_SOURCE_CHUNK, f"{v7.shape[0]} sources")
    cases.append((v7, inb7, 3, 1))
    for v_, inb_, r, step in cases:
        S, H, W = v_.shape
        c_k = pk.ncc_cost(ref, v_, inb_, r, step, 3.0, 0.2)
        c_p = pk.ncc_cost_plain(ref, v_, inb_, r, step, 3.0, 0.2)
        torch.cuda.synchronize()
        e = max_err(c_k, c_p)
        gated = int((c_k == 2.0).sum())
        require(e <= 2e-4, f"ncc_cost S={S} r={r} step={step}: max |err| "
                f"{e:.3e} > 2e-4")
        require(torch.equal(c_k, c_p), f"ncc_cost S={S} r={r} step={step}: "
                f"not bit-equal to its twin (max |err| {e:.3e})")
        require(0 < gated < c_k.numel(), f"ncc_cost S={S} r={r} "
                f"step={step}: {gated} gated pixels")
        err = max(err, e)
        log("twins-mvs", f"ncc_cost {S}x{H}x{W} r={r} step={step}: equals "
            f"its twin bit for bit, max |err| {e:.3e} (atol 2e-4), {gated} "
            f"pixels at cost 2.0")
    del v7, inb7, cases
    # The hypothesis cost on the card (packed u8 sampling + K6) against
    # the CPU twins (exact sampling + twin) on one depth state: on 8-bit
    # images the two samplers agree to float32 rounding, which NCC
    # amplifies by 1/sqrt(var_r var_v) in flat windows: atol 2e-3.
    small = render_scene(num_images=5, image_size=(320, 240), seed=1,
                         device="cuda")
    gen = torch.Generator().manual_seed(0)
    noise = 1.0 + 0.05 * (torch.rand(240, 320, generator=gen) - 0.5)
    normal = torch.zeros(240, 320, 3)
    normal[..., 2] = -1.0
    costs = {}
    for dev in ("cuda", "cpu"):
        r_, s_, K_, Ks_, Rs_, ts_, d_ = _mvs_problem(small, 2, (0, 1, 3, 4),
                                                     dev)
        costs[dev] = pm._cost_for_hypothesis(
            r_, s_, torch.linalg.inv(K_), Ks_, Rs_, ts_,
            d_ * noise.to(dev), normal.to(dev), pm.PatchMatchOptions(),
            src_packed=[pm._pack_intensity_nbhd(x) for x in s_]
            if dev == "cuda" else None)
    e = max_err(costs["cuda"].cpu(), costs["cpu"])
    require(e <= 2e-3, f"hypothesis cost card vs CPU twins: {e:.3e} > 2e-3")
    log("twins-mvs", f"_cost_for_hypothesis 240x320 x 4 sources, card vs "
        f"CPU twins: max |err| {e:.3e} (atol 2e-3)")
    return err, (ref, v, inb)


def phase_mvs(scene):
    """The dense chain through the CLI on the rendered scene, checked
    against the analytic heightfield; then one warm photometric solve in
    process. Returns (K6 launches of patch_match_stereo, the in-process
    solve as a callable, its warm wall ms)."""
    import numpy as np
    import torch

    from sba_tpu_torch.mvs import PatchMatchOptions, patch_match_stereo
    from sba_tpu_torch.ops import cuda_build
    from sba_tpu_torch.ops import patch_match_kernels as pk
    from sba_tpu_torch.utils import mvs_accuracy
    from sba_tpu_torch.utils.render import (_Heightfield,
                                            gt_sparse_reconstruction,
                                            write_scene_images)

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="mvs_smoke_",
                                 dir=cuda_build.BUILD_DIR))
    try:
        t = time.perf_counter()
        names = write_scene_images(scene, str(work / "images"))
        rec = gt_sparse_reconstruction(scene, names, stride=40)
        rec.write(str(work / "sparse"))
        log("mvs", f"wrote {len(names)} images and a sparse model of "
            f"{len(rec.points3D)} points in {time.perf_counter() - t:.1f} s")
        ws = work / "dense"
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        out = {}
        for args in (
                ["image_undistorter", "--image_path", work / "images",
                 "--input_path", work / "sparse", "--output_path", ws],
                ["patch_match_stereo", "--workspace_path", ws],
                ["stereo_fuser", "--workspace_path", ws, "--output_path",
                 ws / "fused.ply", *FUSION_FLAGS]):
            budget = max(30.0, DEADLINE_S - (time.perf_counter() - T0) - 60)
            t = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "sba_tpu_torch.cli",
                 *map(str, args), "--device", "cuda"], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=budget)
            dt = time.perf_counter() - t
            require(res.returncode == 0, f"{args[0]} exit {res.returncode}:"
                    f"\n{res.stdout}\n{res.stderr}")
            out[args[0]] = res.stdout
            lines = [l for l in res.stdout.splitlines()
                     if not l.startswith("wall seconds")]
            log("mvs", f"{args[0]} in {dt:.1f} s: " + " | ".join(
                l.strip() for l in lines[-4:]))
        k = re.search(r"kernel launches: (\{.*\})", out["patch_match_stereo"])
        w = re.search(r"wall seconds per view: (\{.*\})",
                      out["patch_match_stereo"])
        require(k is not None and w is not None,
                f"unexpected patch_match_stereo output:\n"
                f"{out['patch_match_stereo']}")
        launches = json.loads(k.group(1))["ncc_cost"]
        secs = json.loads(w.group(1))
        n_solves = len(secs["photometric"]) + len(secs["geometric"])
        require(n_solves == 2 * MVS_SCENE["num_images"],
                f"{n_solves} solves, not two per view: {secs}")
        require(launches > 0, "patch_match_stereo never launched K6")
        W, H = MVS_SCENE["image_size"]
        its = PatchMatchOptions().num_iterations
        for kind, per_view in secs.items():
            t_med = float(np.median(list(per_view.values())))
            log("mvs", f"{kind} pass: per-view wall s "
                + ", ".join(f"{v:.3f}" for v in per_view.values())
                + f"; median {t_med:.3f} s = "
                f"{H * W * its / t_med / 1e6:.2f} Mpix*iterations/s")
        log("mvs", f"K6 launches {launches} over {n_solves} solves = "
            f"{launches / n_solves:.1f} per solve")
        field = _Heightfield(5.0, 0.55, MVS_SCENE["seed"])
        for kind, a in mvs_accuracy.depth_map_accuracy(ws, field,
                                                       "cuda").items():
            lim = MAP_LIMITS[kind]
            log("mvs", f"{kind} depth maps vs the heightfield (means over "
                f"views): valid {a['valid']:.4f} (>= {lim['valid']}), "
                f"median |err| {a['median']:.4f} (<= {lim['median']}), "
                f"p80 {a['p80']:.4f} (<= {lim['p80']}), within 1% "
                f"{a['within1']:.4f} (>= {lim['within1']}) of the valid "
                "pixels")
            require(a["valid"] >= lim["valid"]
                    and a["median"] <= lim["median"]
                    and a["p80"] <= lim["p80"]
                    and a["within1"] >= lim["within1"],
                    f"{kind} depth maps outside their limits")
        xyz = mvs_accuracy.read_ply_xyz(ws / "fused.ply")
        c = mvs_accuracy.cloud_accuracy(xyz, field)
        md = float(np.median(scene["depths"]))
        log("mvs", f"fused {c['points']} points (>= {MIN_FUSED_POINTS}); "
            f"vertical distance to the heightfield: median "
            f"{c['median']:.5f}, p80 {c['p80']:.5f} (median depth "
            f"{md:.4f}: {100 * c['median'] / md:.3f}% and "
            f"{100 * c['p80'] / md:.3f}%)")
        require(c["points"] >= MIN_FUSED_POINTS and np.isfinite(xyz).all(),
                f"fused cloud: {c['points']} points")
        require(c["median"] < 0.01 * md and c["p80"] < 0.03 * md,
                "fused cloud off the heightfield")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # One warm photometric solve in process at the full shape (view 0
    # against views 1-4, the pinhole part of the lens, the true depths'
    # range widened as the CLI widens the sparse points').
    ref, srcs, K, Ks, Rs, ts, depth = _mvs_problem(scene, 0, (1, 2, 3, 4),
                                                   "cuda")
    opt = PatchMatchOptions(depth_min=0.5 * float(depth.min()),
                            depth_max=2.0 * float(depth.max()),
                            geom_consistency=False)

    def solve():
        patch_match_stereo(ref, srcs, K, Ks, Rs, ts, options=opt,
                           generator=torch.Generator("cuda").manual_seed(0))
        return 1

    solve()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launches()
    t = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    log("mvs", f"warm photometric solve {H}x{W} x 4 sources: {ms:.1f} ms "
        f"= {H * W * opt.num_iterations / ms / 1e3:.2f} Mpix*iterations/s, "
        f"{pk.LAUNCHES['ncc_cost']} K6 launches; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches, solve, ms


def _ncc_bound(S, H, W, r, step):
    """Least time of one K6 launch: max(bytes / HBM rate, operations /
    f32 rate). Bytes: ref, v (f32) and inb (u8) read once, cost written
    once. Operations (kernel source; a fused multiply-add is 2, expf 1):
    per tap, 11 that depend on the reference alone (the difference from
    the centre, its square and scaling, expf, the weight, w*r, SW, SR,
    SRR), which the function needs once per pixel, and 8 per source (w*v,
    SV, SVV, SRV, FIN); in the epilogue 5 per pixel and 15 per source."""
    K = (2 * r // step + 1) ** 2
    t_b = (H * W * 4 + S * H * W * (4 + 1 + 4)) / HBM_BYTES_PER_S
    t_f = H * W * (K * (11 + 8 * S) + 5 + 15 * S) / F32_FLOPS_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def phase_timing_mvs(inputs, launches, err):
    """K6 at the full shape (r=3, step 1): ms per launch, its twin's,
    its bound."""
    from sba_tpu_torch.ops import patch_match_kernels as pk
    from sba_tpu_torch.utils.kernel_timing import time_ms

    ref, v, inb = inputs
    S, H, W = v.shape
    ms = time_ms(lambda: pk.ncc_cost(ref, v, inb, 3, 1, 3.0, 0.2), 20)
    plain_ms = time_ms(lambda: pk.ncc_cost_plain(ref, v, inb, 3, 1, 3.0,
                                                 0.2), 3)
    bound = _ncc_bound(S, H, W, 3, 1)
    log("timing", f"ncc_cost ({S}x{H}x{W}, 49 taps): {ms:.4f} ms per "
        f"launch (was {WAS_MS['ncc_cost']:.4f} ms), twin {plain_ms:.3f} ms, "
        f"bound {bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.1f}% "
        f"of it")
    return {"ncc_cost": _kernel_row("ncc_cost", {"ncc_cost": launches},
                                    {"ncc_cost": err}, ms, plain_ms, bound)}


def _bounds(statics, lays, opt, kernels):
    """Least time of each kernel's work in one pass over all buckets (one
    LM iteration; one CG iteration for K3): max(bytes / HBM rate, flops /
    f32 rate). Bytes count each input the kernel needs once and each
    output once. Per-observation inputs are charged on the live lanes
    only, plus one read of the mask row over all lanes (padding lanes
    need nothing else); K1's/K2's `jw` and K2's bf16 `jcorr` are charged
    over all lanes, since their shapes are the interface's. Flops are counted
    from the kernel source per live observation, plus, for K1, the
    data-dependent S_corr outer products of this run's tracks. Returns
    {name: (ms, "bytes" or "operations")} for the named kernels."""
    import numpy as np
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk

    out = {}
    b1 = b2 = b3 = b4 = b5 = 0.0
    f1 = f2 = f3 = f4 = f5 = 0.0
    for st, lay in zip(statics, lays):
        O, Pp, NP = lay.Pp * lay.K, lay.Pp, lay.nparams
        mask = st.obs_sta[2].cpu().numpy() > 0
        live = float(mask.sum())
        imgs = st.obs_img.cpu().numpy().reshape(lay.nb, lay.K, lay.TP)
        cams = st.obs_cam.cpu().numpy().reshape(lay.nb, lay.K, lay.TP)
        m3 = mask.reshape(lay.nb, lay.K, lay.TP)
        par_b = (7 + NP) * lay.Npad * 4
        mask_b = O * 4
        # K2 reads what K1 reads; writes the implicit image payload, the
        # point payload, jw and, in bf16 only, jcorr ([JC, O']; in f32 K3
        # reads jw's coupling rows).
        bf16 = bk.jcorr_dtype(lay, opt) == torch.bfloat16
        jc_bytes = 2 if bf16 else 4
        b2 += (par_b + (4 + NP) * lay.Npad * 4 + 4 * Pp * 4 + mask_b
               + 4 * live * 4 + lay.Npad * lay.DI_implicit * 4
               + 19 * Pp * 4 + lay.JW * O * 4 + bf16 * lay.JC * O * 2)
        f2 += live * (120 + 30 + 3 * lay.DI_implicit + (6 + NP) * 22)
        # K3 (one matvec) reads the coupling rows, image and camera of
        # each live lane and the du tables; writes [Npad, 6+np].
        b3 += (6 * lay.Npad * 4 + 12 * lay.C * 4 + mask_b
               + (3 * (6 + NP) * jc_bytes + 2 * 4) * live
               + lay.Npad * (6 + NP) * 4)
        f3 += live * (3 * (6 + NP) * 2 + (6 + NP) * 6)
        rows = 0.0
        for b in range(lay.nb if "fused_schur" in kernels else 0):
            for p in range(lay.TP):
                sel = m3[b, :, p]
                ni = len(np.unique(imgs[b, sel, p]))
                nc = len(np.unique(cams[b, sel, p]))
                rows += (6 * ni + NP * nc) ** 2
        # K1 reads x, y, image and camera of each live lane; writes S,
        # the image payload, Ey, the point payload and jw.
        b1 += (par_b + (4 + NP) * lay.Npad * 4 + 4 * Pp * 4 + mask_b
               + 4 * live * 4 + lay.Dk * lay.Dk * 4 + lay.Npad * lay.DI * 4
               + lay.Dk * 4 + 19 * Pp * 4 + lay.JW * O * 4)
        # per live obs: projection + Jacobians ~120, point sums 30,
        # image payload 3*DI, whitening + Ey (6+NP)*(9+8+5)
        f1 += live * (120 + 30 + 3 * lay.DI + (6 + NP) * 22) + 5 * rows
        # K4 reads every jw row, the image and camera of each live lane.
        b4 += (6 * lay.Npad * 4 + 12 * lay.C * 4 + 19 * Pp * 4 + mask_b
               + (lay.JW + 2) * live * 4 + 3 * Pp * 4)
        f4 += live * (3 * (6 + NP) * 2 + 2 * (6 + NP + 3) * 2 + 2) + 40 * Pp
        # K5 reads x, y and image of each live lane.
        b5 += par_b + 3 * Pp * 4 + mask_b + 3 * live * 4
        f5 += live * 60
    for name, by, fl in (("fused_schur", b1, f1), ("fused_reduce", b2, f2),
                         ("schur_matvec", b3, f3), ("backsub", b4, f4),
                         ("fused_cost", b5, f5)):
        if name not in kernels:
            continue
        t_b, t_f = by / HBM_BYTES_PER_S, fl / F32_FLOPS_PER_S
        out[name] = (max(t_b, t_f) * 1e3,
                     "bytes" if t_b >= t_f else "operations")
    return out


def _kernel_row(name, launches, errs, ms, plain_ms, bound):
    return dict(name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=launches[name],
                max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None)


def phase_timing(ctx, launches, errs):
    """K1/K4/K5 at the headline: ms per LM iteration (all buckets), and
    the host's ms to enqueue one. K4 takes random nonzero du."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.utils.kernel_timing import host_ms, random_du, time_ms

    statics, lays, pts0, _, prob, opt, _ = ctx
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    lam = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    dup, duc = random_du(lays[0], 2)
    k1 = [bk.fused_schur(st, par, p, lam, lay, opt)
          for st, lay, p in zip(statics, lays, pts0)]
    groups = list(zip(statics, lays, pts0, k1))

    def run(fn):
        return lambda: [fn(st, lay, p, o) for st, lay, p, o in groups]

    fns = {
        "fused_schur": (
            run(lambda st, lay, p, o: bk.fused_schur(st, par, p, lam, lay,
                                                     opt)),
            run(lambda st, lay, p, o: bk.fused_schur_plain(st, par, p, lam,
                                                           lay, opt))),
        "backsub": (
            run(lambda st, lay, p, o: bk.backsub(st, dup, duc, o[3], o[4],
                                                 lam, lay, opt)),
            run(lambda st, lay, p, o: bk.backsub_plain(st, dup, duc, o[3],
                                                       o[4], lam, lay,
                                                       opt))),
        "fused_cost": (
            run(lambda st, lay, p, o: bk.fused_cost(st, par, p, lay, opt)),
            run(lambda st, lay, p, o: bk.fused_cost_plain(st, par, p, lay,
                                                          opt))),
    }
    bounds = _bounds(statics, lays, opt, tuple(fns))
    rows = {}
    for name, (kern, plain) in fns.items():
        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 3)
        rows[name] = _kernel_row(name, launches, errs, ms, plain_ms,
                                 bounds[name])
        was = (f" (was {WAS_MS[name]:.4f} ms)" if name in WAS_MS else "")
        log("timing", f"{name}: {ms:.4f} ms per LM iteration{was} "
            f"({len(groups)} bucket launches; host {host_ms(kern, 20):.4f}"
            f" ms to enqueue), twin {plain_ms:.3f} ms, "
            f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}), "
            f"{100 * bounds[name][0] / ms:.1f}% of it")
    return rows


def phase_timing_implicit(ctx, launches, errs, k3_per_it):
    """K2 and K3 at the 1024-image scene: K2 per LM iteration, K3 per
    matvec (one CG iteration; all buckets each)."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.utils.kernel_timing import host_ms, random_du, time_ms

    statics, lays, pts0, _, prob, opt, _ = ctx
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    lam = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    dup, duc = random_du(lays[0], 2)
    k2 = [bk.fused_reduce(st, par, p, lam, lay, opt)
          for st, lay, p in zip(statics, lays, pts0)]
    groups = list(zip(statics, lays, pts0, [o[3] for o in k2]))
    fns = {
        "fused_reduce": (
            lambda: [bk.fused_reduce(st, par, p, lam, lay, opt)
                     for st, lay, p, _ in groups],
            lambda: [bk.fused_reduce_plain(st, par, p, lam, lay, opt)
                     for st, lay, p, _ in groups]),
        "schur_matvec": (
            lambda: [bk.schur_matvec(st, dup, duc, jc, lay, opt)
                     for st, lay, _, jc in groups],
            lambda: [bk.schur_matvec_plain(st, dup, duc, jc, lay, opt)
                     for st, lay, _, jc in groups]),
    }
    bounds = _bounds(statics, lays, opt, tuple(fns))
    rows = {}
    for name, (kern, plain) in fns.items():
        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 3)
        rows[name] = _kernel_row(name, launches, errs, ms, plain_ms,
                                 bounds[name])
        unit = "LM iteration" if name == "fused_reduce" else "matvec"
        was = (f" (was {WAS_MS[name]:.4f} ms)" if name in WAS_MS else "")
        log("timing", f"{name} (1024 img): {ms:.4f} ms per {unit}{was} "
            f"({len(groups)} bucket launches; host {host_ms(kern, 20):.4f}"
            f" ms to enqueue), twin {plain_ms:.3f} ms, "
            f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}), "
            f"{100 * bounds[name][0] / ms:.1f}% of it")
    log("timing", f"schur_matvec per LM iteration of the 1024-image solve: "
        f"{k3_per_it:.1f} matvecs x {rows['schur_matvec']['ms']:.4f} ms = "
        f"{k3_per_it * rows['schur_matvec']['ms']:.3f} ms")
    # K4's second figure: the implicit path's bucket (its row keeps the
    # headline's).
    b4 = _bounds(statics, lays, opt, ("backsub",))["backsub"]
    ms4 = time_ms(lambda: [bk.backsub(st, dup, duc, o[1], o[2], lam, lay,
                                      opt)
                           for st, lay, o in zip(statics, lays, k2)], 20)
    log("timing", f"backsub (1024 img): {ms4:.4f} ms per LM iteration "
        f"({len(lays)} bucket launch, K = {lays[0].K}), bound "
        f"{b4[0]:.4f} ms ({b4[1]}), {100 * b4[0] / ms4:.1f}% of it")
    return rows


def _profile(label, solve, unit, parts=None, bounds=None):
    """Device time by kernel over one warm call of `solve` (which returns
    its count of `unit`s) under torch.profiler. Busy time sums the
    device-side events only (kernels, copies, sets): an aten op's own
    device total repeats the kernels it launched. `parts` maps a label to
    a kernel-name pattern whose summed device time per unit is logged,
    beside its share of `bounds[label]` (ms per unit) where given.
    Returns busy us per unit, or None when the profiler saw no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n = solve()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in kernels)
    if busy <= 0:
        log("profile", f"{label}: the profiler saw no device time: busy "
            "share not measured")
        return None
    ours = sum(dev_us(e) for e in kernels
               if re.search(r"\b(k[1-6]\w*|b_map_gather\w*)_kernel",
                            e.key))
    log("profile", f"{label}, {n} {unit}: device time {busy / 1e3:.2f} ms "
        f"= {busy / 1e3 / n:.3f} ms/{unit}; our CUDA kernels "
        f"{ours / 1e3 / n:.3f} ms/{unit}, all other device work "
        f"{(busy - ours) / 1e3 / n:.3f} ms/{unit} (profiled wall "
        f"{wall_us / 1e3:.1f} ms, inflated by the profiler)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log("profile", f"{dev_us(e) / 1e3:8.3f} ms {e.count:6d}x "
            f"{e.key[:70]}")
    for part, pattern in (parts or {}).items():
        sel = [e for e in kernels if re.search(pattern, e.key)]
        ms = sum(map(dev_us, sel)) / 1e3 / n
        share = ((bounds or {}).get(part) or 0.0) / ms if ms else 0.0
        log("profile", f"{label}: {part} {ms:.4f} ms/{unit} over "
            f"{sum(e.count for e in sel)} launches"
            + (f", {100 * share:.1f}% of its bound" if share else ""))
    return busy / n


def phase_profile(ctx, label, parts=None, bounds=None):
    """Device time by kernel over one warm BA solve."""
    from sba_tpu_torch.optim import ba_fused

    return _profile(label, lambda: ba_fused.solve_prepared(ctx)[1]
                    .num_iterations, "LM it", parts, bounds)


def _log_busy(label, dev_us_per_unit, ms_per_unit, unit="LM iteration"):
    if dev_us_per_unit:
        log("profile", f"{label}: device busy {dev_us_per_unit / 1e3:.3f} "
            f"ms of the {ms_per_unit:.3f} ms warm {unit} = "
            f"{100 * dev_us_per_unit / 1e3 / ms_per_unit:.1f}%")


def phase_mvs_scene():
    """The 8-view 1600x1200 scene, rendered on the card."""
    import torch

    from sba_tpu_torch.utils.render import render_scene

    t = time.perf_counter()
    scene = render_scene(device="cuda", **MVS_SCENE)
    torch.cuda.synchronize()
    log("mvs", f"rendered {MVS_SCENE['num_images']} views of "
        f"{MVS_SCENE['image_size']} ({MVS_SCENE['model_name']}) in "
        f"{time.perf_counter() - t:.1f} s")
    return scene


# ---------------------------------------------------------------------------
# Semantic bundle adjustment: the map-gather kernels B1-B4
# ---------------------------------------------------------------------------


def probe_inputs():
    """The probes' tables and indices on the card (u32 words as int32),
    from a seed: depth and label tables [50 * 640*480], local indices
    [50, 150,528]; plus the global int64 indices of the library call."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(0)
    n = PROBE_MAPS * PROBE_HW

    def words():
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), dtype=torch.int32,
                             generator=gen).cuda()

    depth, label = words(), words()
    il = torch.randint(0, PROBE_HW, (PROBE_MAPS, PROBE_PER),
                       dtype=torch.int32, generator=gen).cuda()
    gi = (il.long() + PROBE_HW * torch.arange(
        PROBE_MAPS, device="cuda")[:, None]).reshape(-1)
    inter = torch.stack([depth, label], -1).reshape(
        PROBE_MAPS, PROBE_HW // 64, 128).contiguous()
    return dict(depth=depth, label=label, il=il, gi=gi, inter=inter)


def probe_calls(inp):
    """{row: (kernel call, twin call, library call)} at the probes'
    shapes: B1 flat table, B2 its [rows, 128] view, B3 the interleaved
    depth|label table, B4 the [maps, rows, 128] view with [maps, 8,
    per / 8] indices. The library call is `torch.take` on global int64
    indices (B3: of the table viewed as int64, both words, no sum)."""
    import torch

    from sba_tpu_torch.ops import map_gather as mg

    d, il, gi, inter = inp["depth"], inp["il"], inp["gi"], inp["inter"]
    il3 = il.view(PROBE_MAPS, 8, PROBE_PER // 8)
    d3 = d.view(PROBE_MAPS, PROBE_HW // 128, 128)
    hw, per = PROBE_HW, PROBE_PER
    return {
        "map_gather_b1": (lambda: mg.probe_flat(d, il),
                          lambda: mg.map_gather_plain(d, il, per, hw),
                          lambda: torch.take(d, gi)),
        "map_gather_b2": (lambda: mg.probe_rows(d.view(-1, 128), il),
                          lambda: mg.map_gather_plain(d, il, per, hw),
                          lambda: torch.take(d, gi)),
        "map_gather_pair_b3": (
            lambda: mg.probe_pair(inter, il3),
            lambda: mg.map_gather_pair_plain(inter, il3, per, hw, True),
            lambda: torch.take(inter.view(torch.int64), gi)),
        "map_gather_b4": (lambda: mg.probe_take(d3, il3),
                          lambda: mg.map_gather_plain(d3, il3, per, hw),
                          lambda: torch.take(d, gi)),
    }


def _tangent_check(device):
    """Primal and x-tangent of the f64 samplers (bilinear_flat, label
    agreement) under forward mode on `device`, at the same points."""
    import numpy as np
    import torch
    import torch.autograd.forward_ad as fwAD

    from sba_tpu_torch.ops import interpolation as itp

    rng = np.random.default_rng(4)
    N, H, W = 4, 480, 640
    depth = torch.tensor(rng.uniform(1, 9, (N * H * W)), device=device)
    sem = torch.tensor(rng.integers(0, 5, (N * H * W)).astype(np.float64),
                       device=device)
    x = torch.tensor(rng.uniform(-3, W + 2, (N, 4096)), device=device)
    y = torch.tensor(rng.uniform(-3, H + 2, (N, 4096)), device=device)
    lab = torch.tensor(rng.integers(0, 5, (N, 4096)).astype(np.float64),
                       device=device)
    base = torch.arange(N, device=device, dtype=torch.int32)[:, None] * H * W
    out = []
    with fwAD.dual_level():
        xd = fwAD.make_dual(x, torch.ones_like(x))
        yd = fwAD.make_dual(y, 0.5 * torch.ones_like(y))
        for v in (itp.bilinear_flat(depth, H, W, base, xd, yd, fill=-1e6),
                  itp.bilinear_label_agreement_flat_raw(
                      sem, H, W, base, xd, yd, lab)):
            p, t = fwAD.unpack_dual(v)
            out += [p.cpu(), t.cpu()]
    return out


def phase_twins_sba():
    """map_gather / map_gather_pair against their twins on the same CUDA
    tensors (bit for bit), at the probes' shapes and in the path's flat
    form (4- and 8-byte words); the forward-mode tangent through the
    kernels against the CPU twins'. Returns (probe inputs, errors)."""
    import torch

    from sba_tpu_torch.ops import map_gather as mg

    inp = probe_inputs()
    errs = {}
    for row, (kern, plain, _) in probe_calls(inp).items():
        a, b = kern(), plain()
        require(a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b), f"{row}: kernel != twin")
        errs[row] = 0.0
    gen = torch.Generator(device="cpu").manual_seed(5)
    n = PROBE_MAPS * PROBE_HW
    flat = torch.randint(0, n, (1302, 3072), dtype=torch.int32,
                         generator=gen).cuda()
    f64 = torch.randn(n, dtype=torch.float64, generator=gen).cuda()
    for name, tab in (("int32", inp["depth"]),
                      ("float32", inp["depth"].view(torch.float32)),
                      ("float64", f64)):
        a, b = mg.map_gather(tab, flat), mg.map_gather_plain(tab, flat)
        bits = torch.int64 if tab.element_size() == 8 else torch.int32
        require(torch.equal(a.view(bits), b.view(bits)),
                f"map_gather flat form, {name} words: kernel != twin")
    pair = inp["inter"].view(-1, 2)
    require(torch.equal(mg.map_gather_pair(pair, flat),
                        mg.map_gather_pair_plain(pair, flat)),
            "map_gather_pair flat form: kernel != twin")
    card, cpu = _tangent_check("cuda"), _tangent_check("cpu")
    tan_err = max(max_err(a, b) for a, b in zip(card, cpu))
    require(tan_err <= 1e-12, f"forward mode through the kernels: "
            f"{tan_err:.3e} from the CPU twins")
    require(all(float(t.abs().max()) > 0 for t in card[1::2]),
            "forward mode: a tangent is zero everywhere")
    log("twins-sba", f"B1-B4 probes and the flat form (4- and 8-byte "
        f"words, pair) bit-equal to their twins; forward-mode primal and "
        f"tangent {tan_err:.2e} from the CPU twins'; launches "
        f"{json.dumps(mg.LAUNCHES)}")
    return inp, errs


def _pose_errors(q, t, q_gt, t_gt):
    """(largest rotation angle in degrees, largest translation error)."""
    import numpy as np

    q = np.asarray(q, np.float64)
    d = np.abs(np.sum(q * q_gt, axis=-1)) / np.linalg.norm(q, axis=-1)
    ang = 2 * np.degrees(np.arccos(np.clip(d, -1.0, 1.0)))
    return float(ang.max()), float(np.abs(np.asarray(t) - t_gt).max())


def _sba_solve_on_card(scene, opt, tag):
    """Build and solve one SBA problem on the card. Gates: the cost, the
    rotation error against the truth and the hard label mismatches fall.
    The translation error is printed, not gated: sba_tpu's own solve
    raises it over the first iterations, trading it against the rotation
    (tests/test_torch_sba.py::test_pose_errors_track_sba_tpu_640x480).
    Returns (problem, summary, launches)."""
    import torch

    from sba_tpu_torch.ops import map_gather as mg
    from sba_tpu_torch.optim.sba import (build_sba_problem, evaluate_hard,
                                         semantic_bundle_adjust)

    q_gt, t_gt, cam, depth, sem, q0, t0 = scene
    problem = build_sba_problem(q0, t0, cam, depth, sem, opt,
                                dtype=torch.float32, device="cuda")
    mis0 = int(evaluate_hard(problem, opt)["num_label_mismatch"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mg.reset_launches()
    t = time.perf_counter()
    out, s = semantic_bundle_adjust(problem, opt)
    c0, c1 = float(s.initial_cost), float(s.final_cost)
    wall = time.perf_counter() - t
    launches = dict(mg.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    require(c1 < c0, f"{tag}: SBA cost did not decrease: {c0} -> {c1}")
    for name, v in (("qvecs", out.qvecs), ("tvecs", out.tvecs)):
        require(bool(torch.isfinite(v).all()), f"{tag}: non-finite {name}")
    e0 = _pose_errors(q0, t0, q_gt, t_gt)
    e1 = _pose_errors(out.qvecs.cpu(), out.tvecs.cpu(), q_gt, t_gt)
    mis1 = int(s.num_label_mismatch)
    require(e1[0] < e0[0] and mis1 < mis0,
            f"{tag}: rotation error {e0[0]} -> {e1[0]} deg, hard label "
            f"mismatches {mis0} -> {mis1}")
    log("sba", f"{tag}: {problem.pair_src.shape[0]} pairs x "
        f"{problem.pix_xy.shape[0]} pixels: cost {c0:.6g} -> {c1:.6g} in "
        f"{s.num_iterations} it, {wall:.2f} s cold; rotation error "
        f"{e0[0]:.4f} -> {e1[0]:.4f} deg, translation {e0[1]:.5f} -> "
        f"{e1[1]:.5f}; hard label mismatches {mis0} -> {mis1}; "
        f"launches {json.dumps(launches)}; peak {peak:.1f} MiB")
    return problem, s, launches


def phase_sba():
    """The bench_sba solve at full width (joint path), the 12-label
    two-map path, and a small solve on the card against the CPU twins.
    Returns (map_gather launches of the bench_sba solve, its problem and
    options, warm ms of the 10-iteration solve per LM iteration,
    map_gather_pair launches of the two-map solve)."""
    import numpy as np
    import torch

    from sba_tpu_torch.optim import sba as tsba
    from sba_tpu_torch.utils.synthetic import make_sba_scene

    t = time.perf_counter()
    scene = make_sba_scene(**SBA_SCENE)
    log("sba", f"bench_sba scene ({SBA_SCENE['num_images']} x "
        f"{SBA_SCENE['image_size']}) made on the host in "
        f"{time.perf_counter() - t:.1f} s")
    opt = tsba.SBAOptions(**SBA_OPT)
    problem, s, launches = _sba_solve_on_card(scene, opt, "bench_sba")
    require(problem.joint_packed is not None, "bench_sba: not joint-packed")
    chunks = -(-problem.pair_src.shape[0] // tsba._chunk_size(problem, opt))
    lins = s.num_iterations + 1
    require(launches["map_gather"] >= lins * chunks,
            f"map_gather launched {launches['map_gather']} times for "
            f"{lins} linearizations of {chunks} chunks")
    require(launches["map_gather_pair"] == 0,
            "the joint path launched map_gather_pair")
    del scene

    def run(n_it):
        o = tsba.SBAOptions(**dict(SBA_OPT, max_iterations=n_it))
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, s = tsba.semantic_bundle_adjust(problem, o)
        float(s.final_cost)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(2)
    t10 = [run(10) for _ in range(3)]
    t2 = [run(2) for _ in range(3)]
    m10, m2 = float(np.median(t10)), float(np.median(t2))
    ms_it = (m10 - m2) / 8 * 1e3
    log("sba", f"warm 10-iteration solves {[round(x * 1e3, 1) for x in t10]}"
        f" ms, median {m10 * 1e3:.1f} ms = {10 / m10:.2f} LM it/s with its "
        f"fixed costs; 2-iteration median {m2 * 1e3:.1f} ms; per LM "
        f"iteration (10 - 2) / 8 = {ms_it:.2f} ms = {1e3 / ms_it:.2f} LM "
        f"it/s; map_gather launches per LM iteration "
        f"{launches['map_gather'] / s.num_iterations:.1f} ({chunks} "
        f"chunks per linearization)")

    t = time.perf_counter()
    scene2 = make_sba_scene(**SBA_PAIR_SCENE)
    log("sba", f"12-label scene ({SBA_PAIR_SCENE['num_images']} images) "
        f"made in {time.perf_counter() - t:.1f} s")
    p2, _, l2 = _sba_solve_on_card(scene2, opt, "12 labels, two-map path")
    require(p2.pair_packed is not None and l2["map_gather_pair"] > 0,
            f"two-map path: map_gather_pair launches {l2}")
    del scene2, p2

    # A small solve through the kernels against the CPU twins
    # (tests/test_sba.py:245's scene, float32, analytic).
    small = make_sba_scene(num_images=4, image_size=(64, 48),
                           pose_noise=0.01, seed=11)
    o = tsba.SBAOptions(pixel_step=4, max_iterations=15)
    res = {}
    for dev in ("cuda", "cpu"):
        p = tsba.build_sba_problem(small[5], small[6], *small[2:5], o,
                                   dtype=torch.float32, device=dev)
        out, s_small = tsba.semantic_bundle_adjust(p, o)
        res[dev] = (float(s_small.final_cost), out.tvecs.cpu(),
                    out.qvecs.cpu())
    gap_c = abs(res["cuda"][0] - res["cpu"][0]) / res["cpu"][0]
    gap_t = max(max_err(res["cuda"][i], res["cpu"][i]) for i in (1, 2))
    require(gap_c <= 1e-3 and gap_t <= 5e-3,
            f"small solve: card vs CPU cost {gap_c:.3e}, poses {gap_t:.3e}")
    log("sba", f"small solve (4 x 64x48, f32): card vs CPU twins final "
        f"cost {gap_c:.2e} relative, poses {gap_t:.2e}")
    return launches, (problem, opt), m10 * 1e3 / 10, l2


def _write_sba_workspace(work, scene):
    """A SIMPLE_PINHOLE model of the scene's initial poses + TIFF maps."""
    import numpy as np

    from sba_tpu_torch.geometry import camera_models
    from sba_tpu_torch.io.colmap_models import Camera, Image
    from sba_tpu_torch.io.maps import write_float_map_tiff
    from sba_tpu_torch.models.reconstruction import Reconstruction

    q_gt, t_gt, cam, depth, sem, q0, t0 = scene
    n, h, w = depth.shape
    rec = Reconstruction()
    sp = camera_models.model_by_name("SIMPLE_PINHOLE").model_id
    rec.add_camera(Camera(camera_id=1, model_id=sp, width=w, height=h,
                          params=np.asarray(cam[0], np.float64)))
    (work / "maps").mkdir(parents=True)
    for i in range(n):
        rec.add_image(Image(image_id=i + 1, qvec=q0[i], tvec=t0[i],
                            camera_id=1, name=f"im{i}.png",
                            xys=np.zeros((0, 2)),
                            point3D_ids=np.zeros(0, np.int64)),
                      registered=True)
        write_float_map_tiff(depth[i], work / "maps" / f"im{i}_depth.tiff")
        write_float_map_tiff(sem[i], work / "maps" / f"im{i}_semantic.tiff")
    rec.write(str(work / "in"))


def phase_cli_sba():
    """semantic_bundle_adjuster on the card: defaults (float64, forward
    mode) and hard_numeric."""
    from sba_tpu_torch.ops import cuda_build
    from sba_tpu_torch.utils.synthetic import make_sba_scene

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="cli_sba_",
                                 dir=cuda_build.BUILD_DIR))
    try:
        _write_sba_workspace(work, make_sba_scene(**SBA_CLI_SCENE))
        for tag, extra in (("defaults", ()),
                           ("hard_numeric", (
                               "--SemanticBundleAdjustment.mode",
                               "hard_numeric",
                               "--SemanticBundleAdjustment.max_iterations",
                               "5"))):
            cmd = [sys.executable, "-m", "sba_tpu_torch.cli",
                   "semantic_bundle_adjuster", "--device", "cuda",
                   "--input_path", str(work / "in"),
                   "--output_path", str(work / f"out_{tag}"),
                   "--data_path", str(work / "maps"), *extra]
            env = dict(os.environ, PYTHONPATH=str(ROOT))
            budget = max(30.0, DEADLINE_S - (time.perf_counter() - T0) - 60)
            t = time.perf_counter()
            res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=budget)
            wall = time.perf_counter() - t
            require(res.returncode == 0, f"CLI exit {res.returncode}:\n"
                    f"{res.stdout}\n{res.stderr}")
            m = re.search(r"SBA: cost (\S+) -> (\S+) in (\d+) iters",
                          res.stdout)
            k = re.search(r"kernel launches: (\{.*\})", res.stdout)
            require(m is not None and k is not None,
                    f"unexpected CLI output:\n{res.stdout}")
            c0, c1 = float(m.group(1)), float(m.group(2))
            launches = json.loads(k.group(1))
            require(c1 < c0, f"CLI {tag}: cost did not decrease: {c0} -> "
                    f"{c1}")
            require(launches["map_gather"] > 0,
                    f"CLI {tag}: map_gather never launched")
            log("cli-sba", f"{tag}: cost {c0:.6g} -> {c1:.6g} in "
                f"{m.group(3)} it, {wall:.1f} s wall; launches "
                f"{json.dumps(launches)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _gather_bound(inp):
    """Least time of each probe's work: the table words this run's
    indices touch (4 bytes each; 8 for B3's pairs), the 4-byte indices
    read once and the outputs written once, over the HBM rate (a gather
    does no arithmetic to speak of). Also returns, for the record, the
    least time at the granularity device memory moves (the 32-byte
    sectors the touched words lie in) and over the whole table."""
    import torch

    gi = inp["gi"]
    touched = int(torch.unique(gi).numel())
    n = inp["il"].numel()
    out = {}
    for row, (kernel, _) in PROBES.items():
        word = 8 if kernel == "map_gather_pair" else 4
        sectors = int(torch.unique(gi // (32 // word)).numel())
        ms = [(t + n * 8) / HBM_BYTES_PER_S * 1e3
              for t in (touched * word, sectors * 32,
                        PROBE_MAPS * PROBE_HW * word)]
        out[row] = (ms[0], "bytes", ms[1], ms[2])
    return out, touched


def phase_timing_sba(inp, launches, errs):
    """B1-B4 at the probes' shapes: kernel, twin and library ms, and the
    bound."""
    from sba_tpu_torch.utils.kernel_timing import time_ms

    bounds, touched = _gather_bound(inp)
    rows = {}
    for row, (kern, plain, library) in probe_calls(inp).items():
        ms = time_ms(kern, 50)
        plain_ms = time_ms(plain, 5)
        lib_ms = time_ms(library, 50)
        rows[row] = _kernel_row(row, {row: launches[PROBES[row][0]]}, errs,
                                ms, plain_ms, bounds[row][:2])
        rows[row]["library_ms"] = lib_ms
        kernel = PROBES[row][0]
        was = (f" (was {WAS_MS[kernel]:.4f} ms)" if kernel in WAS_MS
               else "")
        log("timing", f"{row} ({PROBES[row][1]}, {PROBE_MAPS} x "
            f"{PROBE_HW} words, {inp['il'].numel()} samples): {ms:.4f} ms"
            f"{was}, twin {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{bounds[row][0]:.4f} ms ({touched} table words touched), "
            f"{100 * bounds[row][0] / ms:.1f}% of it; "
            f"{bounds[row][2]:.4f} ms over their 32-byte sectors, "
            f"{bounds[row][3]:.4f} ms over the whole table")
    return rows


def phase_profile_sba(problem, opt):
    """Device time by kernel over one warm 10-iteration bench_sba
    solve."""
    from sba_tpu_torch.optim.sba import semantic_bundle_adjust

    return _profile("bench_sba SBA", lambda: semantic_bundle_adjust(
        problem, opt)[1].num_iterations, "LM it")


def main() -> int:
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("start", f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(name, f"phase done in {time.perf_counter() - t:.1f} s")
        return out

    run("build", phase_build)
    errs = run("twins", phase_twins)
    run("twins-implicit", phase_twins_implicit, errs)
    run("twins-heads", phase_twins_heads, errs)
    launches, ctx, ms_per_it = run("main", phase_main)
    launches_i, ctx_i, ms_per_it_i, k3_per_it = run("main-implicit",
                                                    phase_main_implicit)
    run("main-opencv", phase_main_opencv)
    run("large-ranged", phase_large_ranged, errs)
    run("cli", phase_cli)
    scene = run("mvs", phase_mvs_scene)
    ncc_err, ncc_inputs = run("twins-mvs", phase_twins_mvs, scene)
    ncc_launches, pm_solve, pm_ms = run("mvs", phase_mvs, scene)
    del scene
    probe_in, gather_errs = run("twins-sba", phase_twins_sba)
    gather_launches, sba_ctx, sba_ms, pair_launches = run("sba", phase_sba)
    gather_launches["map_gather_pair"] = pair_launches["map_gather_pair"]
    run("cli-sba", phase_cli_sba)
    rows = run("timing", phase_timing, ctx, launches, errs)
    rows.update(run("timing", phase_timing_implicit, ctx_i, launches_i,
                    errs, k3_per_it))
    run("timing", phase_timing_heads)
    rows.update(run("timing", phase_timing_mvs, ncc_inputs, ncc_launches,
                    ncc_err))
    del ncc_inputs
    rows.update(run("timing", phase_timing_sba, probe_in, gather_launches,
                    gather_errs))
    del probe_in
    k1_bound = {"K1": rows["fused_schur"]["bound_ms"]}
    for label, c, ms, parts in (
            ("headline (dense)", ctx, ms_per_it, K1_PARTS),
            ("1024 images (implicit)", ctx_i, ms_per_it_i, None)):
        _log_busy(label, run("profile", phase_profile, c, label, parts,
                             k1_bound), ms)
    label = "PatchMatch photometric 1600x1200"
    _log_busy(label, run("profile", _profile, label, pm_solve, "solve"),
              pm_ms, "solve")
    _log_busy("bench_sba SBA", run("profile", phase_profile_sba, *sba_ctx),
              sba_ms)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    require(bool(smi), "nvidia-smi printed nothing")
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # noqa: BLE001 - report and fail the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
