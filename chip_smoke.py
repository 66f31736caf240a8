"""On-card smoke run of the PyTorch/CUDA port (sba_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (found through torch's CUDA_HOME, else
/usr/local/cuda). It builds the hand-written kernels from csrc/, then:

1. build    -- nvcc version and path, build time, ptxas resource lines;
2. twins    -- K1/K4/K5 against their plain PyTorch twins on the same
               CUDA tensors at the headline shapes (128 images, 30,000
               points, ~7 observations per point), models 0 and 2;
               a small solve through the kernels against the same solve
               through the twins on the CPU, and bf16 against f32 S_corr;
3. main     -- `bundle_adjust` on the headline problem in float32 (the
               fused path), cost must fall and every kernel must launch;
               LM it/s of a warm `solve_prepared`;
4. cli      -- `python -m sba_tpu_torch.cli bundle_adjuster` on a small
               synthetic model in a subprocess;
5. timing   -- per-kernel CUDA-event times against the twins and the
               memory/compute bound;
6. profile  -- device time by kernel over one warm solve
               (torch.profiler) and the device's busy share.

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
SOURCE = "sba_tpu_torch/csrc/ba_kernels.cu"
REPLACES = {
    "fused_schur": "sba_tpu/ops/ba_kernels.py:945",
    "backsub": "sba_tpu/ops/ba_kernels.py:1298",
    "fused_cost": "sba_tpu/ops/ba_kernels.py:1381",
}
HEADLINE = dict(num_images=128, num_points=30_000, observations_per_point=7,
                pose_noise=0.005, point_noise=0.02, pixel_noise=0.5, seed=0)


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


def headline_problem(model_id, device):
    import torch

    from sba_tpu_torch.utils.synthetic import make_ba_problem

    problem, _ = make_ba_problem(model_id=model_id, dtype=torch.float32,
                                 device=device, **HEADLINE)
    if model_id == 2:  # a small radial term, so the head's k1 path runs
        cam = problem.cam_params.clone()
        cam[:, 3] = 0.02
        problem = problem._replace(cam_params=cam)
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
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line.lower():
            log("build", "ptxas " + line.strip())
    cuda_build.lib()
    log("build", f"built {path.name} in {dt:.1f} s")


def _bucket_inputs(problem, opt, lam_value=1e-3):
    """Prepared buckets + the per-iteration inputs of the three kernels."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.optim import ba_fused

    ctx = ba_fused.prepare(problem, opt)
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


def phase_twins():
    """Each kernel against its twin on identical CUDA inputs."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
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
            out_k = bk.fused_schur(st, par, pts, lam, lay, opt)
            out_p = bk.fused_schur_plain(st, par, pts, lam, lay, opt)
            torch.cuda.synchronize()
            s_k, img_k, ey_k, pt_k, jw_k = out_k
            s_p, img_p, ey_p, pt_p, jw_p = out_p
            # Payloads: 1e-5 of each row group's scale; S/Ey 3e-5 (the
            # f32 tolerances of tests/test_ba_fused.py). Rows through the
            # damped 3x3 point inverse (Hpp^-1, Lp, WL, dp): 1e-4, since
            # a point seen once has a rank-2 Hpp whose inverse amplifies
            # f32 rounding by up to 1/lambda (tests/test_torch_ba_kernels).
            for r0, r1, tol in ((0, 3, 1e-5), (3, 6, 1e-5), (6, 12, 1e-4),
                                (12, 18, 1e-4), (18, 19, 1e-5)):
                close(f"m{model_id} b{b} pt_pay[{r0}:{r1}]", pt_k[r0:r1],
                      pt_p[r0:r1], tol)
            n_jac = 18 + 2 * lay.nparams
            for r in range(lay.JW):
                close(f"m{model_id} b{b} jw[{r}]", jw_k[r], jw_p[r],
                      1e-5 if r < n_jac else 1e-4)
            np_ = lay.nparams
            ofs = [0, 6, 42, 42 + 6 * np_, 42 + 7 * np_, lay.DI]
            for a0, a1 in zip(ofs[:-1], ofs[1:]):
                close(f"m{model_id} b{b} img_red[:, {a0}:{a1}]",
                      img_k[:, a0:a1], img_p[:, a0:a1], 1e-5)
            e1 = close(f"m{model_id} b{b} S_corr", s_k, s_p, 3e-5)
            close(f"m{model_id} b{b} ey", ey_k, ey_p, 3e-5)
            errs["fused_schur"] = max(errs["fused_schur"], e1)

            dp_k, acc_k = bk.backsub(st, dup, duc, pt_k, jw_k, lam, lay, opt)
            dp_p, acc_p = bk.backsub_plain(st, dup, duc, pt_k, jw_k, lam,
                                           lay, opt)
            torch.cuda.synchronize()
            e4 = close(f"m{model_id} b{b} dp", dp_k, dp_p, 1e-4)
            for i in range(3):
                close(f"m{model_id} b{b} acc[{i}]", acc_k[i:i + 1],
                      acc_p[i:i + 1], 1e-4)
            errs["backsub"] = max(errs["backsub"], e4)

            c_k = bk.fused_cost(st, par, pts, lay, opt)
            c_p = bk.fused_cost_plain(st, par, pts, lay, opt)
            e5 = close(f"m{model_id} b{b} cost", c_k.reshape(1),
                       c_p.reshape(1), 1e-4)
            errs["fused_cost"] = max(errs["fused_cost"], e5)
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
    require(all(v > 0 for v in launches.values()),
            f"a kernel never launched on the main path: {launches}")
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

    ctx = ba_fused.prepare(problem, opt)
    ba_fused.solve_prepared(ctx)            # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, s2 = ba_fused.solve_prepared(ctx)
    float(s2.final_cost)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    its = s2.num_iterations
    log("main", f"warm solve_prepared: {its} LM it in {dt * 1e3:.1f} ms = "
        f"{its / dt:.2f} LM it/s, {dt * 1e3 / its:.2f} ms/it; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches, ctx, dt * 1e3 / its


def phase_cli():
    import numpy as np

    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.ops import cuda_build
    from sba_tpu_torch.utils.synthetic import make_synthetic_reconstruction

    rec = make_synthetic_reconstruction(num_images=20, num_points=400,
                                        seed=3)
    rng = np.random.default_rng(3)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(scale=0.05, size=3)
    err0 = rec.compute_mean_reprojection_error()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="cli_smoke_",
                                 dir=cuda_build.BUILD_DIR))
    try:
        rec.write(str(work / "in"))
        cmd = [sys.executable, "-m", "sba_tpu_torch.cli", "bundle_adjuster",
               "--input_path", str(work / "in"),
               "--output_path", str(work / "out"),
               "--BundleAdjustment.dtype", "float32",
               "--BundleAdjustment.max_iterations", "20"]
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
        require(all(v > 0 for v in launches.values()),
                f"CLI run did not launch every kernel: {launches}")
        out = Reconstruction.read(str(work / "out"))
        out.update_point_errors()   # the file keeps the input's errors
        err1 = out.compute_mean_reprojection_error()
        require(len(out.images) == 20 and np.isfinite(err1) and err1 < err0,
                f"CLI model: mean reprojection error {err0} -> {err1}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("cli", f"bundle_adjuster cost {c0:.6g} -> {c1:.6g} in "
        f"{m.group(3)} it; launches {json.dumps(launches)}; mean "
        f"reprojection error {err0:.4f} -> {err1:.4f} px")


def _time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bounds(statics, lays, opt):
    """Least time of each kernel's work in one LM iteration (all
    buckets): max(bytes / HBM rate, flops / f32 rate). Bytes count each
    input the kernel needs once and each output once. Per-observation
    inputs are charged on the live lanes only, plus one read of the mask
    row over all lanes (padding lanes need nothing else); K1's `jw` is
    charged over all lanes, since its shape is the interface's. Flops
    are counted from the kernel source per live observation, plus the
    data-dependent S_corr outer products of this run's tracks."""
    import numpy as np

    out = {}
    b1 = b4 = b5 = 0.0
    f1 = f4 = f5 = 0.0
    for st, lay in zip(statics, lays):
        O, Pp, NP = lay.Pp * lay.K, lay.Pp, lay.nparams
        mask = st.obs_sta[2].cpu().numpy() > 0
        live = float(mask.sum())
        imgs = st.obs_img.cpu().numpy().reshape(lay.nb, lay.K, lay.TP)
        cams = st.obs_cam.cpu().numpy().reshape(lay.nb, lay.K, lay.TP)
        m3 = mask.reshape(lay.nb, lay.K, lay.TP)
        rows = 0.0
        for b in range(lay.nb):
            for p in range(lay.TP):
                sel = m3[b, :, p]
                ni = len(np.unique(imgs[b, sel, p]))
                nc = len(np.unique(cams[b, sel, p]))
                rows += (6 * ni + NP * nc) ** 2
        par_b = (7 + NP) * lay.Npad * 4
        mask_b = O * 4
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
    for name, by, fl in (("fused_schur", b1, f1), ("backsub", b4, f4),
                         ("fused_cost", b5, f5)):
        t_b, t_f = by / HBM_BYTES_PER_S, fl / F32_FLOPS_PER_S
        out[name] = (max(t_b, t_f) * 1e3,
                     "bytes" if t_b >= t_f else "operations")
    return out


def phase_timing(ctx, launches, errs):
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk

    statics, lays, pts0, _, prob, opt, _ = ctx
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    lam = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    lay0 = lays[0]
    dup = torch.zeros(6, lay0.Npad, device="cuda")
    duc = torch.zeros(12, lay0.C, device="cuda")
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
    bounds = _bounds(statics, lays, opt)
    rows = []
    for name, (kern, plain) in fns.items():
        ms = _time_ms(kern, 20)
        plain_ms = _time_ms(plain, 3)
        bound_ms, bound_by = bounds[name]
        rows.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
        log("timing", f"{name}: {ms:.4f} ms per LM iteration "
            f"({len(groups)} bucket launches), twin {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    return rows


def phase_profile(ctx):
    """Device time by kernel over one warm solve (torch.profiler). Busy
    time sums the device-side events only (kernels, copies, sets): an
    aten op's own device total repeats the kernels it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sba_tpu_torch.optim import ba_fused

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, s = ba_fused.solve_prepared(ctx)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in kernels)
    if busy <= 0:
        log("profile", "the profiler saw no device time: busy share not "
            "measured")
        return
    ours = sum(dev_us(e) for e in kernels
               if re.search(r"\bk[145]_\w+_kernel", e.key))
    its = s.num_iterations
    log("profile", f"{its} LM it: device time {busy / 1e3:.2f} ms = "
        f"{busy / 1e3 / its:.3f} ms/it; K1/K4/K5 kernels "
        f"{ours / 1e3 / its:.3f} ms/it, all other device work "
        f"{(busy - ours) / 1e3 / its:.3f} ms/it (profiled wall "
        f"{wall_us / 1e3:.1f} ms, inflated by the profiler)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log("profile", f"{dev_us(e) / 1e3:8.3f} ms {e.count:6d}x "
            f"{e.key[:70]}")
    return busy / its


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
    phase_build()
    errs = phase_twins()
    launches, ctx, ms_per_it = phase_main()
    phase_cli()
    rows = phase_timing(ctx, launches, errs)
    dev_us_per_it = phase_profile(ctx)
    if dev_us_per_it:
        log("profile", f"device busy {dev_us_per_it / 1e3:.3f} ms of the "
            f"{ms_per_it:.3f} ms warm LM iteration = "
            f"{100 * dev_us_per_it / 1e3 / ms_per_it:.1f}%")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    require(bool(smi), "nvidia-smi printed nothing")
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
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
