"""Time whole bundle-adjustment calls on the card, host preparation
included, as a user pays for them.

    python -m sba_tpu_torch.utils.ba_timing [--reps 5]

Scenes, float32 on CUDA, the dense path (K1):

- headline (bench.py:473: 128 images, 30,000 points, ~7 observations per
  point): `bundle_adjust` at the default options, `ba_fused.prepare`
  alone, and a warm 10-iteration `solve_prepared` with the tolerances
  off (LM it/s, and the device time of K1's CUDA kernels per LM
  iteration from `torch.profiler`);
- cli20 (the 20-image, 400-point model of `chip_smoke.py`'s CLI phase,
  its points perturbed by 0.05): `sfm.controllers.adjust_bundle`, what
  `bundle_adjuster` runs, at the CLI's options (float32, 20
  iterations), and `prepare` alone.

Each call is made once to warm up, then `--reps` times; prints the card's
name and power limit, then one JSON line per scene with the median and
least wall seconds of each call (synchronized before and after).

It uses only entry points that older checkouts of the port share, so two
versions compare on one card in one machine call: copy this file into
the other checkout's `sba_tpu_torch/utils/` and run it from each root in
turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

HEADLINE = dict(num_images=128, num_points=30_000, observations_per_point=7,
                pose_noise=0.005, point_noise=0.02, pixel_noise=0.5, seed=0)
# K1's CUDA kernels, in this and older versions of ba_kernels.cu.
K1_KERNELS = r"\bk1(2|b|_)\w*_kernel"


def wall_s(fn, reps):
    """Median and least wall seconds of `fn` over `reps` calls after one
    warm-up call, each synchronized before and after."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return dict(median_s=statistics.median(times), min_s=min(times))


def _k1_device_ms(solve):
    """Device ms of K1's kernels per LM iteration over one call of
    `solve` (which returns its LM iterations) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        n = solve()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and re.search(K1_KERNELS, e.key))
    return us / 1e3 / n


def headline(reps):
    from sba_tpu_torch.optim import ba_fused
    from sba_tpu_torch.optim.ba import BAOptions, bundle_adjust
    from sba_tpu_torch.utils.synthetic import make_ba_problem

    problem, _ = make_ba_problem(dtype=torch.float32, device="cuda",
                                 **HEADLINE)
    opt = BAOptions(dtype="float32")
    out = dict(scene="headline",
               bundle_adjust=wall_s(lambda: bundle_adjust(problem, opt), reps),
               prepare=wall_s(lambda: ba_fused.prepare(problem, opt), reps))
    _, s = bundle_adjust(problem, opt)
    out["lm_iterations"] = int(s.num_iterations)
    opt10 = BAOptions(dtype="float32", max_iterations=10,
                      function_tolerance=0.0, gradient_tolerance=0.0,
                      parameter_tolerance=0.0)
    ctx = ba_fused.prepare(problem, opt10)

    def solve():
        return ba_fused.solve_prepared(ctx)[1].num_iterations

    w = wall_s(solve, reps)
    n = solve()
    out["warm_lm_it_per_s"] = n / w["median_s"]
    out["k1_device_ms_per_lm_it"] = _k1_device_ms(solve)
    return out


def cli20(reps):
    from sba_tpu_torch.optim import ba_fused
    from sba_tpu_torch.optim.ba import BAOptions, build_problem
    from sba_tpu_torch.sfm.controllers import adjust_bundle
    from sba_tpu_torch.utils.synthetic import make_synthetic_reconstruction

    rec = make_synthetic_reconstruction(num_images=20, num_points=400,
                                        seed=3)
    rng = np.random.default_rng(3)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(scale=0.05, size=3)
    xyz = {k: p.xyz.copy() for k, p in rec.points3D.items()}
    poses = {k: (im.qvec.copy(), im.tvec.copy())
             for k, im in rec.images.items()}
    opt = BAOptions(dtype="float32", max_iterations=20)

    def run():
        # adjust_bundle writes its result back: start each call afresh.
        for k, p in rec.points3D.items():
            p.xyz = xyz[k].copy()
        for k, im in rec.images.items():
            im.qvec, im.tvec = (a.copy() for a in poses[k])
        return adjust_bundle(rec, opt, device="cuda")

    out = dict(scene="cli20", adjust_bundle=wall_s(run, reps))
    out["lm_iterations"] = int(run()["summary"].num_iterations)
    arrays = rec.to_arrays(image_ids=[i for i in rec.images
                                      if rec.is_registered(i)])
    problem = build_problem(arrays, constant_pose_rows=[0],
                            constant_tvec_rows={1: [0]},
                            dtype=torch.float32, device="cuda")
    out["prepare"] = wall_s(lambda: ba_fused.prepare(problem, opt), reps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ba_timing: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    for scene in (headline, cli20):
        print(json.dumps(scene(args.reps)), flush=True)


if __name__ == "__main__":
    main()
