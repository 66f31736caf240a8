"""Run-to-run spread of the small fused BA solve on the card.

    python -m sba_tpu_torch.utils.card_repeat [--runs 10] \
        [--max_iterations 10] [--cg_tolerance 1e-2]

Solves the 6-image problem of ``tests/test_torch_cuda.py::
test_fused_solve_on_card_matches_cpu_twins`` (float32, 10 LM iterations
by default) through the CUDA kernels `--runs` times and once through
the plain twins on the CPU, and prints, for each card run, the
final-cost gap to the CPU solve (relative), the largest translation
gap, the iteration count, the first LM iteration whose cost differs
from the CPU trace by more than 1e-5 relative, both solves' largest
translation error against the scene's truth, and each solve's accept
(1) / reject (0) pattern.
It also launches K1 (`fused_schur`) twice on the same inputs and prints
the largest difference between the two launches for each output: S_corr
is summed without atomics and repeats exactly, the image payload's and
Ey's float atomics sum in no fixed order. One JSON line per run, then
one summary line.

First, on the CPU alone, a witness: `--witness` more twin solves from
the points perturbed by 1e-6 relative (fixed seeds), each one's final
cost and largest translation gap to the unperturbed solve. With
``--runs 0`` the script runs only that part and needs no CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from sba_tpu_torch.ops import ba_kernels as bk
from sba_tpu_torch.optim import ba_fused
from sba_tpu_torch.optim.ba import BAOptions, bundle_adjust
from sba_tpu_torch.utils.synthetic import make_ba_problem

SMALL = dict(num_images=6, num_points=150, observations_per_point=4,
             pose_noise=0.01, point_noise=0.05, pixel_noise=0.5, seed=0)


def _first_divergence(trace, ref, rtol=1e-5):
    for i, (a, b) in enumerate(zip(trace.tolist(), ref.tolist())):
        if a != a and b != b:       # both NaN: past the last iteration
            continue
        if not abs(a - b) <= rtol * abs(b):
            return i
    return None


def _accepts(trace):
    """'1' where an LM iteration lowered the cost, '0' where rejected."""
    t = trace.tolist()
    return "".join("1" if b < a else "0" for a, b in zip(t, t[1:])
                   if b == b)


def k1_repeat_spread(problem, opt):
    """Largest |difference| between two K1 launches on identical inputs,
    for each of its outputs (S, image payload, Ey, point payload, jw)."""
    statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    lam = torch.tensor(1e-3, device=problem.qvecs.device)
    worst = dict.fromkeys(("S", "img_red", "ey", "pt_pay", "jw"), 0.0)
    for st, lay, pts in zip(statics, lays, pts0):
        a = bk.fused_schur(st, par, pts, lam, lay, opt)
        b = bk.fused_schur(st, par, pts, lam, lay, opt)
        for name, x, y in zip(worst, a, b):
            worst[name] = max(worst[name], float((x - y).abs().max()))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--max_iterations", type=int, default=10)
    ap.add_argument("--cg_tolerance", type=float, default=1e-2)
    ap.add_argument("--witness", type=int, default=6)
    args = ap.parse_args(argv)
    if args.runs and not torch.cuda.is_available():
        raise SystemExit("card_repeat: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = BAOptions(max_iterations=args.max_iterations, dtype="float32",
                    cg_tolerance=args.cg_tolerance)
    cpu, truth = make_ba_problem(dtype=torch.float32, device="cpu",
                                 **SMALL)
    t_true = torch.as_tensor(truth["tvecs"], dtype=torch.float32)
    out_c, s_c = ba_fused.bundle_adjust_fused(cpu, opt)
    ref_cost = float(s_c.final_cost)
    for k in range(args.witness):
        gen = torch.Generator().manual_seed(k)
        moved = cpu._replace(points=cpu.points * (
            1 + 1e-6 * torch.randn(cpu.points.shape, generator=gen)))
        out_w, s_w = ba_fused.bundle_adjust_fused(moved, opt)
        print(json.dumps(dict(
            witness=k,
            cost_gap=abs(float(s_w.final_cost) - ref_cost) / ref_cost,
            tvec_gap=float((out_w.tvecs - out_c.tvecs).abs().max()))),
            flush=True)
    if not args.runs:
        return 0
    rows = []
    for run in range(args.runs):
        gpu, _ = make_ba_problem(dtype=torch.float32, device="cuda", **SMALL)
        out_g, s_g = bundle_adjust(gpu, opt)
        row = dict(
            run=run,
            cost_gap=abs(float(s_g.final_cost) - ref_cost) / ref_cost,
            tvec_gap=float((out_g.tvecs.cpu() - out_c.tvecs).abs().max()),
            iterations=int(s_g.num_iterations),
            cpu_iterations=int(s_c.num_iterations),
            first_divergent_iteration=_first_divergence(
                s_g.cost_trace.cpu(), s_c.cost_trace),
            k1_repeat_max_abs=k1_repeat_spread(gpu, opt),
            tvec_err_truth=float((out_g.tvecs.cpu() - t_true).abs().max()),
            cpu_tvec_err_truth=float((out_c.tvecs - t_true).abs().max()),
            accepts=_accepts(s_g.cost_trace.cpu()),
            cpu_accepts=_accepts(s_c.cost_trace))
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(
        runs=len(rows),
        cost_gap_max=max(r["cost_gap"] for r in rows),
        tvec_gap_max=max(r["tvec_gap"] for r in rows),
        tvec_gap_min=min(r["tvec_gap"] for r in rows),
        fail_cost=sum(r["cost_gap"] > 1e-3 for r in rows),
        fail_tvec=sum(r["tvec_gap"] > 5e-3 for r in rows),
        max_iterations=args.max_iterations,
        cg_tolerance=args.cg_tolerance,
        device=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
