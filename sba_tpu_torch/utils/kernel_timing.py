"""Time K3 (`schur_matvec`) and K6 (`ncc_cost`) on the card, for one or
more builds of the kernel sources, in one process.

    python -m sba_tpu_torch.utils.kernel_timing [--csrc DIR ...] \
        [--rounds 2] [--reps 50]

Each `--csrc` names a directory of CUDA sources with this package's C
entry points (an older checkout's ``sba_tpu_torch/csrc``, say); with
none, the package's own. Each is built into a library of its own, and
the libraries are timed in turns on the same inputs (first to last,
then last to first, `--rounds` times), so that two versions compare on
one card within one call. The inputs are the main path's shapes:

- K3: one matvec of the 1024-image sequential scene (bench.py:195:
  120,000 points, track 7), f32 couplings and bf16 ones (ranged), and
  the same bucket with its image ids spread (`spread_image_ids`), which
  gives every block a window of several chunks;
- K6: 4 sources x 1200 x 1600 (r=3 step 1, r=5 step 1, r=3 step 2) on
  random images, each source with a band outside it.

Prints the card's name and power limit, the compiler's register and
spill lines for the two kernels, and one line per (case, library): the
CUDA-event ms per launch and the largest difference from the plain twin
on the same inputs. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

import torch

from sba_tpu_torch.ops import ba_kernels as bk
from sba_tpu_torch.ops import cuda_build
from sba_tpu_torch.ops import patch_match_kernels as pk
from sba_tpu_torch.optim import ba_fused
from sba_tpu_torch.optim.ba import BAOptions
from sba_tpu_torch.utils.synthetic import (make_sequential_ba_problem,
                                           spread_image_ids)

LARGE = dict(num_images=1024, num_points=120_000, track_len=7,
             pose_noise=0.005, point_noise=0.02, pixel_noise=0.5, seed=0)
NCC_CASES = ((3, 1), (5, 1), (3, 2))


def time_ms(fn, reps):
    """CUDA-event ms per call of `fn` over `reps` calls, after one
    warm-up call."""
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


def k3_cases():
    """{name: (static, layout, options, du_pose_t, du_cam_t, jcorr)} at
    the 1024-image scene."""
    problem, _ = make_sequential_ba_problem(**LARGE, device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(2)
    cases = {}
    for ranged in ("off", "on"):
        opt = BAOptions(dtype="float32", fused_ranged=ranged)
        statics, lays, pts0, _, prob, _, _ = ba_fused.prepare(problem, opt)
        st, lay, pts = statics[0], lays[0], pts0[0]
        par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                             st.image_cam, lay)
        lam = torch.tensor(1e-3, device="cuda")
        jc = bk.fused_reduce(st, par, pts, lam, lay, opt)[3]
        dup = torch.zeros(6, lay.Npad)
        dup[:, :lay.N] = 1e-3 * torch.randn(6, lay.N, generator=gen)
        duc = 1e-2 * torch.randn(12, lay.C, generator=gen)
        dup, duc = dup.cuda(), duc.cuda()
        perm = torch.as_tensor(spread_image_ids(lay.N), device="cuda")
        permuted = st._replace(obs_img=perm[st.obs_img.long()].contiguous())
        tag = "bf16" if jc.dtype == torch.bfloat16 else "f32"
        cases[f"k3 {tag} sorted"] = (st, lay, opt, dup, duc, jc)
        cases[f"k3 {tag} permuted"] = (permuted, lay, opt, dup, duc, jc)
    return cases


def k6_inputs():
    """Random images; each source lies outside the reference's view on a
    band of 240-540 columns (about a fifth of the pixels, as in the
    8-view scene), where it is 0."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    ref = torch.rand(1200, 1600, generator=gen).cuda()
    v = torch.rand(4, 1200, 1600, generator=gen).cuda()
    inb = torch.ones(4, 1200, 1600, dtype=torch.bool, device="cuda")
    for s in range(4):
        band = slice(None, 240 + 100 * s) if s % 2 else \
            slice(1600 - 240 - 100 * s, None)
        inb[s, :, band] = False
    v[~inb] = 0.0
    return ref, v, inb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", type=Path,
                    help="a directory of kernel sources (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--kernels", nargs="+", choices=("k3", "k6"),
                    default=("k3", "k6"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    dirs = args.csrc or [cuda_build.CSRC_DIR]
    libs = []
    for d in dirs:
        path, log = cuda_build.build(d.resolve())
        libs.append(cuda_build.load(path))
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "entry function" in line and ("k3_matvec" in line
                                             or "k6_ncc" in line):
                info = [x.strip() for x in lines[i + 2:i + 4]]
                print(f"lib{len(libs) - 1} {line.split(chr(39))[1]}: "
                      + " | ".join(x.replace("ptxas info    : ", "")
                                   for x in info), flush=True)
        print(f"lib{len(libs) - 1} = {d}", flush=True)
    own = cuda_build.lib()

    k3 = k3_cases() if "k3" in args.kernels else {}
    for name, (st, lay, opt, dup, duc, jc) in k3.items():
        _, _, chunks = bk.schur_matvec_windows(st, lay)
        live = chunks > 0
        print(f"{name}: {int(live.sum())} blocks, "
              f"{int((chunks > 1).sum())} of more than one window chunk, "
              f"at most {int(chunks.max())}", flush=True)
    if "k6" in args.kernels:
        ref, v, inb = k6_inputs()
    fns = {}
    for name, (st, lay, opt, dup, duc, jc) in k3.items():
        fns[name] = (
            lambda st=st, lay=lay, opt=opt, dup=dup, duc=duc, jc=jc:
            bk.schur_matvec(st, dup, duc, jc, lay, opt),
            bk.schur_matvec_plain(st, dup, duc, jc, lay, opt))
    for r, step in NCC_CASES if "k6" in args.kernels else ():
        fns[f"k6 r={r} step={step}"] = (
            lambda r=r, step=step: pk.ncc_cost(ref, v, inb, r, step, 3.0,
                                               0.2),
            pk.ncc_cost_plain(ref, v, inb, r, step, 3.0, 0.2))
    # The wrappers launch through cuda_build.lib(): point it at each
    # library in turn, and back at the package's own at the end.
    order = list(range(len(libs)))
    times = {}
    try:
        for _ in range(args.rounds):
            for i in order + order[::-1]:
                cuda_build._LIB = libs[i]
                for name, (fn, _) in fns.items():
                    times.setdefault((name, i), []).append(
                        time_ms(fn, args.reps))
        for name, (fn, plain) in fns.items():
            for i in order:
                cuda_build._LIB = libs[i]
                out = fn()
                torch.cuda.synchronize()
                err = float((out - plain).abs().max())
                scale = float(plain.abs().max())
                t = times[(name, i)]
                print(f"{name} lib{i}: {min(t):.4f} ms per launch (runs "
                      + ", ".join(f"{x:.4f}" for x in t)
                      + f"); max |err| vs twin {err:.3e} (scale "
                      f"{scale:.3e})", flush=True)
    finally:
        cuda_build._LIB = own


if __name__ == "__main__":
    main()
