"""Time the hand-written kernels K1 (`fused_schur`), K2 (`fused_reduce`),
K3 (`schur_matvec`), K4 (`backsub`), K5 (`fused_cost`), K6 (`ncc_cost`),
`map_gather` (B1/B2/B4) and `map_gather_pair` (B3) on the card, for one
or more builds of the kernel sources, in one process.

    python -m sba_tpu_torch.utils.kernel_timing [--csrc DIR ...] \
        [--kernels k1 k2 k3 k4 k5 k6 gather pair] [--rounds 2] [--reps 50]

Each `--csrc` names a directory of CUDA sources with this package's C
entry points (an older checkout's ``sba_tpu_torch/csrc``, say); with
none, the package's own. Each is built into a library of its own, and
the libraries are timed in turns on the same inputs (first to last,
then last to first, `--rounds` times), so that two versions compare on
one card within one call; every source must have the package's C
signatures for the kernels timed (for K1 sources before its Schur tile
table, compare whole checkouts with `sba_tpu_torch.utils.ba_timing`); a
directory may hold only the source of the kernels timed (map_gather.cu
alone for `gather` and `pair`). The inputs are the main path's shapes:

- K1: one LM iteration of the headline (bench.py:473: 128 images,
  30,000 points, ~7 observations per point; its three track-length
  buckets), with `schur_bf16` on and off; also the wall time of
  building its Schur work list (`build_schur_tiles`, once per solve);
- K2: one LM iteration of the 1024-image sequential scene (bench.py:195:
  120,000 points, track 7; one bucket) with f32 couplings, with bf16
  ones (ranged), and in f32 with its images renamed by
  `spread_image_ids` (`rename_images`), which gives every block a window
  of several chunks;
- K3: one matvec of the same bucket, f32 and bf16 couplings, sorted and
  spread ids;
- K4: one LM iteration of the headline (its three buckets, from K1's
  outputs) and of the 1024-image scene (one bucket, from K2's), with
  random nonzero du;
- K5: one LM cost evaluation of the headline (three buckets) and of the
  1024-image scene (one bucket): one `fused_cost_buckets` launch; for a
  library without it (sources before the all-bucket K5), the LM loop's
  old evaluation: per bucket a zeroed accumulator and one
  `sba_fused_cost` launch, then the buckets' sum;
- K6: 4 sources x 1200 x 1600 (r=3 step 1, r=5 step 1, r=3 step 2) on
  random images, each source with a band outside it;
- gather: `map_gather` at the probes' shape (B1's form: 50 maps of
  640x480 words, 150,528 samples each) and on the first gather of a
  bench_sba linearization (bench.py:94: 50 images at 640x480, pixel step
  10; the path's flat form, about 3.8M samples), each beside
  `torch.take` of the same words (the library call; the same time for
  every library);
- pair: `map_gather_pair` at the probes' shape (B3's summed form on the
  interleaved depth|label table, 8-byte words) and on the first pair
  gather of a two-map bench_sba linearization (bench.py:94's scene at 12
  labels; the path's flat form, both words), each beside `torch.take`
  of the same 8-byte words; and two index laws that isolate B3's floors
  at the probes' shape: the same indices sorted within each map (the
  same words and sectors, no divergence: the memory floor) and all
  samples from map 0 (a 2.4 MB table that stays in L2: the rate of
  divergent requests).

Prints the card's name and power limit, the compiler's register and
spill lines for the timed kernels, and one line per (case, library):
the CUDA-event ms per call (the device's time: the stream sleeps while
the host enqueues the calls), the host's ms to enqueue one (where it
reaches the CUDA-event time, the host bounds the solve's use of the
kernel) and the largest
difference from the plain twin on the same inputs, relative to the
twin's largest entry (for integer words: the count of words that
differ). For K1, K2, K4 and K5 it also prints the device time of each
CUDA kernel inside one call, from `torch.profiler` (the split between a
wrapper's launches, and the output fills beside K4 and the old K5).
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from sba_tpu_torch.ops import ba_kernels as bk
from sba_tpu_torch.ops import cuda_build
from sba_tpu_torch.ops import patch_match_kernels as pk
from sba_tpu_torch.optim import ba_fused
from sba_tpu_torch.optim.ba import BAOptions
from sba_tpu_torch.utils.ba_timing import wall_s
from sba_tpu_torch.utils.synthetic import (make_ba_problem,
                                           make_sequential_ba_problem,
                                           rename_images, spread_image_ids)

HEADLINE = dict(num_images=128, num_points=30_000, observations_per_point=7,
                pose_noise=0.005, point_noise=0.02, pixel_noise=0.5, seed=0)
LARGE = dict(num_images=1024, num_points=120_000, track_len=7,
             pose_noise=0.005, point_noise=0.02, pixel_noise=0.5, seed=0)
NCC_CASES = ((3, 1), (5, 1), (3, 2))
# Kernel names whose ptxas lines are printed.
KERNEL_NAMES = ("k1_", "k2_", "k12_", "k3_matvec", "k4_backsub", "k5_cost",
                "k6_ncc", "b_map_gather_kernel", "b_map_gather_pair")
# The probes' shape (benchmarks/gather_micro.py): maps, words per map,
# samples per map.
PROBE_MAPS, PROBE_HW, PROBE_PER = 50, 640 * 480, 150_528
# bench.py:94 bench_sba: the scene and its options.
SBA_SCENE = dict(num_images=50, image_size=(640, 480), focal=500.0,
                 pose_noise=0.003, seed=0)
SBA_OPT = dict(pixel_step=10, max_iterations=10, mode="soft")
# The two-map path: the same scene at 12 labels (a palette over 8).
SBA_PAIR_LABELS = 12


def time_ms(fn, reps):
    """CUDA-event ms per call of `fn` over `reps` calls, after one
    warm-up call. The stream first sleeps for about twice the host's
    time to enqueue the calls (`torch.cuda._sleep`, cycles at up to
    2 GHz; at most ~0.5 s), so the host's launches run ahead and the
    events time the device's work, not the host's."""
    import time

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * host_s * reps, 0.5) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Host wall ms per call of `fn` with nothing waited for: the time to
    enqueue it. A case whose host time reaches its CUDA-event time is
    bound by the host, not the device."""
    import time

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt * 1e3 / reps


def kernel_split(fn, reps):
    """{CUDA kernel name: (launches per call, device ms per call)} over
    `reps` calls of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        out[e.key] = (e.count / reps, us / 1e3 / reps)
    return out


def _step(ctx):
    statics, lays, pts0, _, prob, _, _ = ctx
    par = bk.pack_params(prob.qvecs, prob.tvecs, prob.cam_params,
                         statics[0].image_cam, lays[0])
    return statics, lays, pts0, par, torch.tensor(1e-3, device="cuda")


def k1_cases():
    """{name: (per-library call, twin outputs, output names)} at the
    headline, one LM iteration (all buckets) per call."""
    problem, _ = make_ba_problem(dtype=torch.float32, device="cuda",
                                 **HEADLINE)
    cases = {}
    for bf16 in (True, False):
        opt = BAOptions(dtype="float32", schur_bf16=bf16)
        statics, lays, pts0, par, lam = _step(ba_fused.prepare(problem, opt))
        groups = list(zip(statics, lays, pts0))
        if bf16:
            tiles = [st.tiles for st in statics]
            ms = 1e3 * wall_s(lambda: [bk.build_schur_tiles(st, lay)
                                       for st, lay in zip(statics, lays)],
                              10)["median_s"]
            print(f"k1 work list: build_schur_tiles over {len(lays)} "
                  f"buckets {ms:.2f} ms (median wall of 10 calls), "
                  f"{sum(t.n_items for t in tiles)} items in "
                  f"{sum(t.n_units for t in tiles)} units", flush=True)

        def call(groups=groups, par=par, lam=lam, opt=opt):
            return [bk.fused_schur(st, par, p, lam, lay, opt)
                    for st, lay, p in groups]

        plain = [bk.fused_schur_plain(st, par, p, lam, lay, opt)
                 for st, lay, p in groups]
        cases[f"k1 schur_bf16={'on' if bf16 else 'off'}"] = (
            call, plain, ("S", "img_red", "ey", "pt_pay", "jw"))
    return cases


def k2_cases():
    """{name: (per-library call, twin outputs, output names)} at the
    1024-image scene, one LM iteration (one bucket) per call."""
    problem, _ = make_sequential_ba_problem(**LARGE, device="cuda")
    cases = {}
    for ranged, order in (("off", "sorted"), ("on", "sorted"),
                          ("off", "spread")):
        opt = BAOptions(dtype="float32", fused_ranged=ranged)
        statics, lays, pts0, par, lam = _step(ba_fused.prepare(problem, opt))
        st, lay, pts = statics[0], lays[0], pts0[0]
        if order == "spread":
            st, par = rename_images(st, par, spread_image_ids(lay.N))

        def call(st=st, lay=lay, pts=pts, par=par, lam=lam, opt=opt):
            return [bk.fused_reduce(st, par, pts, lam, lay, opt)]

        tag = "bf16" if bk.jcorr_dtype(lay, opt) == torch.bfloat16 else "f32"
        _, _, chunks = bk.fused_reduce_windows(st, lay)
        print(f"k2 {tag} {order}: {int((chunks > 0).sum())} blocks, "
              f"{int((chunks > 1).sum())} of more than one window chunk, "
              f"at most {int(chunks.max())}", flush=True)
        cases[f"k2 {tag} {order}"] = (
            call, [bk.fused_reduce_plain(st, par, pts, lam, lay, opt)],
            ("img_red", "pt_pay", "jw", "jcorr"))
    return cases


def k3_cases():
    """{name: (per-library call, twin outputs, output names)}: one matvec
    at the 1024-image scene."""
    problem, _ = make_sequential_ba_problem(**LARGE, device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(2)
    cases = {}
    for ranged in ("off", "on"):
        opt = BAOptions(dtype="float32", fused_ranged=ranged)
        statics, lays, pts0, par, lam = _step(ba_fused.prepare(problem, opt))
        st, lay, pts = statics[0], lays[0], pts0[0]
        jc = bk.fused_reduce(st, par, pts, lam, lay, opt)[3]
        dup = torch.zeros(6, lay.Npad)
        dup[:, :lay.N] = 1e-3 * torch.randn(6, lay.N, generator=gen)
        duc = 1e-2 * torch.randn(12, lay.C, generator=gen)
        dup, duc = dup.cuda(), duc.cuda()
        perm = torch.as_tensor(spread_image_ids(lay.N), device="cuda")
        permuted = st._replace(obs_img=perm[st.obs_img.long()].contiguous())
        tag = "bf16" if jc.dtype == torch.bfloat16 else "f32"
        for order, s in (("sorted", st), ("permuted", permuted)):
            _, _, chunks = bk.schur_matvec_windows(s, lay)
            print(f"k3 {tag} {order}: {int((chunks > 0).sum())} blocks, "
                  f"{int((chunks > 1).sum())} of more than one window "
                  f"chunk, at most {int(chunks.max())}", flush=True)

            def call(s=s, lay=lay, opt=opt, dup=dup, duc=duc, jc=jc):
                return [(bk.schur_matvec(s, dup, duc, jc, lay, opt),)]

            cases[f"k3 {tag} {order}"] = (
                call, [(bk.schur_matvec_plain(s, dup, duc, jc, lay, opt),)],
                ("out",))
    return cases


def random_du(lay, seed):
    """Random nonzero du tables [6, Npad] / [12, C] on the card (K3's and
    K4's inputs; the image rows and the camera rows of the model's
    intrinsics), from a seed."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dup = torch.zeros(6, lay.Npad)
    dup[:, :lay.N] = 1e-3 * torch.randn(6, lay.N, generator=gen)
    duc = torch.zeros(12, lay.C)
    duc[:lay.nparams] = 1e-2 * torch.randn(lay.nparams, lay.C, generator=gen)
    return dup.cuda(), duc.cuda()


def k4_cases():
    """{name: (per-library call, twin outputs, output names)}: one LM
    iteration of K4 at the headline (three buckets) and at the
    1024-image scene (one bucket)."""
    cases = {}
    for tag, make, reduce in (
            ("headline", lambda: make_ba_problem(
                dtype=torch.float32, device="cuda", **HEADLINE)[0],
             bk.fused_schur),
            ("1024 img", lambda: make_sequential_ba_problem(
                **LARGE, device="cuda")[0], bk.fused_reduce)):
        opt = BAOptions(dtype="float32")
        statics, lays, pts0, par, lam = _step(ba_fused.prepare(make(), opt))
        dup, duc = random_du(lays[0], 4)
        ins = []
        for st, lay, p in zip(statics, lays, pts0):
            out = reduce(st, par, p, lam, lay, opt)
            pt_pay, jw = out[3:5] if reduce is bk.fused_schur else out[1:3]
            ins.append((st, lay, pt_pay, jw))
        print(f"k4 {tag}: buckets K = {[lay.K for lay in lays]}, "
              f"Pp = {[lay.Pp for lay in lays]}", flush=True)

        def call(ins=ins, dup=dup, duc=duc, lam=lam, opt=opt):
            return [bk.backsub(st, dup, duc, pt, jw, lam, lay, opt)
                    for st, lay, pt, jw in ins]

        plain = [bk.backsub_plain(st, dup, duc, pt, jw, lam, lay, opt)
                 for st, lay, pt, jw in ins]
        cases[f"k4 {tag}"] = (call, plain, ("dp", "acc"))
        for i in range(len(ins) if len(ins) > 1 else 0):
            cases[f"k4 {tag} K={ins[i][1].K}"] = (
                lambda i=i, call=call, ins=ins: call(ins[i:i + 1]),
                plain[i:i + 1], ("dp", "acc"))
    return cases


# K5's C entry in sources before the all-bucket K5: one bucket, added
# into `acc` (model, loss, loss_scale, TP, K, Pp, Npad, par, pts,
# obs_sta, obs_img, acc, stream).
_ONE_BUCKET_K5 = [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  *[ctypes.c_int] * 4, *[ctypes.c_void_p] * 6]


def load_other(path):
    """Load a kernel library built from another checkout's sources, or
    from some of them (map_gather.cu alone): declare those of the
    package's C entry points that it has, and K5's one-bucket entry."""
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in cuda_build._SIGNATURES.items():
        if hasattr(cdll, name):
            getattr(cdll, name).argtypes = argtypes
            getattr(cdll, name).restype = ctypes.c_int
    if hasattr(cdll, "sba_fused_cost"):
        cdll.sba_fused_cost.argtypes = _ONE_BUCKET_K5
        cdll.sba_fused_cost.restype = ctypes.c_int
    if hasattr(cdll, "sba_error_string"):
        cdll.sba_error_string.argtypes = [ctypes.c_int]
        cdll.sba_error_string.restype = ctypes.c_char_p
    return cdll


def _cost_per_bucket(statics, par, pts0, lays, opt):
    """The LM loop's cost evaluation before the all-bucket K5: per bucket
    a zeroed accumulator and one `sba_fused_cost` launch (which added
    into it), then the buckets' sum."""
    lib = cuda_build.lib()
    accs = []
    for st, lay, p in zip(statics, lays, pts0):
        acc = torch.zeros(1, dtype=torch.float32, device=par.device)
        cuda_build.check(lib.sba_fused_cost(
            opt.model_id, bk.LOSS_IDS[opt.loss], opt.loss_scale, lay.TP,
            lay.K, lay.Pp, lay.Npad, par.data_ptr(), p.data_ptr(),
            st.obs_sta.data_ptr(), st.obs_img.data_ptr(), acc.data_ptr(),
            bk._stream()), "sba_fused_cost")
        accs.append(acc[0])
    return sum(accs)


def k5_cases():
    """{name: (per-library call, twin outputs, output names)}: one LM cost
    evaluation (all buckets) at the headline and at the 1024-image
    scene."""
    cases = {}
    for tag, make in (
            ("headline", lambda: make_ba_problem(
                dtype=torch.float32, device="cuda", **HEADLINE)[0]),
            ("1024 img", lambda: make_sequential_ba_problem(
                **LARGE, device="cuda")[0])):
        opt = BAOptions(dtype="float32")
        statics, lays, pts0, par, _ = _step(ba_fused.prepare(make(), opt))
        staged = (bk.k5_stages_par(par, lays[0])
                  if hasattr(cuda_build.lib(), "sba_fused_cost_stages")
                  else "?")
        print(f"k5 {tag}: {len(lays)} buckets, K = {[l.K for l in lays]}, "
              f"Pp = {[l.Pp for l in lays]}, par staged in shared memory: "
              f"{staged}", flush=True)

        def call(statics=statics, lays=lays, pts0=pts0, par=par, opt=opt):
            if hasattr(cuda_build.lib(), "sba_fused_cost_buckets"):
                out = bk.fused_cost_buckets(statics, par, pts0, lays, opt)
            else:
                out = _cost_per_bucket(statics, par, pts0, lays, opt)
            return [(out.reshape(1),)]

        plain = bk.fused_cost_buckets_plain(statics, par, pts0, lays, opt)
        cases[f"k5 {tag} ({len(lays)} buckets)"] = (
            call, [(plain.reshape(1),)], ("cost",))
    return cases


def k6_cases():
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
    cases = {}
    for r, step in NCC_CASES:
        def call(r=r, step=step):
            return [(pk.ncc_cost(ref, v, inb, r, step, 3.0, 0.2),)]

        cases[f"k6 r={r} step={step}"] = (
            call, [(pk.ncc_cost_plain(ref, v, inb, r, step, 3.0, 0.2),)],
            ("cost",))
    return cases


def _sba_chunk_gather(pair=False):
    """(table, idx) of the first `map_gather` of one bench_sba
    linearization on the card: the path's flat form on the packed maps;
    with `pair`, of the first `map_gather_pair` of the scene at
    SBA_PAIR_LABELS labels (the two-map path's interleaved table)."""
    from sba_tpu_torch.ops import interpolation
    from sba_tpu_torch.optim import sba as tsba
    from sba_tpu_torch.utils.synthetic import make_sba_scene

    spec = dict(SBA_SCENE, num_labels=SBA_PAIR_LABELS) if pair \
        else SBA_SCENE
    scene = make_sba_scene(**spec)            # q, t, cam, depth, sem, q0, t0
    opt = tsba.SBAOptions(**SBA_OPT)
    problem = tsba.build_sba_problem(scene[5], scene[6], *scene[2:5], opt,
                                     dtype=torch.float32, device="cuda")
    seen = []
    mods = (interpolation,) if pair else (tsba, interpolation)
    name = "map_gather_pair" if pair else "map_gather"
    real = getattr(interpolation, name)

    def record(table, idx, per=0, hw=0, *rest):
        seen.append((table, idx.clone(), per, hw))
        return real(table, idx, per, hw, *rest)

    for m in mods:
        setattr(m, name, record)
    try:
        tsba._linearize_system(problem, opt)
    finally:
        for m in mods:
            setattr(m, name, real)
    table, idx, per, hw = seen[0]
    assert per == 0
    print(f"{'pair' if pair else 'gather'} bench_sba: {len(seen)} {name} "
          f"calls per linearization; the first: {idx.numel()} samples from "
          f"{table.numel()} {table.dtype} words", flush=True)
    return table, idx


def gather_cases():
    """{name: (per-library call, twin outputs, output names)}:
    map_gather at the probes' shape and on a bench_sba chunk, and
    torch.take on the same words."""
    from sba_tpu_torch.ops import map_gather as mg

    gen = torch.Generator(device="cpu").manual_seed(0)
    d = torch.randint(-2 ** 31, 2 ** 31 - 1, (PROBE_MAPS * PROBE_HW,),
                      dtype=torch.int32, generator=gen).cuda()
    il = torch.randint(0, PROBE_HW, (PROBE_MAPS, PROBE_PER),
                       dtype=torch.int32, generator=gen).cuda()
    gi = (il.long() + PROBE_HW * torch.arange(
        PROBE_MAPS, device="cuda")[:, None])
    table, idx = _sba_chunk_gather()
    cases = {}
    for tag, kern, take, plain in (
            ("probe", lambda: mg.probe_flat(d, il),
             lambda: torch.take(d, gi),
             mg.map_gather_plain(d, il, PROBE_PER, PROBE_HW)),
            ("bench_sba chunk", lambda: mg.map_gather(table, idx),
             lambda: torch.take(table, idx.long()),
             mg.map_gather_plain(table, idx))):
        cases[f"gather {tag}"] = (lambda kern=kern: [(kern(),)],
                                  [(plain,)], ("out",))
        cases[f"gather {tag} torch.take"] = (lambda take=take: [(take(),)],
                                             [(plain,)], ("out",))
    return cases


def pair_cases():
    """{name: (per-library call, twin outputs, output names)}:
    map_gather_pair at the probes' shape (summed form), with its indices
    sorted within each map and with every sample from map 0, and on a
    two-map bench_sba chunk (both words), with torch.take on the same
    8-byte words beside the first and the last."""
    from sba_tpu_torch.ops import map_gather as mg

    gen = torch.Generator(device="cpu").manual_seed(0)
    n = PROBE_MAPS * PROBE_HW
    inter = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 2), dtype=torch.int32,
                          generator=gen).cuda()
    il = torch.randint(0, PROBE_HW, (PROBE_MAPS, PROBE_PER),
                       dtype=torch.int32, generator=gen).cuda()
    gi = (il.long() + PROBE_HW * torch.arange(
        PROBE_MAPS, device="cuda")[:, None])
    il_sorted = il.sort(dim=-1).values.contiguous()
    table, idx = _sba_chunk_gather(pair=True)
    total = il.numel()
    cases = {}
    for tag, (tab, ii, per, hw, summed) in (
            ("probe", (inter, il, PROBE_PER, PROBE_HW, True)),
            ("probe sorted in each map",
             (inter, il_sorted, PROBE_PER, PROBE_HW, True)),
            ("probe all from map 0", (inter, il, total, PROBE_HW, True)),
            ("bench_sba chunk", (table, idx, 0, 0, False))):
        cases[f"pair {tag}"] = (
            lambda tab=tab, ii=ii, per=per, hw=hw, summed=summed: [(
                mg.map_gather_pair(tab, ii, per, hw, summed),)],
            [(mg.map_gather_pair_plain(tab, ii, per, hw, summed),)],
            ("out",))
    words = (("probe", inter, gi), ("bench_sba chunk", table, idx.long()))
    for tag, tab, g in words:
        t64 = tab.reshape(-1).view(torch.int64)
        cases[f"pair {tag} torch.take"] = (
            lambda t64=t64, g=g: [(torch.take(t64, g),)],
            [(torch.take(t64, g),)], ("out",))
    return cases


def _errors(outs, plain, names):
    """'name rel_err' for each output: the largest |kernel - twin| over
    the buckets, relative to the twin's largest |entry|."""
    parts = []
    for i, name in enumerate(names):
        if not plain[0][i].is_floating_point():
            bad = sum(int((o[i] != p[i]).sum()) for o, p in zip(outs, plain))
            parts.append(f"{name} {bad} words differ")
            continue
        err = max(float((o[i].float() - p[i].float()).abs().max())
                  for o, p in zip(outs, plain))
        scale = max(float(p[i].float().abs().max()) for p in plain)
        parts.append(f"{name} {err / max(scale, 1e-30):.2e}")
    return ", ".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", type=Path,
                    help="a directory of kernel sources (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--kernels", nargs="+",
                    choices=("k1", "k2", "k3", "k4", "k5", "k6", "gather",
                             "pair"),
                    default=("k1", "k2", "k3", "k4", "k5", "k6", "gather",
                             "pair"))
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
        own_src = d.resolve() == cuda_build.CSRC_DIR.resolve()
        libs.append(cuda_build.load(path) if own_src else load_other(path))
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "entry function" in line and any(k in line
                                                for k in KERNEL_NAMES):
                info = [x.strip() for x in lines[i + 2:i + 4]]
                print(f"lib{len(libs) - 1} {line.split(chr(39))[1]}: "
                      + " | ".join(x.replace("ptxas info    : ", "")
                                   for x in info), flush=True)
        print(f"lib{len(libs) - 1} = {d}", flush=True)
    # The wrappers launch through cuda_build.lib(): the inputs are made
    # with the last library, the timing points it at each library in
    # turn, and the package's own comes back at the end.
    own = cuda_build._LIB
    order = list(range(len(libs)))
    times = {}
    try:
        cuda_build._LIB = libs[-1]
        cases = {}
        for k, make in (("k1", k1_cases), ("k2", k2_cases),
                        ("k3", k3_cases), ("k4", k4_cases),
                        ("k5", k5_cases), ("k6", k6_cases),
                        ("gather", gather_cases), ("pair", pair_cases)):
            if k in args.kernels:
                cases.update(make())
        for _ in range(args.rounds):
            for i in order + order[::-1]:
                cuda_build._LIB = libs[i]
                for name, (call, _, _) in cases.items():
                    times.setdefault((name, i), []).append(
                        time_ms(call, args.reps))
        for name, (call, plain, names) in cases.items():
            for i in order:
                cuda_build._LIB = libs[i]
                outs = call()
                torch.cuda.synchronize()
                t = times[(name, i)]
                host = host_ms(call, args.reps)
                print(f"{name} lib{i}: {min(t):.4f} ms per call (runs "
                      + ", ".join(f"{x:.4f}" for x in t)
                      + f"; host {host:.4f} ms to enqueue one); max |err| "
                      "/ twin scale: " + _errors(outs, plain, names),
                      flush=True)
                if name[:2] in ("k1", "k2", "k4", "k5"):
                    split = kernel_split(call, args.reps)
                    for kname, (n, ms) in sorted(split.items(),
                                                 key=lambda kv: -kv[1][1]):
                        print(f"  {ms:.4f} ms {n:g}x {kname[:90]}",
                              flush=True)
    finally:
        cuda_build._LIB = own


if __name__ == "__main__":
    main()
