"""On-card smoke run of the PyTorch/CUDA port (sba_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (found through torch's CUDA_HOME, else
/usr/local/cuda). It builds the hand-written kernels from csrc/, then:

1. build          -- nvcc version and path, build time, ptxas lines;
2. twins          -- K1/K4/K5 against their plain PyTorch twins on the
                     same CUDA tensors at the headline shapes (128 images,
                     30,000 points, ~7 observations per point), models 0
                     and 2 (K1's S_corr exactly symmetric), K5 also over
                     all buckets in one launch (two calls, the same
                     bits); a small solve
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
                     K4 and K5 (per bucket and over all buckets) against
                     their twins at the headline shapes, K2-K5 on an implicit bucket (the 1024-image
                     scene for RADIAL and FULL_OPENCV, K2's diagonal and
                     block payload modes; 160 images for the rest);
5. main           -- `bundle_adjust` on the headline problem in float32
                     (dense path: K1, K4, K5 must launch; K5 once per
                     cost evaluation), cost must fall; host prep
                     (`ba_fused.prepare`) and LM it/s of a warm
                     `solve_prepared`;
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
                     K2-K5 against their twins at these shapes, K5 also
                     over all buckets (its parameter table read in
                     place, past shared memory; two calls, same bits);
9. cli            -- `sba_tpu_torch.cli bundle_adjuster` (its `main`, in
                     this process) in
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
                     `sba_tpu_torch.cli` (its `main`, in this process)
                     with `--device cuda`;
                     K6 must launch, each pass's depth maps must meet
                     MAP_LIMITS against the analytic heightfield, the
                     cloud must hold MIN_FUSED_POINTS and lie on the
                     heightfield (median vertical error under 1%, 80th
                     percentile under 3% of the median depth); then one
                     warm photometric solve in process
                     (Mpix*iterations/s, peak device memory);
11a. meshing      -- `poisson_mesher` and `delaunay_mesher` (in this
                     process, `--device cuda`) on the mvs phase's
                     workspace at TSDFOptions' defaults (voxel grid,
                     TSDF fusion ms, surface nets s and peak memory
                     printed; the meshes' heightfield errors printed),
                     then `poisson_mesher` on the same workspace with the
                     true depth maps: MESH_GATES against the heightfield;
11b. dense-writers -- `image_undistorter --output_type PMVS` and
                     `CMP-MVS` on the mvs scene (files, and projection
                     matrices against the COLMAP workspace's keypoints),
                     `image_rectifier` on two neighbouring views
                     (RECT_GATES: Q, rows through H1/H2 and of matched
                     image patches, the depth Q gives back);
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
14. cli-sba       -- `sba_tpu_torch.cli semantic_bundle_adjuster` (its
                     `main`, in this process, as every command below)
                     on an 8-image 640x480 model with TIFF maps, at its
                     defaults (float64, forward mode) and in hard_numeric
                     mode;
15. gsba          -- geometric-semantic BA in float32 through
                     `geometric_semantic_bundle_adjust` (plain PyTorch,
                     no kernel of its own): bench_gsba (bench.py:125: 20
                     images, 640x480, soft, 10 LM iterations, tolerances
                     off; the cost, the hard mean IoU and the cylinder's
                     centre error must improve; the first LM step against
                     the float64 solve on the card at 1e-3 of scale, the
                     costs at rtol 1e-4; warm LM it/s as bench.py's
                     `_delta_rate`) and the forest (bench.py:318: 16
                     trunks x 32 images at 640x480, 10 LM iterations
                     (3 could leave every step rejected, under a
                     second); the cost and the mean own-view hard
                     IoU must improve, and the final cost must match the
                     float64 solve's on the card at rtol 1e-3; warm LM
                     it/s, chunks, peak memory, and the trunks whose
                     own-view IoU fell in either solve);
16. cli-gsba      -- `sba_tpu_torch.cli
                     geometric_semantic_bundle_adjuster` at its defaults
                     (cuda, float64) on an 8-image 640x480 model with
                     semantic TIFFs and a perturbed cylinders.txt: the
                     printed line, and the cylinder's centre error falls;
17. twins-frontend -- the front end on the card against the port's own
                     CPU path on the same inputs: SIFT of four 320x240
                     views (rows within 1e-3 px / 1e-3 rad, u8
                     descriptors within 1; map_gather launched twice an
                     image), `match_pairs_batched` on one descriptor
                     stack (rows equal but 0.1%), and
                     `estimate_two_view_geometry_batch` with the same
                     sample tensors (configurations equal, inliers within
                     1%);
18. frontend      -- `feature_extractor`, `exhaustive_matcher` (276
                     pairs) and, on a copy of the database,
                     `sequential_matcher` of `python -m sba_tpu_torch.cli`
                     at their defaults on 24 rendered 1600x1200 views
                     (8192 features, batches of 8 images and 32 pairs,
                     4096 trials); map_gather launches counted during
                     extraction; FRONTEND_GATES against the true poses;
18a. retrieval    -- on the frontend phase's database (~3760 features an
                     image): `vocab_tree_builder` (16^2 words),
                     `vocab_tree_matcher` (10 images each) on a copy with
                     its matches cleared, `vocab_tree_retriever`, and
                     `sequential_matcher` with loop detection
                     (LOOP_FLAGS); every retrieved pair verifies, loop
                     detection adds pairs beyond the overlap window;
                     card = CPU (RETRIEVAL_TWIN): the words through the
                     card's tree, the k-means objective of the trees
                     built on both, the retriever's rankings, the
                     matcher's and loop detection's pairs; each
                     command's seconds;
19. mapper        -- `python -m sba_tpu_torch.cli mapper` at its defaults
                     on the frontend phase's exhaustive database (24 x
                     1600x1200, 8192 features, SIMPLE_RADIAL): one model
                     of all 24 views within MAPPER_GATES of the true
                     poses (reprojection error, ATE after a similarity,
                     consecutive rotations, points); wall seconds and
                     registrations per second, local and global BAs and
                     their LM iterations, the wall's split into BA,
                     RANSAC and host, peak memory, the busy share;
20. twins-mapper  -- the mapper's initial pair, first registration,
                     triangulation and local BA (TWIN_LOCAL_BA_IT LM
                     iterations) on the card and the CPU with the same
                     draws: inlier sets equal, poses within 1e-8 of the
                     baseline, local BA costs at rtol 1e-9;
20a. pose_graph_optimizer -- the command at its defaults (float32) on
                     the mapper phase's model: its printed line, the
                     poses within PG_GATES of the input's, MAPPER_GATES;
20b. hierarchical -- `hierarchical_mapper` at its defaults but two
                     leaves (HIER_FLAGS: 12 images a leaf, overlap 4) on
                     the same database: the leaves, one merge and the
                     seam relaxation; one model of all 24 views within
                     MAPPER_GATES' pose gates (its reprojection error
                     under the merge's 8 px bound), and within all of
                     MAPPER_GATES after `bundle_adjuster`; the wall split
                     into the leaves' mappers, merging and relaxing;
                     then `model_merger` on the run's two leaf models
                     (every common image merged);
21. point_triangulator -- the command on the true poses over the
                     database's keypoints: the points on the heightfield;
22. automatic_reconstructor -- `--dense 1` on 8 of the views with one
                     shared camera (its own extraction, matching and
                     mapping within MAPPER_GATES, then undistortion,
                     PatchMatch, fusion and `poisson_mesher`): K6
                     launched, the cloud and mesh written, the mesh's
                     heightfield errors (after the model's similarity
                     onto the truth) printed;
22a. pose-graph   -- `pose_graph_from_reconstruction` on the 1024-image
                     sequential scene's true model (noisy measurements),
                     `optimize_pose_graph` from a drifted start in
                     float32 on the card, SE3 with Huber then Sim3 with
                     scale drift, at sba_tpu's defaults: the cost and the
                     relative drift fall (PG_GATES), the final cost
                     equals the float64 solve's on the card at rtol
                     1e-3 with the edges in their order and in
                     PG_EDGE_ORDERS permutations; edges, LM and CG
                     iterations, wall seconds;
22b. rig          -- a 4-camera rig over 64 snapshots (256 x 1600x1200
                     SIMPLE_RADIAL, 40,000 points) written as a COLMAP
                     model with a JSON rig config, every image pose
                     perturbed off the rig: `rig_bundle_adjuster` at its
                     defaults on the card (model_id 2); the cost falls,
                     the composed poses beat the perturbed ones by
                     RIG_GATES' 0.2; GR6P between two snapshots (30%
                     outliers) and the generalized absolute pose of one
                     snapshot (10% outliers) on the card, against the
                     truth;
22c. parallel    -- the SPMD solvers (`sba_tpu_torch.parallel`, the
                     sharded pose graph) on torch.distributed: (a) NCCL
                     at one rank per card (at one card in this process:
                     each sharded solver once against its single-device
                     counterpart on the same scene, bit for bit, or where
                     the single-device solve is not reproducible itself
                     (the BA kernels' float atomics) its final cost
                     within PAR_GATES and its first accepted step's cost
                     within the spread of single-device reruns of that
                     step (PAR_FIRST_*; the pose graph's reruns with its
                     edges reordered); (b)
                     PAR_RANKS gloo ranks sharing card 0, spawned once:
                     the headline (K1/K4/K5) and 1024-image (K2-K5)
                     fused solves, the latter again with the shared
                     camera's intrinsics free, the float64
                     observation-sharded PCG and point-sharded explicit
                     solves of the headline scene (PAR_F64_IT LM
                     iterations; the latter again with free
                     intrinsics), bench_sba (map_gather), the GSBA
                     forest and the 1024-pose SE3 and Sim3 pose graphs,
                     each against the single-device solve on the card
                     (PAR_GATES, PG_GATES, and the first step as in
                     (a)); both ranks bit-equal, each rank's kernels
                     launched; wall, LM it/s, all-reduces and bytes per
                     LM iteration;
23. timing        -- per-kernel CUDA-event times (the stream sleeps
                     while the host enqueues the timed calls, so they are
                     the device's) against the twins, the
                     memory/compute bound and, for B1-B4, the PyTorch
                     library call of the same function (every kernel
                     also beside its first design's time, "was"); K5
                     as one all-bucket launch per LM iteration; K4 with
                     random du, also at the 1024-image bucket; B1-B4
                     also beside the least time over the 32-byte
                     sectors their samples touch (B3's sector floor);
                     `map_gather` also at SIFT's index law;
24. profile       -- device time by kernel over one warm solve of the
                     headline (with K1's split between its linearize-and-
                     reduce kernel and its three Schur kernels, and its
                     share of its bound), of the
                     1024-image scene, of one 1600x1200 photometric
                     PatchMatch solve, of the bench_sba SBA solve and of
                     the bench_gsba GSBA solve (torch.profiler), and the
                     device's busy share; then the front end's device
                     time per image (SIFT, 8 x 1600x1200) and per pair
                     (match and verify, 16 pairs), its busy share,
                     map_gather's launches and time per image, and its
                     top operations with cuSOLVER's marked.

Prints one progress line per phase, a `{"kernels": [...]}` line, the
card's name and power limit, and as its last line
`{"ok": true, "device": {...}}`. Any failure exits non-zero without that
line; a run that outlives its deadline dumps its stacks and exits.
"""

from __future__ import annotations

import faulthandler
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEADLINE_S = 1000
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
# bench.py:125 bench_gsba: one trunk seen by 20 images at 640x480, soft,
# 10 LM iterations, tolerances off; and bench.py:318 bench_gsba_forest:
# 16 trunks x 2 close-up views, 640x480, focal 700 (LM iterations as the
# deadline allows, at least 3).
GSBA_SCENE = dict(num_images=20, image_size=(640, 480), pose_noise=0.01,
                  cylinder_noise=0.05, seed=0)
GSBA_OPT = dict(mode="soft", max_iterations=10, function_tolerance=0.0,
                gradient_tolerance=0.0, parameter_tolerance=0.0)
FOREST_SCENE = dict(num_cylinders=16, cameras_per_cylinder=2,
                    image_size=(640, 480), focal=700.0, pose_noise=0.005,
                    cylinder_noise=0.03, seed=0)
FOREST_IT = 10            # LM iterations of the forest solves
# The GSBA CLI's model: 8 images of the bench_gsba scene at their true
# poses (tests/test_cli_semantic.py's setting), the cylinder perturbed.
GSBA_CLI_SCENE = dict(GSBA_SCENE, num_images=8, pose_noise=0.0)
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
# walking its slots for K4; a launch per bucket into a zeroed
# accumulator, a float atomic per block, for K5; a thread per sample
# with the default cache policy for map_gather and map_gather_pair) at
# the timing phase's shapes, on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md kernel table), printed beside the current times.
WAS_MS = {"ncc_cost": 0.6771, "schur_matvec": 0.2602, "fused_schur": 2.3427,
          "fused_reduce": 1.7302, "backsub": 0.2238, "map_gather": 0.0750,
          "fused_cost": 0.0191, "map_gather_pair": 0.0851}
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


def _check_cost_buckets(phase, tag, statics, lays, pts0, par, opt,
                        stages):
    """K5 over all buckets in one launch against the twins' sum, and a
    second call on the same inputs with the same bits; its launcher
    stages the parameter table in shared memory iff `stages`. Returns the
    max abs error."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk

    c1 = bk.fused_cost_buckets(statics, par, pts0, lays, opt)
    c2 = bk.fused_cost_buckets(statics, par, pts0, lays, opt)
    c_p = bk.fused_cost_buckets_plain(statics, par, pts0, lays, opt)
    torch.cuda.synchronize()
    require(torch.equal(c1, c2), f"{tag} K5 over all buckets: two calls on "
            f"the same inputs differ ({float(c1)!r} / {float(c2)!r})")
    e = close(f"{tag} cost over {len(lays)} buckets", c1.reshape(1),
              c_p.reshape(1), 1e-4)
    staged = bk.k5_stages_par(par, lays[0])
    require(staged == stages, f"{tag} K5: the parameter table is "
            f"{'' if staged else 'not '}staged in shared memory")
    where = "staged in shared memory" if staged else "read in place"
    log(phase, f"{tag}: K5 over {len(lays)} buckets in one launch (par "
        f"{where}) matches the twins' sum, |dcost| {e:.2e}; two calls, the "
        f"same bits")
    return e


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
        e5 = _check_cost_buckets("twins", f"m{model_id}", statics, lays,
                                 pts0, par, opt, stages=True)
        errs["fused_cost"] = max(errs["fused_cost"], e5)

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
    require(launches["fused_cost"] == s.num_iterations + 1,
            f"K5 launched {launches['fused_cost']} times for "
            f"{s.num_iterations + 1} cost evaluations")
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
    errs["fused_cost"] = max(errs["fused_cost"], _check_cost_buckets(
        "large-ranged", "10240", ctx[0], ctx[1], ctx[2], par, opt,
        stages=False))
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
        errs["fused_cost"] = max(errs["fused_cost"], _check_cost_buckets(
            "twins-heads", f"m{m}", ctx[0], ctx[1], ctx[2], par, opt,
            stages=True))
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
    iteration (all buckets; K5 in one launch), for OPENCV and
    FULL_OPENCV, each beside its
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
                "fused_cost": lambda: bk.fused_cost_buckets(
                    ctx[0], par, ctx[2], ctx[1], opt)}
            bounds = _bounds(ctx[0], ctx[1], opt, names)
            for name in names:
                ms = time_ms(fns[name], 20)
                out[(m, name)] = (ms, bounds[name])
                log("timing", f"model {m} (np {ctx[1][0].nparams}, JW "
                    f"{ctx[1][0].JW}) {name} at {scene['num_images']} "
                    f"images: {ms:.4f} ms per LM iteration ({len(groups)} "
                    f"buckets, {1 if name == 'fused_cost' else len(groups)}"
                    f" launches), bound {bounds[name][0]:.4f} ms "
                    f"({bounds[name][1]}), {100 * bounds[name][0] / ms:.1f}% "
                    f"of it")
            del ctx, par, groups, fns
            torch.cuda.empty_cache()
    return out


def _run_cli(rec, tag, flags, kernels, other):
    """bundle_adjuster with `flags` on `rec` (`sba_tpu_torch.cli`'s
    `main` in this process, the launch counts set to 0 first); checks
    the cost, the mean reprojection error and that the path's kernels
    (and no other) launched."""
    import numpy as np

    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.ops import ba_kernels, cuda_build

    err0 = rec.compute_mean_reprojection_error()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="cli_smoke_",
                                 dir=cuda_build.BUILD_DIR))
    try:
        rec.write(str(work / "in"))
        ba_kernels.reset_launches()
        stdout, _ = _run_frontend_cli(
            ["bundle_adjuster", "--input_path", str(work / "in"),
             "--output_path", str(work / "out"), *flags], "bundle_adjuster")
        m = re.search(r"BA: cost (\S+) -> (\S+) in (\d+) iters", stdout)
        k = re.search(r"kernel launches: (\{.*\})", stdout)
        require(m is not None and k is not None,
                f"unexpected CLI output:\n{stdout}")
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
    solve as a callable, its warm wall ms, the work directory: images/,
    sparse/ and the dense workspace dense/, which the meshing and
    dense-writers phases use and main removes)."""
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
        out = {}
        for args in (
                ["image_undistorter", "--image_path", work / "images",
                 "--input_path", work / "sparse", "--output_path", ws],
                ["patch_match_stereo", "--workspace_path", ws],
                ["stereo_fuser", "--workspace_path", ws, "--output_path",
                 ws / "fused.ply", *FUSION_FLAGS]):
            pk.reset_launches()
            out[args[0]], dt = _run_frontend_cli(
                [*map(str, args), "--device", "cuda"], args[0])
            lines = [l for l in out[args[0]].splitlines()
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
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise

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
    return launches, solve, ms, work


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
        # K5 reads x, y and image of each live lane; its one launch over
        # all buckets reads par once (below).
        b5 += 3 * Pp * 4 + mask_b + 3 * live * 4
        f5 += live * 60
    b5 += (7 + lays[0].nparams) * lays[0].Npad * 4
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
    """K1/K4/K5 at the headline: ms per LM iteration (all buckets; K5 in
    one launch), and the host's ms to enqueue one. K4 takes random
    nonzero du."""
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
            lambda: bk.fused_cost_buckets(statics, par, pts0, lays, opt),
            lambda: bk.fused_cost_buckets_plain(statics, par, pts0, lays,
                                                opt)),
    }
    bounds = _bounds(statics, lays, opt, tuple(fns))
    rows = {}
    for name, (kern, plain) in fns.items():
        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 3)
        rows[name] = _kernel_row(name, launches, errs, ms, plain_ms,
                                 bounds[name])
        was = (f" (was {WAS_MS[name]:.4f} ms)" if name in WAS_MS else "")
        n_launch = (f"one launch over {len(groups)} buckets"
                    if name == "fused_cost"
                    else f"{len(groups)} bucket launches")
        log("timing", f"{name}: {ms:.4f} ms per LM iteration{was} "
            f"({n_launch}; host {host_ms(kern, 20):.4f}"
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


class _DevTotal:
    """One device-side event name's launches and summed time (us)."""

    def __init__(self, key):
        self.key = key
        self.count = 0
        self.self_device_time_total = 0.0


def _device_totals(prof):
    """The device-side events (kernels, copies, sets) of a finished
    profile, summed by name from its raw trace: the profiler's own
    per-operation tables take tens of seconds at these event counts."""
    from torch.autograd import DeviceType

    tot = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        t = tot.get(e.name())
        if t is None:
            t = tot[e.name()] = _DevTotal(e.name())
        t.count += 1
        t.self_device_time_total += e.duration_ns() / 1e3
    return list(tot.values())


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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n = solve()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    kernels = _device_totals(prof)

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
    mode) cut to 10 LM iterations, and hard_numeric."""
    from sba_tpu_torch.ops import cuda_build, map_gather
    from sba_tpu_torch.utils.synthetic import make_sba_scene

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="cli_sba_",
                                 dir=cuda_build.BUILD_DIR))
    try:
        _write_sba_workspace(work, make_sba_scene(**SBA_CLI_SCENE))
        for tag, extra in (("defaults", (
                               "--SemanticBundleAdjustment.max_iterations",
                               "10")),
                           ("hard_numeric", (
                               "--SemanticBundleAdjustment.mode",
                               "hard_numeric",
                               "--SemanticBundleAdjustment.max_iterations",
                               "5"))):
            map_gather.reset_launches()
            stdout, wall = _run_frontend_cli(
                ["semantic_bundle_adjuster", "--device", "cuda",
                 "--input_path", str(work / "in"),
                 "--output_path", str(work / f"out_{tag}"),
                 "--data_path", str(work / "maps"), *extra],
                "semantic_bundle_adjuster")
            m = re.search(r"SBA: cost (\S+) -> (\S+) in (\d+) iters", stdout)
            k = re.search(r"kernel launches: (\{.*\})", stdout)
            require(m is not None and k is not None,
                    f"unexpected CLI output:\n{stdout}")
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
            f"{100 * bounds[row][0] / ms:.1f}% of it; sector floor "
            f"{bounds[row][2]:.4f} ms over their 32-byte sectors "
            f"({100 * bounds[row][2] / ms:.1f}% of it), "
            f"{bounds[row][3]:.4f} ms over the whole table")
    return rows


def phase_profile_sba(problem, opt):
    """Device time by kernel over one warm 10-iteration bench_sba
    solve."""
    from sba_tpu_torch.optim.sba import semantic_bundle_adjust

    return _profile("bench_sba SBA", lambda: semantic_bundle_adjust(
        problem, opt)[1].num_iterations, "LM it")


def _centre_error(tvec, cyl):
    import numpy as np

    return float(np.linalg.norm(np.asarray(tvec, np.float64) - cyl.tvec))


def _gsba_rates(problem, opt_kw):
    """bench.py's two readings of a warm solve: 10 / the median time of
    a 10-iteration solve, and `_delta_rate` (best of 4 interleaved 5-
    and 20-iteration solves, (20 - 5) / their difference). Returns (ms
    per LM iteration of the 10-iteration solve, its it/s, the per-added-
    iteration it/s)."""
    import numpy as np
    import torch

    from sba_tpu_torch.optim.gsba import (GSBAOptions,
                                          geometric_semantic_bundle_adjust)

    def run(n_it):
        o = GSBAOptions(**dict(opt_kw, max_iterations=n_it))
        torch.cuda.synchronize()
        t = time.perf_counter()
        float(geometric_semantic_bundle_adjust(problem, o)[1].final_cost)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(5)
    t10 = float(np.median([run(10) for _ in range(3)]))
    best = {5: float("inf"), 20: float("inf")}
    for _ in range(4):
        for n in best:
            best[n] = min(best[n], run(n))
    return t10 * 1e3 / 10, 10 / t10, 15 / (best[20] - best[5])


def phase_gsba():
    """Geometric-semantic BA at full width in float32: bench_gsba (cost,
    hard mean IoU and cylinder centre error must improve; the first LM
    step and cost against the float64 solve on the card; warm rates) and
    the 16-trunk forest (cost and mean own-view hard IoU improve, the
    final cost matches float64's; warm rate, chunks, peak memory). A
    trunk's own-view IoU may fall: sba_tpu's solve of a forest trades
    one trunk's views against the others' (one 1 - IoU residual per
    image against the union mask; tests/test_torch_gsba.py::
    test_forest_trunk_trade_matches_sba_tpu). Returns (bench_gsba's
    problem and options, its warm ms per LM iteration, the forest's
    problem, options and float32 summary)."""
    import numpy as np
    import torch

    from sba_tpu_torch.optim import gsba as tg
    from sba_tpu_torch.utils.synthetic import (make_gsba_forest_scene,
                                               make_gsba_scene)

    t = time.perf_counter()
    q, tv, cam, sem, cyl, q0, t0, cyl0 = make_gsba_scene(**GSBA_SCENE)
    log("gsba", f"bench_gsba scene ({GSBA_SCENE['num_images']} x "
        f"{GSBA_SCENE['image_size']}, {int((sem > 0).sum())} trunk "
        f"pixels) made on the host in {time.perf_counter() - t:.1f} s")
    opt = tg.GSBAOptions(**GSBA_OPT)
    probs = {dt: tg.build_gsba_problem(q0, t0, cam, sem, [cyl0], opt,
                                       dtype=dt, device="cuda")
             for dt in (torch.float32, torch.float64)}
    p32, p64 = probs[torch.float32], probs[torch.float64]
    iou0 = float(tg.evaluate_iou(p32).mean())
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, s = tg.geometric_semantic_bundle_adjust(p32, opt)
    c0, c1 = float(s.initial_cost), float(s.final_cost)
    wall = time.perf_counter() - t
    e0 = _centre_error(cyl0.tvec, cyl)
    e1 = _centre_error(out.cyl_tvec[0].cpu(), cyl)
    iou1 = float(s.mean_iou)
    require(s.num_iterations == GSBA_OPT["max_iterations"]
            and bool(torch.isfinite(out.cyl_tvec).all()),
            f"bench_gsba: {s.num_iterations} iterations")
    require(c1 < c0 and iou1 > iou0 and e1 < e0,
            f"bench_gsba: cost {c0} -> {c1}, hard mean IoU {iou0} -> "
            f"{iou1}, centre error {e0} -> {e1}")
    log("gsba", f"bench_gsba f32: cost {c0:.6g} -> {c1:.6g} in "
        f"{s.num_iterations} it, {wall:.2f} s cold; hard mean IoU "
        f"{iou0:.4f} -> {iou1:.4f}; cylinder centre error {e0:.5f} -> "
        f"{e1:.5f}")

    # The first LM step and the first iteration's cost, float32 against
    # float64 on the card.
    steps = {}
    for dt, p in probs.items():
        free = tg._free_vector(p, opt)
        g, H = tg._linearize(p, opt, free)
        lam = torch.as_tensor(1.0 / opt.initial_trust_radius, dtype=dt,
                              device="cuda")
        steps[dt] = tg._lm_step(H, g, lam, free)[0]
    _, s64 = tg.geometric_semantic_bundle_adjust(
        p64, tg.GSBAOptions(**dict(GSBA_OPT, max_iterations=1)))
    step_err = close("bench_gsba first LM step f32 vs f64",
                     steps[torch.float32], steps[torch.float64], 1e-3)
    cost_gap = [abs(float(s.cost_trace[i]) - float(s64.cost_trace[i]))
                / float(s64.cost_trace[i]) for i in (0, 1)]
    require(max(cost_gap) <= 1e-4,
            f"bench_gsba f32 vs f64 costs (initial, first iteration): "
            f"{cost_gap}")
    ms_it, rate10, rate_d = _gsba_rates(p32, GSBA_OPT)
    step_max = float(steps[torch.float64].abs().max())
    log("gsba", f"bench_gsba f32 vs f64 on the card: first LM step "
        f"|err| {step_err:.3e} (of {step_max:.3e}),"
        f" costs {cost_gap[0]:.2e} / {cost_gap[1]:.2e} relative; warm "
        f"10-iteration solve {ms_it:.2f} ms per LM iteration = "
        f"{rate10:.2f} LM it/s with its fixed costs; per added iteration "
        f"(bench.py _delta_rate, 5 and 20) {rate_d:.2f} LM it/s")
    del probs, p64

    t = time.perf_counter()
    q, tv, cam, sem, cyls, q0, t0, cyls0 = make_gsba_forest_scene(
        **FOREST_SCENE)
    log("gsba", f"forest scene ({len(cyls)} trunks x {len(q)} images x "
        f"{FOREST_SCENE['image_size']}) made on the host in "
        f"{time.perf_counter() - t:.1f} s")
    pf = tg.build_gsba_problem(q0, t0, cam, sem, cyls0, opt,
                               dtype=torch.float32, device="cuda")
    own = np.arange(len(q)) // FOREST_SCENE["cameras_per_cylinder"]

    def own_iou(iou):
        """Each trunk's mean hard IoU over its own close-up views."""
        iou = iou.cpu().numpy()[np.arange(len(q)), own]
        return np.array([iou[own == k].mean() for k in range(len(cyls))])

    own0 = own_iou(tg.evaluate_iou(pf))
    chunks = tg.image_chunks(pf)
    # The first solve warms up; with 3 iterations every LM step could be
    # rejected (the cost unchanged), 10 take about a second.
    on = tg.GSBAOptions(**dict(GSBA_OPT, max_iterations=FOREST_IT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _, sf = tg.geometric_semantic_bundle_adjust(pf, on)
    float(sf.final_cost)
    cold = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, sf = tg.geometric_semantic_bundle_adjust(pf, on)
    fc0, fc1 = float(sf.initial_cost), float(sf.final_cost)
    warm = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    own1 = own_iou(sf.per_image_iou)
    # The same solve in float64 (the path held to sba_tpu's on the CPU).
    p64 = tg.build_gsba_problem(q0, t0, cam, sem, cyls0, opt,
                                dtype=torch.float64, device="cuda")
    t = time.perf_counter()
    _, s64 = tg.geometric_semantic_bundle_adjust(p64, on)
    c64 = float(s64.final_cost)
    wall64 = time.perf_counter() - t
    own64 = own_iou(s64.per_image_iou)
    require(fc1 < fc0 and own1.mean() > own0.mean(),
            f"forest: cost {fc0} -> {fc1}, mean own-view hard IoU "
            f"{own0.mean()} -> {own1.mean()}")
    require(abs(fc1 - c64) <= 1e-3 * c64,
            f"forest: float32 final cost {fc1} against float64 {c64}")
    fell = np.nonzero(own1 < own0)[0].tolist()
    fell64 = np.nonzero(own64 < own0)[0].tolist()
    log("gsba", f"forest f32: cost {fc0:.6g} -> {fc1:.6g} in {FOREST_IT} "
        f"it (float64 {c64:.6g}, {wall64:.2f} s); own-view hard IoU mean "
        f"{own0.mean():.4f} -> {own1.mean():.4f} (float64 "
        f"{own64.mean():.4f}), largest f32-f64 gap "
        f"{np.abs(own1 - own64).max():.4f}; trunks whose own-view IoU "
        f"fell: {fell} (float64 {fell64}); warm {FOREST_IT}-iteration "
        f"solve {warm * 1e3:.1f} ms = {FOREST_IT / warm:.2f} LM it/s with "
        f"its fixed costs ({cold:.2f} s for the first); "
        f"{len(chunks)} chunks of up to {chunks[0].stop} images under "
        f"{tg.GSBA_CHUNK_BYTES / 2 ** 30:.0f} GiB; peak device memory "
        f"{peak:.1f} MiB (float32)")
    del p64
    return (p32, opt), ms_it, (pf, on, sf)


def _write_gsba_workspace(work, scene):
    """A SIMPLE_PINHOLE model of the scene's initial poses, its semantic
    TIFF maps and the perturbed cylinder."""
    import numpy as np

    from sba_tpu_torch.geometry import camera_models
    from sba_tpu_torch.io.colmap_models import Camera, Image
    from sba_tpu_torch.io.maps import write_float_map_tiff
    from sba_tpu_torch.models.cylinder import write_cylinders_text
    from sba_tpu_torch.models.reconstruction import Reconstruction

    q, tv, cam, sem, cyl, q0, t0, cyl0 = scene
    n, h, w = sem.shape
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
        write_float_map_tiff(sem[i], work / "maps" / f"im{i}_semantic.tiff")
    rec.write(str(work / "in"))
    write_cylinders_text([cyl0], work / "cylinders.txt")


def phase_cli_gsba():
    """geometric_semantic_bundle_adjuster on the card at its defaults
    (float64): the printed line, and the output cylinder's centre closer
    to the truth."""
    from sba_tpu_torch.models.cylinder import read_cylinders_text
    from sba_tpu_torch.ops import cuda_build
    from sba_tpu_torch.utils.synthetic import make_gsba_scene

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="cli_gsba_",
                                 dir=cuda_build.BUILD_DIR))
    try:
        scene = make_gsba_scene(**GSBA_CLI_SCENE)
        _write_gsba_workspace(work, scene)
        stdout, wall = _run_frontend_cli(
            ["geometric_semantic_bundle_adjuster",
             "--input_path", str(work / "in"),
             "--output_path", str(work / "out"),
             "--data_path", str(work / "maps"),
             "--input_geometry", str(work / "cylinders.txt")],
            "geometric_semantic_bundle_adjuster")
        m = re.search(r"GSBA: cost (\S+) -> (\S+), mean IoU (\S+)", stdout)
        require(m is not None, f"unexpected CLI output:\n{stdout}")
        c0, c1, iou = (float(x) for x in m.groups())
        (out,) = read_cylinders_text(work / "out" / "cylinders.txt")
        cyl, cyl0 = scene[4], scene[7]
        e0, e1 = _centre_error(cyl0.tvec, cyl), _centre_error(out.tvec, cyl)
        require(c1 < c0 and e1 < e0,
                f"CLI: cost {c0} -> {c1}, centre error {e0} -> {e1}")
        log("cli-gsba", f"defaults (cuda, float64), "
            f"{GSBA_CLI_SCENE['num_images']} x "
            f"{GSBA_CLI_SCENE['image_size']}: cost {c0:.6g} -> {c1:.6g}, "
            f"mean IoU {iou:.4f}; cylinder centre error {e0:.5f} -> "
            f"{e1:.5f}; {wall:.1f} s wall")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_profile_gsba(problem, opt):
    """Device time by kernel over one warm 10-iteration bench_gsba
    solve."""
    from sba_tpu_torch.optim.gsba import geometric_semantic_bundle_adjust

    return _profile("bench_gsba GSBA", lambda: (
        geometric_semantic_bundle_adjust(problem, opt)[1].num_iterations),
        "LM it")


# ---------------------------------------------------------------------------
# The front end: SIFT (gradient taps through map_gather), matching, E/F/H
# verification, and the three commands at full width
# ---------------------------------------------------------------------------

# 24 views of 1600x1200 on a ring, focal at the extractor's default prior
# (1.2 x the longer side, the value a camera without EXIF gets).
FRONTEND_SCENE = dict(num_images=24, image_size=(1600, 1200),
                      focal=1.2 * 1600, seed=7)
TWINS_FRONTEND_SIZE = (320, 240)
TWINS_VERIFY_PAIRS = 3    # of the 6; the CPU side's verification is slow
PROFILE_PAIRS = 16        # pairs matched and verified under the profiler
TWIN_FULL_PAIRS = 4       # full-width pairs verified on the card and CPU
PLANAR_DUMP_MATCHES = 2   # PLANAR pairs written with all their matches
# Gates, set from probes on the card (PERF.md section 6, PR 14). A PLANAR
# pair's stored rotation is held at 7 deg: one of H's two decompositions
# that pass the cheirality vote with every point is 4.8204 deg off, and
# sba_tpu's tie-break takes it (tests/test_torch_frontend.py::
# test_planar_pose_of_card_homographies); the best decomposition is held
# at max_rot_deg.
FRONTEND_GATES = dict(min_features=1000, min_inliers=15, max_rot_deg=2.0,
                      max_rot_planar_deg=7.0, max_dir_deg=10.0)
CUSOLVER = r"syevj|gesvdj|gesvd|getrf|getrs|geqrf|orgqr|potrf|cusolver|" \
    r"batched_svd|jacobi|trsm|ormqr|lu_"


def _frontend_rows(ft_a, ft_b):
    """Rows of `ft_a` (keypoints [K, 4], mask [K]) with a row of `ft_b`
    within 1e-3 px in x, y and scale and 1e-3 rad in orientation: (share
    of a's valid rows, index into b per a row or -1)."""
    import torch

    ka, kb = ft_a[0][ft_a[1]], ft_b[0][ft_b[1]]
    d = (ka[:, None, :] - kb[None, :, :]).abs()
    d[..., 3] = torch.minimum(d[..., 3], 2 * torch.pi - d[..., 3])
    worst = d.amax(-1)
    best = worst.argmin(1)
    ok = worst.gather(1, best[:, None])[:, 0] <= 1e-3
    return float(ok.float().mean()), torch.where(ok, best, -1)


def _fixed_draws(kind, trials, pairs, masks_r):
    """Deterministic CPU draws per (family, trials, pair), so the card and
    the CPU verify with the same samples."""
    import torch

    from sba_tpu_torch.optim.ransac import draw_samples

    ssz = {"F": 7, "H": 4, "E": 5}[kind]
    out = []
    for p in pairs:
        g = torch.Generator().manual_seed(
            1000003 * int(p) + 7919 * trials + ord(kind))
        out.append(draw_samples(masks_r.shape[1], trials, ssz,
                                mask=torch.as_tensor(masks_r[p]),
                                generator=g))
    return torch.stack(out).numpy()


def phase_twins_frontend():
    """The front end on the card against the port's own CPU path on the
    same inputs: SIFT of one 320x240 view (map_gather launches counted),
    the batched matcher on one descriptor stack, and the batched verifier
    with the same sample tensors."""
    import numpy as np
    import torch

    from sba_tpu_torch.estimators.two_view_geometry import (
        estimate_two_view_geometry_batch, pack_matches)
    from sba_tpu_torch.features.matching import match_pairs_batched
    from sba_tpu_torch.features.sift import (descriptors_to_uint8,
                                             extract_sift)
    from sba_tpu_torch.ops import map_gather
    from sba_tpu_torch.utils.render import render_scene

    w, h = TWINS_FRONTEND_SIZE
    scene = render_scene(num_images=4, image_size=(w, h), focal=1.2 * w,
                         seed=5, device="cuda")
    imgs = scene["images"].astype(np.float32) / 255.0
    map_gather.reset_launches()
    card = [extract_sift(im, device="cuda") for im in imgs]
    torch.cuda.synchronize()
    launches = map_gather.LAUNCHES["map_gather"]
    require(launches == 2 * len(imgs),
            f"SIFT: map_gather launched {launches} times for {len(imgs)} "
            "images (expected two each)")
    cpu = [extract_sift(im, device="cpu") for im in imgs]
    shares, dshares = [], []
    for c, p in zip(card, cpu):
        kc = (c.keypoints.cpu(), c.mask.cpu())
        share, idx = _frontend_rows(kc, (p.keypoints, p.mask))
        uc = descriptors_to_uint8(c.descriptors.cpu())[kc[1]][idx >= 0]
        up = descriptors_to_uint8(p.descriptors)[p.mask][idx[idx >= 0]]
        dshares.append(float(((uc.int() - up.int()).abs() <= 1)
                             .float().mean()))
        shares.append(share)
        require(int(c.mask.sum()) > 200,
                f"SIFT on the card: {int(c.mask.sum())} features")
    require(min(shares) >= 0.98 and min(dshares) >= 0.99,
            f"SIFT card vs CPU: rows within 1e-3 {shares}, u8 descriptors "
            f"within 1 {dshares}")
    log("twins-frontend", f"SIFT {len(imgs)} x {w}x{h}: features "
        f"{[int(c.mask.sum()) for c in card]}; rows of the card with a CPU "
        f"row within 1e-3 px / 1e-3 rad {[round(s, 4) for s in shares]}; "
        f"u8 descriptor entries within 1 {[round(s, 5) for s in dshares]}; "
        f"map_gather launches {launches}")

    # One descriptor stack (the CPU path's u8 rows), matched on both.
    n = max(int(p.mask.sum()) for p in cpu)
    npad = max(256, -(-n // 256) * 256)
    stack = np.zeros((len(cpu), npad, 128), np.uint8)
    nvalid = np.zeros(len(cpu), np.int32)
    kps = []
    for i, p in enumerate(cpu):
        d = descriptors_to_uint8(p.descriptors)[p.mask].numpy()
        stack[i, :len(d)] = d
        nvalid[i] = len(d)
        kps.append(p.keypoints[p.mask][:, :2].double().numpy())
    pairs = np.array([(a, b) for a in range(4) for b in range(a + 1, 4)])
    mc, _ = match_pairs_batched(torch.as_tensor(stack, device="cuda"),
                                torch.as_tensor(nvalid, device="cuda"), pairs)
    mp, _ = match_pairs_batched(torch.as_tensor(stack),
                                torch.as_tensor(nvalid), pairs)
    mc = mc.cpu().numpy()
    mp = mp.numpy()
    rows = int(nvalid[pairs[:, 0]].sum())
    diff = int((mc != mp).sum())
    require(diff <= 0.001 * rows,
            f"matcher card vs CPU: {diff} of {rows} rows differ")
    log("twins-frontend", f"match_pairs_batched {len(pairs)} pairs: "
        f"{int((mp >= 0).sum())} matches; {diff} of {rows} rows differ")

    matches = []
    for j, (a, b) in enumerate(pairs):
        i1 = np.nonzero(mp[j] >= 0)[0]
        matches.append((a, b, np.stack([i1, mp[j][i1]], -1)))
    matches = matches[:TWINS_VERIFY_PAIRS]
    xy1, xy2, vm = pack_matches(kps, matches)
    cam = np.tile([[1.2 * w, 1.2 * w, w / 2, h / 2]], (len(matches), 1))
    sizes = [(w, h)] * len(matches)
    res = {}
    for dev in ("cuda", "cpu"):
        res[dev] = estimate_two_view_geometry_batch(
            xy1, xy2, vm, cam, cam, sizes, sizes, dtype=torch.float32,
            device=dev, draw_fn=_fixed_draws)
    cfg = [(r.config, q.config) for r, q in zip(res["cuda"], res["cpu"])]
    inl = [(r.num_inliers, q.num_inliers)
           for r, q in zip(res["cuda"], res["cpu"])]
    require(all(a == b for a, b in cfg)
            and all(abs(a - b) <= 0.01 * max(b, 1) for a, b in inl),
            f"verifier card vs CPU: configurations {cfg}, inliers {inl}")
    log("twins-frontend", f"estimate_two_view_geometry_batch {len(matches)} "
        f"pairs, same draws: configurations {[a for a, _ in cfg]} equal; "
        f"inliers card/CPU {inl}")
    return launches


def _run_frontend_cli(args, tag):
    """`python -m sba_tpu_torch.cli <args>` in this process (the same
    entry point, without a second process start and kernel load):
    (printed output, wall seconds)."""
    import contextlib
    import io

    from sba_tpu_torch import cli

    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            code = cli.main(list(args))
    except SystemExit as e:
        code = e.code
    wall = time.perf_counter() - t
    out = buf.getvalue()
    require(code == 0, f"{tag}: exit {code}:\n{out[-3000:]}")
    return out, wall


def _rot_deg(Ra, Rb):
    import numpy as np

    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _frontend_gates(db_path, scene, ring, tag, planar_out=None):
    """Features per image, and the ring-neighbour pairs' inliers and
    relative pose against the scene's truth; of a PLANAR pair also the
    best of its H's decompositions (the stored pose takes the one
    sba_tpu's cheirality vote and tie-break pick). `planar_out`: a path
    where the PLANAR ring pairs' H, intrinsics, true and stored poses and
    errors go (np.savez_compressed), with all matched keypoints of the
    PLANAR_DUMP_MATCHES pairs whose rotation errs most: the input of
    tests/test_torch_frontend.py::test_planar_pose_of_card_homographies."""
    import numpy as np

    from sba_tpu_torch.estimators.homography_matrix import \
        decompose_homography
    from sba_tpu_torch.geometry import camera_models
    from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat
    from sba_tpu_torch.io.database import Database

    g = FRONTEND_GATES
    db = Database(str(db_path))
    try:
        ids = sorted(db.read_images())
        feats = [db.num_keypoints_for_image(i) for i in ids]
        tvg = db.read_all_two_view_geometries()
        cams, images = db.read_cameras(), db.read_images()

        def K(iid):
            cam = cams[images[iid]["camera_id"]]
            spec = camera_models.model_by_id(cam["model_id"])
            p = cam["params"]
            fi, ci = spec.focal_idxs, spec.principal_idxs
            return np.array([[p[fi[0]], 0, p[ci[0]]],
                             [0, p[fi[-1]], p[ci[1]]], [0, 0, 1.0]])

        R = [np_quat_to_rotmat(q) for q in scene["qvecs"]]
        worst = dict(inliers=10 ** 9, rot={2: 0.0, 4: 0.0}, dir=0.0,
                     h_best=0.0)
        configs = {}
        planar = []
        for a, b in ring:
            key = (ids[a], ids[b])
            require(key in tvg, f"{tag}: pair {key} not verified")
            geo = tvg[key]
            n = len(geo["inlier_matches"])
            Rr = R[b] @ R[a].T
            tr = scene["tvecs"][b] - Rr @ scene["tvecs"][a]
            rot = _rot_deg(np_quat_to_rotmat(geo["qvec"]), Rr)
            cfg = geo["config"]
            configs[cfg] = configs.get(cfg, 0) + 1
            worst["inliers"] = min(worst["inliers"], n)
            require(cfg in (2, 4) and n >= g["min_inliers"],
                    f"{tag}: pair {key}: config {cfg}, {n} inliers")
            worst["rot"][cfg] = max(worst["rot"][cfg], rot)
            lim = g["max_rot_deg"] if cfg == 2 else g["max_rot_planar_deg"]
            require(rot <= lim, f"{tag}: pair {key}: config {cfg}, "
                    f"rotation error {rot:.3f} deg")
            if cfg == 4:
                Ks = (K(key[0]), K(key[1]))
                Rs, _, _ = decompose_homography(np.asarray(geo["H"]), *Ks)
                best = min(_rot_deg(np.asarray(Rc), Rr) for Rc in Rs)
                worst["h_best"] = max(worst["h_best"], best)
                require(best <= g["max_rot_deg"],
                        f"{tag}: pair {key}: no decomposition of H within "
                        f"{g['max_rot_deg']} deg (best {best:.3f})")
                planar.append((rot, key, geo, Rr, tr) + Ks)
            if cfg == 2:
                t = np.asarray(geo["tvec"])
                c = float(t @ tr / (np.linalg.norm(t) * np.linalg.norm(tr)))
                ang = float(np.degrees(np.arccos(np.clip(c, -1, 1))))
                worst["dir"] = max(worst["dir"], ang)
                require(ang <= g["max_dir_deg"],
                        f"{tag}: pair {key}: translation direction error "
                        f"{ang:.3f} deg")
        require(min(feats) >= g["min_features"],
                f"{tag}: features per image {feats}")
        n_ok = sum(len(v["inlier_matches"]) >= g["min_inliers"]
                   for v in tvg.values())
        if planar_out is not None and planar:
            _dump_planar(db, planar, planar_out)
    finally:
        db.close()
    log("frontend", f"{tag}: features per image min {min(feats)} / mean "
        f"{np.mean(feats):.0f} / max {max(feats)}; {len(ring)} ring pairs: "
        f"configs {configs}, min inliers {worst['inliers']}, max rotation "
        f"error {worst['rot'][2]:.4f} deg CALIBRATED, {worst['rot'][4]:.4f} "
        f"deg PLANAR (the best of each PLANAR H's decompositions: max "
        f"{worst['h_best']:.4f} deg), max translation direction error "
        f"{worst['dir']:.4f} deg (CALIBRATED); {n_ok}/{len(tvg)} stored "
        f"pairs with >= {g['min_inliers']} inliers")


def _dump_planar(db, planar, path):
    """See _frontend_gates; planar: (rotation error, pair, geometry,
    true R, true t, K1, K2) per PLANAR pair."""
    import numpy as np

    planar = sorted(planar, key=lambda x: -x[0])
    cols = list(zip(*planar))
    out = dict(
        pairs=np.array(cols[1]), rot_err_deg=np.array(cols[0]),
        H=np.stack([np.asarray(geo["H"]) for geo in cols[2]]),
        qvec=np.stack([np.asarray(geo["qvec"]) for geo in cols[2]]),
        R_true=np.stack(cols[3]), t_true=np.stack(cols[4]),
        K1=np.stack(cols[5]), K2=np.stack(cols[6]))
    for j, (i1, i2) in enumerate(cols[1][:PLANAR_DUMP_MATCHES]):
        m = db.read_matches(i1, i2).astype(np.int64)
        out[f"xy1_{j}"] = db.read_keypoints(i1)[m[:, 0], :2]
        out[f"xy2_{j}"] = db.read_keypoints(i2)[m[:, 1], :2]
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    log("frontend", f"{len(planar)} PLANAR ring pairs (and the matches of "
        f"{min(len(planar), PLANAR_DUMP_MATCHES)}) written to {path}")


def phase_frontend():
    """feature_extractor, exhaustive_matcher and sequential_matcher of
    `python -m sba_tpu_torch.cli` at their defaults on the card (24 views
    of 1600x1200, 8192 features, batches of 8 images and 32 pairs,
    4096 trials), gated on the scene's true poses. Returns the scene and
    the work directory (images, the exhaustive database), which the
    mapper phases use and remove."""
    import numpy as np

    from sba_tpu_torch.ops import cuda_build, map_gather
    from sba_tpu_torch.utils.render import render_scene

    t = time.perf_counter()
    scene = render_scene(device="cuda", **FRONTEND_SCENE)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="frontend_",
                                 dir=cuda_build.BUILD_DIR))
    from PIL import Image as PILImage

    (work / "imgs").mkdir()
    for k, im in enumerate(scene["images"]):
        PILImage.fromarray(im).save(work / "imgs" / f"view{k:03d}.png",
                                    compress_level=1)
    n = FRONTEND_SCENE["num_images"]
    log("frontend", f"rendered and wrote {n} x "
        f"{FRONTEND_SCENE['image_size']} in {time.perf_counter() - t:.1f} s")
    try:
        db = work / "db.db"
        map_gather.reset_launches()
        out, wall = _run_frontend_cli(
            ["feature_extractor", "--database_path", str(db),
             "--image_path", str(work / "imgs")], "feature_extractor")
        m = re.search(r"extraction: (\S+) s for (\d+) images \((\S+) "
                      r"images/s\)", out)
        k = re.search(r"kernel launches: (\{.*\})", out)
        require(m is not None and k is not None,
                f"feature_extractor output:\n{out[-2000:]}")
        launches = json.loads(k.group(1))["map_gather"]
        require(launches > 0 and launches == map_gather.LAUNCHES["map_gather"],
                f"feature_extractor: map_gather launches {launches}")
        log("frontend", f"feature_extractor: {m.group(3)} images/s "
            f"({m.group(1)} s of extraction calls for {m.group(2)} images), "
            f"{wall:.1f} s wall; map_gather launches {launches} "
            f"({launches / n:.3f} per image)")
        shutil.copy(db, work / "seq.db")
        rates = {}
        for cmd, path in (("exhaustive_matcher", db),
                          ("sequential_matcher", work / "seq.db")):
            out, wall = _run_frontend_cli(
                [cmd, "--database_path", str(path)], cmd)
            m = re.search(r"match (\S+) s, verify (\S+) s, host/db (\S+) s "
                          r"for (\d+) pairs \((\S+) pairs/s", out)
            v = re.search(r"verified (\d+)/(\d+) pairs", out)
            require(m is not None and v is not None,
                    f"{cmd} output:\n{out[-2000:]}")
            rates[cmd] = float(m.group(5))
            log("frontend", f"{cmd}: {v.group(1)}/{v.group(2)} pairs "
                f"verified; match {m.group(1)} s, verify {m.group(2)} s, "
                f"host/db {m.group(3)} s; {m.group(5)} pairs/s matched and "
                f"verified; {wall:.1f} s wall")
        ring = [(i, i + 1) for i in range(n - 1)]
        _frontend_gates(db, scene, ring + [(0, n - 1)], "exhaustive",
                        ROOT / "chiprun_out" / "frontend_planar.npz")
        _frontend_gates(work / "seq.db", scene, ring, "sequential")
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    return scene, work


# The first SIFT gather of phase twins-frontend's full-width batch (its
# table, indices and form), timed in phase timing.
SIFT_GATHER = {}


def _gather_checked(extract):
    """`extract()` with every launch of SIFT's map_gather held bit-equal
    to map_gather_plain on the same card tensors: (its result, (samples,
    table words) per launch)."""
    import torch

    from sba_tpu_torch.features import sift
    from sba_tpu_torch.ops import map_gather as mg

    calls, same = [], []

    def checked(table, idx, *args):
        out = mg.map_gather(table, idx, *args)
        same.append(torch.equal(out, mg.map_gather_plain(table, idx, *args)))
        calls.append((idx.numel(), table.numel()))
        if not SIFT_GATHER:
            SIFT_GATHER.update(table=table, idx=idx, args=args)
        return out

    sift.map_gather = checked
    try:
        out = extract()
    finally:
        sift.map_gather = mg.map_gather
    require(bool(calls) and all(same),
            f"map_gather against map_gather_plain: launches (samples, "
            f"table words) {calls}, bit-equal {same}")
    return out, calls


def phase_twins_frontend_full(scene):
    """The front end's kernel and verifier on the card against the plain
    path at the frontend phase's shapes: one batch of 8 views of
    1600x1200 extracted with each map_gather launch checked bit-equal to
    map_gather_plain, its pairs matched on the card, and the
    TWIN_FULL_PAIRS pairs with the most matches (past the 512 cap, so
    the cap's subsampling and the full-set re-evaluation run) verified on
    the card and on the CPU with the same draws, under a memory budget
    that sub-batches the 5-point RANSAC two pairs a launch.
    Returns what the profile reuses."""
    import numpy as np
    import torch

    from sba_tpu_torch.estimators import two_view_geometry as tvg
    from sba_tpu_torch.features.matching import match_pairs_batched
    from sba_tpu_torch.features.sift import extract_sift_batch

    imgs = scene["images"][:8].astype(np.float32) / 255.0
    (kps, desc, mask), calls = _gather_checked(
        lambda: extract_sift_batch(imgs, device="cuda"))
    h, w = imgs.shape[1:]
    log("twins-frontend", f"SIFT {len(imgs)} x {w}x{h} on the card: "
        f"{len(calls)} map_gather launches of {[c[0] for c in calls]} "
        f"samples over {calls[0][1]} table words, each bit-equal to "
        "map_gather_plain on the same card tensors")

    I = len(imgs)
    nvalid = mask.sum(1).astype(np.int32)
    stack = np.zeros((I, -(-int(nvalid.max()) // 256) * 256, 128), np.uint8)
    for i in range(I):
        stack[i, :nvalid[i]] = desc[i][mask[i]]
    sd = torch.as_tensor(stack, device="cuda")
    nv = torch.as_tensor(nvalid, device="cuda")
    xy = [kps[i][mask[i]][:, :2].astype(np.float64) for i in range(I)]
    pairs = np.array([(a, b) for a in range(I) for b in range(a + 1, I)])
    m, _ = match_pairs_batched(sd, nv, pairs)
    m = m.cpu().numpy()
    matches = []
    for j, (a, b) in enumerate(pairs):
        i1 = np.nonzero(m[j] >= 0)[0]
        matches.append((a, b, np.stack([i1, m[j][i1]], -1)))
    sel = sorted(matches, key=lambda x: -len(x[2]))[:TWIN_FULL_PAIRS]
    cap = tvg._TVG_RANSAC_CAP
    require(len(sel[-1][2]) > cap,
            f"full-width pairs' matches {[len(x[2]) for x in sel]}: not "
            f"past the cap of {cap}")
    xy1, xy2, vm = tvg.pack_matches(xy, sel)
    f = FRONTEND_SCENE["focal"]
    cam = np.tile([[f, f, w / 2, h / 2]], (len(sel), 1))
    sizes = [(w, h)] * len(sel)
    budget = tvg.SUB_BATCH_BYTES
    # Two pairs a launch at the 5-point RANSAC's first round (256 trials
    # x 10 models x the capped correspondences x 4 bytes each).
    tvg.SUB_BATCH_BYTES = 2 * 256 * 10 * cap * 4
    res = {}
    try:
        for dev in ("cuda", "cpu"):
            t = time.perf_counter()
            res[dev] = tvg.estimate_two_view_geometry_batch(
                xy1, xy2, vm, cam, cam, sizes, sizes, dtype=torch.float32,
                device=dev, draw_fn=_fixed_draws)
            res[dev, "s"] = time.perf_counter() - t
    finally:
        tvg.SUB_BATCH_BYTES = budget
    cfg = [(r.config, q.config) for r, q in zip(res["cuda"], res["cpu"])]
    inl = [(r.num_inliers, q.num_inliers)
           for r, q in zip(res["cuda"], res["cpu"])]
    require(all(a == b for a, b in cfg)
            and all(abs(a - b) <= 0.01 * max(b, 1) for a, b in inl),
            f"verifier card vs CPU at full width: configurations {cfg}, "
            f"inliers {inl}")
    log("twins-frontend", f"estimate_two_view_geometry_batch on "
        f"{len(sel)} full-width pairs of {[len(x[2]) for x in sel]} "
        f"matches (bucket {vm.shape[1]}, RANSAC on {cap} each, 5-point "
        f"RANSAC two pairs a launch), same draws: configurations "
        f"{[a for a, _ in cfg]} equal; inliers card/CPU {inl}; card "
        f"{res['cuda', 's']:.2f} s, CPU {res['cpu', 's']:.2f} s")
    return imgs, sd, nv, xy, pairs


def phase_profile_frontend(full):
    """Device time of one batch of 8 images extracted and of one batch
    of PROFILE_PAIRS pairs matched and verified (torch.profiler): per
    image and per pair, busy share, map_gather's launches and time per
    image, and the top device operations with cuSOLVER's apart. `full`:
    the batch of phase_twins_frontend_full (already warm)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sba_tpu_torch.estimators.two_view_geometry import (
        estimate_two_view_geometry_batch, pack_matches)
    from sba_tpu_torch.features.matching import match_pairs_batched
    from sba_tpu_torch.features.sift import (SiftExtractionOptions,
                                             extract_sift_batch)
    from sba_tpu_torch.ops import map_gather

    imgs, sd, nv, xy, pairs = full
    pairs = pairs[:PROFILE_PAIRS]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def run(label, fn, n, unit):
        torch.cuda.synchronize()
        map_gather.reset_launches()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        ev = _device_totals(prof)
        busy = sum(dev_us(e) for e in ev)
        gat = [e for e in ev if "b_map_gather" in e.key]
        sol = [e for e in ev if re.search(CUSOLVER, e.key, re.I)]
        if busy <= 0:
            log("profile", f"{label}: the profiler saw no device time: "
                "busy share not measured")
            return out
        log("profile", f"{label}: device {busy / 1e3 / n:.3f} ms/{unit} "
            f"({busy / 1e3:.1f} ms for {n}), busy "
            f"{100 * busy / 1e6 / wall:.1f}% of {wall * 1e3:.1f} ms "
            f"profiled wall; map_gather "
            f"{map_gather.LAUNCHES['map_gather']} launches, "
            f"{sum(map(dev_us, gat)) / 1e3 / n:.4f} ms/{unit}; cuSOLVER "
            f"{sum(map(dev_us, sol)) / 1e3 / n:.3f} ms/{unit} "
            f"({100 * sum(map(dev_us, sol)) / busy:.1f}% of device time, "
            f"{sum(e.count for e in sol)} launches)")
        for e in sorted(ev, key=dev_us, reverse=True)[:10]:
            log("profile", f"{dev_us(e) / 1e3:8.3f} ms {e.count:6d}x "
                f"{'[cuSOLVER] ' if e in sol else ''}{e.key[:70]}")
        return out

    run("front end: SIFT 8 x 1600x1200",
        lambda: extract_sift_batch(imgs, device="cuda"), len(imgs), "image")
    # map_gather's floor at SIFT's index law: each launch reads an int32
    # index and writes a word per sample (table reads not counted); a
    # sample per grid point (256) of every candidate row of the batch.
    opt = SiftExtractionOptions()
    h, w = imgs.shape[1:]
    n_oct = min(opt.num_octaves,
                max(1, int(np.floor(np.log2(min(h, w) / 16.0))) + 1))
    rows = min(opt.max_num_features, n_oct * opt.desc_candidates_per_octave)
    samples = len(imgs) * rows * 256
    log("profile", f"front end: map_gather at SIFT's index law: "
        f"{samples} samples a launch (orientation, then descriptors); "
        f"floor of its indices and output "
        f"{samples * 8 / HBM_BYTES_PER_S * 1e3:.4f} ms a launch (table "
        f"reads not counted)")
    w, h = FRONTEND_SCENE["image_size"]
    f = FRONTEND_SCENE["focal"]

    def match_and_verify(pairs=pairs):
        """The matcher commands' device path (cli._match_and_verify)
        without the database."""
        m, _ = match_pairs_batched(sd, nv, pairs)
        m = m.cpu().numpy()
        matches = []
        for j, (a, b) in enumerate(pairs):
            i1 = np.nonzero(m[j] >= 0)[0]
            if len(i1):
                matches.append((a, b, np.stack([i1, m[j][i1]], -1)))
        xy1, xy2, vm = pack_matches(xy, matches)
        cam = np.tile([[f, f, w / 2, h / 2]], (len(matches), 1))
        return estimate_two_view_geometry_batch(
            xy1, xy2, vm, cam, cam, [(w, h)] * len(matches),
            [(w, h)] * len(matches), dtype=torch.float32, device="cuda")

    match_and_verify(pairs[:2])                      # warm
    run(f"front end: match + verify {len(pairs)} pairs", match_and_verify,
        len(pairs), "pair")


# ---------------------------------------------------------------------------
# The incremental mapper: mapper, point_triangulator, image registration
# step twins and automatic_reconstructor on the frontend phase's database
# ---------------------------------------------------------------------------

# Gates on a mapped model against the rendered truth (sba_tpu's own ATE
# bound, tests/test_e2e_reconstruction.py:74-77: 5% of the ring radius),
# set from probes on the card (PERF.md section 6, the mapper).
MAPPER_GATES = dict(max_reproj_px=1.0, max_ate_frac=0.05,
                    max_rel_rot_deg=1.0, min_points=1000)
RING_RADIUS = 1.6         # utils/render.py::render_scene's default
AUTO_VIEWS = 8            # views of the automatic_reconstructor phase
TWIN_LOCAL_BA_IT = 10     # LM iterations of twins-mapper's local BA
TRI_MAX_ERR_FRAC = 0.01   # point_triangulator: median height error / depth


def _scene_index(name):
    return int(re.search(r"view(\d+)\.png", name).group(1))


def _model_gates(model_dir, scene, expect, tag, gates=None):
    """The mapped model in `model_dir` against the scene's truth: all
    `expect` views registered, mean reprojection error, mean ATE of the
    camera centres after a similarity (umeyama) onto the true ones, the
    rotation between consecutive views against the truth, the points."""
    import numpy as np
    import torch

    from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat
    from sba_tpu_torch.geometry.similarity import umeyama
    from sba_tpu_torch.models.reconstruction import Reconstruction

    g = MAPPER_GATES if gates is None else gates
    rec = Reconstruction.read(str(model_dir))
    ids = sorted(rec.images, key=lambda i: _scene_index(rec.images[i].name))
    ks = [_scene_index(rec.images[i].name) for i in ids]
    R = {k: np_quat_to_rotmat(rec.images[i].qvec) for k, i in zip(ks, ids)}
    c_est = np.stack([-R[k].T @ rec.images[i].tvec for k, i in zip(ks, ids)])
    Rg = {k: np_quat_to_rotmat(scene["qvecs"][k]) for k in ks}
    c_gt = np.stack([-Rg[k].T @ scene["tvecs"][k] for k in ks])
    s, Rs, t = umeyama(torch.as_tensor(c_est), torch.as_tensor(c_gt))
    aligned = (float(s) * c_est @ Rs.numpy().T) + t.numpy()
    ate = float(np.mean(np.linalg.norm(aligned - c_gt, axis=1)))
    rel = [_rot_deg(R[b] @ R[a].T, Rg[b] @ Rg[a].T)
           for a, b in zip(ks[:-1], ks[1:]) if b == a + 1]
    reproj = rec.compute_mean_reprojection_error()
    out = dict(views=len(ids), reproj=reproj, ate=ate,
               ate_frac=ate / RING_RADIUS, rel_rot=max(rel),
               points=rec.num_points3d())
    log(tag, f"model: {len(ids)} views (expected {expect}), "
        f"{out['points']} points, mean reprojection error {reproj:.4f} px, "
        f"mean ATE {ate:.5f} ({100 * out['ate_frac']:.3f}% of the ring "
        f"radius), max rotation error between consecutive views "
        f"{out['rel_rot']:.4f} deg")
    require(len(ids) == expect and reproj < g["max_reproj_px"]
            and out["ate_frac"] < g["max_ate_frac"]
            and out["rel_rot"] < g["max_rel_rot_deg"]
            and out["points"] >= g["min_points"],
            f"{tag}: model outside MAPPER_GATES: {out}")
    return out


_MAPPER_STATS = (r"mapper: (\S+) s, (\d+) registrations \((\S+) "
                 r"registrations/s\); BA (\S+) s \(local (\d+) BAs, (\d+) "
                 r"LM it; global (\d+) BAs, (\d+) LM it\), RANSAC (\S+) s, "
                 r"host (\S+) s")


def _mapper_stats(out, tag):
    m = re.search(_MAPPER_STATS, out)
    require(m is not None, f"{tag} output:\n{out[-2000:]}")
    v = [float(x) for x in m.groups()]
    wall, ba, ransac, host = v[0], v[3], v[8], v[9]
    log(tag, f"{v[1]:.0f} registrations in {wall:.1f} s "
        f"({v[2]:.4f} registrations/s); {v[4]:.0f} local BAs ({v[5]:.0f} "
        f"LM it), {v[6]:.0f} global BAs ({v[7]:.0f} LM it); wall in BA "
        f"{100 * ba / wall:.1f}%, RANSAC {100 * ransac / wall:.1f}%, host "
        f"{100 * host / wall:.1f}%")
    return dict(wall=wall, ba=ba, ransac=ransac, host=host)


class _Utilization:
    """The card's busy share over a stretch of wall time: NVML's
    utilization.gpu (the share of each sample period in which a kernel
    ran), read by `nvidia-smi` every 100 ms in a child process that the
    context stops. (torch.profiler over a whole mapper run records ~1M
    device events; reading them back took ~67 s of the smoke.)"""

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "100", "-i", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        self.samples, self.share = 0, None
        if self.proc is None:
            return False
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = [float(v) for v in out.split() if v.strip().isdigit()]
        self.samples = len(vals)
        self.share = sum(vals) / len(vals) / 100.0 if vals else None
        return False


def phase_mapper(scene, work):
    """`python -m sba_tpu_torch.cli mapper` at its defaults on the card on
    the frontend phase's exhaustive database (24 x 1600x1200, 8192
    features, SIMPLE_RADIAL), in this process; the device's busy share
    over the run (`_Utilization`); MAPPER_GATES on model 0. Returns the
    initial pair and its two-view seed."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _Utilization() as util:
        out, wall = _run_frontend_cli(
            ["mapper", "--database_path", str(work / "db.db"),
             "--output_path", str(work / "sparse")], "mapper")
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    busy = ("not measured (nvidia-smi read no utilization)"
            if util.share is None else
            f"{100 * util.share:.2f}% ({util.samples} NVML samples)")
    log("mapper", f"command wall {wall:.1f} s; peak device memory "
        f"{peak:.1f} MiB; device busy over the run {busy}")
    _mapper_stats(out, "mapper")
    n = FRONTEND_SCENE["num_images"]
    _model_gates(work / "sparse" / "0", scene, n, "mapper")
    require(not (work / "sparse" / "1").exists(),
            "mapper: more than one model")
    m = re.search(r"mapper 0: initial pair \((\d+), (\d+)\), two-view "
                  r"seed (\d+)", out)
    require(m is not None, f"mapper output:\n{out[-2000:]}")
    return tuple(int(x) for x in m.groups())


def _mapper_draws(kind, seed, n, trials, sample_size, mask):
    """Deterministic CPU draws per (RANSAC, seed), so that the card and the
    CPU register with the same samples."""
    import torch

    from sba_tpu_torch.optim.ransac import draw_samples

    g = torch.Generator().manual_seed(7919 * seed + ord(kind[0]))
    return draw_samples(n, trials, sample_size,
                        mask=torch.as_tensor(mask > 0), generator=g).numpy()


def phase_twins_mapper(work, init):
    """One registration step at full width on the card and on the CPU
    with the same sample tensors: the mapper phase's initial pair (its
    two-view RANSAC at the same seed), the first `register_next_image`,
    its `triangulate_image` and `adjust_local_bundle`. Inlier sets equal,
    poses within 1e-8 of the scene's scale, local BA costs at rtol 1e-9.
    The card's step is also profiled (its busy share by torch.profiler
    beside NVML's, a check of `_Utilization`)."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.io.database_cache import DatabaseCache

    d = Database(str(work / "db.db"))
    cache = DatabaseCache.create(d)
    d.close()
    res = {}
    for dev in ("cuda", "cpu"):
        card = dev == "cuda"
        prof = profile(activities=[ProfilerActivity.CUDA]) if card \
            else contextlib.nullcontext()
        util = _Utilization() if card else contextlib.nullcontext()
        t = time.perf_counter()
        with prof, util:
            res[dev] = _twin_step(cache, dev, init)
        res[dev]["s"] = time.perf_counter() - t
        if card:
            busy = sum(e.self_device_time_total
                       for e in _device_totals(prof)) / 1e6
            log("twins-mapper", f"the card's step: device busy {busy:.3f} s"
                f" = {100 * busy / res[dev]['s']:.2f}% of its "
                f"{res[dev]['s']:.2f} s by torch.profiler; NVML over the "
                "same stretch " + ("not measured" if util.share is None
                                   else f"{100 * util.share:.2f}%"))
    _twins_mapper_gates(res["cuda"], res["cpu"], *init[:2])


def _twin_step(cache, dev, init):
    """phase_twins_mapper's step on one device."""
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.optim.ba import BAOptions
    from sba_tpu_torch.sfm.controllers import MapperControllerOptions
    from sba_tpu_torch.sfm.incremental_mapper import IncrementalMapper

    i1, i2, seed = init
    opt = MapperControllerOptions()
    matches = cache.correspondence_graph.image_pairs[(i1, i2)]
    m = IncrementalMapper(cache, device=dev, draw_fn=_mapper_draws)
    m.begin_reconstruction(Reconstruction())
    m._seed_counter = seed - 1
    info = m._estimate_initial_two_view(i1, i2, matches, opt.mapper)
    require(info is not None, f"twins-mapper [{dev}]: the initial pair "
            f"({i1}, {i2}) failed its gates")
    require(m.register_initial_image_pair(i1, i2, info, opt.mapper),
            f"twins-mapper [{dev}]: too few points from the pair")
    nxt = m.find_next_images(opt.mapper)
    require(bool(nxt) and m.register_next_image(nxt[0], opt.mapper),
            f"twins-mapper [{dev}]: the first registration failed")
    ntri = m.triangulate_image(nxt[0], opt.triangulator)
    out = m.adjust_local_bundle(nxt[0], opt.mapper, BAOptions(
        max_iterations=TWIN_LOCAL_BA_IT, loss="cauchy", loss_scale=1.0))
    im = m.rec.images[nxt[0]]
    return dict(info=info, next=nxt[0], tri=ntri, q=im.qvec.copy(),
                t=im.tvec.copy(), pids=im.point3D_ids.copy(),
                cost=float(out["summary"].final_cost),
                cost0=float(out["summary"].initial_cost),
                it=int(out["summary"].num_iterations))


def _twins_mapper_gates(a, b, i1, i2):
    """The twins' inlier sets, poses and local BA costs."""
    import numpy as np

    same_pair = np.array_equal(a["info"]["inlier_matches"],
                               b["info"]["inlier_matches"])
    scale = float(np.linalg.norm(b["info"]["tvec"]))   # the pair's baseline
    dq = float(np.abs(a["q"] - b["q"]).max())
    dt = float(np.abs(a["t"] - b["t"]).max()) / scale
    rc = abs(a["cost"] - b["cost"]) / abs(b["cost"])
    log("twins-mapper", f"initial pair ({i1}, {i2}): "
        f"{len(b['info']['inlier_matches'])} inliers, equal {same_pair}; "
        f"next image {a['next']}/{b['next']}; its tracks after the P3P "
        f"inliers and triangulation equal "
        f"{np.array_equal(a['pids'], b['pids'])} "
        f"({a['tri']}/{b['tri']} observations triangulated); pose after the "
        f"local BA: |dq| {dq:.3g}, |dt|/baseline {dt:.3g}; local BA cost "
        f"{b['cost0']:.10g} -> card {a['cost']:.12g}, CPU {b['cost']:.12g} "
        f"(rel {rc:.3g}), {a['it']}/{b['it']} LM it; card {a['s']:.1f} s, "
        f"CPU {b['s']:.1f} s")
    require(same_pair and a["next"] == b["next"] and a["tri"] == b["tri"]
            and np.array_equal(a["pids"], b["pids"]),
            "twins-mapper: the card's and the CPU's inlier sets differ")
    require(dq <= 1e-8 and dt <= 1e-8 and rc <= 1e-9,
            f"twins-mapper: pose {dq:.3g}/{dt:.3g}, cost {rc:.3g}")


def phase_point_triangulator(scene, work):
    """`point_triangulator` on the scene's true poses, written as a model
    without points over the database's keypoints: its points must lie on
    the rendered heightfield (median vertical error under
    TRI_MAX_ERR_FRAC of the median depth)."""
    import numpy as np

    from sba_tpu_torch.io.colmap_models import Camera, Image
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.utils import mvs_accuracy
    from sba_tpu_torch.utils.render import _Heightfield

    d = Database(str(work / "db.db"))
    rec = Reconstruction()
    try:
        for cid, c in d.read_cameras().items():
            rec.add_camera(Camera(cid, c["model_id"], c["width"],
                                  c["height"], np.asarray(c["params"])))
        for iid, im in d.read_images().items():
            k = _scene_index(im["name"])
            kp = d.read_keypoints(iid)
            rec.add_image(Image(
                iid, scene["qvecs"][k].copy(), scene["tvecs"][k].copy(),
                im["camera_id"], im["name"],
                np.asarray(kp[:, :2], np.float64),
                np.full(len(kp), -1, np.int64)), registered=True)
    finally:
        d.close()
    gt = work / "gt_model"
    gt.mkdir()
    rec.write(str(gt))
    out, wall = _run_frontend_cli(
        ["point_triangulator", "--database_path", str(work / "db.db"),
         "--input_path", str(gt), "--output_path", str(work / "tri")],
        "point_triangulator")
    tri = Reconstruction.read(str(work / "tri"))
    xyz = np.stack([p.xyz for p in tri.points3D.values()])
    c = mvs_accuracy.cloud_accuracy(xyz, _Heightfield(
        5.0, 0.55, FRONTEND_SCENE["seed"]))
    md = float(np.median(scene["depths"]))
    log("point_triangulator", f"{out.strip().splitlines()[-1]}; {wall:.1f} s"
        f"; vertical distance to the heightfield: median {c['median']:.6f}, "
        f"p80 {c['p80']:.6f} ({100 * c['median'] / md:.4f}% and "
        f"{100 * c['p80'] / md:.4f}% of the median depth {md:.4f})")
    require(len(xyz) >= MAPPER_GATES["min_points"] and np.isfinite(xyz).all()
            and c["median"] < TRI_MAX_ERR_FRAC * md,
            f"point_triangulator: {len(xyz)} points, median error "
            f"{c['median']}")


def phase_automatic(scene, work):
    """`automatic_reconstructor --dense 1` on AUTO_VIEWS consecutive views
    with one shared camera (its own extraction, matching, mapping, then
    image_undistorter, patch_match_stereo, stereo_fuser and
    poisson_mesher): all views registered under MAPPER_GATES, K6
    launched, meshed-poisson.ply written; the mesh, mapped onto the truth
    by the model's camera centres, against the heightfield."""
    import numpy as np
    import torch

    from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat
    from sba_tpu_torch.geometry.similarity import umeyama
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.ops import patch_match_kernels as pk
    from sba_tpu_torch.utils.render import _Heightfield

    imgs = work / "auto_imgs"
    imgs.mkdir()
    for k in range(AUTO_VIEWS):
        shutil.copy(work / "imgs" / f"view{k:03d}.png", imgs)
    pk.reset_launches()
    out, wall = _run_frontend_cli(
        ["automatic_reconstructor", "--workspace_path", str(work / "auto"),
         "--image_path", str(imgs), "--dense", "1",
         "--ImageReader.single_camera", "1", "--device", "cuda"],
        "automatic_reconstructor")
    launches = pk.LAUNCHES["ncc_cost"]
    w = re.search(r"wall seconds per view: (\{.*\})", out)
    m = re.search(r"meshing: (.*)", out)
    require(w is not None and m is not None,
            f"automatic_reconstructor output:\n{out[-3000:]}")
    secs = json.loads(w.group(1))
    log("automatic_reconstructor", f"{AUTO_VIEWS} views, --dense 1: "
        f"{wall:.1f} s wall; K6 launches {launches}; PatchMatch "
        f"{sum(secs['photometric'].values()):.1f} s photometric + "
        f"{sum(secs['geometric'].values()):.1f} s geometric; "
        + " | ".join(l.strip() for l in out.splitlines()
                     if l.startswith(("fused", "meshed", "meshing"))))
    require(launches > 0, "automatic_reconstructor --dense 1 never "
            "launched K6")
    _mapper_stats(out, "automatic_reconstructor")
    model = work / "auto" / "sparse" / "0"
    _model_gates(model, scene, AUTO_VIEWS, "automatic_reconstructor")
    rec = Reconstruction.read(str(model))
    ks = [_scene_index(im.name) for im in rec.images.values()]
    c_est = np.stack([-np_quat_to_rotmat(im.qvec).T @ im.tvec
                      for im in rec.images.values()])
    c_gt = np.stack([-np_quat_to_rotmat(scene["qvecs"][k]).T
                     @ scene["tvecs"][k] for k in ks])
    s, Rs, t = umeyama(torch.as_tensor(c_est), torch.as_tensor(c_gt))
    s, Rs, t = float(s), Rs.numpy(), t.numpy()
    dense = work / "auto" / "dense"
    require((dense / "meshed-poisson.ply").exists()
            and (dense / "fused.ply").exists(),
            "automatic_reconstructor --dense 1 wrote no mesh or cloud")
    _mesh_check(dense / "meshed-poisson.ply",
                _Heightfield(5.0, 0.55, FRONTEND_SCENE["seed"]),
                float(np.median(scene["depths"][:AUTO_VIEWS])),
                "automatic_reconstructor", gate=False,
                transform=lambda v: s * v @ Rs.T + t)


# ---------------------------------------------------------------------------
# The end of the dense chain (meshing, the PMVS / CMP-MVS writers,
# rectification) and retrieval (the vocab-tree commands, loop detection)
# ---------------------------------------------------------------------------

# Heightfield limits of a mesh's vertices (vertical distance, as a share
# of the median depth), as the fused cloud's.
MESH_GATES = dict(median_frac=0.01, p80_frac=0.03, min_vertices=10_000,
                  min_faces=20_000)
RECT_PAIR = ("view000.png", "view001.png")
RECT_GATES = dict(min_points=50, max_points=500, min_ncc=0.7,
                  min_row_share=0.9, max_depth_rel=1e-6)
# Loop detection on the ring: overlap 2 and no quadratic jumps, so pairs
# of views more than 2 apart in the sequence (among them those across
# the seam between views 23 and 0) come only from retrieval. The phase
# adds the builder's tree (SequentialMatching.vocab_tree_path), so that
# its CPU twin ranks through the same tree.
LOOP_FLAGS = ("--SequentialMatching.overlap", "2",
              "--SequentialMatching.quadratic_overlap", "0",
              "--SequentialMatching.loop_detection", "1",
              "--SequentialMatching.loop_detection_period", "3",
              "--SequentialMatching.loop_detection_num_images", "4")
MIN_SEAM_INLIERS = 15      # inliers of a verified loop-detection pair
# Card = CPU limits of retrieval: the share of equal words through one
# tree; the k-means objective (the mean cosine of a descriptor and its
# word's centre) of the trees each device builds from the same draws
# (k-means is chaotic: one assignment that rounds the other way on the
# card sends a level's later draws and iterations elsewhere, so the two
# trees share ~40% of their words; the objective of five seeds on the
# CPU spreads 3e-4, three Lloyd iterations in place of ten lose 4e-3);
# and the TF-IDF scores' tolerance through one tree (scores lie in
# [0, 1]; the retriever prints them to 1e-4).
RETRIEVAL_TWIN = dict(quantize_share=0.999, objective_tol=1e-3,
                      score_tol=5e-4)


def _mesh_check(path, field, md, tag, gate, transform=None):
    """The mesh at `path` (its vertices mapped by `transform`) against the
    heightfield: counts, finiteness and, with `gate`, MESH_GATES."""
    import numpy as np

    from sba_tpu_torch.utils import mvs_accuracy

    v, f = mvs_accuracy.read_mesh_ply(path)
    if transform is not None:
        v = transform(v)
    c = mvs_accuracy.cloud_accuracy(v, field)
    log(tag, f"{path.name}: {len(v)} vertices, {len(f)} faces; vertical "
        f"distance to the heightfield: median {c['median']:.5f}, p80 "
        f"{c['p80']:.5f} ({100 * c['median'] / md:.3f}% and "
        f"{100 * c['p80'] / md:.3f}% of the median depth {md:.4f})")
    require(np.isfinite(v).all() and (not len(f) or (
        f.min() >= 0 and f.max() < len(v))), f"{tag}: bad mesh")
    if gate:
        g = MESH_GATES
        require(len(v) >= g["min_vertices"] and len(f) >= g["min_faces"]
                and c["median"] < g["median_frac"] * md
                and c["p80"] < g["p80_frac"] * md,
                f"{tag}: mesh outside MESH_GATES")
    return c


def _mesher_lines(out, tag):
    m = re.search(r"meshed (\d+) vertices / (\d+) faces", out)
    g = re.search(r"meshing: (.*)", out)
    require(m is not None and g is not None, f"{tag} output:\n{out}")
    return g.group(1)


def phase_meshing(scene, work):
    """`poisson_mesher` and `delaunay_mesher` on the mvs phase's
    workspace (8 x 1600x1200 at TSDFOptions' defaults), then
    `poisson_mesher` on the same workspace with the true depth maps as
    its maps (MESH_GATES). Each prints its voxel grid, the TSDF fusion's
    wall ms on the card, the surface nets' host seconds and the peak
    device memory."""
    import numpy as np

    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.mvs import write_colmap_map
    from sba_tpu_torch.utils import mvs_accuracy
    from sba_tpu_torch.utils.render import _Heightfield

    field = _Heightfield(5.0, 0.55, MVS_SCENE["seed"])
    md = float(np.median(scene["depths"]))
    ws = work / "dense"
    for cmd in ("poisson_mesher", "delaunay_mesher"):
        out, wall = _run_frontend_cli(
            [cmd, "--input_path", str(ws), "--output_path",
             str(ws / f"{cmd}.ply"), "--device", "cuda"], cmd)
        log("meshing", f"{cmd} on the PatchMatch maps: {wall:.1f} s; "
            + _mesher_lines(out, cmd))
        _mesh_check(ws / f"{cmd}.ply", field, md, "meshing", gate=False)

    truth = work / "dense_truth"
    shutil.copytree(ws / "sparse", truth / "sparse")
    (truth / "stereo" / "depth_maps").mkdir(parents=True)
    rec = Reconstruction.read(str(truth / "sparse"))
    t = time.perf_counter()
    for iid, im in rec.images.items():
        d = mvs_accuracy.true_depth(field, rec, iid, "cuda")
        write_colmap_map(d.astype(np.float32), str(
            truth / "stereo" / "depth_maps" / f"{im.name}.geometric.bin"))
    log("meshing", f"true depth maps of {len(rec.images)} undistorted "
        f"views in {time.perf_counter() - t:.1f} s")
    out, wall = _run_frontend_cli(
        ["poisson_mesher", "--input_path", str(truth), "--output_path",
         str(truth / "mesh.ply"), "--device", "cuda"], "poisson_mesher")
    log("meshing", f"poisson_mesher on the true depth maps: {wall:.1f} s; "
        + _mesher_lines(out, "poisson_mesher"))
    _mesh_check(truth / "mesh.ply", field, md, "meshing", gate=True)


def _projection_txt(path):
    import numpy as np

    lines = Path(path).read_text().splitlines()
    require(lines[0] == "CONTOUR" and len(lines) == 4, f"{path}: {lines}")
    return np.array([[float(v) for v in l.split()] for l in lines[1:]])


def _reprojection_gap(P_of, rec):
    """Largest pixel distance between each observation's keypoint in the
    undistorted COLMAP model `rec` and its point projected by the written
    projection matrix of its image (P_of[image id])."""
    import numpy as np

    worst = 0.0
    for iid, im in rec.images.items():
        P = P_of[iid]
        for j, pid in enumerate(im.point3D_ids):
            if pid < 0:
                continue
            x = P @ np.append(rec.points3D[int(pid)].xyz, 1.0)
            worst = max(worst, float(np.linalg.norm(x[:2] / x[2]
                                                    - im.xys[j])))
    return worst


def phase_dense_writers(scene, work):
    """`image_undistorter --output_type PMVS` and `CMP-MVS` on the mvs
    phase's scene: the file layout, and every projection matrix
    reprojects the sparse points onto the COLMAP workspace's undistorted
    keypoints; then `image_rectifier` on two neighbouring views: the
    pair's Q, its rows (the sparse points through the rectifying
    homographies, and patches of the written images matched along rows)
    and the depth its Q gives back."""

    from sba_tpu_torch.models.reconstruction import Reconstruction

    colmap = Reconstruction.read(str(work / "dense" / "sparse"))
    n = len(colmap.images)
    for kind, sub in (("PMVS", "pmvs_ws"), ("CMP-MVS", "cmpmvs_ws")):
        out, wall = _run_frontend_cli(
            ["image_undistorter", "--image_path", str(work / "images"),
             "--input_path", str(work / "sparse"), "--output_path",
             str(work / sub), "--output_type", kind, "--device", "cuda"],
            kind)
        root = work / sub
        order = list(colmap.registered_image_ids)
        if kind == "PMVS":
            pm = root / "pmvs"
            need = ([pm / "txt" / f"{i:08d}.txt" for i in range(n)]
                    + [pm / "visualize" / f"{i:08d}.jpg" for i in range(n)]
                    + [pm / f for f in ("bundle.rd.out", "vis.dat",
                                        "option-all")]
                    + [root / "run-pmvs.sh", root / "run-cmvs-pmvs.sh"])
            P_of = {iid: _projection_txt(pm / "txt" / f"{k:08d}.txt")
                    for k, iid in enumerate(order)}
            vis = (pm / "vis.dat").read_text().splitlines()
            require(vis[:2] == ["VISDATA", str(n)] and len(vis) == n + 2,
                    f"vis.dat: {vis[:3]}")
        else:
            need = ([root / f"{i + 1:05d}_P.txt" for i in range(n)]
                    + [root / f"{i + 1:05d}.jpg" for i in range(n)])
            P_of = {iid: _projection_txt(root / f"{k + 1:05d}_P.txt")
                    for k, iid in enumerate(order)}
        missing = [str(p) for p in need if not p.exists()]
        require(not missing, f"{kind}: missing {missing[:4]}")
        gap = _reprojection_gap(P_of, colmap)
        log("dense-writers", f"image_undistorter --output_type {kind}: "
            f"{wall:.1f} s, {len(need)} files; the projection matrices "
            f"reproject the sparse points onto the COLMAP workspace's "
            f"keypoints within {gap:.2e} px")
        require(gap < 1e-3, f"{kind}: projection matrices off by {gap} px")
    _check_rectifier(work)


def _ncc(a, b):
    import numpy as np

    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).sum() / max(np.sqrt((a * a).sum() * (b * b).sum()),
                                      1e-12))


def _check_rectifier(work):
    import numpy as np
    import torch
    from PIL import Image as PILImage

    from sba_tpu_torch.geometry.quaternions import (np_quat_to_rotmat,
                                                    pose_inverse,
                                                    pose_product)
    from sba_tpu_torch.geometry.undistortion import (rectify_stereo_cameras,
                                                     undistort_camera)
    from sba_tpu_torch.models.reconstruction import Reconstruction

    pairs = work / "pairs.txt"
    pairs.write_text(" ".join(RECT_PAIR) + "\n")
    out, wall = _run_frontend_cli(
        ["image_rectifier", "--image_path", str(work / "images"),
         "--input_path", str(work / "sparse"), "--output_path",
         str(work / "rect"), "--stereo_pairs_list", str(pairs),
         "--device", "cuda"], "image_rectifier")
    d = work / "rect" / "-".join(Path(n).stem for n in RECT_PAIR)
    rec = Reconstruction.read(str(work / "sparse"))
    by_name = {im.name: iid for iid, im in rec.images.items()}
    im1, im2 = (rec.images[by_name[n]] for n in RECT_PAIR)
    und = undistort_camera(rec.cameras[im1.camera_id])
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    qi, ti = pose_inverse(f64(im1.qvec), f64(im1.tvec))
    q, t = pose_product(f64(im2.qvec), f64(im2.tvec), qi, ti)
    H1, H2, Q = rectify_stereo_cameras(und, und, q.numpy(), t.numpy())
    Qf = np.loadtxt(d / "Q.txt")
    require(np.abs(Qf - Q).max() <= 1e-12 * np.abs(Q).max(),
            f"image_rectifier: Q.txt {Qf} vs {Q}")
    left = np.asarray(PILImage.open(d / "left.png").convert("L"), np.float64)
    right = np.asarray(PILImage.open(d / "right.png").convert("L"),
                       np.float64)
    fx, fy, cx, cy = und.params
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    R1, R2 = np_quat_to_rotmat(im1.qvec), np_quat_to_rotmat(im2.qvec)
    ids2 = set(int(p) for p in im2.point3D_ids if p >= 0)
    rows, depth_rel, ncc_rows = [], [], []
    h, w = left.shape
    r = 5
    both = sorted(set(int(p) for p in im1.point3D_ids if p >= 0) & ids2)
    for pid in both[::max(1, len(both) // RECT_GATES["max_points"])]:
        X = rec.points3D[pid].xyz
        c1, c2 = R1 @ X + im1.tvec, R2 @ X + im2.tvec
        if c1[2] <= 0 or c2[2] <= 0:
            continue
        x1 = H1 @ (K @ c1)
        x2 = H2 @ (K @ c2)
        x1, x2 = x1[:2] / x1[2], x2[:2] / x2[2]
        if not (r + 4 <= x1[0] < w - r - 4 and r + 4 <= x1[1] < h - r - 4
                and r + 4 <= x2[0] < w - r - 4
                and r + 4 <= x2[1] < h - r - 4):
            continue
        rows.append(abs(x1[1] - x2[1]))
        # Q's layout (sba_tpu's, the reference's): f = Q[3,2],
        # -1/baseline = Q[2,3], principal point (-Q[3,1], -Q[3,0]).
        disp = x1[0] - x2[0]
        Z = Q[3, 2] / (Q[2, 3] * disp)
        P = np.array([(x1[0] + Q[3, 1]) * Z / Q[3, 2],
                      (x1[1] + Q[3, 0]) * Z / Q[3, 2], Z])
        depth_rel.append(abs(np.linalg.norm(P) - np.linalg.norm(c1))
                         / np.linalg.norm(c1))
        u1, v1 = (int(np.floor(v)) for v in x1)
        u2, v2 = (int(np.floor(v)) for v in x2)
        pa = left[v1 - r:v1 + r + 1, u1 - r:u1 + r + 1]
        best = max(((_ncc(pa, right[v2 + dy - r:v2 + dy + r + 1,
                                    u2 + dx - r:u2 + dx + r + 1]), dy)
                    for dy in range(-3, 4) for dx in range(-4, 5)))
        if best[0] >= RECT_GATES["min_ncc"]:
            ncc_rows.append(abs(best[1]))
    g = RECT_GATES
    share = float(np.mean(np.array(ncc_rows) <= 1)) if ncc_rows else 0.0
    log("dense-writers", f"image_rectifier {RECT_PAIR}: {wall:.1f} s; "
        f"{len(rows)} sparse points in both views: row gap through H1/H2 "
        f"max {max(rows):.2e} px; image patches (NCC >= {g['min_ncc']}) at "
        f"most 1 row apart for {share:.4f} of {len(ncc_rows)}; depth from "
        f"Q vs the truth: max rel {max(depth_rel):.2e}")
    require(len(rows) >= g["min_points"] and max(rows) < 1.0
            and len(ncc_rows) >= g["min_points"]
            and share >= g["min_row_share"]
            and max(depth_rel) < g["max_depth_rel"],
            "image_rectifier outside RECT_GATES")


def _true_overlap(scene, i, j, step=40):
    """Share of view i's pixels (every `step`th) whose true surface point
    projects into view j in front of it (SIMPLE_PINHOLE views)."""
    import numpy as np

    from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat

    f, cx, cy = scene["camera"]["params"][:3]
    H, W = scene["depths"].shape[1:]
    yy, xx = np.meshgrid(np.arange(0, H, step) + 0.5,
                         np.arange(0, W, step) + 0.5, indexing="ij")
    d = scene["depths"][i][yy.astype(int), xx.astype(int)]
    pc = np.stack([(xx - cx) / f * d, (yy - cy) / f * d, d], -1)
    Ri, Rj = (np_quat_to_rotmat(scene["qvecs"][k]) for k in (i, j))
    X = (pc.reshape(-1, 3) - scene["tvecs"][i]) @ Ri
    c = X @ Rj.T + scene["tvecs"][j]
    u = f * c[:, 0] / c[:, 2] + cx
    v = f * c[:, 1] / c[:, 2] + cy
    return float(np.mean((c[:, 2] > 0) & (u >= 0) & (u < W) & (v >= 0)
                         & (v < H)))


def _rankings(out):
    """{query: [(image, score)]} from `vocab_tree_retriever`'s output."""
    ranks, query = {}, None
    for line in out.splitlines():
        m = re.match(r"(view\d+\.png):$", line)
        if m:
            query = m.group(1)
            ranks[query] = []
            continue
        m = re.match(r"  (view\d+\.png)  score=(\S+)$", line)
        if m and query is not None:
            ranks[query].append((m.group(1), float(m.group(2))))
    return ranks


def _ranking_twin(card, cpu, tol, tag):
    """Holds the card's rankings against the CPU's: each image both hold
    scores within tol on both, and an image only one holds scores within
    tol of the other's last (a near tie at the cut). Returns the largest
    score difference and the number of images only one ranking holds."""
    require(sorted(card) == sorted(cpu) and all(card.values()),
            f"{tag}: queries differ: {sorted(card)} vs {sorted(cpu)}")
    worst, cut = 0.0, 0
    for q in card:
        a, b = dict(card[q]), dict(cpu[q])
        for x in a.keys() & b.keys():
            worst = max(worst, abs(a[x] - b[x]))
        for x, s, other in [(x, a[x], b) for x in a.keys() - b.keys()] + [
                (x, b[x], a) for x in b.keys() - a.keys()]:
            cut += 1
            require(abs(s - min(other.values())) <= tol,
                    f"{tag}: {q} ranks {x} ({s}) on one device only")
    require(worst <= tol, f"{tag}: scores differ by {worst} (> {tol})")
    return worst, cut


def _pairs_twin(card, cpu, full, kth, tol, tag):
    """Holds the card's set of retrieved pairs against the CPU's: a pair
    only one holds must score, in the CPU's full ranking of one of its
    queries, within tol of that query's last retrieved score."""
    diff = card ^ cpu
    for a, b in diff:
        require(any(q in full and abs(full[q][o] - kth[q]) <= tol
                    for q, o in ((a, b), (b, a))),
                f"{tag}: pair {(a, b)} retrieved on "
                f"{'the card' if (a, b) in card else 'the CPU'} only")
    return len(diff)


def phase_retrieval(scene, work):
    """On the frontend phase's 24-view ring database: `vocab_tree_builder`
    (16^2 words, up to 100,000 descriptors), `vocab_tree_matcher`
    (`num_images` 10) on a copy with its matches cleared,
    `vocab_tree_retriever`, and `sequential_matcher` with loop detection
    (LOOP_FLAGS) on another cleared copy, all on the card. Every
    retrieved pair verifies, and loop detection adds pairs beyond the
    overlap window (>= MIN_SEAM_INLIERS inliers each). Each is then held
    against the port's CPU path on the same database (RETRIEVAL_TWIN):
    the card's tree gives the CPU's words, the builder run on the CPU
    (the same draws) reaches the card's k-means objective, the retriever
    run on the CPU with the card's tree gives its rankings, and the
    CPU's retrievals give the matcher's pairs and loop detection's (over
    the builder's tree), up to near ties at the cut. The true overlap and ring
    distance of the retrieved pairs are printed beside those of all
    pairs (every pair of this ring overlaps by more than 0.7, so the
    truth cannot tell a good ranking from a bad one). The mapper is not
    rerun."""
    import numpy as np

    from sba_tpu_torch import cli
    from sba_tpu_torch.features.pairing import sequential_pairs
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.retrieval.visual_index import (VisualIndex,
                                                      vocab_tree_pairs)
    from sba_tpu_torch.retrieval.vocab_tree import (load_vocab_tree,
                                                    quantize_descriptors)

    n = FRONTEND_SCENE["num_images"]
    db = work / "db.db"
    tree = work / "tree.npz"
    tw = RETRIEVAL_TWIN
    secs = {}
    out, secs["vocab_tree_builder"] = _run_frontend_cli(
        ["vocab_tree_builder", "--database_path", str(db),
         "--vocab_tree_path", str(tree), "--device", "cuda"],
        "vocab_tree_builder")
    log("retrieval", " | ".join(out.strip().splitlines()[-2:]))
    require("trained 256-word tree" in out, "vocab_tree_builder: " + out)

    ov = {(a, b): _true_overlap(scene, a, b) for a in range(n)
          for b in range(n) if a != b}
    pair_ov = {(a, b): min(ov[a, b], ov[b, a]) for a in range(n)
               for b in range(a + 1, n)}
    mean_all = float(np.mean(list(pair_ov.values())))
    ring_all = np.mean([min(b - a, n - b + a) for a, b in pair_ov])

    def cleared(name):
        path = work / name
        shutil.copy(db, path)
        _run_frontend_cli(["database_cleaner", "--database_path", str(path),
                           "--type", "matches"], "database_cleaner")
        return path

    def geometries(path):
        h = Database(str(path))
        try:
            names = {i: _scene_index(im["name"])
                     for i, im in h.read_images().items()}
            return {tuple(sorted((names[a], names[b]))):
                    len(g["inlier_matches"]) for (a, b), g in
                    h.read_all_two_view_geometries().items()}
        finally:
            h.close()

    vt = cleared("vt.db")
    out, secs["vocab_tree_matcher"] = _run_frontend_cli(
        ["vocab_tree_matcher", "--database_path", str(vt),
         "--vocab_tree_path", str(tree), "--VocabTreeMatching.num_images",
         "10", "--device", "cuda"], "vocab_tree_matcher")
    v = re.search(r"verified (\d+)/(\d+) retrieved pairs", out)
    require(v is not None, "vocab_tree_matcher: " + out[-2000:])
    got = geometries(vt)
    log("retrieval", f"vocab_tree_matcher: {v.group(1)}/{v.group(2)} "
        f"retrieved pairs verified; ring distance of the pairs mean "
        f"{np.mean([min(b - a, n - b + a) for a, b in got]):.2f} (all "
        f"pairs {ring_all:.2f}); true overlap min "
        f"{min(pair_ov[p] for p in got):.3f}, mean "
        f"{np.mean([pair_ov[p] for p in got]):.3f} (all pairs "
        f"{mean_all:.3f}); " + " | ".join(
            l for l in out.splitlines() if l.startswith(("retrieval", "match"))))
    require(len(got) == int(v.group(1)) == int(v.group(2)) > 0,
            "vocab_tree_matcher: a retrieved pair not verified")

    out, secs["vocab_tree_retriever"] = _run_frontend_cli(
        ["vocab_tree_retriever", "--database_path", str(db),
         "--vocab_tree_path", str(tree), "--num_images", "10",
         "--device", "cuda"], "vocab_tree_retriever")
    ranks = _rankings(out)
    require(len(ranks) == n, f"vocab_tree_retriever: {len(ranks)} rankings")
    top = [tuple(sorted((_scene_index(q), _scene_index(r[0][0]))))
           for q, r in ranks.items()]
    log("retrieval", f"vocab_tree_retriever: the best-ranked image of each "
        f"of {n} queries: true overlap min "
        f"{min(pair_ov[p] for p in top):.3f}, mean "
        f"{np.mean([pair_ov[p] for p in top]):.3f}; ring distance mean "
        f"{np.mean([min(b - a, n - b + a) for a, b in top]):.2f}; "
        + out.strip().splitlines()[-1])

    loop = cleared("loop.db")
    loop_flags = (*LOOP_FLAGS, "--SequentialMatching.vocab_tree_path",
                  str(tree))
    out, secs["sequential_matcher (loop detection)"] = _run_frontend_cli(
        ["sequential_matcher", "--database_path", str(loop), *loop_flags,
         "--device", "cuda"], "sequential_matcher")
    added = re.search(r"loop detection added (\d+) retrieved pairs", out)
    require(added is not None, "sequential_matcher: " + out[-2000:])
    stored = geometries(loop)
    # Pairs the overlap window cannot make join views more than 2 apart
    # in the sequence; those at ring distance <= 2 close the ring's seam.
    beyond = {p: k for p, k in stored.items() if p[1] - p[0] > 2}
    ok = [p for p, k in beyond.items() if k >= MIN_SEAM_INLIERS]
    seam = [p for p in beyond if min(p[1] - p[0], n - p[1] + p[0]) <= 2]
    log("retrieval", f"sequential_matcher with loop detection: "
        f"{added.group(1)} retrieved pairs added, {len(stored)} pairs "
        f"stored; {len(beyond)} beyond the overlap window, {len(ok)} of "
        f"them verified (>= {MIN_SEAM_INLIERS} inliers); at the ring's seam "
        f"(ring distance <= 2): {sorted(seam)}")
    require(int(added.group(1)) == len(beyond) >= 1
            and len(ok) == len(beyond),
            "loop detection: retrieved pairs missing or not verified")

    # Card = CPU, on the same database.
    t = time.perf_counter()
    tree_cpu = work / "tree_cpu.npz"
    _run_frontend_cli(
        ["vocab_tree_builder", "--database_path", str(db),
         "--vocab_tree_path", str(tree_cpu), "--device", "cpu"],
        "vocab_tree_builder (CPU)")
    out_cpu, _ = _run_frontend_cli(
        ["vocab_tree_retriever", "--database_path", str(db),
         "--vocab_tree_path", str(tree), "--num_images", "10",
         "--device", "cpu"], "vocab_tree_retriever (CPU)")
    r_worst, r_cut = _ranking_twin(ranks, _rankings(out_cpu),
                                   tw["score_tol"], "vocab_tree_retriever")
    h = Database(str(db))
    try:
        images = h.read_images()
        ids = sorted(images)
        sidx = {i: _scene_index(images[i]["name"]) for i in ids}
        descs = {i: cli._unit_descriptors(h, i) for i in ids}
        flags = dict(zip((f[2:] for f in loop_flags[::2]), loop_flags[1::2]))
        window = list(sequential_pairs(len(ids), overlap=2,
                                       quadratic_overlap=False))
        index_l, _ = cli._loop_detection_index(h, ids, flags, "cpu")
    finally:
        h.close()
    card_tree = load_vocab_tree(str(tree), device="cuda")
    host_tree = load_vocab_tree(str(tree), device="cpu")
    cpu_tree = load_vocab_tree(str(tree_cpu), device="cpu")
    x = np.concatenate(list(descs.values()))
    w_card = quantize_descriptors(card_tree, x).cpu().numpy()
    w_host = quantize_descriptors(host_tree, x).numpy()
    w_cpu = quantize_descriptors(cpu_tree, x).numpy()
    q_share = float(np.mean(w_card == w_host))
    b_share = float(np.mean(w_host == w_cpu))

    def objective(t, w):
        leaf = t.centers[-1].reshape(-1, x.shape[1]).numpy()[w]
        return float(np.mean(np.sum(x * leaf, 1)))

    j_card, j_cpu = objective(host_tree, w_host), objective(cpu_tree, w_cpu)

    def full_ranking(index, exclude):
        return {sidx[i]: {sidx[j]: s for j, s in index.query(
            descs[i], num_images=n, exclude_image_id=i if exclude else None)}
            for i in ids}

    index = VisualIndex(host_tree)
    for i in ids:
        index.add_image(i, descs[i])
    index.prepare()
    full = full_ranking(index, True)
    kth = {q: sorted(r.values())[-10] for q, r in full.items()}
    cpu_pairs = {tuple(sorted((sidx[a], sidx[b])))
                 for a, b in vocab_tree_pairs(index, descs, 10)}
    m_diff = _pairs_twin(set(got), cpu_pairs, full, kth, tw["score_tol"],
                         "vocab_tree_matcher")
    period = int(flags["SequentialMatching.loop_detection_period"])
    num = int(flags["SequentialMatching.loop_detection_num_images"])
    full_l = {q: r for q, r in full_ranking(index_l, False).items()
              if q % period == 0}
    kth_l = {q: sorted(r.values())[-num] for q, r in full_l.items()}
    loop_cpu = {tuple(sorted((sidx[ids[a]], sidx[ids[b]]))) for a, b in
                cli._loop_detection_pairs(index_l, descs, ids, window,
                                          flags)}
    l_diff = _pairs_twin(set(beyond), loop_cpu, full_l, kth_l,
                         tw["score_tol"], "loop detection")
    log("retrieval", f"card = CPU ({time.perf_counter() - t:.1f} s): "
        f"words of {len(x)} descriptors through the card's tree on the "
        f"card and the CPU equal {100 * q_share:.4f}%; k-means objective "
        f"of the tree built on the card {j_card:.6f}, on the CPU (same "
        f"draws) {j_cpu:.6f} (their words equal {100 * b_share:.2f}%); "
        f"retriever scores within {r_worst:.3g}, {r_cut} images at a cut "
        f"on one device only; matcher pairs {len(got)} on the card, "
        f"{len(cpu_pairs)} on the CPU, {m_diff} differ; loop-detection "
        f"pairs {len(beyond)} and {len(loop_cpu)}, {l_diff} differ (each "
        f"at a near tie)")
    require(q_share >= tw["quantize_share"],
            "retrieval: the card's words are not the CPU's")
    require(abs(j_card - j_cpu) <= tw["objective_tol"],
            "retrieval: the card's k-means objective is not the CPU's")
    log("retrieval", "seconds per command: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))


# ---------------------------------------------------------------------------
# The mapper's second half: pose graph, hierarchical mapper, camera rigs
# ---------------------------------------------------------------------------

# The pose-graph scene: bench.py:195's 1024-image sequential scene (LARGE),
# its covisibility graph at the truth (max_edges_per_image 10); each
# measurement then perturbed by PG_MEAS_NOISE (rad, scene units, log
# scale), so that the optimum's cost is not zero and the float32 solve
# can be held against the float64 one at a relative tolerance. The start
# drifts along the sequence: random walks of PG_DRIFT per image of the
# rotation, the camera centre and (Sim3) the log scale; image 0 is the
# gauge. The graph has no loop closure, so its low-frequency (bending)
# modes are barely observed: 50 PCG iterations of the block-Jacobi
# preconditioner (sba_tpu's default) do not carry a correction along
# 1024 poses. The gates hold the relative drift (the consecutive relative
# translations against the truth's) to a fall of min_rel_drift_drop; the
# absolute drift (mean centre error) is printed, not gated. CPU probes at
# 1024 images (float32 against float64, the same solves): the relative
# drift fell 19x (SE3) and 20x (Sim3), the absolute drift rose 3.3x, the
# final costs agreed at 1.5e-5 and 2.6e-4 relative; at 1e-4 noise the
# unconverged remainder dominated the cost and Sim3's agreed at only
# 2.5e-3. At 128 images with 300 PCG iterations the same solve reached
# the truth (centres at 3e-13).
PG_MEAS_NOISE = 3e-3
PG_DRIFT = dict(rot=2e-3, center=0.02, log_scale=2e-3)
PG_GATES = dict(min_rel_drift_drop=10.0, cost_rtol=1e-3,
                cli_max_center_frac=1e-4, cli_max_rot_deg=1e-3)
# Permuted edge lists solved in float32 besides the given order: each
# sums the segments in another order, so the gate's margin is read
# against several roundings, not one.
PG_EDGE_ORDERS = 2


def _rec_from_observations(cameras, img_cam, qvecs, tvecs, names, points,
                           obs_image, obs_point, obs_xy):
    """A registered Reconstruction of images (rows) and points whose
    tracks are the observations (rows of obs_*); points seen fewer than
    twice are left out."""
    import numpy as np

    from sba_tpu_torch.io.colmap_models import Image
    from sba_tpu_torch.models.reconstruction import Reconstruction

    count = np.bincount(obs_point, minlength=len(points))
    keep = count[obs_point] >= 2
    oi, op, xy = obs_image[keep], obs_point[keep], obs_xy[keep]
    order = np.lexsort((op, oi))
    oi, op, xy = oi[order], op[order], xy[order]
    starts = np.searchsorted(oi, np.arange(len(names) + 1))
    kp = np.arange(len(oi)) - starts[oi]
    rec = Reconstruction()
    for cam in cameras:
        rec.add_camera(cam)
    for i, name in enumerate(names):
        rows = slice(starts[i], starts[i + 1])
        rec.add_image(Image(i + 1, qvecs[i].copy(), tvecs[i].copy(),
                            int(img_cam[i]), name, xy[rows].copy(),
                            np.full(starts[i + 1] - starts[i], -1,
                                    np.int64)), registered=True)
    by_point = np.argsort(op, kind="stable")
    bounds = np.searchsorted(op[by_point], np.arange(len(points) + 1))
    for p in np.nonzero(count >= 2)[0]:
        rows = by_point[bounds[p]:bounds[p + 1]]
        rec.add_point3d(points[p], list(zip((oi[rows] + 1).tolist(),
                                            kp[rows].tolist())))
    return rec


def _drifts(q, t, log_s, truth):
    """(relative, absolute) drift of Sim3 poses against the truth: the
    mean error of the consecutive relative translations t_{i,i+1}, and
    the mean camera centre error."""
    import numpy as np
    import torch

    from sba_tpu_torch.optim.pose_graph import relative_pose

    def rel(q_, t_, s_):
        q_, t_, s_ = (torch.as_tensor(v) for v in (q_, t_, np.exp(s_)))
        return relative_pose(q_[:-1], t_[:-1], q_[1:], t_[1:], s_[:-1],
                             s_[1:])[1].numpy()

    r = np.linalg.norm(rel(q, t, log_s) - rel(truth["qvecs"],
                                              truth["tvecs"],
                                              np.zeros(len(q))), axis=1)
    a = np.linalg.norm(_centers(q, t, log_s)
                       - _centers(truth["qvecs"], truth["tvecs"]), axis=1)
    return float(np.mean(r)), float(np.mean(a))


def _centers(q, t, log_s=None):
    """Camera centres of world->camera poses (Sim3: x_cam = s R x + t)."""
    import numpy as np

    from sba_tpu_torch.geometry.quaternions import np_quat_rotate

    qi = q * np.array([1.0, -1.0, -1.0, -1.0])
    c = -np_quat_rotate(qi, t)
    return c if log_s is None else c / np.exp(log_s)[:, None]


def phase_pose_graph():
    """`pose_graph_from_reconstruction` on the 1024-image sequential
    scene's true model, then `optimize_pose_graph` in float32 on the card
    from a drifted start: SE3 with Huber, then Sim3 with scale drift, at
    sba_tpu's defaults (50 LM, 50 CG iterations). PG_GATES: the cost
    falls, the relative drift against the truth falls by
    min_rel_drift_drop, and the final cost equals the float64 solve's
    (on the card: the CPU's took ~27 s of the phase) at cost_rtol.
    Returns {"SE3", "Sim3": (the drifted float64 problem on the host, the
    options, the float32 final cost in the given edge order, the start's
    drift, the truth)}."""
    import numpy as np
    import torch

    from sba_tpu_torch.geometry.quaternions import (angle_axis_to_quat,
                                                    np_quat_rotate,
                                                    quat_multiply,
                                                    quat_normalize)
    from sba_tpu_torch.io.colmap_models import Camera
    from sba_tpu_torch.optim.pose_graph import (PoseGraphOptions,
                                                optimize_pose_graph,
                                                pose_graph_from_reconstruction)
    from sba_tpu_torch.utils.synthetic import make_sequential_ba_problem_numpy

    def left_rotate(aa, q):
        """exp(aa) * q, normalized (float64 on the host)."""
        return quat_normalize(quat_multiply(
            angle_axis_to_quat(torch.as_tensor(aa)),
            torch.as_tensor(q))).numpy()

    t = time.perf_counter()
    fields, truth = make_sequential_ba_problem_numpy(**LARGE)
    n = LARGE["num_images"]
    valid = fields["obs_mask"] > 0
    rec = _rec_from_observations(
        [Camera(1, 0, 640, 480, np.array([500.0, 320.0, 240.0]))],
        np.ones(n, np.int64), truth["qvecs"], truth["tvecs"],
        [f"image{i:04d}.png" for i in range(n)], truth["points"],
        fields["obs_image"][valid].astype(np.int64),
        fields["obs_point"][valid].astype(np.int64),
        fields["obs_xy"][valid])
    t_rec = time.perf_counter() - t
    c_true = _centers(truth["qvecs"], truth["tvecs"])
    rng = np.random.default_rng(11)
    solved = {}
    for sim3 in (False, True):
        tag = "Sim3" if sim3 else "SE3"
        t = time.perf_counter()
        prob64, _ = pose_graph_from_reconstruction(
            rec, max_edges_per_image=10, sim3=sim3, dtype=torch.float64,
            device="cpu")
        t_graph = time.perf_counter() - t
        e = prob64.edge_i.shape[0]
        rel_q = left_rotate(rng.normal(0, PG_MEAS_NOISE, (e, 3)),
                            prob64.rel_q)
        rel_t = prob64.rel_t.numpy() + rng.normal(0, PG_MEAS_NOISE, (e, 3))
        drift_q = np.cumsum(rng.normal(0, PG_DRIFT["rot"], (n, 3)), 0)
        drift_c = np.cumsum(rng.normal(0, PG_DRIFT["center"], (n, 3)), 0)
        drift_q[0] = drift_c[0] = 0.0
        q0 = left_rotate(drift_q, truth["qvecs"])
        ls0 = np.zeros(n)
        if sim3:
            ls0 = np.cumsum(rng.normal(0, PG_DRIFT["log_scale"], n))
            ls0[0] = 0.0
        t0 = -np.exp(ls0)[:, None] * np_quat_rotate(q0, c_true + drift_c)
        rel_ls = (rng.normal(0, PG_MEAS_NOISE, e) if sim3
                  else np.zeros(e))
        drift0 = _drifts(q0, t0, ls0, truth)
        opt = PoseGraphOptions(sim3=sim3, loss="huber")
        start = dict(qvecs=q0, tvecs=t0, log_scales=ls0, rel_q=rel_q,
                     rel_t=rel_t, rel_log_s=rel_ls)
        base = prob64._replace(**{k: torch.as_tensor(v) for k, v
                                  in start.items()})
        orders = [None] + [torch.as_tensor(
            np.random.default_rng(100 + k).permutation(e))
            for k in range(PG_EDGE_ORDERS)]
        runs = [(torch.float32, k) for k in range(len(orders))] + [
            (torch.float64, 0)]
        costs, drift = {}, {}
        for dtype, k in runs:
            prob = base
            if orders[k] is not None:
                prob = prob._replace(**{f: getattr(prob, f)[orders[k]] for f
                                        in ("edge_i", "edge_j", "rel_q",
                                            "rel_t", "rel_log_s",
                                            "sqrt_info", "edge_mask")})
            prob = prob._replace(**{
                f: (v.to(dtype) if v.is_floating_point() else v).to("cuda")
                for f, v in prob._asdict().items()})
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, s = optimize_pose_graph(prob, opt)
            c1 = float(s.final_cost)
            wall = time.perf_counter() - t
            costs[dtype, k] = (float(s.initial_cost), c1)
            drift[dtype, k] = _drifts(*(v.double().cpu().numpy() for v in (
                out.qvecs, out.tvecs, out.log_scales)), truth)
            its = s.cg_iterations[:s.num_iterations].tolist()
            log("pose-graph", f"{tag} [cuda, {dtype}, edge order {k}]: {n} "
                f"poses, {e} edges (graph built in {t_graph:.2f} s), cost "
                f"{costs[dtype, k][0]:.6g} -> {c1:.6g} in {s.num_iterations} "
                f"LM iterations, CG iterations per LM iteration {its}; drift "
                f"(relative, absolute) {drift0[0]:.6f}, {drift0[1]:.5f} -> "
                f"{drift[dtype, k][0]:.6f}, {drift[dtype, k][1]:.5f}; "
                f"{wall:.2f} s wall")
        f64 = costs[torch.float64, 0][1]
        rcs = [abs(costs[torch.float32, k][1] - f64) / f64
               for k in range(len(orders))]
        drop = [drift0[i] / drift[torch.float32, 0][i] for i in (0, 1)]
        log("pose-graph", f"{tag}: final cost float32 vs float64 (both on "
            f"the card) rel {', '.join(f'{r:.3g}' for r in rcs)} (edge "
            f"orders 0-{len(orders) - 1}; largest {max(rcs):.3g}); relative "
            f"drift fell {drop[0]:.1f}x, absolute drift {drop[1]:.3f}x")
        require(all(costs[torch.float32, k][1] < costs[torch.float32, k][0]
                    for k in range(len(orders)))
                and drop[0] >= PG_GATES["min_rel_drift_drop"]
                and max(rcs) <= PG_GATES["cost_rtol"],
                f"pose-graph {tag}: outside PG_GATES: costs {costs}, drift "
                f"{drift0} -> {drift}")
        solved[tag] = (base, opt, costs[torch.float32, 0][1], drift0, truth)
    log("pose-graph", f"scene model built in {t_rec:.1f} s "
        f"({rec.num_points3d()} points)")
    return solved


def phase_cli_pose_graph(scene, work):
    """`pose_graph_optimizer` at its defaults on the mapper phase's model:
    its printed line, the poses within PG_GATES (cli_*) of the input's
    (a bundle-adjusted model is at its graph's optimum), MAPPER_GATES."""
    import numpy as np

    from sba_tpu_torch.geometry.quaternions import np_quat_to_rotmat
    from sba_tpu_torch.models.reconstruction import Reconstruction

    src = work / "sparse" / "0"
    out, wall = _run_frontend_cli(
        ["pose_graph_optimizer", "--input_path", str(src), "--output_path",
         str(work / "pg")], "pose_graph_optimizer")
    m = re.search(r"pose graph: (\d+) nodes, (\d+) edges, cost (\S+) -> "
                  r"(\S+) in (\d+) iters", out)
    require(m is not None, f"pose_graph_optimizer output:\n{out[-2000:]}")
    a, b = Reconstruction.read(str(src)), Reconstruction.read(str(work / "pg"))
    dc = max(float(np.linalg.norm(
        _centers(a.images[i].qvec[None], a.images[i].tvec[None])
        - _centers(b.images[i].qvec[None], b.images[i].tvec[None])))
        for i in a.registered_image_ids)
    dr = max(_rot_deg(np_quat_to_rotmat(a.images[i].qvec),
                      np_quat_to_rotmat(b.images[i].qvec))
             for i in a.registered_image_ids)
    log("pose_graph_optimizer", f"{m.group(0)}; "
        f"{out.strip().splitlines()[-1]}; {wall:.1f} s wall; poses moved "
        f"by at most {dc:.3g} (centre) and {dr:.3g} deg")
    require(dc <= PG_GATES["cli_max_center_frac"] * RING_RADIUS
            and dr <= PG_GATES["cli_max_rot_deg"],
            f"pose_graph_optimizer: poses moved {dc}, {dr} deg")
    _model_gates(work / "pg", scene, FRONTEND_SCENE["num_images"],
                 "pose_graph_optimizer")


HIER_FLAGS = ("--SceneClustering.leaf_max_num_images", "12",
              "--SceneClustering.image_overlap", "4")
# sba_tpu's merge keeps points of up to 8 px (merge_reconstructions'
# max_reproj_error) and its seam relaxation moves poses, not points: the
# merged model is held to MAPPER_GATES' pose gates and this bound, and to
# all of MAPPER_GATES after a global BA.
HIER_MAX_REPROJ_PX = 8.0


def phase_hierarchical(scene, work):
    """`hierarchical_mapper` at its defaults (but HIER_FLAGS: two leaves
    of 16 views) on the frontend phase's exhaustive database: its leaves,
    one merge and the seam relaxation printed; one merged model of all 24
    views within MAPPER_GATES' pose gates and HIER_MAX_REPROJ_PX, and
    within all of MAPPER_GATES after `bundle_adjuster` (float64, the
    SIMPLE_RADIAL model). Then `model_merger` on the two leaf models of
    the same run: every image common to the leaves registered."""
    from sba_tpu_torch.models.reconstruction import Reconstruction

    out, wall = _run_frontend_cli(
        ["hierarchical_mapper", "--database_path", str(work / "db.db"),
         "--output_path", str(work / "hier"), "--leaf_output_path",
         str(work / "leaves"), *HIER_FLAGS], "hierarchical_mapper")
    leaves = re.findall(r"leaf (\d+): (\d+) images -> (\d+) models in (\S+) s",
                        out)
    m = re.search(r"hierarchical mapper: (\S+) s; leaves' mappers (\S+) s, "
                  r"merging (\S+) s \((\d+) merges\), relaxing (\S+) s "
                  r"\(relaxed: (\w+)\)", out)
    require(m is not None and len(leaves) == 2,
            f"hierarchical_mapper output:\n{out[-2000:]}")
    log("hierarchical", f"{wall:.1f} s wall: leaves' mappers {m.group(2)} s "
        f"({', '.join(f'{n} views -> {k} models in {s} s' for _, n, k, s in leaves)}), "
        f"merging {m.group(3)} s ({m.group(4)} merges), relaxing "
        f"{m.group(5)} s (relaxed: {m.group(6)})")
    _mapper_stats(out, "hierarchical")
    require(int(m.group(4)) >= 1 and m.group(6) == "True"
            and not (work / "hier" / "1").exists(),
            f"hierarchical: merges {m.group(4)}, relaxed {m.group(6)}")
    n = FRONTEND_SCENE["num_images"]
    _model_gates(work / "hier" / "0", scene, n, "hierarchical",
                 dict(MAPPER_GATES, max_reproj_px=HIER_MAX_REPROJ_PX))
    out, wall = _run_frontend_cli(
        ["bundle_adjuster", "--input_path", str(work / "hier" / "0"),
         "--output_path", str(work / "hier_ba"),
         "--BundleAdjustment.model_id", "2"], "bundle_adjuster")
    m = re.search(r"BA: cost \S+ -> \S+ in \d+ iters", out)
    require(m is not None, f"bundle_adjuster output:\n{out[-2000:]}")
    log("hierarchical", f"bundle_adjuster on the merged model: "
        f"{m.group(0)}; {wall:.1f} s")
    _model_gates(work / "hier_ba", scene, n, "hierarchical+BA")
    paths = [work / "leaves" / str(k) for k in (0, 1)]
    recs = [Reconstruction.read(str(p)) for p in paths]
    names = [{r.images[i].name for i in r.registered_image_ids}
             for r in recs]
    out, wall = _run_frontend_cli(
        ["model_merger", "--input_path1", str(paths[0]), "--input_path2",
         str(paths[1]), "--output_path", str(work / "merged")],
        "model_merger")
    merged = Reconstruction.read(str(work / "merged"))
    got = {merged.images[i].name for i in merged.registered_image_ids}
    common = names[0] & names[1]
    log("model_merger", f"{out.strip().splitlines()[-1]}; {wall:.2f} s; "
        f"leaves of {len(names[0])} and {len(names[1])} views, "
        f"{len(common)} common, merged {len(got)}")
    require(len(common) >= 3 and common <= got
            and got == names[0] | names[1],
            f"model_merger: {sorted(got)} from {sorted(names[0])} and "
            f"{sorted(names[1])}")


# A 4-camera rig (a car's side cameras, two per side) over 64 snapshots
# 0.5 apart along a 32-long street centred on the origin, 1600x1200
# SIMPLE_RADIAL, 40,000 points on its two walls 6 away; every image pose
# perturbed off the rig by a rotation of rot_noise rad and a camera
# centre shift of trans_noise (a tvec perturbation, as
# tests/test_camera_rig.py's scene near the origin takes, would move
# the far cameras' centres by metres here), held to that test's 0.2
# recovery factor in its measure (max quaternion + max tvec error).
# GR6P's gates are the rotation and the translation's direction: its
# scale rests on the few cross-camera correspondences of a 1-long move
# past walls 6 away, and read 10-12% off in CPU probes at 16 snapshots
# (rotation 0.14-0.16 deg); it is printed. The generalized absolute pose
# read 0.0002-0.0003 deg and 3e-5 there.
RIG_SCENE = dict(num_snapshots=64, num_points=40_000, image_size=(1600, 1200),
                 focal=1200.0, k=-0.05, spacing=0.5, wall=6.0,
                 pixel_noise=0.5, rot_noise=0.01, trans_noise=0.05, seed=7)
RIG_GATES = dict(max_err_ratio=0.2, gr6p_max_rot_deg=0.5,
                 gr6p_max_t_dir_deg=5.0, gr6p_outliers=0.3, gr6p_pairs=60,
                 gp_max_rot_deg=0.05, gp_max_center=0.01, gp_outliers=0.1)


def _look(d):
    import numpy as np

    z = np.asarray(d, np.float64) / np.linalg.norm(d)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def _rig_scene():
    """The rig scene's truth: per snapshot the rig (camera 1) pose, the
    cameras' fixed poses relative to it, every camera's pose, the points,
    and each camera's observations (pixels through SIMPLE_RADIAL with
    noise, and the undistorted pixels of the same noise)."""
    import numpy as np
    import torch

    from sba_tpu_torch.geometry import camera_models
    from sba_tpu_torch.geometry.quaternions import (np_angle_axis_to_quat,
                                                    np_quat_to_rotmat,
                                                    np_rotmat_to_quat)

    c = RIG_SCENE
    rng = np.random.default_rng(c["seed"])
    S, P = c["num_snapshots"], c["num_points"]
    W, H = c["image_size"]
    f = c["focal"]
    dirs = [(0, 1, 0), (np.sin(0.6), np.cos(0.6), 0), (0, -1, 0),
            (np.sin(0.6), -np.cos(0.6), 0)]
    offsets = [np.zeros(3), np.array([0.8, 0.0, 0.0]),
               np.array([0.0, 0.0, -1.6]), np.array([0.8, 0.0, -1.6])]
    R_base = [_look(d) for d in dirs]
    rel = []   # camera k from camera 0: (R, t)
    for k in range(4):
        Rr = R_base[k] @ R_base[0].T
        rel.append((Rr, -Rr @ offsets[k]))
    half = S * c["spacing"] / 2
    pts = np.stack([rng.uniform(-half - 6, half + 6, P),
                    np.where(rng.uniform(size=P) < 0.5, 1, -1)
                    * (c["wall"] + rng.uniform(-0.5, 0.5, P)),
                    rng.uniform(-1.5, 2.5, P)], 1)
    poses = np.zeros((S, 4, 7))
    rig = np.zeros((S, 7))
    params = np.array([f, W / 2, H / 2, c["k"]])
    obs = {k: [] for k in ("snap", "cam", "point", "dist", "pin")}
    for s in range(S):
        center = np.array([(s - S / 2) * c["spacing"], 0.1 * rng.normal(),
                           0.05 * rng.normal()])
        R0 = R_base[0] @ np_quat_to_rotmat(np_angle_axis_to_quat(
            rng.normal(0, 0.01, 3)))
        t0 = -R0 @ center
        rig[s] = np.concatenate([np_rotmat_to_quat(R0), t0])
        for k, (Rr, tr) in enumerate(rel):
            R, t = Rr @ R0, Rr @ t0 + tr
            poses[s, k] = np.concatenate([np_rotmat_to_quat(R), t])
            pc = pts @ R.T + t
            z = pc[:, 2]
            uv = pc[:, :2] / np.maximum(z, 1e-9)[:, None]
            noise = rng.normal(0, c["pixel_noise"], uv.shape)
            dist = camera_models.world_to_image(
                2, torch.as_tensor(params), torch.as_tensor(uv)).numpy() \
                + noise
            ok = np.nonzero((z > 0.5) & (dist[:, 0] >= 0) & (dist[:, 0] < W)
                            & (dist[:, 1] >= 0) & (dist[:, 1] < H))[0]
            for key, val in (("snap", np.full(len(ok), s)),
                             ("cam", np.full(len(ok), k)), ("point", ok),
                             ("dist", dist[ok]),
                             ("pin", uv[ok] * f + [W / 2, H / 2]
                              + noise[ok])):
                obs[key].append(val)
    obs = {k: np.concatenate(v) for k, v in obs.items()}
    return dict(rig=rig, rel=rel, poses=poses, points=pts, obs=obs,
                params=params)


def _rig_pose_err(q, t, q_gt, t_gt):
    """tests/test_camera_rig.py's measure: max quaternion difference (up
    to sign) + max translation difference."""
    import numpy as np

    qe = np.minimum(np.abs(q - q_gt), np.abs(q + q_gt)).max()
    return float(qe + np.abs(t - t_gt).max())


def phase_rig():
    """The rig scene written as a COLMAP model (every image pose perturbed
    off the rig) with a JSON rig config, `rig_bundle_adjuster` at its
    defaults on the card (the SIMPLE_RADIAL model named by
    `--BundleAdjustment.model_id 2`): the cost falls and the composed
    poses beat the perturbed ones by RIG_GATES' ratio. Then GR6P
    (`estimate_snapshot_relative_pose`) on two snapshots 2 apart with 30%
    outliers and `estimate_generalized_absolute_pose` on one snapshot
    (10% outliers), both on the card, against the truth."""
    import numpy as np
    import torch

    from sba_tpu_torch.estimators.generalized_pose import (
        estimate_generalized_absolute_pose, refine_generalized_absolute_pose)
    from sba_tpu_torch.geometry.quaternions import (np_angle_axis_to_quat,
                                                    np_quat_rotate,
                                                    np_quat_to_rotmat,
                                                    np_rotmat_to_quat)
    from sba_tpu_torch.io.colmap_models import Camera
    from sba_tpu_torch.models.camera_rig import (
        CameraRig, estimate_snapshot_relative_pose)
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.ops import cuda_build

    t = time.perf_counter()
    sc = _rig_scene()
    c = RIG_SCENE
    S = c["num_snapshots"]
    W, H = c["image_size"]
    rng = np.random.default_rng(c["seed"] + 1)
    gt = sc["poses"].reshape(S * 4, 7)          # row = 4 s + k
    q_n = np.stack([np_rotmat_to_quat(np_quat_to_rotmat(q) @ np_quat_to_rotmat(
        np_angle_axis_to_quat(a))) for q, a in zip(
            gt[:, :4], rng.normal(0, c["rot_noise"], (S * 4, 3)))])
    c_n = _centers(gt[:, :4], gt[:, 4:]) + rng.normal(
        0, c["trans_noise"], (S * 4, 3))
    t_n = -np_quat_rotate(q_n, c_n)
    o = sc["obs"]
    rec = _rec_from_observations(
        [Camera(k + 1, 2, W, H, sc["params"]) for k in range(4)],
        np.tile(np.arange(1, 5), S), q_n, t_n,
        [f"cam{k}/snap{s:03d}.png" for s in range(S) for k in range(4)],
        sc["points"], 4 * o["snap"] + o["cam"], o["point"], o["dist"])
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="rig_", dir=cuda_build.BUILD_DIR))
    try:
        rec.write(str(work / "model"))
        with open(work / "rig.json", "w") as fh:
            json.dump([{"ref_camera_id": 1, "cameras": [
                {"camera_id": k + 1, "image_prefix": f"cam{k}/"}
                for k in range(4)]}], fh)
        n_obs = rec.compute_num_observations()
        log("rig", f"scene: {S} snapshots x 4 cameras of {W}x{H} "
            f"SIMPLE_RADIAL, {rec.num_points3d()} points, {n_obs} "
            f"observations; built and written in "
            f"{time.perf_counter() - t:.1f} s")
        out, wall = _run_frontend_cli(
            ["rig_bundle_adjuster", "--input_path", str(work / "model"),
             "--output_path", str(work / "out"), "--rig_config_path",
             str(work / "rig.json"), "--BundleAdjustment.model_id", "2"],
            "rig_bundle_adjuster")
        m = re.search(r"rig BA: (\d+) snapshots, cost (\S+) -> (\S+) in (\d+) "
                      r"iterations \((\d+) accepted\), (\S+) s", out)
        require(m is not None and f"Camera Rig: 4 cameras, {S} snapshots" in out,
                f"rig_bundle_adjuster output:\n{out[-2000:]}")
        res = Reconstruction.read(str(work / "out"))
        ids = sorted(res.images)
        q = np.stack([res.images[i].qvec for i in ids])
        tt = np.stack([res.images[i].tvec for i in ids])
        before = _rig_pose_err(q_n, t_n, gt[:, :4], gt[:, 4:])
        after = _rig_pose_err(q, tt, gt[:, :4], gt[:, 4:])
        log("rig", f"rig_bundle_adjuster: {m.group(1)} snapshots, cost "
            f"{m.group(2)} -> {m.group(3)} in {m.group(4)} iterations "
            f"({m.group(5)} accepted), {m.group(6)} s of solve, {wall:.1f} s "
            f"wall; pose error {before:.5f} -> {after:.5f} "
            f"({after / before:.3f} of it)")
        require(float(m.group(3)) < float(m.group(2))
                and after < RIG_GATES["max_err_ratio"] * before,
                f"rig: cost {m.group(2)} -> {m.group(3)}, pose error "
                f"{before} -> {after}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # GR6P between snapshots a and b = a + 2 (pinhole pixels), each
    # point through a camera drawn among those that see it in a, and in b
    # through another camera where one sees it (the rig's cross-camera
    # tracks, which observe the scale of its motion).
    f = c["focal"]
    a, b = S // 2, S // 2 + 2
    rig = CameraRig(ref_camera_id=1)
    for k, (Rr, tr) in enumerate(sc["rel"]):
        rig.add_camera(k + 1, np_rotmat_to_quat(Rr), tr)
    cams = {k + 1: (f, f, W / 2, H / 2) for k in range(4)}
    seen = {a: {}, b: {}}
    for j in np.nonzero((o["snap"] == a) | (o["snap"] == b))[0]:
        seen[o["snap"][j]].setdefault(o["point"][j], []).append(
            (o["cam"][j] + 1, o["pin"][j]))
    both = sorted(set(seen[a]) & set(seen[b]))
    pick = rng.choice(len(both), RIG_GATES["gr6p_pairs"], replace=False)
    obs1 = [seen[a][both[i]][rng.integers(len(seen[a][both[i]]))]
            for i in pick]
    obs2 = []
    for i, x in zip(pick, obs1):
        other = [v for v in seen[b][both[i]] if v[0] != x[0]]
        v = other or seen[b][both[i]]
        obs2.append(v[rng.integers(len(v))])
    cross = sum(x[0] != y[0] for x, y in zip(obs1, obs2))
    n_out = int(RIG_GATES["gr6p_outliers"] * len(pick))
    for j in range(n_out):
        obs2[j] = (obs2[j][0], rng.uniform([0, 0], [W, H]))
    Ra, ta = np_quat_to_rotmat(sc["rig"][a, :4]), sc["rig"][a, 4:]
    Rb, tb = np_quat_to_rotmat(sc["rig"][b, :4]), sc["rig"][b, 4:]
    R_true = Rb @ Ra.T
    t_true = tb - R_true @ ta
    t0 = time.perf_counter()
    rep = estimate_snapshot_relative_pose(
        rig, cams, obs1, obs2, device="cuda",
        generator=torch.Generator().manual_seed(0))
    g_wall = time.perf_counter() - t0
    rot = _rot_deg(rep.R, R_true)
    tdir = float(np.degrees(np.arccos(np.clip(
        rep.t @ t_true / max(np.linalg.norm(rep.t) * np.linalg.norm(t_true),
                             1e-30), -1.0, 1.0))))
    scale = float(np.linalg.norm(rep.t) / np.linalg.norm(t_true))
    log("rig", f"GR6P on snapshots {a}, {b}: {len(pick)} "
        f"correspondences ({cross} across cameras, {n_out} outliers): "
        f"{rep.num_inliers} inliers "
        f"({int(rep.inlier_mask[:n_out].sum())} of the outliers), rotation "
        f"error {rot:.4f} deg, translation direction error {tdir:.4f} deg, "
        f"|t| / |t_true| {scale:.4f}; {g_wall:.2f} s")
    require(rep.success and rot < RIG_GATES["gr6p_max_rot_deg"]
            and tdir < RIG_GATES["gr6p_max_t_dir_deg"],
            f"rig: GR6P rotation {rot} deg, translation direction {tdir} deg")

    # The generalized absolute pose of snapshot b (normalized coordinates).
    b = S // 4
    sel = np.nonzero(o["snap"] == b)[0]
    p3 = sc["points"][o["point"][sel]]
    p2 = (o["pin"][sel] - [W / 2, H / 2]) / f
    bad = rng.choice(len(sel), int(RIG_GATES["gp_outliers"] * len(sel)),
                     replace=False)
    p2[bad] += rng.uniform(0.05, 0.2, (len(bad), 2))
    cc = o["cam"][sel]
    rq = np.stack([np_rotmat_to_quat(Rr) for Rr, _ in sc["rel"]])
    rt = np.stack([tr for _, tr in sc["rel"]])
    dev = [torch.as_tensor(x, device="cuda") for x in (p3, p2, cc, rq, rt)]
    t0 = time.perf_counter()
    gp = estimate_generalized_absolute_pose(
        *dev, generator=torch.Generator("cuda").manual_seed(0))
    qr, tr_ = refine_generalized_absolute_pose(
        gp.qvec, gp.tvec, *dev, weights=gp.inlier_mask.double())
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - t0
    q_est, t_est = qr.cpu().numpy(), tr_.cpu().numpy()
    rot = _rot_deg(np_quat_to_rotmat(q_est), np_quat_to_rotmat(sc["rig"][b, :4]))
    cerr = float(np.linalg.norm(
        _centers(q_est[None], t_est[None])
        - _centers(sc["rig"][b, None, :4], sc["rig"][b, None, 4:])))
    inl = gp.inlier_mask.cpu().numpy()
    log("rig", f"generalized absolute pose of snapshot {b}: {len(sel)} "
        f"correspondences over 4 cameras ({len(bad)} outliers), "
        f"{int(inl.sum())} inliers ({int(inl[bad].sum())} of the outliers); "
        f"rotation error {rot:.5f} deg, centre error {cerr:.5f}; "
        f"{p_wall:.2f} s")
    require(rot < RIG_GATES["gp_max_rot_deg"]
            and cerr < RIG_GATES["gp_max_center"] and not inl[bad].any(),
            f"rig: generalized pose rotation {rot} deg, centre {cerr}")


# ---------------------------------------------------------------------------
# parallel: the SPMD solvers (sba_tpu_torch.parallel and the sharded pose
# graph) on torch.distributed
# ---------------------------------------------------------------------------

PAR_RANKS = 2            # gloo ranks sharing card 0 (NCCL refuses that)
PAR_F64_IT = 3           # LM iterations of the float64 headline solves
PAR_PG_IT_ONE_RANK = 10  # LM iterations of the one-rank pose graph check
PAR_TIMEOUT_S = 300      # the spawned ranks' run, every collective in it
# Gates of the sharded solves against the single-device ones on the card:
# float32 BA final cost rtol 1e-3, float64 1e-6; SBA as phase sba holds
# the card against the CPU twins (cost rtol 1e-3, poses 5e-3); the
# forest as phase gsba holds float32 against float64 (cost rtol 1e-3);
# the pose graph at PG_GATES.
PAR_GATES = dict(f32=1e-3, f64=1e-6, sba_pose=5e-3)
# The first accepted LM step's cost, which a wrong step moves at first
# order (a converged final cost barely moves): the sharded solve's must
# lie within PAR_FIRST_SPREAD_X times the spread of PAR_FIRST_RERUNS
# single-device reruns of that step (the kernels' and index_add_'s float
# atomics sum in no fixed order; the pose graph's reruns take its edges
# in other orders), or within PAR_FIRST_ULPS units of the dtype's
# rounding (eps), relative, where the reruns agree to the bit.
PAR_FIRST_RERUNS = 3
PAR_FIRST_SPREAD_X = 10.0
PAR_FIRST_ULPS = 1024


def _par_case(kind, problem, opt):
    """A case for the ranks, picklable: (kind, the problem's class and
    fields as numpy, the options)."""
    return kind, type(problem), {
        k: None if v is None else v.detach().cpu().numpy()
        for k, v in problem._asdict().items()}, opt


def _par_inputs(case, device):
    import torch

    kind, problem_cls, fields, opt = case
    return kind, problem_cls(**{
        k: None if v is None else torch.as_tensor(v, device=device)
        for k, v in fields.items()}), opt


def _par_solve(kind, problem, opt, sharded):
    """One solve of `kind`: the SPMD entry point (over the world group),
    or its single-device counterpart. Returns (problem, summary)."""
    import dataclasses

    from sba_tpu_torch import parallel
    from sba_tpu_torch.optim import ba, ba_fused, gsba, pose_graph, sba

    if kind == "fused":
        return (parallel.distributed_bundle_adjust_fused if sharded
                else ba_fused.bundle_adjust_fused)(problem, opt)
    if kind == "obs":
        if sharded:
            return parallel.distributed_bundle_adjust(problem, opt)
        return ba.bundle_adjust(problem, dataclasses.replace(
            opt, solver="schur_pcg"))
    if kind == "pm":
        if sharded:
            return parallel.distributed_bundle_adjust_pm(problem, opt)
        return ba.bundle_adjust(problem, dataclasses.replace(
            opt, solver="explicit_schur"))
    if kind == "sba":
        return (parallel.semantic_bundle_adjust_spmd if sharded
                else sba.semantic_bundle_adjust)(problem, opt)
    if kind == "gsba":
        return (parallel.geometric_semantic_bundle_adjust_spmd if sharded
                else gsba.geometric_semantic_bundle_adjust)(problem, opt)
    return (pose_graph.distributed_optimize_pose_graph if sharded
            else pose_graph.optimize_pose_graph)(problem, opt)


def _par_single(kind, problem, opt, reorder=False):
    """A function of the options that runs the single-device solve of
    `kind` on `problem` (the fused path prepared once). The pose graph
    sums in a fixed order and repeats itself bit for bit; with `reorder`
    each of its calls takes the edges in a fresh order, as phase
    pose-graph's PG_EDGE_ORDERS do, so that its reruns spread as far as
    another summation order moves them."""
    import dataclasses

    import numpy as np
    import torch

    from sba_tpu_torch.optim import ba_fused

    if kind == "fused":
        ctx = ba_fused.prepare(problem, opt)
        return lambda o: ba_fused.solve_prepared(ctx[:5] + (o,) + ctx[6:])
    if kind == "pm":
        # The point-major layout of the sharded solve, on one device.
        from sba_tpu_torch.optim.ba import _bundle_adjust_impl
        from sba_tpu_torch.parallel.distributed_ba import (
            shard_problem_by_points)

        sh, perm = shard_problem_by_points(problem, 1)
        back = torch.argsort(perm)

        def solve(o):
            out, s = _bundle_adjust_impl(sh, dataclasses.replace(
                o, solver="explicit_schur", obs_layout="point_major"))
            return out._replace(points=out.points[back]), s
        return solve
    if kind == "pg" and reorder:
        calls = [0]
        e = problem.edge_i.shape[0]

        def solve(o):
            calls[0] += 1
            order = torch.as_tensor(np.random.default_rng(
                200 + calls[0]).permutation(e), device=problem.edge_i.device)
            return _par_solve(kind, problem._replace(**{
                f: getattr(problem, f)[order] for f in (
                    "edge_i", "edge_j", "rel_q", "rel_t", "rel_log_s",
                    "sqrt_info", "edge_mask")}), o, False)
        return solve
    return lambda o: _par_solve(kind, problem, o, False)


def _par_first_step(name, single, opt, got_trace, eps, ref_trace=None):
    """Gate the sharded solve's first accepted step (`got_trace`, its
    cost trace) against PAR_FIRST_RERUNS single-device reruns of it
    (`single(options)`), at the first LM iteration that the
    single-device solve (`ref_trace`, else a solve of up to 10 LM
    iterations) accepts. Returns the reading for the log."""
    import dataclasses

    import numpy as np

    def trace(its):
        o = dataclasses.replace(opt, max_iterations=its)
        return np.asarray(single(o)[1].cost_trace.detach().cpu().numpy(),
                          np.float64)

    t = (trace(min(opt.max_iterations, 10)) if ref_trace is None
         else np.asarray(ref_trace, np.float64))
    k = next((i for i in range(1, len(t))
              if np.isfinite(t[i]) and t[i] != t[0]), None)
    require(k is not None, f"parallel {name}: the single-device solve "
            f"accepted none of its first {len(t) - 1} steps")
    vals = np.array([trace(k)[k] for _ in range(PAR_FIRST_RERUNS)])
    mid = float(np.median(vals))
    spread = float(vals.max() - vals.min()) / abs(mid)
    gap = abs(float(got_trace[k]) - mid) / abs(mid)
    limit = max(PAR_FIRST_SPREAD_X * spread, PAR_FIRST_ULPS * eps)
    require(gap <= limit, f"parallel {name}: the cost after the first "
            f"accepted step (LM iteration {k}) is {gap:.3e} from the "
            f"single-device one (> {limit:.3e}; {PAR_FIRST_RERUNS} reruns' "
            f"spread {spread:.3e})")
    return (f"first accepted step (it {k}) {gap:.3e} from one device "
            f"(<= {limit:.3e}; reruns' spread {spread:.3e})")


def _par_result(problem, summary):
    """The solved state and costs as numpy (float64 for the costs)."""
    import numpy as np

    state = {f: getattr(problem, f).detach().cpu().numpy()
             for f in ("qvecs", "tvecs", "points", "cyl_tvec", "log_scales")
             if getattr(problem, f, None) is not None}
    costs = {f: float(getattr(summary, f)) for f in
             ("initial_cost", "final_cost")}
    return dict(state=state, iterations=int(summary.num_iterations),
                trace=np.asarray(summary.cost_trace.detach().cpu()
                                 .numpy(), np.float64), **costs)


def _parallel_rank(rank, world, device, cases):
    """The body of each spawned rank: every case solved sharded over the
    world group, with its wall time, the kernels' launch counts and the
    all-reduces."""
    import torch

    from sba_tpu_torch.ops import ba_kernels as bk
    from sba_tpu_torch.ops import map_gather as mg
    from sba_tpu_torch.parallel import group

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, case in cases.items():
        kind, problem, opt = _par_inputs(case, device)
        torch.cuda.synchronize()
        bk.reset_launches()
        mg.reset_launches()
        group.reset_stats()
        t = time.perf_counter()
        res = _par_result(*_par_solve(kind, problem, opt, True))
        torch.cuda.synchronize()
        res.update(wall=time.perf_counter() - t,
                   launches=dict(bk.LAUNCHES, **mg.LAUNCHES),
                   allreduce=dict(group.STATS))
        out[name] = res
        del problem
        torch.cuda.empty_cache()
    return out


def _par_diff(a, b):
    """The largest |difference| of two results' states and final costs,
    each relative to the larger magnitude of the field."""
    import numpy as np

    d = abs(a["final_cost"] - b["final_cost"]) / max(abs(a["final_cost"]),
                                                     1e-30)
    for f, x in a["state"].items():
        scale = max(float(np.abs(x).max()), 1e-30)
        d = max(d, float(np.abs(x.astype(np.float64)
                                - b["state"][f].astype(np.float64)).max())
                / scale)
    return d


def _par_equal(a, b):
    import numpy as np

    return (a["final_cost"] == b["final_cost"]
            and a["iterations"] == b["iterations"]
            and all(np.array_equal(x, b["state"][f])
                    for f, x in a["state"].items()))


def _par_one_rank(cases):
    """Each sharded solve at world size 1 (NCCL, this process) against
    its single-device counterpart on the same tensors: bit for bit where
    the single-device solve repeats itself bit for bit; where it does not
    (the BA kernels' float atomics and CUDA's index_add_ sum in no fixed
    order, csrc/ba_kernels.cuh), the first accepted step's cost within
    the reruns' spread (`_par_first_step`) and the final cost within
    PAR_GATES (a 10-iteration float32 solve amplifies that spread
    chaotically, to ~1e-3 of the state)."""
    import torch

    for name, case in cases.items():
        kind, problem, opt = _par_inputs(case, "cuda")
        single = _par_single(kind, problem, opt)
        t = time.perf_counter()
        a = _par_result(*single(opt))
        t_single = time.perf_counter() - t
        t = time.perf_counter()
        b = _par_result(*_par_solve(kind, problem, opt, True))
        t_shard = time.perf_counter() - t
        if _par_equal(a, b):
            how = "bit for bit"
        else:
            spread = _par_diff(a, _par_result(*single(opt)))
            gap = abs(b["final_cost"] - a["final_cost"]) / a["final_cost"]
            tol = PAR_GATES["f64" if kind in ("obs", "pm") else "f32"]
            require(spread > 0 and gap <= tol,
                    f"parallel {name}: one-rank final cost {gap:.3e} from "
                    f"the single-device one (> {tol:g}, or that solve "
                    f"repeats itself bit for bit: spread {spread:.3e})")
            reruns = _par_single(kind, problem, opt, reorder=True)
            first = _par_first_step(name, reruns, opt, b["trace"],
                                    torch.finfo(problem.qvecs.dtype).eps,
                                    a["trace"])
            how = (f"final cost at {gap:.3e} (<= {tol:g}), {first} (the "
                   f"single-device solve is not reproducible: state "
                   f"{_par_diff(a, b):.3e} from it, its own rerun "
                   f"{spread:.3e}, relative)")
        log("parallel", f"NCCL, 1 rank: {name} ({a['iterations']} LM it): "
            f"sharded = single-device {how}; {t_shard:.2f} s vs "
            f"{t_single:.2f} s")
        del problem, single


def phase_parallel(ctx, ctx_i, sba_ctx, forest_ctx, pg_ctx):
    """The SPMD solvers on the card. (a) NCCL at one rank per card: at
    one card, in this process, each sharded solve against its
    single-device counterpart (`_par_one_rank`); (b) PAR_RANKS gloo ranks
    sharing card 0, spawned once for all solves, at full width: the
    headline (K1, K4, K5), the 1024-image scene (K2-K5), the float64
    observation-sharded PCG and point-sharded explicit solves of the
    headline scene, bench_sba (map_gather), the GSBA forest and the
    1024-pose SE3 and Sim3 pose graphs, each gated against the
    single-device solve on the card (PAR_GATES, PG_GATES); both ranks
    bit-equal, and each rank's kernels launched."""
    import dataclasses

    import numpy as np
    import torch

    from sba_tpu_torch.optim import ba_fused
    from sba_tpu_torch.optim.ba import BAOptions, bundle_adjust
    from sba_tpu_torch.optim.gsba import geometric_semantic_bundle_adjust
    from sba_tpu_torch.optim.pose_graph import optimize_pose_graph
    from sba_tpu_torch.optim.sba import semantic_bundle_adjust
    from sba_tpu_torch.parallel import group
    from sba_tpu_torch.utils.synthetic import make_ba_problem

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    p64 = make_ba_problem(dtype=torch.float64, device="cuda", **HEADLINE)[0]
    o64 = BAOptions(max_iterations=PAR_F64_IT, function_tolerance=0.0,
                    gradient_tolerance=0.0, parameter_tolerance=0.0)
    pf, of, sf = forest_ctx

    # The scenes' one camera, shared by every image, with its intrinsics
    # free: every rank sums the same replicated per-camera rows.
    def free_cam(p):
        return p._replace(free_cam=torch.ones_like(p.free_cam))

    def pg_problem(tag):
        base, opt, *_ = pg_ctx[tag]
        return base._replace(**{
            f: (v.float() if v.is_floating_point() else v).to("cuda")
            for f, v in base._asdict().items()}), opt

    cases = {
        "headline": _par_case("fused", ctx[4], ctx[5]),
        "1024 images": _par_case("fused", ctx_i[4], ctx_i[5]),
        "f64 obs-sharded PCG": _par_case("obs", p64, dataclasses.replace(
            o64, solver="schur_pcg")),
        "f64 point-sharded explicit": _par_case("pm", p64, o64),
        "1024 images, free shared intrinsics": _par_case(
            "fused", free_cam(ctx_i[4]), ctx_i[5]),
        "f64 point-sharded explicit, free shared intrinsics": _par_case(
            "pm", free_cam(p64), o64),
        "bench_sba": _par_case("sba", *sba_ctx),
        "forest": _par_case("gsba", pf, of),
        "pose graph SE3": _par_case("pg", *pg_problem("SE3")),
        "pose graph Sim3": _par_case("pg", *pg_problem("Sim3")),
    }

    # (a) NCCL, one rank per card.
    n_cards = torch.cuda.device_count()
    t = time.perf_counter()
    if n_cards == 1:
        # Each solver once: the fused path on the headline, the pose
        # graph in SE3 at PAR_PG_IT_ONE_RANK LM iterations.
        one = {k: v for k, v in cases.items()
               if k not in ("1024 images", "pose graph Sim3")
               and "free" not in k}
        kind, cls, fields, opt = one["pose graph SE3"]
        one["pose graph SE3"] = (kind, cls, fields, dataclasses.replace(
            opt, max_iterations=PAR_PG_IT_ONE_RANK))
        with group.single_rank("nccl"):
            _par_one_rank(one)
        nccl = None
    else:
        nccl = group.run_ranks(_parallel_rank, n_cards, "nccl", "cuda",
                               args=(cases,), timeout=PAR_TIMEOUT_S)
    log("parallel", f"(a) NCCL at {n_cards} rank(s), one per card: "
        f"{time.perf_counter() - t:.1f} s; {card}")

    # (b) PAR_RANKS gloo ranks on card 0, spawned once for every solve.
    t = time.perf_counter()
    results = group.run_ranks(_parallel_rank, PAR_RANKS, "gloo", "cuda:0",
                              args=(cases,), timeout=PAR_TIMEOUT_S)
    t_ranks = time.perf_counter() - t

    # The single-device solves on the card.
    explicit = dataclasses.replace(o64, solver="explicit_schur")
    ref = {"headline": ba_fused.solve_prepared(ctx)[1],
           "1024 images": ba_fused.solve_prepared(ctx_i)[1],
           "f64 obs-sharded PCG": bundle_adjust(p64, dataclasses.replace(
               o64, solver="schur_pcg"))[1],
           "f64 point-sharded explicit": bundle_adjust(p64, explicit)[1],
           "1024 images, free shared intrinsics":
               ba_fused.bundle_adjust_fused(free_cam(ctx_i[4]),
                                            ctx_i[5])[1],
           "f64 point-sharded explicit, free shared intrinsics":
               bundle_adjust(free_cam(p64), explicit)[1],
           "forest": sf}
    sba_out, ref["bench_sba"] = semantic_bundle_adjust(*sba_ctx)
    del p64
    kernels = {"headline": DENSE_KERNELS, "1024 images": IMPLICIT_KERNELS,
               "1024 images, free shared intrinsics": IMPLICIT_KERNELS,
               "bench_sba": ("map_gather",)}
    # The first accepted step of each solve against single-device reruns.
    first = {}
    for name, case in cases.items():
        kind, problem, opt = _par_inputs(case, "cuda")
        first[name] = (_par_single(kind, problem, opt, reorder=True), opt,
                       torch.finfo(problem.qvecs.dtype).eps)
        del problem
    for group_name, runs in (("NCCL", nccl), ("gloo", results)):
        if runs is None:
            continue
        for name in cases:
            r = [run[name] for run in runs]
            for k in range(1, len(r)):
                require(_par_equal(r[0], r[k]),
                        f"parallel {group_name} {name}: rank {k}'s solve "
                        f"is not bit-equal to rank 0's")
            for k, run in enumerate(r):
                require(all(run["launches"][x] > 0
                            for x in kernels.get(name, ())),
                        f"parallel {group_name} {name}: rank {k} launched "
                        f"{run['launches']}")
            got = r[0]
            c0, c1 = got["initial_cost"], got["final_cost"]
            require(c1 < c0, f"parallel {name}: cost {c0} -> {c1}")
            if name.startswith("pose graph"):
                tag = name.split()[-1]
                _, _, c32, drift0, truth = pg_ctx[tag]
                st = got["state"]
                drift = _drifts(st["qvecs"].astype(np.float64),
                                st["tvecs"].astype(np.float64),
                                st["log_scales"].astype(np.float64), truth)
                gap = abs(c1 - c32) / c32
                require(gap <= PG_GATES["cost_rtol"] and drift0[0] / drift[0]
                        >= PG_GATES["min_rel_drift_drop"],
                        f"parallel {name}: final cost {c1} vs {c32} on one "
                        f"device, relative drift {drift0[0]} -> {drift[0]}")
                gate = f"final cost vs one device {gap:.3e} (PG_GATES)"
            else:
                c_ref = float(ref[name].final_cost)
                gap = abs(c1 - c_ref) / c_ref
                tol = PAR_GATES["f64" if name.startswith("f64") else "f32"]
                require(gap <= tol, f"parallel {name}: final cost {c1} vs "
                        f"{c_ref} on one device ({gap:.3e} > {tol:g})")
                gate = f"final cost vs one device {gap:.3e} (<= {tol:g})"
                if name == "bench_sba":
                    pose = max(max_err(torch.as_tensor(got["state"][f]),
                                       getattr(sba_out, f).cpu())
                               for f in ("qvecs", "tvecs"))
                    require(pose <= PAR_GATES["sba_pose"],
                            f"parallel bench_sba: poses {pose:.3e} from "
                            f"the single-device solve")
                    gate += f", poses {pose:.2e}"
            single, opt, eps = first[name]
            gate += ", " + _par_first_step(
                f"{group_name} {name}", single, opt, got["trace"], eps,
                None if name.startswith("pose graph")
                else ref[name].cost_trace.detach().cpu().numpy())
            its = max(got["iterations"], 1)
            ar = got["allreduce"]
            log("parallel", f"{group_name} x{len(r)}: {name}: cost {c0:.6g} "
                f"-> {c1:.6g} in {got['iterations']} LM it, {gate}; "
                f"{got['wall']:.2f} s = {got['iterations'] / got['wall']:.2f} "
                f"LM it/s (a fresh process, first solve of its kind); "
                f"{ar['calls'] / its:.1f} all-reduces and "
                f"{ar['bytes'] / its / 2**20:.3f} MiB per LM iteration; "
                f"launches per rank {[json.dumps({k: v for k, v in run['launches'].items() if v}) for run in r]}; "
                f"ranks bit-equal; {card}")
    log("parallel", f"(b) {PAR_RANKS} gloo ranks on card 0: spawned and "
        f"solved in {t_ranks:.1f} s; {card}")


def phase_timing_sift():
    """map_gather at SIFT's index law (the first launch of one 1600x1200
    batch of 8, phase twins-frontend) against its plain version and
    torch.take on the same table; the bound counts the table words the
    samples touch, the indices and the output."""
    import torch

    from sba_tpu_torch.ops import map_gather as mg
    from sba_tpu_torch.utils.kernel_timing import time_ms

    table, idx, args = (SIFT_GATHER[k] for k in ("table", "idx", "args"))
    per, hw = (tuple(args) + (0, 0))[:2]
    gi = mg._flat_index(idx, per, hw)
    touched = int(torch.unique(gi).numel())
    word = table.element_size()
    bound = (touched * word + idx.numel() * (4 + word)) / HBM_BYTES_PER_S * 1e3
    ms = time_ms(lambda: mg.map_gather(table, idx, *args), 50)
    plain_ms = time_ms(lambda: mg.map_gather_plain(table, idx, *args), 5)
    lib_ms = time_ms(lambda: torch.take(table, gi), 50)
    log("timing", f"map_gather at SIFT's index law ({idx.numel()} samples "
        f"over a {table.numel()}-word table of {word}-byte words, "
        f"{touched} words touched): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.take {lib_ms:.4f} ms; bound {bound:.4f} ms (bytes: the "
        f"touched words, the indices and the output), {100 * bound / ms:.1f}"
        f"% of it")
    SIFT_GATHER.clear()


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
    ncc_launches, pm_solve, pm_ms, mvs_work = run("mvs", phase_mvs, scene)
    try:
        run("meshing", phase_meshing, scene, mvs_work)
        run("dense-writers", phase_dense_writers, scene, mvs_work)
    finally:
        shutil.rmtree(mvs_work, ignore_errors=True)
    del scene
    probe_in, gather_errs = run("twins-sba", phase_twins_sba)
    gather_launches, sba_ctx, sba_ms, pair_launches = run("sba", phase_sba)
    gather_launches["map_gather_pair"] = pair_launches["map_gather_pair"]
    run("cli-sba", phase_cli_sba)
    gsba_ctx, gsba_ms, forest_ctx = run("gsba", phase_gsba)
    run("cli-gsba", phase_cli_gsba)
    run("twins-frontend", phase_twins_frontend)
    fe_scene, fe_work = run("frontend", phase_frontend)
    fe_full = run("twins-frontend", phase_twins_frontend_full, fe_scene)
    try:
        run("retrieval", phase_retrieval, fe_scene, fe_work)
        init = run("mapper", phase_mapper, fe_scene, fe_work)
        run("twins-mapper", phase_twins_mapper, fe_work, init)
        run("pose-graph", phase_cli_pose_graph, fe_scene, fe_work)
        run("hierarchical", phase_hierarchical, fe_scene, fe_work)
        run("point_triangulator", phase_point_triangulator, fe_scene,
            fe_work)
        run("automatic_reconstructor", phase_automatic, fe_scene, fe_work)
    finally:
        shutil.rmtree(fe_work, ignore_errors=True)
    del fe_scene
    pg_ctx = run("pose-graph", phase_pose_graph)
    run("rig", phase_rig)
    run("parallel", phase_parallel, ctx, ctx_i, sba_ctx, forest_ctx, pg_ctx)
    del forest_ctx, pg_ctx
    rows = run("timing", phase_timing, ctx, launches, errs)
    rows.update(run("timing", phase_timing_implicit, ctx_i, launches_i,
                    errs, k3_per_it))
    run("timing", phase_timing_heads)
    rows.update(run("timing", phase_timing_mvs, ncc_inputs, ncc_launches,
                    ncc_err))
    del ncc_inputs
    rows.update(run("timing", phase_timing_sba, probe_in, gather_launches,
                    gather_errs))
    run("timing", phase_timing_sift)
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
    _log_busy("bench_gsba GSBA", run("profile", phase_profile_gsba,
                                     *gsba_ctx), gsba_ms)
    run("profile", phase_profile_frontend, fe_full)
    del fe_full
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
