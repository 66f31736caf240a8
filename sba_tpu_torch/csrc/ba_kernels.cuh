// Bundle-adjustment LM kernels for Hopper (sm_90a): kernels, launchers and
// the per-model entry points behind the plain C interface of
// ba_kernels.cu.
//
// Hand-written CUDA replacements of the Pallas TPU kernels of
// sba_tpu/ops/ba_kernels.py:
//   K1 sba_fused_schur  <- fused_schur   (_fused_schur_kernel)
//   K2 sba_fused_reduce <- fused_reduce  (_fused_reduce_kernel)
//   K3 sba_schur_matvec <- schur_matvec  (_schur_matvec_kernel)
//   K4 sba_backsub      <- backsub       (_backsub_kernel)
//   K5 sba_fused_cost_buckets <- fused_cost (_cost_kernel)
// The Python wrappers (sba_tpu_torch/ops/ba_kernels.py) check shapes,
// types and devices, allocate every output (zeroed where a kernel
// accumulates; K5 writes its total) and pass PyTorch's current stream.
// Every entry point returns cudaGetLastError() after its launches.
//
// Data layout (the TPU kernel's): per-observation data are [field, lane]
// rows over O = Pp*K lanes, lane c = b*TP*K + s*TP + p_local holding
// slot s of point b*TP + p_local, so thread i of a block reading row f at
// lane c and thread i+1 at lane c+1 read neighbouring words.
//
// Camera heads: all 11 COLMAP models, one template on the model id (the
// analytic heads of sba_tpu's _head). The five kernels of one model are
// instantiated in a translation unit of their own, ba_model<M>.cu
// (SBA_INSTANTIATE_MODEL), so that the build compiles the models in
// parallel; ba_kernels.cu includes this header with
// SBA_BA_DECLARATIONS_ONLY and switches on the model id.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sba {

// K1 and K2 share their arguments; K1 leaves bj, jcorr_bf16 and jcorr
// unused, K2 leaves schur_bf16, Dk, S and ey unused.
struct K1Args {
  int loss, schur_bf16, TP, K, Pp, Npad, C, Dk;
  int bj, jcorr_bf16;
  float a2;
  const float *lam, *par, *free_sta, *pts, *free_pts, *obs_sta;
  const int *obs_img, *obs_cam;
  float *S, *img_red, *ey, *pt_pay, *jw;
  void* jcorr;
};

// K1b's tile table (SchurTiles.table, int32) and scratch, as views.
struct TileArgs {
  int n_groups, n_img_groups, n_units, n_pairs;
  const int2* items;      // [n_items] group pair (a, b), by node pair
  const int2* pair_node;  // [n_pairs] node ids (image n, camera Npad + c)
  const int* grp_off;     // [n_groups + 1] member lanes of each group in
  const int* grp_lane;    //   grp_lane, in slot order
  const int* unit_off;    // [n_units + 1] items of each unit
  const int* unit_pair;   // [n_units] its node pair
  const int* pair_unit;   // [n_pairs + 1] units of each pair
  float* grp;             // [n_groups][k1b_group_words] merged WL blocks
  float* part;            // [n_units][k1b_entries] partial blocks
};

struct K3Args {
  int TP, K, Pp, Npad, C;
  const float *du_pose_t, *du_cam_t;
  const void* jcorr;
  const float* obs_sta;
  const int *obs_img, *obs_cam;
  float* out;
};

struct K4Args {
  int TP, K, Pp, Npad, C;
  const float *lam, *du_pose_t, *du_cam_t, *pt_pay, *jw, *obs_sta;
  const int *obs_img, *obs_cam;
  float *dp, *acc;
};

// K5 takes up to kK5MaxBuckets track-length buckets in one launch
// (ops/ba_kernels.py K5_MAX_BUCKETS, optim/ba_fused.py MAX_BUCKETS); all
// of them read the one parameter table `par`. Its grid has at most
// kK5MaxBlocks blocks; the caller's workspace holds a partial sum for
// each block and then the ticket, kK5WorkWords 4-byte words.
constexpr int kK5MaxBuckets = 3;
constexpr int kK5MaxBlocks = 1024;
constexpr int kK5WorkWords = kK5MaxBlocks + 1;
// The largest parameter table K5 stages in shared memory: the 227 KB
// opt-in less 1 KB for the kernel's static arrays.
constexpr int kK5StageMax = 232448 - 1024;

// Whether K5 stages the parameter table [7+np, Npad] in shared memory
// (it fits kK5StageMax and loads as 16-byte words); else the kernel
// reads it in place. The launcher decides by this, and
// sba_fused_cost_stages reports it.
inline bool k5_stages(int np, int Npad, const float* par) {
  return sizeof(float) * (7 + np) * (size_t)Npad <= (size_t)kK5StageMax &&
         Npad % 4 == 0 && reinterpret_cast<uintptr_t>(par) % 16 == 0;
}

struct K5Bucket {
  int TP, K, Pp;
  const float *pts, *obs_sta;
  const int* obs_img;
  // Set by the launcher: multipliers and shifts that divide a lane
  // number by TP*K and by TP (k5_div).
  unsigned blk_mul, blk_shr, tp_mul, tp_shr;
};

struct K5Args {
  int loss, Npad, n_buckets;
  float a2;
  const float* par;
  K5Bucket b[kK5MaxBuckets];
  float* part;           // the workspace's kK5MaxBlocks partial sums
  unsigned int* ticket;  // its last word: 0 between launches
  float* out;
};

// K1b's block sizes, mirrored by ops/ba_kernels.py (K1B_UNIT_ITEMS,
// k1b_group_words, k1b_entries): items per unit (4 per lane); floats per
// merged group block, a 6x3 or NPx3 block of EL padded to a multiple of 4
// for 16-byte loads; floats per unit partial block, the largest of a 6x6,
// 6xNP or NPxNP node-pair block. kK1bGroupWords and kK1bEntries are the
// sizes while NP <= 6. The asserts are the table the Python test reads.
constexpr int kK1bUnit = 128;
constexpr int kK1bGroupWords = 20;
constexpr int kK1bEntries = 36;
__host__ __device__ constexpr int k1b_group_words(int np) {
  return np > 6 ? (3 * np + 3) / 4 * 4 : kK1bGroupWords;
}
__host__ __device__ constexpr int k1b_entries(int np) {
  return np > 6 ? np * np : kK1bEntries;
}
static_assert(k1b_group_words(3) == 20 && k1b_entries(3) == 36, "K1b");
static_assert(k1b_group_words(4) == 20 && k1b_entries(4) == 36, "K1b");
static_assert(k1b_group_words(5) == 20 && k1b_entries(5) == 36, "K1b");
static_assert(k1b_group_words(8) == 24 && k1b_entries(8) == 64, "K1b");
static_assert(k1b_group_words(12) == 36 && k1b_entries(12) == 144, "K1b");

// K2's payload mode of a parameter count: the 6x6 pose block of EL EL^T
// (BJ) while it fits the reference's 128-padded payload width, else its
// diagonal (ops/ba_kernels.py::plan_layout).
__host__ __device__ constexpr bool k2_block(int np) {
  return 42 + 7 * np + np * np + 27 + 2 * np <=
         (42 + 7 * np + np * np + 127) / 128 * 128;
}

// The entry points of camera model M, defined below and instantiated by
// ba_model<M>.cu.
template <int M>
cudaError_t fused_schur(const K1Args& a, const TileArgs& t, cudaStream_t s);
template <int M>
cudaError_t fused_reduce(const K1Args& a, cudaStream_t s);
template <int M>
cudaError_t schur_matvec(const K3Args& a, int bf16, cudaStream_t s);
template <int M>
cudaError_t backsub(const K4Args& a, cudaStream_t s);
template <int M>
cudaError_t fused_cost(const K5Args& a, cudaStream_t s);

}  // namespace sba

#ifndef SBA_BA_DECLARATIONS_ONLY

namespace sba {
namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in dynamic shared memory

// ---------------------------------------------------------------------------
// Camera heads: projection of normalized (u, v), A2 = d(px,py)/d(u,v) and
// dk[m] = d(px,py)/dk_m, transcribed from sba_tpu/ops/ba_kernels.py::_head
// operation by operation (Python's left-to-right order, no fused
// multiply-adds: -fmad=false), with its guards: r < 1e-8 for the fisheye
// models, r^2 < 1e-4 and omega^2 < 1e-4 (Taylor branches) for FOV.
// ---------------------------------------------------------------------------

template <int M> struct Head;

template <> struct Head<0> {  // SIMPLE_PINHOLE: f, cx, cy
  static constexpr int NP = 3;
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    px = k[0] * u + k[1];
    py = k[0] * v + k[2];
    a[0][0] = k[0]; a[0][1] = 0.f; a[1][0] = 0.f; a[1][1] = k[0];
    dk[0][0] = u;   dk[0][1] = v;
    dk[1][0] = 1.f; dk[1][1] = 0.f;
    dk[2][0] = 0.f; dk[2][1] = 1.f;
  }
};

template <> struct Head<1> {  // PINHOLE: fx, fy, cx, cy
  static constexpr int NP = 4;
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    px = k[0] * u + k[2];
    py = k[1] * v + k[3];
    a[0][0] = k[0]; a[0][1] = 0.f; a[1][0] = 0.f; a[1][1] = k[1];
    dk[0][0] = u;   dk[0][1] = 0.f;
    dk[1][0] = 0.f; dk[1][1] = v;
    dk[2][0] = 1.f; dk[2][1] = 0.f;
    dk[3][0] = 0.f; dk[3][1] = 1.f;
  }
};

template <> struct Head<2> {  // SIMPLE_RADIAL: f, cx, cy, k1
  static constexpr int NP = 4;
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    const float f = k[0], k1 = k[3];
    const float r2 = u * u + v * v;
    const float d = 1.f + k1 * r2;
    px = f * (u * d) + k[1];
    py = f * (v * d) + k[2];
    a[0][0] = f * (d + 2.f * k1 * u * u);
    a[0][1] = f * (2.f * k1 * u * v);
    a[1][0] = a[0][1];
    a[1][1] = f * (d + 2.f * k1 * v * v);
    dk[0][0] = u * d;      dk[0][1] = v * d;
    dk[1][0] = 1.f;        dk[1][1] = 0.f;
    dk[2][0] = 0.f;        dk[2][1] = 1.f;
    dk[3][0] = f * u * r2; dk[3][1] = f * v * r2;
  }
};

// The intrinsics rows shared by the fx, fy, cx, cy models: (xp, 0),
// (0, yp), (1, 0), (0, 1).
__device__ inline void head_f2(float xp, float yp, float dk[][2]) {
  dk[0][0] = xp;  dk[0][1] = 0.f;
  dk[1][0] = 0.f; dk[1][1] = yp;
  dk[2][0] = 1.f; dk[2][1] = 0.f;
  dk[3][0] = 0.f; dk[3][1] = 1.f;
}

template <> struct Head<3> {  // RADIAL: f, cx, cy, k1, k2
  static constexpr int NP = 5;
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    const float f = k[0], k1 = k[3], k2 = k[4];
    const float r2 = u * u + v * v;
    const float d = 1.f + k1 * r2 + k2 * r2 * r2;
    const float dd = 2.f * (k1 + 2.f * k2 * r2);
    px = f * (u * d) + k[1];
    py = f * (v * d) + k[2];
    a[0][0] = f * (d + dd * u * u);
    a[0][1] = f * (dd * u * v);
    a[1][0] = f * (dd * u * v);
    a[1][1] = f * (d + dd * v * v);
    dk[0][0] = u * d;           dk[0][1] = v * d;
    dk[1][0] = 1.f;             dk[1][1] = 0.f;
    dk[2][0] = 0.f;             dk[2][1] = 1.f;
    dk[3][0] = f * u * r2;      dk[3][1] = f * v * r2;
    dk[4][0] = f * u * r2 * r2; dk[4][1] = f * v * r2 * r2;
  }
};

template <> struct Head<4> {  // OPENCV: fx, fy, cx, cy, k1, k2, p1, p2
  static constexpr int NP = 8;
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    const float fx = k[0], fy = k[1], k1 = k[4], k2 = k[5], p1 = k[6],
                p2 = k[7];
    const float u2 = u * u, v2 = v * v, uv = u * v;
    const float r2 = u2 + v2;
    const float r4 = r2 * r2;
    const float radial = k1 * r2 + k2 * r4;
    const float drad = 2.f * (k1 + 2.f * k2 * r2);
    const float xp = u * (1.f + radial) + 2.f * p1 * uv + p2 * (r2 + 2.f * u2);
    const float yp = v * (1.f + radial) + 2.f * p2 * uv + p1 * (r2 + 2.f * v2);
    px = fx * xp + k[2];
    py = fy * yp + k[3];
    const float dxp_du = 1.f + radial + u2 * drad + 2.f * p1 * v + 6.f * p2 * u;
    const float dxy = uv * drad + 2.f * p1 * u + 2.f * p2 * v;
    const float dyp_dv = 1.f + radial + v2 * drad + 2.f * p2 * u + 6.f * p1 * v;
    a[0][0] = fx * dxp_du; a[0][1] = fx * dxy;
    a[1][0] = fy * dxy;    a[1][1] = fy * dyp_dv;
    head_f2(xp, yp, dk);
    dk[4][0] = fx * u * r2;         dk[4][1] = fy * v * r2;
    dk[5][0] = fx * u * r4;         dk[5][1] = fy * v * r4;
    dk[6][0] = fx * 2.f * uv;       dk[6][1] = fy * (r2 + 2.f * v2);
    dk[7][0] = fx * (r2 + 2.f * u2); dk[7][1] = fy * 2.f * uv;
  }
};

template <> struct Head<5> {  // OPENCV_FISHEYE: fx, fy, cx, cy, k1..k4
  static constexpr int NP = 8;
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    const float fx = k[0], fy = k[1], k1 = k[4], k2 = k[5], k3 = k[6],
                k4 = k[7];
    const float u2 = u * u, v2 = v * v, uv = u * v;
    const float r2 = u2 + v2;
    const float r = sqrtf(r2);
    const float safe_r = fmaxf(r, 1e-12f);
    const bool small = r < 1e-8f;
    const float theta = atanf(r);
    const float t2 = theta * theta;
    const float t4 = t2 * t2;
    const float poly = 1.f + k1 * t2 + k2 * t4 + k3 * t4 * t2 + k4 * t4 * t4;
    const float dpoly =
        2.f * k1 + 4.f * k2 * t2 + 6.f * k3 * t4 + 8.f * k4 * t4 * t2;
    const float thetad = theta * poly;
    const float s = small ? 1.f : thetad / safe_r;
    // g = (ds/dr)/r; its limit at r -> 0 is 2 (k1 - 1/3).
    const float dthetad = poly + t2 * dpoly;
    const float g = small ? 2.f * (k1 - 1.f / 3.f)
                          : (dthetad / (1.f + r2) - s) / fmaxf(r2, 1e-24f);
    const float xp = u * s, yp = v * s;
    px = fx * xp + k[2];
    py = fy * yp + k[3];
    a[0][0] = fx * (s + u2 * g); a[0][1] = fx * uv * g;
    a[1][0] = fy * uv * g;       a[1][1] = fy * (s + v2 * g);
    head_f2(xp, yp, dk);
    // d(thetad)/d(k_i) = theta^(2i+1); d(px)/d(k_i) = fx u theta^(2i+1)/r.
    const float t1r = small ? r2 : theta * t2 / safe_r;
    const float rows[4] = {t1r, t1r * t2, t1r * t4, t1r * t4 * t2};
    for (int i = 0; i < 4; ++i) {
      dk[4 + i][0] = fx * u * rows[i];
      dk[4 + i][1] = fy * v * rows[i];
    }
  }
};

template <> struct Head<6> {  // FULL_OPENCV: fx, fy, cx, cy, k1, k2, p1,
  static constexpr int NP = 12;  //            p2, k3, k4, k5, k6
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    const float fx = k[0], fy = k[1], k1 = k[4], k2 = k[5], p1 = k[6],
                p2 = k[7], k3 = k[8], k4 = k[9], k5 = k[10], k6 = k[11];
    const float u2 = u * u, v2 = v * v, uv = u * v;
    const float r2 = u2 + v2;
    const float r4 = r2 * r2;
    const float r6 = r4 * r2;
    const float num = 1.f + k1 * r2 + k2 * r4 + k3 * r6;
    const float den = 1.f + k4 * r2 + k5 * r4 + k6 * r6;
    const float inv_d = 1.f / den;
    const float radial = num * inv_d;
    const float dnum = k1 + 2.f * k2 * r2 + 3.f * k3 * r4;
    const float dden = k4 + 2.f * k5 * r2 + 3.f * k6 * r4;
    const float drad = 2.f * (dnum - radial * dden) * inv_d;
    const float xp = u * radial + 2.f * p1 * uv + p2 * (r2 + 2.f * u2);
    const float yp = v * radial + 2.f * p2 * uv + p1 * (r2 + 2.f * v2);
    px = fx * xp + k[2];
    py = fy * yp + k[3];
    const float dxp_du = radial + u2 * drad + 2.f * p1 * v + 6.f * p2 * u;
    const float dxy = uv * drad + 2.f * p1 * u + 2.f * p2 * v;
    const float dyp_dv = radial + v2 * drad + 2.f * p2 * u + 6.f * p1 * v;
    a[0][0] = fx * dxp_du; a[0][1] = fx * dxy;
    a[1][0] = fy * dxy;    a[1][1] = fy * dyp_dv;
    const float nd2 = radial * inv_d;  // num / den^2
    head_f2(xp, yp, dk);
    dk[4][0] = fx * u * r2 * inv_d;   dk[4][1] = fy * v * r2 * inv_d;
    dk[5][0] = fx * u * r4 * inv_d;   dk[5][1] = fy * v * r4 * inv_d;
    dk[6][0] = fx * 2.f * uv;         dk[6][1] = fy * (r2 + 2.f * v2);
    dk[7][0] = fx * (r2 + 2.f * u2);  dk[7][1] = fy * 2.f * uv;
    dk[8][0] = fx * u * r6 * inv_d;   dk[8][1] = fy * v * r6 * inv_d;
    dk[9][0] = -fx * u * r2 * nd2;    dk[9][1] = -fy * v * r2 * nd2;
    dk[10][0] = -fx * u * r4 * nd2;   dk[10][1] = -fy * v * r4 * nd2;
    dk[11][0] = -fx * u * r6 * nd2;   dk[11][1] = -fy * v * r6 * nd2;
  }
};

template <> struct Head<7> {  // FOV: fx, fy, cx, cy, omega
  static constexpr int NP = 5;
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    const float fx = k[0], fy = k[1], omega = k[4];
    const float u2 = u * u, v2 = v * v, uv = u * v;
    const float r2 = u2 + v2;
    const float r = sqrtf(r2);
    const bool small_r = r2 < 1e-4f;
    const float tanh = tanf(omega * 0.5f);
    const float aa = 2.f * tanh;                // atan argument slope
    const float safe_om = fabsf(omega) > 1e-12f ? omega : 1.f;
    const bool small_om = omega * omega < 1e-4f;
    // s = atan(aa r) / (omega r), with the reference's Taylor branches.
    const float s_main = atanf(aa * r) / (fmaxf(r, 1e-12f) * safe_om);
    const float s_small =
        (-2.f * tanh * (4.f * r2 * tanh * tanh - 3.f)) / (3.f * safe_om);
    const float s_om = omega * omega * r2 / 3.f - omega * omega / 12.f + 1.f;
    const float s = small_om ? s_om : (small_r ? s_small : s_main);
    // g = (ds/dr)/r and d(s)/d(omega). The reference's forms,
    // (aa / (om (1 + aa^2 r^2)) - s) / r^2 and
    // (1 + aa^2/4) / (om (1 + aa^2 r^2)) - s / om, subtract terms that
    // agree to ~(2/3) (aa r)^2 and ~omega^2 / 6 of themselves, and in
    // float32 miss their float64 values by up to 1e-4. They are
    // evaluated in double, from tan(omega / 2) in double (aa's float32
    // rounding alone moves d(s)/d(omega) by 3e-5), g as
    // aa^3 / om (x / (1 + x^2) - atan x) / x^3 with x = aa r, and each
    // rounded once.
    const double td = tan((double)omega * 0.5), ad = 2.0 * td;
    const double x = ad * (double)r;
    const float g_main = (float)(ad * ad * ad / safe_om *
                                 ((x / (1.0 + x * x) - atan(x)) / (x * x * x)));
    const float g_small = -2.f * aa * aa * aa / (3.f * safe_om);
    const float g = small_om ? 2.f * omega * omega / 3.f
                             : (small_r ? g_small : g_main);
    const double sd =
        small_r ? -2.0 * td * (4.0 * r2 * td * td - 3.0) / (3.0 * safe_om)
                : atan(x) / ((double)fmaxf(r, 1e-12f) * safe_om);
    const float dsdo_main =
        (float)((1.0 + 0.25 * ad * ad) /
                    ((double)safe_om * (1.0 + ad * ad * r2)) -
                sd / safe_om);
    const float dsdo =
        small_om ? 2.f * omega * r2 / 3.f - omega / 6.f : dsdo_main;
    const float xp = u * s, yp = v * s;
    px = fx * xp + k[2];
    py = fy * yp + k[3];
    a[0][0] = fx * (s + u2 * g); a[0][1] = fx * uv * g;
    a[1][0] = fy * uv * g;       a[1][1] = fy * (s + v2 * g);
    head_f2(xp, yp, dk);
    dk[4][0] = fx * u * dsdo;    dk[4][1] = fy * v * dsdo;
  }
};

// SIMPLE_RADIAL_FISHEYE (f, cx, cy, k1) and RADIAL_FISHEYE (f, cx, cy,
// k1, k2): one body, k2 = 0 for the first.
template <int NP_>
__device__ inline void head_radial_fisheye(const float* k, float u, float v,
                                           float& px, float& py,
                                           float a[2][2], float dk[NP_][2]) {
  const float f = k[0], k1 = k[3], k2 = NP_ == 5 ? k[4] : 0.f;
  const float u2 = u * u, v2 = v * v, uv = u * v;
  const float r2 = u2 + v2;
  const float r = sqrtf(r2);
  const float safe_r = fmaxf(r, 1e-12f);
  const bool small = r < 1e-8f;
  const float theta = atanf(r);
  const float t2 = theta * theta;
  const float t4 = t2 * t2;
  const float poly = 1.f + k1 * t2 + k2 * t4;
  const float dthetad = 1.f + 3.f * k1 * t2 + 5.f * k2 * t4;
  const float thetad = theta * poly;
  const float s = small ? 1.f : thetad / safe_r;
  const float g = small ? 2.f * (k1 - 1.f / 3.f)
                        : (dthetad / (1.f + r2) - s) / fmaxf(r2, 1e-24f);
  const float xp = u * s, yp = v * s;
  px = f * xp + k[1];
  py = f * yp + k[2];
  a[0][0] = f * (s + u2 * g); a[0][1] = f * uv * g;
  a[1][0] = f * uv * g;       a[1][1] = f * (s + v2 * g);
  const float t1r = small ? r2 : theta * t2 / safe_r;
  dk[0][0] = xp;          dk[0][1] = yp;
  dk[1][0] = 1.f;         dk[1][1] = 0.f;
  dk[2][0] = 0.f;         dk[2][1] = 1.f;
  dk[3][0] = f * u * t1r; dk[3][1] = f * v * t1r;
  if constexpr (NP_ == 5) {
    dk[4][0] = f * u * t1r * t2;
    dk[4][1] = f * v * t1r * t2;
  }
}

template <> struct Head<8> {  // SIMPLE_RADIAL_FISHEYE: f, cx, cy, k1
  static constexpr int NP = 4;
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    head_radial_fisheye<NP>(k, u, v, px, py, a, dk);
  }
};

template <> struct Head<9> {  // RADIAL_FISHEYE: f, cx, cy, k1, k2
  static constexpr int NP = 5;
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    head_radial_fisheye<NP>(k, u, v, px, py, a, dk);
  }
};

template <> struct Head<10> {  // THIN_PRISM_FISHEYE: fx, fy, cx, cy, k1,
  static constexpr int NP = 12;  //   k2, p1, p2, k3, k4, sx1, sy1
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    const float fx = k[0], fy = k[1], k1 = k[4], k2 = k[5], p1 = k[6],
                p2 = k[7], k3 = k[8], k4 = k[9], sx1 = k[10], sy1 = k[11];
    const float r2 = u * u + v * v;
    const float r = sqrtf(r2);
    const float safe_r = fmaxf(r, 1e-12f);
    const bool small = r < 1e-8f;
    const float theta = atanf(r);
    const float s = small ? 1.f : theta / safe_r;  // equidistant pre-map
    const float gs = small ? -2.f / 3.f              // (ds/dr)/r
                           : (1.f / (1.f + r2) - s) / fmaxf(r2, 1e-24f);
    const float up = u * s, vp = v * s;
    const float j00 = s + u * u * gs;  // the pre-map's Jacobian
    const float j01 = u * v * gs;
    const float j11 = s + v * v * gs;
    // The thin-prism distortion of (up, vp) and its Jacobian.
    const float q2 = up * up + vp * vp;
    const float q4 = q2 * q2;
    const float q6 = q4 * q2;
    const float q8 = q6 * q2;
    const float uvp = up * vp;
    const float radial = k1 * q2 + k2 * q4 + k3 * q6 + k4 * q8;
    const float drad =
        2.f * (k1 + 2.f * k2 * q2 + 3.f * k3 * q4 + 4.f * k4 * q6);
    const float xp = up * (1.f + radial) + 2.f * p1 * uvp +
                     p2 * (q2 + 2.f * up * up) + sx1 * q2;
    const float yp = vp * (1.f + radial) + 2.f * p2 * uvp +
                     p1 * (q2 + 2.f * vp * vp) + sy1 * q2;
    px = fx * xp + k[2];
    py = fy * yp + k[3];
    const float b00 = 1.f + radial + up * up * drad + 2.f * p1 * vp +
                      6.f * p2 * up + 2.f * sx1 * up;
    const float b01 =
        uvp * drad + 2.f * p1 * up + 2.f * p2 * vp + 2.f * sx1 * vp;
    const float b10 =
        uvp * drad + 2.f * p2 * vp + 2.f * p1 * up + 2.f * sy1 * up;
    const float b11 = 1.f + radial + vp * vp * drad + 2.f * p2 * up +
                      6.f * p1 * vp + 2.f * sy1 * vp;
    a[0][0] = fx * (b00 * j00 + b01 * j01);
    a[0][1] = fx * (b00 * j01 + b01 * j11);
    a[1][0] = fy * (b10 * j00 + b11 * j01);
    a[1][1] = fy * (b10 * j01 + b11 * j11);
    head_f2(xp, yp, dk);
    dk[4][0] = fx * up * q2;             dk[4][1] = fy * vp * q2;
    dk[5][0] = fx * up * q4;             dk[5][1] = fy * vp * q4;
    dk[6][0] = fx * 2.f * uvp;           dk[6][1] = fy * (q2 + 2.f * vp * vp);
    dk[7][0] = fx * (q2 + 2.f * up * up); dk[7][1] = fy * 2.f * uvp;
    dk[8][0] = fx * up * q6;             dk[8][1] = fy * vp * q6;
    dk[9][0] = fx * up * q8;             dk[9][1] = fy * vp * q8;
    dk[10][0] = fx * q2;                 dk[10][1] = 0.f;
    dk[11][0] = 0.f;                     dk[11][1] = fy * q2;
  }
};

// The projection alone (K5): the head's px, py; the compiler drops the
// derivatives.
template <int M>
__device__ inline void head_project(const float* k, float u, float v,
                                    float& px, float& py) {
  float a[2][2], dk[Head<M>::NP][2];
  Head<M>::eval(k, u, v, px, py, a, dk);
}

// ---------------------------------------------------------------------------
// Robust losses (ids as sba_tpu_torch.optim.losses.LOSS_IDS).
// ---------------------------------------------------------------------------

__device__ inline float loss_value(int id, float s, float a2) {
  switch (id) {
    case 1: {  // huber
      const float a = sqrtf(a2), r = sqrtf(fmaxf(s, 1e-20f));
      return s <= a2 ? s : 2.f * a * r - a2;
    }
    case 2: return 2.f * a2 * (sqrtf(1.f + s / a2) - 1.f);  // soft_l1
    case 3: return a2 * log1pf(s / a2);                      // cauchy
    default: return s;                                       // trivial
  }
}

__device__ inline float loss_weight(int id, float s, float a2) {
  switch (id) {
    case 1: {
      const float a = sqrtf(a2), r = sqrtf(fmaxf(s, 1e-20f));
      return s <= a2 ? 1.f : a / r;
    }
    case 2: return 1.f / sqrtf(1.f + s / a2);
    case 3: return 1.f / (1.f + s / a2);
    default: return 1.f;
  }
}

__device__ inline float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Pose of image n from par [7+np, Npad]: rotation of the normalized
// quaternion and translation.
__device__ inline void load_pose(const float* par, int Npad, int n,
                                 float R[3][3], float t[3]) {
  const float qw = par[n], qx = par[Npad + n], qy = par[2 * Npad + n],
              qz = par[3 * Npad + n];
  const float s = rsqrtf(qw * qw + qx * qx + qy * qy + qz * qz + 1e-30f);
  const float w = qw * s, x = qx * s, y = qy * s, z = qz * s;
  R[0][0] = 1.f - 2.f * (y * y + z * z);
  R[0][1] = 2.f * (x * y - w * z);
  R[0][2] = 2.f * (x * z + w * y);
  R[1][0] = 2.f * (x * y + w * z);
  R[1][1] = 1.f - 2.f * (x * x + z * z);
  R[1][2] = 2.f * (y * z - w * x);
  R[2][0] = 2.f * (x * z - w * y);
  R[2][1] = 2.f * (y * z + w * x);
  R[2][2] = 1.f - 2.f * (x * x + y * y);
  for (int i = 0; i < 3; ++i) t[i] = par[(4 + i) * Npad + n];
}

// Normalized coordinates of point x in the camera; returns 1/z.
__device__ inline float camera_uv(const float R[3][3], const float t[3],
                                  const float x[3], float& u, float& v) {
  float pc[3];
  for (int i = 0; i < 3; ++i)
    pc[i] = R[i][0] * x[0] + R[i][1] * x[1] + R[i][2] * x[2] + t[i];
  const float z = pc[2];
  const float iz = 1.f / (fabsf(z) > 1e-12f ? z : 1e-12f);
  u = clampf(pc[0] * iz, -1e6f, 1e6f);
  v = clampf(pc[1] * iz, -1e6f, 1e6f);
  return iz;
}

// Residual, robust weight and masked, whitened Jacobian rows of one
// observation: Jc rows kk*6+i (rotation then translation), Jx kk*3+j,
// Jk kk*NP+m (sba_tpu/ops/ba_kernels.py::_linearize_block).
template <int M>
__device__ void linearize(const float* par, const float* free_sta, int Npad,
                          int n, const float x[3], float fp, float ox,
                          float oy, float mask, int loss, float a2,
                          float r[2], float Jc[12], float Jx[6],
                          float Jk[2 * Head<M>::NP]) {
  constexpr int NP = Head<M>::NP;
  float R[3][3], t[3], k[NP];
  load_pose(par, Npad, n, R, t);
  for (int m = 0; m < NP; ++m) k[m] = par[(7 + m) * Npad + n];
  float u, v;
  const float iz = camera_uv(R, t, x, u, v);
  float px, py, A2[2][2], dk[NP][2];
  Head<M>::eval(k, u, v, px, py, A2, dk);
  const float r0 = px - ox, r1 = py - oy;
  const float w = mask * loss_weight(loss, r0 * r0 + r1 * r1, a2);
  const float sw = sqrtf(w);
  r[0] = r0 * sw;
  r[1] = r1 * sw;
  const float rot_m = free_sta[n] * sw;
  const float px_m = fp * sw;
  for (int kk = 0; kk < 2; ++kk) {
    const float A[3] = {A2[kk][0] * iz, A2[kk][1] * iz,
                        -(A2[kk][0] * u + A2[kk][1] * v) * iz};
    float J[3];
    for (int j = 0; j < 3; ++j)
      J[j] = A[0] * R[0][j] + A[1] * R[1][j] + A[2] * R[2][j];
    Jc[kk * 6 + 0] = (J[2] * x[1] - J[1] * x[2]) * rot_m;
    Jc[kk * 6 + 1] = (J[0] * x[2] - J[2] * x[0]) * rot_m;
    Jc[kk * 6 + 2] = (J[1] * x[0] - J[0] * x[1]) * rot_m;
    for (int i = 0; i < 3; ++i)
      Jc[kk * 6 + 3 + i] = A[i] * (free_sta[(1 + i) * Npad + n] * sw);
    for (int j = 0; j < 3; ++j) Jx[kk * 3 + j] = J[j] * px_m;
    for (int m = 0; m < NP; ++m)
      Jk[kk * NP + m] = dk[m][kk] * free_sta[(4 + m) * Npad + n] * sw;
  }
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of NV values, added atomically to out[0..NV). Every
// thread of the block must call it; blockDim.x * blockDim.y is a multiple
// of 32.
template <int NV>
__device__ void block_atomic_add(float (&v)[NV], float* out) {
  __shared__ float part[NV][32];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int nwarps = (blockDim.x * blockDim.y + 31) >> 5;
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0)
    for (int i = 0; i < NV; ++i) part[i][wid] = v[i];
  __syncthreads();
  if (wid == 0) {
    for (int i = 0; i < NV; ++i) {
      const float x = warp_sum(lane < nwarps ? part[i][lane] : 0.f);
      if (lane == 0) atomicAdd(out + i, x);
    }
  }
}


__device__ inline float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Sum v over the lanes of `peers` (the lanes of this warp with this
// lane's key) by a shuffle tree; the lowest lane of each group ends with
// its group's sum. Every lane of the warp must call it.
template <int N>
__device__ inline void peer_sum(unsigned peers, float (&v)[N]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);   // peers above this lane
  while (__any_sync(0xffffffffu, rest != 0u)) {
    const int next = __ffs(rest);                  // 1-based; 0: none
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float o = __shfl_sync(0xffffffffu, v[i], (next - 1) & 31);
      if (next) v[i] += o;
    }
    // Odd ranks were just added into their lower neighbour: drop them.
    rest &= __ballot_sync(0xffffffffu, (rank & 1) == 0);
    rank >>= 1;
  }
}

// ---------------------------------------------------------------------------
// K1a / K2: linearize + reduce, one thread per observation lane.
//
// K1a replaces the linearize/reduce half of fused_schur
// (_linearize_and_reduce): per observation the residual and analytic
// Jacobians; per point g_p, Hpp, the damped Hpp^-1 and its Cholesky Lp;
// the whitened couplings WL = (Ju^T Jx) Lp; per image the g/H payload
// and Ey = EL (Lp^T g_p). On the TPU the per-image reductions are
// one-hot MXU contractions.
//
// With a K2 mode (replacing fused_reduce / _fused_reduce_kernel) the
// same body writes no Ey vector: each live observation adds its Ey rows
// (ey_pose 6, ey_cam NP) and its share of the PCG preconditioner (the
// 6x6 pose block of WL WL^T as 21 upper-triangle rows when bj, else its
// 6 diagonal entries, then the NP camera diagonal entries) to the image
// payload row of its image, behind the dense payload columns; the
// epilogue sums the camera rows by camera. With jcorr_bf16 it also
// stores the couplings once more as the bf16 `jcorr` (WLp 18 rows, WLc
// 3*NP rows, rounded to nearest even) for the matvec K3; in f32 K3 reads
// them from jw's WL rows, so nothing is stored twice.
//
// Bound: device memory, one write of jw (and of K2's bf16 jcorr) and one
// read of the observation rows; the arithmetic per byte is low. A first
// design (one thread per point, a float atomic per lane and payload
// column) took 29-98x that bound: the 32 lanes of a warp mostly share
// one image on a sorted sequential scene, so its 72-105 atomics per lane
// serialised in L2. This design:
//
// - One thread per observation lane. A block covers kK12Points points of
//   one point block (threadIdx.x) and min(K, kK12Slots) slots
//   (threadIdx.y), so a warp reads 32 neighbouring lanes of one row. A
//   thread keeps its lane's Jacobians in registers; the slots' shares of
//   g_p and Hpp are summed per point through shared memory (in slot
//   order), one thread per point inverts Hpp and shares Lp and
//   y = Lp^T g_p, and each lane whitens its own couplings. With
//   K > kK12Slots the block walks the slots in passes and linearizes the
//   earlier passes' lanes again when it needs their Jacobians.
// - The image payload is privatised, as K3's scatter: the block takes
//   the image window [lo, hi] of its live lanes and sums its payload rows
//   (and K1's Ey rows, keyed by image) into shared memory over chunks of
//   kK12Window images; lanes of a warp that share an image are first
//   summed by a shuffle tree (__match_any_sync), one shared atomic per
//   group and column remains. Each chunk then adds its nonzero (image,
//   column) entries to img_red with one global atomic per block; K1's
//   Ey camera rows are first summed over the chunk's images of one camera
//   within a warp. A window wider than a chunk takes more chunks of the
//   same loop (each walks the passes again); every input takes this path.
// The float atomics still sum in no fixed order (the twins' tolerances).
// ---------------------------------------------------------------------------

// kK12Points, kK12Slots and kK12Window are mirrored by ops/ba_kernels.py
// (K12_POINTS_PER_BLOCK, K12_SLOTS, K12_WINDOW), whose
// fused_reduce_windows reports the blocks' windows.
constexpr int kK12Points = 64;   // points per block (threadIdx.x)
constexpr int kK12Slots = 8;     // slots per pass (threadIdx.y)
constexpr int kK12Window = 128;  // images per shared-memory window chunk

// Payload modes: K1 (dense payload and Ey), K2 with the pose diagonal
// of EL EL^T, K2 with its 6x6 upper triangle (bj).
enum { kModeSchur = 0, kModeDiag = 1, kModeBlock = 2 };

// A lane's payload in shared memory: img_red's columns with the
// symmetric Hcc_pose and Hcc_cam blocks by their upper triangles
// (k12_dest maps them back), then Ey pose and camera rows (K1: to ey;
// K2: img_red's) and K2's Jacobi columns.
template <int NP, int Mode>
struct K12Cols {
  static constexpr int DI = 42 + 7 * NP + NP * NP;   // img_red's dense part
  static constexpr int DC = 27 + 7 * NP + NP * (NP + 1) / 2;  // compact
  static constexpr int Tail = Mode == kModeSchur ? 0
                            : NP + (Mode == kModeBlock ? 21 : 6);
  static constexpr int N = DC + 6 + NP + Tail;       // shared columns
  static constexpr int Out = DI + 6 + NP + Tail;     // K2's img_red width
  static constexpr int Stride = N | 1;  // odd: images on distinct banks
  static constexpr int Window = kK12Window * Stride;
  static constexpr int Stage = kK12Points * kK12Slots * (32 + 1);
  static constexpr int Words =          // payload window + staging, or s_part
      Window + Stage > kK12Slots * 9 * kK12Points
          ? Window + Stage : kK12Slots * 9 * kK12Points;
  static constexpr size_t Smem =
      Words * 4 + (Mode == kModeSchur ? kK12Window * 4 : 0);
};

// (i, j), i <= j, of entry t of an n x n upper triangle, row-major.
__host__ __device__ constexpr void k12_tri(int t, int n, int& i, int& j) {
  i = 0;
  while (t >= n - i) t -= n - i++;
  j = i + t;
}

// Stage shared columns [c0, c0 + 32) of one lane at st[0..32), products
// in the twins' order. c0 is a compile-time constant once unrolled, and
// so is every column index: all loops unroll and the out-of-range
// columns fold away.
template <int NP, int Mode>
__device__ inline void k12_stage(int c0, float* st, const float (&r)[2],
                                 const float (&Jc)[12],
                                 const float (&Jk)[2 * NP],
                                 const float (&WL)[6 + NP][3],
                                 const float (&y)[3]) {
  int c = -c0;
  auto put = [&](float v) {
    if (c >= 0 && c < 32) st[c] = v;
    ++c;
  };
#pragma unroll
  for (int i = 0; i < 6; ++i) put(Jc[i] * r[0] + Jc[6 + i] * r[1]);
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) put(Jc[i] * Jc[j] + Jc[6 + i] * Jc[6 + j]);
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int m = 0; m < NP; ++m)
      put(Jc[i] * Jk[m] + Jc[6 + i] * Jk[NP + m]);
#pragma unroll
  for (int m = 0; m < NP; ++m) put(Jk[m] * r[0] + Jk[NP + m] * r[1]);
#pragma unroll
  for (int m = 0; m < NP; ++m)
#pragma unroll
    for (int m2 = m; m2 < NP; ++m2)
      put(Jk[m] * Jk[m2] + Jk[NP + m] * Jk[NP + m2]);
#pragma unroll
  for (int i = 0; i < 6 + NP; ++i) put(dot3(WL[i], y));      // Ey rows
  if constexpr (Mode == kModeBlock) {
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j) put(dot3(WL[i], WL[j]));
  } else if constexpr (Mode == kModeDiag) {
#pragma unroll
    for (int i = 0; i < 6; ++i) put(dot3(WL[i], WL[i]));
  }
  if constexpr (Mode != kModeSchur) {
#pragma unroll
    for (int m = 6; m < 6 + NP; ++m) put(dot3(WL[m], WL[m]));  // camera diag
  }
}

// img_red column(s) of shared column c < DC, or DI + (c - DC) beyond it;
// d2 is the mirror of an off-diagonal symmetric entry, else -1.
template <int NP>
__device__ inline void k12_dest(int c, int& d1, int& d2) {
  constexpr int DC = K12Cols<NP, kModeSchur>::DC;
  int i, j;
  d2 = -1;
  if (c < 6) {
    d1 = c;
  } else if (c < 27) {
    k12_tri(c - 6, 6, i, j);
    d1 = 6 + 6 * i + j;
    if (i != j) d2 = 6 + 6 * j + i;
  } else if (c < 27 + 7 * NP) {
    d1 = c + 15;                      // Hpc, g_cam: 42 + (c - 27)
  } else if (c < DC) {
    k12_tri(c - 27 - 7 * NP, NP, i, j);
    d1 = 42 + 7 * NP + NP * i + j;
    if (i != j) d2 = 42 + 7 * NP + NP * j + i;
  } else {
    d1 = 42 + 7 * NP + NP * NP + c - DC;
  }
}

// Lane c linearized (all zero when !ok); returns whether it is live.
template <int M>
__device__ inline bool k12_lane(const K1Args& a, int64_t O, int64_t c,
                                bool ok, const float x[3], float fp,
                                int& img, int& cam, float r[2], float Jc[12],
                                float Jx[6], float Jk[2 * Head<M>::NP]) {
  constexpr int NP = Head<M>::NP;
  if (!ok) {
    img = cam = 0;
    r[0] = r[1] = 0.f;
    for (int i = 0; i < 12; ++i) Jc[i] = 0.f;
    for (int i = 0; i < 6; ++i) Jx[i] = 0.f;
    for (int i = 0; i < 2 * NP; ++i) Jk[i] = 0.f;
    return false;
  }
  img = a.obs_img[c];
  cam = a.obs_cam[c];
  const float mask = a.obs_sta[2 * O + c];
  linearize<M>(a.par, a.free_sta, a.Npad, img, x, fp, a.obs_sta[c],
               a.obs_sta[O + c], mask, a.loss, a.a2, r, Jc, Jx, Jk);
  return mask != 0.f;
}

template <int M, int Mode>
__global__ void __launch_bounds__(kK12Points * kK12Slots)
k12_reduce_kernel(K1Args a) {
  constexpr int NP = Head<M>::NP;
  using Cols = K12Cols<NP, Mode>;
  constexpr int DC = Cols::DC, NC = Cols::N, SS = Cols::Stride;
  constexpr int kJk = 18, kWLp = 18 + 2 * NP, kWLc = 36 + 2 * NP;
  extern __shared__ float smem[];
  float* s_part = smem;   // pass 1: [kK12Slots][9][kK12Points]
  float* s_pay = smem;    // window chunks: [kK12Window][SS]
  int* s_cam = reinterpret_cast<int*>(smem + Cols::Words);  // K1
  __shared__ float s_pt[9][kK12Points];  // Lp (6) and y (3) per point
  __shared__ int s_lo, s_hi;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ns = blockDim.y;                        // slots per pass
  const int passes = (a.K + ns - 1) / ns;
  const int groups = (a.TP + kK12Points - 1) / kK12Points;
  const int b = blockIdx.x / groups;
  const int p = (blockIdx.x - b * groups) * kK12Points + tx;
  const bool pt_ok = p < a.TP;
  const int pt = b * a.TP + p;
  const int64_t O = (int64_t)a.Pp * a.K;
  const int64_t lane0 = (int64_t)b * a.TP * a.K + p;   // slot 0's lane
  const int tid = ty * kK12Points + tx, nt = kK12Points * ns;
  const int wl = tid & 31;
  // This warp's staging rows: [32 lanes][32 columns + 1].
  float* s_stage = smem + Cols::Window + (tid >> 5) * 32 * 33;
  const float x[3] = {pt_ok ? a.pts[pt] : 0.f,
                      pt_ok ? a.pts[a.Pp + pt] : 0.f,
                      pt_ok ? a.pts[2 * a.Pp + pt] : 0.f};
  const float fp = pt_ok ? a.free_pts[pt] : 0.f;
  if (tid == 0) {
    s_lo = 0x7fffffff;
    s_hi = -1;
  }

  // Pass 1: linearize every lane, store its Jacobian rows, sum g_p and
  // Hpp over the slots (in slot order); the live lanes' image window.
  float r[2], Jc[12], Jx[6], Jk[2 * NP];
  int img = 0, cam = 0, held = 0, lo = 0x7fffffff, hi = -1;
  bool live = false;
  float acc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int q = 0; q < passes; ++q) {
    const int s = q * ns + ty;
    const int64_t c = lane0 + (int64_t)s * a.TP;
    const bool ok = pt_ok && s < a.K;
    live = k12_lane<M>(a, O, c, ok, x, fp, img, cam, r, Jc, Jx, Jk);
    held = q;
    if (ok) {
      for (int i = 0; i < 12; ++i) a.jw[i * O + c] = Jc[i];
      for (int i = 0; i < 6; ++i) a.jw[(12 + i) * O + c] = Jx[i];
      for (int i = 0; i < 2 * NP; ++i) a.jw[(kJk + i) * O + c] = Jk[i];
    }
    if (live) {
      lo = min(lo, img);
      hi = max(hi, img);
    }
    const float v[9] = {
        Jx[0] * r[0] + Jx[3] * r[1], Jx[1] * r[0] + Jx[4] * r[1],
        Jx[2] * r[0] + Jx[5] * r[1],
        Jx[0] * Jx[0] + Jx[3] * Jx[3], Jx[0] * Jx[1] + Jx[3] * Jx[4],
        Jx[0] * Jx[2] + Jx[3] * Jx[5], Jx[1] * Jx[1] + Jx[4] * Jx[4],
        Jx[1] * Jx[2] + Jx[4] * Jx[5], Jx[2] * Jx[2] + Jx[5] * Jx[5]};
#pragma unroll
    for (int j = 0; j < 9; ++j) s_part[(ty * 9 + j) * kK12Points + tx] = v[j];
    __syncthreads();
    if (ty == 0)
      for (int t = 0; t < ns; ++t)
#pragma unroll
        for (int j = 0; j < 9; ++j)
          acc[j] += s_part[(t * 9 + j) * kK12Points + tx];
    __syncthreads();
  }

  // ---- per-point payload: damped Hpp^-1 and its Cholesky factor ----
  if (ty == 0) {
    const float* g = acc;
    const float* H = acc + 3;
    const float lam = *a.lam;
    const float hd[3] = {H[0], H[3], H[5]};
    float d_l[3];
    for (int j = 0; j < 3; ++j) d_l[j] = lam * clampf(hd[j], 1e-6f, 1e32f);
    // The damped inverse in double, rounded once: a point seen once has
    // a rank-2 Hpp, and its float32 inverse cancels by up to 1/lambda.
    // Lp is the Cholesky factor of the stored (float) inverse.
    const double A = H[0] + d_l[0] + 1e-12f, B = H[1], Cc = H[2];
    const double D = H[3] + d_l[1] + 1e-12f, E = H[4];
    const double F = H[5] + d_l[2] + 1e-12f;
    const double co00 = D * F - E * E, co01 = Cc * E - B * F,
                 co02 = B * E - Cc * D, co11 = A * F - Cc * Cc,
                 co12 = B * Cc - A * E, co22 = A * D - B * B;
    const double det = A * co00 + B * co01 + Cc * co02;
    const double inv_det = 1.0 / (fabs(det) > 1e-12 ? det : 1e-12);
    const float hi6[6] = {
        (float)(co00 * inv_det), (float)(co01 * inv_det),
        (float)(co02 * inv_det), (float)(co11 * inv_det),
        (float)(co12 * inv_det), (float)(co22 * inv_det)};
    float L[6];  // l00, l10, l20, l11, l21, l22
    L[0] = sqrtf(fmaxf(hi6[0], 1e-20f));
    L[1] = hi6[1] / L[0];
    L[2] = hi6[2] / L[0];
    L[3] = sqrtf(fmaxf(hi6[3] - L[1] * L[1], 1e-20f));
    L[4] = (hi6[4] - L[2] * L[1]) / L[3];
    L[5] = sqrtf(fmaxf(hi6[5] - L[2] * L[2] - L[4] * L[4], 1e-20f));
    if (pt_ok) {
      float* pp = a.pt_pay + pt;
      for (int j = 0; j < 3; ++j) pp[j * a.Pp] = g[j];
      for (int j = 0; j < 3; ++j) pp[(3 + j) * a.Pp] = hd[j];
      for (int j = 0; j < 6; ++j) pp[(6 + j) * a.Pp] = hi6[j];
      for (int j = 0; j < 6; ++j) pp[(12 + j) * a.Pp] = L[j];
      pp[18 * a.Pp] = fp;
    }
    for (int j = 0; j < 6; ++j) s_pt[j][tx] = L[j];
    s_pt[6][tx] = L[0] * g[0] + L[1] * g[1] + L[2] * g[2];
    s_pt[7][tx] = L[3] * g[1] + L[4] * g[2];
    s_pt[8][tx] = L[5] * g[2];
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (wl == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  float L[6], y[3];
#pragma unroll
  for (int j = 0; j < 6; ++j) L[j] = s_pt[j][tx];
#pragma unroll
  for (int j = 0; j < 3; ++j) y[j] = s_pt[6 + j][tx];
  const int bhi = s_hi, blo = s_lo <= bhi ? s_lo : 0;
  const int chunks = bhi >= blo ? (bhi - blo) / kK12Window + 1 : 1;

  // Pass 2, per window chunk: the whitened couplings (stored in the
  // first chunk) and the payload rows of the chunk's images.
  __nv_bfloat16* jc16 = static_cast<__nv_bfloat16*>(a.jcorr);
  for (int ch = 0; ch < chunks; ++ch) {
    const int w0 = blo + ch * kK12Window;
    const int width = max(0, min(kK12Window, bhi - w0 + 1));
    for (int i = tid; i < width * SS; i += nt) s_pay[i] = 0.f;
    if constexpr (Mode == kModeSchur)
      for (int i = tid; i < width; i += nt) s_cam[i] = -1;
    __syncthreads();
    for (int k = 0, first = held; k < passes; ++k) {
      const int q = (first + k) % passes;
      const int s = q * ns + ty;
      const int64_t c = lane0 + (int64_t)s * a.TP;
      const bool ok = pt_ok && s < a.K;
      if (q != held) {                // only with K > kK12Slots
        live = k12_lane<M>(a, O, c, ok, x, fp, img, cam, r, Jc, Jx, Jk);
        held = q;
      }
      float WL[6 + NP][3];  // rows i: WLp (i < 6), then WLc; 0 if masked
#pragma unroll
      for (int i = 0; i < 6 + NP; ++i) {
        float W[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          W[j] = !live ? 0.f
                 : i < 6 ? Jc[i] * Jx[j] + Jc[6 + i] * Jx[3 + j]
                         : Jk[i - 6] * Jx[j] + Jk[NP + i - 6] * Jx[3 + j];
        WL[i][0] = W[0] * L[0] + W[1] * L[1] + W[2] * L[2];
        WL[i][1] = W[1] * L[3] + W[2] * L[4];
        WL[i][2] = W[2] * L[5];
      }
      if (ch == 0 && ok) {
#pragma unroll
        for (int i = 0; i < 6 + NP; ++i) {
          const int row0 = i < 6 ? kWLp + i * 3 : kWLc + (i - 6) * 3;
#pragma unroll
          for (int j = 0; j < 3; ++j) a.jw[(row0 + j) * O + c] = WL[i][j];
        }
        if (Mode != kModeSchur && a.jcorr_bf16) {
#pragma unroll
          for (int rr = 0; rr < 3 * (6 + NP); ++rr)
            jc16[rr * O + c] = __float2bfloat16_rn(WL[rr / 3][rr % 3]);
        }
      }
      // The payload of the warp's lanes in this chunk, 32 columns at a
      // time: each lane stages its values, then lane j sums column j
      // over each group of lanes that share an image (in lane order) and
      // adds the sum to the group's shared row.
      const bool in = live && img >= w0 && img < w0 + width;
      const unsigned inmask = __ballot_sync(0xffffffffu, in);
      if (inmask == 0u) continue;     // warp-uniform
      const unsigned peers =
          __match_any_sync(0xffffffffu, in ? img : -1 - wl);
      if (Mode == kModeSchur && in) s_cam[img - w0] = cam;
#pragma unroll
      for (int c0 = 0; c0 < NC; c0 += 32) {
        k12_stage<NP, Mode>(c0, s_stage + wl * 33, r, Jc, Jk, WL, y);
        __syncwarp();
        for (unsigned rest = inmask; rest != 0u;) {
          const int l = __ffs(rest) - 1;
          const unsigned grp = __shfl_sync(0xffffffffu, peers, l);
          const int gimg = __shfl_sync(0xffffffffu, img, l);
          // Four partial sums shorten the chain of dependent adds; a
          // warp-wide group takes fixed offsets, a lone lane one load.
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          if (grp == 0xffffffffu) {
#pragma unroll
            for (int m = 0; m < 32; ++m) part[m & 3] += s_stage[m * 33 + wl];
          } else if ((grp & (grp - 1u)) == 0u) {
            part[0] = s_stage[l * 33 + wl];
          } else {
            for (unsigned mm = grp; mm != 0u;) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                if (mm != 0u) {
                  part[k] += s_stage[(__ffs(mm) - 1) * 33 + wl];
                  mm &= mm - 1u;
                }
              }
            }
          }
          const float sum = (part[0] + part[1]) + (part[2] + part[3]);
          if (c0 + wl < NC) atomicAdd(s_pay + (gimg - w0) * SS + c0 + wl, sum);
          rest &= ~grp;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // One global atomic per nonzero (image, img_red column) of the
    // chunk: K2's whole row to img_red; K1's dense columns to img_red,
    // its Ey pose columns to ey, its Ey camera columns (below) by camera.
    constexpr int NF = Mode == kModeSchur ? DC + 6 : NC;
    constexpr int OUT = Mode == kModeSchur ? Cols::DI : Cols::Out;
    for (int i = tid; i < width * NF; i += nt) {
      const int n = i / NF, col = i - n * NF;
      const float v = s_pay[n * SS + col];
      if (v == 0.f) continue;
      if (Mode == kModeSchur && col >= DC) {
        atomicAdd(a.ey + (int64_t)(col - DC) * a.Npad + w0 + n, v);
        continue;
      }
      int d1, d2;
      k12_dest<NP>(col, d1, d2);
      float* row = a.img_red + (int64_t)(w0 + n) * OUT;
      atomicAdd(row + d1, v);
      if (d2 >= 0) atomicAdd(row + d2, v);
    }
    if constexpr (Mode == kModeSchur) {
      for (int n0 = tid - wl; n0 < width; n0 += nt) {
        const int n = n0 + wl;
        const int key = n < width ? s_cam[n] : -1;
        float v[NP];
#pragma unroll
        for (int m = 0; m < NP; ++m)
          v[m] = key >= 0 ? s_pay[n * SS + DC + 6 + m] : 0.f;
        const unsigned peers =
            __match_any_sync(0xffffffffu, key >= 0 ? key : -1 - wl);
        peer_sum<NP>(peers, v);
        if (key >= 0 && wl == __ffs(peers) - 1) {
#pragma unroll
          for (int m = 0; m < NP; ++m)
            if (v[m] != 0.f)
              atomicAdd(a.ey + 6LL * a.Npad + (int64_t)m * a.C + key, v[m]);
        }
      }
    }
    __syncthreads();                  // before the next chunk's zeroing
  }
}

template <int M, int Mode>
cudaError_t launch_k12(const K1Args& a, cudaStream_t stream) {
  constexpr size_t smem = K12Cols<Head<M>::NP, Mode>::Smem;
  static_assert(smem + sizeof(float) * 9 * kK12Points + 8 <= kMaxSmem,
                "k12_reduce_kernel's shared memory exceeds the opt-in limit");
  if (a.TP <= 0 || a.K <= 0 || a.Pp % a.TP != 0)
    return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        k12_reduce_kernel<M, Mode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const int groups = (a.TP + kK12Points - 1) / kK12Points;
  const dim3 block(kK12Points, a.K < kK12Slots ? a.K : kK12Slots);
  const int blocks = a.Pp / a.TP * groups;
  if (blocks == 0) return cudaSuccess;
  k12_reduce_kernel<M, Mode><<<blocks, block, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1b: Schur correction S_corr = EL EL^T, owner-computed tiles.
//
// Replaces the ELb construction + MXU product of _fused_schur_kernel. A
// point's column block of EL has one 6x3 block per distinct observing
// image and one NPx3 block per distinct camera (its nodes): the WL blocks
// of its slots that share the node, summed and, when schur_bf16, rounded
// to bf16 (as the TPU kernel rounds ELb). S's block of a node pair
// (a, b) is the sum over the points that see both of their blocks'
// products. The sparsity is fixed for a solve, so `build_schur_tiles`
// (ops/ba_kernels.py) lists, once per solve, the work items of every
// node pair a <= b (one per point that sees both) and cuts each list
// into units of at most kK1bUnit items. Three launches:
//
// - k1b_group_kernel, one thread per (point, node) group: sums the
//   group's WL rows from jw (in slot order), rounds them, and stores the
//   block (k1b_group_words(NP) floats, 16-byte aligned) in the scratch
//   `grp`.
// - k1b_unit_kernel, one warp per unit: each lane accumulates the node
//   pair's block (6x6, 6xNP or NPxNP; the upper triangle when a == b)
//   over its items in registers, the warp sums it through shared memory
//   and stores the unit's partial block (k1b_entries(NP) floats) in the
//   scratch `part`. The shared buffer takes one row per lane of the
//   largest block, so a block holds fewer warps as NP grows (k1b_warps).
// - k1b_pair_kernel, one thread per (entry, node pair): sums the pair's
//   partial blocks in unit order and stores the entry and its mirror in
//   S with plain stores.
//
// S gets no atomics: it is exactly symmetric and the same from run to
// run. A first design (one warp per point, a float atomic into S per
// entry of the point's (6 ni + NP nc)^2 outer product: 66.9M per LM
// iteration at the headline, every point onto the same camera rows)
// took ~98x K1's bound. Bound of this part: the L2-resident reads of two
// group blocks per item; the arithmetic is ~100 flops per item.
// ---------------------------------------------------------------------------



template <int NP>
__global__ void __launch_bounds__(256) k1b_group_kernel(K1Args a,
                                                        TileArgs t) {
  constexpr int kWLp = 18 + 2 * NP, kWLc = 36 + 2 * NP;
  constexpr int GW = k1b_group_words(NP), RW = 3 * (NP > 6 ? NP : 6);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= t.n_groups) return;
  const bool pose = g < t.n_img_groups;
  const int row0 = pose ? kWLp : kWLc, nr = pose ? 18 : 3 * NP;
  const int64_t O = (int64_t)a.Pp * a.K;
  float v[GW];
#pragma unroll
  for (int i = 0; i < GW; ++i) v[i] = 0.f;
#pragma unroll 4
  for (int k = t.grp_off[g]; k < t.grp_off[g + 1]; ++k) {
    const int64_t c = t.grp_lane[k];
#pragma unroll
    for (int i = 0; i < RW; ++i)
      if (i < nr) v[i] += a.jw[(row0 + i) * O + c];
  }
  if (a.schur_bf16) {
#pragma unroll
    for (int i = 0; i < RW; ++i)
      v[i] = __bfloat162float(__float2bfloat16_rn(v[i]));
  }
  float4* out = reinterpret_cast<float4*>(t.grp + (int64_t)g * GW);
#pragma unroll
  for (int i = 0; i < GW / 4; ++i)
    out[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// R*3 floats of a group block.
template <int R>
__device__ inline void k1b_load(const float* p, float (&v)[3 * R]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 3 * R / 4; ++i) {
    const float4 w = __ldg(p4 + i);
    v[4 * i] = w.x;
    v[4 * i + 1] = w.y;
    v[4 * i + 2] = w.z;
    v[4 * i + 3] = w.w;
  }
#pragma unroll
  for (int i = 3 * R / 4 * 4; i < 3 * R; ++i) v[i] = __ldg(p + i);
}

// Warps per k1b_unit_kernel block: as many as 8 whose per-lane rows of
// the largest block fit the 48 KB of static shared memory.
template <int NP>
__host__ __device__ constexpr int k1b_warps() {
  constexpr int w = 12288 / (32 * (k1b_entries(NP) + 1));
  return w < 8 ? (w < 1 ? 1 : w) : 8;
}

// A unit's partial block: rows RA of node a x rows RB of node b (the
// upper triangle when Self), entries row-major. `buf` holds a row of
// RS >= NE + 1 floats per lane.
template <int NP, int RA, int RB, bool Self>
__device__ inline void k1b_unit(const TileArgs& t, int u, int lane,
                                float* buf) {
  constexpr int NE = Self ? RA * (RA + 1) / 2 : RA * RB;
  constexpr int GW = k1b_group_words(NP), RS = k1b_entries(NP) + 1;
  float acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int it = t.unit_off[u] + lane; it < t.unit_off[u + 1]; it += 32) {
    const int2 ab = t.items[it];
    float A[3 * RA], B[3 * RB];
    k1b_load<RA>(t.grp + (int64_t)ab.x * GW, A);
    if (Self) {
#pragma unroll
      for (int i = 0; i < 3 * RB; ++i) B[i] = A[i];
    } else {
      k1b_load<RB>(t.grp + (int64_t)ab.y * GW, B);
    }
    int e = 0;
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = Self ? i : 0; j < RB; ++j, ++e)
        acc[e] += A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] +
                  A[3 * i + 2] * B[3 * j + 2];
  }
  // Sum over the lanes through shared memory (lane order): lane e
  // takes entry e.
#pragma unroll
  for (int e = 0; e < NE; ++e) buf[lane * RS + e] = acc[e];
  __syncwarp();
  float* part = t.part + (int64_t)u * k1b_entries(NP);
  for (int e = lane; e < NE; e += 32) {
    float v = 0.f;
#pragma unroll 8
    for (int m = 0; m < 32; ++m) v += buf[m * RS + e];
    part[e] = v;
  }
}

template <int NP>
__global__ void __launch_bounds__(256) k1b_unit_kernel(K1Args a, TileArgs t) {
  constexpr int W = k1b_warps<NP>(), RS = k1b_entries(NP) + 1;
  __shared__ float s_red[W][32 * RS];   // per warp: [lane][entry]
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * W + w;
  if (u >= t.n_units) return;         // whole warps
  const int2 nd = t.pair_node[t.unit_pair[u]];
  const bool cam_a = nd.x >= a.Npad, cam_b = nd.y >= a.Npad;
  float* buf = s_red[w];
  if (!cam_b) {
    if (nd.x == nd.y) k1b_unit<NP, 6, 6, true>(t, u, lane, buf);
    else k1b_unit<NP, 6, 6, false>(t, u, lane, buf);
  } else if (!cam_a) {
    k1b_unit<NP, 6, NP, false>(t, u, lane, buf);
  } else {
    if (nd.x == nd.y) k1b_unit<NP, NP, NP, true>(t, u, lane, buf);
    else k1b_unit<NP, NP, NP, false>(t, u, lane, buf);
  }
}

template <int NP>
__global__ void __launch_bounds__(256) k1b_pair_kernel(K1Args a, TileArgs t) {
  // Entry-major: neighbouring threads take neighbouring pairs, whose
  // entries lie in neighbouring columns of S.
  constexpr int NE = k1b_entries(NP);
  const int64_t gi = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int e = (int)(gi / t.n_pairs), k = (int)(gi % t.n_pairs);
  if (e >= NE) return;
  const int2 nd = t.pair_node[k];
  const bool cam_a = nd.x >= a.Npad, cam_b = nd.y >= a.Npad;
  const int ra = cam_a ? NP : 6, rb = cam_b ? NP : 6;
  const bool self = nd.x == nd.y;
  int i, j;
  if (self) {                         // row-major upper triangle
    if (e >= ra * (ra + 1) / 2) return;
    i = 0;
    int rest = e;
    while (rest >= ra - i) rest -= ra - i++;
    j = i + rest;
  } else {
    if (e >= ra * rb) return;
    i = e / rb;
    j = e - i * rb;
  }
  float v = 0.f;
  for (int u = t.pair_unit[k]; u < t.pair_unit[k + 1]; ++u)
    v += t.part[(int64_t)u * NE + e];
  const int64_t row = cam_a ? 6LL * a.Npad + (int64_t)i * a.C + nd.x - a.Npad
                            : (int64_t)i * a.Npad + nd.x;
  const int64_t col = cam_b ? 6LL * a.Npad + (int64_t)j * a.C + nd.y - a.Npad
                            : (int64_t)j * a.Npad + nd.y;
  a.S[row * a.Dk + col] = v;
  a.S[col * a.Dk + row] = v;
}

template <int M>
cudaError_t launch_fused_schur(const K1Args& a, const TileArgs& t,
                               cudaStream_t stream) {
  constexpr int NP = Head<M>::NP;
  cudaError_t err = launch_k12<M, kModeSchur>(a, stream);
  if (err != cudaSuccess || t.n_pairs == 0) return err;
  k1b_group_kernel<NP><<<(t.n_groups + 255) / 256, 256, 0, stream>>>(a, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int W = k1b_warps<NP>();
  k1b_unit_kernel<NP><<<(t.n_units + W - 1) / W, 32 * W, 0, stream>>>(a, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = (int64_t)t.n_pairs * k1b_entries(NP);
  k1b_pair_kernel<NP><<<(int)((n + 255) / 256), 256, 0, stream>>>(a, t);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3: the implicit PCG's correction matvec.
//
// Replaces schur_matvec (_schur_matvec_kernel): for each point,
// etu = EL^T p = sum over its live slots of WL^T (du_pose[:, img],
// du_cam[:, cam]), then out[img, i] += WL[i] . etu for each live slot
// (rows i < 6 pose, then NP camera rows keyed by image). WL comes from
// jw's WL rows (f32) or the bf16 jcorr store (widened here); either way
// rows 0..3*(6+NP) of a [rows, O'] array. On the TPU the gathers and the
// scatter are one-hot MXU contractions over a sequential grid, looping
// over IB-wide image sub-blocks of each point block's image range.
//
// Bound: device memory, one read of the 3*(6+NP) coupling rows and the
// index and mask rows per live lane (0.030 ms at 1024 images); it runs
// once per CG iteration. A scatter with one float atomic per (live
// lane, row), 7.56M per matvec at 1024 images onto 9,216 addresses,
// stays far from it: `prepare` sorts the points by mean observing
// image, so the 32 lanes of a warp (32 neighbouring points, one slot)
// mostly hit one image row, and each such atomic serialises 32 deep in
// L2. This design:
//
// - One thread per observation lane. A block covers kK3Points points of
//   one point block (threadIdx.x) and min(K, kK3Slots) slots
//   (threadIdx.y): a warp reads 32 neighbouring lanes of one coupling
//   row. Each thread keeps its lane's 3*(6+NP) couplings in registers,
//   the slots' shares of etu are summed per point through shared
//   memory, and the scatter works from the registers: each coupling word
//   is read from device memory once. With K > kK3Slots the block walks
//   the slots in passes and re-reads the earlier passes' couplings.
// - The scatter is privatised. The block takes the image window [lo, hi]
//   of its live lanes (min and max of obs_img, as the reference's
//   _block_range) and sums into shared memory over chunks of kK3Window
//   images; the lanes of a warp that share an image are first summed by
//   a shuffle tree (__match_any_sync), and one shared atomic per group
//   and row remains. Each chunk then adds its nonzero rows to `out` with
//   one global atomic per (image, row) and block. A window wider than a
//   chunk (a point order without locality) takes more chunks of the same
//   loop; every input goes through the one code path.
// The float atomics make the summation order vary from run to run (the
// twin's tolerance, 3e-5 of scale).
// ---------------------------------------------------------------------------

// kK3Points and kK3Window are mirrored by ops/ba_kernels.py
// (K3_POINTS_PER_BLOCK, K3_WINDOW), whose schur_matvec_windows reports
// the blocks' windows.
constexpr int kK3Points = 64;    // points per block (threadIdx.x)
constexpr int kK3Slots = 8;      // slots per pass (threadIdx.y)
constexpr int kK3Window = 256;   // images per shared-memory window chunk


template <typename T> __device__ inline float widen(T v);
template <> __device__ inline float widen<float>(float v) { return v; }
template <> __device__ inline float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Lane `c`'s couplings (3*DV words), image and liveness.
// WL[i] . etu, in dot3's order.
template <int N>
__device__ inline float k3_row(const float (&w)[N], int i, const float e[3]) {
  return w[i * 3] * e[0] + w[i * 3 + 1] * e[1] + w[i * 3 + 2] * e[2];
}

template <int DV, typename T>
__device__ inline bool k3_load(const K3Args& a, int64_t O, int64_t c,
                               bool lane_ok, float (&w)[3 * DV], int& img) {
  const bool live = lane_ok && a.obs_sta[2 * O + c] != 0.f;
  img = live ? a.obs_img[c] : 0;
  const T* jc = static_cast<const T*>(a.jcorr);
#pragma unroll
  for (int r = 0; r < 3 * DV; ++r)
    w[r] = live ? widen<T>(jc[r * O + c]) : 0.f;
  return live;
}

template <int NP, typename T>
__global__ void __launch_bounds__(kK3Points * kK3Slots)
k3_matvec_kernel(K3Args a) {
  constexpr int DV = 6 + NP;
  __shared__ float s_part[kK3Slots][3][kK3Points];
  __shared__ float s_etu[3][kK3Points];
  __shared__ float s_out[kK3Window * DV];
  __shared__ int s_lo, s_hi;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ns = blockDim.y;                        // slots per pass
  const int passes = (a.K + ns - 1) / ns;
  const int groups = (a.TP + kK3Points - 1) / kK3Points;
  const int b = blockIdx.x / groups;
  const int p = (blockIdx.x - b * groups) * kK3Points + tx;
  const int64_t O = (int64_t)a.Pp * a.K;
  const int64_t lane0 = (int64_t)b * a.TP * a.K + p;   // slot 0's lane
  const int tid = ty * kK3Points + tx, nt = kK3Points * ns;
  if (tid == 0) {
    s_lo = 0x7fffffff;
    s_hi = -1;
  }

  // Pass 1: each lane's share of its point's etu, summed over the slots
  // in order; the window of the live lanes' images.
  float w[3 * DV];
  int img = 0, lo = 0x7fffffff, hi = -1, held = 0;
  bool live = false;
  float etu[3] = {0.f, 0.f, 0.f};
  for (int q = 0; q < passes; ++q) {
    const int s = q * ns + ty;
    const int64_t c = lane0 + (int64_t)s * a.TP;
    live = k3_load<DV, T>(a, O, c, p < a.TP && s < a.K, w, img);
    held = q;
    float part[3] = {0.f, 0.f, 0.f};
    if (live) {
      lo = min(lo, img);
      hi = max(hi, img);
      const int cam = a.obs_cam[c];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float vp = 0.f, vc = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i)
          vp += w[i * 3 + j] * a.du_pose_t[i * a.Npad + img];
#pragma unroll
        for (int m = 0; m < NP; ++m)
          vc += w[18 + m * 3 + j] * a.du_cam_t[m * a.C + cam];
        part[j] = vp + vc;
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) s_part[ty][j][tx] = part[j];
    __syncthreads();
    if (ty == 0)
      for (int t = 0; t < ns; ++t)
#pragma unroll
        for (int j = 0; j < 3; ++j) etu[j] += s_part[t][j][tx];
    __syncthreads();
  }
  if (ty == 0)
#pragma unroll
    for (int j = 0; j < 3; ++j) s_etu[j][tx] = etu[j];
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((tid & 31) == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const float e[3] = {s_etu[0][tx], s_etu[1][tx], s_etu[2][tx]};
  const int blo = s_lo, bhi = s_hi;

  // Pass 2: out[img, i] += WL[i] . etu, through the window chunks.
  float val[DV];
#pragma unroll
  for (int i = 0; i < DV; ++i) val[i] = k3_row(w, i, e);
  for (int w0 = blo; w0 <= bhi; w0 += kK3Window) {
    const int width = min(kK3Window, bhi - w0 + 1);
    for (int i = tid; i < width * DV; i += nt) s_out[i] = 0.f;
    __syncthreads();
    for (int k = 0, first = held; k < passes; ++k) {
      const int q = (first + k) % passes;
      if (q != held) {                // only with K > kK3Slots
        const int s = q * ns + ty;
        const int64_t c = lane0 + (int64_t)s * a.TP;
        live = k3_load<DV, T>(a, O, c, p < a.TP && s < a.K, w, img);
        held = q;
#pragma unroll
        for (int i = 0; i < DV; ++i) val[i] = k3_row(w, i, e);
      }
      const bool in = live && img >= w0 && img < w0 + width;
      float sum[DV];
#pragma unroll
      for (int i = 0; i < DV; ++i) sum[i] = in ? val[i] : 0.f;
      const unsigned peers =
          __match_any_sync(0xffffffffu, in ? img : -1 - (tid & 31));
      peer_sum<DV>(peers, sum);
      if (in && (tid & 31) == __ffs(peers) - 1) {
        float* row = s_out + (img - w0) * DV;
#pragma unroll
        for (int i = 0; i < DV; ++i) atomicAdd(row + i, sum[i]);
      }
    }
    __syncthreads();
    for (int i = tid; i < width * DV; i += nt) {
      const float v = s_out[i];
      if (v != 0.f) atomicAdd(a.out + (int64_t)w0 * DV + i, v);
    }
    __syncthreads();                  // before the next chunk's zeroing
  }
}

template <int NP>
cudaError_t launch_schur_matvec(const K3Args& a, int bf16,
                                cudaStream_t stream) {
  if (a.TP <= 0 || a.K <= 0 || a.Pp % a.TP != 0)
    return cudaErrorInvalidValue;
  const int groups = (a.TP + kK3Points - 1) / kK3Points;
  const dim3 block(kK3Points, a.K < kK3Slots ? a.K : kK3Slots);
  const int blocks = a.Pp / a.TP * groups;
  if (blocks == 0) return cudaSuccess;
  if (bf16)
    k3_matvec_kernel<NP, __nv_bfloat16><<<blocks, block, 0, stream>>>(a);
  else
    k3_matvec_kernel<NP, float><<<blocks, block, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4: back-substitution + predicted-reduction sums, one thread per lane.
//
// Replaces backsub (_backsub_kernel): dp = -Hpp^-1 g_p - Lp (EL^T du),
// masked by the free points, and the sums ||J d||^2, g_p.dp and
// lam D dp^2. On the TPU the cross-block sums ride a sequential grid.
// Bound: device memory, one read of each live lane's jw rows (Jacobian
// and WL), image and camera, and of the point payload; du is gathered per
// lane from the small [6, Npad] / [12, C] tables, which stay cache
// resident. The design (K3's block shape; the designs tried are in
// PERF.md §6):
//
// - One thread per observation lane. A block covers kK4Points points of
//   one point block (threadIdx.x) and min(K, kK4Slots) slots
//   (threadIdx.y): a warp reads 32 neighbouring lanes of one jw row. With
//   K > kK4Slots a thread takes slots ty, ty + S, ... in passes.
// - Pass 1: each thread loads its lane's du gathers and WL rows together
//   (loops over compile-time rows, so they stay in registers and in
//   flight) and sums its lanes' shares of etu = WL^T du. The block's point
//   payload is copied to shared memory asynchronously meanwhile. The
//   slots' shares meet in shared memory; the y = 0 row sums them in slot
//   order, computes dp, writes it and shares it.
// - Pass 2: each thread loads its lane's Jacobian rows and adds
//   ||J [du; dp]||^2 (with K > kK4Slots, the earlier passes' lanes' du
//   again), loading the Jacobian rows only after the dp barrier. The
//   block reduces the three sums by warp shuffles and adds each with one
//   atomic.
// Dead lanes (mask 0) and padding points contribute exactly zero.
// ---------------------------------------------------------------------------

constexpr int kK4Points = 32;  // points per block (threadIdx.x)
constexpr int kK4Slots = 16;   // slots per pass (threadIdx.y)
constexpr int kPayRows = 19;   // pt_pay: g, hdiag, Hpp^-1, Lp, free_p


// Whether lane c is live (`in`: its slot exists); then its du: image
// n's 6 pose rows and camera cam's NP rows.
template <int NP>
__device__ inline bool k4_lane(const K4Args& a, int64_t O, int64_t c,
                               bool in, float (&du)[6 + NP]) {
  if (!in || a.obs_sta[2 * O + c] == 0.f) return false;
  const int n = a.obs_img[c], cam = a.obs_cam[c];
#pragma unroll
  for (int i = 0; i < 6; ++i) du[i] = a.du_pose_t[i * a.Npad + n];
#pragma unroll
  for (int m = 0; m < NP; ++m) du[6 + m] = a.du_cam_t[m * a.C + cam];
  return true;
}

// Lane c's Jacobian rows Jc(12) | Jx(6) | Jk(2NP), jw rows 0 .. 18+2NP.
template <int NP>
__device__ inline void k4_jac(const K4Args& a, int64_t O, int64_t c,
                              float (&jr)[18 + 2 * NP]) {
#pragma unroll
  for (int r = 0; r < 18 + 2 * NP; ++r) jr[r] = a.jw[r * O + c];
}

// ||J [du; dp]||^2 of one lane, in the twin's order.
template <int NP>
__device__ inline float k4_t2(const float (&du)[6 + NP],
                              const float (&jr)[18 + 2 * NP],
                              const float dp[3]) {
  float sum = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) t += jr[kk * 6 + i] * du[i];
#pragma unroll
    for (int m = 0; m < NP; ++m) t += jr[18 + kk * NP + m] * du[6 + m];
#pragma unroll
    for (int j = 0; j < 3; ++j) t += jr[12 + kk * 3 + j] * dp[j];
    sum += t * t;
  }
  return sum;
}

template <int NP>
__global__ void __launch_bounds__(kK4Points * kK4Slots)
k4_backsub_kernel(K4Args a) {
  constexpr int DV = 6 + NP, NJ = 18 + 2 * NP, kWL = NJ;  // WL rows follow
  __shared__ float s_part[kK4Slots][3][kK4Points];
  __shared__ float s_pay[kPayRows][kK4Points];
  __shared__ float s_dp[3][kK4Points];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ns = blockDim.y;                        // slots per pass
  const int passes = (a.K + ns - 1) / ns;
  const int groups = (a.TP + kK4Points - 1) / kK4Points;
  const int b = blockIdx.x / groups;
  const int p0 = (blockIdx.x - b * groups) * kK4Points;
  const int p = p0 + tx;                             // point in its block
  const bool pt_ok = p < a.TP;
  const int64_t O = (int64_t)a.Pp * a.K;
  const int64_t lane0 = (int64_t)b * a.TP * a.K + p;   // slot 0's lane
  const int tid = ty * kK4Points + tx, nt = kK4Points * ns;

  // The block's point payload, copied to shared memory while pass 1 runs.
  const int np_blk = min(kK4Points, a.TP - p0);
  for (int w = tid; w < kPayRows * kK4Points; w += nt) {
    const int r = w / kK4Points, x = w - r * kK4Points;
    if (x < np_blk)
      __pipeline_memcpy_async(&s_pay[r][x],
                              a.pt_pay + (int64_t)r * a.Pp + b * a.TP + p0 + x,
                              sizeof(float));
  }
  __pipeline_commit();

  // Pass 1: each lane's share of etu, summed over this thread's slots.
  float du[DV];                      // the last pass's lane, kept for pass 2
  bool live = false;
  float part[3] = {0.f, 0.f, 0.f};
  for (int q = 0; q < passes; ++q) {
    const int s = q * ns + ty;
    const int64_t c = lane0 + (int64_t)s * a.TP;
    live = k4_lane<NP>(a, O, c, pt_ok && s < a.K, du);
    if (!live) continue;
    float w[3 * DV];
#pragma unroll
    for (int r = 0; r < 3 * DV; ++r) w[r] = a.jw[(kWL + r) * O + c];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) v += w[i * 3 + j] * du[i];
#pragma unroll
      for (int m = 0; m < NP; ++m) v += w[18 + m * 3 + j] * du[6 + m];
      part[j] += v;
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) s_part[ty][j][tx] = part[j];
  __pipeline_wait_prior(0);
  __syncthreads();

  // The y = 0 row: etu in slot order, then dp and the point's sums.
  float sums[3] = {0.f, 0.f, 0.f};
  if (ty == 0) {
    float dp[3] = {0.f, 0.f, 0.f};
    if (pt_ok) {
      float etu[3] = {0.f, 0.f, 0.f};
      for (int t = 0; t < ns; ++t)
#pragma unroll
        for (int j = 0; j < 3; ++j) etu[j] += s_part[t][j][tx];
      float pay[kPayRows];
#pragma unroll
      for (int r = 0; r < kPayRows; ++r) pay[r] = s_pay[r][tx];
      const float *g = pay, *hd = pay + 3, *hi = pay + 6, *L = pay + 12;
      const float fp = pay[18];
      const float him[3][3] = {{hi[0], hi[1], hi[2]},
                               {hi[1], hi[3], hi[4]},
                               {hi[2], hi[4], hi[5]}};
      const float lpm[3][3] = {{L[0], 0.f, 0.f},
                               {L[1], L[3], 0.f},
                               {L[2], L[4], L[5]}};
      const int pt = b * a.TP + p;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float v = -(him[j][0] * g[0] + him[j][1] * g[1] + him[j][2] * g[2]);
#pragma unroll
        for (int i = 0; i <= j; ++i) v -= lpm[j][i] * etu[i];
        dp[j] = v * fp;
        a.dp[j * a.Pp + pt] = dp[j];
      }
      const float lam = *a.lam;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        sums[1] += g[j] * dp[j];
        sums[2] += lam * clampf(hd[j], 1e-6f, 1e32f) * dp[j] * dp[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) s_dp[j][tx] = dp[j];
  }
  __syncthreads();

  // Pass 2: ||J d||^2 over this thread's lanes, the held lane first.
  const float dp[3] = {s_dp[0][tx], s_dp[1][tx], s_dp[2][tx]};
  const int64_t held = lane0 + (int64_t)((passes - 1) * ns + ty) * a.TP;
  float jr[NJ];
  if (live) {
    k4_jac<NP>(a, O, held, jr);
    sums[0] += k4_t2<NP>(du, jr, dp);
  }
  for (int q = passes - 2; q >= 0; --q) {           // only with K > kK4Slots
    const int64_t c = lane0 + (int64_t)(q * ns + ty) * a.TP;
    if (!k4_lane<NP>(a, O, c, pt_ok, du)) continue;
    k4_jac<NP>(a, O, c, jr);
    sums[0] += k4_t2<NP>(du, jr, dp);
  }
  block_atomic_add<3>(sums, a.acc);
}

template <int NP>
cudaError_t launch_backsub(const K4Args& a, cudaStream_t stream) {
  if (a.TP <= 0 || a.K <= 0 || a.Pp % a.TP != 0)
    return cudaErrorInvalidValue;
  const int groups = (a.TP + kK4Points - 1) / kK4Points;
  const dim3 block(kK4Points, a.K < kK4Slots ? a.K : kK4Slots);
  const int blocks = a.Pp / a.TP * groups;
  if (blocks == 0) return cudaSuccess;
  k4_backsub_kernel<NP><<<blocks, block, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: robust cost at trial parameters over all buckets, in one launch.
//
// Replaces fused_cost (_cost_kernel): the sum of 1/2 mask rho(||r||^2)
// over the observation lanes. The TPU kernel takes one bucket a call and
// carries its sum across a sequential grid; here one launch takes every
// bucket of an LM cost evaluation, their lanes numbered one after
// another. kK5BlocksPerSm blocks a SM walk them: a thread takes kK5Lanes
// lanes at a time, strided by the grid, and issues all their loads
// (mask, x, y, image and point; none waits on another, so dead lanes are
// read too) before it projects any: a group costs one trip to memory. A
// lane's point comes from its number by multiply-and-shift divisions
// (k5_div). Each block writes its partial sum to a slot of its own; the
// last block to finish (an atomic ticket after a fence) adds the slots
// in a fixed order, writes the total and resets the ticket. No float
// atomics: the same inputs give the same bits on every call, and the
// output needs no zeroing. The slots and the ticket are the caller's
// workspace (a.part, a.ticket), zeroed once when it is made; launches
// that share one must not overlap, so the wrapper keeps one a stream.
// Bound: device memory, one read of the mask row and of the live lanes'
// x, y, image and point; at the headline's ~4 MB the launch, two memory
// latencies and the tail set the time. The [7+np, Npad] parameter table
// is staged in shared memory when it fits (kK5StageMax: up to ~3,000
// images at 12 intrinsics), its copy overlapping the first group's
// loads, so a lane's 7+np parameter reads hit shared memory; past that
// (10,240 images) the kernel reads the table in place.
// ---------------------------------------------------------------------------

constexpr int kK5Threads = 512;
constexpr int kK5BlocksPerSm = 2;
constexpr int kK5Lanes = 4;
static_assert(kK5StageMax + 1024 == kMaxSmem, "K5 stage limit");

// n / d for 0 <= n < 2^31 by a multiply and a shift (the round-up
// method of Granlund and Montgomery): mul and shr from k5_divisor(d).
__device__ inline int k5_div(int n, unsigned mul, unsigned shr) {
  return (int)((__umulhi((unsigned)n, mul) + (unsigned)n) >> shr);
}

inline void k5_divisor(unsigned d, unsigned& mul, unsigned& shr) {
  shr = 0;
  while ((1ull << shr) < d) ++shr;
  mul = (unsigned)(((1ull << 32) * ((1ull << shr) - d)) / d + 1);
}

// One lane's observation and point, loaded before its projection.
struct K5Lane {
  float mask, ox, oy, x[3];
  int n;
};

// Loads lanes v0, v0 + stride, ... (kK5Lanes of them) of the buckets'
// lane sequence; a lane past the end gets mask 0.
__device__ inline void k5_load(const K5Args& a,
                               const int (&end)[kK5MaxBuckets], int v0,
                               int stride, K5Lane (&d)[kK5Lanes]) {
#pragma unroll
  for (int u = 0; u < kK5Lanes; ++u) {
    const int v = v0 + u * stride;
    d[u].mask = 0.f;
    if (v >= end[kK5MaxBuckets - 1]) continue;
    const int b = v < end[0] ? 0 : (v < end[1] ? 1 : 2);
    const K5Bucket& B = b == 0 ? a.b[0] : (b == 1 ? a.b[1] : a.b[2]);
    const int c = v - (b == 0 ? 0 : (b == 1 ? end[0] : end[1]));
    const int O = B.Pp * B.K;
    const int q = k5_div(c, B.blk_mul, B.blk_shr);  // c / (TP*K)
    const int r = c - q * B.TP * B.K;               // slot * TP + p
    const int pt = q * B.TP + r - k5_div(r, B.tp_mul, B.tp_shr) * B.TP;
    d[u].mask = __ldg(B.obs_sta + 2LL * O + c);
    d[u].ox = __ldg(B.obs_sta + c);
    d[u].oy = __ldg(B.obs_sta + O + c);
    d[u].n = __ldg(B.obs_img + c);
    d[u].x[0] = __ldg(B.pts + pt);
    d[u].x[1] = __ldg(B.pts + B.Pp + pt);
    d[u].x[2] = __ldg(B.pts + 2 * B.Pp + pt);
  }
}

// Adds the loaded lanes' costs to sum, in lane order.
template <int M>
__device__ inline void k5_add(const K5Args& a, const float* par,
                              const K5Lane (&d)[kK5Lanes], float& sum) {
  constexpr int NP = Head<M>::NP;
#pragma unroll
  for (int u = 0; u < kK5Lanes; ++u) {
    if (d[u].mask == 0.f) continue;
    float R[3][3], t[3], k[NP];
    load_pose(par, a.Npad, d[u].n, R, t);
    for (int m = 0; m < NP; ++m) k[m] = par[(7 + m) * a.Npad + d[u].n];
    float uu, vv, px, py;
    camera_uv(R, t, d[u].x, uu, vv);
    head_project<M>(k, uu, vv, px, py);
    const float r0 = px - d[u].ox, r1 = py - d[u].oy;
    sum += 0.5f * d[u].mask * loss_value(a.loss, r0 * r0 + r1 * r1, a.a2);
  }
}

template <int M>
__global__ void __launch_bounds__(kK5Threads, kK5BlocksPerSm)
    k5_cost_kernel(K5Args a, int stage) {
  constexpr int NP = Head<M>::NP;
  extern __shared__ float4 s_par4[];
  __shared__ float s_sum[kK5Threads / 32];
  __shared__ bool s_last;
  // The end of each bucket in the lane sequence; absent buckets are
  // empty.
  int end[kK5MaxBuckets];
#pragma unroll
  for (int b = 0; b < kK5MaxBuckets; ++b)
    end[b] = (b > 0 ? end[b - 1] : 0) +
             (b < a.n_buckets ? a.b[b].Pp * a.b[b].K : 0);
  const int stride = gridDim.x * kK5Threads;
  int v0 = blockIdx.x * kK5Threads + threadIdx.x;
  K5Lane d[kK5Lanes];
  k5_load(a, end, v0, stride, d);
  const float* par = a.par;
  if (stage) {  // (7+NP)*Npad words, a multiple of 4, 16-byte aligned
    const float4* src = reinterpret_cast<const float4*>(a.par);
    const int n4 = (7 + NP) * a.Npad / 4;
    for (int i = threadIdx.x; i < n4; i += kK5Threads)
      s_par4[i] = __ldg(src + i);
    __syncthreads();
    par = reinterpret_cast<const float*>(s_par4);
  }
  float sum = 0.f;
  while (true) {
    k5_add<M>(a, par, d, sum);
    v0 += kK5Lanes * stride;
    if (v0 >= end[kK5MaxBuckets - 1]) break;
    k5_load(a, end, v0, stride, d);
  }

  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  sum = warp_sum(sum);
  if (lane == 0) s_sum[wid] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float p = 0.f;
    for (int w = 0; w < kK5Threads / 32; ++w) p += s_sum[w];
    a.part[blockIdx.x] = p;
    __threadfence();
    s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  // The last block: every slot is written and fenced.
  float total = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kK5Threads)
    total += __ldcg(a.part + i);
  total = warp_sum(total);
  if (lane == 0) s_sum[wid] = total;  // thread 0 read s_sum before the sync
  __syncthreads();
  if (threadIdx.x == 0) {
    total = 0.f;
    for (int w = 0; w < kK5Threads / 32; ++w) total += s_sum[w];
    *a.out = total;
    atomicExch(a.ticket, 0u);
  }
}

}  // namespace

// `t.grp` is the start of the whole scratch: the group blocks, then the
// unit partial blocks (their sizes follow NP).
template <int M>
cudaError_t fused_schur(const K1Args& a, const TileArgs& t, cudaStream_t s) {
  TileArgs tm = t;
  tm.part = t.grp + (int64_t)t.n_groups * k1b_group_words(Head<M>::NP);
  return launch_fused_schur<M>(a, tm, s);
}

// K2 in the payload mode of the model's layout (k2_block); the wrapper
// passes the layout's BJ, which must agree.
template <int M>
cudaError_t fused_reduce(const K1Args& a, cudaStream_t s) {
  constexpr bool block = k2_block(Head<M>::NP);
  if (a.bj != (block ? 1 : 0)) return cudaErrorInvalidValue;
  return launch_k12<M, block ? kModeBlock : kModeDiag>(a, s);
}

template <int M>
cudaError_t schur_matvec(const K3Args& a, int bf16, cudaStream_t s) {
  return launch_schur_matvec<Head<M>::NP>(a, bf16, s);
}

template <int M>
cudaError_t backsub(const K4Args& a, cudaStream_t s) {
  return launch_backsub<Head<M>::NP>(a, s);
}

// One launch over a.n_buckets buckets; the grid is sized by their lanes
// and the SM count (kK5BlocksPerSm blocks a SM).
template <int M>
cudaError_t fused_cost(const K5Args& args, cudaStream_t s) {
  constexpr int NP = Head<M>::NP;
  if (args.n_buckets < 1 || args.n_buckets > kK5MaxBuckets ||
      args.Npad <= 0 || args.part == nullptr || args.ticket == nullptr)
    return cudaErrorInvalidValue;
  K5Args a = args;
  int64_t lanes = 0;
  for (int b = 0; b < a.n_buckets; ++b) {
    K5Bucket& B = a.b[b];
    if (B.TP <= 0 || B.K <= 0 || B.Pp < 0 || B.Pp % B.TP != 0)
      return cudaErrorInvalidValue;
    lanes += (int64_t)B.Pp * B.K;
    k5_divisor((unsigned)B.TP * B.K, B.blk_mul, B.blk_shr);
    k5_divisor((unsigned)B.TP, B.tp_mul, B.tp_shr);
  }
  // Lane numbers, and the next group's first, stay inside int.
  if (lanes > 0x7fffffffLL - (int64_t)kK5Lanes * kK5Threads * kK5MaxBlocks)
    return cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        k5_cost_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kK5StageMax);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const size_t par_bytes = sizeof(float) * (7 + NP) * (size_t)a.Npad;
  const bool stage = k5_stages(NP, a.Npad, a.par);
  int64_t blocks = (lanes + kK5Threads - 1) / kK5Threads;
  if (blocks > kK5BlocksPerSm * sms) blocks = kK5BlocksPerSm * sms;
  if (blocks > kK5MaxBlocks) blocks = kK5MaxBlocks;
  if (blocks < 1) blocks = 1;  // no lanes: the total is 0
  k5_cost_kernel<M><<<(int)blocks, kK5Threads, stage ? par_bytes : 0, s>>>(
      a, stage ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace sba

// The five entry points of camera model M (in ba_model<M>.cu).
#define SBA_INSTANTIATE_MODEL(M)                                           \
  template cudaError_t sba::fused_schur<M>(const sba::K1Args&,             \
                                           const sba::TileArgs&,           \
                                           cudaStream_t);                  \
  template cudaError_t sba::fused_reduce<M>(const sba::K1Args&,            \
                                            cudaStream_t);                 \
  template cudaError_t sba::schur_matvec<M>(const sba::K3Args&, int,       \
                                            cudaStream_t);                 \
  template cudaError_t sba::backsub<M>(const sba::K4Args&, cudaStream_t);  \
  template cudaError_t sba::fused_cost<M>(const sba::K5Args&, cudaStream_t);

#endif  // SBA_BA_DECLARATIONS_ONLY
