// Bundle-adjustment LM kernels for Hopper (sm_90a), plain C interface.
//
// Hand-written CUDA replacements of the Pallas TPU kernels of
// sba_tpu/ops/ba_kernels.py:
//   K1 sba_fused_schur  <- fused_schur   (_fused_schur_kernel)
//   K2 sba_fused_reduce <- fused_reduce  (_fused_reduce_kernel)
//   K3 sba_schur_matvec <- schur_matvec  (_schur_matvec_kernel)
//   K4 sba_backsub      <- backsub       (_backsub_kernel)
//   K5 sba_fused_cost   <- fused_cost    (_cost_kernel)
// The Python wrappers (sba_tpu_torch/ops/ba_kernels.py) check shapes,
// types and devices, allocate every output (zeroed where a kernel
// accumulates) and pass PyTorch's current stream. Every entry point
// returns cudaGetLastError() after its launches.
//
// Data layout (the TPU kernel's): per-observation data are [field, lane]
// rows over O = Pp*K lanes, lane c = b*TP*K + s*TP + p_local holding
// slot s of point b*TP + p_local, so thread i of a block reading row f at
// lane c and thread i+1 at lane c+1 read neighbouring words.
//
// Camera heads: SIMPLE_PINHOLE (0), PINHOLE (1) and SIMPLE_RADIAL (2),
// one template on the model id. Other models are rejected here and in
// the wrappers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in dynamic shared memory

// ---------------------------------------------------------------------------
// Camera heads: projection of normalized (u, v), A2 = d(px,py)/d(u,v) and
// dk[m] = d(px,py)/dk_m, as sba_tpu/ops/ba_kernels.py::_head.
// ---------------------------------------------------------------------------

template <int M> struct Head;

template <> struct Head<0> {  // SIMPLE_PINHOLE: f, cx, cy
  static constexpr int NP = 3;
  __device__ static void project(const float* k, float u, float v,
                                 float& px, float& py) {
    px = k[0] * u + k[1];
    py = k[0] * v + k[2];
  }
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    project(k, u, v, px, py);
    a[0][0] = k[0]; a[0][1] = 0.f; a[1][0] = 0.f; a[1][1] = k[0];
    dk[0][0] = u;   dk[0][1] = v;
    dk[1][0] = 1.f; dk[1][1] = 0.f;
    dk[2][0] = 0.f; dk[2][1] = 1.f;
  }
};

template <> struct Head<1> {  // PINHOLE: fx, fy, cx, cy
  static constexpr int NP = 4;
  __device__ static void project(const float* k, float u, float v,
                                 float& px, float& py) {
    px = k[0] * u + k[2];
    py = k[1] * v + k[3];
  }
  __device__ static void eval(const float* k, float u, float v, float& px,
                              float& py, float a[2][2], float dk[NP][2]) {
    project(k, u, v, px, py);
    a[0][0] = k[0]; a[0][1] = 0.f; a[1][0] = 0.f; a[1][1] = k[1];
    dk[0][0] = u;   dk[0][1] = 0.f;
    dk[1][0] = 0.f; dk[1][1] = v;
    dk[2][0] = 1.f; dk[2][1] = 0.f;
    dk[3][0] = 0.f; dk[3][1] = 1.f;
  }
};

template <> struct Head<2> {  // SIMPLE_RADIAL: f, cx, cy, k1
  static constexpr int NP = 4;
  __device__ static void project(const float* k, float u, float v,
                                 float& px, float& py) {
    const float d = 1.f + k[3] * (u * u + v * v);
    px = k[0] * (u * d) + k[1];
    py = k[0] * (v * d) + k[2];
  }
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
// thread of the block must call it.
template <int NV>
__device__ void block_atomic_add(float (&v)[NV], float* out) {
  __shared__ float part[NV][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
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

__device__ inline float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// ---------------------------------------------------------------------------
// K1a / K2: linearize + reduce, one thread per point.
//
// K1a replaces the linearize/reduce half of fused_schur
// (_linearize_and_reduce): per observation the residual and analytic
// Jacobians; per point g_p, Hpp, the damped Hpp^-1 and its Cholesky Lp;
// the whitened couplings WL = (Ju^T Jx) Lp; per image the g/H payload
// and Ey = EL (Lp^T g_p). On the TPU the per-image reductions are
// one-hot MXU contractions; here they are atomics into img_red / ey.
//
// With Implicit (K2, replacing fused_reduce / _fused_reduce_kernel) the
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
// Bound: device memory. The kernel writes jw (JW rows per observation),
// and for K2 the bf16 jcorr, reads jw's Jacobian rows back once for the
// whitening pass, and reads the observation rows once; the arithmetic
// per byte is low. Design: lanes are laid out so that a warp's accesses
// to each row are contiguous; the second pass re-reads the Jacobian
// rows this thread just wrote (L1/L2-resident) instead of keeping K
// slots in registers. Every image-payload term is a float atomic; on a
// sequential scene the threads of a block see few images, so these
// atomics contend (correct, slow; not addressed here).
// ---------------------------------------------------------------------------

template <int M, bool Implicit>
__global__ void __launch_bounds__(kThreads) k1_linearize_kernel(K1Args a) {
  constexpr int NP = Head<M>::NP;
  constexpr int DI = 42 + 7 * NP + NP * NP;
  constexpr int kJk = 18, kWLp = 18 + 2 * NP, kWLc = 36 + 2 * NP;
  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= a.Pp) return;
  const int stride = Implicit ? DI + 6 + 2 * NP + (a.bj ? 21 : 6) : DI;
  const int64_t O = (int64_t)a.Pp * a.K;
  const int64_t base = (int64_t)(pt / a.TP) * a.TP * a.K + pt % a.TP;
  const float x[3] = {a.pts[pt], a.pts[a.Pp + pt], a.pts[2 * a.Pp + pt]};
  const float fp = a.free_pts[pt];
  const float lam = *a.lam;

  float g[3] = {0.f, 0.f, 0.f};
  float H[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < a.K; ++s) {
    const int64_t c = base + (int64_t)s * a.TP;
    const int n = a.obs_img[c];
    const float mask = a.obs_sta[2 * O + c];
    float r[2], Jc[12], Jx[6], Jk[2 * NP];
    linearize<M>(a.par, a.free_sta, a.Npad, n, x, fp, a.obs_sta[c],
                 a.obs_sta[O + c], mask, a.loss, a.a2, r, Jc, Jx, Jk);
    for (int i = 0; i < 12; ++i) a.jw[i * O + c] = Jc[i];
    for (int i = 0; i < 6; ++i) a.jw[(12 + i) * O + c] = Jx[i];
    for (int i = 0; i < 2 * NP; ++i) a.jw[(kJk + i) * O + c] = Jk[i];
    for (int j = 0; j < 3; ++j) g[j] += Jx[j] * r[0] + Jx[3 + j] * r[1];
    H[0] += Jx[0] * Jx[0] + Jx[3] * Jx[3];
    H[1] += Jx[0] * Jx[1] + Jx[3] * Jx[4];
    H[2] += Jx[0] * Jx[2] + Jx[3] * Jx[5];
    H[3] += Jx[1] * Jx[1] + Jx[4] * Jx[4];
    H[4] += Jx[1] * Jx[2] + Jx[4] * Jx[5];
    H[5] += Jx[2] * Jx[2] + Jx[5] * Jx[5];
    if (mask == 0.f) continue;  // every payload term of this lane is 0
    float* row = a.img_red + (int64_t)n * stride;
    int o = 0;
    for (int i = 0; i < 6; ++i)
      atomicAdd(row + o++, Jc[i] * r[0] + Jc[6 + i] * r[1]);
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j)
        atomicAdd(row + o++, Jc[i] * Jc[j] + Jc[6 + i] * Jc[6 + j]);
    for (int i = 0; i < 6; ++i)
      for (int m = 0; m < NP; ++m)
        atomicAdd(row + o++, Jc[i] * Jk[m] + Jc[6 + i] * Jk[NP + m]);
    for (int m = 0; m < NP; ++m)
      atomicAdd(row + o++, Jk[m] * r[0] + Jk[NP + m] * r[1]);
    for (int m = 0; m < NP; ++m)
      for (int m2 = 0; m2 < NP; ++m2)
        atomicAdd(row + o++, Jk[m] * Jk[m2] + Jk[NP + m] * Jk[NP + m2]);
  }

  // ---- per-point payload: damped Hpp^-1 and its Cholesky factor ----
  const float hd[3] = {H[0], H[3], H[5]};
  float d_l[3];
  for (int j = 0; j < 3; ++j) d_l[j] = lam * clampf(hd[j], 1e-6f, 1e32f);
  const float A = H[0] + d_l[0] + 1e-12f, B = H[1], Cc = H[2];
  const float D = H[3] + d_l[1] + 1e-12f, E = H[4];
  const float F = H[5] + d_l[2] + 1e-12f;
  const float co00 = D * F - E * E, co01 = Cc * E - B * F,
              co02 = B * E - Cc * D, co11 = A * F - Cc * Cc,
              co12 = B * Cc - A * E, co22 = A * D - B * B;
  const float det = A * co00 + B * co01 + Cc * co02;
  const float inv_det = 1.f / (fabsf(det) > 1e-12f ? det : 1e-12f);
  const float hi[6] = {co00 * inv_det, co01 * inv_det, co02 * inv_det,
                       co11 * inv_det, co12 * inv_det, co22 * inv_det};
  float L[6];  // l00, l10, l20, l11, l21, l22
  L[0] = sqrtf(fmaxf(hi[0], 1e-20f));
  L[1] = hi[1] / L[0];
  L[2] = hi[2] / L[0];
  L[3] = sqrtf(fmaxf(hi[3] - L[1] * L[1], 1e-20f));
  L[4] = (hi[4] - L[2] * L[1]) / L[3];
  L[5] = sqrtf(fmaxf(hi[5] - L[2] * L[2] - L[4] * L[4], 1e-20f));
  float* pp = a.pt_pay + pt;
  for (int j = 0; j < 3; ++j) pp[j * a.Pp] = g[j];
  for (int j = 0; j < 3; ++j) pp[(3 + j) * a.Pp] = hd[j];
  for (int j = 0; j < 6; ++j) pp[(6 + j) * a.Pp] = hi[j];
  for (int j = 0; j < 6; ++j) pp[(12 + j) * a.Pp] = L[j];
  pp[18 * a.Pp] = fp;
  const float y[3] = {L[0] * g[0] + L[1] * g[1] + L[2] * g[2],
                      L[3] * g[1] + L[4] * g[2], L[5] * g[2]};

  // ---- whitened couplings WL = W Lp, then Ey (K1) or the implicit
  // payload and the bf16 jcorr (K2) ----
  __nv_bfloat16* jc16 = static_cast<__nv_bfloat16*>(a.jcorr);
  for (int s = 0; s < a.K; ++s) {
    const int64_t c = base + (int64_t)s * a.TP;
    const bool live = a.obs_sta[2 * O + c] != 0.f;
    float Jc[12], Jx[6], Jk[2 * NP];
    for (int i = 0; i < 12; ++i) Jc[i] = live ? a.jw[i * O + c] : 0.f;
    for (int i = 0; i < 6; ++i) Jx[i] = live ? a.jw[(12 + i) * O + c] : 0.f;
    for (int i = 0; i < 2 * NP; ++i)
      Jk[i] = live ? a.jw[(kJk + i) * O + c] : 0.f;
    const int n = a.obs_img[c], cam = a.obs_cam[c];
    float WL[6 + NP][3];  // rows i*3 + j: WLp (i < 6), then WLc
    for (int i = 0; i < 6 + NP; ++i) {
      float W[3];
      for (int j = 0; j < 3; ++j)
        W[j] = i < 6 ? Jc[i] * Jx[j] + Jc[6 + i] * Jx[3 + j]
                     : Jk[i - 6] * Jx[j] + Jk[NP + i - 6] * Jx[3 + j];
      WL[i][0] = W[0] * L[0] + W[1] * L[1] + W[2] * L[2];
      WL[i][1] = W[1] * L[3] + W[2] * L[4];
      WL[i][2] = W[2] * L[5];
      const int row0 = i < 6 ? kWLp + i * 3 : kWLc + (i - 6) * 3;
      for (int j = 0; j < 3; ++j) a.jw[(row0 + j) * O + c] = WL[i][j];
    }
    if (Implicit && a.jcorr_bf16) {
      for (int r = 0; r < 3 * (6 + NP); ++r)
        jc16[r * O + c] = __float2bfloat16_rn(WL[r / 3][r % 3]);
    }
    if (!live) continue;
    if (!Implicit) {
      for (int i = 0; i < 6 + NP; ++i) {
        const int64_t erow = i < 6 ? (int64_t)i * a.Npad + n
                                   : 6LL * a.Npad + (int64_t)(i - 6) * a.C + cam;
        atomicAdd(a.ey + erow, dot3(WL[i], y));
      }
      continue;
    }
    float* row = a.img_red + (int64_t)n * stride + DI;
    int o = 0;
    for (int i = 0; i < 6 + NP; ++i) atomicAdd(row + o++, dot3(WL[i], y));
    if (a.bj) {
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) atomicAdd(row + o++, dot3(WL[i], WL[j]));
    } else {
      for (int i = 0; i < 6; ++i) atomicAdd(row + o++, dot3(WL[i], WL[i]));
    }
    for (int m = 6; m < 6 + NP; ++m) atomicAdd(row + o++, dot3(WL[m], WL[m]));
  }
}

// ---------------------------------------------------------------------------
// K1b: Schur correction S_corr += EL EL^T, one warp per point.
//
// Replaces the ELb construction + MXU product of _fused_schur_kernel.
// A point's column block of EL has one 6x3 block per distinct observing
// image and one NPx3 block per distinct camera: the warp sums the WL
// blocks of slots that share an image (or camera) in shared memory,
// rounds them to bf16 when schur_bf16 (as the TPU kernel rounds ELb),
// and adds every entry of the point's (6*ni + NP*nc)^2 outer product
// into S with a float atomic. Bound: the atomics into the 3.2 MB S (L2
// resident), ~2k per point at the headline; a tensor-core formulation
// is later work.
// ---------------------------------------------------------------------------

template <int NP>
__host__ __device__ constexpr int k1b_words_per_slot() {
  return 4 + 18 + 3 * NP;  // 4 int tables + merged WLp and WLc rows
}

template <int NP>
__global__ void k1_schur_kernel(K1Args a) {
  extern __shared__ float smem[];
  constexpr int kWLp = 18 + 2 * NP, kWLc = 36 + 2 * NP;
  const int K = a.K;
  const int wpb = blockDim.x >> 5;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pt = blockIdx.x * wpb + wid;
  if (pt >= a.Pp) return;  // whole warps only; no block barrier follows
  const int64_t O = (int64_t)a.Pp * K;
  const int64_t base = (int64_t)(pt / a.TP) * a.TP * K + pt % a.TP;
  int* gimg = reinterpret_cast<int*>(smem + wid * K * k1b_words_per_slot<NP>());
  int* gcam = gimg + K;
  int* sgrp = gcam + K;
  int* scg = sgrp + K;
  float* elp = reinterpret_cast<float*>(scg + K);
  float* elc = elp + 18 * K;

  int ni = 0, nc = 0;
  if (lane == 0) {
    for (int s = 0; s < K; ++s) {
      const int64_t c = base + (int64_t)s * a.TP;
      sgrp[s] = scg[s] = -1;
      if (a.obs_sta[2 * O + c] == 0.f) continue;
      const int n = a.obs_img[c], cam = a.obs_cam[c];
      int gi = 0;
      while (gi < ni && gimg[gi] != n) ++gi;
      if (gi == ni) gimg[ni++] = n;
      sgrp[s] = gi;
      int gc = 0;
      while (gc < nc && gcam[gc] != cam) ++gc;
      if (gc == nc) gcam[nc++] = cam;
      scg[s] = gc;
    }
  }
  ni = __shfl_sync(0xffffffffu, ni, 0);
  nc = __shfl_sync(0xffffffffu, nc, 0);
  __syncwarp();
  for (int e = lane; e < 18 * ni + 3 * NP * nc; e += 32) {
    const bool pose = e < 18 * ni;
    const int gidx = pose ? e / 18 : (e - 18 * ni) / (3 * NP);
    const int r = pose ? e % 18 : (e - 18 * ni) % (3 * NP);
    const int* grp = pose ? sgrp : scg;
    const int row = (pose ? kWLp : kWLc) + r;
    float v = 0.f;
    for (int s = 0; s < K; ++s)
      if (grp[s] == gidx) v += a.jw[row * O + base + (int64_t)s * a.TP];
    if (a.schur_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    if (pose) elp[e] = v; else elc[e - 18 * ni] = v;
  }
  __syncwarp();
  const int nr = 6 * ni + NP * nc;
  for (int e = lane; e < nr * nr; e += 32) {
    int rr[2] = {e / nr, e % nr};
    const float* vec[2];
    int64_t R[2];
    for (int q = 0; q < 2; ++q) {
      const int r = rr[q];
      if (r < 6 * ni) {
        vec[q] = elp + (r / 6) * 18 + (r % 6) * 3;
        R[q] = (int64_t)(r % 6) * a.Npad + gimg[r / 6];
      } else {
        const int rc = r - 6 * ni;
        vec[q] = elc + (rc / NP) * 3 * NP + (rc % NP) * 3;
        R[q] = 6LL * a.Npad + (int64_t)(rc % NP) * a.C + gcam[rc / NP];
      }
    }
    atomicAdd(a.S + R[0] * a.Dk + R[1],
              vec[0][0] * vec[1][0] + vec[0][1] * vec[1][1] +
                  vec[0][2] * vec[1][2]);
  }
}

template <int M>
cudaError_t launch_fused_schur(const K1Args& a, cudaStream_t stream) {
  constexpr int NP = Head<M>::NP;
  k1_linearize_kernel<M, false><<<(a.Pp + kThreads - 1) / kThreads,
                                  kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t per_warp = (size_t)a.K * k1b_words_per_slot<NP>() * 4;
  int wpb = 4;
  while (wpb > 1 && per_warp * wpb > (size_t)kMaxSmem) --wpb;
  const size_t smem = per_warp * wpb;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(k1_schur_kernel<NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  k1_schur_kernel<NP><<<(a.Pp + wpb - 1) / wpb, 32 * wpb, smem, stream>>>(a);
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

struct K3Args {
  int TP, K, Pp, Npad, C;
  const float *du_pose_t, *du_cam_t;
  const void* jcorr;
  const float* obs_sta;
  const int *obs_img, *obs_cam;
  float* out;
};

template <typename T> __device__ inline float widen(T v);
template <> __device__ inline float widen<float>(float v) { return v; }
template <> __device__ inline float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
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
// K4: back-substitution + predicted-reduction sums, one thread per point.
//
// Replaces backsub (_backsub_kernel): dp = -Hpp^-1 g_p - Lp (EL^T du),
// masked by the free points, and the sums ||J d||^2, g_p.dp and
// lam D dp^2. On the TPU the cross-block sums ride a sequential grid;
// here each block reduces in shared memory and adds its three partial
// sums atomically. Bound: device memory (one read of jw's Jacobian and
// WL rows per observation); du is gathered per observation from the
// small [6, Npad] / [12, C] tables, which stay cache resident.
// ---------------------------------------------------------------------------

struct K4Args {
  int TP, K, Pp, Npad, C;
  const float *lam, *du_pose_t, *du_cam_t, *pt_pay, *jw, *obs_sta;
  const int *obs_img, *obs_cam;
  float *dp, *acc;
};

template <int NP>
__global__ void __launch_bounds__(kThreads) k4_backsub_kernel(K4Args a) {
  constexpr int kJk = 18, kWLp = 18 + 2 * NP, kWLc = 36 + 2 * NP;
  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  float sums[3] = {0.f, 0.f, 0.f};
  if (pt < a.Pp) {
    const int64_t O = (int64_t)a.Pp * a.K;
    const int64_t base = (int64_t)(pt / a.TP) * a.TP * a.K + pt % a.TP;
    float etu[3] = {0.f, 0.f, 0.f};
    for (int s = 0; s < a.K; ++s) {
      const int64_t c = base + (int64_t)s * a.TP;
      if (a.obs_sta[2 * O + c] == 0.f) continue;
      const int n = a.obs_img[c], cam = a.obs_cam[c];
      for (int j = 0; j < 3; ++j) {
        float v = 0.f;
        for (int i = 0; i < 6; ++i)
          v += a.jw[(kWLp + i * 3 + j) * O + c] * a.du_pose_t[i * a.Npad + n];
        for (int m = 0; m < NP; ++m)
          v += a.jw[(kWLc + m * 3 + j) * O + c] * a.du_cam_t[m * a.C + cam];
        etu[j] += v;
      }
    }
    const float* pp = a.pt_pay + pt;
    float g[3], hd[3], hi[6], L[6];
    for (int j = 0; j < 3; ++j) g[j] = pp[j * a.Pp];
    for (int j = 0; j < 3; ++j) hd[j] = pp[(3 + j) * a.Pp];
    for (int j = 0; j < 6; ++j) hi[j] = pp[(6 + j) * a.Pp];
    for (int j = 0; j < 6; ++j) L[j] = pp[(12 + j) * a.Pp];
    const float fp = pp[18 * a.Pp];
    const float him[3][3] = {{hi[0], hi[1], hi[2]},
                             {hi[1], hi[3], hi[4]},
                             {hi[2], hi[4], hi[5]}};
    const float lpm[3][3] = {{L[0], 0.f, 0.f},
                             {L[1], L[3], 0.f},
                             {L[2], L[4], L[5]}};
    float dp[3];
    for (int j = 0; j < 3; ++j) {
      float v = -(him[j][0] * g[0] + him[j][1] * g[1] + him[j][2] * g[2]);
      for (int i = 0; i <= j; ++i) v -= lpm[j][i] * etu[i];
      dp[j] = v * fp;
      a.dp[j * a.Pp + pt] = dp[j];
    }
    for (int s = 0; s < a.K; ++s) {
      const int64_t c = base + (int64_t)s * a.TP;
      if (a.obs_sta[2 * O + c] == 0.f) continue;
      const int n = a.obs_img[c], cam = a.obs_cam[c];
      for (int kk = 0; kk < 2; ++kk) {
        float t = 0.f;
        for (int i = 0; i < 6; ++i)
          t += a.jw[(kk * 6 + i) * O + c] * a.du_pose_t[i * a.Npad + n];
        for (int m = 0; m < NP; ++m)
          t += a.jw[(kJk + kk * NP + m) * O + c] * a.du_cam_t[m * a.C + cam];
        for (int j = 0; j < 3; ++j) t += a.jw[(12 + kk * 3 + j) * O + c] * dp[j];
        sums[0] += t * t;
      }
    }
    const float lam = *a.lam;
    for (int j = 0; j < 3; ++j) {
      sums[1] += g[j] * dp[j];
      sums[2] += lam * clampf(hd[j], 1e-6f, 1e32f) * dp[j] * dp[j];
    }
  }
  block_atomic_add<3>(sums, a.acc);
}

// ---------------------------------------------------------------------------
// K5: robust cost at trial parameters, one thread per observation lane.
//
// Replaces fused_cost (_cost_kernel): sum of 1/2 mask rho(||r||^2).
// Block partial sums are added atomically (the TPU kernel accumulates
// over a sequential grid). Bound: device memory, one read of the
// observation rows and points; the per-image parameters are gathered
// from the small [7+np, Npad] table.
// ---------------------------------------------------------------------------

struct K5Args {
  int loss, TP, K, Pp, Npad;
  float a2;
  const float *par, *pts, *obs_sta;
  const int* obs_img;
  float* acc;
};

template <int M>
__global__ void __launch_bounds__(kThreads) k5_cost_kernel(K5Args a) {
  constexpr int NP = Head<M>::NP;
  const int64_t O = (int64_t)a.Pp * a.K;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float val[1] = {0.f};
  if (c < O) {
    const float mask = a.obs_sta[2 * O + c];
    if (mask != 0.f) {
      const int64_t blk = (int64_t)a.TP * a.K;
      const int pt = (int)((c / blk) * a.TP + c % a.TP);
      const int n = a.obs_img[c];
      float R[3][3], t[3], k[NP];
      load_pose(a.par, a.Npad, n, R, t);
      for (int m = 0; m < NP; ++m) k[m] = a.par[(7 + m) * a.Npad + n];
      const float x[3] = {a.pts[pt], a.pts[a.Pp + pt], a.pts[2 * a.Pp + pt]};
      float u, v, px, py;
      camera_uv(R, t, x, u, v);
      Head<M>::project(k, u, v, px, py);
      const float r0 = px - a.obs_sta[c], r1 = py - a.obs_sta[O + c];
      val[0] = 0.5f * mask * loss_value(a.loss, r0 * r0 + r1 * r1, a.a2);
    }
  }
  block_atomic_add<1>(val, a.acc);
}

}  // namespace

extern "C" {

const char* sba_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int sba_fused_schur(int model, int loss, float loss_scale, int schur_bf16,
                    int TP, int K, int Pp, int Npad, int C, int Dk,
                    const float* lam, const float* par, const float* free_sta,
                    const float* pts, const float* free_pts,
                    const float* obs_sta, const int* obs_img,
                    const int* obs_cam, float* S, float* img_red, float* ey,
                    float* pt_pay, float* jw, cudaStream_t stream) {
  const K1Args a{loss, schur_bf16, TP, K, Pp, Npad, C, Dk, 0, 0,
                 loss_scale * loss_scale, lam, par, free_sta, pts, free_pts,
                 obs_sta, obs_img, obs_cam, S, img_red, ey, pt_pay, jw,
                 nullptr};
  switch (model) {
    case 0: return launch_fused_schur<0>(a, stream);
    case 1: return launch_fused_schur<1>(a, stream);
    case 2: return launch_fused_schur<2>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int sba_fused_reduce(int model, int loss, float loss_scale, int bj,
                     int jcorr_bf16, int TP, int K, int Pp, int Npad, int C,
                     const float* lam, const float* par,
                     const float* free_sta, const float* pts,
                     const float* free_pts, const float* obs_sta,
                     const int* obs_img, const int* obs_cam, float* img_red,
                     float* pt_pay, float* jw, void* jcorr,
                     cudaStream_t stream) {
  const K1Args a{loss, 0, TP, K, Pp, Npad, C, 0, bj, jcorr_bf16,
                 loss_scale * loss_scale, lam, par, free_sta, pts, free_pts,
                 obs_sta, obs_img, obs_cam, nullptr, img_red, nullptr,
                 pt_pay, jw, jcorr};
  const int blocks = (Pp + kThreads - 1) / kThreads;
  switch (model) {
    case 0: k1_linearize_kernel<0, true><<<blocks, kThreads, 0, stream>>>(a); break;
    case 1: k1_linearize_kernel<1, true><<<blocks, kThreads, 0, stream>>>(a); break;
    case 2: k1_linearize_kernel<2, true><<<blocks, kThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int sba_schur_matvec(int model, int jcorr_bf16, int TP, int K, int Pp,
                     int Npad, int C, const float* du_pose_t,
                     const float* du_cam_t, const void* jcorr,
                     const float* obs_sta, const int* obs_img,
                     const int* obs_cam, float* out, cudaStream_t stream) {
  const K3Args a{TP, K, Pp, Npad, C, du_pose_t, du_cam_t, jcorr,
                 obs_sta, obs_img, obs_cam, out};
  switch (model) {
    case 0: return launch_schur_matvec<3>(a, jcorr_bf16, stream);
    case 1:
    case 2: return launch_schur_matvec<4>(a, jcorr_bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

int sba_backsub(int model, int TP, int K, int Pp, int Npad, int C,
                const float* lam, const float* du_pose_t,
                const float* du_cam_t, const float* pt_pay, const float* jw,
                const float* obs_sta, const int* obs_img, const int* obs_cam,
                float* dp, float* acc, cudaStream_t stream) {
  const K4Args a{TP, K, Pp, Npad, C, lam, du_pose_t, du_cam_t, pt_pay, jw,
                 obs_sta, obs_img, obs_cam, dp, acc};
  const int blocks = (Pp + kThreads - 1) / kThreads;
  switch (model) {
    case 0: k4_backsub_kernel<3><<<blocks, kThreads, 0, stream>>>(a); break;
    case 1:
    case 2: k4_backsub_kernel<4><<<blocks, kThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int sba_fused_cost(int model, int loss, float loss_scale, int TP, int K,
                   int Pp, int Npad, const float* par, const float* pts,
                   const float* obs_sta, const int* obs_img, float* acc,
                   cudaStream_t stream) {
  const K5Args a{loss, TP, K, Pp, Npad, loss_scale * loss_scale, par, pts,
                 obs_sta, obs_img, acc};
  const int64_t O = (int64_t)Pp * K;
  const int blocks = (int)((O + kThreads - 1) / kThreads);
  switch (model) {
    case 0: k5_cost_kernel<0><<<blocks, kThreads, 0, stream>>>(a); break;
    case 1: k5_cost_kernel<1><<<blocks, kThreads, 0, stream>>>(a); break;
    case 2: k5_cost_kernel<2><<<blocks, kThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
