// PatchMatch stereo kernel for Hopper (sm_90a), plain C interface.
//
// K6 sba_ncc_cost replaces the Pallas TPU kernel
// sba_tpu/mvs/patch_match.py::_ncc_kernel_call: the bilateral-weighted
// NCC between the reference image and the once-warped source images,
// over the window offsets (dx, dy) of _window_offsets(r, step), for all
// S sources in one launch (grid.z = S, the reference plane shared).
//
// Per pixel and source, with ref_c the centre value and tap k at
// (x+dx, y+dy):
//   w_k  = w_sp[k] * [tap inside the image] * exp(-(ref_k-ref_c)^2 * inv2sc2)
//   SW, SR, SRR, SV, SVV, SRV = sums of w, w r, w r r, w v, w v v, w r v
//   FIN  = sum of w_sp[k] * inb_k
//   cost = 1 - clip(cov * rsqrt(max(vr * vs, 1e-10)), -1, 1), or 2.0
//          where FIN <= fin_min (half the window's spatial weight).
//
// The TPU kernel works on zero-padded planes restacked into overlapping
// 32-row blocks so that they fit VMEM; here a block owns a 32x32 output
// tile and stages ref, v and inb with an r-pixel halo in shared memory,
// testing the image bounds by index instead of padding. Every tap then
// reads shared memory only: each input word is read from device memory
// about (1 + 2r/32)^2 times, the output written once.
//
// What bounds it: operations, not bytes. One launch at 1600x1200 with
// S = 4 and r = 3 moves ~77 MB (0.023 ms at 3.35 TB/s). The function
// needs, per tap, 11 operations that depend on the reference alone
// (expf counted as one, a fused multiply-add as two) and 8 per source:
// ~4.2 GFLOP, 0.062 ms at 67 TFLOP/s. This kernel recomputes the
// reference-only part in every source's blocks (S times over): simple
// first, shared across sources in a later change.
//
// Arithmetic follows the plain twin (sba_tpu_torch/ops/
// patch_match_kernels.py::ncc_cost_plain) operation for operation; the
// library is built with -fmad=false, so products are rounded before they
// are added, as in the twin. The spatial weights are computed in double
// and rounded to float, as the twin's (numpy float64) are, so FIN, a sum
// of those weights, is bit-identical to the twin's and the >half gate
// decides the same pixels even at exact halves (window_step > 1 skips
// the centre tap, so a window can lie exactly half outside).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;              // threads along x = tile width
constexpr int kTY = 8;               // threads along y
constexpr int kRowsPerThread = 4;    // tile height kTY * kRowsPerThread
constexpr int kTileH = kTY * kRowsPerThread;
constexpr int kMaxSmem = 232448;     // 227 KB opt-in dynamic shared memory

struct NccArgs {
  int H, W, r, step, n;      // n taps per axis, K = n * n
  double sigma_spatial;
  float inv2sc2, fin_min;
  const float* ref;          // [H, W]
  const float* v;            // [S, H, W]
  const uint8_t* inb;        // [S, H, W], 0 or 1
  float* cost;               // [S, H, W]
};

__host__ __device__ inline int halo_w(int r) { return kTX + 2 * r; }
__host__ __device__ inline int halo_h(int r) { return kTileH + 2 * r; }

inline size_t smem_bytes(int r, int n) {
  const size_t cells = static_cast<size_t>(halo_w(r)) * halo_h(r);
  return cells * 2 * sizeof(float) + static_cast<size_t>(n) * n *
         sizeof(float) + cells;
}

__global__ void __launch_bounds__(kTX * kTY)
k6_ncc_kernel(NccArgs a) {
  extern __shared__ float smem[];
  const int hw = halo_w(a.r), hh = halo_h(a.r), cells = hw * hh;
  const int K = a.n * a.n;
  float* s_ref = smem;
  float* s_v = s_ref + cells;
  float* s_wsp = s_v + cells;
  uint8_t* s_inb = reinterpret_cast<uint8_t*>(s_wsp + K);

  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const float* v = a.v + s * plane;
  const uint8_t* inb = a.inb + s * plane;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  constexpr int nt = kTX * kTY;

  // Stage the tile and its halo; outside the image: 0 (the twin's
  // zero padding).
  for (int i = tid; i < cells; i += nt) {
    const int ly = i / hw, lx = i - ly * hw;
    const int gy = y0 - a.r + ly, gx = x0 - a.r + lx;
    const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    const size_t g = in ? static_cast<size_t>(gy) * a.W + gx : 0;
    s_ref[i] = in ? a.ref[g] : 0.0f;
    s_v[i] = in ? v[g] : 0.0f;
    s_inb[i] = in ? inb[g] : 0;
  }
  // Spatial weights exp(-(dx^2 + dy^2) / (2 sigma_s^2)) in double,
  // rounded to float, k = iy * n + ix (dy outer, dx inner).
  for (int k = tid; k < K; k += nt) {
    const int dy = -a.r + (k / a.n) * a.step;
    const int dx = -a.r + (k % a.n) * a.step;
    const double ss2 = a.sigma_spatial * a.sigma_spatial;
    s_wsp[k] = static_cast<float>(
        exp(static_cast<double>(-(dx * dx + dy * dy)) / (2.0 * ss2)));
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= a.W) return;
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int ly = threadIdx.y + j * kTY;
    const int y = y0 + ly;
    if (y >= a.H) return;
    const int c = (ly + a.r) * hw + threadIdx.x + a.r;   // centre cell
    const float refc = s_ref[c];
    float SW = 0.f, SR = 0.f, SRR = 0.f, SV = 0.f, SVV = 0.f, SRV = 0.f;
    float FIN = 0.f;
    int k = 0;
    for (int iy = 0; iy < a.n; ++iy) {
      const int dy = -a.r + iy * a.step;
      const bool row_in = y + dy >= 0 && y + dy < a.H;
      for (int ix = 0; ix < a.n; ++ix, ++k) {
        const int dx = -a.r + ix * a.step;
        const bool in = row_in && x + dx >= 0 && x + dx < a.W;
        const int t = c + dy * hw + dx;
        const float r_k = s_ref[t];
        const float v_k = s_v[t];
        const float wsp = s_wsp[k];
        const float d = r_k - refc;
        const float w = (wsp * (in ? 1.0f : 0.0f)) *
                        expf(-(d * d) * a.inv2sc2);
        const float wv = w * v_k;
        const float wr = w * r_k;
        SW += w;
        SR += wr;
        SRR += wr * r_k;
        SV += wv;
        SVV += wv * v_k;
        SRV += wr * v_k;
        FIN += wsp * static_cast<float>(s_inb[t]);
      }
    }
    const float wsum = fmaxf(SW, 1e-9f);
    const float mr = SR / wsum;
    const float vr = SRR / wsum - mr * mr;
    const float ms = SV / wsum;
    const float vs = SVV / wsum - ms * ms;
    const float cov = SRV / wsum - mr * ms;
    const float ncc = cov * rsqrtf(fmaxf(vr * vs, 1e-10f));
    const float cost = 1.0f - fminf(fmaxf(ncc, -1.0f), 1.0f);
    a.cost[s * plane + static_cast<size_t>(y) * a.W + x] =
        FIN > a.fin_min ? cost : 2.0f;
  }
}

}  // namespace

extern "C" {

int sba_ncc_cost(int H, int W, int S, int r, int step, double sigma_spatial,
                 float inv2sc2, float fin_min, const float* ref,
                 const float* v, const uint8_t* inb, float* cost,
                 cudaStream_t stream) {
  if (H <= 0 || W <= 0 || S <= 0 || r < 0 || step <= 0 || S > 65535)
    return cudaErrorInvalidValue;
  const int n = 2 * r / step + 1;
  const size_t smem = smem_bytes(r, n);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k6_ncc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const NccArgs a{H, W, r, step, n, sigma_spatial, inv2sc2, fin_min,
                  ref, v, inb, cost};
  const dim3 grid((W + kTX - 1) / kTX, (H + kTileH - 1) / kTileH, S);
  k6_ncc_kernel<<<grid, dim3(kTX, kTY), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
