// PatchMatch stereo kernel for Hopper (sm_90a), plain C interface.
//
// K6 sba_ncc_cost replaces the Pallas TPU kernel
// sba_tpu/mvs/patch_match.py::_ncc_kernel_call: the bilateral-weighted
// NCC between the reference image and the once-warped source images,
// over the window offsets (dx, dy) of _window_offsets(r, step), for all
// S sources in one launch.
//
// Per pixel and source, with ref_c the centre value and tap k at
// (x+dx, y+dy):
//   w_k  = w_sp[k] * [tap inside the image] * exp(-(ref_k-ref_c)^2 * inv2sc2)
//   SW, SR, SRR, SV, SVV, SRV = sums of w, w r, w r r, w v, w v v, w r v
//   FIN  = sum of w_sp[k] * inb_k
//   cost = 1 - clip(cov * rsqrt(max(vr * vs, 1e-10)), -1, 1), or 2.0
//          where FIN <= fin_min (half the window's spatial weight).
//
// What bounds it: operations, not bytes. One launch at 1600x1200 with
// S = 4 and r = 3 moves ~77 MB (0.023 ms at 3.35 TB/s). The function
// needs, per tap, 11 operations that depend on the reference alone
// (expf counted as one, a fused multiply-add as two) and 8 per source:
// ~4.2 GFLOP, 0.062 ms at 67 TFLOP/s. On this card every instruction,
// load and integer test included, takes an issue slot that a float
// operation could have had, so the design removes instructions:
//
// - One block owns a 32x32 output tile for every source. It stages the
//   reference with an r-pixel halo once, and the sources a chunk of
//   kSrc at a time (their in-bounds masks packed as one bit each). Each
//   (pixel, tap) weight and the three reference moments are computed
//   once per chunk and applied to every source of it from registers:
//   the reference half of a tap costs once per pixel, not once per
//   source (S <= kSrc), and one pass in kSrc otherwise.
// - Each thread owns a strip of kRows output rows of one column and
//   walks the kRows + 2r window rows of the strip once: a value loaded
//   from shared memory serves every output row of the strip whose
//   window contains it (about n*kRows/(kRows+2r) times fewer loads).
// - Interior tiles, whose windows lie inside the image, take a variant
//   without the bounds test; border tiles keep it.
// - The staging of a tile issues each thread's loads for kStage cells
//   before it stores any of them.
//
// What is left is issue: at S = 4 a (pixel, tap) costs ~60 issued
// instructions, ~48 of them the float work that the twin's rounding
// fixes (the accurate expf alone is 8: four FFMA, a MUFU.EX2, an FADD,
// a shift and an FMUL; the moment sums cannot be contracted), the rest
// loads, addressing and the per-row tests. The sums of the 4 x 4
// (row, source) pairs fill the register file (128 registers, two blocks
// per SM, no spills). The epilogue's IEEE divisions are the other cost
// (~8% of the time on an H100); a zero sum, as a source that the window
// never sees gives, is its own quotient and skips the division.
//
// The output is bit-equal to the plain twin (sba_tpu_torch/ops/
// patch_match_kernels.py::ncc_cost_plain), as it must be: vr = SRR/wsum
// - mr^2 cancels in flat windows, so two roundings of one window can
// give very different NCC there. Each accumulator is summed in tap order
// (dy outer, dx inner), the library is built with -fmad=false so
// products are rounded before they are added, expf is the accurate one,
// and on interior tiles w_sp*1.0 is exact. The spatial weights are
// computed in double and rounded to float, as the twin's (numpy float64)
// are, so FIN, a tap-order sum of those weights, is bit-identical to the
// twin's and the >half gate decides the same pixels even at exact
// halves (window_step > 1 skips the centre tap, so a window can lie
// exactly half outside). A masked tap adds +0.0f to FIN, which leaves a
// sum that started at +0.0f unchanged, as the twin's w_sp*0 does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;              // threads along x = tile width
constexpr int kTY = 8;               // threads along y
constexpr int kRows = 4;             // output rows per thread (its strip)
constexpr int kTileH = kTY * kRows;  // tile height
constexpr int kSrc = 4;              // sources staged per chunk
constexpr int kStage = 2;            // cells a thread stages per round
constexpr int kMaxSmem = 232448;     // 227 KB opt-in dynamic shared memory

struct NccArgs {
  int H, W, S, r, step, n;   // n taps per axis, K = n * n
  double sigma_spatial;
  float inv2sc2, fin_min;
  const float* ref;          // [H, W]
  const float* v;            // [S, H, W]
  const uint8_t* inb;        // [S, H, W], 0 or 1
  float* cost;               // [S, H, W]
};

__host__ __device__ inline int halo_w(int r) { return kTX + 2 * r; }
__host__ __device__ inline int halo_h(int r) { return kTileH + 2 * r; }

// ref and kSrc source planes (f32), the spatial weights, the packed
// masks (u8, bit s for source s of the chunk).
inline size_t smem_bytes(int r, int n) {
  const size_t cells = static_cast<size_t>(halo_w(r)) * halo_h(r);
  return cells * (1 + kSrc) * sizeof(float) +
         static_cast<size_t>(n) * n * sizeof(float) + cells;
}

// Whether halo cell i (< cells) of the tile at (x0, y0) lies inside the
// image, and if so its index g into an image plane.
__device__ inline bool cell_in(const NccArgs& a, int i, int cells, int hw,
                               int x0, int y0, size_t& g) {
  const int ly = i / hw, lx = i - ly * hw;
  const int gy = y0 - a.r + ly, gx = x0 - a.r + lx;
  const bool in = i < cells && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
  g = in ? static_cast<size_t>(gy) * a.W + gx : 0;
  return in;
}

// x / w for w > 0; a zero x is its own quotient, and skips the
// division's slow path (zero sums: sources masked over the window).
__device__ __forceinline__ float div_w(float x, float w) {
  return x == 0.0f ? x : x / w;
}

struct Tile {
  const float* s_ref;
  const float* s_v;          // kSrc planes of `cells`
  const float* s_wsp;
  const uint8_t* s_bits;
  int cells, hw, x0, y0, s0;
};

// The tile's outputs for sources s0 .. s0+NS-1. kBorder: some window of
// the tile reaches outside the image, so each tap tests its position.
template <int NS, bool kBorder>
__device__ void ncc_tile(const NccArgs& a, const Tile& t) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = t.x0 + tx;
  const int ys = t.y0 + ty * kRows;            // the strip's first row
  const int r = a.r, step = a.step, n = a.n;

  float refc[kRows];
  float SW[kRows], SR[kRows], SRR[kRows];
  float SV[kRows][NS], SVV[kRows][NS], SRV[kRows][NS], FIN[kRows][NS];
  int next[kRows], wrow[kRows];   // next window row of output row j, and
                                  // its offset iy*n into the weights
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    refc[j] = t.s_ref[(ty * kRows + j + r) * t.hw + tx + r];
    SW[j] = SR[j] = SRR[j] = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      SV[j][s] = SVV[j][s] = SRV[j][s] = FIN[j][s] = 0.f;
    next[j] = j;
    wrow[j] = 0;
  }
  const int wend = 2 * r;          // last window row offset (dy = r)

  // Window row m of the strip (halo row ty*kRows + m) is row dy =
  // m - j - r of output row j; rows are visited in increasing m, so each
  // output row meets its taps in the twin's order (dy outer, dx inner).
  for (int m = 0; m < kRows + 2 * r; ++m) {
    bool use[kRows];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      use[j] = m == next[j] && m - j <= wend;
      any |= use[j];
    }
    if (any) {
      const int row = (ty * kRows + m) * t.hw + tx;
      bool row_in = true;
      if (kBorder) {
        const int gy = ys - r + m;
        row_in = gy >= 0 && gy < a.H;
      }
      for (int ix = 0; ix < n; ++ix) {
        const int c = row + ix * step;
        const float r_k = t.s_ref[c];
        float v_k[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) v_k[s] = t.s_v[s * t.cells + c];
        const unsigned bits = t.s_bits[c];
        float inside = 1.0f;
        if (kBorder) {
          const int gx = x - r + ix * step;
          inside = row_in && gx >= 0 && gx < a.W ? 1.0f : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (!use[j]) continue;
          const float wsp = t.s_wsp[wrow[j] + ix];
          const float d = r_k - refc[j];
          const float e = expf(-(d * d) * a.inv2sc2);
          const float w = kBorder ? (wsp * inside) * e : wsp * e;
          const float wr = w * r_k;
          SW[j] += w;
          SR[j] += wr;
          SRR[j] += wr * r_k;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float wv = w * v_k[s];
            SV[j][s] += wv;
            SVV[j][s] += wv * v_k[s];
            SRV[j][s] += wr * v_k[s];
            FIN[j][s] += (bits >> s) & 1u ? wsp : 0.0f;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (use[j]) {
        next[j] += step;
        wrow[j] += n;
      }
    }
  }

  const size_t plane = static_cast<size_t>(a.H) * a.W;
  if (x >= a.W) return;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = ys + j;
    if (y >= a.H) return;
    const float wsum = fmaxf(SW[j], 1e-9f);
    const float mr = div_w(SR[j], wsum);
    const float vr = div_w(SRR[j], wsum) - mr * mr;
    float* out = a.cost + static_cast<size_t>(t.s0) * plane +
                 static_cast<size_t>(y) * a.W + x;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float ms = div_w(SV[j][s], wsum);
      const float vs = div_w(SVV[j][s], wsum) - ms * ms;
      const float cov = div_w(SRV[j][s], wsum) - mr * ms;
      const float ncc = cov * rsqrtf(fmaxf(vr * vs, 1e-10f));
      const float cost = 1.0f - fminf(fmaxf(ncc, -1.0f), 1.0f);
      out[s * plane] = FIN[j][s] > a.fin_min ? cost : 2.0f;
    }
  }
}

template <int NS>
__device__ inline void ncc_chunk(const NccArgs& a, const Tile& t,
                                 bool interior) {
  if (interior)
    ncc_tile<NS, false>(a, t);
  else
    ncc_tile<NS, true>(a, t);
}

__global__ void __launch_bounds__(kTX * kTY, 2)
k6_ncc_kernel(NccArgs a) {
  extern __shared__ float smem[];
  const int hw = halo_w(a.r), hh = halo_h(a.r), cells = hw * hh;
  const int K = a.n * a.n;
  float* s_ref = smem;
  float* s_v = s_ref + cells;
  float* s_wsp = s_v + kSrc * cells;
  uint8_t* s_bits = reinterpret_cast<uint8_t*>(s_wsp + K);

  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  constexpr int nt = kTX * kTY;

  // Stage the reference tile and its halo; outside the image: 0 (the
  // twin's zero padding). Each round a thread issues the loads of
  // kStage cells before it stores any, so a round costs one trip to
  // device memory.
  for (int i0 = tid; i0 < cells; i0 += nt * kStage) {
    float val[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      size_t g;
      val[u] = cell_in(a, i0 + u * nt, cells, hw, x0, y0, g)
                   ? __ldg(a.ref + g) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (i0 + u * nt < cells) s_ref[i0 + u * nt] = val[u];
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
  const bool interior = x0 - a.r >= 0 && x0 + kTX + a.r <= a.W &&
                        y0 - a.r >= 0 && y0 + kTileH + a.r <= a.H;

  for (int s0 = 0; s0 < a.S; s0 += kSrc) {
    const int ns = min(kSrc, a.S - s0);
    __syncthreads();             // the previous chunk's reads are done
    for (int i0 = tid; i0 < cells; i0 += nt * kStage) {
      float val[kStage][kSrc];
      unsigned bits[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        size_t g;
        const bool in = cell_in(a, i0 + u * nt, cells, hw, x0, y0, g);
        bits[u] = 0;
#pragma unroll
        for (int s = 0; s < kSrc; ++s) {
          const bool ok = in && s < ns;
          const size_t o = static_cast<size_t>(s0 + s) * plane + g;
          val[u][s] = ok ? __ldg(a.v + o) : 0.0f;
          bits[u] |= ok && __ldg(a.inb + o) != 0 ? 1u << s : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * nt;
        if (i >= cells) continue;
#pragma unroll
        for (int s = 0; s < kSrc; ++s)
          if (s < ns) s_v[s * cells + i] = val[u][s];
        s_bits[i] = static_cast<uint8_t>(bits[u]);
      }
    }
    __syncthreads();
    const Tile t{s_ref, s_v, s_wsp, s_bits, cells, hw, x0, y0, s0};
    switch (ns) {
      case 1: ncc_chunk<1>(a, t, interior); break;
      case 2: ncc_chunk<2>(a, t, interior); break;
      case 3: ncc_chunk<3>(a, t, interior); break;
      default: ncc_chunk<kSrc>(a, t, interior); break;
    }
  }
}

}  // namespace

extern "C" {

int sba_ncc_cost(int H, int W, int S, int r, int step, double sigma_spatial,
                 float inv2sc2, float fin_min, const float* ref,
                 const float* v, const uint8_t* inb, float* cost,
                 cudaStream_t stream) {
  if (H <= 0 || W <= 0 || S <= 0 || r < 0 || step <= 0)
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
  const NccArgs a{H, W, S, r, step, n, sigma_spatial, inv2sc2, fin_min,
                  ref, v, inb, cost};
  const dim3 grid((W + kTX - 1) / kTX, (H + kTileH - 1) / kTileH);
  k6_ncc_kernel<<<grid, dim3(kTX, kTY), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
