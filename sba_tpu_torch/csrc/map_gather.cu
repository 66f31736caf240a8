// Map-gather kernels of semantic bundle adjustment for Hopper (sm_90a),
// plain C interface.
//
// sba_map_gather replaces the three Pallas TPU probes of one function,
//   out[k] = T[base(k) + i[k]],
// benchmarks/gather_micro.py::f4 (kernel `kern`: flat take from the
// VMEM-resident map), ::f4b (kernel `kern4b`: the map as [HW/128, 128],
// row gather then lane pick) and benchmarks/gather_micro2.py::fE
// (kernel `kernE`: flat take from the [HW/128, 128] view). The three
// differ only in how the TPU lays one map into VMEM; here the table is
// a flat array of 4-byte words (u32 packed neighbourhoods, f32 maps) or
// 8-byte words (f64 maps), and each sample is one load through the
// read-only path. base(k) = (k / per) * hw in the probes' form (per
// samples of each map, hw words per map, indices local to their map);
// per = 0 is the path's form, where the indices are already flat.
//
// sba_map_gather_pair replaces benchmarks/gather_micro2.py::fD (kernel
// `kernD`): depth and label words interleaved per pixel, [K, 2] 4-byte
// words, one 8-byte load (uint2) per sample yields both. The probes'
// epilogue returns their u32 sum, as kernD does; the path's returns both
// words (the two-map SBA sampler).
//
// The TPU kernels keep one map resident in VMEM per grid step and pick
// lanes with one-hot selects; neither carries over. A map of 640x480 u32
// words is 1.2 MB and all 50 maps (61 MB) nearly fit the 50 MB L2.
//
// What bounds it: bytes. Each sample reads its 4-byte index, one table
// word and writes one word: at the probes' shape (50 maps of 640x480,
// 7,526,400 samples) 61.44 MB of table + 30.11 MB of indices + 30.11 MB
// out = 0.0363 ms at 3.35 TB/s, counting each table word once. A random
// index costs a 32-byte sector per 4-byte word, so the kernel moves up
// to 8x the table bytes it uses through L2; the samples of one SBA pair
// land in a small window of one map, which is where the reuse comes from.
//
// Both kernels: one sample per thread, 256 threads a block, blocks in
// sample order, so that the blocks an SM holds at once gather from one
// map. Their index loads and output stores stream past the caches
// (evict-first), leaving L2 to the maps. The time is set by the rate at
// which an SM issues divergent requests, one per random sample, on top
// of the maps' sectors from device memory: B3 at the probes' shape takes
// about as long with every sample in one L2-resident map as with its
// indices sorted (no divergence), and longer with both at once. The
// designs tried against it (sorted samples, a persistent grid, vector
// loads, cache policies, a cluster-held map) are in PERF.md §6.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// out[k] = table[base(k) + idx[k]], one sample per thread.
template <typename Word>
__global__ void __launch_bounds__(kThreads) b_map_gather_kernel(
    const Word* __restrict__ table, const int32_t* __restrict__ idx,
    Word* __restrict__ out, int64_t n, int64_t per, int64_t hw) {
  const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const int64_t base = per > 0 ? (k / per) * hw : 0;
  __stcs(out + k, __ldg(table + base + __ldcs(idx + k)));
}

__global__ void __launch_bounds__(kThreads) b_map_gather_pair_kernel(
    const uint2* __restrict__ table, const int32_t* __restrict__ idx,
    uint2* __restrict__ out_pair, uint32_t* __restrict__ out_sum, int64_t n,
    int64_t per, int64_t hw) {
  const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const int64_t base = per > 0 ? (k / per) * hw : 0;
  const uint2 w = __ldg(table + base + __ldcs(idx + k));
  if (out_sum != nullptr) {
    __stcs(out_sum + k, w.x + w.y);
  } else {
    __stcs(out_pair + k, w);
  }
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// word_bytes 4 or 8; table, idx and out device pointers; n samples.
int sba_map_gather(int word_bytes, long long n, long long per, long long hw,
                   const void* table, const int32_t* idx, void* out,
                   cudaStream_t stream) {
  if (n <= 0 || per < 0 || hw < 0 || blocks_for(n) > 0x7fffffffu)
    return cudaErrorInvalidValue;
  if (word_bytes == 4) {
    b_map_gather_kernel<uint32_t><<<blocks_for(n), kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(table), idx,
        static_cast<uint32_t*>(out), n, per, hw);
  } else if (word_bytes == 8) {
    b_map_gather_kernel<unsigned long long>
        <<<blocks_for(n), kThreads, 0, stream>>>(
            static_cast<const unsigned long long*>(table), idx,
            static_cast<unsigned long long*>(out), n, per, hw);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// table [K, 2] 4-byte words, 8-byte aligned; out [n, 2] words, or [n]
// u32 sums when sum != 0.
int sba_map_gather_pair(long long n, long long per, long long hw, int sum,
                        const void* table, const int32_t* idx, void* out,
                        cudaStream_t stream) {
  if (n <= 0 || per < 0 || hw < 0 || blocks_for(n) > 0x7fffffffu)
    return cudaErrorInvalidValue;
  b_map_gather_pair_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const uint2*>(table), idx,
      sum ? nullptr : static_cast<uint2*>(out),
      sum ? static_cast<uint32_t*>(out) : nullptr, n, per, hw);
  return cudaGetLastError();
}

}  // extern "C"
