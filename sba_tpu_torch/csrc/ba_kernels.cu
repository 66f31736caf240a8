// The plain C interface of the bundle-adjustment kernels (loaded with
// ctypes by sba_tpu_torch/ops/cuda_build.py): each entry point switches
// on the camera model id and calls that model's instantiation of the
// kernels of ba_kernels.cuh, built in ba_model<M>.cu. An unknown model
// id returns cudaErrorInvalidValue.

#define SBA_BA_DECLARATIONS_ONLY
#include "ba_kernels.cuh"

using namespace sba;

namespace {

// cases 0..10 of `switch (model)` calling FN<M>(ARGS).
#define SBA_MODEL_CASES(FN, ...)            \
  case 0: return FN<0>(__VA_ARGS__);       \
  case 1: return FN<1>(__VA_ARGS__);       \
  case 2: return FN<2>(__VA_ARGS__);       \
  case 3: return FN<3>(__VA_ARGS__);       \
  case 4: return FN<4>(__VA_ARGS__);       \
  case 5: return FN<5>(__VA_ARGS__);       \
  case 6: return FN<6>(__VA_ARGS__);       \
  case 7: return FN<7>(__VA_ARGS__);       \
  case 8: return FN<8>(__VA_ARGS__);       \
  case 9: return FN<9>(__VA_ARGS__);       \
  case 10: return FN<10>(__VA_ARGS__);     \
  default: return cudaErrorInvalidValue;

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
                    const int* obs_cam, const int* tiles, int n_groups,
                    int n_img_groups, int n_members, int n_units,
                    int n_pairs, int n_items, float* scratch, float* S,
                    float* img_red, float* ey, float* pt_pay, float* jw,
                    cudaStream_t stream) {
  const K1Args a{loss, schur_bf16, TP, K, Pp, Npad, C, Dk, 0, 0,
                 loss_scale * loss_scale, lam, par, free_sta, pts, free_pts,
                 obs_sta, obs_img, obs_cam, S, img_red, ey, pt_pay, jw,
                 nullptr};
  // The tile table's arrays, in SchurTiles.table order; the scratch's
  // split into group and unit blocks is the model's (sba::fused_schur).
  const int* grp_off = tiles + 2LL * n_items + 2LL * n_pairs;
  const int* unit_off = grp_off + n_groups + 1 + n_members;
  const TileArgs t{n_groups, n_img_groups, n_units, n_pairs,
                   reinterpret_cast<const int2*>(tiles),
                   reinterpret_cast<const int2*>(tiles + 2LL * n_items),
                   grp_off, grp_off + n_groups + 1, unit_off,
                   unit_off + n_units + 1, unit_off + 2 * n_units + 1,
                   scratch, nullptr};
  switch (model) { SBA_MODEL_CASES(sba::fused_schur, a, t, stream) }
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
  switch (model) { SBA_MODEL_CASES(sba::fused_reduce, a, stream) }
}

int sba_schur_matvec(int model, int jcorr_bf16, int TP, int K, int Pp,
                     int Npad, int C, const float* du_pose_t,
                     const float* du_cam_t, const void* jcorr,
                     const float* obs_sta, const int* obs_img,
                     const int* obs_cam, float* out, cudaStream_t stream) {
  const K3Args a{TP, K, Pp, Npad, C, du_pose_t, du_cam_t, jcorr,
                 obs_sta, obs_img, obs_cam, out};
  switch (model) { SBA_MODEL_CASES(sba::schur_matvec, a, jcorr_bf16, stream) }
}

int sba_backsub(int model, int TP, int K, int Pp, int Npad, int C,
                const float* lam, const float* du_pose_t,
                const float* du_cam_t, const float* pt_pay, const float* jw,
                const float* obs_sta, const int* obs_img, const int* obs_cam,
                float* dp, float* acc, cudaStream_t stream) {
  const K4Args a{TP, K, Pp, Npad, C, lam, du_pose_t, du_cam_t, pt_pay, jw,
                 obs_sta, obs_img, obs_cam, dp, acc};
  switch (model) { SBA_MODEL_CASES(sba::backsub, a, stream) }
}

// K5 over n_buckets buckets (1..kK5MaxBuckets) in one launch: out[0] is
// written, not added to. dims (host) holds TP, K, Pp and ptrs (host) the
// device pointers pts, obs_sta, obs_img of each bucket in turn; all
// buckets read the one parameter table par [7+np, Npad]. work is the
// caller's workspace of work_words (>= sba_fused_cost_work_words())
// 4-byte words, zeroed when made and left so by each launch; launches
// that share it must not overlap.
int sba_fused_cost_buckets(int model, int loss, float loss_scale,
                           int n_buckets, int Npad, const float* par,
                           const int* dims, const void* const* ptrs,
                           void* work, int work_words, float* out,
                           cudaStream_t stream) {
  if (n_buckets < 1 || n_buckets > kK5MaxBuckets ||
      work_words < kK5WorkWords)
    return cudaErrorInvalidValue;
  K5Args a{};
  a.loss = loss;
  a.Npad = Npad;
  a.n_buckets = n_buckets;
  a.a2 = loss_scale * loss_scale;
  a.par = par;
  a.part = static_cast<float*>(work);
  a.ticket = static_cast<unsigned int*>(work) + kK5MaxBlocks;
  a.out = out;
  for (int b = 0; b < n_buckets; ++b)
    a.b[b] = K5Bucket{dims[3 * b], dims[3 * b + 1], dims[3 * b + 2],
                      static_cast<const float*>(ptrs[3 * b]),
                      static_cast<const float*>(ptrs[3 * b + 1]),
                      static_cast<const int*>(ptrs[3 * b + 2]),
                      0, 0, 0, 0};
  switch (model) { SBA_MODEL_CASES(sba::fused_cost, a, stream) }
}

// The size of K5's workspace in 4-byte words.
int sba_fused_cost_work_words() { return kK5WorkWords; }

// 1 if K5 stages the parameter table par [7+nparams, Npad] in shared
// memory, 0 if it reads the table in place: the launcher's own rule.
int sba_fused_cost_stages(int nparams, int Npad, const float* par) {
  return k5_stages(nparams, Npad, par) ? 1 : 0;
}

}  // extern "C"
