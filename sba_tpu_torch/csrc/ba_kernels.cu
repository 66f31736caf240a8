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

int sba_fused_cost(int model, int loss, float loss_scale, int TP, int K,
                   int Pp, int Npad, const float* par, const float* pts,
                   const float* obs_sta, const int* obs_img, float* acc,
                   cudaStream_t stream) {
  const K5Args a{loss, TP, K, Pp, Npad, loss_scale * loss_scale, par, pts,
                 obs_sta, obs_img, acc};
  switch (model) { SBA_MODEL_CASES(sba::fused_cost, a, stream) }
}

}  // extern "C"
