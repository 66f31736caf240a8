// The bundle-adjustment kernels of camera model 10 (THIN_PRISM_FISHEYE); see
// ba_kernels.cuh.
#include "ba_kernels.cuh"

SBA_INSTANTIATE_MODEL(10)
