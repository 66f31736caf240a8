// The bundle-adjustment kernels of camera model 4 (OPENCV); see
// ba_kernels.cuh.
#include "ba_kernels.cuh"

SBA_INSTANTIATE_MODEL(4)
