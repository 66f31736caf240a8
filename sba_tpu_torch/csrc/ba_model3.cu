// The bundle-adjustment kernels of camera model 3 (RADIAL); see
// ba_kernels.cuh.
#include "ba_kernels.cuh"

SBA_INSTANTIATE_MODEL(3)
