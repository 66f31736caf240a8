// The bundle-adjustment kernels of camera model 1 (PINHOLE); see
// ba_kernels.cuh.
#include "ba_kernels.cuh"

SBA_INSTANTIATE_MODEL(1)
