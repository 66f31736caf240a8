// The bundle-adjustment kernels of camera model 7 (FOV); see
// ba_kernels.cuh.
#include "ba_kernels.cuh"

SBA_INSTANTIATE_MODEL(7)
