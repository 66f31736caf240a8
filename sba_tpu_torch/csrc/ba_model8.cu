// The bundle-adjustment kernels of camera model 8 (SIMPLE_RADIAL_FISHEYE); see
// ba_kernels.cuh.
#include "ba_kernels.cuh"

SBA_INSTANTIATE_MODEL(8)
