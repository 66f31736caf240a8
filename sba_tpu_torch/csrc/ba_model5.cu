// The bundle-adjustment kernels of camera model 5 (OPENCV_FISHEYE); see
// ba_kernels.cuh.
#include "ba_kernels.cuh"

SBA_INSTANTIATE_MODEL(5)
