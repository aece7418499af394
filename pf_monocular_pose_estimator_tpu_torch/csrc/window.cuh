// Window staging shared by the windowed resampling kernels
// (resample_decode.cu, kernel F; monotone_gather.cu, kernel G): a block
// copies the columns [start, start + width) of the first `rows` rows of a
// row-major (R, n) float array into shared memory as a (rows, width) tile.
// Neighbouring threads read neighbouring columns, so every row read
// coalesces.  Columns at or past n read as 0, so a window that runs past the
// bank's end is still defined.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void stage_window(const float* __restrict__ src, int n, int rows,
                                             int start, int width, float* __restrict__ dst) {
  const int total = rows * width;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / width;
    const int lane = start + (i - r * width);
    dst[i] = lane < n ? src[(size_t)r * n + lane] : 0.0f;
  }
}

}  // namespace
