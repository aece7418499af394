// Resampling gather at non-decreasing ancestors through one window per
// output block:
//   out[r, t] = bank[r, anc[t]] for r < 12, rows 12-15 = (0, 0, 0, 1),
// plus one coverage flag per output block.
//
// Replaces the reference's Pallas TPU kernel
//   pf_monocular_pose_estimator_tpu/pf/pallas_gather.py::monotone_gather_pallas
// with the coverage rule of its wrapper monotone_gather: block i of `block`
// (512) slots reads the `window` (2048) lanes from
//   start = clip(anc[i * block] // 128 * 128, 0, max((n - window) // 128 * 128, 0))
// and is covered when anc[last slot] - start < window and anc[first slot] >=
// start.  Where a block is covered its columns equal the plain gather bit for
// bit; the caller takes the plain gather when any block is not.
//
// The TPU kernel DMAed the window into VMEM and selected the columns with a
// one-hot matrix product on the MXU; here the block stages the 12 varying
// rows of its window (96 KB of dynamic shared memory, coalesced reads,
// window.cuh) and each thread copies its column out of shared memory.
//
// What bounds it on Hopper: bytes.  N = 100,000 reads 12 rows (4.8 MB) and
// the int64 ancestors (0.8 MB) and writes 16 rows (6.4 MB): ~3.6 us at
// 3.35 TB/s.  Neighbouring windows overlap, so the bank is read up to four
// times, mostly from L2.

#include "window.cuh"

namespace {

// blockDim.x == block (one thread per output slot)
__global__ void __launch_bounds__(1024) monotone_gather_kernel(const float* __restrict__ bank,
                                                               const long long* __restrict__ anc,
                                                               int n, int window,
                                                               float* __restrict__ out,
                                                               int* __restrict__ ok) {
  extern __shared__ float swin[];  // (12, window)
  const int block = blockDim.x;
  const int t0 = blockIdx.x * block;
  const long long first = anc[t0];
  const long long last = anc[min(t0 + block, n) - 1];
  const long long max_start = max((n - window) / 128 * 128, 0);
  const long long start = min(max(first / 128 * 128, 0LL), max_start);
  stage_window(bank, n, 12, (int)start, window, swin);
  __syncthreads();

  const int t = t0 + threadIdx.x;
  if (t < n) {
    const long long rel = min(max(anc[t] - start, 0LL), (long long)window - 1);
#pragma unroll
    for (int r = 0; r < 12; ++r) out[(size_t)r * n + t] = swin[r * window + rel];
    out[(size_t)12 * n + t] = 0.0f;
    out[(size_t)13 * n + t] = 0.0f;
    out[(size_t)14 * n + t] = 0.0f;
    out[(size_t)15 * n + t] = 1.0f;
  }
  if (threadIdx.x == 0) ok[blockIdx.x] = (last - start < window && first >= start) ? 1 : 0;
}

}  // namespace

// bank (16, n); anc (n,) int64 non-decreasing in [0, n); out (16, n);
// ok (ceil(n / block),) int32.  Needs n >= window and block <= 1024.
extern "C" int pfmpe_monotone_gather(const float* bank, const long long* anc, int n, int block,
                                     int window, float* out, int* ok, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (block <= 0 || block > 1024 || window <= 0 || n < window) return (int)cudaErrorInvalidValue;
  const int smem = 12 * window * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(monotone_gather_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + block - 1) / block;
  monotone_gather_kernel<<<blocks, block, smem, (cudaStream_t)stream>>>(bank, anc, n, window, out,
                                                                         ok);
  return (int)cudaGetLastError();
}
