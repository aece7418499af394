// Resampling gather of the particle bank:
//   out[r, t] = bank[r, anc[t]] for r < 12, rows 12-15 = (0, 0, 0, 1).
//
// Replaces the reference's Pallas TPU kernels
//   pf_monocular_pose_estimator_tpu/pf/pallas_step.py::bank_top_pin and
//   pf_monocular_pose_estimator_tpu/pf/pallas_step.py::bank_restore_pin
// together with the XLA gather between them (pf/soa.py::gather_soa,
// called at tracker/step.py:222).  The two pins only fixed TPU memory
// layouts; what they compute together is this one gather, so it is one
// kernel here.  Rows 12-15 of every pose are the rigid-transform bottom row
// (0, 0, 0, 1) by construction, so only the 12 varying rows are read.
//
// What bounds it on Hopper: bytes.  N = 100,000 moves 4.8 MB in and 6.4 MB
// out (~3.4 us at 3.35 TB/s).  One thread per output column; the ancestors
// are non-decreasing, so neighbouring threads read neighbouring (or equal)
// columns and the row reads coalesce, and every write is coalesced.

#include <cuda_runtime.h>

namespace {

__global__ void resample_gather_kernel(const float* __restrict__ bank,
                                       const long long* __restrict__ anc, int n,
                                       float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long a = anc[t];
#pragma unroll
  for (int r = 0; r < 12; ++r) out[(size_t)r * n + t] = bank[(size_t)r * n + a];
  out[(size_t)12 * n + t] = 0.0f;
  out[(size_t)13 * n + t] = 0.0f;
  out[(size_t)14 * n + t] = 0.0f;
  out[(size_t)15 * n + t] = 1.0f;
}

}  // namespace

extern "C" int pfmpe_resample_gather(const float* bank, const long long* anc, int n, float* out,
                                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  resample_gather_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      bank, anc, n, out);
  return (int)cudaGetLastError();
}
