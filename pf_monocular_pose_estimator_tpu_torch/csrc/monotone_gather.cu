// Resampling gather at non-decreasing ancestors, read straight from L2:
//   out[r, t] = bank[r, src[t]] for r < 12, rows 12-15 = (0, 0, 0, 1),
// plus one coverage flag per logical output block.
//
// Replaces the reference's Pallas TPU kernel
//   pf_monocular_pose_estimator_tpu/pf/pallas_gather.py::monotone_gather_pallas
// with the coverage rule of its wrapper monotone_gather: logical block i of
// `block` (512) slots owns the `window` (2048) lanes from
//   start = clip(anc[i * block] // 128 * 128, 0, max((n - window) // 128 * 128, 0))
// and is covered when anc[last slot] - start < window and anc[first slot] >=
// start.  A slot reads src = start + clip(anc[t] - start, 0, window - 1): its
// own ancestor where the block is covered, the window's nearest edge where
// it is not.  The caller takes the plain gather when any block is not
// covered.
//
// What bounds it on Hopper: bytes.  N = 100,000 reads 12 rows (4.8 MB) and
// the int64 ancestors (0.8 MB) and writes 16 rows (6.4 MB): ~3.6 us at
// 3.35 TB/s.  The TPU kernel had to DMA the window into VMEM before it could
// select columns (a one-hot product on the MXU); on this card a gather at
// non-decreasing indices is already coalesced, since a warp's 32 slots read
// the same or neighbouring lanes and L1/L2 serve the reuse.  So the window is
// only the coverage rule here, not a buffer: no shared memory, no barrier,
// one thread per slot, and the CUDA block (256 threads) is decoupled from the
// logical block, so every SM is busy at any `block`.  Each thread loads its
// logical block's first and last ancestors (broadcast loads), its own, then
// the 12 rows, and the thread of a logical block's first slot writes its
// flag.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) monotone_gather_kernel(
    const float* __restrict__ bank, const long long* __restrict__ anc, int n, int block,
    int window, float* __restrict__ out, int* __restrict__ ok) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int lb = t / block;
  const int f = lb * block;
  const long long first = __ldg(anc + f);
  const long long last = __ldg(anc + (min(f + block, n) - 1));
  const long long a = __ldg(anc + t);
  const long long max_start = max((n - window) / 128 * 128, 0);
  const long long start = min(max(first / 128 * 128, 0LL), max_start);
  const size_t src = (size_t)(start + min(max(a - start, 0LL), (long long)window - 1));
  float v[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) v[r] = __ldg(bank + (size_t)r * n + src);
#pragma unroll
  for (int r = 0; r < 12; ++r) out[(size_t)r * n + t] = v[r];
  out[(size_t)12 * n + t] = 0.0f;
  out[(size_t)13 * n + t] = 0.0f;
  out[(size_t)14 * n + t] = 0.0f;
  out[(size_t)15 * n + t] = 1.0f;
  if (t == f) ok[lb] = (last - start < window && first >= start) ? 1 : 0;
}

}  // namespace

// bank (16, n); anc (n,) int64 non-decreasing in [0, n); out (16, n);
// ok (ceil(n / block),) int32.  Needs n >= window and block <= 1024.
extern "C" int pfmpe_monotone_gather(const float* bank, const long long* anc, int n, int block,
                                     int window, float* out, int* ok, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (block <= 0 || block > 1024 || window <= 0 || n < window) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  monotone_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(bank, anc, n, block,
                                                                        window, out, ok);
  return (int)cudaGetLastError();
}
