// Windowed decode of a monotone resampling rank into the resampled bank:
//   anc[t] = #{j : rank[j] <= t},  out[:, t] = bank[:, anc[t]]  (all 16 rows)
// plus one coverage flag per output block.
//
// Replaces the reference's Pallas TPU kernel
//   pf_monocular_pose_estimator_tpu/pf/pallas_resample.py::_decode_pallas
// (called by resample_bank_pallas after the probe-rank pre-pass).  Same
// semantics and the same constants, which decide when the caller falls back
// to the sort path: an output block of `block` slots (1024) reads a window
// of `win_chunks` (12) 128-lane chunks of rank and bank starting at chunk
//   q = clip(#{chunks c : rank at c's last lane <= first slot}, 0, nb128 - 12)
// (rank reads as 2^23 past n); each slot counts the window chunks whose last
// rank is <= t, then bisects 7 steps inside the straddling chunk; the block
// is covered when the window's last rank exceeds its last valid slot.  Where
// the flag is set the output equals bank[:, repeat(arange(N), counts)] bit
// for bit.
//
// The TPU kernel got q by scalar prefetch and the window by 24 (16, 128)
// BlockSpecs; here a block finds its own q from rank (one
// __syncthreads_count pass over the ~800 chunk boundaries) and stages the
// window (1536 lanes of rank and of the 16 bank rows, 104 KB of dynamic
// shared memory) with coalesced reads before any slot decodes.
//
// What bounds it on Hopper: bytes.  N = 100,000 reads rank (0.4 MB) and the
// bank (6.4 MB) and writes 6.4 MB: ~3.9 us at 3.35 TB/s; the decode is ~25
// integer operations a slot.  The windows of neighbouring blocks overlap by
// about half, so the bank is read ~1.5 times, mostly from L2.

#include "window.cuh"

namespace {

constexpr int kBigRank = 1 << 23;

__device__ __forceinline__ int rank_at(const int* __restrict__ rank, int n, int j) {
  return j < n ? rank[j] : kBigRank;
}

// blockDim.x == block (one thread per output slot)
__global__ void __launch_bounds__(1024) resample_decode_kernel(const int* __restrict__ rank,
                                                               const float* __restrict__ bank,
                                                               int n, int win_chunks,
                                                               float* __restrict__ out,
                                                               int* __restrict__ ok) {
  extern __shared__ float smem[];
  const int w = win_chunks * 128;
  float* sbank = smem;                                  // (16, w)
  int* srank = reinterpret_cast<int*>(smem + 16 * w);  // (w,)
  const int block = blockDim.x;
  const int tbase = blockIdx.x * block;
  const int nb128 = (n + 127) / 128;

  int c0 = 0;
  for (int c = 0; c < nb128; c += blockDim.x) {
    const int cc = c + threadIdx.x;
    c0 += __syncthreads_count(cc < nb128 && rank_at(rank, n, cc * 128 + 127) <= tbase);
  }
  const int start = min(max(c0, 0), nb128 - win_chunks) * 128;
  stage_window(bank, n, 16, start, w, sbank);
  for (int j = threadIdx.x; j < w; j += blockDim.x) srank[j] = rank_at(rank, n, start + j);
  __syncthreads();

  const int t = tbase + threadIdx.x;
  int coarse = 0;
  for (int c = 0; c < win_chunks; ++c) coarse += srank[c * 128 + 127] <= t ? 1 : 0;
  const int cs = min(coarse, win_chunks - 1);
  int posc = 0;
#pragma unroll
  for (int s = 6; s >= 0; --s) {
    const int stp = 1 << s;
    if (srank[cs * 128 + posc + stp - 1] <= t) posc += stp;
  }
  const int pos = coarse >= win_chunks ? w : cs * 128 + posc;
  const int src = min(pos, w - 1);
  if (t < n) {
#pragma unroll
    for (int r = 0; r < 16; ++r) out[(size_t)r * n + t] = sbank[r * w + src];
  }
  if (threadIdx.x == 0) {
    const int t_last = min(tbase + block, n) - 1;
    ok[blockIdx.x] = srank[w - 1] > t_last ? 1 : 0;
  }
}

}  // namespace

// rank (n,) int32 monotone; bank (16, n); out (16, n); ok (ceil(n / block),)
// int32.  Needs n >= win_chunks * 128 and block <= 1024.
extern "C" int pfmpe_resample_decode(const int* rank, const float* bank, int n, int block,
                                     int win_chunks, float* out, int* ok, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (block <= 0 || block > 1024 || win_chunks <= 0 || n < win_chunks * 128)
    return (int)cudaErrorInvalidValue;
  const int smem = 17 * win_chunks * 128 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(resample_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + block - 1) / block;
  resample_decode_kernel<<<blocks, block, smem, (cudaStream_t)stream>>>(rank, bank, n, win_chunks,
                                                                         out, ok);
  return (int)cudaGetLastError();
}
