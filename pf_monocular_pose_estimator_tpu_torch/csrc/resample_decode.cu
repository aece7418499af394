// Windowed decode of a monotone resampling rank into the resampled bank:
//   anc[t] = #{j : rank[j] <= t},  out[:, t] = bank[:, anc[t]]  (all 16 rows)
// plus one coverage flag per logical output block.
//
// Replaces the reference's Pallas TPU kernel
//   pf_monocular_pose_estimator_tpu/pf/pallas_resample.py::_decode_pallas
// (called by resample_bank_pallas after the probe-rank pre-pass).  Same
// semantics and the same constants, which decide when the caller falls back
// to the sort path: a logical output block of `block` slots (1024) reads a
// window of `win_chunks` (12) 128-lane chunks of rank and bank starting at
// chunk
//   q = clip(#{chunks c : rank at c's last lane <= first slot}, 0, nb128 - 12)
// (rank reads as 2^23 past n); each slot counts the window chunks whose last
// rank is <= t, then bisects 7 steps inside the straddling chunk; the block
// is covered when the window's last rank exceeds its last valid slot.  Where
// the flag is set the output equals bank[:, repeat(arange(N), counts)] bit
// for bit; lanes past n read bank 0.
//
// What bounds it on Hopper: bytes.  N = 100,000 reads rank (0.4 MB) and the
// bank (6.4 MB) and writes 6.4 MB: ~3.9 us at 3.35 TB/s; the decode is ~25
// integer operations a slot.  The TPU kernel got q by scalar prefetch and the
// window by 24 (16, 128) BlockSpecs, because it can only read what it has
// DMAed into VMEM.  Here resample_decode_kernel splits each logical block
// over `parts` blocks of 256 threads (391 at N = 100,000, where one block of
// 1024 a logical block gave 98 for 132 SMs), stages only the window's rank
// (6 KB, for the 12 boundary compares and the bisection; it measured
// faster than reading the rank through L1) and reads the 16 bank rows
// straight from L2: the ancestors are non-decreasing, so a warp's reads
// coalesce without staging.
//
// q stays a count: the chunk-last ranks need not be monotone (a
// Hillis-Steele prefix of float32 weights can step down an ulp), and a
// search would then disagree with the reference.  Without a `starts`
// buffer (the wrapper passes none up to 1,024 chunks) every decode block
// counts its own q (one round of loads a thread at N = 100,000); with one,
// where that count would read nb x nb128 sectors, decode_starts_kernel (one
// block, a launch before the decode) counts q for every logical block at
// once, linear in n: chunk c's last rank v counts for every block from
// ceil(v / block) on, so q is the prefix sum of a histogram of
// ceil(v / block).  The decode is then a programmatic dependent launch
// (PDL), resident and waiting when the starts land (faster than stream
// order at 1,000,000 lanes; PERF.md has both times).

#include <cuda_runtime.h>

namespace {

constexpr int kBigRank = 1 << 23;
constexpr int kThreads = 256;        // decode threads a block
constexpr int kStartThreads = 1024;  // decode_starts_kernel's one block
constexpr int kBins = 8192;          // histogram bins a pass (32 KB of shared memory)
constexpr int kLoads = 8;            // independent chunk loads a thread keeps in flight

__device__ __forceinline__ int rank_at(const int* __restrict__ rank, int n, int j) {
  return j < n ? __ldg(rank + j) : kBigRank;
}

// q of every logical block as the window's first lane, q * 128.
__global__ void __launch_bounds__(kStartThreads) decode_starts_kernel(
    const int* __restrict__ rank, int n, int block, int nb, int win_chunks,
    int* __restrict__ starts) {
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ int hist[kBins];
  __shared__ int warp_sums[kStartThreads / 32];
  const int nb128 = (n + 127) / 128;
  const int max_q = nb128 - win_chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;  // chunks counted by the bins of earlier passes
  for (int base = 0; base < nb; base += kBins) {
    for (int i = threadIdx.x; i < kBins; i += kStartThreads) hist[i] = 0;
    __syncthreads();
    for (int c0 = threadIdx.x; c0 < nb128; c0 += kStartThreads * kLoads) {
      int first_block[kLoads];  // the first logical block this chunk counts for
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = c0 + u * kStartThreads;
        const int v = c < nb128 ? rank_at(rank, n, c * 128 + 127) : 0;
        first_block[u] = c >= nb128 ? nb : (v <= 0 ? 0 : (v - 1) / block + 1);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int b = first_block[u] - base;
        if (first_block[u] < nb && b >= 0 && b < kBins) atomicAdd(&hist[b], 1);
      }
    }
    __syncthreads();
    // inclusive prefix sum over the pass's bins: kBins / kStartThreads a thread
    constexpr int kPer = kBins / kStartThreads;
    int v[kPer], s = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      v[i] = hist[threadIdx.x * kPer + i];
      s += v[i];
    }
    int x = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int y = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int z = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) y += z;
      }
      warp_sums[lane] = y;
    }
    __syncthreads();
    int acc = carry + x - s + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      acc += v[i];
      const int lb = base + threadIdx.x * kPer + i;
      if (lb < nb) starts[lb] = min(acc, max_q) * 128;
    }
    carry += warp_sums[kStartThreads / 32 - 1];
    __syncthreads();
  }
}

// Logical block lb = blockIdx.x / parts; this block takes its slots
// [part * kThreads, (part + 1) * kThreads).
__global__ void __launch_bounds__(kThreads) resample_decode_kernel(
    const int* __restrict__ rank, const float* __restrict__ bank,
    const int* __restrict__ starts, int n, int block, int parts, int win_chunks,
    float* __restrict__ out, int* __restrict__ ok) {
  extern __shared__ int srank[];  // the window's rank, (w,)
  const int w = win_chunks * 128;
  const int lb = blockIdx.x / parts;
  const int part = blockIdx.x - lb * parts;
  const int tbase = lb * block;
  int start;
  if (starts == nullptr) {  // count the window start here
    __shared__ int warp_counts[kThreads / 32];
    const int nb128 = (n + 127) / 128;
    int count = 0;
    for (int c0 = threadIdx.x; c0 < nb128; c0 += kThreads * 4) {
      int last[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * kThreads;
        last[u] = c < nb128 ? rank_at(rank, n, c * 128 + 127) : 0x7fffffff;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) count += last[u] <= tbase ? 1 : 0;
    }
    count = __reduce_add_sync(0xffffffffu, count);
    if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
    __syncthreads();
    count = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) count += warp_counts[i];
    start = min(count, nb128 - win_chunks) * 128;
  } else {  // decode_starts_kernel's
    asm volatile("griddepcontrol.wait;" ::: "memory");
    start = starts[lb];
  }
  for (int j = threadIdx.x; j < w; j += kThreads) srank[j] = rank_at(rank, n, start + j);
  __syncthreads();

  const int slot = part * kThreads + threadIdx.x;
  const int t = tbase + slot;
  if (slot < block && t < n) {
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
    const int lane = start + min(pos, w - 1);
    float v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) v[r] = lane < n ? __ldg(bank + (size_t)r * n + lane) : 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) out[(size_t)r * n + t] = v[r];
  }
  if (part == 0 && threadIdx.x == 0) {
    const int t_last = min(tbase + block, n) - 1;
    ok[lb] = srank[w - 1] > t_last ? 1 : 0;
  }
}

}  // namespace

// rank (n,) int32 monotone; bank (16, n); starts (ceil(n / block),) int32
// scratch, or null to count the window starts in the decode blocks; out
// (16, n); ok (ceil(n / block),) int32.  Needs n >= win_chunks * 128 and
// block <= 1024.
extern "C" int pfmpe_resample_decode(const int* rank, const float* bank, int n, int block,
                                     int win_chunks, int* starts, float* out, int* ok,
                                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (block <= 0 || block > 1024 || win_chunks <= 0 || n < win_chunks * 128)
    return (int)cudaErrorInvalidValue;
  const int nb = (n + block - 1) / block;
  const int parts = (block + kThreads - 1) / kThreads;
  const int smem = win_chunks * 128 * (int)sizeof(int);
  // above 48 KB (win_chunks > 96, never the reference's 12) the kernel needs
  // the opt-in on the current device; set it on each such launch
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resample_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (starts == nullptr) {
    resample_decode_kernel<<<nb * parts, kThreads, smem, (cudaStream_t)stream>>>(
        rank, bank, nullptr, n, block, parts, win_chunks, out, ok);
    return (int)cudaGetLastError();
  }
  decode_starts_kernel<<<1, kStartThreads, 0, (cudaStream_t)stream>>>(rank, n, block, nb,
                                                                       win_chunks, starts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nb * parts));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, resample_decode_kernel, rank, bank,
                                                  (const int*)starts, n, block, parts,
                                                  win_chunks, out, ok);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}
