// Ring gather of the sharded resampler: every local shard's resampled bank
// from the blocks its ring exchange delivered, in one launch, without
// building their concatenation:
//   out[l, r, t] = cat(blocks_l, axis=1)[r, pos[l, t]] for r < 12,
//   rows 12-15 = (0, 0, 0, 1).
//
// Replaces the reference's Pallas TPU kernel
//   pf_monocular_pose_estimator_tpu/pf/pallas_step.py::bank_layout_pin
// as the sharded resampler uses it
// (pf_monocular_pose_estimator_tpu/parallel/resample.py:305-311): an
// identity copy of the concatenated ring blocks that pins a TPU memory
// layout ahead of `jnp.take`, followed by the restore pin
// (pallas_step.py::bank_restore_pin).  The card has no such layout
// problem, so what the chain computes is one launch here; with one block
// and pos = 0..S-1 it is the two pins with nothing between them.
//
// The launch covers every local shard (blockIdx.y).  It takes a table of
// descriptors in its parameters, one per (shard, block): a pointer and a
// row stride; the lane counts are one per block, the same on every shard.
// So on a mesh of P shards in one process a block is the other shard's
// rows where they lie (a view at any lane offset), and nothing is copied
// before the gather.  Positions past the last block read its last lane
// (the resampler produces none; the clamp only keeps the read in bounds).
//
// What bounds it on Hopper: bytes.  A lane reads 4 bytes of position and 48
// of bank and writes 64 (116 bytes): L * S = 100,000 lanes move 11.6 MB,
// ~3.46 us at 3.35 TB/s.  Positions are non-decreasing except at clamped
// draws, so neighbouring threads take neighbouring lanes: their row reads
// coalesce, and so does every write.  A thread takes two lanes, reading
// its positions and writing each row as one 8-byte vector, where every
// row start is 8-byte aligned (S even); otherwise one lane, with 4-byte
// accesses.  128 threads a block.  Measured on the card against one and
// four lanes a thread, 4-byte stores and 256 threads (PERF.md, Findings).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBlocks = 16;    // ring blocks a shard
constexpr int kMaxEntries = 256;  // (shard, block) descriptors a launch
constexpr int kThreads = 128;

struct RingTable {
  const float* ptr[kMaxEntries];  // entry shard * count + block
  int stride[kMaxEntries];        // floats between rows
  int len[kMaxBlocks];            // lanes of each block, the same on every shard
  int count;                      // blocks a shard
};
// kernel parameters are limited to 4 KB
static_assert(sizeof(RingTable) + 3 * sizeof(void*) <= 4096, "ring table over 4 KB");

// Where position p of `shard`'s concatenation lies: its block's lane p, and
// that block's row stride.
__device__ __forceinline__ const float* locate(const RingTable& table, int shard, int p,
                                               int& stride) {
  p = p < 0 ? 0 : p;
  int b = 0;
  while (b < table.count - 1 && p >= table.len[b]) {
    p -= table.len[b];
    ++b;
  }
  if (p >= table.len[b]) p = table.len[b] - 1;
  const int e = shard * table.count + b;
  stride = table.stride[e];
  return table.ptr[e] + p;
}

// Lanes t0 .. t0 + kLanes - 1 of one row.
template <int kLanes>
__device__ __forceinline__ void store_row(float* row, int t0, const float (&v)[kLanes]) {
  if constexpr (kLanes == 2) {
    *reinterpret_cast<float2*>(row + t0) = make_float2(v[0], v[1]);
  } else {
    row[t0] = v[0];
  }
}

// kLanes = 2 needs S even and 8-byte aligned positions and output.
template <int kLanes>
__global__ void __launch_bounds__(kThreads)
    ring_gather_kernel(const __grid_constant__ RingTable table, const int* __restrict__ pos,
                       int s, float* __restrict__ out) {
  const int shard = blockIdx.y;
  const int t0 = (blockIdx.x * kThreads + threadIdx.x) * kLanes;
  if (t0 >= s) return;  // S % kLanes == 0, so the thread's other lane is in range too
  pos += (size_t)shard * s;
  out += (size_t)shard * 16 * s;
  int p[kLanes];
  if constexpr (kLanes == 2) {
    const int2 q = *reinterpret_cast<const int2*>(pos + t0);
    p[0] = q.x;
    p[1] = q.y;
  } else {
    p[0] = pos[t0];
  }
  const float* src[kLanes];
  int stride[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) src[j] = locate(table, shard, p[j], stride[j]);
  float v[12][kLanes];
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int j = 0; j < kLanes; ++j) v[r][j] = __ldg(src[j] + (size_t)r * stride[j]);
#pragma unroll
  for (int r = 0; r < 12; ++r) store_row<kLanes>(out + (size_t)r * s, t0, v[r]);
  float zero[kLanes], one[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) zero[j] = 0.0f, one[j] = 1.0f;
#pragma unroll
  for (int r = 12; r < 15; ++r) store_row<kLanes>(out + (size_t)r * s, t0, zero);
  store_row<kLanes>(out + (size_t)15 * s, t0, one);
}

template <int kLanes>
void launch(const RingTable& table, int n_shards, const int* pos, int s, float* out,
            cudaStream_t stream) {
  const int per_block = kThreads * kLanes;
  const dim3 grid((s + per_block - 1) / per_block, n_shards);
  ring_gather_kernel<kLanes><<<grid, kThreads, 0, stream>>>(table, pos, s, out);
}

}  // namespace

// ptrs, strides: host arrays of n_shards * count entries, shard-major
// (1 <= count <= 16, n_shards * count <= 256); lens: host array of `count`
// lane counts (each > 0); pos: device int32 (n_shards, s); out: device
// float32 (n_shards, 16, s).
extern "C" int pfmpe_ring_gather(const void* const* ptrs, const int* strides, const int* lens,
                                 int n_shards, int count, const int* pos, int s, float* out,
                                 void* stream) {
  if (count < 1 || count > kMaxBlocks || n_shards < 1 || n_shards * count > kMaxEntries)
    return (int)cudaErrorInvalidValue;
  if (s <= 0) return (int)cudaSuccess;
  RingTable table = {};
  table.count = count;
  for (int b = 0; b < count; ++b) {
    if (lens[b] <= 0) return (int)cudaErrorInvalidValue;
    table.len[b] = lens[b];
  }
  for (int e = 0; e < n_shards * count; ++e) {
    table.ptr[e] = (const float*)ptrs[e];
    table.stride[e] = strides[e];
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (s % 2 == 0 && (uintptr_t)pos % 8 == 0 && (uintptr_t)out % 8 == 0)
    launch<2>(table, n_shards, pos, s, out, st);
  else
    launch<1>(table, n_shards, pos, s, out, st);
  return (int)cudaGetLastError();
}
