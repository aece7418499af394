// Ring gather of the sharded resampler: one shard's resampled bank from the
// blocks its ring exchange delivered, without building their concatenation:
//   out[r, t] = cat(blocks, axis=1)[r, pos[t]] for r < 12,
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
// A block is 12 rows of `len` lanes with its own row stride, so a shard's
// own block can be the top of its (16, S) bank and a window a slice of a
// neighbour's, uncopied.  Positions past the last block read its last lane
// (the resampler produces none; the clamp only keeps the read in bounds).
//
// What bounds it on Hopper: bytes.  S = 25,000 reads 4 S bytes of positions
// and 48 S of bank and writes 64 S (2.9 MB, ~0.87 us at 3.35 TB/s).  One
// thread per output lane: positions are non-decreasing except at clamped
// draws, so neighbouring threads read neighbouring (or equal) lanes of one
// block and the row reads coalesce; every write is coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlocks = 16;

struct RingBlocks {
  const float* ptr[kMaxBlocks];
  long long stride[kMaxBlocks];  // floats between rows
  int len[kMaxBlocks];           // lanes
  int count;
};

__global__ void ring_gather_kernel(RingBlocks blocks, const int* __restrict__ pos, int s,
                                   float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= s) return;
  int p = pos[t] < 0 ? 0 : pos[t];
  int b = 0;
  while (b < blocks.count - 1 && p >= blocks.len[b]) {
    p -= blocks.len[b];
    ++b;
  }
  if (p >= blocks.len[b]) p = blocks.len[b] - 1;
  const float* src = blocks.ptr[b] + p;
  const long long stride = blocks.stride[b];
#pragma unroll
  for (int r = 0; r < 12; ++r) out[(size_t)r * s + t] = src[r * stride];
  out[(size_t)12 * s + t] = 0.0f;
  out[(size_t)13 * s + t] = 0.0f;
  out[(size_t)14 * s + t] = 0.0f;
  out[(size_t)15 * s + t] = 1.0f;
}

}  // namespace

// ptrs, strides, lens: host arrays of `count` entries (1 <= count <= 16,
// every len > 0); pos: device int32 (s,); out: device float32 (16, s).
extern "C" int pfmpe_ring_gather(const void* const* ptrs, const long long* strides,
                                 const int* lens, int count, const int* pos, int s, float* out,
                                 void* stream) {
  if (count < 1 || count > kMaxBlocks) return (int)cudaErrorInvalidValue;
  if (s <= 0) return (int)cudaSuccess;
  RingBlocks blocks = {};
  blocks.count = count;
  for (int i = 0; i < count; ++i) {
    if (lens[i] <= 0) return (int)cudaErrorInvalidValue;
    blocks.ptr[i] = (const float*)ptrs[i];
    blocks.stride[i] = strides[i];
    blocks.len[i] = lens[i];
  }
  const int threads = 256;
  ring_gather_kernel<<<(s + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      blocks, pos, s, out);
  return (int)cudaGetLastError();
}
