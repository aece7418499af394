// Fused particle-filter iteration: propagate every particle of the (16, N)
// structure-of-arrays bank and weight it against the frame's detections.
//
// Replaces the reference's Pallas TPU kernel
//   pf_monocular_pose_estimator_tpu/pf/pallas_step.py::fused_propagate_weight_pallas
// in both its variants: the folded one (_make_folded_kernel, weights only)
// and the straight one (_make_fused_kernel), whose want_pairs output --
// each greedy step's (marker, detection) pair and the pair count -- is the
// WANT_PAIRS instantiation here.  The folded variant is a TPU layout choice
// (eight particles per sublane row) that computes the same values; one
// thread per particle has no counterpart of it, so both settings run this.
//
// Per particle: base = L @ T @ R (ego-motion / prediction compose); six
// uniforms drawn in the kernel from the threefry-2x32 counter stream at
// counter r * n_total + global_lane -- the same stream as jax.random, so the
// draws equal the reference's bit for bit; Rz @ Ry @ Rx noise rotation and
// additive translation noise; lanes 0 and 1 pinned to the current and
// predicted poses; then the marker-major greedy weight of pf_common.cuh.
//
// What bounds it on Hopper: one thread per particle reads 64 B and writes
// 68 B (+44 B of pairs and count with WANT_PAIRS): 13.2 MB / 17.6 MB for
// N = 100,000, 3.9 / 5.3 us at 3.35 TB/s.  The work is ~2.0 k operations a
// particle (threefry hashing, the compose, the greedy weight: chip_smoke.py's
// PROPAGATE_OPS and weight_ops), 3.0 us at the 67 TFLOP/s fp32 peak; with
// --fmad=false every add and multiply issues alone, so ~6 us is the
// reachable floor and the kernel is compute- and latency-bound.  The design
// keeps the greedy state in registers as M row minima (pf_common.cuh: the
// volume is never held, a greedy step is O(M)), stages the launch's
// parameters once a block in shared memory and reads the bank row by row so
// neighbouring threads touch neighbouring addresses.  Built with
// --fmad=false and precise sincosf so every expression rounds as the
// reference writes it; the 32-byte stack frame ptxas reports is the math
// library's reduction of huge angles (local memory only on that path).
//
// Shapes: the Pallas kernel unrolls over any marker and detection count, so
// this one takes every 1 <= K <= 128 and 1 <= M <= 32.  K = 16 with
// 3 <= M <= 8 (the tracker's defaults) keeps its specialised, fully
// unrolled instantiations; every other shape runs the wide form
// (pf_common.cuh: the detections listed real first once a block, a row's
// masked slots walked only when they could still hold its minimum, rows
// four at a time with their minima in shared memory), whose greedy work
// grows as 9 M K_real + 2 M^2 a particle.

#include "pf_common.cuh"

namespace {

// params: lr[32] | pin[32] | prop[12] | scal[8] | mark[4M] | dets[3K] | downg[M]
// K > 0: the specialised form (M markers, K detections); K = 0: the wide
// form, runtime m <= kMaxM markers and k <= kMaxK detections.
template <int M, int K, bool WANT_PAIRS>
__global__ void __launch_bounds__(kPfThreads) pf_step_kernel(
    const float* __restrict__ bank, const float* __restrict__ prm, int n, uint32_t kr0,
    uint32_t kr1, uint32_t kt0, uint32_t kt1, int lane_offset, int n_total,
    float* __restrict__ out, float* __restrict__ wout, int* __restrict__ pairs,
    int* __restrict__ ncorr, int m_rt, int k_rt) {
  __shared__ float sprm[76 + n_weight_params(K > 0 ? M : kMaxM, K > 0 ? K : kMaxK)];
  stage(sprm, prm, K > 0 ? 76 + n_weight_params(M, K) : 76 + n_weight_params(m_rt, k_rt));
  if constexpr (K == 0) stage_wide(wide_dets(), sprm + 76, m_rt, k_rt);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float* lr = sprm;
  const float* pin = sprm + 32;
  const float* prop = sprm + 64;

  float t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = bank[(size_t)i * n + lane];

  // base = L @ (T @ R)
  float tr[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = t[i * 4 + 0] * lr[16 + 0 * 4 + j];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = acc + t[i * 4 + k] * lr[16 + k * 4 + j];
      tr[i * 4 + j] = acc;
    }
  }
  float base[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = lr[i * 4 + 0] * tr[0 * 4 + j];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = acc + lr[i * 4 + k] * tr[k * 4 + j];
      base[i * 4 + j] = acc;
    }
  }

  // six uniforms: rows 0-2 angles (key k_rot), rows 3-5 translation (k_trans)
  const int glane = lane + lane_offset;
  float nz[6];
#pragma unroll
  for (int row = 0; row < 6; ++row) {
    const uint32_t k0 = row < 3 ? kr0 : kt0;
    const uint32_t k1 = row < 3 ? kr1 : kt1;
    const uint32_t r = (uint32_t)(row < 3 ? row : row - 3);
    const uint32_t p = r * (uint32_t)n_total + (uint32_t)glane;
    const float u = unit_uniform(k0, k1, p);
    const float lo = prop[2 * row], hi = prop[2 * row + 1];
    nz[row] = fmaxf(lo, u * (hi - lo) + lo);
  }
  // sincosf equals sinf and cosf bit for bit (tests/test_torch_kernels_cuda.py)
  float sa, ca, sb, cb, sc, cc;
  sincosf(nz[0], &sa, &ca);
  sincosf(nz[1], &sb, &cb);
  sincosf(nz[2], &sc, &cc);
  const float rn[9] = {
      cc * cb,
      cc * sb * sa - sc * ca,
      cc * sb * ca + sc * sa,
      sc * cb,
      sc * sb * sa + cc * ca,
      sc * sb * ca - cc * sa,
      -sb,
      cb * sa,
      cb * ca,
  };

  float rows[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v;
      if (j == 3) {
        v = i < 3 ? base[i * 4 + 3] + nz[3 + i] : base[15];
      } else if (i == 3) {
        v = base[12 + j];
      } else {
        float acc = base[i * 4 + 0] * rn[0 * 3 + j];
        acc = acc + base[i * 4 + 1] * rn[1 * 3 + j];
        acc = acc + base[i * 4 + 2] * rn[2 * 3 + j];
        v = acc;
      }
      if (glane == 0) v = pin[i * 4 + j];
      if (glane == 1) v = pin[16 + i * 4 + j];
      rows[i * 4 + j] = v;
      out[(size_t)(i * 4 + j) * n + lane] = v;
    }
  }

  if constexpr (K > 0)
    wout[lane] = greedy_weight<M, K, WANT_PAIRS>(rows, sprm + 76, lane, n, pairs, ncorr);
  else
    wout[lane] = greedy_weight_wide<WANT_PAIRS>(rows, sprm + 76, wide_dets(), m_rt, k_rt, lane, n,
                                                pairs, ncorr);
}

template <int M, int K, bool WANT_PAIRS>
cudaError_t launch_m(const float* bank, const float* prm, int n, int m, int k,
                     const uint32_t* keys, int lane_offset, int n_total, float* out, float* w,
                     int* pairs, int* ncorr, cudaStream_t st) {
  const int blocks = (n + kPfThreads - 1) / kPfThreads;
  pf_step_kernel<M, K, WANT_PAIRS><<<blocks, kPfThreads, 0, st>>>(
      bank, prm, n, keys[0], keys[1], keys[2], keys[3], lane_offset, n_total, out, w, pairs,
      ncorr, m, k);
  return cudaGetLastError();
}

template <int M, int K>
cudaError_t launch_pairs(const float* bank, const float* prm, int n, int m, int k,
                         const uint32_t* keys, int lane_offset, int n_total, float* out, float* w,
                         int* pairs, int* ncorr, cudaStream_t st) {
  if (pairs != nullptr && ncorr != nullptr)
    return launch_m<M, K, true>(bank, prm, n, m, k, keys, lane_offset, n_total, out, w, pairs,
                                ncorr, st);
  if (pairs != nullptr || ncorr != nullptr) return cudaErrorInvalidValue;
  return launch_m<M, K, false>(bank, prm, n, m, k, keys, lane_offset, n_total, out, w, nullptr,
                               nullptr, st);
}

}  // namespace

// pairs (2M, N) int32 and ncorr (N,) int32 are both null (weights only) or
// both set (the straight variant's pairs output).  1 <= k <= 128 detections,
// 1 <= m <= 32 markers: K = 16 with 3 <= M <= 8 runs the specialised form.
extern "C" int pfmpe_pf_step(const float* bank, const float* prm, int n, int m, int k,
                             unsigned int kr0, unsigned int kr1, unsigned int kt0,
                             unsigned int kt1, int lane_offset, int n_total, float* out,
                             float* w, int* pairs, int* ncorr, void* stream) {
  const uint32_t keys[4] = {kr0, kr1, kt0, kt1};
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxK || m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
#define PFMPE_CASE(M_, K_)                                                                  \
  return (int)launch_pairs<M_, K_>(bank, prm, n, m, k, keys, lane_offset, n_total, out, w, \
                                   pairs, ncorr, st);
  if (k == 16) {  // the specialised shapes
    switch (m) {
      case 3: PFMPE_CASE(3, 16)
      case 4: PFMPE_CASE(4, 16)
      case 5: PFMPE_CASE(5, 16)
      case 6: PFMPE_CASE(6, 16)
      case 7: PFMPE_CASE(7, 16)
      case 8: PFMPE_CASE(8, 16)
      default: break;
    }
  }
  PFMPE_CASE(0, 0)  // the wide form
#undef PFMPE_CASE
}
