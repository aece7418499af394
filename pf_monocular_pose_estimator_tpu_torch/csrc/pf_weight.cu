// Particle-filter weight of every particle of a (16, N) structure-of-arrays
// bank against the frame's detections, with each particle's greedy pairs
// and pair count.
//
// Replaces the reference's Pallas TPU kernel
//   pf_monocular_pose_estimator_tpu/pf/pallas_weight.py::weight_particles_pallas
// (the tracker's weight after an XLA propagation when use_fused_pf_kernel is
// off).  Same semantics: marker-major M x K distance volume with the 3e37
// sentinel, M rounds of greedy first-minimum matching, score
// nms + ((tol_init - d) / tol_init)^2 minus reuse and downgrade penalties;
// pairs (2M, N) int32 row 2s = marker, row 2s + 1 = detection of step s
// (-1 where none formed), ncorr (N,) int32.
//
// What bounds it on Hopper: one thread per particle reads 12 rows (48 B) and
// writes 48 B (weight, 2M = 10 pair rows, count): 9.6 MB at N = 100,000,
// 2.9 us at 3.35 TB/s.  The work these inputs need (the projection, the
// 80-cell volume with its row minima, five greedy steps over five row pairs:
// chip_smoke.py's weight_ops) is ~1 k operations a particle, 1.4 us at the
// 67 TFLOP/s fp32 peak and ~2.9 us with every add and multiply issued alone
// (--fmad=false).  The TPU kernel staged the volume in VMEM scratch and
// swept it M times; here each row keeps its first minimum while the volume
// is built (pf_common.cuh), so nothing of the volume is held, the
// parameters are staged once a block in shared memory, and the row-wise bank
// reads and pair writes coalesce.  Built with --fmad=false.  Every
// 1 <= K <= 128 and 1 <= M <= 32 runs: K = 16 with 3 <= M <= 8 on the
// specialised instantiations, the rest on the wide form of pf_common.cuh.

#include "pf_common.cuh"

namespace {

// wprm: scal[8] | mark[4M] | dets[3K] | downg[M] (pf_common.cuh).  K > 0:
// the specialised form; K = 0: the wide form, runtime m <= M (the bucket)
// markers and k <= kMaxK detections.
template <int M, int K>
__global__ void __launch_bounds__(kPfThreads) pf_weight_kernel(const float* __restrict__ bank,
                                                               const float* __restrict__ wprm,
                                                               int n, float* __restrict__ wout,
                                                               int* __restrict__ pairs,
                                                               int* __restrict__ ncorr, int m_rt,
                                                               int k_rt) {
  __shared__ float sprm[n_weight_params(M, K > 0 ? K : kMaxK)];
  stage(sprm, wprm, K > 0 ? n_weight_params(M, K) : n_weight_params(m_rt, k_rt));
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float rows[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) rows[i] = bank[(size_t)i * n + lane];
  if constexpr (K > 0)
    wout[lane] = greedy_weight<M, K, true>(rows, sprm, lane, n, pairs, ncorr);
  else
    wout[lane] = greedy_weight_wide<M, true>(rows, sprm, m_rt, k_rt, lane, n, pairs, ncorr);
}

template <int M, int K>
cudaError_t launch_m(const float* bank, const float* wprm, int n, int m, int k, float* w,
                     int* pairs, int* ncorr, cudaStream_t st) {
  pf_weight_kernel<M, K><<<(n + kPfThreads - 1) / kPfThreads, kPfThreads, 0, st>>>(
      bank, wprm, n, w, pairs, ncorr, m, k);
  return cudaGetLastError();
}

}  // namespace

// 1 <= k <= 128 detections, 1 <= m <= 32 markers: K = 16 with 3 <= M <= 8
// runs the specialised form.
extern "C" int pfmpe_pf_weight(const float* bank, const float* wprm, int n, int m, int k,
                               float* w, int* pairs, int* ncorr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxK || m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  if (k == 16) {  // the specialised shapes
    switch (m) {
      case 3: return (int)launch_m<3, 16>(bank, wprm, n, m, k, w, pairs, ncorr, st);
      case 4: return (int)launch_m<4, 16>(bank, wprm, n, m, k, w, pairs, ncorr, st);
      case 5: return (int)launch_m<5, 16>(bank, wprm, n, m, k, w, pairs, ncorr, st);
      case 6: return (int)launch_m<6, 16>(bank, wprm, n, m, k, w, pairs, ncorr, st);
      case 7: return (int)launch_m<7, 16>(bank, wprm, n, m, k, w, pairs, ncorr, st);
      case 8: return (int)launch_m<8, 16>(bank, wprm, n, m, k, w, pairs, ncorr, st);
      default: break;
    }
  }
  switch (marker_bucket(m)) {  // the wide form
    case 8: return (int)launch_m<8, 0>(bank, wprm, n, m, k, w, pairs, ncorr, st);
    case 16: return (int)launch_m<16, 0>(bank, wprm, n, m, k, w, pairs, ncorr, st);
    default: return (int)launch_m<32, 0>(bank, wprm, n, m, k, w, pairs, ncorr, st);
  }
}
