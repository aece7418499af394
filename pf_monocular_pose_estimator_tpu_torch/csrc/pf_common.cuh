// Device code shared by the PF pass kernel (pf_step.cu, kernel B) and the
// standalone weight kernel (pf_weight.cu, kernel E): the threefry-2x32
// counter stream and the marker-major greedy weight of one particle.
//
// The weight is the reference's Pallas weight function
//   pf_monocular_pose_estimator_tpu/pf/pallas_weight.py::_weight_from_rows
// for one lane: the M markers are projected, the M x K squared-distance
// volume (3e37 sentinel added on masked cells) is built marker-major
// (row m * K + k), and M rounds of greedy first-minimum matching score it.
// Everything lives in registers: M and K are template parameters and every
// loop unrolls.  Built with --fmad=false so each product rounds as the
// reference writes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e37f;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int d) { return (v << d) | (v >> (32 - d)); }

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float unit_uniform(uint32_t k0, uint32_t k1, uint32_t counter) {
  uint32_t o1 = 0u, o2 = counter;
  threefry2x32(k0, k1, o1, o2);
  const uint32_t bits = o1 ^ o2;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Weight of the particle whose first 12 pose rows are `rows`.
// wprm: scal[8] (fx fy cx cy tol_pf tol_init num_markers_score 0) | mark[4M]
// (xyz per marker | 0 or 3e37) | dets[3K] (xy per detection | 0 or 3e37) |
// downg[M] (0 or 2).  With WANT_PAIRS, greedy step s writes
// pairs[(2s) * n + lane] = marker, pairs[(2s + 1) * n + lane] = detection
// (-1 where no pair formed) and ncorr[lane] = the number of pairs.
template <int M, int K, bool WANT_PAIRS>
__device__ __forceinline__ float greedy_weight(const float* rows, const float* __restrict__ wprm,
                                               int lane, int n, int* __restrict__ pairs,
                                               int* __restrict__ ncorr) {
  const float* scal = wprm;
  const float* mark = wprm + 8;
  const float* dets = mark + 4 * M;
  const float* downg = dets + 3 * K;
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  const float tol_pf = scal[4], tol_init = scal[5], nms = scal[6];
  float dist[M * K];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float mx = mark[3 * m + 0], my = mark[3 * m + 1], mz = mark[3 * m + 2];
    const float mbig = mark[3 * M + m];
    const float xc = rows[0] * mx + rows[1] * my + rows[2] * mz + rows[3];
    const float yc = rows[4] * mx + rows[5] * my + rows[6] * mz + rows[7];
    const float zc = rows[8] * mx + rows[9] * my + rows[10] * mz + rows[11];
    const float safe_z = fabsf(zc) < 1e-12f ? 1e-12f : zc;
    const float u = fx * xc / safe_z + cx;
    const float v = fy * yc / safe_z + cy;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float du = dets[2 * k] - u;
      const float dv = dets[2 * k + 1] - v;
      dist[m * K + k] = du * du + dv * dv + dets[2 * K + k] + mbig;
    }
  }

  float weight = 0.0f, nself = 1.0f;
  bool done = false;
  int n_pairs = 0;
  float used[K];
#pragma unroll
  for (int k = 0; k < K; ++k) used[k] = 0.0f;
#pragma unroll
  for (int step = 0; step < M; ++step) {
    float minv = dist[0];
#pragma unroll
    for (int r = 1; r < M * K; ++r) minv = fminf(minv, dist[r]);
    int idx = M * K;
#pragma unroll
    for (int r = M * K - 1; r >= 0; --r) idx = dist[r] == minv ? r : idx;  // first min wins
    const int m_sel = idx / K;
    const int k_sel = idx - m_sel * K;
    const float d = sqrtf(fmaxf(minv, 0.0f));
    const bool ok = (d <= tol_pf) && !done;
    done = done || !ok;
    const float q = (tol_init - d) / tol_init;
    const float score = nms + q * q;
    float reused = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) reused = fmaxf(reused, k_sel == k ? used[k] : 0.0f);
    const bool occ_hit = ok && reused > 0.0f;
    const float penal_occ = occ_hit ? 3.0f * nself : 0.0f;
    nself = nself + (occ_hit ? 1.0f : 0.0f);
    float dpen = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) dpen = dpen + (m_sel == m ? downg[m] : 0.0f);
    const float penal_down = ok ? dpen : 0.0f;
    weight = weight + (ok ? score : 0.0f) - penal_occ - penal_down;
    if constexpr (WANT_PAIRS) {
      pairs[(size_t)(2 * step) * n + lane] = ok ? m_sel : -1;
      pairs[(size_t)(2 * step + 1) * n + lane] = ok ? k_sel : -1;
      n_pairs += ok ? 1 : 0;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) used[k] = used[k] + ((k_sel == k && ok) ? 1.0f : 0.0f);
#pragma unroll
    for (int r = 0; r < M * K; ++r) dist[r] = (r / K == m_sel && ok) ? kBig : dist[r];
  }
  if constexpr (WANT_PAIRS) ncorr[lane] = n_pairs;
  return weight;
}

}  // namespace
