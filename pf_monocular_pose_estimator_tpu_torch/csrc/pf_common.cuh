// Device code shared by the PF pass kernel (pf_step.cu, kernel B) and the
// standalone weight kernel (pf_weight.cu, kernel E): the threefry-2x32
// counter stream, the block's staged parameters and the marker-major greedy
// weight of one particle.
//
// The weight is the reference's Pallas weight function
//   pf_monocular_pose_estimator_tpu/pf/pallas_weight.py::_weight_from_rows
// for one lane: the M markers are projected, the M x K squared-distance
// volume (3e37 sentinel added on masked cells) is flattened marker-major
// (row m * K + k), and M rounds of greedy first-minimum matching score it,
// each retiring the matched marker's row.  The volume is never held: a row
// that is not retired never changes (detections are not removed, reuse is
// penalised through `used`), so the first minimum of the flattened volume is
// the first minimum over the M row minima, each a (value, first k) pair
// taken while the volume is built, and a retired row is the pair (3e37, 0).
// A greedy step is then O(M) instead of O(M K).  A NaN cell makes the
// reference's minimum NaN (jnp.min, torch.min propagate it), so no step of
// that lane forms a pair.  Everything lives in registers: M and K are
// template parameters and every loop unrolls.  Built with --fmad=false so
// each product rounds as the reference writes it.
//
// Two forms: `greedy_weight<M, K>` for the shapes the tracker runs by
// default (K = 16, 3 <= M <= 8), and `greedy_weight_wide<MC>` for every
// other 1 <= K <= kMaxK, 1 <= M <= kMaxM: M rounded up to a bucket MC of
// {8, 16, 32} (rows m >= M are never read), K a runtime loop bound over the
// detections staged in shared memory, `used` four words of bits.  Same
// expressions in the same order, so both equal the plain twin bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e37f;
constexpr int kPfThreads = 128;  // threads a block of kernels B and E (PERF.md: against 256)
constexpr int kMaxK = 128;       // detections the wide form takes (kernel A's top-k cap)
constexpr int kMaxM = 32;        // markers the wide form takes

// the marker bucket of the wide form
__host__ __device__ constexpr int marker_bucket(int m) { return m <= 8 ? 8 : m <= 16 ? 16 : 32; }

__host__ __device__ constexpr int n_weight_params(int m, int k) { return 8 + 4 * m + 3 * k + m; }

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

// Copy a launch's `count` uniform parameters into shared memory, once a block.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// Weight of the particle whose first 12 pose rows are `rows`.
// wprm: scal[8] (fx fy cx cy tol_pf tol_init num_markers_score 0) | mark[4M]
// (xyz per marker | 0 or 3e37) | dets[3K] (xy per detection | 0 or 3e37) |
// downg[M] (0 or 2).  With WANT_PAIRS, greedy step s writes
// pairs[(2s) * n + lane] = marker, pairs[(2s + 1) * n + lane] = detection
// (-1 where no pair formed) and ncorr[lane] = the number of pairs.
template <int M, int K, bool WANT_PAIRS>
__device__ __forceinline__ float greedy_weight(const float* rows, const float* wprm, int lane,
                                               int n, int* __restrict__ pairs,
                                               int* __restrict__ ncorr) {
  static_assert(K <= 32, "`used` holds one bit a detection");
  const float* scal = wprm;
  const float* mark = wprm + 8;
  const float* dets = mark + 4 * M;
  const float* downg = dets + 3 * K;
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  const float tol_pf = scal[4], tol_init = scal[5], nms = scal[6];
  float u[M], v[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float mx = mark[3 * m + 0], my = mark[3 * m + 1], mz = mark[3 * m + 2];
    const float xc = rows[0] * mx + rows[1] * my + rows[2] * mz + rows[3];
    const float yc = rows[4] * mx + rows[5] * my + rows[6] * mz + rows[7];
    const float zc = rows[8] * mx + rows[9] * my + rows[10] * mz + rows[11];
    const float safe_z = fabsf(zc) < 1e-12f ? 1e-12f : zc;
    u[m] = fx * xc / safe_z + cx;
    v[m] = fy * yc / safe_z + cy;
  }

  // The volume, one detection at a time: each marker row keeps its first
  // minimum (strict <, so the smaller k wins a tie) and any NaN is noted.
  float rmin[M];
  int rk[M];
  bool nan = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float dx = dets[2 * k], dy = dets[2 * k + 1], dbig = dets[2 * K + k];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float du = dx - u[m];
      const float dv = dy - v[m];
      const float cell = du * du + dv * dv + dbig + mark[3 * M + m];
      nan |= cell != cell;
      if (k == 0 || cell < rmin[m]) {
        rmin[m] = cell;
        rk[m] = k;
      }
    }
  }

  float weight = 0.0f, nself = 1.0f;
  bool done = nan;
  uint32_t used = 0u;  // bit k: detection k is matched (`reused` only asks > 0)
  int n_pairs = 0;
#pragma unroll
  for (int step = 0; step < M; ++step) {
    // first minimum over the row pairs: ties go to the smaller m, which is
    // the flattened index order m * K + k
    float minv = rmin[0];
    int m_sel = 0, k_sel = rk[0];
#pragma unroll
    for (int m = 1; m < M; ++m) {
      const bool lt = rmin[m] < minv;
      minv = lt ? rmin[m] : minv;
      m_sel = lt ? m : m_sel;
      k_sel = lt ? rk[m] : k_sel;
    }
    const float d = sqrtf(fmaxf(minv, 0.0f));
    const bool ok = (d <= tol_pf) && !done;
    done = done || !ok;
    const float q = (tol_init - d) / tol_init;
    const float score = nms + q * q;
    const bool occ_hit = ok && ((used >> k_sel) & 1u);
    const float penal_occ = occ_hit ? 3.0f * nself : 0.0f;
    nself = nself + (occ_hit ? 1.0f : 0.0f);
    const float penal_down = ok ? downg[m_sel] : 0.0f;
    weight = weight + (ok ? score : 0.0f) - penal_occ - penal_down;
    if constexpr (WANT_PAIRS) {
      pairs[(size_t)(2 * step) * n + lane] = ok ? m_sel : -1;
      pairs[(size_t)(2 * step + 1) * n + lane] = ok ? k_sel : -1;
      n_pairs += ok ? 1 : 0;
    }
    used |= (ok ? 1u : 0u) << k_sel;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (ok && m == m_sel) {  // retire the matched marker's row
        rmin[m] = kBig;
        rk[m] = 0;
      }
    }
  }
  if constexpr (WANT_PAIRS) ncorr[lane] = n_pairs;
  return weight;
}

// The weight of `greedy_weight` for runtime m <= MC markers and k <= kMaxK
// detections (wprm laid out for m and k).
template <int MC, bool WANT_PAIRS>
__device__ __forceinline__ float greedy_weight_wide(const float* rows, const float* wprm, int m,
                                                    int k, int lane, int n,
                                                    int* __restrict__ pairs,
                                                    int* __restrict__ ncorr) {
  const float* scal = wprm;
  const float* mark = wprm + 8;
  const float* dets = mark + 4 * m;
  const float* downg = dets + 3 * k;
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  const float tol_pf = scal[4], tol_init = scal[5], nms = scal[6];
  float u[MC], v[MC];
#pragma unroll
  for (int mi = 0; mi < MC; ++mi) {
    u[mi] = v[mi] = 0.0f;
    if (mi < m) {
      const float mx = mark[3 * mi + 0], my = mark[3 * mi + 1], mz = mark[3 * mi + 2];
      const float xc = rows[0] * mx + rows[1] * my + rows[2] * mz + rows[3];
      const float yc = rows[4] * mx + rows[5] * my + rows[6] * mz + rows[7];
      const float zc = rows[8] * mx + rows[9] * my + rows[10] * mz + rows[11];
      const float safe_z = fabsf(zc) < 1e-12f ? 1e-12f : zc;
      u[mi] = fx * xc / safe_z + cx;
      v[mi] = fy * yc / safe_z + cy;
    }
  }

  float rmin[MC];
  int rk[MC];
#pragma unroll
  for (int mi = 0; mi < MC; ++mi) {
    rmin[mi] = kBig;
    rk[mi] = 0;
  }
  bool nan = false;
#pragma unroll 1
  for (int kk = 0; kk < k; ++kk) {
    const float dx = dets[2 * kk], dy = dets[2 * kk + 1], dbig = dets[2 * k + kk];
#pragma unroll
    for (int mi = 0; mi < MC; ++mi) {
      if (mi < m) {
        const float du = dx - u[mi];
        const float dv = dy - v[mi];
        const float cell = du * du + dv * dv + dbig + mark[3 * m + mi];
        nan |= cell != cell;
        if (kk == 0 || cell < rmin[mi]) {
          rmin[mi] = cell;
          rk[mi] = kk;
        }
      }
    }
  }

  float weight = 0.0f, nself = 1.0f;
  bool done = nan;
  uint32_t used0 = 0u, used1 = 0u, used2 = 0u, used3 = 0u;  // bit k: detection k matched
  int n_pairs = 0;
#pragma unroll 1
  for (int step = 0; step < m; ++step) {
    // first minimum over the rows m' < m: ties go to the smaller m'
    float minv = rmin[0];
    int m_sel = 0, k_sel = rk[0];
#pragma unroll
    for (int mi = 1; mi < MC; ++mi) {
      const bool lt = mi < m && rmin[mi] < minv;
      minv = lt ? rmin[mi] : minv;
      m_sel = lt ? mi : m_sel;
      k_sel = lt ? rk[mi] : k_sel;
    }
    const float d = sqrtf(fmaxf(minv, 0.0f));
    const bool ok = (d <= tol_pf) && !done;
    done = done || !ok;
    const float q = (tol_init - d) / tol_init;
    const float score = nms + q * q;
    const uint32_t word = k_sel < 32 ? used0 : k_sel < 64 ? used1 : k_sel < 96 ? used2 : used3;
    const bool occ_hit = ok && ((word >> (k_sel & 31)) & 1u);
    const float penal_occ = occ_hit ? 3.0f * nself : 0.0f;
    nself = nself + (occ_hit ? 1.0f : 0.0f);
    const float penal_down = ok ? downg[m_sel] : 0.0f;
    weight = weight + (ok ? score : 0.0f) - penal_occ - penal_down;
    if constexpr (WANT_PAIRS) {
      pairs[(size_t)(2 * step) * n + lane] = ok ? m_sel : -1;
      pairs[(size_t)(2 * step + 1) * n + lane] = ok ? k_sel : -1;
      n_pairs += ok ? 1 : 0;
    }
    const uint32_t bit = (ok ? 1u : 0u) << (k_sel & 31);
    used0 |= k_sel < 32 ? bit : 0u;
    used1 |= (k_sel >= 32 && k_sel < 64) ? bit : 0u;
    used2 |= (k_sel >= 64 && k_sel < 96) ? bit : 0u;
    used3 |= k_sel >= 96 ? bit : 0u;
#pragma unroll
    for (int mi = 0; mi < MC; ++mi) {
      if (ok && mi == m_sel) {  // retire the matched marker's row
        rmin[mi] = kBig;
        rk[mi] = 0;
      }
    }
  }
  if constexpr (WANT_PAIRS) ncorr[lane] = n_pairs;
  return weight;
}

}  // namespace
