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
// default (K = 16, 3 <= M <= 8), and `greedy_weight_wide` for every other
// 1 <= K <= kMaxK, 1 <= M <= kMaxM.  The wide form's volume is mostly
// padding: a masked detection slot (mask term 3e37) in a row whose real
// detections already give a smaller cell can never be that row's first
// minimum, since its cell is at least 3e37 + the row's mask term (float
// addition is monotone and every distance is >= 0).  So the block lists the
// real detections (mask term 0) and the masked ones apart, once; a lane
// takes each row's first minimum over the real ones and walks the masked
// ones only when a row's minimum reached that bound, merging them by
// (value, k) so ties still go to the lower k.  Rows go four at a time in
// registers (the last group exactly the rows left, no bucket), their
// (value, k) pairs into the thread's column of shared memory, where the
// greedy steps read them.  A lane is NaN exactly when a marker's projection
// is (with finite detections and mask terms >= 0); a block whose detections
// or mask terms are anything else walks every cell in k order as the
// reference writes it.  Same expressions in the same order, so both forms
// equal the plain twin bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e37f;
constexpr int kPfThreads = 128;  // threads a block of kernels B and E (PERF.md: against 256)
constexpr int kMaxK = 128;       // detections the wide form takes (kernel A's top-k cap)
constexpr int kMaxM = 32;        // markers the wide form takes

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

// The wide form's per-block state: the detections listed real first, then
// masked, each in k order, (x, y, mask term, k); and each thread's row
// minima and their detections, one column a thread.
struct WideDets {
  float4 det[kMaxK];
  float rmin[kMaxM][kPfThreads];
  unsigned char rk[kMaxM][kPfThreads];
  int n_real, n_masked;
  int exact_rows;  // detections finite, mask terms finite and >= 0
  float dmin;      // the least masked detection's mask term
};

// The block's WideDets (allocated only in the kernels that call this).
__device__ __forceinline__ WideDets& wide_dets() {
  __shared__ WideDets wd;
  return wd;
}

// List the detections of wprm (laid out for m markers and k detections)
// into wd; every thread of the block calls it.
__device__ __forceinline__ void stage_wide(WideDets& wd, const float* wprm, int m, int k) {
  if (threadIdx.x < 32) {
    const float* mark = wprm + 8;
    const float* dets = mark + 4 * m;
    const int lane = threadIdx.x;
    const unsigned below = (1u << lane) - 1u;
    int n_real = 0;
    for (int base = 0; base < k; base += 32) {
      const int kk = base + lane;
      n_real += __popc(__ballot_sync(0xFFFFFFFFu, kk < k && dets[2 * k + kk] == 0.0f));
    }
    int nr = 0, nm = 0;
    bool fine = true;
    float dmin = INFINITY;
    for (int base = 0; base < k; base += 32) {
      const int kk = base + lane;
      const bool valid = kk < k;
      const float x = valid ? dets[2 * kk] : 0.0f, y = valid ? dets[2 * kk + 1] : 0.0f;
      const float big = valid ? dets[2 * k + kk] : 0.0f;
      const bool real = valid && big == 0.0f, masked = valid && !real;
      fine = fine && isfinite(x) && isfinite(y) && isfinite(big) && big >= 0.0f;
      if (masked) dmin = fminf(dmin, big);
      const unsigned br = __ballot_sync(0xFFFFFFFFu, real);
      const unsigned bm = __ballot_sync(0xFFFFFFFFu, masked);
      const float4 d4 = make_float4(x, y, big, __int_as_float(kk));
      if (real) wd.det[nr + __popc(br & below)] = d4;
      if (masked) wd.det[n_real + nm + __popc(bm & below)] = d4;
      nr += __popc(br);
      nm += __popc(bm);
    }
    for (int mi = lane; mi < m; mi += 32) {
      const float t = mark[3 * m + mi];
      fine = fine && isfinite(t) && t >= 0.0f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dmin = fminf(dmin, __shfl_xor_sync(0xFFFFFFFFu, dmin, off));
    fine = __all_sync(0xFFFFFFFFu, fine);
    if (lane == 0) {
      wd.n_real = nr;
      wd.n_masked = nm;
      wd.exact_rows = fine;
      wd.dmin = dmin;
    }
  }
  __syncthreads();
}

// Rows c0 .. c0 + CH - 1 of one lane: their projections and first minima,
// into this thread's column of wd; `nan` notes a NaN cell.
template <int CH>
__device__ __forceinline__ void wide_rows(const float* rows, const float* wprm, WideDets& wd,
                                          int m, int k, int c0, bool& nan) {
  const float* scal = wprm;
  const float* mark = wprm + 8;
  const float* dets = mark + 4 * m;
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  float u[CH], v[CH], tm[CH], rmin[CH];
  int rk[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int mi = c0 + i;
    const float mx = mark[3 * mi + 0], my = mark[3 * mi + 1], mz = mark[3 * mi + 2];
    const float xc = rows[0] * mx + rows[1] * my + rows[2] * mz + rows[3];
    const float yc = rows[4] * mx + rows[5] * my + rows[6] * mz + rows[7];
    const float zc = rows[8] * mx + rows[9] * my + rows[10] * mz + rows[11];
    const float safe_z = fabsf(zc) < 1e-12f ? 1e-12f : zc;
    u[i] = fx * xc / safe_z + cx;
    v[i] = fy * yc / safe_z + cy;
    tm[i] = mark[3 * m + mi];
    rmin[i] = INFINITY;  // an all-inf row's first minimum is (inf, 0), as the reference's
    rk[i] = 0;
  }
  if (wd.exact_rows) {
#pragma unroll
    for (int i = 0; i < CH; ++i) nan = nan || u[i] != u[i] || v[i] != v[i];
    const int n_real = wd.n_real, n_masked = wd.n_masked;
    for (int j = 0; j < n_real; ++j) {  // mask term 0: cell = (du^2 + dv^2 + 0) + t
      const float4 d4 = wd.det[j];
      const int kk = __float_as_int(d4.w);
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float du = d4.x - u[i];
        const float dv = d4.y - v[i];
        const float cell = du * du + dv * dv + tm[i];
        if (cell < rmin[i]) {
          rmin[i] = cell;
          rk[i] = kk;
        }
      }
    }
    bool reach = false;  // a masked cell could still be a row's first minimum
#pragma unroll
    for (int i = 0; i < CH; ++i) reach = reach || rmin[i] >= wd.dmin + tm[i];
    if (n_masked > 0 && reach) {
      for (int j = n_real; j < n_real + n_masked; ++j) {
        const float4 d4 = wd.det[j];
        const int kk = __float_as_int(d4.w);
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const float du = d4.x - u[i];
          const float dv = d4.y - v[i];
          const float cell = du * du + dv * dv + d4.z + tm[i];
          if (cell < rmin[i] || (cell == rmin[i] && kk < rk[i])) {
            rmin[i] = cell;
            rk[i] = kk;
          }
        }
      }
    }
  } else {  // every cell in k order, as the reference
    for (int kk = 0; kk < k; ++kk) {
      const float dx = dets[2 * kk], dy = dets[2 * kk + 1], dbig = dets[2 * k + kk];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float du = dx - u[i];
        const float dv = dy - v[i];
        const float cell = du * du + dv * dv + dbig + tm[i];
        nan = nan || cell != cell;
        if (cell < rmin[i]) {
          rmin[i] = cell;
          rk[i] = kk;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    wd.rmin[c0 + i][threadIdx.x] = rmin[i];
    wd.rk[c0 + i][threadIdx.x] = (unsigned char)rk[i];
  }
}

// The weight of `greedy_weight` for runtime 1 <= m <= kMaxM markers and
// 1 <= k <= kMaxK detections (wprm laid out for m and k, wd staged from it).
template <bool WANT_PAIRS>
__device__ __forceinline__ float greedy_weight_wide(const float* rows, const float* wprm,
                                                    WideDets& wd, int m, int k, int lane, int n,
                                                    int* __restrict__ pairs,
                                                    int* __restrict__ ncorr) {
  const float* scal = wprm;
  const float* downg = wprm + 8 + 4 * m + 3 * k;
  const float tol_pf = scal[4], tol_init = scal[5], nms = scal[6];
  bool nan = false;
  int c0 = 0;
  for (; c0 + 4 <= m; c0 += 4) wide_rows<4>(rows, wprm, wd, m, k, c0, nan);
  switch (m - c0) {
    case 3: wide_rows<3>(rows, wprm, wd, m, k, c0, nan); break;
    case 2: wide_rows<2>(rows, wprm, wd, m, k, c0, nan); break;
    case 1: wide_rows<1>(rows, wprm, wd, m, k, c0, nan); break;
    default: break;
  }

  const int t = threadIdx.x;
  float weight = 0.0f, nself = 1.0f;
  uint32_t used0 = 0u, used1 = 0u, used2 = 0u, used3 = 0u;  // bit k: detection k matched
  int step = 0;
  // a NaN lane, or the first step whose pair is beyond tol_pf, ends the
  // pairs: every later step selects no pair either
  for (; step < m && !nan; ++step) {
    // first minimum over the rows: ties go to the smaller row
    float minv = wd.rmin[0][t];
    int m_sel = 0;
    for (int mi = 1; mi < m; ++mi) {
      const float r = wd.rmin[mi][t];
      if (r < minv) {
        minv = r;
        m_sel = mi;
      }
    }
    const int k_sel = wd.rk[m_sel][t];
    const float d = sqrtf(fmaxf(minv, 0.0f));
    if (!(d <= tol_pf)) break;
    const float q = (tol_init - d) / tol_init;
    const float score = nms + q * q;
    const uint32_t word = k_sel < 32 ? used0 : k_sel < 64 ? used1 : k_sel < 96 ? used2 : used3;
    const bool occ_hit = (word >> (k_sel & 31)) & 1u;
    const float penal_occ = occ_hit ? 3.0f * nself : 0.0f;
    nself = nself + (occ_hit ? 1.0f : 0.0f);
    weight = weight + score - penal_occ - downg[m_sel];
    if constexpr (WANT_PAIRS) {
      pairs[(size_t)(2 * step) * n + lane] = m_sel;
      pairs[(size_t)(2 * step + 1) * n + lane] = k_sel;
    }
    const uint32_t bit = 1u << (k_sel & 31);
    used0 |= k_sel < 32 ? bit : 0u;
    used1 |= (k_sel >= 32 && k_sel < 64) ? bit : 0u;
    used2 |= (k_sel >= 64 && k_sel < 96) ? bit : 0u;
    used3 |= k_sel >= 96 ? bit : 0u;
    wd.rmin[m_sel][t] = kBig;  // retire the matched marker's row
    wd.rk[m_sel][t] = 0;
  }
  if constexpr (WANT_PAIRS) ncorr[lane] = step;
  if (step < m) {
    // each step left adds (0 - 0 - 0) in the reference; once is the same
    weight = weight + 0.0f - 0.0f - 0.0f;
    if constexpr (WANT_PAIRS) {
      for (int s = step; s < m; ++s) {
        pairs[(size_t)(2 * s) * n + lane] = -1;
        pairs[(size_t)(2 * s + 1) * n + lane] = -1;
      }
    }
  }
  return weight;
}

}  // namespace
