// Fused particle-filter iteration: propagate every particle of the (16, N)
// structure-of-arrays bank and weight it against the frame's detections.
//
// Replaces the reference's Pallas TPU kernel
//   pf_monocular_pose_estimator_tpu/pf/pallas_step.py::fused_propagate_weight_pallas
//   (its folded variant, _make_folded_kernel).
//
// Per particle: base = L @ T @ R (ego-motion / prediction compose); six
// uniforms drawn in the kernel from the threefry-2x32 counter stream at
// counter r * n_total + global_lane -- the same stream as jax.random, so the
// draws equal the reference's bit for bit; Rz @ Ry @ Rx noise rotation and
// additive translation noise; lanes 0 and 1 pinned to the current and
// predicted poses; then the M markers are projected, the M x K distance
// volume (3e37 sentinel on masked cells) is built and M rounds of greedy
// marker-major first-minimum matching score the particle.
//
// What bounds it on Hopper: one thread per particle reads 64 B and writes
// 68 B (6.8 MB for N = 100,000, ~2 us of HBM time at 3.35 TB/s); the work is
// ~1.5 k FLOP and ~20 threefry rounds x 6 draws per particle, so it is
// compute- and latency-bound at roughly 0.2 GFLOP per launch.  The design
// keeps the whole M x K volume and the greedy state in registers (M and K are
// template parameters, every loop unrolls) and reads the bank row by row so
// neighbouring threads touch neighbouring addresses.  The TPU kernel's
// sublane folding has no counterpart here.  Built with --fmad=false and
// precise sinf/cosf so every expression rounds as the reference writes it.

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

// params: lr[32] | pin[32] | prop[12] | scal[8] | mark[4M] | dets[3K] | downg[M]
template <int M, int K>
__global__ void __launch_bounds__(256) pf_step_kernel(const float* __restrict__ bank,
                                                      const float* __restrict__ prm, int n,
                                                      uint32_t kr0, uint32_t kr1, uint32_t kt0,
                                                      uint32_t kt1, int lane_offset, int n_total,
                                                      float* __restrict__ out,
                                                      float* __restrict__ wout) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float* lr = prm;
  const float* pin = prm + 32;
  const float* prop = prm + 64;
  const float* scal = prm + 76;
  const float* mark = prm + 84;
  const float* dets = mark + 4 * M;
  const float* downg = dets + 3 * K;

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
  const float ca = cosf(nz[0]), sa = sinf(nz[0]);
  const float cb = cosf(nz[1]), sb = sinf(nz[1]);
  const float cc = cosf(nz[2]), sc = sinf(nz[2]);
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

  // weight
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
#pragma unroll
    for (int k = 0; k < K; ++k) used[k] = used[k] + ((k_sel == k && ok) ? 1.0f : 0.0f);
#pragma unroll
    for (int r = 0; r < M * K; ++r) dist[r] = (r / K == m_sel && ok) ? kBig : dist[r];
  }
  wout[lane] = weight;
}

template <int M>
cudaError_t launch_m(const float* bank, const float* prm, int n, int k, const uint32_t* keys,
                     int lane_offset, int n_total, float* out, float* w, cudaStream_t st) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (k != 16) return cudaErrorInvalidValue;
  pf_step_kernel<M, 16><<<blocks, threads, 0, st>>>(bank, prm, n, keys[0], keys[1], keys[2],
                                                    keys[3], lane_offset, n_total, out, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pfmpe_pf_step(const float* bank, const float* prm, int n, int m, int k,
                             unsigned int kr0, unsigned int kr1, unsigned int kt0,
                             unsigned int kt1, int lane_offset, int n_total, float* out,
                             float* w, void* stream) {
  const uint32_t keys[4] = {kr0, kr1, kt0, kt1};
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  switch (m) {
    case 3: return (int)launch_m<3>(bank, prm, n, k, keys, lane_offset, n_total, out, w, st);
    case 4: return (int)launch_m<4>(bank, prm, n, k, keys, lane_offset, n_total, out, w, st);
    case 5: return (int)launch_m<5>(bank, prm, n, k, keys, lane_offset, n_total, out, w, st);
    case 6: return (int)launch_m<6>(bank, prm, n, k, keys, lane_offset, n_total, out, w, st);
    case 7: return (int)launch_m<7>(bank, prm, n, k, keys, lane_offset, n_total, out, w, st);
    case 8: return (int)launch_m<8>(bank, prm, n, k, keys, lane_offset, n_total, out, w, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
