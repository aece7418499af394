// Batched Gauss-Newton pose refinement: a fixed budget of iterations for
// every hypothesis in one launch.
//
// Replaces the reference's Pallas TPU kernel
//   pf_monocular_pose_estimator_tpu/pf/pallas_refine.py::gauss_newton_refine_pallas
//   (_make_gn_kernel, _solve6_rows, _exp_se3_rows).
//
// Per hypothesis and iteration: project the M markers, form the Eade A.14
// Jacobian, build the 6x6 normal equations with 1e-8 damping, solve them by
// Jacobi-scaled 3x3-block Schur complement, scrub non-finite steps, apply
// the left exp-map update and freeze the hypothesis once max |dt| <= tol.
// After the budget: the final normal matrix, the largest pair residual and
// the divergence revert.  The covariance (inv6_spd of the normal matrix) is
// left to the caller, as in the reference.
//
// What bounds it on Hopper: latency.  11 hypotheses x 25 iterations x
// ~600 FLOP is ~0.2 MFLOP of dependent scalar math; there is nothing to
// stream, so the time is the length of one hypothesis's chain of dependent
// instructions.  The design shortens that chain:
//   * one warp per hypothesis.  Lane q < M projects marker q and stages its
//     Jacobian rows and residuals in shared memory; lanes 0..27 each take one
//     of the 28 normal-equation sums (21 entries of A's upper triangle, 6 of
//     b, the error) over the pairs in index order, `s = t_0; s = s + t_q`;
//     lanes 0..5 take the six Jacobi scales.  The rest of the solve, the exp
//     map and the pose update run alike on every lane from the shuffled
//     sums, so no lane waits for a broadcast;
//   * M is a template parameter (1..8), so every array is indexed by
//     constants and lives in registers.  ptxas still reports a 32-byte
//     stack frame: it is sinf/cosf's reduction of huge arguments (a build
//     with __sinf/__cosf has none), which the exact results need;
//   * a frozen hypothesis changes nothing more (pose, n_iter and the flag
//     stay as they are), so its warp leaves the loop: the outputs equal the
//     full budget's.
// Every sum keeps the order of the plain PyTorch version, and the kernel is
// built with --fmad=false, so both round alike.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxM = 8;
constexpr int kRow = 14;  // a pair's staged row: ju[0..5], jv[0..5], ru, rv
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kDamping = 1e-8f;
constexpr float kEpsTheta = 1e-8f;

// index of A's upper-triangle entry (i <= j) among the 28 sums, row by row;
// b[i] is sum 21 + i and the error sum 27
__host__ __device__ constexpr int upper(int i, int j) { return i * 6 - i * (i - 1) / 2 + (j - i); }

// the staged-row offsets of this lane's sum: term = r[o0] * r[o1] + r[o2] * r[o3]
__device__ __forceinline__ void term_offsets(int lane, int& o0, int& o1, int& o2, int& o3) {
  o0 = 12, o1 = 12, o2 = 13, o3 = 13;  // err: ru * ru + rv * rv
  if (lane < 21) {
    int rest = lane;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (rest >= 0 && rest < 6 - i) o0 = i, o1 = i + rest, o2 = 6 + i, o3 = 6 + i + rest;
      rest -= 6 - i;
    }
  } else if (lane < 27) {
    const int i = lane - 21;  // b: ju[i] * ru + jv[i] * rv
    o0 = i, o1 = 12, o2 = 6 + i, o3 = 13;
  }
}

// This lane's normal-equation sum at pose p; the pairs' rows stay staged.
template <int M>
__device__ __forceinline__ float pair_sums(const float p[16], int lane, float mx, float my,
                                           float mz, float du, float dv, float mk, float fx,
                                           float fy, float cx, float cy, float* stage, int o0,
                                           int o1, int o2, int o3) {
  __syncwarp();
  if (lane < M) {
    const float pcx = p[0] * mx + p[1] * my + p[2] * mz + p[3];
    const float pcy = p[4] * mx + p[5] * my + p[6] * mz + p[7];
    const float pcz = p[8] * mx + p[9] * my + p[10] * mz + p[11];
    const float z = fabsf(pcz) < 1e-12f ? 1e-12f : pcz;
    const float u = fx * pcx / z + cx;
    const float v = fy * pcy / z + cy;
    const float iz = 1.0f / z;
    const float x_z = pcx * iz;
    const float y_z = pcy * iz;
    float* r = stage + lane * kRow;
    r[0] = (fx * iz) * mk;
    r[1] = 0.0f * mk;
    r[2] = (-fx * x_z * iz) * mk;
    r[3] = (-fx * x_z * y_z) * mk;
    r[4] = (fx * (1.0f + x_z * x_z)) * mk;
    r[5] = (-fx * y_z) * mk;
    r[6] = 0.0f * mk;
    r[7] = (fy * iz) * mk;
    r[8] = (-fy * y_z * iz) * mk;
    r[9] = (-fy * (1.0f + y_z * y_z)) * mk;
    r[10] = (fy * x_z * y_z) * mk;
    r[11] = (fy * x_z) * mk;
    r[12] = (du - u) * mk;
    r[13] = (dv - v) * mk;
  }
  __syncwarp();
  float s = stage[o0] * stage[o1] + stage[o2] * stage[o3];
#pragma unroll
  for (int q = 1; q < M; ++q) {
    const float* r = stage + q * kRow;
    s = s + (r[o0] * r[o1] + r[o2] * r[o3]);
  }
  return s;
}

__device__ __forceinline__ void inv3sym(float m00, float m01, float m02, float m11, float m12,
                                        float m22, float out[3][3]) {
  const float c00 = m11 * m22 - m12 * m12;
  const float c01 = -(m01 * m22 - m12 * m02);
  const float c02 = m01 * m12 - m11 * m02;
  const float c11 = m00 * m22 - m02 * m02;
  const float c12 = -(m00 * m12 - m01 * m02);
  const float c22 = m00 * m11 - m01 * m01;
  float det = m00 * c00 + m01 * c01 + m02 * c02;
  det = fabsf(det) < 1e-30f ? 1e-30f : det;
  const float inv = 1.0f / det;
  out[0][0] = c00 * inv; out[0][1] = c01 * inv; out[0][2] = c02 * inv;
  out[1][0] = c01 * inv; out[1][1] = c11 * inv; out[1][2] = c12 * inv;
  out[2][0] = c02 * inv; out[2][1] = c12 * inv; out[2][2] = c22 * inv;
}

// Jacobi-scaled block-Schur solve of the damped normal equations, given the
// scales s[i] = 1 / sqrt(max(|a_ii|, 1e-30)).
__device__ __forceinline__ void solve6(const float a[6][6], const float b[6], const float s[6],
                                       float x[6]) {
  float ah[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int ii = i <= j ? i : j, jj = i <= j ? j : i;
      ah[i][j] = a[ii][jj] * s[ii] * s[jj];
    }
  float bh[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) bh[i] = b[i] * s[i];
  float pi[3][3], si[3][3], w[3][3], sc[3][3];
  inv3sym(ah[0][0], ah[0][1], ah[0][2], ah[1][1], ah[1][2], ah[2][2], pi);
  // W = Q^T @ Pi, Q = ah[0:3, 3:6]
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = acc + ah[k][3 + i] * pi[k][j];
      w[i][j] = acc;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = acc + w[i][k] * ah[k][3 + j];
      sc[i][j] = ah[3 + i][3 + j] - acc;
    }
  inv3sym(sc[0][0], sc[0][1], sc[0][2], sc[1][1], sc[1][2], sc[2][2], si);
  float rhs2[3], x2[3], rhs1[3], x1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc = acc + w[i][k] * bh[k];
    rhs2[i] = bh[3 + i] - acc;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc = acc + si[i][k] * rhs2[k];
    x2[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc = acc + ah[i][3 + k] * x2[k];
    rhs1[i] = bh[i] - acc;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc = acc + pi[i][k] * rhs1[k];
    x1[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = x1[i] * s[i];
    x[3 + i] = x2[i] * s[3 + i];
  }
}

// exp map of dt = [rho, omega] -> 12 row-major entries of [R | t]
__device__ __forceinline__ void exp_rows(const float dt[6], float e[12]) {
  const float rx = dt[0], ry = dt[1], rz = dt[2], wx = dt[3], wy = dt[4], wz = dt[5];
  const float th2 = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(fmaxf(th2, 0.0f));
  const bool small = th2 < kEpsTheta;
  const float safe_t = small ? 1.0f : theta;
  const float sin_t = sinf(safe_t);
  const float cos_t = cosf(safe_t);
  const float a = small ? 1.0f - th2 / 6.0f : sin_t / safe_t;
  const float b = small ? 0.5f - th2 / 24.0f : (1.0f - cos_t) / fmaxf(th2, kEpsTheta);
  const float c = small ? 1.0f / 6.0f - th2 / 120.0f
                        : (safe_t - sin_t) / fmaxf(th2 * safe_t, kEpsTheta);
  const float wxx = wx * wx, wyy = wy * wy, wzz = wz * wz;
  const float wxy = wx * wy, wxz = wx * wz, wyz = wy * wz;
  const float r00 = 1.0f + b * (wxx - th2);
  const float r01 = -a * wz + b * wxy;
  const float r02 = a * wy + b * wxz;
  const float r10 = a * wz + b * wxy;
  const float r11 = 1.0f + b * (wyy - th2);
  const float r12 = -a * wx + b * wyz;
  const float r20 = -a * wy + b * wxz;
  const float r21 = a * wx + b * wyz;
  const float r22 = 1.0f + b * (wzz - th2);
  const float v00 = 1.0f + c * (wxx - th2);
  const float v01 = -b * wz + c * wxy;
  const float v02 = b * wy + c * wxz;
  const float v10 = b * wz + c * wxy;
  const float v11 = 1.0f + c * (wyy - th2);
  const float v12 = -b * wx + c * wyz;
  const float v20 = -b * wy + c * wxz;
  const float v21 = b * wx + c * wyz;
  const float v22 = 1.0f + c * (wzz - th2);
  e[0] = r00; e[1] = r01; e[2] = r02; e[3] = v00 * rx + v01 * ry + v02 * rz;
  e[4] = r10; e[5] = r11; e[6] = r12; e[7] = v10 * rx + v11 * ry + v12 * rz;
  e[8] = r20; e[9] = r21; e[10] = r22; e[11] = v20 * rx + v21 * ry + v22 * rz;
}

// scal: [fx, fy, cx, cy, ...]; mark: (3, M) rows mx, my, mz; du/dv/mask: (b, M)
// out_pose: (b, 16); stats: (b, 8) [err0, err, n_iter, max_resid, done,
// diverged, 0, 0]; amat: (b, 36) final normal matrix (undamped).
// One block, one warp, a hypothesis (one warp a block measured faster on the
// H100 than 11 warps in one block: PERF.md, kernel D).
template <int M>
__global__ void gn_refine_kernel(const float* __restrict__ scal, const float* __restrict__ poses,
                                 const float* __restrict__ mark, const float* __restrict__ du_all,
                                 const float* __restrict__ dv_all,
                                 const float* __restrict__ mask_all, int max_iter,
                                 float tol, float* __restrict__ out_pose,
                                 float* __restrict__ stats, float* __restrict__ amat) {
  __shared__ float stage[M * kRow];
  const int lane = threadIdx.x;
  const int h = blockIdx.x;
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  float mx = 0.0f, my = 0.0f, mz = 0.0f, du = 0.0f, dv = 0.0f, mk = 0.0f;
  if (lane < M) {
    mx = mark[lane];
    my = mark[M + lane];
    mz = mark[2 * M + lane];
    du = du_all[h * M + lane];
    dv = dv_all[h * M + lane];
    mk = mask_all[h * M + lane];
  }
  int o0, o1, o2, o3;
  term_offsets(lane, o0, o1, o2, o3);
  const int diag = lane < 6 ? upper(lane, lane) : 0;
  float p[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = poses[h * 16 + i];
  float sum = pair_sums<M>(p, lane, mx, my, mz, du, dv, mk, fx, fy, cx, cy, stage, o0, o1, o2, o3);
  const float err0 = __shfl_sync(kFull, sum, 27);
  float done = 0.0f, n_iter = 0.0f;
  for (int it = 0; it < max_iter && !(done > 0.0f); ++it) {
    sum = pair_sums<M>(p, lane, mx, my, mz, du, dv, mk, fx, fy, cx, cy, stage, o0, o1, o2, o3);
    float a[6][6], b[6], s[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) a[i][j] = a[j][i] = __shfl_sync(kFull, sum, upper(i, j));
      b[i] = __shfl_sync(kFull, sum, 21 + i);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) a[i][i] = a[i][i] + kDamping;
    // the Jacobi scales, lane i < 6 for s[i]
    const float a_ii = __shfl_sync(kFull, sum, diag) + kDamping;
    const float scale = 1.0f / sqrtf(fmaxf(fabsf(a_ii), 1e-30f));
#pragma unroll
    for (int i = 0; i < 6; ++i) s[i] = __shfl_sync(kFull, scale, i);
    float dt[6];
    solve6(a, b, s, dt);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float d = dt[i];
      dt[i] = (d == d && fabsf(d) < 1e30f) ? d : 0.0f;
    }
    float e[12];
    exp_rows(dt, e);
    float newp[12];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        newp[r * 4 + c] = e[4 * r + 0] * p[c] + e[4 * r + 1] * p[4 + c] + e[4 * r + 2] * p[8 + c];
      newp[r * 4 + 3] = e[4 * r + 0] * p[3] + e[4 * r + 1] * p[7] + e[4 * r + 2] * p[11] +
                        e[4 * r + 3];
    }
    float step = fabsf(dt[0]);
#pragma unroll
    for (int i = 1; i < 6; ++i) step = fmaxf(step, fabsf(dt[i]));
    // not frozen here (the loop ends once it is)
#pragma unroll
    for (int i = 0; i < 12; ++i) p[i] = newp[i];
    n_iter = n_iter + 1.0f;
    done = step <= tol ? 1.0f : 0.0f;
  }
  sum = pair_sums<M>(p, lane, mx, my, mz, du, dv, mk, fx, fy, cx, cy, stage, o0, o1, o2, o3);
  float max_resid = 0.0f;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const float ru = stage[q * kRow + 12], rv = stage[q * kRow + 13];
    const float r = sqrtf(ru * ru + rv * rv);
    max_resid = q == 0 ? r : fmaxf(max_resid, r);
  }
  const float err = __shfl_sync(kFull, sum, 27);
  const bool diverged = err > err0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (lane == i) out_pose[h * 16 + i] = diverged ? poses[h * 16 + i] : p[i];
  if (lane < 8) {
    const float v = lane == 0   ? err0
                    : lane == 1 ? (diverged ? err0 : err)
                    : lane == 2 ? n_iter
                    : lane == 3 ? max_resid
                    : lane == 4 ? done
                    : lane == 5 ? (diverged ? 1.0f : 0.0f)
                                : 0.0f;
    stats[h * 8 + lane] = v;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = min(lane + 32 * r, 35), i = e / 6, j = e % 6;
    const float v = __shfl_sync(kFull, sum, i <= j ? upper(i, j) : upper(j, i));
    if (lane + 32 * r < 36) amat[h * 36 + e] = v;
  }
}

template <int M>
int launch(const float* scal, const float* poses, const float* mark, const float* du,
           const float* dv, const float* mask, int nb, int max_iter, float tol, float* out_pose,
           float* stats, float* amat, cudaStream_t st) {
  gn_refine_kernel<M><<<nb, 32, 0, st>>>(scal, poses, mark, du, dv, mask, max_iter, tol, out_pose,
                                         stats, amat);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pfmpe_gn_refine(const float* scal, const float* poses, const float* mark,
                               const float* du, const float* dv, const float* mask, int nb, int m,
                               int max_iter, float tol, float* out_pose, float* stats,
                               float* amat, void* stream) {
  if (m < 1 || m > kMaxM || nb < 1) return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const float*, const float*, const float*, const float*, const float*,
                         const float*, int, int, float, float*, float*, float*, cudaStream_t);
  constexpr Launch kLaunch[kMaxM] = {launch<1>, launch<2>, launch<3>, launch<4>,
                                     launch<5>, launch<6>, launch<7>, launch<8>};
  return kLaunch[m - 1](scal, poses, mark, du, dv, mask, nb, max_iter, tol, out_pose, stats, amat,
                        (cudaStream_t)stream);
}
