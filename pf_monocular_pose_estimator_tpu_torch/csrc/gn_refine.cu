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
// left to the caller, as in the reference.  The fused refine below runs the
// same warp body inside its larger launch.
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
//     with __sinf/__cosf has none), which the exact results need.  For
//     9..32 markers one instantiation (M = 0) takes the count at run time:
//     lane q < M still projects pair q, the staged rows are in shared memory
//     in both forms, and the pair loops run to the runtime count in the
//     same order;
//   * a frozen hypothesis changes nothing more (pose, n_iter and the flag
//     stay as they are), so its warp leaves the loop: the outputs equal the
//     full budget's.
// Every sum keeps the order of the plain PyTorch version, and the kernel is
// built with --fmad=false, so both round alike.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxM = 32;   // markers a warp takes (one lane a pair)
constexpr int kFixedM = 8;  // counts with their own instantiation
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

// This lane's normal-equation sum at pose p over the m pairs (m = M when
// M > 0); the pairs' rows stay staged.
template <int M>
__device__ __forceinline__ float pair_sums(const float p[16], int lane, int m, float mx, float my,
                                           float mz, float du, float dv, float mk, float fx,
                                           float fy, float cx, float cy, float* stage, int o0,
                                           int o1, int o2, int o3) {
  if constexpr (M > 0) m = M;
  __syncwarp();
  if (lane < m) {
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
  for (int q = 1; q < m; ++q) {
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

// One hypothesis's run on one warp, lane q < m holding pair q (its marker
// mx, my, mz and detection du, dv, masked by mk): the full budget of
// iterations from pose p (updated in place; a frozen hypothesis leaves the
// loop, which changes no output), then the normal-equation sums at the
// final pose.  Returns this lane's sum there (lanes 0..27: A's upper
// triangle, b, the error); err0, n_iter, done and max_resid as D reports
// them.  Kernel D and the fused refine run it alike.
template <int M>
__device__ __forceinline__ float gn_warp(float p[16], int lane, int m, float mx, float my,
                                         float mz, float du, float dv, float mk, float fx,
                                         float fy, float cx, float cy, float* stage, int max_iter,
                                         float tol, float& err0, float& n_iter, float& done,
                                         float& max_resid) {
  int o0, o1, o2, o3;
  term_offsets(lane, o0, o1, o2, o3);
  const int diag = lane < 6 ? upper(lane, lane) : 0;
  float sum = pair_sums<M>(p, lane, m, mx, my, mz, du, dv, mk, fx, fy, cx, cy, stage, o0, o1,
                           o2, o3);
  err0 = __shfl_sync(kFull, sum, 27);
  done = 0.0f, n_iter = 0.0f;
  for (int it = 0; it < max_iter && !(done > 0.0f); ++it) {
    sum = pair_sums<M>(p, lane, m, mx, my, mz, du, dv, mk, fx, fy, cx, cy, stage, o0, o1,
                       o2, o3);
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
  sum = pair_sums<M>(p, lane, m, mx, my, mz, du, dv, mk, fx, fy, cx, cy, stage, o0, o1,
                     o2, o3);
  if constexpr (M > 0) m = M;
  max_resid = 0.0f;
#pragma unroll
  for (int q = 0; q < m; ++q) {
    const float ru = stage[q * kRow + 12], rv = stage[q * kRow + 13];
    const float r = sqrtf(ru * ru + rv * rv);
    max_resid = q == 0 ? r : fmaxf(max_resid, r);
  }
  return sum;
}

// The normal matrix entry e (row-major 6x6) from the lanes' sums.
__device__ __forceinline__ float amat_entry(float sum, int e) {
  const int i = e / 6, j = e % 6;
  return __shfl_sync(kFull, sum, i <= j ? upper(i, j) : upper(j, i));
}

// scal: [fx, fy, cx, cy, ...]; mark: (3, M) rows mx, my, mz; du/dv/mask: (b, M)
// out_pose: (b, 16); stats: (b, 8) [err0, err, n_iter, max_resid, done,
// diverged, 0, 0]; amat: (b, 36) final normal matrix (undamped).
// One block, one warp, a hypothesis (one warp a block measured faster on the
// H100 than 11 warps in one block: PERF.md, kernel D).  M > 0: M markers;
// M = 0: m_rt <= kMaxM markers.
template <int M>
__global__ void gn_refine_kernel(const float* __restrict__ scal, const float* __restrict__ poses,
                                 const float* __restrict__ mark, const float* __restrict__ du_all,
                                 const float* __restrict__ dv_all,
                                 const float* __restrict__ mask_all, int max_iter,
                                 float tol, float* __restrict__ out_pose,
                                 float* __restrict__ stats, float* __restrict__ amat, int m_rt) {
  __shared__ float stage[(M > 0 ? M : kMaxM) * kRow];
  const int m = M > 0 ? M : m_rt;
  const int lane = threadIdx.x;
  const int h = blockIdx.x;
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  float mx = 0.0f, my = 0.0f, mz = 0.0f, du = 0.0f, dv = 0.0f, mk = 0.0f;
  if (lane < m) {
    mx = mark[lane];
    my = mark[m + lane];
    mz = mark[2 * m + lane];
    du = du_all[h * m + lane];
    dv = dv_all[h * m + lane];
    mk = mask_all[h * m + lane];
  }
  float p[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = poses[h * 16 + i];
  float err0, n_iter, done, max_resid;
  const float sum = gn_warp<M>(p, lane, m, mx, my, mz, du, dv, mk, fx, fy, cx, cy, stage,
                               max_iter, tol, err0, n_iter, done, max_resid);
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
    const int e = min(lane + 32 * r, 35);
    const float v = amat_entry(sum, e);
    if (lane + 32 * r < 36) amat[h * 36 + e] = v;
  }
}

// ---------------------------------------------------------------------------
// The fused refine: the track branch's whole refine layer in one launch
// (`tracker/step.py::refine_hypotheses` op by op, `pf/refine_kernel.py::
// refine_frame_plain` in this kernel's order).  From the picked particle's
// pose pre_gn:
//   1. its pairs: `pf/weight.py::weight_particles`' greedy matching on the
//      K x M squared distances (cells of a masked detection or marker hold
//      FLT_MAX / 4), its first minimum in flat index k * M + m, a step
//      accepted while sqrt(d2) <= tol_pf and no earlier step failed, the
//      chosen marker's column then retired.  Retiring a column changes no
//      other column, so each column's least (d2, k) is found once and a step
//      is a warp argmin over the M columns; a NaN cell in any column fails
//      the first step, as torch.min's NaN does;
//   2. the hypotheses: the base binding, for each marker its nearest other
//      detection (`alt`, kept where within tol_pf and the marker is bound)
//      and the marker dropped: 2M + 1 rows, or the base alone;
//   3. kernel D's Gauss-Newton (`gn_warp`), one warp a hypothesis, warps
//      looping over the rows where there are more rows than warps;
//   4. the pick: the feasible hypothesis (largest residual within the gate,
//      a pair at least, within the step radius) with most pairs, the first
//      of equals (the first argmax of n_pairs - 1e-3 h); pre_gn where none
//      is; then the rotation jump test and the teleport guard;
//   5. the covariance of the picked hypothesis alone: `pf/refine.py::
//      inv6_spd` of its normal matrix + 1e-8 I, the Jacobi-scaled block
//      Schur inverse in that function's order (the 3x3 inverses by
//      cofactors over the determinant, the 3x3 products as torch's batched
//      matmul on the card sums them, so that the covariance equals what
//      the layer op by op gives there).
// Latency-bound like D (~0.2 MFLOP of dependent scalar math): one block,
// the pairs and the pick on warp 0, the rows staged in shared memory.
constexpr int kMaxK = 128;          // detection slots (pf/weight_kernel.py MAX_DETECTIONS)
constexpr int kWideWarps = 16;      // warps of the runtime-count form (up to 65 rows)
constexpr float kCap = FLT_MAX * 0.25f;  // weight_particles' masked-cell distance
constexpr float kFar = 1e12f;            // the alternative search's masked-cell distance
constexpr int kHypotheses = 1, kGuard = 2;  // `flags` bits

template <int M>
struct FrameShared {
  static constexpr int kM = M > 0 ? M : kMaxM;
  static constexpr int kRows = 2 * kM + 1;
  static constexpr int kWarps = M > 0 ? kRows : kWideWarps;
  float stage[kWarps][kM * kRow];
  float pose[kRows][16];
  float amat[kRows][36];
  float resid[kRows];
  float iters[kRows];
  int pairs[kRows];
  float det[kMaxK][2];
  int det_ok[kMaxK];
  int dfm[kM];
  int alt[kM];
};

// 3x3 inverse by cofactors over the determinant (`pf/refine.py::_inv3`)
__device__ __forceinline__ void inv3(const float m[3][3], float out[3][3]) {
  const float a = m[0][0], b = m[0][1], c = m[0][2];
  const float d = m[1][0], e = m[1][1], f = m[1][2];
  const float g = m[2][0], h = m[2][1], i = m[2][2];
  const float ca = e * i - f * h;
  const float cb = -(d * i - f * g);
  const float cc = d * h - e * g;
  const float cd = -(b * i - c * h);
  const float ce = a * i - c * g;
  const float cf = -(a * h - b * g);
  const float cg = b * f - c * e;
  const float ch = -(a * f - c * d);
  const float ci = a * e - b * d;
  float det = a * ca + b * cb + c * cc;
  det = fabsf(det) < 1e-30f ? 1e-30f : det;
  out[0][0] = ca / det; out[0][1] = cd / det; out[0][2] = cg / det;
  out[1][0] = cb / det; out[1][1] = ce / det; out[1][2] = ch / det;
  out[2][0] = cc / det; out[2][1] = cf / det; out[2][2] = ci / det;
}

// out = op(a) @ b with op(a) = a or a^T, as torch's batched matmul sums it
// on the card (cuBLAS): from 0, one fused multiply-add a term in index order
template <bool TransA>
__device__ __forceinline__ void mm3(const float a[3][3], const float b[3][3], float out[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = __fmaf_rn(TransA ? a[k][i] : a[i][k], b[k][j], acc);
      out[i][j] = acc;
    }
}

// `pf/refine.py::inv6_spd` of one 6x6 matrix
__device__ __forceinline__ void inv6_spd(const float a[6][6], float out[6][6]) {
  float inv_d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float d = sqrtf(fabsf(a[i][i]));
    inv_d[i] = 1.0f / (d > 0.0f ? d : 1.0f);
  }
  float p[3][3], q[3][3], s[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p[i][j] = a[i][j] * inv_d[i] * inv_d[j];
      q[i][j] = a[i][3 + j] * inv_d[i] * inv_d[3 + j];
      s[i][j] = a[3 + i][3 + j] * inv_d[3 + i] * inv_d[3 + j];
    }
  float p_inv[3][3], qt_pinv[3][3], qq[3][3], schur_inv[3][3], t1[3][3], t2[3][3], nq[3][3];
  inv3(p, p_inv);
  mm3<true>(q, p_inv, qt_pinv);
  mm3<false>(qt_pinv, q, qq);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) qq[i][j] = s[i][j] - qq[i][j];
  inv3(qq, schur_inv);
  mm3<true>(qt_pinv, schur_inv, t1);  // qt_pinv^T @ schur_inv
  mm3<false>(t1, qt_pinv, t2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) nq[i][j] = -qt_pinv[i][j];
  mm3<true>(nq, schur_inv, t1);  // (-qt_pinv)^T @ schur_inv: the top right block
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[i][j] = (p_inv[i][j] + t2[i][j]) * inv_d[i] * inv_d[j];
      out[i][3 + j] = t1[i][j] * inv_d[i] * inv_d[3 + j];
      out[3 + i][j] = t1[j][i] * inv_d[3 + i] * inv_d[j];
      out[3 + i][3 + j] = schur_inv[i][j] * inv_d[3 + i] * inv_d[3 + j];
    }
}

// the warp's least (value, index) pair, ties to the smaller index
__device__ __forceinline__ void warp_argmin(float& v, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ov < v || (ov == v && oi < idx)) v = ov, idx = oi;
  }
}

// sqrt((x^2 + y^2) + z^2) of a translation difference
__device__ __forceinline__ float dist3(const float* a, const float* b) {
  const float dx = a[3] - b[3], dy = a[7] - b[7], dz = a[11] - b[11];
  return sqrtf(dx * dx + dy * dy + dz * dz);
}

// scal [fx, fy, cx, cy]; pre_gn (16); mark (4, M) rows x, y, z, w; marker_mask
// (M) and det_mask (K) bool; det_xy (K, 2); tol_pf, jump_thr, predicted (16)
// and trust (bool) on the device.  out: the published pose (16) then the
// covariance (36); info: [n_iter, picked row, any feasible, teleported];
// jump (bool).
template <int M>
__global__ void __launch_bounds__(32 * FrameShared<M>::kWarps)
refine_frame_kernel(const float* __restrict__ scal, const float* __restrict__ pre_gn,
                    const float* __restrict__ mark, const unsigned char* __restrict__ marker_mask,
                    const float* __restrict__ det_xy, const unsigned char* __restrict__ det_mask,
                    const float* __restrict__ tol_pf_p, const float* __restrict__ jump_thr,
                    const float* __restrict__ predicted, const unsigned char* __restrict__ trust,
                    int m_rt, int k, int max_iter, float tol, float gate, float step_radius,
                    float jump_radius, int flags, float* __restrict__ out,
                    int* __restrict__ info, unsigned char* __restrict__ jump_out) {
  using S = FrameShared<M>;
  __shared__ S sh;
  const int m = M > 0 ? M : m_rt;
  const int rows = (flags & kHypotheses) ? 2 * m + 1 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  float p0[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) p0[i] = pre_gn[i];
  float mx = 0.0f, my = 0.0f, mz = 0.0f;
  bool m_ok = false;
  if (lane < m) {
    mx = mark[lane];
    my = mark[m + lane];
    mz = mark[2 * m + lane];
    m_ok = marker_mask[lane] != 0;
  }

  if (warp == 0) {
    for (int kk = lane; kk < k; kk += 32) {
      sh.det[kk][0] = det_xy[2 * kk];
      sh.det[kk][1] = det_xy[2 * kk + 1];
      sh.det_ok[kk] = det_mask[kk] != 0;
    }
    __syncwarp();
    // 1. pre_gn's pairs: lane q holds marker q's column
    const float tol_pf = tol_pf_p[0];
    float u = 0.0f, v = 0.0f;
    float cmin = INFINITY;
    int ck = 0;
    bool nan = false;
    if (lane < m) {
      const float mw = mark[3 * m + lane];
      const float pcx = p0[0] * mx + p0[1] * my + p0[2] * mz + p0[3] * mw;
      const float pcy = p0[4] * mx + p0[5] * my + p0[6] * mz + p0[7] * mw;
      const float pcz = p0[8] * mx + p0[9] * my + p0[10] * mz + p0[11] * mw;
      const float z = fabsf(pcz) < 1e-12f ? 1e-12f : pcz;
      u = fx * pcx / z + cx;
      v = fy * pcy / z + cy;
      for (int kk = 0; kk < k; ++kk) {
        const float dx = sh.det[kk][0] - u, dy = sh.det[kk][1] - v;
        const float d2 = (sh.det_ok[kk] && m_ok) ? dx * dx + dy * dy : kCap;
        if (d2 != d2) nan = true;
        else if (kk == 0 || d2 < cmin) cmin = d2, ck = kk;
      }
    }
    int dfm = -1;
    if (!__any_sync(kFull, nan)) {
      for (int step = 0; step < m; ++step) {
        float best = lane < m ? cmin : INFINITY;
        int flat = lane < m ? ck * m + lane : INT_MAX;
        warp_argmin(best, flat);
        if (!(sqrtf(best) <= tol_pf)) break;
        const int col = flat % m;
        if (lane == col) {
          dfm = max(dfm, flat / m);
          cmin = kCap, ck = 0;
        }
      }
    }
    // 2. each bound marker's nearest other detection
    int alt = dfm;
    if ((flags & kHypotheses) && lane < m) {
      const int bound = min(max(dfm, 0), k - 1);
      float amin = INFINITY;
      int ak = 0;
      bool anan = false;
      for (int kk = 0; kk < k; ++kk) {
        const float dx = sh.det[kk][0] - u, dy = sh.det[kk][1] - v;
        const float d2 = (sh.det_ok[kk] && kk != bound) ? dx * dx + dy * dy : kFar;
        if (d2 != d2) anan = true;
        else if (kk == 0 || d2 < amin) amin = d2, ak = kk;
      }
      if (!anan && amin <= tol_pf * tol_pf && dfm >= 0) alt = ak;
    }
    if (lane < m) sh.dfm[lane] = dfm, sh.alt[lane] = alt;
  }
  __syncthreads();

  // 3. Gauss-Newton, one warp a row: base, swap marker h - 1, drop marker h - 1 - m
  for (int h = warp; h < rows; h += warps) {
    float du = 0.0f, dv = 0.0f, mk = 0.0f;
    if (lane < m) {
      int e = sh.dfm[lane];
      if (h >= 1 && h <= m && lane == h - 1) e = sh.alt[lane];
      if (h > m && lane == h - 1 - m) e = -1;
      const int idx = min(max(e, 0), k - 1);
      du = sh.det[idx][0];
      dv = sh.det[idx][1];
      mk = (e >= 0 && m_ok) ? 1.0f : 0.0f;
    }
    const int n_pairs = __popc(__ballot_sync(kFull, mk > 0.0f));
    float p[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = p0[i];
    float err0, n_iter, done, max_resid;
    const float sum = gn_warp<M>(p, lane, m, mx, my, mz, du, dv, mk, fx, fy, cx, cy,
                                 sh.stage[warp], max_iter, tol, err0, n_iter, done, max_resid);
    const bool diverged = __shfl_sync(kFull, sum, 27) > err0;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (lane == i) sh.pose[h][i] = diverged ? p0[i] : p[i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = min(lane + 32 * r, 35);
      const float a = amat_entry(sum, e);
      if (lane + 32 * r < 36) sh.amat[h][e] = a;
    }
    if (lane == 0) sh.resid[h] = max_resid, sh.iters[h] = n_iter, sh.pairs[h] = n_pairs;
    __syncwarp();
  }
  __syncthreads();
  if (warp != 0) return;

  // 4. the pick: most pairs among the feasible rows, the first of equals
  float key = -INFINITY;
  int pick = INT_MAX;
  for (int h = lane; h < rows; h += 32) {
    const float n_pairs = (float)sh.pairs[h];
    const bool feasible = sh.resid[h] <= gate && n_pairs > 0.0f &&
                          dist3(sh.pose[h], p0) <= step_radius;
    const float pref = n_pairs - 1e-3f * (float)h;
    if (feasible && (pref > key || (pref == key && h < pick))) key = pref, pick = h;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(kFull, key, off);
    const int oh = __shfl_xor_sync(kFull, pick, off);
    if (ok > key || (ok == key && oh < pick)) key = ok, pick = oh;
  }
  const bool any = pick != INT_MAX;
  const int best = any ? pick : 0;
  float pose[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) pose[i] = any ? sh.pose[best][i] : p0[i];
  float rot = 0.0f;
  bool rot_nan = false;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g = fabsf(pose[4 * r + c] - p0[4 * r + c]);
      rot_nan |= g != g;
      rot = fmaxf(rot, g);
    }
  bool jump = !rot_nan && rot >= jump_thr[0];
  bool teleport = false;
  if (flags & kGuard) teleport = trust[0] != 0 && dist3(pose, predicted) > jump_radius;
  jump = jump || teleport;

  // 5. the picked row's covariance
  float a[6][6], cov[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) a[i][j] = sh.amat[best][6 * i + j] + (i == j ? kDamping : 0.0f);
  inv6_spd(a, cov);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (lane == i) out[i] = teleport ? predicted[i] : pose[i];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = lane + 32 * r;
    float c = 0.0f;
#pragma unroll
    for (int i = 0; i < 36; ++i)
      if (i == e) c = cov[i / 6][i % 6];
    if (e < 36) out[16 + e] = c;
  }
  if (lane == 0) {
    info[0] = (int)sh.iters[best];
    info[1] = best;
    info[2] = any;
    info[3] = teleport;
    jump_out[0] = jump;
  }
}

// ---------------------------------------------------------------------------
// One pose's refine in one launch (`pf/refine_kernel.py::refine_pose`): the
// Gauss-Newton of `pf/refine.py::gauss_newton_refine` on one pose, as torch
// computes it op by op on the card, with the pairs' gather and the
// covariance.  It serves no TPU kernel of its own: it is kernel #8's
// one-pose form, for the reference's plain `gauss_newton_refine` of one pose
// (`ipe_track_branch`'s refine and the init branch's), which
// `tracker/step.py::Tracker._refine_from` runs op by op without
// `use_pallas_gn`.
//
// The covariance of a 5-LED pose is ill-conditioned (cond ~3e4): a one-ulp
// change of the final pose or of one normal-matrix entry moves it by ~2e-3
// of its largest entry, as far as the benchmark's limit.  So this kernel is
// not D's iteration: it repeats the op-by-op path's arithmetic to the bit.
// Every elementwise op rounds as torch's kernel does (`/` by a host scalar
// multiplies by its float reciprocal; --fmad=false keeps products and sums
// apart), and every matmul and einsum sums in the order torch's cuBLAS call
// takes on the card (`Sum` below, measured on the H100).  Lane q < M loads
// marker q and gathers its detection (a pair is live where dfm[q] >= 0 and
// the marker is unmasked) and stages its two Jacobian rows and residuals;
// lanes 0..27 take the 21 + 6 normal-equation sums and the error, as D's
// lanes do; the solve, exp map and compose run alike on every lane.
// What bounds it: latency, as D: 25 dependent iterations on one warp; its
// bytes (a few hundred) take D's ~0.001 us at 3.35 TB/s.

// How torch's cuBLAS calls on the card sum a dot product of n terms
// a[k] * b[k] (recorded on the H100 for every matmul and einsum of the path,
// each layout on its own; every kind held to the bit over 60 problems at
// M = 5, the einsums and the error sum at every M to 32):
enum class Sum {
  kFmaSeq,    // acc = 0; acc = fma(a[k], b[k], acc), k ascending: a matmul whose
              // left operand is a transposed view, and einsum "cri,crj->ij"
  kPlainSeq,  // acc = a[0] * b[0]; acc = acc + a[k] * b[k], each product rounded
  kPairs,     // fma(a[k + 1], b[k + 1], a[k] * b[k]) for each pair, an odd last
              // product rounded, the pairs' sums added in order: a matmul whose
              // left operand is row-major
  kHalves,    // kFmaSeq over each half (the first ceil(n / 2) terms, the rest),
              // then their sum: einsum "cri,cr->i" (a matrix times a vector)
};

constexpr int kRowJ = 7;  // a residual's staged row: its Jacobian row (6), its residual

// sum_k a[k * sa] * b[k * sb] over k in [lo, hi), one kind of sum
template <Sum S>
__device__ __forceinline__ float dot(const float* a, int sa, const float* b, int sb, int hi,
                                     int lo = 0) {
  if constexpr (S == Sum::kFmaSeq) {
    float acc = 0.0f;
    for (int k = lo; k < hi; ++k) acc = __fmaf_rn(a[k * sa], b[k * sb], acc);
    return acc;
  } else if constexpr (S == Sum::kPlainSeq) {
    float acc = a[lo * sa] * b[lo * sb];
    for (int k = lo + 1; k < hi; ++k) acc = acc + a[k * sa] * b[k * sb];
    return acc;
  } else if constexpr (S == Sum::kPairs) {
    float acc = 0.0f;
    for (int k = lo; k < hi; k += 2) {
      float pair = a[k * sa] * b[k * sb];
      if (k + 1 < hi) pair = __fmaf_rn(a[(k + 1) * sa], b[(k + 1) * sb], pair);
      acc = k == lo ? pair : acc + pair;
    }
    return acc;
  } else {
    const int mid = lo + (hi - lo + 1) / 2;
    return dot<Sum::kFmaSeq>(a, sa, b, sb, mid, lo) + dot<Sum::kFmaSeq>(a, sa, b, sb, hi, mid);
  }
}

// einsum "ij,mj->mi" (the projection's pose row i times marker m) sums its
// four terms in an order that depends on the M markers: kPairs at M = 1,
// kPlainSeq for 2 <= M <= 16, kFmaSeq from 17 (recorded at every M to 32)
__device__ __forceinline__ float proj_dot(const float* row, const float pt[4], int m) {
  if (m == 1) return dot<Sum::kPairs>(row, 1, pt, 1, 4);
  if (m <= 16) return dot<Sum::kPlainSeq>(row, 1, pt, 1, 4);
  return dot<Sum::kFmaSeq>(row, 1, pt, 1, 4);
}

// out = a @ b for a (r x n), b (n x c), row-major with the given row strides
template <Sum S>
__device__ __forceinline__ void matmul(const float* a, int lda, const float* b, int ldb,
                                       float* out, int r, int n, int c) {
  for (int i = 0; i < r; ++i)
    for (int j = 0; j < c; ++j) out[i * c + j] = dot<S>(a + i * lda, 1, b + j, ldb, n);
}

// `pf/refine.py::_inv3`: cofactors over the determinant
__device__ __forceinline__ void ref_inv3(const float* m, int ld, float out[9]) {
  float mm[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) mm[i][j] = m[i * ld + j];
  float o[3][3];
  inv3(mm, o);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i * 3 + j] = o[i][j];
}

// `pf/refine.py::_jacobi`: 1 / sqrt|a_ii| (1 where 0) and the scaled matrix
__device__ __forceinline__ void ref_jacobi(const float a[36], float a_s[36], float inv_d[6]) {
  for (int i = 0; i < 6; ++i) {
    const float d = sqrtf(fabsf(a[7 * i]));
    inv_d[i] = 1.0f / (d > 0.0f ? d : 1.0f);
  }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) a_s[6 * i + j] = a[6 * i + j] * inv_d[i] * inv_d[j];
}

// the blocks P, Q (rows 0-2, columns 0-2 / 3-5) and S of a scaled 6x6, with
// P^-1, Q^T P^-1 and the Schur complement's inverse (S - Q^T P^-1 Q)^-1
__device__ __forceinline__ void ref_schur(const float a_s[36], float p_inv[9], float qt_pinv[9],
                                          float schur_inv[9]) {
  float qt[9], tmp[9], schur[9];
  ref_inv3(a_s, 6, p_inv);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) qt[3 * i + j] = a_s[6 * j + 3 + i];
  matmul<Sum::kFmaSeq>(qt, 3, p_inv, 3, qt_pinv, 3, 3, 3);  // Q^T @ P^-1
  matmul<Sum::kPairs>(qt_pinv, 3, a_s + 3, 6, tmp, 3, 3, 3);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) schur[3 * i + j] = a_s[6 * (3 + i) + 3 + j] - tmp[3 * i + j];
  ref_inv3(schur, 3, schur_inv);
}

// `pf/refine.py::solve6_spd(a, b, refine=False)`
__device__ __forceinline__ void ref_solve6(const float a[36], const float b[6], float x[6]) {
  float a_s[36], inv_d[6], b_s[6], p_inv[9], qt_pinv[9], schur_inv[9];
  ref_jacobi(a, a_s, inv_d);
  for (int i = 0; i < 6; ++i) b_s[i] = b[i] * inv_d[i];
  ref_schur(a_s, p_inv, qt_pinv, schur_inv);
  float t[3], r[3], x1[3], x2[3];
  matmul<Sum::kPairs>(qt_pinv, 3, b_s, 1, t, 3, 3, 1);
  for (int i = 0; i < 3; ++i) r[i] = b_s[3 + i] - t[i];
  matmul<Sum::kPairs>(schur_inv, 3, r, 1, x2, 3, 3, 1);
  matmul<Sum::kPairs>(a_s + 3, 6, x2, 1, t, 3, 3, 1);
  for (int i = 0; i < 3; ++i) r[i] = b_s[i] - t[i];
  matmul<Sum::kPairs>(p_inv, 3, r, 1, x1, 3, 3, 1);
  for (int i = 0; i < 3; ++i) x[i] = x1[i] * inv_d[i], x[3 + i] = x2[i] * inv_d[3 + i];
}

// `pf/refine.py::inv6_spd` of one matrix
__device__ __forceinline__ void ref_inv6(const float a[36], float out[36]) {
  float a_s[36], inv_d[6], p_inv[9], qt_pinv[9], schur_inv[9];
  ref_jacobi(a, a_s, inv_d);
  ref_schur(a_s, p_inv, qt_pinv, schur_inv);
  float tq[9], nq[9], t1[9], t2[9], tr[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) tq[3 * i + j] = qt_pinv[3 * j + i], nq[3 * i + j] = -tq[3 * i + j];
  matmul<Sum::kFmaSeq>(tq, 3, schur_inv, 3, t1, 3, 3, 3);  // (Q^T P^-1)^T @ S^-1
  matmul<Sum::kPairs>(t1, 3, qt_pinv, 3, t2, 3, 3, 3);
  matmul<Sum::kFmaSeq>(nq, 3, schur_inv, 3, tr, 3, 3, 3);  // its negation's, transposed too
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      out[6 * i + j] = (p_inv[3 * i + j] + t2[3 * i + j]) * inv_d[i] * inv_d[j];
      out[6 * i + 3 + j] = tr[3 * i + j] * inv_d[i] * inv_d[3 + j];
      out[6 * (3 + i) + j] = tr[3 * j + i] * inv_d[3 + i] * inv_d[j];
      out[6 * (3 + i) + 3 + j] = schur_inv[3 * i + j] * inv_d[3 + i] * inv_d[3 + j];
    }
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// `geometry/se3.py::exp_se3` of one twist -> the 4x4 transform, row-major
__device__ __forceinline__ void ref_exp(const float dt[6], float e[16]) {
  const float wx = dt[3], wy = dt[4], wz = dt[5];
  const float th2 = (wx * wx + wz * wz) + wy * wy;  // torch.sum's butterfly over 3
  const float om[9] = {0.0f, -wz, wy, wz, 0.0f, -wx, -wy, wx, 0.0f};
  float om2[9];
  matmul<Sum::kPairs>(om, 3, om, 3, om2, 3, 3, 3);
  const float theta = sqrtf(clamp_min(th2, 0.0f));
  const bool small = th2 < kEpsTheta;
  const float safe = small ? 1.0f : theta;
  const float sn = sinf(safe), cs = cosf(safe);
  // `x / c` by a host scalar c is x * (1 / c) in float on the card
  const float a = small ? 1.0f - th2 * (1.0f / 6.0f) : sn / safe;
  const float b = small ? 0.5f - th2 * (1.0f / 24.0f) : (1.0f - cs) / clamp_min(th2, kEpsTheta);
  const float c = small ? (float)(1.0 / 6.0) - th2 * (1.0f / 120.0f)
                        : (safe - sn) / clamp_min(th2 * safe, kEpsTheta);
  float rot[9], v[9], t[3];
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.0f : 0.0f;
    rot[i] = (eye + a * om[i]) + b * om2[i];
    v[i] = (eye + b * om[i]) + c * om2[i];
  }
  matmul<Sum::kPairs>(v, 3, dt, 1, t, 3, 3, 1);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) e[4 * i + j] = rot[3 * i + j];
    e[4 * i + 3] = t[i];
  }
  e[12] = e[13] = e[14] = 0.0f, e[15] = 1.0f;
}

// This lane's sum of `pf/refine.py::_residuals_and_normal_eqs` at pose p
// (lanes 0..20: A's upper triangle, 21..26: b, 27: the error).  Lane q < m
// stages pair q's rows 2q and 2q + 1 of J (u, v) and their residuals.
template <int M>
__device__ __forceinline__ float ref_normal_sums(const float p[16], int lane, int m,
                                                 const float pt[4], float du, float dv, bool live,
                                                 float fx, float fy, float cx, float cy,
                                                 float* stage) {
  if constexpr (M > 0) m = M;
  __syncwarp();
  if (lane < m) {
    const float x = proj_dot(p, pt, m);
    const float y = proj_dot(p + 4, pt, m);
    const float z = proj_dot(p + 8, pt, m);
    const float sz = fabsf(z) < 1e-12f ? 1e-12f : z;
    const float u = fx * x / sz + cx;
    const float v = fy * y / sz + cy;
    const float zj = fabsf(z) < 1e-9f ? 1e-9f : z;
    const float z2 = zj * zj;
    const float nfx = -fx, nfy = -fy;
    const float ju[6] = {fx / zj, 0.0f, nfx * x / z2, nfx * x * y / z2,
                         fx * (1.0f + x * x / z2), nfx * y / zj};
    const float jv[6] = {0.0f, fy / zj, nfy * y / z2, nfy * (1.0f + y * y / z2),
                         fy * x * y / z2, fy * x / zj};
    float* ru = stage + (2 * lane) * kRowJ;
    float* rv = ru + kRowJ;
    for (int i = 0; i < 6; ++i) ru[i] = live ? ju[i] : 0.0f, rv[i] = live ? jv[i] : 0.0f;
    ru[6] = live ? du - u : 0.0f;
    rv[6] = live ? dv - v : 0.0f;
  }
  __syncwarp();
  const int n = 2 * m;
  // the error: torch.sum of the squares, a butterfly over the lanes (lane t
  // holds square t, and t + 32 added first where there are more than 32)
  float err = 0.0f;
  if (lane < n) err = stage[lane * kRowJ + 6] * stage[lane * kRowJ + 6];
  if (lane + 32 < n) err = err + stage[(lane + 32) * kRowJ + 6] * stage[(lane + 32) * kRowJ + 6];
  for (int off = 16; off > 0; off >>= 1) err = err + __shfl_xor_sync(kFull, err, off);
  if (lane < 21) {
    int i = 0, rest = lane;
    while (rest >= 6 - i) rest -= 6 - i, ++i;
    return dot<Sum::kFmaSeq>(stage + i, kRowJ, stage + i + rest, kRowJ, n);
  }
  if (lane < 27) return dot<Sum::kHalves>(stage + lane - 21, kRowJ, stage + 6, kRowJ, n);
  return err;
}

// the damped normal matrix (lanes' sums -> every lane) and b
__device__ __forceinline__ void ref_gather_normal(float sum, float a[36], float b[6]) {
  for (int e = 0; e < 36; ++e) a[e] = amat_entry(sum, e) + (e / 6 == e % 6 ? kDamping : 0.0f);
  for (int i = 0; i < 6; ++i) b[i] = __shfl_sync(kFull, sum, 21 + i);
}

// scal [fx, fy, cx, cy]; pose0 (16); mark (4, M) rows x, y, z, w;
// marker_mask (M) bool; dfm (M) int32; det_xy (K, 2).  out: the pose (16),
// the covariance (36), then the iterations as an int32.
template <int M>
__global__ void __launch_bounds__(32)
refine_pose_kernel(const float* __restrict__ scal, const float* __restrict__ pose0,
                   const float* __restrict__ mark, const unsigned char* __restrict__ marker_mask,
                   const int* __restrict__ dfm, const float* __restrict__ det_xy, int m_rt, int k,
                   int max_iter, float tol, float* __restrict__ out) {
  __shared__ float stage[2 * (M > 0 ? M : kMaxM) * kRowJ];
  const int m = M > 0 ? M : m_rt;
  const int lane = threadIdx.x;
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  float pt[4] = {0.0f, 0.0f, 0.0f, 0.0f}, du = 0.0f, dv = 0.0f;
  bool live = false;
  if (lane < m) {
    for (int r = 0; r < 4; ++r) pt[r] = mark[r * m + lane];
    const int e = dfm[lane];
    const int idx = min(max(e, 0), k - 1);
    du = det_xy[2 * idx];
    dv = det_xy[2 * idx + 1];
    live = e >= 0 && marker_mask[lane] != 0;
  }
  float p0[16], p[16];
  for (int i = 0; i < 16; ++i) p[i] = p0[i] = pose0[i];
  float sum = ref_normal_sums<M>(p, lane, m, pt, du, dv, live, fx, fy, cx, cy, stage);
  const float err0 = __shfl_sync(kFull, sum, 27);
  int n_iter = 0;
  for (int it = 0; it < max_iter; ++it) {
    float a[36], b[6], dt[6], e[16], np[16];
    ref_gather_normal(sum, a, b);
    ref_solve6(a, b, dt);
    float step = 0.0f;
    for (int i = 0; i < 6; ++i) {
      dt[i] = isfinite(dt[i]) ? dt[i] : 0.0f;
      step = fmaxf(step, fabsf(dt[i]));
    }
    ref_exp(dt, e);
    matmul<Sum::kPairs>(e, 4, p, 4, np, 4, 4, 4);
    for (int i = 0; i < 16; ++i) p[i] = np[i];
    ++n_iter;
    // the next iteration's system, or the final one
    sum = ref_normal_sums<M>(p, lane, m, pt, du, dv, live, fx, fy, cx, cy, stage);
    // a converged pose stops moving: the rest of the budget changes nothing
    if (step <= tol) break;
  }
  const bool diverged = __shfl_sync(kFull, sum, 27) > err0;
  float a[36], b[6], cov[36];
  ref_gather_normal(sum, a, b);
  ref_inv6(a, cov);
  for (int i = 0; i < 16; ++i)
    if (lane == i) out[i] = diverged ? p0[i] : p[i];
  for (int r = 0; r < 2; ++r) {
    const int e = lane + 32 * r;
    float c = 0.0f;
    for (int i = 0; i < 36; ++i)
      if (i == e) c = cov[i];
    if (e < 36) out[16 + e] = c;
  }
  if (lane == 0) reinterpret_cast<int*>(out)[52] = n_iter;
}

template <int M>
int launch_pose(const float* scal, const float* pose0, const float* mark,
                const unsigned char* marker_mask, const int* dfm, const float* det_xy, int m,
                int k, int max_iter, float tol, float* out, cudaStream_t st) {
  refine_pose_kernel<M><<<1, 32, 0, st>>>(scal, pose0, mark, marker_mask, dfm, det_xy, m, k,
                                          max_iter, tol, out);
  return (int)cudaGetLastError();
}

template <int M>
int launch_frame(const float* scal, const float* pre_gn, const float* mark,
                 const unsigned char* marker_mask, const float* det_xy,
                 const unsigned char* det_mask, const float* tol_pf, const float* jump_thr,
                 const float* predicted, const unsigned char* trust, int m, int k, int max_iter,
                 float tol, float gate, float step_radius, float jump_radius, int flags,
                 float* out, int* info, unsigned char* jump, cudaStream_t st) {
  const int rows = (flags & kHypotheses) ? 2 * m + 1 : 1;
  const int warps = min(rows, FrameShared<M>::kWarps);
  refine_frame_kernel<M><<<1, 32 * warps, 0, st>>>(scal, pre_gn, mark, marker_mask, det_xy,
                                                   det_mask, tol_pf, jump_thr, predicted, trust,
                                                   m, k, max_iter, tol, gate, step_radius,
                                                   jump_radius, flags, out, info, jump);
  return (int)cudaGetLastError();
}

template <int M>
int launch(const float* scal, const float* poses, const float* mark, const float* du,
           const float* dv, const float* mask, int nb, int m, int max_iter, float tol,
           float* out_pose, float* stats, float* amat, cudaStream_t st) {
  gn_refine_kernel<M><<<nb, 32, 0, st>>>(scal, poses, mark, du, dv, mask, max_iter, tol, out_pose,
                                         stats, amat, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pfmpe_gn_refine(const float* scal, const float* poses, const float* mark,
                               const float* du, const float* dv, const float* mask, int nb, int m,
                               int max_iter, float tol, float* out_pose, float* stats,
                               float* amat, void* stream) {
  if (m < 1 || m > kMaxM || nb < 1) return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const float*, const float*, const float*, const float*, const float*,
                         const float*, int, int, int, float, float*, float*, float*,
                         cudaStream_t);
  constexpr Launch kLaunch[kFixedM + 1] = {launch<0>, launch<1>, launch<2>, launch<3>, launch<4>,
                                           launch<5>, launch<6>, launch<7>, launch<8>};
  return kLaunch[m <= kFixedM ? m : 0](scal, poses, mark, du, dv, mask, nb, m, max_iter, tol,
                                       out_pose, stats, amat, (cudaStream_t)stream);
}


extern "C" int pfmpe_refine_frame(const float* scal, const float* pre_gn, const float* mark,
                                  const unsigned char* marker_mask, const float* det_xy,
                                  const unsigned char* det_mask, const float* tol_pf,
                                  const float* jump_thr, const float* predicted,
                                  const unsigned char* trust, int m, int k, int max_iter,
                                  float tol, float gate, float step_radius, float jump_radius,
                                  int flags, float* out, int* info, unsigned char* jump,
                                  void* stream) {
  if (m < 1 || m > kMaxM || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const float*, const float*, const float*, const unsigned char*,
                         const float*, const unsigned char*, const float*, const float*,
                         const float*, const unsigned char*, int, int, int, float, float, float,
                         float, int, float*, int*, unsigned char*, cudaStream_t);
  constexpr Launch kLaunch[kFixedM + 1] = {
      launch_frame<0>, launch_frame<1>, launch_frame<2>, launch_frame<3>, launch_frame<4>,
      launch_frame<5>, launch_frame<6>, launch_frame<7>, launch_frame<8>};
  return kLaunch[m <= kFixedM ? m : 0](scal, pre_gn, mark, marker_mask, det_xy, det_mask, tol_pf,
                                       jump_thr, predicted, trust, m, k, max_iter, tol, gate,
                                       step_radius, jump_radius, flags, out, info, jump,
                                       (cudaStream_t)stream);
}

extern "C" int pfmpe_refine_pose(const float* scal, const float* pose0, const float* mark,
                                 const unsigned char* marker_mask, const int* dfm,
                                 const float* det_xy, int m, int k, int max_iter, float tol,
                                 float* out, void* stream) {
  if (m < 1 || m > kMaxM || k < 1) return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const float*, const float*, const float*, const unsigned char*,
                         const int*, const float*, int, int, int, float, float*, cudaStream_t);
  constexpr Launch kLaunch[kFixedM + 1] = {launch_pose<0>, launch_pose<1>, launch_pose<2>,
                                           launch_pose<3>, launch_pose<4>, launch_pose<5>,
                                           launch_pose<6>, launch_pose<7>, launch_pose<8>};
  return kLaunch[m <= kFixedM ? m : 0](scal, pose0, mark, marker_mask, dfm, det_xy, m, k,
                                       max_iter, tol, out, (cudaStream_t)stream);
}
