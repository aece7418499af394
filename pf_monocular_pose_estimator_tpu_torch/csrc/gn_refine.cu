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
