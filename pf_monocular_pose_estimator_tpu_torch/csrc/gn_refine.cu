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
// stream.  One block, one thread per hypothesis, everything in registers,
// so the launch costs one kernel's latency instead of the reference's
// per-op dispatch.  Sums over the M pairs run in index order; built with
// --fmad=false, so the plain PyTorch version follows the same roundings.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxM = 8;
constexpr float kDamping = 1e-8f;
constexpr float kEpsTheta = 1e-8f;

struct Normal {
  float a[6][6];
  float b[6];
  float err;
};

__device__ void normal_eqs(const float* p, const float* mx, const float* my, const float* mz,
                           const float* du, const float* dv, const float* mask, int m, float fx,
                           float fy, float cx, float cy, Normal& ne, float* ru_out,
                           float* rv_out) {
  float ju[kMaxM][6], jv[kMaxM][6], ru[kMaxM], rv[kMaxM];
  for (int q = 0; q < m; ++q) {
    const float pcx = p[0] * mx[q] + p[1] * my[q] + p[2] * mz[q] + p[3];
    const float pcy = p[4] * mx[q] + p[5] * my[q] + p[6] * mz[q] + p[7];
    const float pcz = p[8] * mx[q] + p[9] * my[q] + p[10] * mz[q] + p[11];
    const float z = fabsf(pcz) < 1e-12f ? 1e-12f : pcz;
    const float u = fx * pcx / z + cx;
    const float v = fy * pcy / z + cy;
    ru[q] = (du[q] - u) * mask[q];
    rv[q] = (dv[q] - v) * mask[q];
    const float iz = 1.0f / z;
    const float x_z = pcx * iz;
    const float y_z = pcy * iz;
    ju[q][0] = fx * iz;
    ju[q][1] = 0.0f;
    ju[q][2] = -fx * x_z * iz;
    ju[q][3] = -fx * x_z * y_z;
    ju[q][4] = fx * (1.0f + x_z * x_z);
    ju[q][5] = -fx * y_z;
    jv[q][0] = 0.0f;
    jv[q][1] = fy * iz;
    jv[q][2] = -fy * y_z * iz;
    jv[q][3] = -fy * (1.0f + y_z * y_z);
    jv[q][4] = fy * x_z * y_z;
    jv[q][5] = fy * x_z;
    for (int i = 0; i < 6; ++i) {
      ju[q][i] = ju[q][i] * mask[q];
      jv[q][i] = jv[q][i] * mask[q];
    }
    if (ru_out) {
      ru_out[q] = ru[q];
      rv_out[q] = rv[q];
    }
  }
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      float s = ju[0][i] * ju[0][j] + jv[0][i] * jv[0][j];
      for (int q = 1; q < m; ++q) s = s + (ju[q][i] * ju[q][j] + jv[q][i] * jv[q][j]);
      ne.a[i][j] = s;
      ne.a[j][i] = s;
    }
    float s = ju[0][i] * ru[0] + jv[0][i] * rv[0];
    for (int q = 1; q < m; ++q) s = s + (ju[q][i] * ru[q] + jv[q][i] * rv[q]);
    ne.b[i] = s;
  }
  float e = ru[0] * ru[0] + rv[0] * rv[0];
  for (int q = 1; q < m; ++q) e = e + (ru[q] * ru[q] + rv[q] * rv[q]);
  ne.err = e;
}

__device__ void inv3sym(float m00, float m01, float m02, float m11, float m12, float m22,
                        float out[3][3]) {
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

// Jacobi-scaled block-Schur solve of the damped normal equations.
__device__ void solve6(const float a[6][6], const float b[6], float x[6]) {
  float s[6];
  for (int i = 0; i < 6; ++i) s[i] = 1.0f / sqrtf(fmaxf(fabsf(a[i][i]), 1e-30f));
  float ah[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      const int ii = i <= j ? i : j, jj = i <= j ? j : i;
      ah[i][j] = a[ii][jj] * s[ii] * s[jj];
    }
  float bh[6];
  for (int i = 0; i < 6; ++i) bh[i] = b[i] * s[i];
  float pi[3][3], si[3][3], w[3][3], sc[3][3];
  inv3sym(ah[0][0], ah[0][1], ah[0][2], ah[1][1], ah[1][2], ah[2][2], pi);
  // W = Q^T @ Pi, Q = ah[0:3, 3:6]
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < 3; ++k) acc = acc + ah[k][3 + i] * pi[k][j];
      w[i][j] = acc;
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < 3; ++k) acc = acc + w[i][k] * ah[k][3 + j];
      sc[i][j] = ah[3 + i][3 + j] - acc;
    }
  inv3sym(sc[0][0], sc[0][1], sc[0][2], sc[1][1], sc[1][2], sc[2][2], si);
  float rhs2[3], x2[3], rhs1[3], x1[3];
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
    for (int k = 0; k < 3; ++k) acc = acc + w[i][k] * bh[k];
    rhs2[i] = bh[3 + i] - acc;
  }
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
    for (int k = 0; k < 3; ++k) acc = acc + si[i][k] * rhs2[k];
    x2[i] = acc;
  }
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
    for (int k = 0; k < 3; ++k) acc = acc + ah[i][3 + k] * x2[k];
    rhs1[i] = bh[i] - acc;
  }
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
    for (int k = 0; k < 3; ++k) acc = acc + pi[i][k] * rhs1[k];
    x1[i] = acc;
  }
  for (int i = 0; i < 3; ++i) {
    x[i] = x1[i] * s[i];
    x[3 + i] = x2[i] * s[3 + i];
  }
}

// exp map of dt = [rho, omega] -> 12 row-major entries of [R | t]
__device__ void exp_rows(const float dt[6], float e[12]) {
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

// scal: [fx, fy, cx, cy, ...]; mark: (3, m) rows mx, my, mz; du/dv/mask: (b, m)
// out_pose: (b, 16); stats: (b, 8) [err0, err, n_iter, max_resid, done,
// diverged, 0, 0]; amat: (b, 36) final normal matrix (undamped)
__global__ void gn_refine_kernel(const float* __restrict__ scal, const float* __restrict__ poses,
                                 const float* __restrict__ mark, const float* __restrict__ du_all,
                                 const float* __restrict__ dv_all,
                                 const float* __restrict__ mask_all, int nb, int m, int max_iter,
                                 float tol, float* __restrict__ out_pose,
                                 float* __restrict__ stats, float* __restrict__ amat) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= nb) return;
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  float mx[kMaxM], my[kMaxM], mz[kMaxM], du[kMaxM], dv[kMaxM], mask[kMaxM];
  for (int q = 0; q < m; ++q) {
    mx[q] = mark[q];
    my[q] = mark[m + q];
    mz[q] = mark[2 * m + q];
    du[q] = du_all[h * m + q];
    dv[q] = dv_all[h * m + q];
    mask[q] = mask_all[h * m + q];
  }
  float p0[16], p[16];
  for (int i = 0; i < 16; ++i) p0[i] = p[i] = poses[h * 16 + i];
  Normal ne;
  normal_eqs(p0, mx, my, mz, du, dv, mask, m, fx, fy, cx, cy, ne, nullptr, nullptr);
  const float err0 = ne.err;
  float done = 0.0f, n_iter = 0.0f;
  for (int it = 0; it < max_iter; ++it) {
    normal_eqs(p, mx, my, mz, du, dv, mask, m, fx, fy, cx, cy, ne, nullptr, nullptr);
    for (int i = 0; i < 6; ++i) ne.a[i][i] = ne.a[i][i] + kDamping;
    float dt[6];
    solve6(ne.a, ne.b, dt);
    for (int i = 0; i < 6; ++i) {
      const float d = dt[i];
      dt[i] = (d == d && fabsf(d) < 1e30f) ? d : 0.0f;
    }
    float e[12];
    exp_rows(dt, e);
    float newp[16];
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c)
        newp[r * 4 + c] = e[4 * r + 0] * p[c] + e[4 * r + 1] * p[4 + c] + e[4 * r + 2] * p[8 + c];
      newp[r * 4 + 3] = e[4 * r + 0] * p[3] + e[4 * r + 1] * p[7] + e[4 * r + 2] * p[11] +
                        e[4 * r + 3];
    }
    for (int i = 12; i < 16; ++i) newp[i] = p[i];
    float step = fabsf(dt[0]);
    for (int i = 1; i < 6; ++i) step = fmaxf(step, fabsf(dt[i]));
    const float now_done = fmaxf(done, step <= tol ? 1.0f : 0.0f);
    if (!(done > 0.0f))
      for (int i = 0; i < 16; ++i) p[i] = newp[i];
    n_iter = n_iter + (1.0f - done);
    done = now_done;
  }
  float ru[kMaxM], rv[kMaxM];
  normal_eqs(p, mx, my, mz, du, dv, mask, m, fx, fy, cx, cy, ne, ru, rv);
  float max_resid = sqrtf(ru[0] * ru[0] + rv[0] * rv[0]);
  for (int q = 1; q < m; ++q) max_resid = fmaxf(max_resid, sqrtf(ru[q] * ru[q] + rv[q] * rv[q]));
  const bool diverged = ne.err > err0;
  for (int i = 0; i < 16; ++i) out_pose[h * 16 + i] = diverged ? p0[i] : p[i];
  float* st = stats + h * 8;
  st[0] = err0;
  st[1] = diverged ? err0 : ne.err;
  st[2] = n_iter;
  st[3] = max_resid;
  st[4] = done;
  st[5] = diverged ? 1.0f : 0.0f;
  st[6] = 0.0f;
  st[7] = 0.0f;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) amat[h * 36 + i * 6 + j] = ne.a[i][j];
}

}  // namespace

extern "C" int pfmpe_gn_refine(const float* scal, const float* poses, const float* mark,
                               const float* du, const float* dv, const float* mask, int nb, int m,
                               int max_iter, float tol, float* out_pose, float* stats,
                               float* amat, void* stream) {
  if (m < 1 || m > kMaxM || nb < 1 || nb > 1024) return (int)cudaErrorInvalidValue;
  const int threads = nb <= 32 ? 32 : 128;
  gn_refine_kernel<<<(nb + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      scal, poses, mark, du, dv, mask, nb, m, max_iter, tol, out_pose, stats, amat);
  return (int)cudaGetLastError();
}
