// LED detection front end: threshold + blur, bounded connected components,
// per-root component statistics and the top-k component ranking.
//
// Replaces the reference's Pallas TPU kernels
//   pf_monocular_pose_estimator_tpu/ops/pallas_kernels.py::threshold_blur_pallas
//     (body _make_kernel) -- the `threshold_blur` launch below, and
//   pf_monocular_pose_estimator_tpu/ops/pallas_kernels.py::detect_stats_pallas
//     (body _make_detect_kernel) -- threshold_blur + label + stats + topk.
//
// What bounds it on Hopper: nothing heavy.  A 192x256 crop is 49,152 pixels;
// the windowed moment sums are 13x25 compares a pixel and the bbox pass is
// 12 sweeps x 8 directions, so the work is a few tens of MFLOP and the
// launches (four, a few microseconds each) dominate.  The TPU kernel kept the
// whole crop and a dozen maps resident in one program's VMEM; a 192x256 f32
// map alone is 196 KB against 227 KB of shared memory per block here, so the
// design splits the work into launches and tiles each map with a halo deep
// enough that every tile's interior is exact:
//   * labels: 12 sweeps of a 3x3 max move information 12 px, so a 12 px halo
//     around a 32x32 tile is exact (errors from the cut edge travel 1 px a
//     sweep and die in the halo);
//   * stats: a label's pixels all lie within 12 px (Chebyshev) of the pixel
//     whose index it carries, so every pixel sharing a label with an interior
//     pixel lies within 24 px of it; the bbox min/max sweeps only move values
//     between same-label neighbours, so a 24 px halo around a 16x16 tile is
//     exact whatever order the sweeps run in.
// Out-of-frame neighbours never match (label 0 here; the Pallas rolls bring
// in biased labels that never compare equal, which is the same thing).
// Blur sums keep the reference's tap order; built with --fmad=false, so the
// blurred map, labels, counts and moment sums equal the plain PyTorch version
// bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxTaps = 15;
constexpr int kLabTile = 32;
constexpr int kLabHalo = 12;
constexpr int kLabSpan = kLabTile + 2 * kLabHalo;  // 56
constexpr int kStTile = 16;
constexpr int kStHalo = 24;
constexpr int kStSpan = kStTile + 2 * kStHalo;  // 64
constexpr int kStThreads = kStTile * kStTile;  // 256
constexpr int kTopkThreads = 1024;

// params: [x0, y0, roi_w, roi_h, threshold, min_area, max_area, taps...]
__device__ __forceinline__ float thresholded(const float* img, const float* prm, int y, int x,
                                             int w, int active) {
  const float v = img[y * w + x];
  const float fx = (float)x;
  const float fy = (float)y;
  const bool in_roi = (fx >= prm[0]) && (fx < prm[0] + prm[2]) && (fy >= prm[1]) &&
                      (fy < prm[1] + prm[3]);
  const float thr = prm[4];
  float tz;
  if (active) {
    tz = v > thr ? v : 0.0f;  // THRESH_TOZERO
  } else {
    tz = v > thr ? 0.0f : 255.0f;  // THRESH_BINARY_INV
  }
  return in_roi ? tz : 0.0f;
}

// out(y, x) = sum_i t_i * acc(y, x - (i - half)),
// acc(y, x') = sum_j t_j * tz(y - (j - half), x'); zero outside the frame.
__global__ void threshold_blur_kernel(const float* __restrict__ img, const float* __restrict__ prm,
                                      int ntaps, int h, int w, int active,
                                      float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float* taps = prm + 7;
  const int half = ntaps / 2;
  float o = 0.0f;
  for (int i = 0; i < ntaps; ++i) {
    const int xs = x - (i - half);
    float a = 0.0f;
    if (xs >= 0 && xs < w) {
      for (int j = 0; j < ntaps; ++j) {
        const int ys = y - (j - half);
        const float t = (ys >= 0 && ys < h) ? thresholded(img, prm, ys, xs, w, active) : 0.0f;
        a = a + taps[j] * t;
      }
    }
    o = o + taps[i] * a;
  }
  out[y * w + x] = o;
}

// 3x3 max-label propagation, exactly `sweeps` sweeps, labels = 1-based flat
// index of the pixel, 0 on background.
__global__ void label_kernel(const float* __restrict__ blurred, int h, int w, int sweeps,
                             int* __restrict__ lab_out) {
  __shared__ int lab[2][kLabSpan][kLabSpan];
  __shared__ unsigned char fg[kLabSpan][kLabSpan];
  const int oy = blockIdx.y * kLabTile - kLabHalo;
  const int ox = blockIdx.x * kLabTile - kLabHalo;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < kLabSpan * kLabSpan; i += nthreads) {
    const int ly = i / kLabSpan, lx = i % kLabSpan;
    const int gy = oy + ly, gx = ox + lx;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const bool f = inside && blurred[gy * w + gx] > 1e-3f;
    fg[ly][lx] = f;
    lab[0][ly][lx] = f ? gy * w + gx + 1 : 0;
  }
  __syncthreads();
  for (int s = 0; s < sweeps; ++s) {
    const int cur = s & 1;
    for (int i = tid; i < kLabSpan * kLabSpan; i += nthreads) {
      const int ly = i / kLabSpan, lx = i % kLabSpan;
      int m = 0;
      if (fg[ly][lx]) {
        for (int dy = -1; dy <= 1; ++dy) {
          const int yy = ly + dy;
          if (yy < 0 || yy >= kLabSpan) continue;
          for (int dx = -1; dx <= 1; ++dx) {
            const int xx = lx + dx;
            if (xx < 0 || xx >= kLabSpan) continue;
            m = max(m, lab[cur][yy][xx]);
          }
        }
      }
      lab[cur ^ 1][ly][lx] = m;
    }
    __syncthreads();
  }
  const int fin = sweeps & 1;
  for (int i = tid; i < kLabTile * kLabTile; i += nthreads) {
    const int ty = i / kLabTile, tx = i % kLabTile;
    const int gy = blockIdx.y * kLabTile + ty, gx = blockIdx.x * kLabTile + tx;
    if (gy < h && gx < w) lab_out[gy * w + gx] = lab[fin][kLabHalo + ty][kLabHalo + tx];
  }
}

// Windowed same-label sums (dy in [-reach, 0], dx in [-reach, reach]) and the
// bbox extrema by `reach` sweeps of same-label min/max propagation in the
// reference's direction order.  maps: 10 planes of (h, w) in the order
// cnt, sx, sy, xmin, xmax, ymin, ymax, sxx, syy, sxy.
__global__ void __launch_bounds__(kStThreads) stats_kernel(const int* __restrict__ lab, int h,
                                                           int w, int reach,
                                                           float* __restrict__ maps) {
  extern __shared__ unsigned char smem_raw[];
  int* labb = reinterpret_cast<int*>(smem_raw);                      // kStSpan^2
  float* bb = reinterpret_cast<float*>(labb + kStSpan * kStSpan);    // 4 x kStSpan^2
  const int oy = blockIdx.y * kStTile - kStHalo;
  const int ox = blockIdx.x * kStTile - kStHalo;
  const int tid = threadIdx.x;
  const int span2 = kStSpan * kStSpan;
  for (int i = tid; i < span2; i += kStThreads) {
    const int ly = i / kStSpan, lx = i % kStSpan;
    const int gy = oy + ly, gx = ox + lx;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const int l = inside ? lab[gy * w + gx] : 0;
    // background biased to unique negatives; outside the frame 0 (no match)
    labb[i] = inside ? (l > 0 ? l : -(gy * w + gx + 1)) : 0;
    const bool f = l > 0;
    bb[0 * span2 + i] = f ? (float)gx : 1e9f;
    bb[1 * span2 + i] = f ? (float)gx : -1e9f;
    bb[2 * span2 + i] = f ? (float)gy : 1e9f;
    bb[3 * span2 + i] = f ? (float)gy : -1e9f;
  }
  __syncthreads();

  const int ty = tid / kStTile, tx = tid % kStTile;
  const int cy = kStHalo + ty, cxl = kStHalo + tx;
  const int me = labb[cy * kStSpan + cxl];
  float cnt = 0.0f, sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
  for (int dy = -reach; dy <= 0; ++dy) {
    float r_cnt = 0.0f, r_sx = 0.0f, r_sxx = 0.0f;
    const int* row = labb + (cy + dy) * kStSpan + cxl;
    for (int dx = -reach; dx <= reach; ++dx) {
      const float samef = row[dx] == me ? 1.0f : 0.0f;
      const float fdx = (float)dx;
      r_cnt = r_cnt + samef;
      r_sx = r_sx + fdx * samef;
      r_sxx = r_sxx + (fdx * fdx) * samef;
    }
    const float fdy = (float)dy;
    cnt = cnt + r_cnt;
    sx = sx + r_sx;
    sy = sy + fdy * r_cnt;
    sxx = sxx + r_sxx;
    syy = syy + (fdy * fdy) * r_cnt;
    sxy = sxy + fdy * r_sx;
  }

  // bbox sweeps over the whole span; each thread owns span2 / kStThreads
  // pixels and stages their new values in registers between barriers.
  constexpr int kPer = kStSpan * kStSpan / kStThreads;  // 16
  const int dirs[8][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {1, 1}, {1, -1}, {-1, 1}, {-1, -1}};
  for (int s = 0; s < reach; ++s) {
    for (int d = 0; d < 8; ++d) {
      const int ddy = dirs[d][0], ddx = dirs[d][1];
      float nv[kPer][4];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * kStThreads;
        const int ly = i / kStSpan, lx = i % kStSpan;
        const int sy_ = ly - ddy, sx_ = lx - ddx;  // shifted[y, x] = src[y - dy, x - dx]
        bool same = false;
        int j = 0;
        if (sy_ >= 0 && sy_ < kStSpan && sx_ >= 0 && sx_ < kStSpan) {
          j = sy_ * kStSpan + sx_;
          same = labb[j] == labb[i];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = bb[q * span2 + i];
          if (!same) {
            nv[k][q] = v;
          } else {
            const float u = bb[q * span2 + j];
            nv[k][q] = (q & 1) ? fmaxf(v, u) : fminf(v, u);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * kStThreads;
#pragma unroll
        for (int q = 0; q < 4; ++q) bb[q * span2 + i] = nv[k][q];
      }
      __syncthreads();
    }
  }

  const int gy = blockIdx.y * kStTile + ty, gx = blockIdx.x * kStTile + tx;
  if (gy < h && gx < w) {
    const int hw = h * w;
    const int o = gy * w + gx;
    const int ci = cy * kStSpan + cxl;
    maps[0 * hw + o] = cnt;
    maps[1 * hw + o] = sx;
    maps[2 * hw + o] = sy;
    maps[3 * hw + o] = bb[0 * span2 + ci];
    maps[4 * hw + o] = bb[1 * span2 + ci];
    maps[5 * hw + o] = bb[2 * span2 + ci];
    maps[6 * hw + o] = bb[3 * span2 + ci];
    maps[7 * hw + o] = sxx;
    maps[8 * hw + o] = syy;
    maps[9 * hw + o] = sxy;
  }
}

// Top-k component roots by the reference's ranking score (roots whose exact
// count lies in [min_area, max_area] lifted by 1e6), highest score first,
// lowest flat index winning ties -- lax.top_k's order.  One block.
__global__ void __launch_bounds__(kTopkThreads) topk_kernel(const int* __restrict__ lab,
                                                            const float* __restrict__ cnt,
                                                            const float* __restrict__ prm,
                                                            int hw, int topk,
                                                            int* __restrict__ out) {
  __shared__ float s_score[kTopkThreads / 32];
  __shared__ int s_idx[kTopkThreads / 32];
  __shared__ int picked[64];
  const float min_area = prm[5], max_area = prm[6];
  const int tid = threadIdx.x;
  for (int t = 0; t < topk; ++t) {
    float best = -INFINITY;
    int bidx = hw;
    for (int i = tid; i < hw; i += kTopkThreads) {
      bool taken = false;
      for (int q = 0; q < t; ++q) taken = taken || picked[q] == i;
      if (taken) continue;
      const float area = lab[i] == i + 1 ? cnt[i] : 0.0f;
      const bool in_range = area >= min_area && area <= max_area && area > 0.0f;
      const float score = in_range ? area + 1e6f : area;
      if (score > best || (score == best && i < bidx)) {
        best = score;
        bidx = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bidx, off);
      if (ob > best || (ob == best && oi < bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    if ((tid & 31) == 0) {
      s_score[tid >> 5] = best;
      s_idx[tid >> 5] = bidx;
    }
    __syncthreads();
    if (tid == 0) {
      float b = s_score[0];
      int bi = s_idx[0];
      for (int q = 1; q < kTopkThreads / 32; ++q) {
        if (s_score[q] > b || (s_score[q] == b && s_idx[q] < bi)) {
          b = s_score[q];
          bi = s_idx[q];
        }
      }
      picked[t] = bi;
      out[t] = bi;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int pfmpe_threshold_blur(const float* img, const float* prm, int ntaps, int h, int w, int active,
                         float* out, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  threshold_blur_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, prm, ntaps, h, w, active,
                                                                   out);
  return (int)cudaGetLastError();
}

// blurred: (h, w) scratch; lab: (h, w) int32; maps: (10, h, w); topk_out: (topk,)
int pfmpe_detect_stats(const float* img, const float* prm, int ntaps, int h, int w, int active,
                       int sweeps, int topk, float* blurred, int* lab, float* maps,
                       int* topk_out, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || sweeps < 0 || sweeps > kLabHalo || topk < 1 ||
      topk > 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  {
    const dim3 block(32, 8);
    const dim3 grid((w + 31) / 32, (h + 7) / 8);
    threshold_blur_kernel<<<grid, block, 0, st>>>(img, prm, ntaps, h, w, active, blurred);
  }
  {
    const dim3 block(32, 8);
    const dim3 grid((w + kLabTile - 1) / kLabTile, (h + kLabTile - 1) / kLabTile);
    label_kernel<<<grid, block, 0, st>>>(blurred, h, w, sweeps, lab);
  }
  {
    const int smem = kStSpan * kStSpan * (int)(sizeof(int) + 4 * sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((w + kStTile - 1) / kStTile, (h + kStTile - 1) / kStTile);
    stats_kernel<<<grid, kStThreads, smem, st>>>(lab, h, w, sweeps, maps);
  }
  topk_kernel<<<1, kTopkThreads, 0, st>>>(lab, maps, prm, h * w, topk, topk_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
