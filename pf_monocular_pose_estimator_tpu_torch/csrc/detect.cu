// LED detection front end: threshold + blur, bounded connected components,
// per-root component statistics and the top-k component ranking.
//
// Replaces the reference's Pallas TPU kernels
//   pf_monocular_pose_estimator_tpu/ops/pallas_kernels.py::threshold_blur_pallas
//     (body _make_kernel) -- the `threshold_blur` launch below, and
//   pf_monocular_pose_estimator_tpu/ops/pallas_kernels.py::detect_stats_pallas
//     (body _make_detect_kernel) -- threshold_blur + label + stats + merge.
//
// What bounds it on Hopper: latency, not bytes or operations.  A 192x256
// crop is 49,152 pixels and a few tens of MFLOP; what costs time is the
// chain of dependent steps (up to 12 label sweeps, 96 bbox steps, k ranking
// rounds), each a barrier.  The TPU kernel kept the whole crop
// and a dozen maps resident in one program's VMEM; a 192x256 f32 map alone
// is 196 KB against 227 KB of shared memory per block here, so the work is
// split into four launches and each map is tiled with a halo deep enough
// that every tile's interior is exact:
//   * labels: 12 sweeps of a 3x3 max move information 12 px, so a 12 px halo
//     around a 32x32 tile is exact (errors from the cut edge travel 1 px a
//     sweep and die in the halo);
//   * stats: a label's pixels all lie within 12 px (Chebyshev) of the pixel
//     whose index it carries, so every pixel sharing a label with an interior
//     pixel lies within 24 px of it; the bbox min/max sweeps only move values
//     between same-label neighbours, so a 24 px halo is exact whatever order
//     the sweeps run in.
// Out-of-frame neighbours never match (label 0 here; the Pallas rolls bring
// in biased labels that never compare equal, which is the same thing).
// Those halos are for at most 12 sweeps, the tracker's default.  13 to 32
// sweeps run the wide shapes, whose halos are sized the same way for 32:
// labels a 32 px halo around a 32x32 tile (512 threads), stats a 64 px halo
// around a 16x16 tile (512 threads, 223 KB of shared memory), both in
// dynamic shared memory, the stats' bbox sweeps reading their values from
// shared memory instead of registers.
//
// Both sweep loops work on lists.  Only foreground pixels change; they are
// listed once, the sweeping threads (one listed pixel each while the list
// fits the block, on a named barrier of just their warps) keep their
// pixels' values in registers, the loops ping-pong between two buffers with
// one barrier a step, and a sweep that changes nothing ends the loop: the
// state is then a fixed point of every step, so the result equals the full
// count's.
// In the stats launch labels do not change during the bbox sweeps, so each
// span pixel gets one byte of "same label as the neighbour in direction d"
// bits, and its four extrema travel as one 32-bit word of bytes relative to
// the span's origin (xmin, ymin, 255 - xmax, 255 - ymax): a step is one
// __vminu4 gated by one bit.  Background pixels skip the windowed sums,
// whose result there is known (count 1, every moment +0).
//
// The top-k (1 to 128) is exact in two stages.  The ranking (score descending, flat
// index ascending) is a strict total order, encoded as one 64-bit key
// (float bits of the score << 32 | 0xFFFFFFFF - index; scores are >= 0, so
// their bits sort as unsigned integers), and the global top-k lies in the
// union of the tiles' top-k.  Every root scores > 0 and every other pixel
// exactly 0, so a tile's top-k is its roots by key, then its other pixels by
// index; the stats launch writes them, and one block merges the tiles' keys.
//
// Blur sums keep the reference's tap order, and the moment sums are exact
// integers in any order; built with --fmad=false, so the blurred map,
// labels, counts, moment sums, bbox maps and the top-k equal the plain
// PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxTaps = 15;
constexpr int kBlurX = 32, kBlurY = 8;
constexpr int kLabTile = 32;
constexpr int kLabHalo = 12;
constexpr int kLabSpan = kLabTile + 2 * kLabHalo;  // 56
constexpr int kLabThreads = 256;
constexpr int kStHalo = 24;                        // 2 x the largest sweep count
constexpr int kMaxSweeps = kLabHalo;               // the default shapes' sweeps
constexpr int kLabWideHalo = 32;                   // the wide shapes: up to 32 sweeps
constexpr int kLabWideThreads = 512;
constexpr int kStWideHalo = 2 * kLabWideHalo;
constexpr int kWideSweeps = kLabWideHalo;
constexpr int kMaxTopk = 64;   // the merge's list of the default shapes
constexpr int kWideTopk = 128;  // and the largest top-k
constexpr int kMergeThreads = 256;
constexpr int kMergeHeld = 8;  // keys a lane of the merge holds in registers

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
// A block stages the thresholded values of its 32x8 outputs and their halo,
// then the column sums acc, then the row sums: the reference's tap order.
__global__ void __launch_bounds__(kBlurX * kBlurY)
    threshold_blur_kernel(const float* __restrict__ img, const float* __restrict__ prm,
                          int ntaps, int h, int w, int active, float* __restrict__ out) {
  constexpr int kH = kMaxTaps / 2;
  __shared__ float tz[kBlurY + 2 * kH][kBlurX + 2 * kH];
  __shared__ float acc[kBlurY][kBlurX + 2 * kH];
  __shared__ float taps[kMaxTaps];
  const int half = ntaps / 2;
  const int rows = kBlurY + 2 * half, cols = kBlurX + 2 * half;
  const int x0 = blockIdx.x * kBlurX - half, y0 = blockIdx.y * kBlurY - half;
  const int tid = threadIdx.y * kBlurX + threadIdx.x;
  if (tid < ntaps) taps[tid] = prm[7 + tid];
  for (int i = tid; i < rows * cols; i += kBlurX * kBlurY) {
    const int r = i / cols, c = i % cols, y = y0 + r, x = x0 + c;
    tz[r][c] = (y >= 0 && y < h && x >= 0 && x < w) ? thresholded(img, prm, y, x, w, active)
                                                     : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < kBlurY * cols; i += kBlurX * kBlurY) {
    const int r = i / cols, c = i % cols;
    float a = 0.0f;
    for (int j = 0; j < ntaps; ++j) a = a + taps[j] * tz[r + 2 * half - j][c];
    acc[r][c] = a;
  }
  __syncthreads();
  const int x = blockIdx.x * kBlurX + threadIdx.x, y = blockIdx.y * kBlurY + threadIdx.y;
  if (x >= w || y >= h) return;
  float o = 0.0f;
  for (int i = 0; i < ntaps; ++i) o = o + taps[i] * acc[threadIdx.y][threadIdx.x + 2 * half - i];
  out[y * w + x] = o;
}

// Barrier 1 over the first `nthreads` threads of the block (a multiple of 32),
// returning whether `p` held on any of them; orders their shared-memory accesses.
__device__ __forceinline__ bool bar1_any(bool p, int nthreads) {
  int r;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.s32 p, %1, 0;\n bar.red.or.pred q, 1, %2, p;\n"
      " selp.s32 %0, 1, 0, q;\n}"
      : "=r"(r)
      : "r"((int)p), "r"(nthreads)
      : "memory");
  return r != 0;
}

__device__ __forceinline__ void bar1(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// Threads that sweep `n` listed pixels: one a pixel (whole warps) while
// n <= max_threads, else max_threads, each owning several.
__device__ __forceinline__ int sweep_threads(int n, int max_threads) {
  return n <= max_threads ? 32 * ((n + 31) / 32) : max_threads;
}

// Label sweeps over the listed pixels (indices into the padded span P x P),
// R a thread, by the first nsw threads; returns the sweeps done (a sweep
// that changes no label is the last: both buffers then hold the result).
template <int R, int P>
__device__ __forceinline__ int label_sweeps(int tid, int nsw, int n, const unsigned short* list,
                                            int (*lab)[P * P], int sweeps) {
  int idx[R], val[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = tid + r * nsw;
    idx[r] = k < n ? list[k] : 0;
    val[r] = k < n ? lab[0][idx[r]] : 0;
  }
  int s = 0;
  while (s < sweeps) {
    const int* cur = lab[s & 1];
    int* nxt = lab[(s & 1) ^ 1];
    bool changed = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (tid + r * nsw < n) {
        const int* c = cur + idx[r];
        const int m = max(max(max(c[-P - 1], c[-P]), max(c[-P + 1], c[-1])),
                          max(max(c[0], c[1]), max(max(c[P - 1], c[P]), c[P + 1])));
        changed = changed || m != val[r];
        val[r] = m;
        nxt[idx[r]] = m;
      }
    }
    ++s;
    if (!bar1_any(changed, nsw)) break;
  }
  return s;
}

// A label launch's shape: a 32x32 tile in a span with a `Halo` px halo
// (exact for up to Halo sweeps), NT threads.
template <int Halo, int NT>
struct LabShape {
  static constexpr int kSpan = kLabTile + 2 * Halo;
  static constexpr int P = kSpan + 2;  // the span with a ring of zeros
  static constexpr int S2 = kSpan * kSpan;
  static constexpr int kLoad = (S2 + NT - 1) / NT;
  static constexpr int kSmem = 2 * P * P * 4 + S2 * 2;  // both label buffers, the list
  static_assert(kLoad <= 32, "a thread's foreground pixels are bits of one word");
};

// 3x3 max-label propagation, exactly `sweeps` sweeps, labels = 1-based flat
// index of the pixel, 0 on background.  Only foreground pixels change: they
// are listed and swept (label_sweeps) in a span with a ring of zeros, so no
// neighbour needs a bounds check.
template <int Halo, int NT, int P = LabShape<Halo, NT>::P>
__device__ __forceinline__ void label_tile(const float* __restrict__ blurred, int h, int w,
                                           int sweeps, int* __restrict__ lab_out,
                                           int (*lab)[P * P], unsigned short* list, int& s_n,
                                           int& s_fin) {
  using Sh = LabShape<Halo, NT>;
  constexpr int S2 = Sh::S2, kSpan = Sh::kSpan, kLoad = Sh::kLoad;
  const int oy = blockIdx.y * kLabTile - Halo;
  const int ox = blockIdx.x * kLabTile - Halo;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) s_n = s_fin = 0;
  for (int i = tid; i < P * P; i += NT) lab[0][i] = lab[1][i] = 0;
  unsigned fg = 0;  // bit r: pixel tid + r * NT is foreground
#pragma unroll
  for (int r = 0; r < kLoad; ++r) {
    const int i = tid + r * NT;
    const int gy = oy + i / kSpan, gx = ox + i % kSpan;
    if (i < S2 && gy >= 0 && gy < h && gx >= 0 && gx < w && blurred[gy * w + gx] > 1e-3f)
      fg |= 1u << r;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kLoad; ++r) {
    const int i = tid + r * NT;
    const int ly = i / kSpan, lx = i % kSpan;
    const int pi = (ly + 1) * P + lx + 1;
    const bool f = (fg >> r) & 1u;
    if (f) lab[0][pi] = lab[1][pi] = (oy + ly) * w + ox + lx + 1;
    const unsigned ball = __ballot_sync(0xFFFFFFFFu, f);
    int at = 0;
    if (lane == 0 && ball) at = atomicAdd(&s_n, __popc(ball));
    at = __shfl_sync(0xFFFFFFFFu, at, 0);
    if (f) list[at + __popc(ball & ((1u << lane) - 1u))] = (unsigned short)pi;
  }
  __syncthreads();
  const int n = s_n;
  if (n > 0) {
    const int nsw = sweep_threads(n, NT);
    int done = 0;
    if (tid < nsw)
      done = n <= NT ? label_sweeps<1, P>(tid, nsw, n, list, lab, sweeps)
                     : label_sweeps<kLoad, P>(tid, nsw, n, list, lab, sweeps);
    if (tid == 0) s_fin = done & 1;
  }
  __syncthreads();
  const int fin = s_fin;
  for (int i = tid; i < kLabTile * kLabTile; i += NT) {
    const int ty = i / kLabTile, tx = i % kLabTile;
    const int gy = blockIdx.y * kLabTile + ty, gx = blockIdx.x * kLabTile + tx;
    if (gy < h && gx < w)
      lab_out[gy * w + gx] = lab[fin][(Halo + ty + 1) * P + Halo + tx + 1];
  }
}

// Up to 12 sweeps: static shared memory.
__global__ void __launch_bounds__(kLabThreads)
    label_kernel(const float* __restrict__ blurred, int h, int w, int sweeps,
                 int* __restrict__ lab_out) {
  using Sh = LabShape<kLabHalo, kLabThreads>;
  static_assert(Sh::kSpan == kLabSpan, "label span");
  __shared__ int lab[2][Sh::P * Sh::P];
  __shared__ unsigned short list[Sh::S2];
  __shared__ int s_n, s_fin;
  label_tile<kLabHalo, kLabThreads>(blurred, h, w, sweeps, lab_out, lab, list, s_n, s_fin);
}

// 13 to 32 sweeps: the same in dynamic shared memory.
__global__ void __launch_bounds__(kLabWideThreads)
    label_wide_kernel(const float* __restrict__ blurred, int h, int w, int sweeps,
                      int* __restrict__ lab_out) {
  using Sh = LabShape<kLabWideHalo, kLabWideThreads>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto lab = reinterpret_cast<int (*)[Sh::P * Sh::P]>(smem_raw);
  auto list = reinterpret_cast<unsigned short*>(smem_raw + 2 * Sh::P * Sh::P * 4);
  __shared__ int s_n, s_fin;
  label_tile<kLabWideHalo, kLabWideThreads>(blurred, h, w, sweeps, lab_out, lab, list, s_n,
                                            s_fin);
}

// The stats launch's shape: an interior tile of T x T pixels in a span of
// (T + 2 Halo)^2, exact for up to Halo / 2 sweeps.  The default shape
// (StatsShape, up to 12 sweeps): T = 24 measured faster on the H100 than 16
// (more redundant span loads) and 32 (a longer chain of barriers in each
// block, on fewer SMs): PERF.md, kernel A.  The wide shape (up to 32
// sweeps): T = 16, the largest tile whose span fits a block's shared memory;
// its bbox sweeps keep their values in shared memory (kRegSweeps false).
template <int T_, int Halo_, int NT_, bool RegSweeps_>
struct StatsShapeT {
  static constexpr int T = T_;
  static constexpr int kHalo = Halo_;
  static constexpr bool kRegSweeps = RegSweeps_;
  static constexpr int kSpan = T + 2 * kHalo;
  static constexpr int kSpan2 = kSpan * kSpan;
  static constexpr int kThreads = NT_;
  static constexpr int kPix = (T * T + kThreads - 1) / kThreads;  // interior pixels a thread
  static constexpr int kOwn = (kSpan2 + kThreads - 1) / kThreads;  // listed pixels a thread
  // shared memory: labels (then the second sweep buffer, then the roots'
  // keys), the first sweep buffer, neighbour bits, the list, interior kinds
  static constexpr int kSmem = kSpan2 * (4 + 4 + 1 + 2) + T * T;
  static_assert(kSpan <= 254, "packed extrema need a span of at most 254 px");
  static_assert(T * T % 32 == 0 && kSpan2 % 2 == 0, "tile shape");
  static_assert(T * T * 8 <= kSpan2 * 4, "the roots' keys must fit the label buffer");
  static_assert(kSmem <= 232448 - 64, "a block's shared memory");
  static_assert(T * T >= kWideTopk, "a tile fills its top-k from its own pixels");
};
using StatsShape = StatsShapeT<24, kStHalo, 512, true>;
using StatsWideShape = StatsShapeT<16, kStWideHalo, 512, false>;

// shifted[y, x] = src[y - dy, x - dx], in the reference's direction order
__device__ __forceinline__ int dir_dy(int d) {
  return (d == 2 || d == 4 || d == 5) ? 1 : (d == 3 || d >= 6) ? -1 : 0;
}
__device__ __forceinline__ int dir_dx(int d) {
  return (d == 0 || d == 4 || d == 6) ? 1 : (d == 1 || d == 5 || d == 7) ? -1 : 0;
}

// The bbox sweeps over the listed pixels, R a thread, by the first nsw
// threads: 8 steps a sweep, buf_a -> buf_b -> buf_a, so the final words are
// in buf_a (unlisted pixels never change and are never read).  A sweep that
// changes no word ends the loop: the state is a fixed point of every step.
template <int R, int S>
__device__ __forceinline__ void bbox_sweeps(int tid, int nsw, int nlist,
                                            const unsigned short* list, const unsigned char* nbr,
                                            unsigned* buf_a, unsigned* buf_b, int reach) {
  unsigned ent[R], val[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = tid + r * nsw;
    ent[r] = 0;
    val[r] = 0;
    if (k < nlist) {
      const int i = list[k];
      ent[r] = (unsigned)i | ((unsigned)nbr[i] << 16);
      val[r] = buf_a[i];
    }
  }
  for (int s = 0; s < reach; ++s) {
    bool changed = false;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const unsigned* cur = (d & 1) ? buf_b : buf_a;
      unsigned* nxt = (d & 1) ? buf_a : buf_b;
      const int off = -(dir_dy(d) * S + dir_dx(d));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (tid + r * nsw < nlist) {
          const int i = ent[r] & 0xFFFF;
          if ((ent[r] >> (16 + d)) & 1u) {
            const unsigned v = __vminu4(val[r], cur[i + off]);
            changed = changed || v != val[r];
            val[r] = v;
          }
          nxt[i] = val[r];
        }
      }
      if (d < 7) bar1(nsw);
    }
    if (!bar1_any(changed, nsw)) break;
  }
}

// bbox_sweeps with every value read from the buffers instead of registers:
// a listed pixel's own word in the buffer a step reads is the value the
// register form holds, so both give the same words.
template <int S>
__device__ __forceinline__ void bbox_sweeps_shared(int tid, int nsw, int nlist,
                                                   const unsigned short* list,
                                                   const unsigned char* nbr, unsigned* buf_a,
                                                   unsigned* buf_b, int reach) {
  for (int s = 0; s < reach; ++s) {
    bool changed = false;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const unsigned* cur = (d & 1) ? buf_b : buf_a;
      unsigned* nxt = (d & 1) ? buf_a : buf_b;
      const int off = -(dir_dy(d) * S + dir_dx(d));
      for (int k = tid; k < nlist; k += nsw) {
        const int i = list[k];
        unsigned v = cur[i];
        if ((nbr[i] >> d) & 1u) {
          const unsigned nv = __vminu4(v, cur[i + off]);
          changed = changed || nv != v;
          v = nv;
        }
        nxt[i] = v;
      }
      if (d < 7) bar1(nsw);
    }
    if (!bar1_any(changed, nsw)) break;
  }
}

// Windowed same-label sums (dy in [-reach, 0], dx in [-reach, reach]), the
// bbox extrema by `reach` sweeps of same-label min/max propagation in the
// reference's direction order, and the tile's top-k keys.  maps: 10 planes
// of (h, w) in the order cnt, sx, sy, xmin, xmax, ymin, ymax, sxx, syy, sxy;
// tile_keys: topk keys per tile, best first.
template <class Sh>
__global__ void __launch_bounds__(Sh::kThreads)
    stats_kernel(const int* __restrict__ lab, const float* __restrict__ prm, int h, int w,
                 int reach, int topk, float* __restrict__ maps,
                 unsigned long long* __restrict__ tile_keys) {
  constexpr int T = Sh::T, S = Sh::kSpan, S2 = Sh::kSpan2, NT = Sh::kThreads;
  constexpr int H = Sh::kHalo;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the labels' space holds the second sweep buffer after the sums, the
  // roots' keys after the sweeps
  int* labb = reinterpret_cast<int*>(smem_raw);
  unsigned* buf_b = reinterpret_cast<unsigned*>(smem_raw);
  unsigned long long* root_keys = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned* buf_a = reinterpret_cast<unsigned*>(labb + S2);
  unsigned char* nbr = reinterpret_cast<unsigned char*>(buf_a + S2);
  unsigned short* list = reinterpret_cast<unsigned short*>(nbr + S2);
  unsigned char* kind = reinterpret_cast<unsigned char*>(list + S2);  // 0 outside, 1 other, 2 root
  __shared__ int s_nlist, s_nroots;

  const int tid = threadIdx.x, lane = tid & 31;
  const int oy = blockIdx.y * T - H;
  const int ox = blockIdx.x * T - H;
  if (tid == 0) {
    s_nlist = 0;
    s_nroots = 0;
  }
  {
    int l[Sh::kOwn];
#pragma unroll
    for (int r = 0; r < Sh::kOwn; ++r) {
      const int i = tid + r * NT;
      const int gy = oy + i / S, gx = ox + i % S;
      const bool inside = i < S2 && gy >= 0 && gy < h && gx >= 0 && gx < w;
      // background biased to unique negatives; outside the frame 0 (no match)
      l[r] = inside ? lab[gy * w + gx] : 0;
      l[r] = inside ? (l[r] > 0 ? l[r] : -(gy * w + gx + 1)) : 0;
    }
#pragma unroll
    for (int r = 0; r < Sh::kOwn; ++r)
      if (tid + r * NT < S2) labb[tid + r * NT] = l[r];
  }
  __syncthreads();

  // neighbour bits, packed extrema and the list of pixels that can change
  for (int base = 0; base < S2; base += NT) {
    const int i = base + tid;
    unsigned bits = 0;
    if (i < S2) {
      const int ly = i / S, lx = i % S;
      const int me = labb[i];
      unsigned v = 0xFFFFFFFFu;
      if (me > 0) {
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          const int sy = ly - dir_dy(d), sx = lx - dir_dx(d);
          if (sy >= 0 && sy < S && sx >= 0 && sx < S && labb[sy * S + sx] == me) bits |= 1u << d;
        }
        v = (unsigned)lx | ((unsigned)ly << 8) | ((unsigned)(255 - lx) << 16) |
            ((unsigned)(255 - ly) << 24);
      }
      nbr[i] = (unsigned char)bits;
      buf_a[i] = v;
    }
    const unsigned ball = __ballot_sync(0xFFFFFFFFu, bits != 0);
    int at = 0;
    if (lane == 0 && ball) at = atomicAdd(&s_nlist, __popc(ball));
    at = __shfl_sync(0xFFFFFFFFu, at, 0);
    if (bits) list[at + __popc(ball & ((1u << lane) - 1u))] = (unsigned short)i;
  }

  // windowed moment sums of this thread's interior pixels
  int me[Sh::kPix];
  float cnt[Sh::kPix], sx[Sh::kPix], sy[Sh::kPix], sxx[Sh::kPix], syy[Sh::kPix], sxy[Sh::kPix];
#pragma unroll
  for (int r = 0; r < Sh::kPix; ++r) {
    const int p = tid + r * NT;
    const int ty = p / T, tx = p % T;
    const int cy = H + ty, cxl = H + tx;
    me[r] = p < T * T ? labb[cy * S + cxl] : 0;
    // Every term and partial sum is an integer below 2^24, so the float sums
    // of the plain version are exact in any order: integer sums equal them
    // (zeros included, which the float sums leave as +0).
    int c = 1, a = 0, b = 0, aa = 0, bb = 0, ab = 0;
    if (me[r] > 0) {
      c = 0;
      for (int dy = -reach; dy <= 0; ++dy) {
        int r_cnt = 0, r_sx = 0, r_sxx = 0;
        const int* row = labb + (cy + dy) * S + cxl;
#pragma unroll 5
        for (int dx = -reach; dx <= reach; ++dx) {
          if (row[dx] == me[r]) {
            r_cnt += 1;
            r_sx += dx;
            r_sxx += dx * dx;
          }
        }
        c += r_cnt;
        a += r_sx;
        b += dy * r_cnt;
        aa += r_sxx;
        bb += dy * dy * r_cnt;
        ab += dy * r_sx;
      }
    }
    cnt[r] = (float)c;
    sx[r] = (float)a;
    sy[r] = (float)b;
    sxx[r] = (float)aa;
    syy[r] = (float)bb;
    sxy[r] = (float)ab;
  }
  __syncthreads();  // the labels are done with: their space becomes buf_b

  // bbox sweeps (bbox_sweeps); the final words are in buf_a
  const int nlist = s_nlist;
  if (nlist > 0) {
    const int nsw = sweep_threads(nlist, NT);
    if (tid < nsw) {
      if constexpr (!Sh::kRegSweeps)
        bbox_sweeps_shared<S>(tid, nsw, nlist, list, nbr, buf_a, buf_b, reach);
      else if (nlist <= NT)
        bbox_sweeps<1, S>(tid, nsw, nlist, list, nbr, buf_a, buf_b, reach);
      else
        bbox_sweeps<Sh::kOwn, S>(tid, nsw, nlist, list, nbr, buf_a, buf_b, reach);
    }
  }
  __syncthreads();

  // the maps of this thread's interior pixels, and their kinds for the ranking
  const int hw = h * w;
  const float min_area = prm[5], max_area = prm[6];
#pragma unroll
  for (int r = 0; r < Sh::kPix; ++r) {
    const int p = tid + r * NT;
    if (p >= T * T) continue;
    const int ty = p / T, tx = p % T;
    const int gy = blockIdx.y * T + ty, gx = blockIdx.x * T + tx;
    unsigned char k = 0;
    if (gy < h && gx < w) {
      const int o = gy * w + gx;
      const unsigned word = buf_a[(H + ty) * S + H + tx];
      const bool fg = me[r] > 0;
      maps[0 * hw + o] = cnt[r];
      maps[1 * hw + o] = sx[r];
      maps[2 * hw + o] = sy[r];
      maps[3 * hw + o] = fg ? (float)(ox + (int)(word & 0xFFu)) : 1e9f;
      maps[4 * hw + o] = fg ? (float)(ox + 255 - (int)((word >> 16) & 0xFFu)) : -1e9f;
      maps[5 * hw + o] = fg ? (float)(oy + (int)((word >> 8) & 0xFFu)) : 1e9f;
      maps[6 * hw + o] = fg ? (float)(oy + 255 - (int)(word >> 24)) : -1e9f;
      maps[7 * hw + o] = sxx[r];
      maps[8 * hw + o] = syy[r];
      maps[9 * hw + o] = sxy[r];
      k = 1;
      if (me[r] == o + 1) {  // a root: rank by the reference's score
        const float area = cnt[r];
        const bool in_range = area >= min_area && area <= max_area && area > 0.0f;
        const float score = in_range ? area + 1e6f : area;
        const unsigned long long key = ((unsigned long long)__float_as_uint(score) << 32) |
                                       (0xFFFFFFFFull - (unsigned)o);
        root_keys[atomicAdd(&s_nroots, 1)] = key;
        k = 2;
      }
    }
    kind[p] = k;
  }
  __syncthreads();

  // the tile's top-k: its roots by rank, then its other pixels by index
  unsigned long long* out = tile_keys + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * topk;
  const int nroots = s_nroots;
  const int nr = min(nroots, topk);
  for (int a = tid; a < nroots; a += NT) {
    const unsigned long long key = root_keys[a];
    int rank = 0;
    for (int b = 0; b < nroots; ++b) rank += root_keys[b] > key;
    if (rank < topk) out[rank] = key;
  }
  if (tid < 32) {
    const int need = topk - nr;
    int filled = 0;
    for (int base = 0; base < T * T && filled < need; base += 32) {
      const int p = base + lane;
      const bool other = kind[p] == 1;
      const unsigned ball = __ballot_sync(0xFFFFFFFFu, other);
      const int at = filled + __popc(ball & ((1u << lane) - 1u));
      if (other && at < need) {
        const int o = (blockIdx.y * T + p / T) * w + blockIdx.x * T + p % T;
        out[nr + at] = 0xFFFFFFFFull - (unsigned)o;  // score 0
      }
      filled += __popc(ball);
    }
    for (int slot = nr + min(filled, need) + lane; slot < topk; slot += 32) out[slot] = 0;
  }
}

// The largest 64-bit key of a warp, by two 32-bit reductions.
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long k) {
  const unsigned hi = __reduce_max_sync(0xFFFFFFFFu, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(0xFFFFFFFFu, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

// k rounds of "the largest key below the last one taken" over one warp's
// keys[0, n) (distinct, or 0: padding, which is what a round takes once
// nothing is left); round t's key goes to out[t], so out is descending.
__device__ __forceinline__ void warp_topk(const unsigned long long* keys, int n, int topk,
                                          unsigned long long* out) {
  const int lane = threadIdx.x & 31;
  const int nheld = (n + 31) / 32;  // keys a lane holds, if at most kMergeHeld
  const bool held = nheld <= kMergeHeld;  // else each round reads them again
  unsigned long long reg[kMergeHeld];
#pragma unroll
  for (int j = 0; j < kMergeHeld; ++j) {
    const int i = lane + 32 * j;
    reg[j] = held && i < n ? keys[i] : 0;
  }
  unsigned long long taken = ~0ull;
  for (int t = 0; t < topk; ++t) {
    unsigned long long best = 0;
    if (held) {
#pragma unroll
      for (int j = 0; j < kMergeHeld; ++j) {
        if (j == nheld) break;
        if (reg[j] < taken && reg[j] > best) best = reg[j];
      }
    } else {
      for (int i = lane; i < n; i += 32) {
        const unsigned long long k = keys[i];
        if (k < taken && k > best) best = k;
      }
    }
    taken = warp_max_key(best);
    if (lane == 0) out[t] = taken;
  }
}

// The global top-k (topk <= Cap) from the tiles' keys: each of 8 warps takes
// the top-k of its share, then warp 0 merges the 8 descending lists by their
// heads.
template <int Cap>
__global__ void __launch_bounds__(kMergeThreads)
    topk_merge_kernel(const unsigned long long* __restrict__ keys, int n, int topk,
                      int* __restrict__ out) {
  constexpr int kWarps = kMergeThreads / 32;
  __shared__ unsigned long long lists[kWarps * Cap];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int share = (n + kWarps - 1) / kWarps;
  const int lo = min(n, warp * share), hi = min(n, lo + share);
  warp_topk(keys + lo, hi - lo, topk, lists + warp * topk);
  __syncthreads();
  if (warp == 0) {
    const unsigned long long* mine = lists + lane * topk;
    int at = 0;
    unsigned long long head = lane < kWarps ? mine[0] : 0;
    for (int t = 0; t < topk; ++t) {
      const unsigned long long best = warp_max_key(head);
      if (lane < kWarps && head == best) head = ++at < topk ? mine[at] : 0;
      if (lane == 0) out[t] = (int)(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFull));
    }
  }
}

template <class Sh>
int n_tiles(int h, int w) {
  constexpr int T = Sh::T;
  return ((w + T - 1) / T) * ((h + T - 1) / T);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising its
// limit once first.
template <class Kernel, class... Args>
cudaError_t launch_dynamic(Kernel kernel, bool& ready, int smem, dim3 grid, int threads,
                           cudaStream_t st, Args... args) {
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <class Sh>
cudaError_t launch_stats(const int* lab, const float* prm, int h, int w, int sweeps, int topk,
                         float* maps, unsigned long long* tile_keys, cudaStream_t st) {
  static bool ready = false;
  const dim3 grid((w + Sh::T - 1) / Sh::T, (h + Sh::T - 1) / Sh::T);
  return launch_dynamic(stats_kernel<Sh>, ready, Sh::kSmem, grid, Sh::kThreads, st, lab, prm, h,
                        w, sweeps, topk, maps, tile_keys);
}

}  // namespace

extern "C" {

int pfmpe_threshold_blur(const float* img, const float* prm, int ntaps, int h, int w, int active,
                         float* out, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps) return (int)cudaErrorInvalidValue;
  const dim3 block(kBlurX, kBlurY);
  const dim3 grid((w + kBlurX - 1) / kBlurX, (h + kBlurY - 1) / kBlurY);
  threshold_blur_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, prm, ntaps, h, w, active,
                                                                   out);
  return (int)cudaGetLastError();
}

// The stats tile of a sweep count (tile_keys holds n_tiles * topk keys).
int pfmpe_detect_stats_tile(int sweeps) {
  return sweeps <= kMaxSweeps ? StatsShape::T : StatsWideShape::T;
}

// blurred: (h, w) scratch; lab: (h, w) int32; maps: (10, h, w);
// tile_keys: (tiles * topk,) scratch, tiles = ceil(h / T) * ceil(w / T) with
// T = pfmpe_detect_stats_tile(sweeps); topk_out: (topk,).  0 <= sweeps <= 32,
// 1 <= topk <= min(128, h * w).
int pfmpe_detect_stats(const float* img, const float* prm, int ntaps, int h, int w, int active,
                       int sweeps, int topk, float* blurred, int* lab, float* maps,
                       unsigned long long* tile_keys, int* topk_out, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || sweeps < 0 || sweeps > kWideSweeps || topk < 1 ||
      topk > kWideTopk || (long long)h * w < topk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = sweeps > kMaxSweeps;
  {
    const dim3 block(kBlurX, kBlurY);
    const dim3 grid((w + kBlurX - 1) / kBlurX, (h + kBlurY - 1) / kBlurY);
    threshold_blur_kernel<<<grid, block, 0, st>>>(img, prm, ntaps, h, w, active, blurred);
  }
  const dim3 lab_grid((w + kLabTile - 1) / kLabTile, (h + kLabTile - 1) / kLabTile);
  cudaError_t e;
  if (!wide) {
    label_kernel<<<lab_grid, kLabThreads, 0, st>>>(blurred, h, w, sweeps, lab);
    e = launch_stats<StatsShape>(lab, prm, h, w, sweeps, topk, maps, tile_keys, st);
  } else {
    using L = LabShape<kLabWideHalo, kLabWideThreads>;
    static bool ready = false;
    e = launch_dynamic(label_wide_kernel, ready, L::kSmem, lab_grid, kLabWideThreads, st, blurred,
                       h, w, sweeps, lab);
    if (e == cudaSuccess)
      e = launch_stats<StatsWideShape>(lab, prm, h, w, sweeps, topk, maps, tile_keys, st);
  }
  if (e != cudaSuccess) return (int)e;
  const int n_keys = (wide ? n_tiles<StatsWideShape>(h, w) : n_tiles<StatsShape>(h, w)) * topk;
  if (topk <= kMaxTopk)
    topk_merge_kernel<kMaxTopk><<<1, kMergeThreads, 0, st>>>(tile_keys, n_keys, topk, topk_out);
  else
    topk_merge_kernel<kWideTopk><<<1, kMergeThreads, 0, st>>>(tile_keys, n_keys, topk, topk_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
