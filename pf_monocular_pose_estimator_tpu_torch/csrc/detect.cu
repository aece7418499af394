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
// Those halos are for at most 12 sweeps and a top-k of at most 64, the
// tracker's defaults.  Beyond them (13 to 32 sweeps, or a top-k of 65 to
// 128) the wide path runs the same work in rounds through global memory,
// every round exact on its own tiles:
//   * labels: a sweep is a function of the last label map alone, so s
//     sweeps are rounds of at most 12, each a launch of 32x32 tiles with
//     the 12 px halo started from the last round's map (ping-pong in global
//     memory, the last round into the output);
//   * bbox: the same holds for the four bbox maps.  A value moves at most
//     3 px a sweep (three of the eight directions step each way), so a
//     round of 4 sweeps on a 32x32 tile with a 12 px halo is exact, and one
//     round of any sweeps <= 6 is exact by the label argument above.
//     Between rounds a pixel's extrema travel as one 32-bit word of bytes
//     relative to the pixel (each lies within 2 x 32 px of it);
//   * windowed sums: a pixel's sums need the final labels within `sweeps`
//     px and nothing else, so blocks of a second kind beside the first
//     bbox rounds' (one wave of tiles in each) stage a 16x16 tile with
//     that reach above and beside it, split the foreground pixels' windows
//     into runs of rows over all 1024 threads and add the integer sums
//     with shared-memory atomics.  They also append their tile's best
//     roots' keys to one compact list;
//   * top-k: one block takes the top-k of that list (the roots, which all
//     score > 0) and fills the rest with the lowest flat indices that are
//     not roots (score 0).
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
// The default path's top-k (1 to 64) is exact in two stages.  The ranking
// (score descending, flat index ascending) is a strict total order, encoded
// as one 64-bit key (float bits of the score << 32 | 0xFFFFFFFF - index;
// scores are >= 0, so their bits sort as unsigned integers), and the global
// top-k lies in the union of the tiles' top-k.  Every root scores > 0 and
// every other pixel exactly 0, so a tile's top-k is its roots by key, then
// its other pixels by index; the stats launch writes them, and one block
// merges the tiles' keys.
//
// Blur sums keep the reference's tap order, and the moment sums are exact
// integers in any order; built with --fmad=false, so the blurred map,
// labels, counts, moment sums, bbox maps and the top-k equal the plain
// PyTorch version bit for bit.
//
// The crop path's epilogue, `detect_epilogue_kernel`, turns A's label map,
// statistics maps and top-k into the finished detection bank: per top-k
// slot the root test and area, the centroid, variances and bounding box,
// the shape filters, the merged-blob split with its dip samples of the
// crop, then the stable compaction of the 2K keys to K slots, the crop
// offset, 8 fixed-point undistortion iterations and the final masking.  It
// replaces no TPU kernel: the reference leaves this tail to XLA
// (pf_monocular_pose_estimator_tpu/ops/blob.py::_detect_blobs_fused,
// _split_and_compact, find_leds), and the port ran it as ~500 PyTorch ops.
// What bounds it: latency -- K <= 128 slots of a few hundred dependent
// flops and 9 image samples, then one compaction.  One block of 2K threads
// does it all from registers and shared memory: a thread a slot, then a
// thread a compaction key whose rank (keys below it, plus equal keys at a
// lower index: torch.sort's stable order) is its output slot.  Each value
// is computed as PyTorch computes it on the card, op by op (IEEE `/` and
// `sqrtf`, `rintf` for torch.round, NaN through torch.minimum and clamp,
// float32 scalars, left to right), so the bank equals the plain version's
// bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kMaxTaps = 15;
constexpr int kBlurX = 32, kBlurY = 8;
constexpr int kLabTile = 32;
constexpr int kLabHalo = 12;
constexpr int kLabSpan = kLabTile + 2 * kLabHalo;  // 56
constexpr int kLabThreads = 256;
constexpr int kStHalo = 24;                        // 2 x the largest sweep count
constexpr int kMaxSweeps = kLabHalo;               // the default shapes' sweeps
constexpr int kMaxTopk = 64;   // the default merge's list
constexpr int kWideSweeps = 32;  // the wide path's largest sweep count
constexpr int kWideTopk = 128;   // and top-k
// the wide path's launches (see the head of this file)
constexpr int kLabRoundThreads = 1024;
constexpr int kBbTile = 32, kBbHalo = 12, kBbThreads = 1024;
constexpr int kBbRoundSweeps = kBbHalo / 3;  // a value moves at most 3 px a sweep
constexpr int kSumTile = 16;
constexpr int kMergeSort = 4096, kMergeSortThreads = 256;  // the wide merge's sorts
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
  static_assert(kLoad <= 32, "a thread's foreground pixels are bits of one word");
};

// 3x3 max-label propagation, exactly `sweeps` sweeps, labels = 1-based flat
// index of the pixel, 0 on background.  Only foreground pixels change: they
// are listed and swept (label_sweeps) in a span with a ring of zeros, so no
// neighbour needs a bounds check.  Src = float: from the blurred map
// (foreground > 1e-3); Src = int: from a label map (foreground > 0), the
// wide path's later rounds.
template <int Halo, int NT, class Src = float, int P = LabShape<Halo, NT>::P>
__device__ __forceinline__ void label_tile(const Src* __restrict__ src, int h, int w,
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
  int init[kLoad];  // Src = int: the pixel's label
#pragma unroll
  for (int r = 0; r < kLoad; ++r) {
    const int i = tid + r * NT;
    const int gy = oy + i / kSpan, gx = ox + i % kSpan;
    const bool in = i < S2 && gy >= 0 && gy < h && gx >= 0 && gx < w;
    if constexpr (std::is_integral_v<Src>) {
      init[r] = in ? src[gy * w + gx] : 0;
      if (init[r] > 0) fg |= 1u << r;
    } else {
      init[r] = 0;
      if (in && src[gy * w + gx] > 1e-3f) fg |= 1u << r;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kLoad; ++r) {
    const int i = tid + r * NT;
    const int ly = i / kSpan, lx = i % kSpan;
    const int pi = (ly + 1) * P + lx + 1;
    const bool f = (fg >> r) & 1u;
    if (f) lab[0][pi] = lab[1][pi] = init[r] > 0 ? init[r] : (oy + ly) * w + ox + lx + 1;
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

// The wide path's label rounds (at most 12 sweeps each): 1024 threads, from
// the blurred map (the first round) or from the last round's labels.
template <class Src>
__global__ void __launch_bounds__(kLabRoundThreads)
    label_round_kernel(const Src* __restrict__ src, int h, int w, int sweeps,
                       int* __restrict__ lab_out) {
  using Sh = LabShape<kLabHalo, kLabRoundThreads>;
  __shared__ int lab[2][Sh::P * Sh::P];
  __shared__ unsigned short list[Sh::S2];
  __shared__ int s_n, s_fin;
  label_tile<kLabHalo, kLabRoundThreads, Src>(src, h, w, sweeps, lab_out, lab, list, s_n,
                                              s_fin);
}

// The stats launch's shape: an interior tile of T x T pixels in a span of
// (T + 2 Halo)^2, exact for up to Halo / 2 sweeps.  StatsShape (up to 12
// sweeps): T = 24 measured faster on the H100 than 16 (more redundant span
// loads) and 32 (a longer chain of barriers in each block, on fewer SMs):
// PERF.md, kernel A.
template <int T_, int Halo_, int NT_>
struct StatsShapeT {
  static constexpr int T = T_;
  static constexpr int kHalo = Halo_;
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
  static_assert(T * T >= kMaxTopk, "a tile fills its top-k from its own pixels");
};
using StatsShape = StatsShapeT<24, kStHalo, 512>;

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
      if (nlist <= NT)
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

// ---- The wide path: 13 to 32 sweeps, or a top-k of 65 to 128 ----

// A bbox round's tile: 32x32 pixels with a 12 px halo (rounds of 4 sweeps:
// measured faster on the H100 than halos of 24 and 36 px with rounds of 8
// and 12, whose spans make every step longer; PERF.md, kernel A).  Its
// extrema are 16-bit lanes relative to the span's origin less kOff (every
// value is the coordinate of a pixel of the same label, within 2 x 32 px
// of its own pixel): (xmin, ymin) and (0xFFFF - xmax, 0xFFFF - ymax), so a
// step is two __vminu2 (one instruction each on sm_90, where __vminu4 is
// six).
struct WideBb {
  static constexpr int T = kBbTile, H = kBbHalo, S = T + 2 * H, S2 = S * S, NT = kBbThreads;
  static constexpr int kOwn = (S2 + NT - 1) / NT;  // span pixels a thread
  static constexpr int kOff = 2 * kWideSweeps;
  // the second sweep buffer (the labels first), the first sweep buffer
  // (each with a dummy word), neighbour bits, the list
  static constexpr int kSmem = (S2 + 1) * 8 * 2 + S2 * (1 + 2);
};

// A sums tile: 16x16 pixels with `sweeps` px of labels above and beside it.
// The tiles are shared out over the first bbox rounds, as many in a round
// as there are SMs beside the bbox tiles, so each of those launches is one
// wave (all of them in the first round took two waves beside it, and
// tiles of 24 and 32 px took longer than a round).
struct WideSum {
  static constexpr int T = kSumTile, T2 = T * T, NT = kBbThreads;
  static constexpr int kMaxRows = T + kWideSweeps, kMaxCols = T + 2 * kWideSweeps;
  // labels, six sums a pixel, the foreground list, the roots' keys
  static constexpr int kSmem = kMaxRows * kMaxCols * 4 + 6 * T2 * 4 + T2 * 2 + T2 * 8;
  static_assert(kSmem <= WideBb::kSmem, "both kinds of block share one launch's shared memory");
  static_assert(T2 <= NT, "one interior pixel a thread");
};

// Tiles of `t` px over an h x w frame.
__host__ __device__ __forceinline__ int tiles_x(int w, int t) { return (w + t - 1) / t; }
__host__ __device__ __forceinline__ int tiles_of(int h, int w, int t) {
  return tiles_x(w, t) * ((h + t - 1) / t);
}

// bbox_sweeps on the wide path's 16x2 words, R listed pixels a thread,
// without branches: a slot past the list points at the dummy word S2 (no
// neighbour bits, written and never read), a neighbour is loaded only
// where its bit is set, and the change test is made once a sweep.
template <int R, int S>
__device__ __forceinline__ void bbox_sweeps_u16(int tid, int nsw, int nlist,
                                                const unsigned short* list,
                                                const unsigned char* nbr, uint2* buf_a,
                                                uint2* buf_b, int reach) {
  unsigned ent[R];
  uint2 val[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = tid + r * nsw;
    const int i = k < nlist ? list[k] : S * S;
    ent[r] = (unsigned)i | (k < nlist ? (unsigned)nbr[i] << 16 : 0u);
    val[r] = buf_a[i];
  }
  for (int s = 0; s < reach; ++s) {
    uint2 start[R];
#pragma unroll
    for (int r = 0; r < R; ++r) start[r] = val[r];
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const uint2* cur = (d & 1) ? buf_b : buf_a;
      uint2* nxt = (d & 1) ? buf_a : buf_b;
      const int off = -(dir_dy(d) * S + dir_dx(d));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ent[r] & 0xFFFF;
        if ((ent[r] >> (16 + d)) & 1u) {
          const uint2 c = cur[i + off];
          val[r] = make_uint2(__vminu2(val[r].x, c.x), __vminu2(val[r].y, c.y));
        }
        nxt[i] = val[r];
      }
      if (d < 7) bar1(nsw);
    }
    bool changed = false;
#pragma unroll
    for (int r = 0; r < R; ++r)
      changed = changed || val[r].x != start[r].x || val[r].y != start[r].y;
    if (!bar1_any(changed, nsw)) break;
  }
}

// One bbox round on tile `b`: `rsw` sweeps from the pixels' own coordinates
// (state_in null) or from the last round's words (x - xmin, y - ymin,
// xmax - x, ymax - y as bytes), into state_out as such words or, in the last
// round (state_out null), into the four bbox maps.
__device__ __forceinline__ void wide_bbox_tile(int b, const int* __restrict__ lab, int h, int w,
                                               int rsw, const unsigned* __restrict__ state_in,
                                               unsigned* __restrict__ state_out,
                                               float* __restrict__ maps, unsigned char* smem) {
  using Sh = WideBb;
  constexpr int T = Sh::T, H = Sh::H, S = Sh::S, S2 = Sh::S2, NT = Sh::NT, kOff = Sh::kOff;
  uint2* buf_b = reinterpret_cast<uint2*>(smem);
  int* labb = reinterpret_cast<int*>(smem);  // the labels, before buf_b
  uint2* buf_a = buf_b + S2 + 1;
  unsigned char* nbr = reinterpret_cast<unsigned char*>(buf_a + S2 + 1);
  unsigned short* list = reinterpret_cast<unsigned short*>(nbr + S2);
  __shared__ int s_nlist;
  const int by = b / tiles_x(w, T), bx = b % tiles_x(w, T);
  const int oy = by * T - H, ox = bx * T - H;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) s_nlist = 0;
  unsigned st[Sh::kOwn];  // the last round's words of this thread's span pixels
#pragma unroll
  for (int r = 0; r < Sh::kOwn; ++r) {
    const int i = tid + r * NT;
    const int gy = oy + i / S, gx = ox + i % S;
    const bool inside = i < S2 && gy >= 0 && gy < h && gx >= 0 && gx < w;
    const int l = inside ? lab[gy * w + gx] : 0;
    st[r] = inside && state_in != nullptr ? state_in[gy * w + gx] : 0u;
    // background biased to unique negatives; outside the frame 0 (no match)
    if (i < S2) labb[i] = inside ? (l > 0 ? l : -(gy * w + gx + 1)) : 0;
  }
  __syncthreads();

  // neighbour bits, the words (background all ones, which no foreground
  // word is) and the list of pixels that can change
#pragma unroll
  for (int r = 0; r < Sh::kOwn; ++r) {
    const int i = tid + r * NT;
    unsigned bits = 0;
    if (i < S2) {
      const int ly = i / S, lx = i % S;
      const int me = labb[i];
      uint2 v = make_uint2(0xFFFFFFFFu, 0xFFFFFFFFu);
      if (me > 0) {
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          const int sy = ly - dir_dy(d), sx = lx - dir_dx(d);
          if (sy >= 0 && sy < S && sx >= 0 && sx < S && labb[sy * S + sx] == me) bits |= 1u << d;
        }
        const unsigned xr = lx + kOff, yr = ly + kOff;
        const unsigned xmin = state_in ? xr - (st[r] & 0xFFu) : xr;
        const unsigned ymin = state_in ? yr - ((st[r] >> 8) & 0xFFu) : yr;
        const unsigned xmax = state_in ? xr + ((st[r] >> 16) & 0xFFu) : xr;
        const unsigned ymax = state_in ? yr + (st[r] >> 24) : yr;
        v = make_uint2(xmin | (ymin << 16), (0xFFFFu - xmax) | ((0xFFFFu - ymax) << 16));
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
  __syncthreads();  // the labels are done with: their space becomes buf_b

  // the sweeps; the final words are in buf_a
  const int nlist = s_nlist;
  if (nlist > 0) {
    const int nsw = sweep_threads(nlist, NT);
    if (tid < nsw) {
      if (nlist <= NT)
        bbox_sweeps_u16<1, S>(tid, nsw, nlist, list, nbr, buf_a, buf_b, rsw);
      else if (nlist <= 2 * NT)
        bbox_sweeps_u16<2, S>(tid, nsw, nlist, list, nbr, buf_a, buf_b, rsw);
      else
        bbox_sweeps_u16<Sh::kOwn, S>(tid, nsw, nlist, list, nbr, buf_a, buf_b, rsw);
    }
  }
  __syncthreads();

  for (int p = tid; p < T * T; p += NT) {
    const int ty = p / T, tx = p % T;
    const int gy = by * T + ty, gx = bx * T + tx;
    if (gy >= h || gx >= w) continue;
    const int o = gy * w + gx;
    const unsigned xr = H + tx + kOff, yr = H + ty + kOff;
    const uint2 word = buf_a[(H + ty) * S + H + tx];
    const bool fg = word.x != 0xFFFFFFFFu;
    const unsigned xmin = word.x & 0xFFFFu, ymin = word.x >> 16;
    const unsigned xmax = 0xFFFFu - (word.y & 0xFFFFu), ymax = 0xFFFFu - (word.y >> 16);
    if (state_out != nullptr) {
      state_out[o] = fg ? (xr - xmin) | ((yr - ymin) << 8) | ((xmax - xr) << 16) |
                              ((ymax - yr) << 24)
                        : 0xFFFFFFFFu;
    } else {
      const int hw = h * w;
      maps[3 * hw + o] = fg ? (float)(ox - kOff + (int)xmin) : 1e9f;
      maps[4 * hw + o] = fg ? (float)(ox - kOff + (int)xmax) : -1e9f;
      maps[5 * hw + o] = fg ? (float)(oy - kOff + (int)ymin) : 1e9f;
      maps[6 * hw + o] = fg ? (float)(oy - kOff + (int)ymax) : -1e9f;
    }
  }
}

// The windowed sums of sums tile `b` (dy in [-reach, 0], dx in [-reach,
// reach]) and its roots' keys: the tile's best min(roots, topk) keys go to
// keys[] at a place taken from *key_count.  Each foreground pixel's window
// is cut into runs of its reach + 1 rows, spread over all the block's
// threads (the sums are integers, added with atomics in any order).
__device__ __forceinline__ void wide_sums_tile(int b, const int* __restrict__ lab,
                                               const float* __restrict__ prm, int h, int w,
                                               int reach, int topk, float* __restrict__ maps,
                                               unsigned long long* __restrict__ keys,
                                               unsigned* __restrict__ key_count,
                                               unsigned char* smem) {
  using Sh = WideSum;
  constexpr int T = Sh::T, T2 = Sh::T2, NT = Sh::NT;
  int* slab = reinterpret_cast<int*>(smem);
  int* acc = slab + Sh::kMaxRows * Sh::kMaxCols;  // cnt, sx, sy, sxx, syy, sxy: T2 each
  unsigned short* fgl = reinterpret_cast<unsigned short*>(acc + 6 * T2);
  unsigned long long* root_keys = reinterpret_cast<unsigned long long*>(fgl + T2);
  __shared__ int s_nfg, s_nroots, s_base;
  const int rows = T + reach, cols = T + 2 * reach;
  const int y0 = (b / tiles_x(w, T)) * T, x0 = (b % tiles_x(w, T)) * T;
  const int oy = y0 - reach, ox = x0 - reach;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) s_nfg = s_nroots = 0;
  for (int i = tid; i < rows * cols; i += NT) {
    const int gy = oy + i / cols, gx = ox + i % cols;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const int l = inside ? lab[gy * w + gx] : 0;
    slab[i] = inside ? (l > 0 ? l : -(gy * w + gx + 1)) : 0;
  }
  for (int i = tid; i < 6 * T2; i += NT) acc[i] = 0;
  __syncthreads();
  const int ty = tid / T, tx = tid % T;
  const bool mine = tid < T2 && y0 + ty < h && x0 + tx < w;
  const int me = mine ? slab[(reach + ty) * cols + reach + tx] : 0;
  if (tid < T2) {
    const bool f = me > 0;
    const unsigned ball = __ballot_sync(0xFFFFFFFFu, f);
    int at = 0;
    if (lane == 0 && ball) at = atomicAdd(&s_nfg, __popc(ball));
    at = __shfl_sync(0xFFFFFFFFu, at, 0);
    if (f) fgl[at + __popc(ball & ((1u << lane) - 1u))] = (unsigned short)tid;
  }
  __syncthreads();

  // Every term and partial sum is an integer below 2^24, so the float sums
  // of the plain version are exact in any order: integer sums equal them.
  const int nfg = s_nfg;
  // a work item: `run` consecutive window rows of one pixel, as many items
  // as threads where there are enough rows (fewer atomics than one a row)
  const int run = max(1, (nfg * (reach + 1) + NT - 1) / NT);
  const int runs = (reach + 1 + run - 1) / run;
  for (int it = tid; it < nfg * runs; it += NT) {
    const int q = it / nfg, p = fgl[it - q * nfg];
    const int* centre = slab + (reach + p / T) * cols + reach + p % T;
    const int l = *centre;
    int c = 0, sx = 0, sy = 0, sxx = 0, syy = 0, sxy = 0;
    for (int dyi = q * run; dyi < min((q + 1) * run, reach + 1); ++dyi) {
      const int dy = dyi - reach;
      const int* row = centre + dy * cols;
      int rc = 0, rx = 0, rxx = 0;
#pragma unroll 4
      for (int dx = -reach; dx <= reach; ++dx) {
        if (row[dx] == l) {
          rc += 1;
          rx += dx;
          rxx += dx * dx;
        }
      }
      c += rc;
      sx += rx;
      sy += dy * rc;
      sxx += rxx;
      syy += dy * dy * rc;
      sxy += dy * rx;
    }
    if (c > 0) {
      atomicAdd(&acc[0 * T2 + p], c);
      atomicAdd(&acc[1 * T2 + p], sx);
      atomicAdd(&acc[2 * T2 + p], sy);
      atomicAdd(&acc[3 * T2 + p], sxx);
      atomicAdd(&acc[4 * T2 + p], syy);
      atomicAdd(&acc[5 * T2 + p], sxy);
    }
  }
  __syncthreads();

  // the six sum maps (background: count 1, every moment +0) and the roots' keys
  if (mine) {
    const int hw = h * w, o = (y0 + ty) * w + x0 + tx;
    const bool fg = me > 0;
    const float cnt = fg ? (float)acc[tid] : 1.0f;
    maps[0 * hw + o] = cnt;
    maps[1 * hw + o] = fg ? (float)acc[1 * T2 + tid] : 0.0f;
    maps[2 * hw + o] = fg ? (float)acc[2 * T2 + tid] : 0.0f;
    maps[7 * hw + o] = fg ? (float)acc[3 * T2 + tid] : 0.0f;
    maps[8 * hw + o] = fg ? (float)acc[4 * T2 + tid] : 0.0f;
    maps[9 * hw + o] = fg ? (float)acc[5 * T2 + tid] : 0.0f;
    if (fg && me == o + 1) {  // a root: rank by the reference's score
      const bool in_range = cnt >= prm[5] && cnt <= prm[6] && cnt > 0.0f;
      const float score = in_range ? cnt + 1e6f : cnt;
      root_keys[atomicAdd(&s_nroots, 1)] =
          ((unsigned long long)__float_as_uint(score) << 32) | (0xFFFFFFFFull - (unsigned)o);
    }
  }
  __syncthreads();
  const int nroots = s_nroots;
  if (tid == 0 && nroots > 0) s_base = (int)atomicAdd(key_count, (unsigned)min(nroots, topk));
  __syncthreads();
  for (int a = tid; a < nroots; a += NT) {
    const unsigned long long key = root_keys[a];
    int rank = 0;
    for (int c = 0; c < nroots; ++c) rank += root_keys[c] > key;
    if (rank < topk) keys[s_base + rank] = key;
  }
}

// One launch of the wide stats: blocks [0, n_bb) take a bbox round on their
// 32x32 tiles, the blocks after them the windowed sums and the roots' keys
// of the sums tiles from `sum0` on.
__global__ void __launch_bounds__(kBbThreads, 1)
    wide_stats_kernel(const int* __restrict__ lab, const float* __restrict__ prm, int h, int w,
                      int sweeps, int rsw, const unsigned* __restrict__ state_in,
                      unsigned* __restrict__ state_out, float* __restrict__ maps, int n_bb,
                      int sum0, int topk, unsigned long long* __restrict__ keys,
                      unsigned* __restrict__ key_count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if ((int)blockIdx.x < n_bb)
    wide_bbox_tile(blockIdx.x, lab, h, w, rsw, state_in, state_out, maps, smem_raw);
  else
    wide_sums_tile(blockIdx.x - n_bb + sum0, lab, prm, h, w, sweeps, topk, maps, keys,
                   key_count, smem_raw);
}

// The wide path's top-k: the best roots among the `*key_count` keys (every
// root scores > 0, every key is distinct), by bitonic sorts of at most
// kMergeSort keys in shared memory: each pass sorts the best keys so far
// with the next ones, descending, and keeps the first topk.  Then the
// lowest flat indices that are not roots (score 0) fill the slots left.
__global__ void __launch_bounds__(kMergeSortThreads)
    roots_merge_kernel(const unsigned long long* __restrict__ keys,
                       const unsigned* __restrict__ key_count, const int* __restrict__ lab,
                       int hw, int topk, int* __restrict__ out) {
  constexpr int NT = kMergeSortThreads;
  __shared__ unsigned long long buf[kMergeSort];
  const int n = (int)*key_count;
  const int tid = threadIdx.x, lane = tid & 31;
  int kept = 0;  // buf[0, kept): the best keys so far, descending
  for (int next = 0; next < n || next == 0;) {
    const int take = min(n - next, kMergeSort - kept);
    int p = 2;  // a power of two >= kept + take
    while (p < kept + take) p <<= 1;
    for (int i = kept + tid; i < p; i += NT) buf[i] = i - kept < take ? keys[next + i - kept] : 0;
    __syncthreads();
    for (int size = 2; size <= p; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < p / 2; i += NT) {
          const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1)), hi = lo + stride;
          const unsigned long long a = buf[lo], b = buf[hi];
          if ((a < b) == ((lo & size) == 0)) {  // descending runs where (lo & size) == 0
            buf[lo] = b;
            buf[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    kept = min(kept + take, topk);
    next += take;
    if (n == 0) break;
  }
  for (int t = tid; t < kept; t += NT)
    out[t] = (int)(0xFFFFFFFFu - (unsigned)(buf[t] & 0xFFFFFFFFull));
  if (tid >= 32) return;
  const int need = topk - kept;
  for (int base = 0, filled = 0; filled < need; base += 32) {
    const int i = base + lane;
    const bool other = i < hw && lab[i] != i + 1;
    const unsigned ball = __ballot_sync(0xFFFFFFFFu, other);
    const int slot = filled + __popc(ball & ((1u << lane) - 1u));
    if (other && slot < need) out[kept + slot] = i;
    filled += __popc(ball);
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

// The wide path's scratch: the key count, the compact key list (topk keys
// for each sums tile) and two (h, w) planes for the rounds' labels and words.
struct WideScratch {
  unsigned* count;
  unsigned long long* keys;
  unsigned* plane[2];
  WideScratch(void* base, int h, int w, int topk) {
    unsigned char* p = static_cast<unsigned char*>(base);
    count = reinterpret_cast<unsigned*>(p);
    keys = reinterpret_cast<unsigned long long*>(p + 16);
    plane[0] = reinterpret_cast<unsigned*>(keys + (size_t)tiles_of(h, w, kSumTile) * topk);
    plane[1] = plane[0] + (size_t)h * w;
  }
  static size_t bytes(int h, int w, int topk) {
    return 16 + (size_t)tiles_of(h, w, kSumTile) * topk * 8 + 2 * (size_t)h * w * 4;
  }
};

bool wide_shape(int sweeps, int topk) { return sweeps > kMaxSweeps || topk > kMaxTopk; }

// The wide path after the blur (see the head of this file): the label
// rounds, the bbox rounds (each with its share of the sums tiles), the
// merge.
cudaError_t launch_wide(const float* blurred, const float* prm, int h, int w, int sweeps,
                        int topk, int* lab, float* maps, void* scratch, int* topk_out,
                        cudaStream_t st) {
  WideScratch sc(scratch, h, w, topk);
  const dim3 lab_grid(tiles_x(w, kLabTile), (h + kLabTile - 1) / kLabTile);
  const int n_lab = sweeps == 0 ? 1 : (sweeps + kLabHalo - 1) / kLabHalo;
  const int* src = nullptr;
  for (int r = 0; r < n_lab; ++r) {  // ping-pong with plane 0, the last round into lab
    const int sw = std::min(kLabHalo, sweeps - r * kLabHalo);
    int* dst = (n_lab - 1 - r) % 2 == 0 ? lab : reinterpret_cast<int*>(sc.plane[0]);
    if (r == 0)
      label_round_kernel<float><<<lab_grid, kLabRoundThreads, 0, st>>>(blurred, h, w, sw, dst);
    else
      label_round_kernel<int><<<lab_grid, kLabRoundThreads, 0, st>>>(src, h, w, sw, dst);
    src = dst;
  }
  cudaError_t e = cudaMemsetAsync(sc.count, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  const bool one = 2 * sweeps <= kBbHalo;  // the label argument: one round is exact
  const int n_rounds = one ? 1 : (sweeps + kBbRoundSweeps - 1) / kBbRoundSweeps;
  const int n_bb = tiles_of(h, w, kBbTile), n_sum = tiles_of(h, w, kSumTile);
  // the sums tiles go to the first rounds, as many in each as there are SMs
  // beside the bbox tiles
  int dev = 0, n_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int free_sm = std::max(1, n_sm - n_bb);
  const int sum_rounds = std::min(n_rounds, (n_sum + free_sm - 1) / free_sm);
  static bool ready = false;
  const unsigned* in = nullptr;
  for (int r = 0; r < n_rounds; ++r) {
    const int rsw = one ? sweeps : std::min(kBbRoundSweeps, sweeps - r * kBbRoundSweeps);
    unsigned* out = r + 1 == n_rounds ? nullptr : sc.plane[r % 2];
    const int sum0 = r < sum_rounds ? n_sum * r / sum_rounds : n_sum;
    const int sum1 = r < sum_rounds ? n_sum * (r + 1) / sum_rounds : n_sum;
    e = launch_dynamic(wide_stats_kernel, ready, WideBb::kSmem, dim3(n_bb + sum1 - sum0),
                       kBbThreads, st, lab, prm, h, w, sweeps, rsw, in, out, maps, n_bb, sum0,
                       topk, sc.keys, sc.count);
    if (e != cudaSuccess) return e;
    in = out;
  }
  roots_merge_kernel<<<1, kMergeSortThreads, 0, st>>>(sc.keys, sc.count, lab, h * w, topk,
                                                        topk_out);
  return cudaGetLastError();
}

// ---- The crop path's epilogue (see the head of this file) ----

constexpr int kEpiThreads = 2 * kWideTopk;   // one thread a compaction key
constexpr long long kNoKey = 2147483647LL;   // the compaction's key of an empty entry
constexpr float kPi = 3.14159265358979323846f;
// detect_epilogue_kernel's flags
constexpr int kSplitMerged = 1, kSplitDip = 2, kActiveMarkers = 4;

// torch.minimum and torch.clamp(min=) on the card: a NaN operand comes out
__device__ __forceinline__ float torch_min(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}
__device__ __forceinline__ float torch_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// The crop's value at the pixel nearest (x, y) (torch.round, clamped into
// the crop), inverted for passive markers.
__device__ __forceinline__ float crop_sample(const float* img, int h, int w, bool active, float x,
                                             float y) {
  long long xi = (long long)rintf(x), yi = (long long)rintf(y);
  xi = xi < 0 ? 0 : xi > w - 1 ? w - 1 : xi;
  yi = yi < 0 ? 0 : yi > h - 1 ? h - 1 : yi;
  const float v = img[yi * w + xi];
  return active ? v : 255.0f - v;
}

// prm: [x0, y0, roi_w, roi_h, threshold, min_area, max_area, taps...,
// wh_tol, circ_tol, offset_x, offset_y]; out: xy (k, 2), xy_distorted
// (k, 2), area (k); out_mask: mask (k), then k false flags.
__global__ void __launch_bounds__(kEpiThreads)
    detect_epilogue_kernel(const int* __restrict__ lab, const float* __restrict__ maps,
                           const long long* __restrict__ top, const float* __restrict__ img,
                           int h, int w, int k, const float* __restrict__ prm, int ntaps,
                           int flags, float split_max_factor, float split_min_elongation,
                           float dip_ratio, const float* __restrict__ fx,
                           const float* __restrict__ fy, const float* __restrict__ ccx,
                           const float* __restrict__ ccy, const float* __restrict__ dist,
                           float* __restrict__ out, bool* __restrict__ out_mask) {
  __shared__ long long keys[kEpiThreads];
  __shared__ float ent_x[kEpiThreads], ent_y[kEpiThreads], ent_area[kEpiThreads];
  __shared__ bool ent_valid[kEpiThreads];
  const int t = threadIdx.x;
  const bool split = flags & kSplitMerged;
  const int n = split ? 2 * k : k;
  const float min_a = prm[5], max_a = prm[6];
  const float* tail = prm + 7 + ntaps;  // wh_tol, circ_tol, offset
  if (t < k) {
    const long long hw = (long long)h * w, idx = top[t];
    const float cnt = maps[idx];
    const float area = lab[idx] == (int)(idx + 1) ? cnt : 0.0f;
    const long long comp = area > 0.0f ? idx + 1 : 0;
    const float cntv = torch_clamp_min(cnt, 1e-9f);
    const float mdx = maps[hw + idx] / cntv, mdy = maps[2 * hw + idx] / cntv;
    const float cx = (float)(idx % w) + mdx, cy = (float)(idx / w) + mdy;
    const float vxx = maps[7 * hw + idx] / cntv - mdx * mdx;
    const float vyy = maps[8 * hw + idx] / cntv - mdy * mdy;
    const float vxy = maps[9 * hw + idx] / cntv - mdx * mdy;
    const float bb_w = maps[4 * hw + idx] - maps[3 * hw + idx] + 1.0f;
    const float bb_h = maps[6 * hw + idx] - maps[5 * hw + idx] + 1.0f;
    // the shape filters; (b / 2) ** 2 is b / 2 times itself on the card
    const float ratio = torch_min(bb_w / bb_h, bb_h / bb_w);
    const float rw = bb_w / 2.0f, rh = bb_h / 2.0f;
    const float circ_w = fabsf(1.0f - area / (rw * rw * kPi));
    const float circ_h = fabsf(1.0f - area / (rh * rh * kPi));
    const bool valid = comp > 0 && area >= min_a && area <= max_a &&
                       fabsf(1.0f - ratio) <= tail[0] && circ_w <= tail[1] && circ_h <= tail[1];
    if (!split) {
      keys[t] = valid ? comp : kNoKey;
      ent_x[t] = cx;
      ent_y[t] = cy;
      ent_area[t] = area;
      ent_valid[t] = valid;
    } else {
      // the merged-blob split: two detections off the centroid along the
      // major axis
      const float tr = vxx + vyy, diff = vxx - vyy;
      const float disc = sqrtf(torch_clamp_min(diff * diff + 4.0f * vxy * vxy, 0.0f));
      const float lam_max = 0.5f * (tr + disc);
      const float lam_min = torch_clamp_min(0.5f * (tr - disc), 1e-6f);
      const float half = area * 0.5f;
      bool ok = comp > 0 && area > max_a && area <= split_max_factor * max_a &&
                lam_max / lam_min >= split_min_elongation && half >= min_a && half <= max_a;
      const bool degen = fabsf(vxy) <= 1e-9f;
      const float ux = degen ? (diff >= 0.0f ? 1.0f : 0.0f) : vxy;
      const float uy = degen ? (diff >= 0.0f ? 0.0f : 1.0f) : lam_max - vxx;
      const float norm = sqrtf(torch_clamp_min(ux * ux + uy * uy, 1e-12f));
      const float off = sqrtf(torch_clamp_min(lam_max - lam_min, 0.0f));
      const float ox = ux / norm * off, oy = uy / norm * off;
      if (ok && (flags & kSplitDip)) {  // a split needs a dip along the axis or a thin waist
        const bool active = flags & kActiveMarkers;
        auto at = [&](float x, float y) { return crop_sample(img, h, w, active, x, y); };
        const float i_1 = at(cx + ox, cy + oy), i_2 = at(cx - ox, cy - oy);
        const float lobes = torch_min(i_1, i_2);
        const bool dip_axis = at(cx, cy) <= dip_ratio * lobes;
        const float perp_k = sqrtf(torch_clamp_min(lam_min, 1.0f)) * 0.8f + 0.5f;
        const float px = -(uy / norm) * perp_k, py = (ux / norm) * perp_k;
        auto perp_min = [&](float xc, float yc) {
          return torch_min(at(xc + px, yc + py), at(xc - px, yc - py));
        };
        const float w_c = perp_min(cx, cy);
        const float w_lobe = torch_min(perp_min(cx + ox, cy + oy), perp_min(cx - ox, cy - oy));
        ok = dip_axis || (w_lobe >= 0.5f * lobes && w_c <= dip_ratio * w_lobe);
      }
      const bool p_valid = valid || ok;
      keys[t] = p_valid ? comp * 2 : kNoKey;
      ent_x[t] = ok ? cx + ox : cx;
      ent_y[t] = ok ? cy + oy : cy;
      ent_area[t] = ok ? half : area;
      ent_valid[t] = p_valid;
      keys[k + t] = ok ? comp * 2 + 1 : kNoKey;
      ent_x[k + t] = cx - ox;
      ent_y[k + t] = cy - oy;
      ent_area[k + t] = half;
      ent_valid[k + t] = ok;
    }
  }
  __syncthreads();
  if (t >= n) return;
  const long long key = keys[t];
  int rank = 0;
  for (int j = 0; j < n; ++j) rank += keys[j] < key || (keys[j] == key && j < t);
  if (rank >= k) return;
  // the crop offset, then OpenCV's fixed-point undistortion
  const float xd = ent_x[t] + tail[2], yd = ent_y[t] + tail[3];
  const float k1 = dist[0], k2 = dist[1], p1 = dist[2], p2 = dist[3], k3 = dist[4];
  const float x0 = (xd - *ccx) / *fx, y0 = (yd - *ccy) / *fy;
  float x = x0, y = y0;
  for (int it = 0; it < 8; ++it) {
    const float r2 = x * x + y * y;
    const float radial = 1.0f + r2 * (k1 + r2 * (k2 + r2 * k3));
    const float dx = 2.0f * p1 * x * y + p2 * (r2 + 2.0f * x * x);
    const float dy = p1 * (r2 + 2.0f * y * y) + 2.0f * p2 * x * y;
    const float safe = fabsf(radial) < 1e-12f ? 1e-12f : radial;
    x = (x0 - dx) / safe;
    y = (y0 - dy) / safe;
  }
  const bool m = ent_valid[t];
  out[2 * rank] = m ? x * *fx + *ccx : 0.0f;
  out[2 * rank + 1] = m ? y * *fy + *ccy : 0.0f;
  out[2 * k + 2 * rank] = m ? xd : 0.0f;
  out[2 * k + 2 * rank + 1] = m ? yd : 0.0f;
  out[4 * k + rank] = m ? ent_area[t] : 0.0f;
  out_mask[rank] = m;
  out_mask[k + rank] = false;
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

// Bytes of scratch `pfmpe_detect_stats` needs for these shapes.
int pfmpe_detect_stats_scratch(int h, int w, int sweeps, int topk) {
  if (wide_shape(sweeps, topk)) return (int)WideScratch::bytes(h, w, topk);
  return n_tiles<StatsShape>(h, w) * topk * 8;
}

// blurred: (h, w) scratch; lab: (h, w) int32; maps: (10, h, w); scratch:
// pfmpe_detect_stats_scratch(h, w, sweeps, topk) bytes, 16-byte aligned;
// topk_out: (topk,).  0 <= sweeps <= 32, 1 <= topk <= min(128, h * w): up
// to 12 sweeps and a top-k of up to 64 run the default shapes, the rest the
// wide path.
int pfmpe_detect_stats(const float* img, const float* prm, int ntaps, int h, int w, int active,
                       int sweeps, int topk, float* blurred, int* lab, float* maps, void* scratch,
                       int* topk_out, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || sweeps < 0 || sweeps > kWideSweeps || topk < 1 ||
      topk > kWideTopk || (long long)h * w < topk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  {
    const dim3 block(kBlurX, kBlurY);
    const dim3 grid((w + kBlurX - 1) / kBlurX, (h + kBlurY - 1) / kBlurY);
    threshold_blur_kernel<<<grid, block, 0, st>>>(img, prm, ntaps, h, w, active, blurred);
  }
  if (wide_shape(sweeps, topk))
    return (int)launch_wide(blurred, prm, h, w, sweeps, topk, lab, maps, scratch, topk_out, st);
  unsigned long long* tile_keys = static_cast<unsigned long long*>(scratch);
  const dim3 lab_grid((w + kLabTile - 1) / kLabTile, (h + kLabTile - 1) / kLabTile);
  label_kernel<<<lab_grid, kLabThreads, 0, st>>>(blurred, h, w, sweeps, lab);
  const cudaError_t e = launch_stats<StatsShape>(lab, prm, h, w, sweeps, topk, maps, tile_keys, st);
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<kMaxTopk><<<1, kMergeThreads, 0, st>>>(
      tile_keys, n_tiles<StatsShape>(h, w) * topk, topk, topk_out);
  return (int)cudaGetLastError();
}

// The crop path's epilogue (detect_epilogue_kernel) after pfmpe_detect_stats
// on the same stream: lab (h, w), maps (10, h, w), top (k,) int64, img the
// float crop (h, w), prm 11 + ntaps floats, fx, fy, cx, cy one float each
// and dist 5; out 5k floats, mask 2k bools.  1 <= k <= min(128, h * w).
int pfmpe_detect_epilogue(const int* lab, const float* maps, const long long* top,
                          const float* img, int h, int w, int k, const float* prm, int ntaps,
                          int flags, float split_max_factor, float split_min_elongation,
                          float split_dip_ratio, const float* fx, const float* fy,
                          const float* cx, const float* cy, const float* dist, float* out,
                          bool* mask, void* stream) {
  if (k < 1 || k > kWideTopk || (long long)h * w < k || ntaps < 1 || ntaps > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  detect_epilogue_kernel<<<1, 32 * ((2 * k + 31) / 32), 0, (cudaStream_t)stream>>>(
      lab, maps, top, img, h, w, k, prm, ntaps, flags, split_max_factor, split_min_elongation,
      split_dip_ratio, fx, fy, cx, cy, dist, out, mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
