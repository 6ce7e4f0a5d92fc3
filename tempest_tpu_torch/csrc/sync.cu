// K2: blanking sync of every frame of [F, h, w] screens, integer or sub-pixel.
//
// Replaces stage 4 of the JAX package, tempest_tpu/ops/framesync.py:
// frame_sync (:258) and frame_sync_subpixel (:239) with smooth_profile (:83),
// _circular_prefix (:100), _window_sums (:107), _contrast_score (:142),
// _blank_score (:134), find_blank (:177) and find_blank_subpixel (:191).
// There it is XLA, not Pallas: the JAX package wrote no kernel for it.  Per
// frame and axis it computes
//
//   profile  the row sums (y) or column sums (x) of the screen;
//   smooth   a 5-tap circular Gaussian, taps summed left to right;
//   P        the f32 prefix (leading zero) of the profile padded by w_max
//            on both sides, ext = [tail w_max | profile | head w_max];
//   score    for every half-width w in [w_min, w_max] and centre c in
//            [0, n): window = P[w_max + w + 1 + c] - P[w_max - w + c], and
//            the contrast (mean inside - mean outside)^2 or the reference's
//            fill_beta score of it;
//   argmax   over (w, c) in w-major order, the first maximum on a tie, a
//            NaN winning, as torch.argmax has it;
//   parabola (sub-pixel only) the three scores at c-1, c, c+1 (mod n) re-read
//            from P at the winning width, frac = 0.5 (b0 - b2) / (b0 - 2 b1
//            + b2) unless the denominator is degenerate, clamped to +-0.5.
//
// Every operation is the plain version's (tempest_tpu_torch/ops/framesync.py)
// in its order, one rounding each (the _rn intrinsics keep nvcc from
// contracting a multiply-add into an FMA).  What differs is the ORDER of the
// sums, which here depends only on the frame's own shape, never on how many
// frames the call holds: the plain version's torch.sum and torch.cumsum pick
// their reduction tree by the tensor's shape, which moved the sub-pixel
// centre of the same screen between a batch of 36 frames and one of 144.
//
//   row sum      lane j of a warp adds columns j, j + 32, ... in order, then
//                a butterfly over the 32 lanes;
//   column sum   within a chunk of kChunkRows rows, warp k adds its rows
//                k, k + 8, ... in order; the 8 warps' partials are added in
//                warp order; the chunks' partials in chunk order;
//   total, P     one thread, sequentially, as XLA's CPU reduce_window forms a
//                cumulative sum.
//
// Bound: memory.  The screens are read once (69.1 MB for 36 frames of
// 600x800: 0.021 ms at 3.35 TB/s); the scores are some 7.8 M for such a block
// at about 8 operations each, far below the card's float32 rate.  Two
// launches:
//
//   K2a (profiles_kernel)  one pass over the screens.  A block takes
//        kChunkRows rows of one frame; each warp reads whole rows, 128
//        bytes a request, and keeps its column partials in shared memory, so
//        that nothing but the profiles (F x (h + chunks x w) floats, 2.2 MB
//        at the slice) goes back to device memory;
//   K2b (search_kernel)  one block per frame: half of it takes the row axis,
//        the other half the column axis, each with its own named barrier.  It
//        smooths, forms the prefix, scores and takes the argmax in shared
//        memory, and never writes the [F, W, n] score matrix that the plain
//        version materialises.  The two halves' scores meet in the block, so
//        the frame's score y + x is written by the kernel itself.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kProfileThreads = 256;  // K2a: 8 warps
constexpr int kProfileWarps = kProfileThreads / 32;
constexpr int kChunkRows = 32;        // rows of one K2a block
constexpr int kHalf = 512;            // K2b: threads per axis
constexpr int kHalfWarps = kHalf / 32;
constexpr int kSearchThreads = 2 * kHalf;
constexpr int kBlockSmem = 227 * 1024;
// What K2b's dynamic shared memory may take beside its static reduction
// slots (a few hundred bytes).
constexpr int kSearchSmem = kBlockSmem - 1024;

// ---------------------------------------------------------------- K2a
__global__ void __launch_bounds__(kProfileThreads)
profiles_kernel(const float* __restrict__ frames, float* __restrict__ row_sums,
                float* __restrict__ col_parts, int h, int w, int chunks) {
  extern __shared__ float col_warp[];  // [kProfileWarps][w]
  const int f = blockIdx.y;
  const int chunk = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = chunk * kChunkRows;
  const int rows = min(kChunkRows, h - r0);
  float* const mine = col_warp + warp * w;
  for (int c = lane; c < w; c += 32) mine[c] = 0.0f;  // each lane owns its columns
  const float* const base = frames + (static_cast<long long>(f) * h + r0) * w;
  for (int r = warp; r < rows; r += kProfileWarps) {
    const float* const row = base + static_cast<long long>(r) * w;
    float acc = 0.0f;
    for (int c = lane; c < w; c += 32) {
      const float v = row[c];
      acc = __fadd_rn(acc, v);
      mine[c] = __fadd_rn(mine[c], v);
    }
    // Butterfly: every lane ends with the same bits (each step adds the
    // same two values, in either order).
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) row_sums[static_cast<long long>(f) * h + r0 + r] = acc;
  }
  __syncthreads();
  float* const out = col_parts + (static_cast<long long>(f) * chunks + chunk) * w;
  for (int c = threadIdx.x; c < w; c += kProfileThreads) {
    float s = col_warp[c];
    for (int k = 1; k < kProfileWarps; ++k) s = __fadd_rn(s, col_warp[k * w + c]);
    out[c] = s;
  }
}

// ---------------------------------------------------------------- K2b
struct Axis {
  int n;      // profile length
  int w_min;  // smallest half-width
  int w_max;  // largest half-width (the prefix's padding)
};

struct Search {
  const float* row_sums;   // [F, h]
  const float* col_parts;  // [F, chunks, w]
  int h, w, chunks;
  Axis y, x;
  float g[5];              // the Gaussian taps, float32
  int method;              // 0 contrast, 1 reference
  int subpixel;
  void* s_y;               // int32 [F], or float32 [F] when subpixel
  void* s_x;
  float* score;            // [F]
};

// Floats of shared memory one axis takes: raw and smoothed profile, prefix.
__host__ __device__ inline int axis_floats(const Axis& a) {
  return 3 * a.n + 2 * a.w_max + 1;
}

__device__ __forceinline__ void half_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kHalf) : "memory");
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// (va, ia) ranks before (vb, ib): a NaN first, then the larger value, then
// the smaller index.  A strict total order on distinct indices, so the
// reduction's order does not matter.
__device__ __forceinline__ bool ranks_before(float va, int ia, float vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

__device__ __forceinline__ float score_of(float win, float total, float wf, float nf,
                                          int method) {
  if (method == 0) {
    const float size = __fadd_rn(__fmul_rn(2.0f, wf), 1.0f);
    const float d = __fsub_rn(__fdiv_rn(win, size),
                              __fdiv_rn(__fsub_rn(total, win), __fsub_rn(nf, size)));
    return __fmul_rn(d, d);
  }
  const float beta = __fadd_rn(
      __fdiv_rn(__fsub_rn(total, __fmul_rn(2.0f, win)), __fmul_rn(2.0f, __fsub_rn(nf, wf))),
      __fdiv_rn(win, wf));
  return __fmul_rn(beta, beta);
}

struct AxisResult {
  float s;      // centre, with the fraction when subpixel
  int c;        // integer centre
  float score;
};

// One axis of frame f, run by the kHalf threads of one half (t in [0, kHalf)),
// synchronised among themselves by named barrier `bar`.
__device__ void search_axis(const Search& p, const Axis a, int f, bool columns, int t, int bar,
                            float* prof, float* red_v, int* red_i, AxisResult* res,
                            float* total_out) {
  const int n = a.n;
  const int wm = a.w_max;
  float* const raw = prof;
  float* const sm = prof + n;
  float* const P = prof + 2 * n;
  // Profile: the row sums as K2a left them, or the column chunks in order.
  for (int i = t; i < n; i += kHalf) {
    if (columns) {
      const float* cp = p.col_parts + static_cast<long long>(f) * p.chunks * p.w + i;
      float s = cp[0];
      for (int k = 1; k < p.chunks; ++k) s = __fadd_rn(s, cp[static_cast<long long>(k) * p.w]);
      raw[i] = s;
    } else {
      raw[i] = p.row_sums[static_cast<long long>(f) * p.h + i];
    }
  }
  half_sync(bar);
  // Circular Gaussian, taps at i-2 .. i+2 summed left to right.
  for (int i = t; i < n; i += kHalf) {
    float s = __fmul_rn(p.g[0], raw[wrap(i - 2, n)]);
#pragma unroll
    for (int k = 1; k < 5; ++k) s = __fadd_rn(s, __fmul_rn(p.g[k], raw[wrap(i + k - 2, n)]));
    sm[i] = s;
  }
  half_sync(bar);
  // Total and prefix, sequentially.
  if (t == 0) {
    float total = 0.0f;
    for (int i = 0; i < n; ++i) total = __fadd_rn(total, sm[i]);
    *total_out = total;
    float acc = 0.0f;
    P[0] = 0.0f;
    int k = 1;
    for (int i = n - wm; i < n; ++i, ++k) P[k] = acc = __fadd_rn(acc, sm[i]);
    for (int i = 0; i < n; ++i, ++k) P[k] = acc = __fadd_rn(acc, sm[i]);
    for (int i = 0; i < wm; ++i, ++k) P[k] = acc = __fadd_rn(acc, sm[i]);
  }
  half_sync(bar);
  const float total = *total_out;
  const float nf = static_cast<float>(n);
  // Every (w, c), flat index (w - w_min) * n + c, strided over the half.
  const int count = (wm - a.w_min + 1) * n;
  float best_v = -INFINITY;
  int best_i = INT_MAX;
  int row = t / n;
  int c = t - row * n;
  const int step_row = kHalf / n;
  const int step_c = kHalf - step_row * n;
  for (int idx = t; idx < count; idx += kHalf) {
    const int wi = a.w_min + row;
    const float win = __fsub_rn(P[wm + wi + 1 + c], P[wm - wi + c]);
    const float v = score_of(win, total, static_cast<float>(wi), nf, p.method);
    if (ranks_before(v, idx, best_v, best_i)) {
      best_v = v;
      best_i = idx;
    }
    row += step_row;
    c += step_c;
    if (c >= n) {
      c -= n;
      ++row;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (ranks_before(ov, oi, best_v, best_i)) {
      best_v = ov;
      best_i = oi;
    }
  }
  if ((t & 31) == 0) {
    red_v[t >> 5] = best_v;
    red_i[t >> 5] = best_i;
  }
  half_sync(bar);
  if (t != 0) return;
  for (int k = 1; k < kHalfWarps; ++k) {
    if (ranks_before(red_v[k], red_i[k], best_v, best_i)) {
      best_v = red_v[k];
      best_i = red_i[k];
    }
  }
  const int brow = best_i / n;
  const int bc = best_i - brow * n;
  res->c = bc;
  res->s = static_cast<float>(bc);
  res->score = best_v;
  if (!p.subpixel) return;
  const float wf = static_cast<float>(a.w_min + brow);
  const int hi = brow + a.w_min + wm + 1;
  const int lo = wm - a.w_min - brow;
  float b[3];
  for (int k = 0; k < 3; ++k) {
    const int ci = wrap(bc + k - 1, n);
    b[k] = score_of(__fsub_rn(P[ci + hi], P[ci + lo]), total, wf, nf, p.method);
  }
  const float denom = __fadd_rn(__fsub_rn(b[0], __fmul_rn(2.0f, b[1])), b[2]);
  float frac = 0.0f;
  if (fabsf(denom) > __fmul_rn(1e-12f, __fadd_rn(fabsf(b[1]), 1e-30f))) {
    frac = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(b[0], b[2])), denom);
  }
  // Clamp to +-0.5, a NaN staying a NaN as under torch.clamp.
  if (frac < -0.5f) frac = -0.5f;
  if (frac > 0.5f) frac = 0.5f;
  res->s = __fadd_rn(static_cast<float>(bc), frac);
  res->score = b[1];
}

__global__ void __launch_bounds__(kSearchThreads) search_kernel(Search p) {
  extern __shared__ float smem[];
  __shared__ float red_v[2][kHalfWarps];
  __shared__ int red_i[2][kHalfWarps];
  __shared__ float totals[2];
  __shared__ AxisResult res[2];
  const int f = blockIdx.x;
  const int half = threadIdx.x / kHalf;
  const int t = threadIdx.x - half * kHalf;
  float* const prof = half ? smem + axis_floats(p.y) : smem;
  search_axis(p, half ? p.x : p.y, f, half == 1, t, 1 + half, prof, red_v[half], red_i[half],
              &res[half], &totals[half]);
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (p.subpixel) {
    static_cast<float*>(p.s_y)[f] = res[0].s;
    static_cast<float*>(p.s_x)[f] = res[1].s;
  } else {
    static_cast<int*>(p.s_y)[f] = res[0].c;
    static_cast<int*>(p.s_x)[f] = res[1].c;
  }
  p.score[f] = __fadd_rn(res[0].score, res[1].score);
}

// Raise a kernel's dynamic shared-memory cap to `cap`, the most a launch may
// ask for beside its static shared memory, once per device (the cap is state
// of the function on the device); a launch of 48 KB or less needs no raise.
int raise_smem_cap(const void* kernel, int bytes, int cap) {
  static std::mutex lock;
  static std::vector<std::pair<int, const void*>> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes <= 48 * 1024) return 0;
  const std::lock_guard<std::mutex> guard(lock);
  for (const auto& d : done) {
    if (d.first == device && d.second == kernel) return 0;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  done.emplace_back(device, kernel);
  return 0;
}

}  // namespace

// Launches K2a and K2b on `stream`; returns the cudaError_t of the launches
// (0 = ok).  `frames` is [n_frames, h, w] float32; `row_sums` [n_frames, h]
// and `col_parts` [n_frames, ceil(h / 32), w] are scratch the caller
// allocates; `s_y`, `s_x` are int32 [n_frames] (float32 when `subpixel`),
// `score` float32 [n_frames].  `g0..g4` are the Gaussian taps; `method` 0 is
// the contrast score, 1 the reference's.  Needs 1 <= w_min <= w_max <= n / 4
// on each axis, or w_min = 0 with the division that gives.
extern "C" int tt_blanking_sync(const float* frames, float* row_sums, float* col_parts,
                                int n_frames, int h, int w, int y_wmin, int y_wmax, int x_wmin,
                                int x_wmax, float g0, float g1, float g2, float g3, float g4,
                                int method, int subpixel, void* s_y, void* s_x, float* score,
                                void* stream) {
  if (n_frames < 1 || n_frames > 65535 || h < 4 || w < 4 || y_wmin < 0 || x_wmin < 0 ||
      y_wmin > y_wmax || x_wmin > x_wmax || 4 * y_wmax > h || 4 * x_wmax > w ||
      (method != 0 && method != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (h + kChunkRows - 1) / kChunkRows;
  const int smem_a = kProfileWarps * w * static_cast<int>(sizeof(float));
  Search p;
  p.row_sums = row_sums;
  p.col_parts = col_parts;
  p.h = h;
  p.w = w;
  p.chunks = chunks;
  p.y = Axis{h, y_wmin, y_wmax};
  p.x = Axis{w, x_wmin, x_wmax};
  p.g[0] = g0;
  p.g[1] = g1;
  p.g[2] = g2;
  p.g[3] = g3;
  p.g[4] = g4;
  p.method = method;
  p.subpixel = subpixel;
  p.s_y = s_y;
  p.s_x = s_x;
  p.score = score;
  const int smem_b = (axis_floats(p.y) + axis_floats(p.x)) * static_cast<int>(sizeof(float));
  if (smem_a > kBlockSmem || smem_b > kSearchSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = raise_smem_cap(reinterpret_cast<const void*>(profiles_kernel), smem_a, kBlockSmem);
  if (rc != 0) return rc;
  rc = raise_smem_cap(reinterpret_cast<const void*>(search_kernel), smem_b, kSearchSmem);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  profiles_kernel<<<dim3(chunks, n_frames), kProfileThreads, smem_a, s>>>(frames, row_sums,
                                                                          col_parts, h, w, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  search_kernel<<<n_frames, kSearchThreads, smem_b, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
