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
// frames the call holds or how the search is split: the plain version's
// torch.sum and torch.cumsum pick their reduction tree by the tensor's shape,
// which moved the sub-pixel centre of the same screen between a batch of 36
// frames and one of 144.
//
//   row sum      lane j of a warp adds columns j, j + 32, ... in order, then
//                a butterfly over the 32 lanes;
//   column sum   within a chunk of kChunkRows rows, warp k adds its rows
//                k, k + 8, ... in order; the 8 warps' partials are added in
//                warp order; the chunks' partials in chunk order;
//   total, P     one thread each, sequentially, as XLA's CPU reduce_window
//                forms a cumulative sum.
//
// Bound.  K2a by memory: the screens are read once (69.1 MB for 36 frames of
// 600x800: 0.021 ms at 3.35 TB/s).  K2b by instruction issue: some 7.8 M
// window scores for such a block against 2.2 MB of profiles; a window needs
// at least 13 instructions (two loads, two differences, two quotients from
// reciprocals hoisted per half-width at three each, the difference of the
// means, its square, the argmax's comparison: sync_kernel.SCORE_INSTRUCTIONS),
// 0.0030 ms at the card's issue rate.  As compiled the loop issues some 50 a
// window (each IEEE division's fast path 12, the per-width terms recomputed,
// the index and the loop).  Two launches:
//
//   K2a (profiles_kernel)  one pass over the screens.  A block takes
//        kChunkRows rows of one frame; each warp reads whole rows, 128
//        bytes a request, and keeps its column partials in shared memory, so
//        that nothing but the profiles (F x (h + chunks x w) floats, 2.2 MB
//        at the slice) goes back to device memory;
//   K2b (search_kernel)  a thread-block cluster a frame, 2 to 8 blocks (the
//        wrapper takes 6 while the card holds the F clusters of 6 at once,
//        else 3: 36 frames fill the 132 SMs in one wave, 144 do not
//        over-split).  Every block sums a slice of the columns' chunks into
//        the column leader's shared memory (distributed shared memory, after
//        a split cluster barrier: a block's shared memory is written only
//        once every block of the cluster has started); block 0 leads the row axis, block 1 the column
//        axis: each smooths its profile and forms, on two threads at once,
//        the total and the prefix, each a register chain fed by 16-byte
//        loads issued ahead.  After a cluster barrier every block copies the
//        prefixes and totals it lacks and scores an equal, contiguous slice
//        of all the frame's windows, rows' first (a slice may hold windows
//        of both axes); each block's best window of each axis goes to that
//        axis's leader, and they meet there in the argmax's strict total
//        order (NaN, value, index), so the winner does not depend on the
//        split.  The leaders re-read the parabola's three scores, the column
//        leader hands its result to block 0, and block 0 writes s_y, s_x,
//        the score y + x and, when asked, the [F, 2] pair.  Nothing is
//        summed across blocks: the same bits as one block a frame.  The
//        score loop is most of its time; the profiles, the leaders' serial
//        chains, the copies and the barriers are the rest (some 11 us a
//        cluster at 600x800, 3.4 of them the 1,200-element prefix chain).
//        With kStamps the leaders take clock64() stamps at the phases' ends
//        (tt_blanking_sync_timed, for exp/k2_clocks.py); the main path's
//        instantiation has none.  Blocks with
//        no cluster, each forming both prefixes itself and the frame's last
//        block (a ticket) taking the argmax, measured slower: every block
//        then reads the whole column profile's chunks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kProfileThreads = 256;  // K2a: 8 warps
constexpr int kProfileWarps = kProfileThreads / 32;
constexpr int kChunkRows = 32;        // rows of one K2a block
constexpr int kSearchThreads = 512;   // K2b: a block
constexpr int kSearchWarps = kSearchThreads / 32;
constexpr int kMaxCluster = 8;        // blocks of a frame's cluster, both axes
constexpr int kChainQuads = 4;       // 16-byte loads issued ahead of a sum's chain
constexpr int kLoadsAhead = 16;      // column chunks loaded ahead of their adds
constexpr int kBlockSmem = 227 * 1024;
// What K2b's dynamic shared memory may take beside its static slots.
constexpr int kSearchSmem = kBlockSmem - 1024;
constexpr int kStampCount = 10;       // clock64() stamps a leader takes, 2 globaltimer

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
  int cluster;             // blocks of a frame's cluster, 2 to kMaxCluster
  float g[5];              // the Gaussian taps, float32
  int method;              // 0 contrast, 1 reference
  int subpixel;
  void* s_y;               // int32 [F], or float32 [F] when subpixel
  void* s_x;
  float* score;            // [F]
  void* pairs;             // [F, 2] (s_y, s_x) of s_y's type, or null
  long long* clocks;       // [F, 2, kStampCount] the leaders' stamps, or null
};

// K2b's shared memory, in floats, each part from a 16-byte boundary: both
// axes' prefixes, each 3 floats in (so that P + 1, where the prefix chain's
// 16-byte stores start, is aligned); then the axis leader's work: ext (the
// smoothed profile padded as P sums it), the smoothed profile and the raw
// one, as long as the longer axis needs.
constexpr int kPrefixAt = 3;
__host__ __device__ inline int quad_up(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int prefix_floats(const Axis& a) { return a.n + 2 * a.w_max + 1; }

struct Layout {
  int p[2];  // P of the row axis, of the column axis
  int ext, sm, raw, total;
};

__host__ __device__ inline Layout layout(const Axis& y, const Axis& x) {
  Layout l;
  l.p[0] = kPrefixAt;
  l.p[1] = quad_up(l.p[0] + prefix_floats(y)) + kPrefixAt;
  l.ext = quad_up(l.p[1] + prefix_floats(x));
  const int n = y.n > x.n ? y.n : x.n;
  const int ext = y.n + 2 * y.w_max > x.n + 2 * x.w_max ? y.n + 2 * y.w_max : x.n + 2 * x.w_max;
  l.sm = l.ext + quad_up(ext);
  l.raw = l.sm + quad_up(n);
  l.total = l.raw + n;
  return l;
}

// Start of slice `part` of `parts` over [0, count): contiguous, in order.
__device__ __forceinline__ int slice_begin(int count, int parts, int part) {
  return static_cast<int>(static_cast<long long>(count) * part / parts);
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

// Four more terms of a chain: acc + v.x, + v.y, + v.z, + v.w, left to right,
// the four partial sums written as one 16-byte store when STORE.
template <bool STORE>
__device__ __forceinline__ float add4(float4 v, float acc, float4* dst) {
  float4 o;
  o.x = acc = __fadd_rn(acc, v.x);
  o.y = acc = __fadd_rn(acc, v.y);
  o.z = acc = __fadd_rn(acc, v.z);
  o.w = acc = __fadd_rn(acc, v.w);
  if constexpr (STORE) *dst = o;
  return acc;
}

// acc + src[0] + src[1] + ... + src[len - 1], left to right, each partial
// written to dst[i] when STORE; src and dst 16-byte aligned.  The chain waits
// on one add's latency an element: the values come in 16-byte loads, the next
// kChainQuads of them issued before the adds of the current ones (two sets
// in turn, no copy between them), and the partial sums leave in 16-byte
// stores.
template <bool STORE>
__device__ float chain(const float* __restrict__ src, int len, float acc,
                       float* __restrict__ dst) {
  constexpr int B = kChainQuads;
  const float4* const s4 = reinterpret_cast<const float4*>(src);
  float4* const d4 = reinterpret_cast<float4*>(dst);
  const auto at = [d4](int k) { return STORE ? d4 + k : nullptr; };
  const int quads = len >> 2;
  int q = 0;
  if (quads >= 2 * B) {
    float4 a[B], b[B];
#pragma unroll
    for (int u = 0; u < B; ++u) a[u] = s4[u];
    for (; q + 2 * B <= quads; q += 2 * B) {
#pragma unroll
      for (int u = 0; u < B; ++u) b[u] = s4[q + B + u];
#pragma unroll
      for (int u = 0; u < B; ++u) acc = add4<STORE>(a[u], acc, at(q + u));
      const int next = min(q + 2 * B, quads - B);  // past the end: reloads, unused
#pragma unroll
      for (int u = 0; u < B; ++u) a[u] = s4[next + u];
#pragma unroll
      for (int u = 0; u < B; ++u) acc = add4<STORE>(b[u], acc, at(q + B + u));
    }
  }
  for (; q < quads; ++q) acc = add4<STORE>(s4[q], acc, at(q));
  for (int i = 4 * quads; i < len; ++i) {
    acc = __fadd_rn(acc, src[i]);
    if constexpr (STORE) dst[i] = acc;
  }
  return acc;
}

struct AxisResult {
  float s;      // centre, with the fraction when subpixel
  int c;        // integer centre
  float score;
};

template <bool ON>
__device__ __forceinline__ void stamp(long long* at, int k) {
  if constexpr (ON) {
    if (at) at[k] = clock64();
  }
}

// The global nanosecond timer, the same on every SM, into at[k].
template <bool ON>
__device__ __forceinline__ void stamp_ns(long long* at, int k) {
  if constexpr (ON) {
    if (at) {
      long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      at[k] = ns;
    }
  }
}

// The two halves of a cluster barrier: every thread arrives once, then waits
// once.  The arrival orders nothing (relaxed); the wait returns once every
// thread of every block of the cluster has arrived, so each block has
// started and its shared memory may be written.  Not .aligned: a thread may
// wait inside a loop its warp's other threads have left.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// The best window of flat indices [lo, hi) of one axis ((w - w_min) * n + c)
// over the block, in thread 0's best_v, best_i: (-inf, INT_MAX) for an empty
// range.  Every thread of the block calls it.
__device__ __forceinline__ void best_window(const float* P, float total, const Axis a,
                                            int method, int lo, int hi, float* red_v,
                                            int* red_i, float& best_v, int& best_i) {
  const int t = threadIdx.x;
  const int n = a.n;
  const int wm = a.w_max;
  const float nf = static_cast<float>(n);
  int idx = lo + t;
  best_v = -INFINITY;
  best_i = INT_MAX;
  int row = idx / n;
  int c = idx - row * n;
  const int step_row = kSearchThreads / n;
  const int step_c = kSearchThreads - step_row * n;
  for (bool first = true; idx < hi; idx += kSearchThreads, first = false) {
    const int wi = a.w_min + row;
    const float win = __fsub_rn(P[wm + wi + 1 + c], P[wm - wi + c]);
    const float v = score_of(win, total, static_cast<float>(wi), nf, method);
    // A thread's indices rise, so a later one wins only by ranking before:
    // a NaN over a number, or a larger number.
    if (first || (!(v <= best_v) && !isnan(best_v))) {
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
  __syncthreads();
  if (t == 0) {
    for (int k = 1; k < kSearchWarps; ++k) {
      if (ranks_before(red_v[k], red_i[k], best_v, best_i)) {
        best_v = red_v[k];
        best_i = red_i[k];
      }
    }
  }
  __syncthreads();  // the slots are free for the next call
}

template <bool kStamps>
__global__ void __launch_bounds__(kSearchThreads, 2) search_kernel(Search p) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // the start barrier, waited at before the first remote write
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[kSearchWarps];
  __shared__ int red_i[kSearchWarps];
  __shared__ float part_v[2][kMaxCluster];  // a leader's: its axis's best in each block
  __shared__ int part_i[2][kMaxCluster];
  __shared__ float totals[2];
  __shared__ AxisResult x_res;              // block 0's: the column axis's result

  const int t = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = p.cluster;
  const int f = blockIdx.x / size;
  const Layout L = layout(p.y, p.x);
  // Block 0 leads the row axis, block 1 the column axis.
  const bool lead = rank < 2;
  const Axis own = rank == 1 ? p.x : p.y;
  long long* const clk = (kStamps && p.clocks && lead && t == 0)
                             ? p.clocks + (static_cast<long long>(f) * 2 + rank) * kStampCount
                             : nullptr;
  stamp_ns<kStamps>(clk, 8);
  stamp<kStamps>(clk, 0);

  // The profiles, by every block of the cluster: a slice of the columns each,
  // summed over the chunks in order, kLoadsAhead chunks' loads issued before
  // their adds, into the column leader's raw profile; the row sums as K2a
  // left them into the row leader's.
  {
    float* const raw_x = cluster.map_shared_rank(smem + L.raw, 1);
    const float* const parts = p.col_parts + static_cast<long long>(f) * p.chunks * p.w;
    bool started = false;  // this thread has waited at the start barrier
    for (int c = slice_begin(p.w, size, rank) + t; c < slice_begin(p.w, size, rank + 1);
         c += kSearchThreads) {
      const float* cp = parts + c;
      float s = cp[0];
      for (int k = 1; k < p.chunks; k += kLoadsAhead) {
        float v[kLoadsAhead];
#pragma unroll
        for (int u = 0; u < kLoadsAhead; ++u) {
          v[u] = k + u < p.chunks ? cp[static_cast<long long>(k + u) * p.w] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kLoadsAhead; ++u) {
          if (k + u < p.chunks) s = __fadd_rn(s, v[u]);
        }
      }
      if (!started) {
        cluster_wait();  // every block of the cluster has started
        started = true;
      }
      raw_x[c] = s;
    }
    if (!started) cluster_wait();
    if (rank == 0) {
      for (int i = t; i < p.h; i += kSearchThreads) {
        smem[L.raw + i] = p.row_sums[static_cast<long long>(f) * p.h + i];
      }
    }
  }
  cluster.sync();  // A0: each leader holds its raw profile
  stamp<kStamps>(clk, 1);

  if (lead) {
    const int n = own.n;
    const int wm = own.w_max;
    float* const raw = smem + L.raw;
    float* const ext = smem + L.ext;
    float* const sm = smem + L.sm;
    float* const P = smem + L.p[rank];
    // Circular Gaussian, taps at i-2 .. i+2 summed left to right; written
    // to sm and to its places in ext = [tail w_max | profile | head w_max].
    for (int i = t; i < n; i += kSearchThreads) {
      float s = __fmul_rn(p.g[0], raw[wrap(i - 2, n)]);
#pragma unroll
      for (int k = 1; k < 5; ++k) s = __fadd_rn(s, __fmul_rn(p.g[k], raw[wrap(i + k - 2, n)]));
      sm[i] = s;
      ext[wm + i] = s;
      if (i < wm) ext[wm + n + i] = s;
      if (i >= n - wm) ext[i - (n - wm)] = s;
    }
    __syncthreads();
    stamp<kStamps>(clk, 2);
    // The total and the prefix, each sequentially, on two warps at once.
    if (t == 0) {
      P[0] = 0.0f;
      chain<true>(ext, n + 2 * wm, 0.0f, P + 1);
    } else if (t == 32) {
      totals[rank] = chain<false>(sm, n, 0.0f, nullptr);
    }
    __syncthreads();
    stamp<kStamps>(clk, 3);
  }
  cluster.sync();  // A: each axis's prefix and total are in its leader
  // Each block copies the prefixes and totals it does not hold itself.
  for (int axis = 0; axis < 2; ++axis) {
    if (axis == rank) continue;
    const int count = prefix_floats(axis ? p.x : p.y);
    const float* const src = cluster.map_shared_rank(smem + L.p[axis], axis);
    for (int i = t; i < count; i += kSearchThreads) smem[L.p[axis] + i] = src[i];
    if (t == 0) totals[axis] = *cluster.map_shared_rank(&totals[axis], axis);
  }
  __syncthreads();
  stamp<kStamps>(clk, 4);

  // This block's slice of all the frame's windows, the row axis's first:
  // an equal share of the score loop, whichever axis it falls on.  Its best
  // on each axis goes to that axis's leader, (-inf, INT_MAX) where the slice
  // holds none of the axis.
  const int wy = (p.y.w_max - p.y.w_min + 1) * p.y.n;
  const int wx = (p.x.w_max - p.x.w_min + 1) * p.x.n;
  const int lo = slice_begin(wy + wx, size, rank);
  const int hi = slice_begin(wy + wx, size, rank + 1);
  for (int axis = 0; axis < 2; ++axis) {
    const int base = axis ? wy : 0;
    const int end = axis ? wy + wx : wy;
    float best_v;
    int best_i;
    best_window(smem + L.p[axis], totals[axis], axis ? p.x : p.y, p.method,
                max(lo, base) - base, min(hi, end) - base, red_v, red_i, best_v, best_i);
    if (t == 0) {
      *cluster.map_shared_rank(&part_v[axis][rank], axis) = best_v;
      *cluster.map_shared_rank(&part_i[axis][rank], axis) = best_i;
    }
  }
  stamp<kStamps>(clk, 5);
  cluster.sync();  // B: every block's best is in the axes' leaders

  AxisResult res{0.0f, 0, 0.0f};
  if (lead && t == 0) {
    const int n = own.n;
    const float nf = static_cast<float>(n);
    const float* const P = smem + L.p[rank];
    float best_v = part_v[rank][0];
    int best_i = part_i[rank][0];
    for (int k = 1; k < size; ++k) {
      if (ranks_before(part_v[rank][k], part_i[rank][k], best_v, best_i)) {
        best_v = part_v[rank][k];
        best_i = part_i[rank][k];
      }
    }
    const int brow = best_i / n;
    const int bc = best_i - brow * n;
    res = AxisResult{static_cast<float>(bc), bc, best_v};
    if (p.subpixel) {
      const float wf = static_cast<float>(own.w_min + brow);
      const int up = brow + own.w_min + own.w_max + 1;
      const int down = own.w_max - own.w_min - brow;
      float b[3];
      for (int k = 0; k < 3; ++k) {
        const int ci = wrap(bc + k - 1, n);
        b[k] = score_of(__fsub_rn(P[ci + up], P[ci + down]), totals[rank], wf, nf, p.method);
      }
      const float denom = __fadd_rn(__fsub_rn(b[0], __fmul_rn(2.0f, b[1])), b[2]);
      float frac = 0.0f;
      if (fabsf(denom) > __fmul_rn(1e-12f, __fadd_rn(fabsf(b[1]), 1e-30f))) {
        frac = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(b[0], b[2])), denom);
      }
      // Clamp to +-0.5, a NaN staying a NaN as under torch.clamp.
      if (frac < -0.5f) frac = -0.5f;
      if (frac > 0.5f) frac = 0.5f;
      res.s = __fadd_rn(static_cast<float>(bc), frac);
      res.score = b[1];
    }
    if (rank == 1) *cluster.map_shared_rank(&x_res, 0) = res;
  }
  stamp<kStamps>(clk, 6);
  cluster.sync();  // C: the column axis's result is in block 0
  stamp<kStamps>(clk, 7);
  stamp_ns<kStamps>(clk, 9);
  if (rank != 0 || t != 0) return;
  const AxisResult xr = x_res;
  if (p.subpixel) {
    static_cast<float*>(p.s_y)[f] = res.s;
    static_cast<float*>(p.s_x)[f] = xr.s;
    if (p.pairs) static_cast<float2*>(p.pairs)[f] = make_float2(res.s, xr.s);
  } else {
    static_cast<int*>(p.s_y)[f] = res.c;
    static_cast<int*>(p.s_x)[f] = xr.c;
    if (p.pairs) static_cast<int2*>(p.pairs)[f] = make_int2(res.c, xr.c);
  }
  p.score[f] = __fadd_rn(res.score, xr.score);
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

// How many clusters of `size` K2b blocks, each with `smem` bytes of dynamic
// shared memory, the current device holds at once, into *out; returns the
// cudaError_t (0 = ok).  The wrapper sizes a frame's cluster by it.
extern "C" int tt_sync_max_clusters(int size, int smem, int* out) {
  if (size < 1 || size > kMaxCluster || smem > kSearchSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = raise_smem_cap(reinterpret_cast<const void*>(search_kernel<false>), smem,
                          kSearchSmem);
  if (rc != 0) return rc;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(size * kMaxCluster);
  config.blockDim = dim3(kSearchThreads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, search_kernel<false>, &config));
}

// The labels of the clock64() stamps a leader takes (tt_blanking_sync_timed):
// stamp k is taken when the phase that label k names has ended.
extern "C" const char* tt_sync_clock_labels() {
  return "start,profiles (every block) + barrier A0,smoothing,total+prefix,"
         "barrier A + copies of P,score loop (the leader's slice),"
         "barrier B + argmax across the cluster + parabola,barrier C";
}

// Launches K2a and K2b on `stream`; returns the cudaError_t of the launches
// (0 = ok).  `frames` is [n_frames, h, w] float32; `row_sums` [n_frames, h]
// and `col_parts` [n_frames, ceil(h / 32), w] are scratch the caller
// allocates; `s_y`, `s_x` are int32 [n_frames] (float32 when `subpixel`),
// `score` float32 [n_frames], and `pairs`, when not null, [n_frames, 2] of
// the centres' type, (s_y, s_x) a row.  `g0..g4` are the Gaussian taps;
// `method` 0 is the contrast score, 1 the reference's; `cluster` (2 to 8) the
// blocks of a frame's cluster.  Needs 1 <= w_min <= w_max <= n / 4 on each axis, or
// w_min = 0 with the division that gives.  `clocks`, when not null, is int64
// [n_frames, 2, 10] for the leaders' stamps: 8 of clock64(), then the global
// timer's nanoseconds at the block's start and end.
extern "C" int tt_blanking_sync_timed(const float* frames, float* row_sums, float* col_parts,
                                      int n_frames, int h, int w, int y_wmin, int y_wmax,
                                      int x_wmin, int x_wmax, float g0, float g1, float g2,
                                      float g3, float g4, int method, int subpixel,
                                      int cluster, void* s_y, void* s_x, float* score,
                                      void* pairs, void* stream, long long* clocks) {
  if (n_frames < 1 || n_frames > 65535 || h < 4 || w < 4 || y_wmin < 0 || x_wmin < 0 ||
      y_wmin > y_wmax || x_wmin > x_wmax || 4 * y_wmax > h || 4 * x_wmax > w ||
      (method != 0 && method != 1) || cluster < 2 || cluster > kMaxCluster) {
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
  p.cluster = cluster;
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
  p.pairs = pairs;
  p.clocks = clocks;
  const int smem_b = layout(p.y, p.x).total * static_cast<int>(sizeof(float));
  if (smem_a > kBlockSmem || smem_b > kSearchSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = raise_smem_cap(reinterpret_cast<const void*>(profiles_kernel), smem_a, kBlockSmem);
  if (rc != 0) return rc;
  void (*const search)(Search) = clocks ? &search_kernel<true> : &search_kernel<false>;
  rc = raise_smem_cap(reinterpret_cast<const void*>(search), smem_b, kSearchSmem);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  profiles_kernel<<<dim3(chunks, n_frames), kProfileThreads, smem_a, s>>>(frames, row_sums,
                                                                          col_parts, h, w, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_frames * cluster);
  config.blockDim = dim3(kSearchThreads);
  config.dynamicSmemBytes = smem_b;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, search, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_blanking_sync(const float* frames, float* row_sums, float* col_parts,
                                int n_frames, int h, int w, int y_wmin, int y_wmax, int x_wmin,
                                int x_wmax, float g0, float g1, float g2, float g3, float g4,
                                int method, int subpixel, int cluster, void* s_y, void* s_x,
                                float* score, void* pairs, void* stream) {
  return tt_blanking_sync_timed(frames, row_sums, col_parts, n_frames, h, w, y_wmin, y_wmax,
                                x_wmin, x_wmax, g0, g1, g2, g3, g4, method, subpixel, cluster,
                                s_y, s_x, score, pairs, stream, nullptr);
}
