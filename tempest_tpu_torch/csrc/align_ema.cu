// K3: sub-pixel alignment of every frame fused with the EMA fold.
//
// Replaces stages 5 and 6 of the JAX package: align_frame (:279),
// _roll_frac (:285), align_frame_subpixel (:302) and _interp_weights (:316)
// of tempest_tpu/ops/framesync.py, and ema_fold of
// tempest_tpu/pipeline/offline.py (:664).  There they are XLA, not Pallas:
// the JAX package wrote no kernel for them.  For B streams of F frames each
// ([B·F, h, w] screens, stream-major) it writes
//
//   aligned  each frame circularly shifted by (-s_y, -s_x), rows first: a
//            row pass out of the taps (i + k_y + o) mod h, then a column pass
//            over its rounded values at (j + k_x + o) mod w, o running over
//            the taps' offsets (integer: one tap of weight 1, no product;
//            linear: 0, 1; cubic: -1, 0, 1, 2);
//   ema      each stream's fold fl(fl(A · ema) + S), S = sum over the
//            stream's frames n, in frame order, of fl(w_n · aligned_n),
//            started from the first product.
//
// The integer shifts k = floor(s) (int64, any sign: the kernel reduces them
// mod h and mod w, once a frame), the tap weights, the fold's weights
// w_n = (1 - a) a^(F-1-n) and A = a^F come from the wrapper, computed by
// torch exactly as the plain version computes them
// (tempest_tpu_torch/ops/align_kernel.py), so that every product and sum here
// is one of the plain version's, in its order, one rounding each: the _rn
// intrinsics keep nvcc from contracting them into FMAs.  The aligned frames
// and the EMA then equal the plain version's to the bit, and a fold from a
// zero image is the B that the mesh composes as A · e + B.  A mode that only
// folds (no shift) reads the frames and writes the EMA.
//
// Bound: memory.  At the slice, 36 screens of 600x800 are read once and
// written once aligned (69.1 MB each way) and the EMA read and written once
// (1.9 MB each way): 0.042 ms at 3.35 TB/s; a few operations a pixel.  The
// design moves those bytes once:
//
// * A block owns one output row i of one stream and walks over the stream's
//   F frames in order, so that the fold's sum of a pixel stays in one thread
//   (in shared memory, one slot a column) and the EMA is written once, at the
//   end.
// * Per frame the row pass reads the taps' 2 or 4 source rows (whole rows,
//   coalesced; the neighbouring output rows' blocks read the same rows about
//   the same time, so they come from L2) into a shared row; the column pass
//   reads its taps from that row and writes the aligned row, coalesced.  Two
//   shared rows are used in turn, so one barrier a frame suffices.

#include <cuda_runtime.h>

#include <mutex>
#include <utility>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockSmem = 227 * 1024;

struct Params {
  const float* frames;      // [B·F, h, w]
  float* aligned;           // [B·F, h, w], or null: not written
  const float* ema_in;      // [B, h, w], or null: no fold
  float* ema_out;           // [B, h, w]
  const long long* shift;   // [2, B·F]: floors of the row shifts, then the columns'
  const float* weights;     // [2, B·F, TAPS]: row-pass weights, then column-pass
  const float* fold_w;      // [F]
  const float* fold_a;      // [1]: A = a^F
  int h, w, n_frames, n_streams;
};

// k mod n in [0, n), for any k.
__device__ __forceinline__ int reduce(long long k, int n) {
  const long long r = k % n;
  return static_cast<int>(r < 0 ? r + n : r);
}

// i mod n for i in [-n, 3n): an index plus a reduced shift plus a tap offset.
__device__ __forceinline__ int wrap(int i, int n) {
  if (i < 0) return i + n;
  if (i >= n) i -= n;
  return i >= n ? i - n : i;
}

// Offset of tap t: 2 taps at 0, 1; 4 taps at -1, 0, 1, 2.
template <int TAPS>
__device__ __forceinline__ int tap_offset(int t) {
  return TAPS == 4 ? t - 1 : t;
}

// TAPS: 0 fold only (no shift), 1 integer shift, 2 linear, 4 cubic.
template <int TAPS>
__global__ void __launch_bounds__(kThreads) align_fold_kernel(Params p) {
  extern __shared__ float smem[];
  const int h = p.h, w = p.w;
  const int i = blockIdx.x;  // output row
  const int b = blockIdx.y;  // stream
  const bool fold = p.ema_out != nullptr;
  float* const sum = smem;                 // [w] the fold's sums
  float* const rows = smem + (fold ? w : 0);  // [2][w] the row pass, in turn
  const long long plane = static_cast<long long>(h) * w;
  const long long total = static_cast<long long>(p.n_streams) * p.n_frames;
  for (int n = 0; n < p.n_frames; ++n) {
    const long long f = static_cast<long long>(b) * p.n_frames + n;
    const float* const img = p.frames + f * plane;
    float* const r = rows + (n & 1) * w;
    int ky = 0, kx = 0;
    if constexpr (TAPS >= 1) {
      ky = reduce(p.shift[f], h);
      kx = reduce(p.shift[total + f], w);
    }
    if constexpr (TAPS >= 2) {
      float wt[TAPS];
      const float* src[TAPS];
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        wt[t] = p.weights[f * TAPS + t];
        src[t] = img + static_cast<long long>(wrap(i + ky + tap_offset<TAPS>(t), h)) * w;
      }
      for (int j = threadIdx.x; j < w; j += kThreads) {
        float acc = __fmul_rn(wt[0], src[0][j]);
#pragma unroll
        for (int t = 1; t < TAPS; ++t) acc = __fadd_rn(acc, __fmul_rn(wt[t], src[t][j]));
        r[j] = acc;
      }
      __syncthreads();  // the row is whole; the other row was read a frame ago
    }
    float wt[TAPS > 1 ? TAPS : 1];
    const float* src_row = img + static_cast<long long>(i) * w;
    if constexpr (TAPS == 1) src_row = img + static_cast<long long>(wrap(i + ky, h)) * w;
    if constexpr (TAPS >= 2) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t) wt[t] = p.weights[(total + f) * TAPS + t];
    }
    const float fw = fold ? p.fold_w[n] : 0.0f;
    float* const out_row = p.aligned ? p.aligned + f * plane + static_cast<long long>(i) * w
                                     : nullptr;
    for (int j = threadIdx.x; j < w; j += kThreads) {
      float v;
      if constexpr (TAPS == 0) {
        v = src_row[j];
      } else if constexpr (TAPS == 1) {
        v = src_row[wrap(j + kx, w)];
      } else {
        v = __fmul_rn(wt[0], r[wrap(j + kx + tap_offset<TAPS>(0), w)]);
#pragma unroll
        for (int t = 1; t < TAPS; ++t) {
          v = __fadd_rn(v, __fmul_rn(wt[t], r[wrap(j + kx + tap_offset<TAPS>(t), w)]));
        }
      }
      if (out_row) out_row[j] = v;
      if (fold) {
        const float term = __fmul_rn(fw, v);
        sum[j] = n == 0 ? term : __fadd_rn(sum[j], term);
      }
    }
  }
  if (!fold) return;
  const float a = *p.fold_a;
  const long long at = (static_cast<long long>(b) * h + i) * w;
  for (int j = threadIdx.x; j < w; j += kThreads) {
    p.ema_out[at + j] = __fadd_rn(__fmul_rn(a, p.ema_in[at + j]), sum[j]);
  }
}

template <int TAPS>
int launch(const Params& p, cudaStream_t stream) {
  static std::mutex lock;
  static std::vector<int> capped;  // devices whose shared-memory cap is raised
  const bool fold = p.ema_out != nullptr;
  const int rows = (fold ? 1 : 0) + (TAPS >= 2 ? 2 : 0);  // the fold's sums, the two row buffers
  const int smem = static_cast<int>(sizeof(float)) * p.w * rows;
  if (smem > kBlockSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const std::lock_guard<std::mutex> guard(lock);
    bool done = false;
    for (int d : capped) done = done || d == device;
    if (!done) {
      err = cudaFuncSetAttribute(align_fold_kernel<TAPS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      capped.push_back(device);
    }
  }
  align_fold_kernel<TAPS><<<dim3(p.h, p.n_streams), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K3 on `stream`; returns the cudaError_t of the launch (0 = ok).
// `frames` [n_streams·n_frames, h, w] float32, stream-major.  `taps`: 0 fold
// only (shift, weights unread), 1 integer shifts (weights unread), 2 linear,
// 4 cubic.  `shift` int64 [2, frames]: the floor of each frame's row shift,
// then of its column shift, of any sign; `weights` float32 [2, frames,
// taps].  `aligned` may be null (not written; not with taps 0, where the
// frames are their own alignment); `ema_in`/`ema_out` [n_streams, h, w] may
// both be null (no fold), else `fold_w` float32 [n_frames] and `fold_a`
// float32 [1] are the fold's weights.
extern "C" int tt_align_fold(const float* frames, float* aligned, const float* ema_in,
                             float* ema_out, const long long* shift, const float* weights,
                             const float* fold_w, const float* fold_a, int h, int w,
                             int n_frames, int n_streams, int taps, void* stream) {
  if (h < 1 || w < 1 || n_frames < 1 || n_streams < 1 || n_streams > 65535 ||
      (ema_in == nullptr) != (ema_out == nullptr) || (aligned == nullptr && ema_out == nullptr) ||
      (taps == 0 && (aligned != nullptr || ema_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{frames, aligned, ema_in, ema_out, shift, weights, fold_w, fold_a,
           h, w, n_frames, n_streams};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (taps) {
    case 0: return launch<0>(p, s);
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 4: return launch<4>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
