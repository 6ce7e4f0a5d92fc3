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
// The kernel takes the shifts as the sync returns them (float32 for
// sub-pixel, int32 for integer; int64 and float64 too) and computes, once a
// frame, what the plain version (tempest_tpu_torch/ops/align_kernel.py)
// computes with torch: k = floor(s) as int64 (a truncation for the integer
// mode, as .to(int64) is), f = fl(s - k) in the shift's type then rounded
// to float32, and _interp_weights's taps of f, one rounding per torch
// operation in torch's order; the fold's weights w_n = (1 - a) a^(F-1-n) and
// A = a^F come from the wrapper's cache.  Every product and sum is then one
// of the plain version's, in its order, one rounding each: the _rn
// intrinsics keep nvcc from contracting them into FMAs.  The aligned frames
// and the EMA equal the plain version's to the bit, and a fold from a zero
// image is the B that the mesh composes as A · e + B.  A mode that only folds
// (no shift) reads the frames and writes the EMA.
//
// Bound: memory.  At the slice, 36 screens of 600x800 are read once and
// written once aligned (69.1 MB each way) and the EMA read and written once
// (1.9 MB each way): 0.042 ms at 3.35 TB/s; a few operations a pixel.  What
// held the first version back was latency: a block walked its frames in
// order and waited, every frame, on the frame's shift, then on its source
// rows.  This design keeps rows in flight:
//
// * A block owns one output row i of one stream and walks over the stream's
//   F frames in order; each thread owns fixed columns (four at a time when
//   w % 4 == 0) for all of them, so the fold's sums stay in its registers
//   and the EMA row is read at the start and written once at the end.
// * Warp 0 computes 32 frames' integer parts and weights at once into a
//   ring of 64 slots in shared memory, from shifts it loaded 32 frames
//   earlier, so no frame waits on its shift.
// * The source rows go through a ring of kStages stages in shared memory,
//   filled by cp.async (16 bytes a copy when w % 4 == 0): while frame n is
//   computed, the rows of frames n + 1 .. n + kStages - 1 are in flight.  A
//   source row is always a whole row (its index taken mod h), so the copies
//   need no mask.
// * The row pass reads the ring's taps and writes one shared row; the
//   column pass reads that row four columns at a time as aligned 16-byte
//   loads and picks the shifted columns out of registers (the shift's
//   remainder mod 4 is the same for the whole frame), and writes the aligned
//   row with 16-byte stores.
// * One output row a block: blocks of two neighbouring rows, which share a
//   source row of every frame, measured slower (half the blocks, fewer rows
//   in flight on each SM).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <mutex>
#include <utility>
#include <vector>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxUnits = 2;      // columns, or quads of columns, a thread owns
constexpr int kChunk = 32;        // frames whose shifts warp 0 decodes at once
constexpr int kSlots = 2 * kChunk;
constexpr int kBlockSmem = 227 * 1024;

// Shift types: the sync's int32 and float32, and int64, float64, float16,
// bfloat16.
enum ShiftType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3, kFloat16 = 4,
                 kBFloat16 = 5 };

struct Params {
  const float* frames;      // [B·F, h, w]
  float* aligned;           // [B·F, h, w], or null: not written
  const float* ema_in;      // [B, h, w], or null: no fold
  float* ema_out;           // [B, h, w]
  const void* s_y;          // [B·F] of type y_type
  const void* s_x;          // [B·F] of type x_type
  const float* fold_w;      // [F]
  const float* fold_a;      // [1]: A = a^F
  int y_type, x_type;
  int h, w, n_frames, n_streams;
  int units;                // columns (vec: quads) each thread owns
};

// One frame's integer parts (reduced mod h and mod w), tap weights and fold
// weight, as warp 0 decodes them.
struct Frame {
  int ky, kx;
  float wy[4], wx[4];
  float fw;
};

// Ring stages of source rows and rows a stage holds.
template <int TAPS>
struct Ring {
  static constexpr int kRows = TAPS > 1 ? TAPS : 1;
  static constexpr int kStages = TAPS == 4 ? 3 : 4;
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

// A shift's bits, loaded ahead of its decoding.
__device__ __forceinline__ unsigned long long load_shift(const void* s, int type, long long f) {
  switch (type) {
    case kInt32: return static_cast<unsigned>(static_cast<const int*>(s)[f]);
    case kInt64: return static_cast<const unsigned long long*>(s)[f];
    case kFloat32: return __float_as_uint(static_cast<const float*>(s)[f]);
    case kFloat16:
    case kBFloat16: return static_cast<const unsigned short*>(s)[f];
    default: return static_cast<unsigned long long>(
        __double_as_longlong(static_cast<const double*>(s)[f]));
  }
}

// The integer part, reduced mod n, and the tap weights of one shift, as
// shift_taps computes them with torch: for the integer mode s.to(int64);
// else k = floor(s).to(int64), f = (s - k.to(s.dtype)).to(float32) and
// _interp_weights(f), each torch operation one rounding in its order.
template <int TAPS>
__device__ void decode_shift(unsigned long long bits, int type, int n, int* k_out, float* wt) {
  long long k;
  float f = 0.0f;
  if (type == kInt32) {
    k = static_cast<int>(static_cast<unsigned>(bits));
  } else if (type == kInt64) {
    k = static_cast<long long>(bits);
  } else if (type == kFloat32) {
    const float v = __uint_as_float(static_cast<unsigned>(bits));
    if (TAPS == 1) {
      k = static_cast<long long>(v);
    } else {
      k = static_cast<long long>(floorf(v));
      f = __fsub_rn(v, __ll2float_rn(k));
    }
  } else if (type == kFloat64) {
    const double v = __longlong_as_double(static_cast<long long>(bits));
    if (TAPS == 1) {
      k = static_cast<long long>(v);
    } else {
      k = static_cast<long long>(floor(v));
      f = __double2float_rn(__dsub_rn(v, __ll2double_rn(k)));
    }
  } else {
    // A 16-bit float: torch takes s - k in float32 (exact: both are 16-bit
    // values, and floor(s) is one) and rounds it to the shift's type.
    const unsigned short u = static_cast<unsigned short>(bits);
    const bool half = type == kFloat16;
    const float v = half ? __half2float(__ushort_as_half(u))
                         : __bfloat162float(__ushort_as_bfloat16(u));
    if (TAPS == 1) {
      k = static_cast<long long>(v);
    } else {
      k = static_cast<long long>(floorf(v));
      const float d = __fsub_rn(v, __ll2float_rn(k));
      f = half ? __half2float(__float2half_rn(d)) : __bfloat162float(__float2bfloat16_rn(d));
    }
  }
  *k_out = reduce(k, n);
  if constexpr (TAPS == 2) {
    wt[0] = __fsub_rn(1.0f, f);
    wt[1] = f;
  } else if constexpr (TAPS == 4) {
    const float f2 = __fmul_rn(f, f);
    const float f3 = __fmul_rn(__fmul_rn(f, f), f);
    wt[0] = __fmul_rn(0.5f, __fsub_rn(__fadd_rn(-f3, __fmul_rn(2.0f, f2)), f));
    wt[1] = __fmul_rn(0.5f, __fadd_rn(__fsub_rn(__fmul_rn(3.0f, f3), __fmul_rn(5.0f, f2)), 2.0f));
    wt[2] = __fmul_rn(0.5f, __fadd_rn(__fadd_rn(__fmul_rn(-3.0f, f3), __fmul_rn(4.0f, f2)), f));
    wt[3] = __fmul_rn(0.5f, __fsub_rn(f3, f2));
  }
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes16) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The column pass of four columns 4q .. 4q + 3 from the shared row `row`
// (w / 4 quads), `qk` = q + kx / 4 and S = kx mod 4: the quads the taps reach
// are read as aligned 16-byte loads and the shifted columns picked out of
// registers.
template <int TAPS, int S>
__device__ __forceinline__ void column_quad(const float* row, int w4, int qk, const float* wx,
                                            float* v) {
  constexpr int kLow = TAPS == 4 ? -1 : 0;  // first quad read, relative to qk
  constexpr int kQuads = TAPS == 4 ? 4 : 2;
  float vals[4 * kQuads];
#pragma unroll
  for (int d = 0; d < kQuads; ++d) {
    const float4 x = reinterpret_cast<const float4*>(row)[wrap(qk + kLow + d, w4)];
    vals[4 * d] = x.x;
    vals[4 * d + 1] = x.y;
    vals[4 * d + 2] = x.z;
    vals[4 * d + 3] = x.w;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (TAPS == 1) {
      v[c] = vals[c + S];
    } else {
      float acc = __fmul_rn(wx[0], vals[c + tap_offset<TAPS>(0) + S - 4 * kLow]);
#pragma unroll
      for (int t = 1; t < TAPS; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(wx[t], vals[c + tap_offset<TAPS>(t) + S - 4 * kLow]));
      }
      v[c] = acc;
    }
  }
}

// TAPS: 0 fold only (no shift), 1 integer shift, 2 linear, 4 cubic.  VEC:
// w % 4 == 0 and 16-byte aligned rows, each thread owning quads of columns.
template <int TAPS, bool VEC>
__global__ void __launch_bounds__(kMaxThreads) align_fold_kernel(Params p) {
  using R = Ring<TAPS>;
  constexpr int kCol = VEC ? 4 : 1;  // columns of a unit
  extern __shared__ __align__(16) float smem[];
  __shared__ Frame frame_ring[kSlots];
  const int h = p.h, w = p.w, F = p.n_frames;
  const int i = blockIdx.x;  // output row
  const int b = blockIdx.y;  // stream
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const bool warp0 = tid < 32;
  const bool fold = p.ema_out != nullptr;
  const int wu = w / kCol;   // units of a row
  float* const ring = smem;  // [kStages][kRows][w]
  float* const rowbuf = ring + R::kStages * R::kRows * w;  // [w], TAPS >= 2
  const long long plane = static_cast<long long>(h) * w;
  const long long first = static_cast<long long>(b) * F;  // the stream's first frame

  // Warp 0: the shifts of the chunk after next are loaded a chunk ahead and
  // decoded into the slot ring half a chunk before any thread reads them.
  unsigned long long raw_y = 0, raw_x = 0;
  float raw_fw = 0.0f;
  auto load_chunk = [&](int c) {
    const int m = c * kChunk + lane;
    if (m < F) {
      if (TAPS >= 1) {
        raw_y = load_shift(p.s_y, p.y_type, first + m);
        raw_x = load_shift(p.s_x, p.x_type, first + m);
      }
      if (fold) raw_fw = p.fold_w[m];
    }
  };
  auto decode_chunk = [&](int c) {
    const int m = c * kChunk + lane;
    if (m < F) {
      Frame& fr = frame_ring[m % kSlots];
      fr.ky = fr.kx = 0;
      if (TAPS >= 1) {
        decode_shift<TAPS>(raw_y, p.y_type, h, &fr.ky, fr.wy);
        decode_shift<TAPS>(raw_x, p.x_type, w, &fr.kx, fr.wx);
      }
      fr.fw = raw_fw;
    }
  };
  // Issue the copies of frame m's source rows into stage m mod kStages.
  auto prefetch = [&](int m) {
    if (m < F) {
      const Frame& fr = frame_ring[m % kSlots];
      const float* const img = p.frames + (first + m) * plane;
      float* const stage = ring + (m % R::kStages) * R::kRows * w;
#pragma unroll
      for (int t = 0; t < R::kRows; ++t) {
        int r = i;
        if constexpr (TAPS == 1) r = wrap(i + fr.ky, h);
        if constexpr (TAPS >= 2) r = wrap(i + fr.ky + tap_offset<TAPS>(t), h);
        const float* const src = img + static_cast<long long>(r) * w;
        for (int e = tid; e < wu; e += T) {
          cp_async(stage + t * w + e * kCol, src + e * kCol, VEC);
        }
      }
    }
    cp_async_commit();  // one group a frame, empty past the last
  };

  if (warp0) {
    load_chunk(0);
    decode_chunk(0);
    load_chunk(1);
  }
  // The EMA row and the fold's A, read while the first rows are in flight.
  float ema[kMaxUnits][kCol];
  float big_a = 0.0f;
  const long long ema_at = (static_cast<long long>(b) * h + i) * w;
  if (fold) {
    big_a = *p.fold_a;
#pragma unroll
    for (int u = 0; u < kMaxUnits; ++u) {
      const int e = tid + u * T;
      if (u < p.units && e < wu) {
        if constexpr (VEC) {
          const float4 x = reinterpret_cast<const float4*>(p.ema_in + ema_at)[e];
          ema[u][0] = x.x;
          ema[u][1] = x.y;
          ema[u][2] = x.z;
          ema[u][3] = x.w;
        } else {
          ema[u][0] = p.ema_in[ema_at + e];
        }
      }
    }
  }
  __syncthreads();  // chunk 0's frames are decoded
  for (int m = 0; m < R::kStages - 1; ++m) prefetch(m);

  float sum[kMaxUnits][kCol];
  for (int n = 0; n < F; ++n) {
    prefetch(n + R::kStages - 1);
    if (warp0 && n % kChunk == kChunk / 2) {
      const int c = n / kChunk + 1;
      decode_chunk(c);
      load_chunk(c + 1);
    }
    cp_async_wait<R::kStages - 1>();
    __syncthreads();  // frame n's rows have landed, from every thread's copies
    const Frame& fr = frame_ring[n % kSlots];
    const float* const stage = ring + (n % R::kStages) * R::kRows * w;
    const float* src_row = stage;  // what the column pass reads
    if constexpr (TAPS >= 2) {
      float wy[TAPS];
#pragma unroll
      for (int t = 0; t < TAPS; ++t) wy[t] = fr.wy[t];
      for (int e = tid; e < wu; e += T) {
        if constexpr (VEC) {
          float4 x[TAPS];
#pragma unroll
          for (int t = 0; t < TAPS; ++t) x[t] = reinterpret_cast<const float4*>(stage + t * w)[e];
          float4 acc;
          acc.x = __fmul_rn(wy[0], x[0].x);
          acc.y = __fmul_rn(wy[0], x[0].y);
          acc.z = __fmul_rn(wy[0], x[0].z);
          acc.w = __fmul_rn(wy[0], x[0].w);
#pragma unroll
          for (int t = 1; t < TAPS; ++t) {
            acc.x = __fadd_rn(acc.x, __fmul_rn(wy[t], x[t].x));
            acc.y = __fadd_rn(acc.y, __fmul_rn(wy[t], x[t].y));
            acc.z = __fadd_rn(acc.z, __fmul_rn(wy[t], x[t].z));
            acc.w = __fadd_rn(acc.w, __fmul_rn(wy[t], x[t].w));
          }
          reinterpret_cast<float4*>(rowbuf)[e] = acc;
        } else {
          float acc = __fmul_rn(wy[0], stage[e]);
#pragma unroll
          for (int t = 1; t < TAPS; ++t) acc = __fadd_rn(acc, __fmul_rn(wy[t], stage[t * w + e]));
          rowbuf[e] = acc;
        }
      }
      __syncthreads();  // the row pass is whole; the stage may be refilled
      src_row = rowbuf;
    }
    float wx[TAPS > 1 ? TAPS : 1];
#pragma unroll
    for (int t = 0; t < (TAPS > 1 ? TAPS : 1); ++t) wx[t] = TAPS > 1 ? fr.wx[t] : 1.0f;
    const int kx = fr.kx;
    const float fw = fr.fw;
    float* const out_row =
        p.aligned ? p.aligned + (first + n) * plane + static_cast<long long>(i) * w : nullptr;
#pragma unroll
    for (int u = 0; u < kMaxUnits; ++u) {
      const int e = tid + u * T;
      if (u >= p.units || e >= wu) continue;
      float v[kCol];
      if constexpr (VEC) {
        if constexpr (TAPS == 0) {
          const float4 x = reinterpret_cast<const float4*>(src_row)[e];
          v[0] = x.x;
          v[1] = x.y;
          v[2] = x.z;
          v[3] = x.w;
        } else {
          const int qk = e + (kx >> 2);
          switch (kx & 3) {
            case 0: column_quad<TAPS, 0>(src_row, wu, qk, wx, v); break;
            case 1: column_quad<TAPS, 1>(src_row, wu, qk, wx, v); break;
            case 2: column_quad<TAPS, 2>(src_row, wu, qk, wx, v); break;
            default: column_quad<TAPS, 3>(src_row, wu, qk, wx, v); break;
          }
        }
        if (out_row) reinterpret_cast<float4*>(out_row)[e] = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        if constexpr (TAPS == 0) {
          v[0] = src_row[e];
        } else if constexpr (TAPS == 1) {
          v[0] = src_row[wrap(e + kx, w)];
        } else {
          float acc = __fmul_rn(wx[0], src_row[wrap(e + kx + tap_offset<TAPS>(0), w)]);
#pragma unroll
          for (int t = 1; t < TAPS; ++t) {
            acc = __fadd_rn(acc, __fmul_rn(wx[t], src_row[wrap(e + kx + tap_offset<TAPS>(t), w)]));
          }
          v[0] = acc;
        }
        if (out_row) out_row[e] = v[0];
      }
      if (fold) {
#pragma unroll
        for (int c = 0; c < kCol; ++c) {
          const float term = __fmul_rn(fw, v[c]);
          sum[u][c] = n == 0 ? term : __fadd_rn(sum[u][c], term);
        }
      }
    }
    if constexpr (TAPS < 2) __syncthreads();  // the stage read above may be refilled
  }
  if (!fold) return;
#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u) {
    const int e = tid + u * T;
    if (u >= p.units || e >= wu) continue;
    float out[kCol];
#pragma unroll
    for (int c = 0; c < kCol; ++c) out[c] = __fadd_rn(__fmul_rn(big_a, ema[u][c]), sum[u][c]);
    if constexpr (VEC) {
      reinterpret_cast<float4*>(p.ema_out + ema_at)[e] =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {
      p.ema_out[ema_at + e] = out[0];
    }
  }
}

template <int TAPS, bool VEC>
int launch(const Params& p, int threads, cudaStream_t stream) {
  static std::mutex lock;
  static std::vector<int> capped;  // devices whose shared-memory cap is raised
  using R = Ring<TAPS>;
  const int rows = R::kStages * R::kRows + (TAPS >= 2 ? 1 : 0);
  const int smem = static_cast<int>(sizeof(float)) * p.w * rows;
  if (smem + static_cast<int>(sizeof(Frame)) * kSlots > kBlockSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024 - static_cast<int>(sizeof(Frame)) * kSlots) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const std::lock_guard<std::mutex> guard(lock);
    bool done = false;
    for (int d : capped) done = done || d == device;
    if (!done) {
      err = cudaFuncSetAttribute(align_fold_kernel<TAPS, VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBlockSmem - static_cast<int>(sizeof(Frame)) * kSlots);
      if (err != cudaSuccess) return static_cast<int>(err);
      capped.push_back(device);
    }
  }
  align_fold_kernel<TAPS, VEC><<<dim3(p.h, p.n_streams), threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int TAPS>
int launch_taps(const Params& p, bool vec, int threads, cudaStream_t stream) {
  return vec ? launch<TAPS, true>(p, threads, stream) : launch<TAPS, false>(p, threads, stream);
}

}  // namespace

// Launches K3 on `stream`; returns the cudaError_t of the launch (0 = ok).
// `frames` [n_streams·n_frames, h, w] float32, stream-major.  `taps`: 0 fold
// only (shifts unread), 1 integer shifts, 2 linear, 4 cubic.  `s_y`, `s_x`
// [frames]: each frame's row and column shift, of type `y_type` / `x_type`
// (0 int32, 1 int64, 2 float32, 3 float64, 4 float16, 5 bfloat16), any sign
// and size.  `aligned` may
// be null (not written; not with taps 0, where the frames are their own
// alignment); `ema_in`/`ema_out` [n_streams, h, w] may both be null (no
// fold), else `fold_w` float32 [n_frames] and `fold_a` float32 [1] are the
// fold's weights.  `vec` (w % 4 == 0 and every row 16-byte aligned): each
// thread takes four columns at a time.  `threads` (a multiple of 32, at most
// 1024) times `units` (at most 2) must cover w / 4 quads (vec) or w columns.
extern "C" int tt_align_fold(const float* frames, float* aligned, const float* ema_in,
                             float* ema_out, const void* s_y, const void* s_x, int y_type,
                             int x_type, const float* fold_w, const float* fold_a, int h, int w,
                             int n_frames, int n_streams, int taps, int vec, int threads,
                             int units, void* stream) {
  const int cover = vec ? w / 4 : w;
  if (h < 1 || w < 1 || n_frames < 1 || n_streams < 1 || n_streams > 65535 ||
      (ema_in == nullptr) != (ema_out == nullptr) || (aligned == nullptr && ema_out == nullptr) ||
      (taps == 0 && (aligned != nullptr || ema_out == nullptr)) || (vec && w % 4 != 0) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || units < 1 ||
      units > kMaxUnits || threads * units < cover ||
      (taps > 0 && (y_type < kInt32 || y_type > kBFloat16 || x_type < kInt32 ||
                    x_type > kBFloat16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{frames, aligned, ema_in, ema_out, s_y, s_x, fold_w, fold_a, y_type, x_type,
           h, w, n_frames, n_streams, units};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (taps) {
    case 0: return launch_taps<0>(p, vec != 0, threads, s);
    case 1: return launch_taps<1>(p, vec != 0, threads, s);
    case 2: return launch_taps<2>(p, vec != 0, threads, s);
    case 4: return launch_taps<4>(p, vec != 0, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
