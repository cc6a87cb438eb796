// SELL-C-σ SpMV / SpMM for NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/spmv_sellcs.py:103 spmv_sellcs_pallas (the
// Pallas TPU kernel, vector and batched bodies) and computes what it
// computes, followed by the row_perm scatter the reference does outside the
// kernel: for every sorted row i = t*C + c with row_perm[i] < m and column j,
//
//   y[row_perm[i], j] = sum_{w < w_t} dq(vals[t, c, w]) * x[col[t, c, w], j]
//
// with w_t = chunk_width[t], dq the f32 upcast of bf16 or int8 code *
// val_scale[t, c, w / group], and every product and sum in f32.  x and y
// are float32 or bfloat16 (one type for both, as the Pallas kernel stores y
// in x's dtype): a bf16 x is widened to f32 as it is read, and each row is
// rounded to bf16 once, when stored.
//
// Bound: bytes.  SpMV does 2 flops per stored slot and column and reads
// 5-8 bytes per slot, far below the card's ~20 flops per byte of float32
// balance, so the least time is the bytes the work must move over the
// memory rate.  At B = 1 a row's x gathers wait on its column loads, so
// what sets the time is how many bytes each SM keeps in flight.
//
// Design:
//   * A row's slots are summed as 8 strands: strand l adds the 4-slot
//     vectors l, l + 8, l + 16, ... (slots 4l..4l+3, then 4l+32..) in order
//     with fused multiply-adds, and a fixed xor tree folds the strands
//     (l + 4, then l + 2, then l + 1).  At B = 1 each strand has a thread:
//     8 threads per row, four rows per warp.  At B > 1 a thread carries two
//     strands (4 threads per row) and gathers whole 32-byte x rows.  Either
//     way column j takes the same operations in the same order whatever B
//     is: repeat launches are bit-equal and column j of an [n, B] launch
//     equals an [n] launch on x[:, j].  No float atomics.
//   * The [T, C, W] view's rows start W * sizeof(V) bytes apart with W a
//     multiple of 128, so a vector is one 16-byte load of columns and one
//     16-, 8- or 4-byte load of values, kept packed until it is summed.  A
//     thread issues the loads of a whole 128-slot batch before its first x
//     gather: on bmwcra_1 (w_t <= 80) every load of a row is in flight at
//     once.  A vector that crosses w_t, or a view whose pointers are not
//     aligned, is read slot by slot.  At B = 1 the kernel is held to 64
//     registers, four blocks of 256 threads per SM.
//   * Only the chunk's real lanes [0, w_t) are read.  The [T, C, W] view
//     pads every chunk to the global maximum width rounded up to 128 (the
//     Pallas kernel's static block); walking all W lanes would move the
//     padding too (1.61x the slots on bmwcra_1).
//   * No serial loads before the slots: the grid holds as many blocks as
//     fit on the card at once and each row group walks rows i, i + stride,
//     ...; a row's chunk_width and row_perm are fetched while the previous
//     row is summed.  C-alignment pad rows (row_perm == m, the dump row)
//     are summed like any row (their lanes are padding) and only their
//     store is skipped, so no row of y is written twice.
//   * int8: a scale group of 128 lanes or more (every container's is 128)
//     meets a batch in at most two scales, loaded once per batch, with no
//     divide in the slot loop.  Smaller groups take one scale load per slot.
//   * x is read straight from global memory through the read-only path and
//     L2 (the Pallas kernel held the whole padded x in VMEM).  Reads of x
//     past x_rows return 0, so x needs no padding.
//   * Each row is written straight to y[row_perm[i]]: this folds in the
//     reference's scatter.
//
// Plain C interface (loaded with ctypes); the launch is asynchronous on the
// caller's stream and the function returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;                    // columns a group sums per pass at B > 1

constexpr int kSum = 8;                        // strands per row (design notes)
constexpr int kBatch = 128;                    // slots of a row per batch
// Threads per row by columns per pass: one strand each at B = 1, two at B > 1.
__host__ __device__ constexpr int lanes_for(int nb) { return nb == 1 ? 8 : 4; }

// Four consecutive slots of values as loaded, unpacked only when summed, so
// a load in flight holds 4 (f32), 2 (bf16) or 1 (int8) registers: f32 as a
// float4, bf16 as a uint2, int8 codes as an int (the scale comes later).
template <typename V> struct Values4;

template <> struct Values4<float> {
  float4 r;
  __device__ void clear() { r = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ void load(const float* v, int i) { r = __ldg(reinterpret_cast<const float4*>(v + i)); }
  __device__ void load_one(const float* v, int i, int e) {
    const float f = __ldg(v + i);
    if (e == 0) r.x = f;
    if (e == 1) r.y = f;
    if (e == 2) r.z = f;
    if (e == 3) r.w = f;
  }
  __device__ float get(int e) const { return e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w; }
};

template <> struct Values4<__nv_bfloat16> {
  uint2 r;
  __device__ void clear() { r = make_uint2(0u, 0u); }
  __device__ void load(const __nv_bfloat16* v, int i) {
    r = __ldg(reinterpret_cast<const uint2*>(v + i));
  }
  __device__ void load_one(const __nv_bfloat16* v, int i, int e) {
    const unsigned h = __ldg(reinterpret_cast<const unsigned short*>(v) + i);
    unsigned& word = e < 2 ? r.x : r.y;
    word = e % 2 ? (word & 0xffffu) | (h << 16) : (word & 0xffff0000u) | h;
  }
  __device__ float get(int e) const {
    const unsigned word = e < 2 ? r.x : r.y;
    return __uint_as_float(e % 2 ? word & 0xffff0000u : word << 16);
  }
};

template <> struct Values4<int8_t> {
  int r;
  __device__ void clear() { r = 0; }
  __device__ void load(const int8_t* v, int i) { r = __ldg(reinterpret_cast<const int*>(v + i)); }
  __device__ void load_one(const int8_t* v, int i, int e) {
    const int b = __ldg(reinterpret_cast<const unsigned char*>(v) + i);
    r = (r & ~(0xff << (8 * e))) | (b << (8 * e));
  }
  __device__ float get(int e) const { return static_cast<float>((r << (24 - 8 * e)) >> 24); }
};

__device__ __forceinline__ int pick(const int4& c, int e) {
  return e == 0 ? c.x : e == 1 ? c.y : e == 2 ? c.z : c.w;
}

template <typename V, typename X, bool kScaled, int NB>
__global__ void __launch_bounds__(kThreads, NB == 1 ? 4 : 2)
sellcs_kernel(const V* __restrict__ vals, const int* __restrict__ cols,
              const int* __restrict__ row_perm, const int* __restrict__ chunk_width,
              const float* __restrict__ val_scale, int groups, int group,
              const X* __restrict__ x, long long x_rows, int B, X* __restrict__ y,
              int m, long long m_pad, int C, int W, bool vec) {
  constexpr int kG = lanes_for(NB);             // threads per row
  constexpr int kH = kSum / kG;                 // strands per thread
  constexpr int kU = kBatch / (4 * kG);         // vectors a thread loads per batch
  constexpr int kRowsPerBlock = kThreads / kG;
  const int lane = threadIdx.x % kG;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kG;
  // a warp's rows are consecutive: it runs while its first row is in range,
  // so all 32 lanes take part in every shuffle
  int64_t warp_first = i - (threadIdx.x % 32) / kG;
  // x rows can be read four values at a time when aligned to four values
  const bool x4 = NB == 8 && B % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(X) - 1)) == 0;
  // int8 groups of at least a batch (128 lanes in every container): a batch
  // spans at most two of them, so it loads at most two scales
  const bool few_scales = kScaled && group >= kBatch;

  int wt_cur = 0, orig_cur = m;               // row i's chunk width and home
  if (i < m_pad) {
    wt_cur = __ldg(chunk_width + i / C);
    orig_cur = __ldg(row_perm + i);
  }
  for (; warp_first < m_pad; warp_first += stride, i += stride) {
    const bool active = i < m_pad;
    const int wt = active ? min(max(wt_cur, 0), W) : 0;
    const int orig = orig_cur;
    if (i + stride < m_pad) {                 // the next row's, while this one runs
      wt_cur = __ldg(chunk_width + (i + stride) / C);
      orig_cur = __ldg(row_perm + i + stride);
    }
    const V* vrow = vals + i * W;
    const int* crow = cols + i * W;
    const float* scales = kScaled ? val_scale + i * groups : nullptr;

    for (int j0 = 0; j0 < B; j0 += NB) {
      const int nb = min(NB, B - j0);
      float acc[kH][NB];
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int k = 0; k < NB; ++k) acc[h][k] = 0.f;

      int g = 0, g_end = group;               // scale group of the batch's first slot
      for (int w0 = 0; w0 < wt; w0 += kBatch) {
        float s_lo = 1.f, s_hi = 1.f;
        if (few_scales) {
          if (w0 >= g_end) {
            ++g;
            g_end += group;
          }
          s_lo = __ldg(scales + g);
          if (g_end < min(w0 + kBatch, wt)) s_hi = __ldg(scales + g + 1);
        }
        Values4<V> v[kU];
        int4 c[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int w = w0 + 4 * (lane + kG * u);
          if (vec && w + 4 <= wt) {
            v[u].load(vrow, w);
            c[u] = __ldg(reinterpret_cast<const int4*>(crow + w));
          } else {
            v[u].clear();
            c[u] = make_int4(0, 0, 0, 0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (w + e < wt) {
                v[u].load_one(vrow, w + e, e);
                if (e == 0) c[u].x = __ldg(crow + w);
                if (e == 1) c[u].y = __ldg(crow + w + 1);
                if (e == 2) c[u].z = __ldg(crow + w + 2);
                if (e == 3) c[u].w = __ldg(crow + w + 3);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int w = w0 + 4 * (lane + kG * u);
          const int h = u % kH;                   // vector lane + kG u: strand h kG + lane
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (w + e >= wt) break;
            float val = v[u].get(e);
            if (kScaled)
              val = __fmul_rn(val, few_scales ? (w + e < g_end ? s_lo : s_hi)
                                              : __ldg(scales + (w + e) / group));
            const int cc = pick(c[u], e);
            const bool in = cc >= 0 && cc < x_rows;
            if (NB == 1) {
              acc[h][0] = __fmaf_rn(val, in ? load_f32(x + cc) : 0.f, acc[h][0]);
              continue;
            }
            const X* xr = x + static_cast<int64_t>(in ? cc : 0) * B + j0;
            if (x4 && nb == NB) {
#pragma unroll
              for (int k = 0; k < NB; k += 4) {
                const float4 xv = in ? load_f32x4(xr + k) : make_float4(0.f, 0.f, 0.f, 0.f);
                acc[h][k] = __fmaf_rn(val, xv.x, acc[h][k]);
                acc[h][k + 1] = __fmaf_rn(val, xv.y, acc[h][k + 1]);
                acc[h][k + 2] = __fmaf_rn(val, xv.z, acc[h][k + 2]);
                acc[h][k + 3] = __fmaf_rn(val, xv.w, acc[h][k + 3]);
              }
            } else {
#pragma unroll
              for (int k = 0; k < NB; ++k) {
                if (k < nb)
                  acc[h][k] = __fmaf_rn(val, in ? load_f32(xr + k) : 0.f, acc[h][k]);
              }
            }
          }
        }
      }

#pragma unroll
      for (int k = 0; k < NB; ++k) {
        float s = acc[0][k];
        if (kH == 2) s = __fadd_rn(s, acc[1][k]);   // the tree's first step: l and l + 4
#pragma unroll
        for (int off = kG / 2; off > 0; off >>= 1)
          s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off, kG));
        if (lane == 0 && k < nb && active && orig >= 0 && orig < m)
          store_rounded(y + static_cast<int64_t>(orig) * B + j0 + k, s);
      }
    }
  }
}

// Blocks of one kernel instance that fit on the current card at once: the
// grid of a launch that walks the rows.
template <typename V, typename X, bool kScaled, int NB>
int resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sellcs_kernel<V, X, kScaled, NB>,
                                                kThreads, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

template <typename V, typename X, bool kScaled, int NB>
cudaError_t launch_cols(const V* v, const int* cols, const int* row_perm,
                        const int* chunk_width, const float* val_scale, int groups,
                        const X* x, long long x_rows, int B, X* y, int m,
                        long long m_pad, int C, int W, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / lanes_for(NB);
  const long long need = (m_pad + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long cap = resident_blocks<V, X, kScaled, NB>();
  const int group = groups > 0 ? W / groups : 1;
  // 16-byte column vectors and 4-slot value vectors need aligned bases
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(cols) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v) & (4 * sizeof(V) - 1)) == 0;
  sellcs_kernel<V, X, kScaled, NB><<<static_cast<unsigned>(need < cap ? need : cap), kThreads,
                                     0, stream>>>(v, cols, row_perm, chunk_width, val_scale,
                                                  groups, group, x, x_rows, B, y, m, m_pad, C,
                                                  W, vec);
  return cudaGetLastError();
}

template <typename V, typename X, bool kScaled>
cudaError_t launch_x(const void* vals, const int* cols, const int* row_perm,
                     const int* chunk_width, const float* val_scale, int groups,
                     const void* x_ptr, long long x_rows, int B, void* y_ptr, int m, int T,
                     int C, int W, cudaStream_t stream) {
  const long long m_pad = static_cast<long long>(T) * C;
  const V* v = static_cast<const V*>(vals);
  const X* x = static_cast<const X*>(x_ptr);
  X* y = static_cast<X*>(y_ptr);
  if (B == 1)
    return launch_cols<V, X, kScaled, 1>(v, cols, row_perm, chunk_width, val_scale, groups, x,
                                         x_rows, B, y, m, m_pad, C, W, stream);
  return launch_cols<V, X, kScaled, kMaxCols>(v, cols, row_perm, chunk_width, val_scale,
                                              groups, x, x_rows, B, y, m, m_pad, C, W, stream);
}

// x_kind: 0 = float32, 1 = bfloat16 (x and y alike).
template <typename V, bool kScaled>
cudaError_t launch(int x_kind, const void* vals, const int* cols, const int* row_perm,
                   const int* chunk_width, const float* val_scale, int groups, const void* x,
                   long long x_rows, int B, void* y, int m, int T, int C, int W,
                   cudaStream_t stream) {
  switch (x_kind) {
    case 0:
      return launch_x<V, float, kScaled>(vals, cols, row_perm, chunk_width, val_scale, groups,
                                         x, x_rows, B, y, m, T, C, W, stream);
    case 1:
      return launch_x<V, __nv_bfloat16, kScaled>(vals, cols, row_perm, chunk_width, val_scale,
                                                 groups, x, x_rows, B, y, m, T, C, W, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// value_kind: 0 = float32, 1 = bfloat16, 2 = int8 (val_scale required);
// x_kind: 0 = float32, 1 = bfloat16, the type of x and of y.
// vals / cols: [T, C, W]; val_scale: [T, C, groups]; row_perm: [T*C];
// chunk_width: [T]; x: [x_rows, B]; y: [m, B].
int repro_spmv_sellcs(int value_kind, int x_kind, const void* vals, const int* cols,
                      const int* row_perm, const int* chunk_width, const float* val_scale,
                      int groups, const void* x, long long x_rows, int B, void* y, int m, int T,
                      int C, int W, void* stream) {
  if (T <= 0 || C < 1 || W < 1 || B < 1 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (value_kind) {
    case 0:
      return static_cast<int>(launch<float, false>(x_kind, vals, cols, row_perm, chunk_width,
                                                   nullptr, 0, x, x_rows, B, y, m, T, C, W, st));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16, false>(x_kind, vals, cols, row_perm,
                                                           chunk_width, nullptr, 0, x, x_rows, B,
                                                           y, m, T, C, W, st));
    case 2:
      if (val_scale == nullptr || groups <= 0 || W % groups)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch<int8_t, true>(x_kind, vals, cols, row_perm, chunk_width,
                                                   val_scale, groups, x, x_rows, B, y, m, T, C,
                                                   W, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_sellcs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
