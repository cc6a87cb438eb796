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
// val_scale[t, c, w / group], and every product and sum in f32.
//
// Bound: bytes.  SpMV does 2 flops per stored slot and column and reads
// 5-8 bytes per slot, far below the card's ~20 flops per byte of float32
// balance, so the least time is the bytes the work must move over the
// memory rate.
//
// Design:
//   * One warp per sorted row, eight rows per block.  Rows inside a chunk
//     are independent (no segmented reduction), and a row's lanes are
//     contiguous in the [T, C, W] view, so neighbouring threads read
//     neighbouring slots: 128-byte loads of values and columns.
//   * Only the chunk's real lanes [0, w_t) are read.  The [T, C, W] view
//     pads every chunk to the global maximum width rounded up to 128 (the
//     Pallas kernel's static block); walking all W lanes would move the
//     padding too (1.61x the slots on bmwcra_1).
//   * x is read straight from global memory through the read-only path and
//     L2 (the Pallas kernel held the whole padded x in VMEM).  Reads of x
//     past x_rows return 0, so x needs no padding.
//   * Each thread issues the loads of kUnroll slots before it uses any.
//   * Deterministic sums, no float atomics: lane l adds its slots
//     l, l+32, l+64, ... in increasing order with fused multiply-adds, then
//     a fixed shuffle tree sums the 32 lanes.  Column j takes the same
//     operations in the same order whatever B is, so repeat launches are
//     bit-equal and column j of an [n, B] launch equals an [n] launch on
//     x[:, j].  At B > 1 a warp takes up to 8 columns per pass.
//   * Each row is written straight to y[row_perm[i]]: this folds in the
//     reference's scatter, and C-alignment pad rows (row_perm == m, the
//     dump row) are skipped, so no row of y is written twice.
//
// Plain C interface (loaded with ctypes); the launch is asynchronous on the
// caller's stream and the function returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kUnroll = 4;        // slots whose loads a thread keeps in flight
constexpr int kMaxCols = 8;       // columns a warp sums per pass at B > 1

__device__ __forceinline__ float load_value(const float* v, int64_t i, float) {
  return __ldg(v + i);
}

__device__ __forceinline__ float load_value(const __nv_bfloat16* v, int64_t i, float) {
  return __bfloat162float(v[i]);
}

__device__ __forceinline__ float load_value(const int8_t* v, int64_t i, float scale) {
  return __fmul_rn(static_cast<float>(__ldg(v + i)), scale);
}

// Fixed reduction tree over the warp; lane 0 holds the sum.
__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, off));
  return a;
}

template <typename V, bool kScaled, int NB>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
sellcs_kernel(const V* __restrict__ vals, const int* __restrict__ cols,
              const int* __restrict__ row_perm, const int* __restrict__ chunk_width,
              const float* __restrict__ val_scale, int groups, int group,
              const float* __restrict__ x, long long x_rows, int B, float* __restrict__ y,
              int m, long long m_pad, int C, int W) {
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= m_pad) return;                 // the whole warp leaves together
  const int orig = __ldg(row_perm + i);
  if (orig < 0 || orig >= m) return;      // pad row: its dump row is never written
  const int wt = min(max(__ldg(chunk_width + i / C), 0), W);
  const int64_t base = i * W;
  // x rows can be read as float4 when 16-byte aligned
  const bool vec4 = NB == 8 && B % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  for (int j0 = 0; j0 < B; j0 += NB) {
    const int nb = min(NB, B - j0);
    float acc[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) acc[k] = 0.f;

    for (int w0 = lane; w0 < wt; w0 += 32 * kUnroll) {
      float v[kUnroll];
      int64_t col[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int w = w0 + u * 32;
        v[u] = 0.f;
        col[u] = -1;
        if (w < wt) {
          const float scale =
              kScaled ? __ldg(val_scale + i * groups + w / group) : 1.f;
          v[u] = load_value(vals, base + w, scale);
          col[u] = __ldg(cols + base + w);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (w0 + u * 32 >= wt) break;
        const bool in = col[u] >= 0 && col[u] < x_rows;
        const float* xr = x + (in ? col[u] : 0) * B + j0;
        if (NB == 1) {
          acc[0] = __fmaf_rn(v[u], in ? __ldg(xr) : 0.f, acc[0]);
        } else if (vec4 && nb == NB) {
#pragma unroll
          for (int k = 0; k < NB; k += 4) {
            const float4 xv = in ? __ldg(reinterpret_cast<const float4*>(xr + k))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            acc[k] = __fmaf_rn(v[u], xv.x, acc[k]);
            acc[k + 1] = __fmaf_rn(v[u], xv.y, acc[k + 1]);
            acc[k + 2] = __fmaf_rn(v[u], xv.z, acc[k + 2]);
            acc[k + 3] = __fmaf_rn(v[u], xv.w, acc[k + 3]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < NB; ++k) {
            if (k < nb) acc[k] = __fmaf_rn(v[u], in ? __ldg(xr + k) : 0.f, acc[k]);
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const float s = warp_sum(acc[k]);
      if (lane == 0 && k < nb) y[static_cast<int64_t>(orig) * B + j0 + k] = s;
    }
  }
}

template <typename V, bool kScaled>
cudaError_t launch(const void* vals, const int* cols, const int* row_perm,
                   const int* chunk_width, const float* val_scale, int groups,
                   const float* x, long long x_rows, int B, float* y, int m, int T, int C,
                   int W, cudaStream_t stream) {
  const long long m_pad = static_cast<long long>(T) * C;
  const long long blocks = (m_pad + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int group = groups > 0 ? W / groups : 1;
  const V* v = static_cast<const V*>(vals);
  if (B == 1) {
    sellcs_kernel<V, kScaled, 1><<<static_cast<unsigned>(blocks), kRowsPerBlock * 32, 0,
                                   stream>>>(v, cols, row_perm, chunk_width, val_scale,
                                             groups, group, x, x_rows, B, y, m, m_pad, C, W);
  } else {
    sellcs_kernel<V, kScaled, kMaxCols><<<static_cast<unsigned>(blocks),
                                          kRowsPerBlock * 32, 0, stream>>>(
        v, cols, row_perm, chunk_width, val_scale, groups, group, x, x_rows, B, y, m, m_pad,
        C, W);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// value_kind: 0 = float32, 1 = bfloat16, 2 = int8 (val_scale required).
// vals / cols: [T, C, W]; val_scale: [T, C, groups]; row_perm: [T*C];
// chunk_width: [T]; x: [x_rows, B]; y: [m, B].
int repro_spmv_sellcs(int value_kind, const void* vals, const int* cols, const int* row_perm,
                      const int* chunk_width, const float* val_scale, int groups,
                      const float* x, long long x_rows, int B, float* y, int m, int T, int C,
                      int W, void* stream) {
  if (T <= 0 || C < 1 || W < 1 || B < 1 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (value_kind) {
    case 0:
      return static_cast<int>(launch<float, false>(vals, cols, row_perm, chunk_width, nullptr,
                                                   0, x, x_rows, B, y, m, T, C, W, st));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16, false>(vals, cols, row_perm, chunk_width,
                                                           nullptr, 0, x, x_rows, B, y, m, T,
                                                           C, W, st));
    case 2:
      if (val_scale == nullptr || groups <= 0 || W % groups)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch<int8_t, true>(vals, cols, row_perm, chunk_width,
                                                   val_scale, groups, x, x_rows, B, y, m, T,
                                                   C, W, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_sellcs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
