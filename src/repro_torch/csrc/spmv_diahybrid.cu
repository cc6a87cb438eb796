// DIA/CSR-hybrid SpMV / SpMM for NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/spmv_diahybrid.py:84 spmv_dia_pallas (the
// Pallas TPU kernel of the DIA plane, vector and batched bodies) together
// with the CSR remainder that src/repro/kernels/ops.py spmv_diahybrid adds
// after it.  For every row i < m and column j:
//
//   y[i, j] = sum_k plane[k, i] * x[i + off_k, j]
//           + sum_{e in rem row i} rem_val[e] * x[rem_col[e], j]
//
// with plane[k, i] the f32 upcast of an f32 or bf16 value, x[c, j] read as 0
// for c outside [0, n), and every product and sum in f32.
//
// Bound: bytes.  The plane costs 4 (f32) or 2 (bf16) bytes per slot and the
// remainder 8 bytes per entry, for 2 flops per slot and column: far below
// the card's ~20 flops per byte of float32 balance, so the least time is the
// bytes the product must move over the memory rate.
//
// Design:
//   * One thread per row, one CUDA launch per SpMV, plane and remainder
//     together.  The plane is stored per diagonal, so plane[k, i] and
//     x[i + off_k] for neighbouring rows are neighbouring addresses: both
//     loads coalesce across a warp with no gather.  The offsets come from a
//     device array, the same for every thread (one broadcast load each).
//   * Bounded reads take the place of the reference's zero `lead` margin:
//     x[c] is read only for 0 <= c < n, so x needs no padded copy per call.
//   * Every in-range plane slot is multiplied, a 0 value included, so an inf
//     or NaN in x reaches exactly the rows it reaches in the reference.
//   * The remainder is summed by the same thread after the plane: the plane
//     in f32 over k in increasing order, the row's remainder entries in entry
//     order, then the two added.  One fixed order, no float atomics, each y
//     row written once.  Column j takes the same operations in the same
//     order whatever B is, so repeat launches are bit-equal and column j of
//     an [n, B] launch equals an [n] launch on x[:, j].  At B > 1 a thread
//     keeps 8 accumulators per pass and reads each plane value once for them.
//   * The kernel waits on memory latency far more than on bandwidth, so the
//     warps in flight set its pace.  Plain loops keep a thread at 32
//     registers at B = 1, which lets 64 warps share an SM.
//   * Rows with many remainder entries (a fringe row has 64) hold their warp
//     while the others wait, and a block ends only when its last warp does.
//     Blocks of 64 rows keep that hold small: on stencil_fringe, where 1% of
//     rows are fringe rows, 47% of 64-row blocks hold one against 92% of
//     256-row blocks.  The imbalance itself is the first thing a faster
//     design looks at (PERF.md).
//
// Plain C interface (loaded with ctypes); the launch is asynchronous on the
// caller's stream and the function returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // rows per block
constexpr int kMaxCols = 8;   // columns a thread sums per pass at B > 1

__device__ __forceinline__ float load_value(const float* v, int64_t i) { return __ldg(v + i); }

__device__ __forceinline__ float load_value(const __nv_bfloat16* v, int64_t i) {
  return __bfloat162float(v[i]);
}

// acc[k] += v * x[c, j0 + k] for the nb columns of this pass (x[c] = 0 off
// the matrix); float4 loads when the row of x is 16-byte aligned.
template <int NB>
__device__ __forceinline__ void fma_row(float (&acc)[NB], float v, const float* __restrict__ x,
                                        int64_t c, bool in, int B, int j0, int nb, bool vec4) {
  const float* xr = x + (in ? c : 0) * B + j0;
  if (NB == 1) {
    acc[0] = __fmaf_rn(v, in ? __ldg(xr) : 0.f, acc[0]);
  } else if (vec4 && nb == NB) {
#pragma unroll
    for (int k = 0; k < NB; k += 4) {
      const float4 xv = in ? __ldg(reinterpret_cast<const float4*>(xr + k))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[k] = __fmaf_rn(v, xv.x, acc[k]);
      acc[k + 1] = __fmaf_rn(v, xv.y, acc[k + 1]);
      acc[k + 2] = __fmaf_rn(v, xv.z, acc[k + 2]);
      acc[k + 3] = __fmaf_rn(v, xv.w, acc[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (k < nb) acc[k] = __fmaf_rn(v, in ? __ldg(xr + k) : 0.f, acc[k]);
    }
  }
}

template <typename V, int NB>
__global__ void __launch_bounds__(kThreads)
diahybrid_kernel(const V* __restrict__ plane, const int* __restrict__ offsets, int n_diag,
                 const int* __restrict__ rem_ptr, const int* __restrict__ rem_col,
                 const float* __restrict__ rem_val, const float* __restrict__ x, int B,
                 float* __restrict__ y, int m, int n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int e0 = __ldg(rem_ptr + i);
  const int e1 = __ldg(rem_ptr + i + 1);
  const bool vec4 = NB == 8 && B % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  for (int j0 = 0; j0 < B; j0 += NB) {
    const int nb = min(NB, B - j0);
    float dia[NB];
    float rem[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) dia[k] = rem[k] = 0.f;

    for (int k = 0; k < n_diag; ++k) {
      const int64_t c = i + __ldg(offsets + k);
      const float v = load_value(plane, static_cast<int64_t>(k) * m + i);
      fma_row<NB>(dia, v, x, c, c >= 0 && c < n, B, j0, nb, vec4);
    }
    for (int e = e0; e < e1; ++e) {
      const int64_t c = __ldg(rem_col + e);
      fma_row<NB>(rem, __ldg(rem_val + e), x, c, c >= 0 && c < n, B, j0, nb, vec4);
    }

    float* yr = y + i * B + j0;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (k < nb) yr[k] = __fadd_rn(dia[k], rem[k]);
    }
  }
}

template <typename V>
cudaError_t launch(const void* plane, const int* offsets, int n_diag, const int* rem_ptr,
                   const int* rem_col, const float* rem_val, const float* x, int B, float* y,
                   int m, int n, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((static_cast<int64_t>(m) + kThreads - 1) / kThreads);
  const V* p = static_cast<const V*>(plane);
  if (B == 1) {
    diahybrid_kernel<V, 1><<<blocks, kThreads, 0, stream>>>(p, offsets, n_diag, rem_ptr, rem_col,
                                                            rem_val, x, B, y, m, n);
  } else {
    diahybrid_kernel<V, kMaxCols><<<blocks, kThreads, 0, stream>>>(
        p, offsets, n_diag, rem_ptr, rem_col, rem_val, x, B, y, m, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// value_kind: 0 = float32, 1 = bfloat16.  plane: [n_diag, m]; offsets:
// [n_diag]; rem_ptr: [m + 1]; rem_col / rem_val: [rem_ptr[m]]; x: [n, B];
// y: [m, B].  m = 0 launches nothing.
int repro_spmv_diahybrid(int value_kind, const void* plane, const int* offsets, int n_diag,
                         const int* rem_ptr, const int* rem_col, const float* rem_val,
                         const float* x, int B, float* y, int m, int n, void* stream) {
  if (m < 0 || n < 0 || n_diag < 0 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (value_kind) {
    case 0:
      return static_cast<int>(launch<float>(plane, offsets, n_diag, rem_ptr, rem_col, rem_val,
                                            x, B, y, m, n, st));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(plane, offsets, n_diag, rem_ptr, rem_col,
                                                    rem_val, x, B, y, m, n, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_diahybrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
