// ELL SpMV for NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/spmv_ell.py:29 spmv_ell_pallas (the Pallas TPU
// kernel of the ELL baseline, paper Sec. 2.3; vector only).  For every row
// i < m of the row-major [m, kmax] slab:
//
//   y[i] = sum_k vals[i, k] * x[col[i, k]]
//
// with f32 values, f32 x, every product and sum in f32, and x[c] read as 0
// for a column outside [0, n) (a well-formed slab has none).
//
// Bound: bytes.  Every slot costs 8 bytes (value and column) for 2 flops,
// far below the card's ~20 flops per byte of float32 balance, so the least
// time is the slab, x and y over the memory rate.  Padding slots are part
// of the slab the function reads, so they count: ELL's cost is m * kmax,
// not nnz (the paper's point about ELL padding).
//
// Design:
//   * A group of G lanes per row, G = 32 when kmax >= 32 and otherwise the
//     least power of two >= kmax.  Lane l of a group reads slots l, l + G,
//     l + 2G, ... of its row, so a group's loads of col and vals cover
//     neighbouring addresses and coalesce on the reference's own row-major
//     slab: the port keeps no column-major copy.  The Pallas row tile and
//     the whole-x VMEM block are TPU idioms and are not carried over; x is
//     gathered through L2.
//   * Every slot is multiplied, padding (column 0, value 0) included, as in
//     the reference, so an inf or NaN at x[0] reaches the same rows.
//   * Each lane sums its slots in increasing k, then the group folds its G
//     partials with __shfl_xor_sync in a fixed butterfly.  G depends only on
//     kmax, so the order is the same on every launch and repeat launches
//     give the same bits.  No atomics; lane 0 of the group writes its row,
//     every row is written, so y need not be cleared.
//   * Slot offsets are 64-bit: m * kmax passes 2^31 at stencil_fringe(2048)
//     (306,184,192 slots, 2.4 GB of slab).
//
// Plain C interface (loaded with ctypes); the launch is asynchronous on the
// caller's stream and the function returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void __launch_bounds__(kThreads)
ell_kernel(const int* __restrict__ col, const float* __restrict__ vals,
           const float* __restrict__ x, float* __restrict__ y, int m, int n, int kmax) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int lane = threadIdx.x % G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / G;
  const bool active = row < m;

  float acc = 0.f;
  if (active) {
    const int64_t base = row * kmax;
#pragma unroll 4
    for (int k = lane; k < kmax; k += G) {
      const int c = __ldg(col + base + k);
      const float v = __ldg(vals + base + k);
      const float xv = (c >= 0 && c < n) ? __ldg(x + c) : 0.f;
      acc = __fmaf_rn(v, xv, acc);
    }
  }
  // every lane of the warp takes part in the shuffles, rows past m too
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off, G));
  }
  if (active && lane == 0) y[row] = acc;
}

template <int G>
cudaError_t launch(const int* col, const float* vals, const float* x, float* y, int m, int n,
                   int kmax, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / G;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<int64_t>(m) + kRowsPerBlock - 1) / kRowsPerBlock);
  ell_kernel<G><<<blocks, kThreads, 0, stream>>>(col, vals, x, y, m, n, kmax);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// col: [m, kmax] int32; vals: [m, kmax] float32; x: [n]; y: [m].
// m = 0 launches nothing.
int repro_spmv_ell(const int* col, const float* vals, const float* x, float* y, int m, int n,
                   int kmax, void* stream) {
  if (m < 0 || n < 0 || kmax < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int group = 1;
  while (group < kmax && group < 32) group *= 2;
  switch (group) {
    case 1: return static_cast<int>(launch<1>(col, vals, x, y, m, n, kmax, st));
    case 2: return static_cast<int>(launch<2>(col, vals, x, y, m, n, kmax, st));
    case 4: return static_cast<int>(launch<4>(col, vals, x, y, m, n, kmax, st));
    case 8: return static_cast<int>(launch<8>(col, vals, x, y, m, n, kmax, st));
    case 16: return static_cast<int>(launch<16>(col, vals, x, y, m, n, kmax, st));
    default: return static_cast<int>(launch<32>(col, vals, x, y, m, n, kmax, st));
  }
}

const char* repro_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
