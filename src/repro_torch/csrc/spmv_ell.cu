// ELL SpMV for NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/spmv_ell.py:29 spmv_ell_pallas (the Pallas TPU
// kernel of the ELL baseline, paper Sec. 2.3; vector only).  For every row
// i < m of the row-major [m, kmax] slab:
//
//   y[i] = sum_k vals[i, k] * x[col[i, k]]
//
// with f32 or bf16 values widened to f32, every product and sum in f32, and
// x[c] read as 0 for a column outside [0, n) (a well-formed slab has none).
// x and y are float32 or bfloat16 (one type for both, as the Pallas kernel
// stores y in x's dtype): a bf16 x is widened to f32 as it is read, and each
// row is rounded to bf16 once, when stored.
//
// Bound: bytes.  Every slot costs 6-8 bytes (value and column) for 2 flops,
// far below the card's ~20 flops per byte of float32 balance, so the least
// time is the slab, x and y over the memory rate.  Padding slots are part
// of the slab the function reads, so they count: ELL's cost is m * kmax,
// not nnz (the paper's point about ELL padding).
//
// Design (the SELL-C-σ kernel's, csrc/spmv_sellcs.cu, on the reference's
// own row-major slab; the port keeps no column-major copy):
//   * A row's slots are summed as 8 strands by 8 threads, four rows to a
//     warp.  The row is cut where its slots meet 16-byte boundaries: a head
//     of h < 4 slots up to the first boundary, 4-slot vectors, then a tail
//     of fewer than 4.  Strand l adds head slot l (l < h), then vectors l,
//     l + 8, l + 16, ... slot by slot in order with fused multiply-adds,
//     then tail slot l - 4 (4 <= l < 4 + tail); a fixed xor tree folds the
//     strands (l + 4, then l + 2, then l + 1).  h depends only on the row's
//     index, kmax and the column array's base address mod 16, so the order
//     is the same on every launch and repeat launches give the same bits;
//     the same slab copied to a base of another 16-byte phase (a view) may
//     be summed in another order and differ in its last bits, within the
//     bound.  Rows of
//     a kmax that is not a multiple of 4 (kmax 73 on stencil_fringe(2048):
//     rows 292 bytes apart) start at every phase and take their vectors all
//     the same.
//   * A vector is one 16-byte load of columns and one of values (16 bytes
//     of f32, 8 of bf16), not
//     allocated in L1, which is left to the x rows the gathers reuse.  A
//     thread issues the loads of a whole batch of its row (three vectors:
//     96 slots of a row in all, every row of bmwcra_1 and stencil_fringe)
//     before its first x gather.  x is read through the read-only path and
//     L2 (the Pallas row tile and the whole-x VMEM block are TPU idioms and
//     are not carried over).  Where the value array's phase (in slots, mod
//     4) differs from the column array's (a view that starts off a
//     boundary), the vectors are read slot by slot, in the same order.
//   * The grid holds as many blocks as fit on the card at once and each row
//     group walks rows i, i + stride, ...; the kernel is held to 64
//     registers, four blocks of 256 threads per SM.  Loading the next row's
//     batch ahead, or asking L2 to prefetch it, ran slower on the 2.45 GB
//     slab of stencil_fringe(2048) (PERF.md).
//   * Every slot is multiplied, padding (column 0, value 0) included, as in
//     the reference, so an inf or NaN at x[0] reaches the same rows.
//   * No atomics; lane 0 of the row's group writes it, every row is
//     written, so y need not be cleared.
//   * Slot offsets are 64-bit: m * kmax passes 2^31 at stencil_fringe(2048)
//     (306,184,192 slots, 2.4 GB of slab).
//
// Plain C interface (loaded with ctypes); the launch is asynchronous on the
// caller's stream and the function returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                          // strands (threads) per row
constexpr int kRowsPerBlock = kThreads / kLanes;
constexpr int kU = 3;                              // vectors a strand loads per batch

// Loads of the slab, read once: through the read-only path without
// allocating in L1, which is left to the x rows the gathers reuse.
__device__ __forceinline__ int4 ld_stream(const int4* p) {
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 r;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ uint2 ld_stream(const uint2* p) {
  uint2 r;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(r.x), "=r"(r.y) : "l"(p));
  return r;
}

// Four consecutive values from an aligned vector of the slab, widened to f32.
__device__ __forceinline__ float4 ld_vec(const float* p) {
  return ld_stream(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld_vec(const __nv_bfloat16* p) {
  const uint2 w = ld_stream(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

template <typename X>
__device__ __forceinline__ float x_at(const X* x, int c, int n) {
  return (c >= 0 && c < n) ? load_f32(x + c) : 0.f;
}

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ int get(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <typename V, typename X>
__global__ void __launch_bounds__(kThreads, 4)
ell_kernel(const int* __restrict__ col, const V* __restrict__ vals,
           const X* __restrict__ x, X* __restrict__ y, int m, int n, int kmax,
           int phase, bool vec) {
  const int lane = threadIdx.x % kLanes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kLanes;
  // a warp's rows are consecutive: it runs while its first row is in range,
  // so all 32 lanes take part in every shuffle
  int64_t warp_first = i - (threadIdx.x % 32) / kLanes;
  for (; warp_first < m; warp_first += stride, i += stride) {
    const bool active = i < m;
    const int64_t base = i * kmax;
    // head slots up to the row's first 16-byte boundary, vectors, tail
    const int h = active ? min(static_cast<int>((4 - ((phase + base) & 3)) & 3), kmax) : 0;
    const int nv = active ? (kmax - h) / 4 : 0;
    const int tail = active ? (kmax - h) % 4 : 0;
    const int* crow = col + base;
    const V* vrow = vals + base;

    // the head and tail slots are loaded with the first batch
    float hv = 0.f, tv = 0.f;
    int hc = 0, tc = 0;
    if (lane < h) {
      hv = load_f32(vrow + lane);
      hc = __ldg(crow + lane);
    }
    const bool has_tail = lane >= 4 && lane - 4 < tail;
    if (has_tail) {
      tv = load_f32(vrow + h + 4 * nv + lane - 4);
      tc = __ldg(crow + h + 4 * nv + lane - 4);
    }
    float acc = 0.f;
    if (nv == 0 && lane < h) acc = __fmaf_rn(hv, x_at(x, hc, n), acc);   // no vector
    for (int v0 = 0; v0 < nv; v0 += kU * kLanes) {
      float4 v[kU];
      int4 c[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int w = h + 4 * (v0 + lane + kLanes * u);
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        c[u] = make_int4(0, 0, 0, 0);
        if (v0 + lane + kLanes * u >= nv) continue;
        if (vec) {
          v[u] = ld_vec(vrow + w);
          c[u] = ld_stream(reinterpret_cast<const int4*>(crow + w));
        } else {
          v[u] = make_float4(load_f32(vrow + w), load_f32(vrow + w + 1), load_f32(vrow + w + 2),
                             load_f32(vrow + w + 3));
          c[u] = make_int4(__ldg(crow + w), __ldg(crow + w + 1), __ldg(crow + w + 2),
                           __ldg(crow + w + 3));
        }
      }
      if (v0 == 0 && lane < h) acc = __fmaf_rn(hv, x_at(x, hc, n), acc);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (v0 + lane + kLanes * u >= nv) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc = __fmaf_rn(get(v[u], e), x_at(x, get(c[u], e), n), acc);
      }
    }
    if (has_tail) acc = __fmaf_rn(tv, x_at(x, tc, n), acc);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off, kLanes));
    if (active && lane == 0) store_rounded(y + i, acc);
  }
}

// Blocks of one kernel instance that fit on the current card at once: the
// grid of a launch that walks the rows.
template <typename V, typename X>
int resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ell_kernel<V, X>, kThreads, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

template <typename V, typename X>
cudaError_t launch(const int* col, const void* vals, const void* x, void* y, int m, int n,
                   int kmax, cudaStream_t stream) {
  const long long cap = resident_blocks<V, X>();
  const long long need = (static_cast<long long>(m) + kRowsPerBlock - 1) / kRowsPerBlock;
  const uintptr_t c = reinterpret_cast<uintptr_t>(col), v = reinterpret_cast<uintptr_t>(vals);
  // the head is cut at the column array's 16-byte boundaries; vectors of
  // values need the value array at the same phase, in slots mod 4
  const int phase = static_cast<int>((c >> 2) & 3);
  const bool vec = (c & 3) == 0 && v % sizeof(V) == 0 && ((c / 4 - v / sizeof(V)) & 3) == 0;
  ell_kernel<V, X><<<static_cast<unsigned>(need < cap ? need : cap), kThreads, 0, stream>>>(
      col, static_cast<const V*>(vals), static_cast<const X*>(x), static_cast<X*>(y), m, n,
      kmax, phase, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// value_kind: 0 = float32, 1 = bfloat16; x_kind: 0 = float32, 1 = bfloat16,
// the type of x and of y.  col: [m, kmax] int32; vals: [m, kmax]; x: [n];
// y: [m].  m = 0 launches nothing.
int repro_spmv_ell(int value_kind, int x_kind, const int* col, const void* vals, const void* x,
                   void* y, int m, int n, int kmax, void* stream) {
  if (m < 0 || n < 0 || kmax < 0 || value_kind < 0 || value_kind > 1 || x_kind < 0 ||
      x_kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (value_kind == 0) {
    err = x_kind == 0 ? launch<float, float>(col, vals, x, y, m, n, kmax, st)
                      : launch<float, __nv_bfloat16>(col, vals, x, y, m, n, kmax, st);
  } else {
    err = x_kind == 0 ? launch<__nv_bfloat16, float>(col, vals, x, y, m, n, kmax, st)
                      : launch<__nv_bfloat16, __nv_bfloat16>(col, vals, x, y, m, n, kmax, st);
  }
  return static_cast<int>(err);
}

const char* repro_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
