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
// for c outside [0, n), and every product and sum in f32.  x and y are
// float32 or bfloat16 (one type for both, as the Pallas kernel stores y in
// x's dtype): a bf16 x is widened to f32 as it is read, a row's plane part
// and remainder are added in f32, and the row is rounded to bf16 once, when
// stored.
//
// Bound: bytes.  The plane costs 4 (f32) or 2 (bf16) bytes per slot and the
// remainder 8 bytes per entry, for 2 flops per slot and column: far below
// the card's ~20 flops per byte of float32 balance, so the least time is the
// bytes the product must move over the memory rate.
//
// Design: one launch, two kinds of work on disjoint rows.  The rows that
// hold remainder entries are found through the port's row list
// (DIAHybridMatrix.rem_rows / rem_start / rem_mask), never through the
// remainder's all-rows row pointer (16.8 MB of 222.8 at stencil_fringe(2048)).
//   * Fringe groups.  Each listed row goes to a group of G lanes, a power of
//     two from 1 to 32 that the wrapper fixes from the shapes (about four
//     remainder entries a lane; 16 on stencil_fringe).  Lane l sums entries
//     l, l + G, ... in entry order, so a group's column and value loads
//     coalesce and its x gathers are in flight together, and a butterfly of
//     fixed shape joins the lanes.  Lane l also loads diagonals l, l + G,
//     ... of the row; the group's shuffles hand them round, and every lane
//     sums the plane part over k in increasing order: one round trip for
//     the plane part instead of one per diagonal.  Lane 0 writes y = plane +
//     remainder.  In the one-thread-per-row design these rows held their
//     warps for 64 serial entries and took half the call.
//   * The plane pass, every row whose rem_mask bit is clear.  At B = 1 a
//     thread takes 16 bytes of each diagonal: 4 consecutive rows (f32) or 8
//     (bf16), one 16-byte load per diagonal when the plane rows are 16-byte
//     aligned (m a multiple of 4 or 8 and an aligned base), otherwise the
//     same rows with scalar loads.  The loads of kDiagBatch diagonals are
//     issued before their products are summed.  x comes in aligned loads
//     of four values (float4, or 8 bytes of bf16) shifted by the diagonal's
//     offset mod 4, the same for the whole warp (scalar loads at the
//     matrix's edges), and y goes out in stores of four values.  At B > 1 a
//     thread takes one row and 8 columns per pass.
//   * Fringe blocks are spread over the grid, one block in 2^s from block
//     0 (s as large as lets them all in), so the fringe's gathers run beside
//     the plane stream from the start.
//   * The plane, the remainder's columns and values skip L1
//     (ld.global.nc.L1::no_allocate), which keeps L1 for x.  An L2
//     evict-first policy on them measured no faster and is not used.
//   * The offsets come from the device array (DIAHybridMatrix.offset_vec,
//     built once with the container), so a call uploads nothing and a CUDA
//     graph can capture it; passing up to 64 of them by value in the
//     kernel's parameters measured no faster.
//   * Bounded reads take the place of the reference's zero `lead` margin:
//     x[c] is read only for 0 <= c < n, so x needs no padded copy per call.
//     Every in-range plane slot is multiplied, a 0 value included, so an inf
//     or NaN in x reaches exactly the rows it reaches in the reference.
//   * One fixed order, no float atomics, each y row written once: the plane
//     in f32 over k in increasing order from 0 (fused multiply-adds), then,
//     for a listed row, its remainder added.  A row's order depends only on
//     the container (G comes from its shapes), never on B or on which rows
//     share a thread, so repeat launches are bit-equal and column j of an
//     [n, B] launch equals an [n] launch on x[:, j].
//   * Registers: 256-thread blocks held to 64 registers a thread
//     (__launch_bounds__(256, 4)) at every B, with no spills; at B > 1 the
//     80 registers the compiler chose unbounded ran slower.
//
// Plain C interface (loaded with ctypes); the launch is asynchronous on the
// caller's stream and the function returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;          // columns a thread sums per pass at B > 1
constexpr int kDiagBatch = 3;        // diagonals whose loads a plane thread issues together
constexpr int kRemUnroll = 4;        // remainder entries a fringe lane loads together at B = 1

// Rows a plane thread takes at B = 1: 16 bytes of each diagonal.
template <typename V>
__host__ __device__ constexpr int rows_per_thread() {
  return 16 / sizeof(V);
}

// Streamed loads: not kept in L1.
__device__ __forceinline__ float ld_stream(const float* p) {
  float r;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(r) : "l"(p));
  return r;
}

__device__ __forceinline__ int ld_stream(const int* p) {
  int r;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}

__device__ __forceinline__ float ld_stream(const __nv_bfloat16* p) {
  unsigned short r;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(r) : "l"(p));
  return __uint_as_float(static_cast<unsigned>(r) << 16);
}

// RPT = 16 / sizeof(V) plane values from one aligned 16-byte vector.
template <typename V, int RPT>
__device__ __forceinline__ void ld_plane_vec(float (&v)[RPT], const V* p) {
  static_assert(RPT * sizeof(V) == 16, "plane vectors are 16 bytes");
  unsigned u[4];
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3]) : "l"(p));
  if constexpr (sizeof(V) == 4) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) v[r] = __uint_as_float(u[r]);
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const unsigned h = r % 2 ? u[r / 2] >> 16 : u[r / 2] & 0xffffu;
      v[r] = __uint_as_float(h << 16);
    }
  }
}

// xs[k] = x[c, j0 + k] for the nb columns of this pass, 0 off the matrix
// (c outside [0, n)); loads of four values when the row of x is aligned to
// four values.
template <int NB, typename X>
__device__ __forceinline__ void load_x(float (&xs)[NB], const X* __restrict__ x, int64_t c,
                                       bool in, int B, int j0, int nb, bool vec4) {
  const X* xr = x + (in ? c : 0) * B + j0;
  if (NB > 1 && vec4 && nb == NB) {
#pragma unroll
    for (int k = 0; k < NB; k += 4) {
      const float4 f = in ? load_f32x4(xr + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      xs[k] = f.x;
      xs[k + 1] = f.y;
      xs[k + 2] = f.z;
      xs[k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NB; ++k) xs[k] = in && k < nb ? load_f32(xr + k) : 0.f;
  }
}

// acc[k] += v * x[c, j0 + k] for the nb columns of this pass.
template <int NB, typename X>
__device__ __forceinline__ void fma_row(float (&acc)[NB], float v, const X* __restrict__ x,
                                        int64_t c, bool in, int B, int j0, int nb, bool vec4) {
  float xs[NB];
  load_x<NB>(xs, x, c, in, B, j0, nb, vec4);
#pragma unroll
  for (int k = 0; k < NB; ++k) acc[k] = __fmaf_rn(v, xs[k], acc[k]);
}

// y[row, j0 + k] = val[k] for the nb columns of this pass.
template <int NB, typename Y>
__device__ __forceinline__ void store_row(Y* yr, const float (&val)[NB], int nb, bool vec4) {
  if (NB > 1 && vec4 && nb == NB) {
#pragma unroll
    for (int k = 0; k < NB; k += 4)
      store_rounded4(yr + k, val[k], val[k + 1], val[k + 2], val[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (k < nb) store_rounded(yr + k, val[k]);
    }
  }
}

struct Args {
  const void* plane;        // [n_diag, m] f32 | bf16
  const int* offsets;       // [n_diag]
  int n_diag;
  const int* rem_rows;      // [R]
  const int* rem_start;     // [R + 1]
  const unsigned* rem_mask; // [ceil(m / 32)]
  const int* rem_col;
  const float* rem_val;
  int R;
  int lanes_log2;           // G = 1 << lanes_log2 lanes per listed row
  int fringe_blocks;        // blocks that run the fringe groups
  int fringe_shift;         // one block in 2^fringe_shift is a fringe block
  const void* x;            // [n, B] f32 | bf16
  int B;
  void* y;                  // [m, B], x's type
  int m;
  int n;
  bool vec_plane;           // vector plane loads (aligned plane rows)
  bool vec_x;               // B % 4 == 0 and x aligned to four values
  bool x_aligned;           // x aligned to four values
  bool vec_y;               // B % 4 == 0 (or B = 1) and y aligned to four values
};

// One listed row per group of G lanes.  Lane l sums remainder entries l,
// l + G, ... in entry order and loads diagonals l, l + G, ...; every lane of
// the group then sums the plane products over k in increasing order from
// the group's shuffles, a butterfly joins the remainder, lane 0 writes.
template <typename V, typename X, int NB>
__device__ __forceinline__ void fringe_group(const Args& a, int64_t block) {
  const int G = 1 << a.lanes_log2;
  const int64_t t = block * kThreads + threadIdx.x;
  const int64_t j = t >> a.lanes_log2;
  const int lane = static_cast<int>(t & (G - 1));
  const bool valid = j < a.R;  // lanes past the list still join the shuffles
  const int64_t i = valid ? __ldg(a.rem_rows + j) : 0;
  const int e0 = valid ? __ldg(a.rem_start + j) : 0;
  const int e1 = valid ? __ldg(a.rem_start + j + 1) : 0;
  const V* plane = static_cast<const V*>(a.plane);
  const X* x = static_cast<const X*>(a.x);

  for (int j0 = 0; j0 < a.B; j0 += NB) {
    const int nb = min(NB, a.B - j0);
    float dia[NB];
    float rem[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) dia[k] = rem[k] = 0.f;
#pragma unroll (NB == 1 ? kRemUnroll : 2)
    for (int e = e0 + lane; e < e1; e += G) {
      const int64_t c = ld_stream(a.rem_col + e);
      fma_row<NB>(rem, ld_stream(a.rem_val + e), x, c, c >= 0 && c < a.n, a.B, j0, nb,
                  a.vec_x);
    }
    for (int k0 = 0; k0 < a.n_diag; k0 += G) {  // the same trip count in every lane
      const int k = k0 + lane;
      const bool have = valid && k < a.n_diag;
      const int64_t c = i + (have ? __ldg(a.offsets + k) : 0);
      const float v = have ? ld_stream(plane + static_cast<int64_t>(k) * a.m + i) : 0.f;
      float xs[NB];
      load_x<NB>(xs, x, c, have && c >= 0 && c < a.n, a.B, j0, nb, a.vec_x);
      const int count = min(G, a.n_diag - k0);
      for (int u = 0; u < count; ++u) {
        const float vu = __shfl_sync(0xffffffffu, v, u, G);
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          dia[q] = __fmaf_rn(vu, __shfl_sync(0xffffffffu, xs[q], u, G), dia[q]);
        }
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int q = 0; q < NB; ++q) rem[q] += __shfl_xor_sync(0xffffffffu, rem[q], o);
    }
    if (valid && lane == 0) {
      float out[NB];
#pragma unroll
      for (int q = 0; q < NB; ++q) out[q] = __fadd_rn(dia[q], rem[q]);
      store_row<NB>(static_cast<X*>(a.y) + i * a.B + j0, out, nb, a.vec_y);
    }
  }
}

// xv[r] = x[c0 + r] for r < RPT (0 off [0, n)), c0 = i0 + off with i0 a
// multiple of 4: aligned loads of four values (16 bytes of f32, 8 of bf16)
// and a shift by c0 mod 4, which is the same for the whole warp.
template <int RPT, typename X>
__device__ __forceinline__ void x_window(float (&xv)[RPT], const X* __restrict__ x,
                                         int64_t c0, int n) {
  const int s = static_cast<int>(c0 & 3);
  const int64_t a0 = c0 - s;
  constexpr int W = RPT + 4;
  if (a0 >= 0 && a0 + W <= n) {
    float w[W];
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      if (q * 4 < s + RPT) {
        const float4 f = load_f32x4(x + a0 + 4 * q);
        w[4 * q] = f.x;
        w[4 * q + 1] = f.y;
        w[4 * q + 2] = f.z;
        w[4 * q + 3] = f.w;
      } else {
        w[4 * q] = w[4 * q + 1] = w[4 * q + 2] = w[4 * q + 3] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      xv[r] = s == 0 ? w[r] : s == 1 ? w[r + 1] : s == 2 ? w[r + 2] : w[r + 3];
    }
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int64_t c = c0 + r;
      xv[r] = c >= 0 && c < n ? load_f32(x + c) : 0.f;
    }
  }
}

// RPT consecutive rows per thread (NB columns each) whose mask bit is clear.
template <typename V, typename X, int RPT, int NB>
__device__ __forceinline__ void plane_rows(const Args& a, int64_t block) {
  const int64_t i0 = (block * kThreads + threadIdx.x) * RPT;
  if (i0 >= a.m) return;
  constexpr unsigned kAll = RPT == 32 ? ~0u : (1u << RPT) - 1;
  // RPT divides 32, so the RPT rows' bits lie in one mask word
  const unsigned skip = (__ldg(a.rem_mask + (i0 >> 5)) >> (i0 & 31)) & kAll;
  if (skip == kAll) return;
  const int64_t left = a.m - i0;
  const int rows = left < RPT ? static_cast<int>(left) : RPT;
  const V* plane = static_cast<const V*>(a.plane);
  const X* x = static_cast<const X*>(a.x);
  X* y = static_cast<X*>(a.y);
  const bool vec = RPT > 1 && a.vec_plane;  // then rows == RPT

  for (int j0 = 0; j0 < a.B; j0 += NB) {
    const int nb = min(NB, a.B - j0);
    float acc[RPT][NB];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
#pragma unroll
      for (int k = 0; k < NB; ++k) acc[r][k] = 0.f;
    }
    for (int k0 = 0; k0 < a.n_diag; k0 += kDiagBatch) {
      float v[kDiagBatch][RPT];
#pragma unroll
      for (int u = 0; u < kDiagBatch; ++u) {
        if (k0 + u >= a.n_diag) break;
        const V* p = plane + static_cast<int64_t>(k0 + u) * a.m + i0;
        bool loaded = false;
        if constexpr (RPT * sizeof(V) == 16) {
          if (vec) {
            ld_plane_vec<V, RPT>(v[u], p);
            loaded = true;
          }
        }
        if (!loaded) {
#pragma unroll
          for (int r = 0; r < RPT; ++r) v[u][r] = r < rows ? ld_stream(p + r) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kDiagBatch; ++u) {
        if (k0 + u >= a.n_diag) break;
        const int off = __ldg(a.offsets + k0 + u);
        if constexpr (NB == 1 && RPT % 4 == 0) {
          if (a.x_aligned) {
            float xv[RPT];
            x_window<RPT>(xv, x, i0 + off, a.n);
#pragma unroll
            for (int r = 0; r < RPT; ++r) acc[r][0] = __fmaf_rn(v[u][r], xv[r], acc[r][0]);
            continue;
          }
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int64_t c = i0 + r + off;
          fma_row<NB>(acc[r], v[u][r], x, c, c >= 0 && c < a.n, a.B, j0, nb, a.vec_x);
        }
      }
    }
    if (NB == 1 && RPT % 4 == 0 && vec && a.vec_y && skip == 0) {
#pragma unroll
      for (int r = 0; r < RPT; r += 4)
        store_rounded4(y + i0 + r, acc[r][0], acc[r + 1][0], acc[r + 2][0], acc[r + 3][0]);
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (r < rows && !((skip >> r) & 1u))
          store_row<NB>(y + (i0 + r) * a.B + j0, acc[r], nb, a.vec_y);
      }
    }
  }
}

template <typename V, typename X, int NB>
__global__ void __launch_bounds__(kThreads, 4) diahybrid_kernel(const __grid_constant__ Args a) {
  // the fringe blocks are blocks 0, 2^s, 2 * 2^s, ... until all are placed
  const unsigned b = blockIdx.x;
  const unsigned F = a.fringe_blocks;
  const unsigned s = a.fringe_shift;
  if ((b & ((1u << s) - 1)) == 0 && (b >> s) < F) {
    fringe_group<V, X, NB>(a, b >> s);
  } else {
    const unsigned before = (b + (1u << s) - 1) >> s;
    plane_rows<V, X, NB == 1 ? rows_per_thread<V>() : 1, NB>(a, b - (before < F ? before : F));
  }
}

template <typename V, typename X>
cudaError_t launch(Args a, cudaStream_t stream) {
  const int64_t rpt = a.B == 1 ? rows_per_thread<V>() : 1;  // rows per plane thread
  const int64_t group_threads = static_cast<int64_t>(a.R) << a.lanes_log2;
  a.fringe_blocks = static_cast<int>((group_threads + kThreads - 1) / kThreads);
  const int64_t plane_blocks = (a.m + kThreads * rpt - 1) / (kThreads * rpt);
  const int64_t blocks = a.fringe_blocks + plane_blocks;
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  a.fringe_shift = 0;
  while (a.fringe_blocks > 0 &&
         (static_cast<int64_t>(a.fringe_blocks) << (a.fringe_shift + 1)) <= blocks &&
         a.fringe_shift < 30) {
    ++a.fringe_shift;
  }
  a.vec_plane = a.vec_plane && a.m % rpt == 0;
  if (a.B == 1) {
    diahybrid_kernel<V, X, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  } else {
    diahybrid_kernel<V, X, kMaxCols><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// value_kind: 0 = float32, 1 = bfloat16; x_kind: 0 = float32, 1 = bfloat16,
// the type of x and of y.  plane: [n_diag, m]; offsets:
// [n_diag] on the device; rem_rows: [R]; rem_start: [R + 1]; rem_mask:
// [ceil(m / 32)]; rem_col / rem_val: [rem_start[R]]; lanes_log2 in [0, 5];
// x: [n, B]; y: [m, B].  m = 0 launches nothing.
int repro_spmv_diahybrid(int value_kind, int x_kind, const void* plane, const int* offsets,
                         int n_diag, const int* rem_rows, const int* rem_start,
                         const int* rem_mask, const int* rem_col, const float* rem_val, int R,
                         int lanes_log2, const void* x, int B, void* y, int m, int n,
                         void* stream) {
  if (m < 0 || n < 0 || n_diag < 0 || R < 0 || R > m || B < 1 || lanes_log2 < 0 ||
      lanes_log2 > 5 || x_kind < 0 || x_kind > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  Args a{};
  a.plane = plane;
  a.offsets = offsets;
  a.n_diag = n_diag;
  a.rem_rows = rem_rows;
  a.rem_start = rem_start;
  a.rem_mask = reinterpret_cast<const unsigned*>(rem_mask);
  a.rem_col = rem_col;
  a.rem_val = rem_val;
  a.R = R;
  a.lanes_log2 = lanes_log2;
  a.x = x;
  a.B = B;
  a.y = y;
  a.m = m;
  a.n = n;
  // four values of x or y: 16 bytes of f32, 8 of bf16
  const uintptr_t four = x_kind == 0 ? 15 : 7;
  a.vec_plane = (reinterpret_cast<uintptr_t>(plane) & 15) == 0;
  a.vec_x = B % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & four) == 0;
  a.x_aligned = (reinterpret_cast<uintptr_t>(x) & four) == 0;
  a.vec_y = (B == 1 || B % 4 == 0) && (reinterpret_cast<uintptr_t>(y) & four) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16_x = x_kind == 1;
  switch (value_kind) {
    case 0:
      return static_cast<int>(bf16_x ? launch<float, __nv_bfloat16>(a, st)
                                     : launch<float, float>(a, st));
    case 1:
      return static_cast<int>(bf16_x ? launch<__nv_bfloat16, __nv_bfloat16>(a, st)
                                     : launch<__nv_bfloat16, float>(a, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_diahybrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
