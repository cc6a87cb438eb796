// CSR-k tile SpMV / SpMM for NVIDIA Hopper (sm_90a).
//
// Replaces repro/kernels/spmv_csrk.py::spmv_csrk_tiles_pallas (the Pallas
// TPU kernel, vector and batched bodies) and computes what it computes: for
// tile t, output row r and column j,
//
//   y[t*R + r, j] = sum_s [lr[t,s] == r] * dq(vals[t,s]) * x[win_block[t]*W + lc[t,s], j]
//
// with dq the f32 upcast of bf16 or int8 code * val_scale[t, s / group], and
// every product and sum in f32.  x and y are float32 or bfloat16 (one type
// for both, as the Pallas kernel stores y in x's dtype): a bf16 x is widened
// to f32 as it is read, and each row is rounded to bf16 once, when stored.
//
// Bound: bytes.  SpMV does 2 flops per nonzero and column and reads 8-12
// bytes per nonzero, far below the card's ~20 flops per byte of float32
// balance, so the least time is the bytes the work must move over the
// memory rate.  At B = 1 every x gather waits on its column load, so what
// sets the time is how many bytes each SM keeps in flight.
//
// Design:
//   * One thread block per tile (super-super-row), as in the paper's GPU
//     mapping.  The grid holds as many blocks as fit on the card at once and
//     each block walks tiles t, t + gridDim.x, ...; a tile's slot count,
//     window and home are fetched while the previous tile is summed, so the
//     slot loads are the first loads of a tile.  The Pallas kernel staged a
//     contiguous 2*W x-window per tile in VMEM and gathered from it with
//     one-hot matmuls on the MXU.  Here x is read directly from global memory
//     through the read-only cache: the per-tile window would re-read x once
//     per tile, and at B=8 it is larger than a block's shared memory, while
//     the whole x of the suite matrices fits in the 50 MB L2.
//   * Only the tile's real slots [0, tile_nnz[t]) are read: padding slots
//     hold value 0 and would add nothing.
//   * A pass covers up to 640 slots at B = 1 (128 threads x 5, held to 32
//     registers so that 16 blocks share an SM) and 768 at B > 1 (256
//     threads x 3), fewer where shared memory is short.
//     Every thread issues the loads of all its slots, at B = 1 also their x
//     gathers, then stages one f32 product per slot and column in shared
//     memory (__fmul_rn) with the slot's row.  On ecology1 (about 525 slots
//     per tile) a tile is one pass.
//   * Rows are summed without atomics.  The tiles that tiles_from_csrk
//     builds keep each tile's real slots in CSR order, so a row's slots are
//     contiguous: once the pass is staged, every thread marks where the rows
//     of its slots start (a slot whose row differs from the slot before it)
//     and the barrier after it votes whether the rows are sorted and in
//     [0, R).  Then one thread per (row, column) adds the row's products in
//     slot order from +0 with __fadd_rn.  A pass whose rows are not sorted
//     (the wrapper takes any local_row; a monolithic view read without
//     tile_nnz ends in padding slots of row 0) is summed by scanning all of
//     its slots for the row instead: the same sums in the same order, only
//     slower.  Rows outside [0, R) are dropped (the one-hot reduce drops
//     them).  Three barriers per pass.
//   * Each row's sum is the same chain of operations whatever the slot
//     order, B or launch: repeat launches are bit-equal, column j of an
//     [n, B] launch equals an [n] launch on x[:, j], and the output equals
//     ref.csrk_tile_rows_in_order bit for bit.
//   * int8 scales: one divide per pass, none per slot.
//   * Reads of x past x_rows return 0 (the reference zero-pads x).
//   * With tile_ids, tile t writes its rows at tile_ids[t]*R of y, which
//     folds the bucketed layout's row scatter into the kernel.
//
// Plain C interface (loaded with ctypes); the launch is asynchronous on the
// caller's stream and the function returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kSmemBudget = 48 * 1024;   // no opt-in attribute needed below this

// Threads per block and slots per thread per pass: B = 1 keeps each slot's
// product in a register until it is staged, B > 1 stages products as it goes.
__host__ __device__ constexpr int threads_for(bool one_col) { return one_col ? 128 : 256; }
__host__ __device__ constexpr int unroll_for(bool one_col) { return one_col ? 5 : 3; }

template <typename V>
__device__ __forceinline__ float load_value(const V* v, int64_t i) { return load_f32(v + i); }

__device__ __forceinline__ float load_value(const int8_t* v, int64_t i) {
  return static_cast<float>(__ldg(reinterpret_cast<const signed char*>(v) + i));
}

template <typename V, typename X, bool kScaled, bool kOneCol>
__global__ void __launch_bounds__(threads_for(kOneCol), kOneCol ? 16 : 6)
csrk_tiles_kernel(const V* __restrict__ vals, const int* __restrict__ lc,
                  const int* __restrict__ lr, const int* __restrict__ win_block,
                  const float* __restrict__ val_scale, int groups, int group,
                  const int* __restrict__ tile_nnz, const int* __restrict__ tile_ids,
                  int out_tiles, const X* __restrict__ x, long long x_rows, int B,
                  X* __restrict__ y, int T, int S, int R, int W, int chunk) {
  constexpr int kThreads = threads_for(kOneCol);
  constexpr int kU = unroll_for(kOneCol);
  extern __shared__ __align__(16) float smem[];
  float* prod = smem;                                    // [chunk * B]
  float* acc = prod + chunk * B;                         // [R * B]
  int* slot_row = reinterpret_cast<int*>(acc + R * B);   // [chunk]
  int* row_start = slot_row + chunk;                     // [R + 1]

  const int tid = threadIdx.x;
  const int RB = R * B;
  // x rows can be read four values at a time when aligned to four values
  // (prod rows then are 16-byte aligned)
  const bool x4 = !kOneCol && B % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(X) - 1)) == 0;

  for (int w = tid; w < RB; w += kThreads) acc[w] = 0.f;
  int t = blockIdx.x;
  int nslots_next = 0, win_next = 0, home_next = t;
  if (t < T) {
    nslots_next = tile_nnz ? __ldg(tile_nnz + t) : S;
    win_next = __ldg(win_block + t);
    if (tile_ids) home_next = __ldg(tile_ids + t);
  }
  for (; t < T; t += gridDim.x) {
    const int nslots = min(max(nslots_next, 0), S);
    const int64_t x0 = static_cast<int64_t>(win_next) * W;
    const int home = home_next;
    const int t_next = t + gridDim.x;
    if (t_next < T) {                    // the next tile's, while this one runs
      nslots_next = tile_nnz ? __ldg(tile_nnz + t_next) : S;
      win_next = __ldg(win_block + t_next);
      home_next = tile_ids ? __ldg(tile_ids + t_next) : t_next;
    }
    const int64_t base = static_cast<int64_t>(t) * S;
    const float* scales = kScaled ? val_scale + static_cast<int64_t>(t) * groups : nullptr;

    for (int c0 = 0; c0 < nslots; c0 += chunk) {
      const int cn = min(chunk, nslots - c0);
      // 1. the loads of all this thread's slots (B = 1: and their x gathers);
      //    staged once the previous pass's sums are done
      float v[kU];
      int col[kU], row[kU];
      int sg = 0, sr = 0;                // scale group and offset of slot c0 + tid
      if (kScaled) {
        sg = (c0 + tid) / group;
        sr = (c0 + tid) - sg * group;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = tid + u * kThreads;
        v[u] = 0.f;
        col[u] = 0;
        row[u] = -1;
        if (j < cn) {
          const int64_t slot = base + c0 + j;
          v[u] = load_value(vals, slot);
          if (kScaled) v[u] = __fmul_rn(v[u], __ldg(scales + sg));
          col[u] = __ldg(lc + slot);
          row[u] = __ldg(lr + slot);
        }
        if (kScaled) {
          for (sr += kThreads; sr >= group; sr -= group) ++sg;
        }
      }
      if (kOneCol) {                     // B = 1: the products stay in registers
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int64_t c = x0 + col[u];
          const bool in = c >= 0 && c < x_rows;
          if (tid + u * kThreads < cn) v[u] = __fmul_rn(v[u], in ? load_f32(x + c) : 0.f);
        }
      }
      __syncthreads();                   // the previous pass's sums are done
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = tid + u * kThreads;
        if (j >= cn) break;
        slot_row[j] = row[u];
        if (kOneCol) {
          prod[j] = v[u];
          continue;
        }
        const int64_t c = x0 + col[u];
        const bool in = c >= 0 && c < x_rows;
        const X* xr = x + (in ? c : 0) * B;
        float* pr = prod + j * B;
        if (x4) {
          for (int k = 0; k < B; k += 4) {
            const float4 xv = in ? load_f32x4(xr + k) : make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(pr + k) =
                make_float4(__fmul_rn(v[u], xv.x), __fmul_rn(v[u], xv.y),
                            __fmul_rn(v[u], xv.z), __fmul_rn(v[u], xv.w));
          }
        } else {
          for (int k = 0; k < B; ++k) pr[k] = __fmul_rn(v[u], in ? load_f32(xr + k) : 0.f);
        }
      }
      __syncthreads();

      // 2. where each row's slots start; vote whether the rows are sorted
      int unsorted = 0;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = tid + u * kThreads;
        if (j >= cn) break;
        const int r = row[u];
        const int before = j > 0 ? slot_row[j - 1] : -1;
        if (r < 0 || r >= R || before > r) {
          unsorted = 1;
          continue;
        }
        for (int q = max(before + 1, 0); q <= r; ++q) row_start[q] = j;
        if (j == cn - 1)
          for (int q = r + 1; q <= R; ++q) row_start[q] = cn;
      }
      unsorted = __syncthreads_or(unsorted);

      // 3. each (row, column) adds its products in slot order
      for (int w = tid; w < RB; w += kThreads) {
        const int r = w / B;
        const int k = w - r * B;
        float a = acc[w];
        if (!unsorted) {
          const int end = row_start[r + 1];
          for (int j = row_start[r]; j < end; ++j) a = __fadd_rn(a, prod[j * B + k]);
        } else {
          for (int j = 0; j < cn; ++j)
            if (slot_row[j] == r) a = __fadd_rn(a, prod[j * B + k]);
        }
        acc[w] = a;
      }
    }

    // each thread stores and clears the (row, column) sums it owns
    const bool home_ok = home >= 0 && home < out_tiles;   // never write outside y
    const int64_t out0 = static_cast<int64_t>(home) * R * B;
    for (int w = tid; w < RB; w += kThreads) {
      if (home_ok) store_rounded(y + out0 + w, acc[w]);
      acc[w] = 0.f;
    }
  }
}

// Blocks of one kernel instance that fit on the current card at once with
// smem bytes of shared memory each: the grid of a launch that walks the tiles.
template <typename V, typename X, bool kScaled, bool kOneCol>
int resident_blocks(int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, csrk_tiles_kernel<V, X, kScaled, kOneCol>, threads, smem);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

template <typename V, typename X, bool kScaled, bool kOneCol>
cudaError_t launch_cols(const void* vals, const int* lc, const int* lr, const int* win_block,
                        const float* val_scale, int groups, const int* tile_nnz,
                        const int* tile_ids, int out_tiles, const void* x, long long x_rows,
                        int B, void* y, int T, int S, int R, int W, int chunk,
                        cudaStream_t stream) {
  const int threads = threads_for(kOneCol);
  const size_t smem = 4 * ((static_cast<size_t>(chunk) + R) * (B + 1) + 1);
  const int group = groups > 0 ? S / groups : 1;
  const int cap = resident_blocks<V, X, kScaled, kOneCol>(threads, smem);
  csrk_tiles_kernel<V, X, kScaled, kOneCol><<<T < cap ? T : cap, threads, smem, stream>>>(
      static_cast<const V*>(vals), lc, lr, win_block, val_scale, groups, group, tile_nnz,
      tile_ids, out_tiles, static_cast<const X*>(x), x_rows, B, static_cast<X*>(y), T, S, R, W,
      chunk);
  return cudaGetLastError();
}

template <typename V, typename X, bool kScaled>
cudaError_t launch_x(const void* vals, const int* lc, const int* lr, const int* win_block,
                     const float* val_scale, int groups, const int* tile_nnz,
                     const int* tile_ids, int out_tiles, const void* x, long long x_rows,
                     int B, void* y, int T, int S, int R, int W, int chunk,
                     cudaStream_t stream) {
  if (B == 1)
    return launch_cols<V, X, kScaled, true>(vals, lc, lr, win_block, val_scale, groups,
                                            tile_nnz, tile_ids, out_tiles, x, x_rows, B, y, T,
                                            S, R, W, chunk, stream);
  return launch_cols<V, X, kScaled, false>(vals, lc, lr, win_block, val_scale, groups,
                                           tile_nnz, tile_ids, out_tiles, x, x_rows, B, y, T,
                                           S, R, W, chunk, stream);
}

// x_kind: 0 = float32, 1 = bfloat16 (x and y alike).
template <typename V, bool kScaled>
cudaError_t launch(int x_kind, const void* vals, const int* lc, const int* lr,
                   const int* win_block, const float* val_scale, int groups,
                   const int* tile_nnz, const int* tile_ids, int out_tiles, const void* x,
                   long long x_rows, int B, void* y, int T, int S, int R, int W, int chunk,
                   cudaStream_t stream) {
  switch (x_kind) {
    case 0:
      return launch_x<V, float, kScaled>(vals, lc, lr, win_block, val_scale, groups, tile_nnz,
                                         tile_ids, out_tiles, x, x_rows, B, y, T, S, R, W,
                                         chunk, stream);
    case 1:
      return launch_x<V, __nv_bfloat16, kScaled>(vals, lc, lr, win_block, val_scale, groups,
                                                 tile_nnz, tile_ids, out_tiles, x, x_rows, B, y,
                                                 T, S, R, W, chunk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Slots staged per pass for this geometry, or 0 if even one slot does not
// fit the shared-memory budget.
int repro_csrk_chunk(int S, int R, int B) {
  const long long fixed = 4LL * (static_cast<long long>(R) * (B + 1) + 1);
  const long long per_slot = 4LL * (B + 1);
  long long chunk = (kSmemBudget - fixed) / per_slot;
  const long long most = static_cast<long long>(threads_for(B == 1)) * unroll_for(B == 1);
  chunk = chunk < most ? chunk : most;
  if (chunk > S) chunk = S > 0 ? S : 1;
  return chunk < 1 ? 0 : static_cast<int>(chunk);
}

// value_kind: 0 = float32, 1 = bfloat16, 2 = int8 (val_scale required);
// x_kind: 0 = float32, 1 = bfloat16, the type of x and of y.
int repro_spmv_csrk_tiles(int value_kind, int x_kind, const void* vals, const int* lc,
                          const int* lr, const int* win_block, const float* val_scale,
                          int groups, const int* tile_nnz, const int* tile_ids, int out_tiles,
                          const void* x, long long x_rows, int B, void* y, int T, int S, int R,
                          int W, void* stream) {
  const int chunk = repro_csrk_chunk(S, R, B);
  if (T <= 0 || chunk == 0 || B < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (value_kind) {
    case 0:
      err = launch<float, false>(x_kind, vals, lc, lr, win_block, nullptr, 0, tile_nnz,
                                 tile_ids, out_tiles, x, x_rows, B, y, T, S, R, W, chunk, st);
      break;
    case 1:
      err = launch<__nv_bfloat16, false>(x_kind, vals, lc, lr, win_block, nullptr, 0,
                                         tile_nnz, tile_ids, out_tiles, x, x_rows, B, y, T, S,
                                         R, W, chunk, st);
      break;
    case 2:
      if (val_scale == nullptr || groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
      err = launch<int8_t, true>(x_kind, vals, lc, lr, win_block, val_scale, groups, tile_nnz,
                                 tile_ids, out_tiles, x, x_rows, B, y, T, S, R, W, chunk, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
