// CSR-k tile SpMV / SpMM for NVIDIA Hopper (sm_90a).
//
// Replaces repro/kernels/spmv_csrk.py::spmv_csrk_tiles_pallas (the Pallas
// TPU kernel, vector and batched bodies) and computes what it computes: for
// tile t, output row r and column j,
//
//   y[t*R + r, j] = sum_s [lr[t,s] == r] * dq(vals[t,s]) * x[win_block[t]*W + lc[t,s], j]
//
// with dq the f32 upcast of bf16 or int8 code * val_scale[t, s / group], and
// every product and sum in f32.
//
// Bound: bytes.  SpMV does 2 flops per nonzero and column and reads 8-12
// bytes per nonzero, far below the card's ~20 flops per byte of float32
// balance, so the least time is the bytes the work must move over the
// memory rate.
//
// Design:
//   * One thread block per tile (super-super-row).  The Pallas kernel staged
//     a contiguous 2*W x-window per tile in VMEM and gathered from it with
//     one-hot matmuls on the MXU.  Here x is read directly from global memory
//     through the read-only cache: the per-tile window would re-read x once
//     per tile (it is most of the TPU design's modeled bytes), and at B=8 it
//     is larger than a block's shared memory, while the whole x of the suite
//     matrices fits in the 50 MB L2.
//   * Only the tile's real slots [0, tile_nnz[t]) are read: padding slots
//     hold value 0 and would add nothing.
//   * The per-row reduction is deterministic and uses no float atomics.  The
//     contributions of one chunk of slots are staged in shared memory; then
//     one thread per (row, column) sums that row's slots in slot order,
//     scanning only the slot range the row occupies (found with integer
//     shared-memory atomicMin/atomicMax, whose results do not depend on
//     order).  Two launches give the same bits, and column j of a [n, B]
//     launch is summed in the same order and with the same operations as a
//     [n] launch, so it is bit-equal to a B=1 launch on x[:, j].
//   * Reads of x past x_rows return 0 (the reference zero-pads x); rows
//     outside [0, R) are dropped (the one-hot reduce drops them).
//   * With tile_ids, tile t writes its rows at tile_ids[t]*R of y, which
//     folds the bucketed layout's row scatter into the kernel.
//
// Plain C interface (loaded with ctypes); the launch is asynchronous on the
// caller's stream and the function returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;  // slots whose loads a thread keeps in flight

__device__ __forceinline__ float load_value(const float* v, int64_t i, float) {
  return __ldg(v + i);
}

__device__ __forceinline__ float load_value(const __nv_bfloat16* v, int64_t i, float) {
  return __bfloat162float(v[i]);
}

__device__ __forceinline__ float load_value(const int8_t* v, int64_t i, float scale) {
  return __fmul_rn(static_cast<float>(__ldg(v + i)), scale);
}

template <typename V, bool kScaled>
__global__ void csrk_tiles_kernel(
    const V* __restrict__ vals, const int* __restrict__ lc, const int* __restrict__ lr,
    const int* __restrict__ win_block, const float* __restrict__ val_scale,
    int groups, int group, const int* __restrict__ tile_nnz,
    const int* __restrict__ tile_ids, int out_tiles, const float* __restrict__ x,
    long long x_rows, int B, float* __restrict__ y, int S, int R, int W, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* contrib = smem;                                  // [chunk * B]
  float* acc = contrib + chunk * B;                       // [R * B]
  int* slot_row = reinterpret_cast<int*>(acc + R * B);    // [chunk]
  int* row_lo = slot_row + chunk;                         // [R]
  int* row_hi = row_lo + R;                               // [R]

  const int t = blockIdx.x;
  const int64_t base = static_cast<int64_t>(t) * S;
  const int nslots = tile_nnz ? min(max(tile_nnz[t], 0), S) : S;
  const int64_t x0 = static_cast<int64_t>(win_block[t]) * W;
  const int RB = R * B;
  // x rows can be read as float4 when 16-byte aligned (contrib rows then are)
  const bool vec4 = B % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  for (int i = threadIdx.x; i < RB; i += blockDim.x) acc[i] = 0.f;

  for (int c0 = 0; c0 < nslots; c0 += chunk) {
    const int cn = min(chunk, nslots - c0);
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      row_lo[r] = INT_MAX;
      row_hi[r] = -1;
    }
    __syncthreads();

    // Phase 1: one f32 product per (slot, column), staged in slot order.  A
    // thread takes whole slots (all B columns: one contiguous x row each) and
    // issues the loads of kUnroll slots before using any of them.
    for (int s0 = threadIdx.x; s0 < cn; s0 += blockDim.x * kUnroll) {
      float v[kUnroll];
      int64_t col[kUnroll];
      int row[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * blockDim.x;
        col[u] = -1;
        if (s < cn) {
          const int64_t slot = base + c0 + s;
          const float scale =
              kScaled ? __ldg(val_scale + static_cast<int64_t>(t) * groups + (c0 + s) / group)
                      : 1.f;
          v[u] = load_value(vals, slot, scale);
          col[u] = x0 + __ldg(lc + slot);
          row[u] = __ldg(lr + slot);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * blockDim.x;
        if (s >= cn) continue;
        const bool in = col[u] >= 0 && col[u] < x_rows;
        const float* xr = x + (in ? col[u] : 0) * B;
        float* cr = contrib + s * B;
        if (vec4) {
          for (int j = 0; j < B; j += 4) {
            const float4 xv = in ? __ldg(reinterpret_cast<const float4*>(xr + j))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(cr + j) =
                make_float4(__fmul_rn(v[u], xv.x), __fmul_rn(v[u], xv.y),
                            __fmul_rn(v[u], xv.z), __fmul_rn(v[u], xv.w));
          }
        } else {
          for (int j = 0; j < B; ++j) cr[j] = __fmul_rn(v[u], in ? __ldg(xr + j) : 0.f);
        }
        const int r = row[u];
        slot_row[s] = r;
        if (r >= 0 && r < R) {
          atomicMin(&row_lo[r], s);
          atomicMax(&row_hi[r], s);
        }
      }
    }
    __syncthreads();

    // Phase 2: each (row, column) adds its slots in slot order.
    for (int w = threadIdx.x; w < RB; w += blockDim.x) {
      const int r = w / B;
      const int j = w - r * B;
      float a = acc[w];
      const int hi = row_hi[r];
      for (int s = row_lo[r]; s <= hi; ++s) {
        if (slot_row[s] == r) a = __fadd_rn(a, contrib[s * B + j]);
      }
      acc[w] = a;
    }
    __syncthreads();
  }

  const int home = tile_ids ? tile_ids[t] : t;
  if (home < 0 || home >= out_tiles) return;  // never write outside y
  const int64_t row0 = static_cast<int64_t>(home) * R;
  for (int w = threadIdx.x; w < RB; w += blockDim.x) y[row0 * B + w] = acc[w];
}

constexpr int kSmemBudget = 48 * 1024;  // no opt-in attribute needed below this
constexpr int kMaxChunk = 2048;

template <typename V, bool kScaled>
cudaError_t launch(const void* vals, const int* lc, const int* lr, const int* win_block,
                   const float* val_scale, int groups, const int* tile_nnz,
                   const int* tile_ids, int out_tiles, const float* x, long long x_rows,
                   int B, float* y, int T, int S, int R, int W, int chunk,
                   cudaStream_t stream) {
  const int threads = B == 1 ? 128 : 256;
  const size_t smem =
      static_cast<size_t>(chunk) * (B + 1) * 4 + static_cast<size_t>(R) * (B + 2) * 4;
  const int group = groups > 0 ? S / groups : 1;
  csrk_tiles_kernel<V, kScaled><<<T, threads, smem, stream>>>(
      static_cast<const V*>(vals), lc, lr, win_block, val_scale, groups, group, tile_nnz,
      tile_ids, out_tiles, x, x_rows, B, y, S, R, W, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Slots staged per chunk for this geometry, or 0 if even the smallest chunk
// does not fit the shared-memory budget.
int repro_csrk_chunk(int S, int R, int B) {
  const long long fixed = static_cast<long long>(R) * (B + 2) * 4;
  const long long per_slot = static_cast<long long>(B + 1) * 4;
  long long chunk = (kSmemBudget - fixed) / per_slot;
  chunk = chunk < kMaxChunk ? chunk : kMaxChunk;
  if (chunk > S) chunk = S > 0 ? S : 1;
  return chunk < 1 ? 0 : static_cast<int>(chunk);
}

// value_kind: 0 = float32, 1 = bfloat16, 2 = int8 (val_scale required).
int repro_spmv_csrk_tiles(int value_kind, const void* vals, const int* lc, const int* lr,
                          const int* win_block, const float* val_scale, int groups,
                          const int* tile_nnz, const int* tile_ids, int out_tiles,
                          const float* x, long long x_rows, int B, float* y, int T, int S,
                          int R, int W, void* stream) {
  const int chunk = repro_csrk_chunk(S, R, B);
  if (T <= 0 || chunk == 0 || B < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (value_kind) {
    case 0:
      err = launch<float, false>(vals, lc, lr, win_block, nullptr, 0, tile_nnz, tile_ids,
                                 out_tiles, x, x_rows, B, y, T, S, R, W, chunk, st);
      break;
    case 1:
      err = launch<__nv_bfloat16, false>(vals, lc, lr, win_block, nullptr, 0, tile_nnz,
                                         tile_ids, out_tiles, x, x_rows, B, y, T, S, R, W,
                                         chunk, st);
      break;
    case 2:
      if (val_scale == nullptr || groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
      err = launch<int8_t, true>(vals, lc, lr, win_block, val_scale, groups, tile_nnz,
                                 tile_ids, out_tiles, x, x_rows, B, y, T, S, R, W, chunk,
                                 st);
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
