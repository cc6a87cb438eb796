// Segmented-sum SpMV / SpMM for NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/spmv_segsum.py:101 spmv_segsum_pallas (the
// Pallas TPU kernel, vector and batched bodies) together with the carry
// scatter-add the reference runs after it (repro/kernels/ops.py
// spmv_segsum): for every row i and column j,
//
//   y[i, j] = sum over the slots s of row i of dq(vals[s]) * x[col[s], j]
//
// where the slots are the nnz stream cut into T chunks of S slots with no
// regard for row boundaries, dq is the f32 upcast of bf16 or int8 code *
// val_scale[t, s / group], and every product and sum is in f32.  Rows no
// slot belongs to (empty rows) come out 0.
//
// Bound: bytes.  SpMV does 2 flops per slot and column and reads 9-12
// bytes per slot, far below the card's ~20 flops per byte of float32
// balance, so the least time is the bytes the work must move over the
// memory rate.
//
// Design: two launches on the caller's stream.
//   * Chunk pass, one block of 128 threads per chunk.  Only the chunk's
//     real slots [0, n_t) are read, n_t = min(S, nnz - t*S): the tail
//     chunk's padding slots are skipped, not multiplied by x[0].  The
//     block loads the chunk's local segment ids into shared memory and
//     finds where each segment starts.  Then each thread loads values and
//     columns of slots tid, tid+128, ... (coalesced, four slots in flight
//     per thread), gathers x through the read-only path and L2 (x is not
//     staged), and writes the products to shared memory.  Then one warp
//     per segment sums them: lane l adds the segment's slots l, l+32, ...
//     in increasing order, then a fixed shuffle tree sums the lanes.
//   * A segment whose row lies wholly in the chunk is written straight to
//     y.  A segment that continues from the previous chunk (only segment 0
//     can) or into the next one (only the last real segment can) is a
//     fragment: its sum goes to part[t, 0] (segment 0) or part[t, 1] (the
//     last segment), and nothing is written to y.  Only the real segments
//     are visited: R counts the worst chunk's segments, most chunks have
//     far fewer, and the unused ones (seg_row == m) are never read.
//   * The same warps write 0 to the rows between one segment's row and the
//     next (and, in the last chunk, after the last row; with no nnz, all
//     rows).  So every row of y is written exactly once and y needs no
//     clearing: empty rows are 0 whatever the memory held before.
//   * Carry pass, one warp per row that spans chunks, from the container's
//     carry list (row, first fragment, last chunk; built on the host with
//     the chunks), so the pass never walks chunk boundaries.  The warp sums
//     the row's fragments as a segment is summed (lane-strided, then the
//     shuffle tree) and writes y[row]: the hub row of a power-law matrix
//     has a hundred fragments.
//   * Deterministic sums, no float atomics: every sum is taken in an order
//     fixed by the matrix alone.  Column j takes the same operations in the
//     same order whatever B is, so repeat launches are bit-equal and column
//     j of an [n, B] launch equals an [n] launch on x[:, j].  At B > 1 the
//     block takes up to 8 columns per pass.
//
// Plain C interface (loaded with ctypes); the launches are asynchronous on
// the caller's stream and the function returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;             // chunk pass: four warps per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                // slots whose loads a thread keeps in flight
constexpr int kMaxCols = 8;               // columns a block sums per pass at B > 1
constexpr int kCarryThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;   // above this, dynamic shared memory needs opt-in

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

// Real slots of chunk t.
__device__ __forceinline__ int real_slots(int t, int S, long long nnz) {
  const long long left = nnz - static_cast<long long>(t) * S;
  return left <= 0 ? 0 : (left < S ? static_cast<int>(left) : S);
}

// Zero rows [lo, hi) of y, columns [j0, j0 + nb), one warp.
__device__ __forceinline__ void zero_rows(float* y, int lo, int hi, int B, int j0, int nb,
                                          int lane) {
  for (int r = lo + lane; r < hi; r += 32) {
    for (int k = 0; k < nb; ++k) y[static_cast<int64_t>(r) * B + j0 + k] = 0.f;
  }
}

template <typename V, bool kScaled, int NB>
__global__ void __launch_bounds__(kThreads)
segsum_chunk_kernel(const V* __restrict__ vals, const int* __restrict__ cols,
                    const int* __restrict__ lseg, const int* __restrict__ seg_row,
                    const float* __restrict__ val_scale, int groups, int group,
                    const float* __restrict__ x, long long x_rows, int B,
                    float* __restrict__ y, float* __restrict__ part, int m, int T, int S,
                    int R, long long nnz) {
  extern __shared__ float smem[];
  float* prod = smem;                                   // [NB][S] slot products
  int* seg = reinterpret_cast<int*>(prod + S * NB);     // [S] local segment ids
  int* start = seg + S;                                 // [S + 1] segment starts
  __shared__ int s_prev_row, s_next_row;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(t) * S;
  const int n_t = real_slots(t, S, nnz);

  // 1. segment structure of the chunk
  for (int s = tid; s < n_t; s += kThreads) seg[s] = __ldg(lseg + base + s);
  if (tid == 0) {
    // last row of the previous chunk (full, so its last slot is real) and
    // first row of the next chunk; -1 where there is none
    s_prev_row = t > 0 ? __ldg(seg_row + static_cast<int64_t>(t - 1) * R +
                               __ldg(lseg + base - 1))
                       : -1;
    s_next_row = t + 1 < T ? __ldg(seg_row + static_cast<int64_t>(t + 1) * R) : -1;
  }
  __syncthreads();
  for (int s = tid; s < n_t; s += kThreads) {
    const int k = seg[s];
    if ((s == 0 || k != seg[s - 1]) && k >= 0 && k < S) start[k] = s;
  }
  const int L = n_t > 0 ? min(min(seg[n_t - 1] + 1, R), n_t) : 0;   // real segments
  if (tid == 0) start[L] = n_t;
  __syncthreads();
  const int prev_row = s_prev_row;
  const int next_row = s_next_row;

  // vec4: x rows can be read as float4
  const bool vec4 = NB == 8 && B % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int j0 = 0; j0 < B; j0 += NB) {
    const int nb = min(NB, B - j0);

    // 2. products of the real slots
    for (int s0 = tid; s0 < n_t; s0 += kThreads * kUnroll) {
      float v[kUnroll];
      int64_t col[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * kThreads;
        v[u] = 0.f;
        col[u] = -1;
        if (s < n_t) {
          const float scale = kScaled ? __ldg(val_scale + t * static_cast<int64_t>(groups) +
                                              s / group)
                                      : 1.f;
          v[u] = load_value(vals, base + s, scale);
          col[u] = __ldg(cols + base + s);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * kThreads;
        if (s >= n_t) break;
        const bool in = col[u] >= 0 && col[u] < x_rows;
        const float* xr = x + (in ? col[u] : 0) * B + j0;
        float* p = prod + s;   // column k at p[k * S]: a warp's lanes hit distinct banks
        if (NB == 1) {
          p[0] = __fmul_rn(v[u], in ? __ldg(xr) : 0.f);
        } else if (vec4 && nb == NB) {
#pragma unroll
          for (int k = 0; k < NB; k += 4) {
            const float4 xv = in ? __ldg(reinterpret_cast<const float4*>(xr + k))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            p[k * S] = __fmul_rn(v[u], xv.x);
            p[(k + 1) * S] = __fmul_rn(v[u], xv.y);
            p[(k + 2) * S] = __fmul_rn(v[u], xv.z);
            p[(k + 3) * S] = __fmul_rn(v[u], xv.w);
          }
        } else {
#pragma unroll
          for (int k = 0; k < NB; ++k) {
            if (k < nb) p[k * S] = __fmul_rn(v[u], in ? __ldg(xr + k) : 0.f);
          }
        }
      }
    }
    __syncthreads();

    // 3. one warp per real segment
    for (int k = warp; k < L; k += kWarps) {
      const int row = __ldg(seg_row + static_cast<int64_t>(t) * R + k);
      const int lo = start[k], hi = start[k + 1];
      float acc[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) acc[c] = 0.f;
      for (int s = lo + lane; s < hi; s += 32) {
#pragma unroll
        for (int c = 0; c < NB; ++c) acc[c] = __fadd_rn(acc[c], prod[c * S + s]);
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) acc[c] = warp_sum(acc[c]);
      if (row < 0 || row >= m) continue;   // dump row (a malformed container only)

      const bool head = k == 0 && row == prev_row;
      const bool tail = k == L - 1 && row == next_row;
      if (lane == 0) {
        float* dst = (head || tail)
                         ? part + (static_cast<int64_t>(t) * 2 + (k == 0 ? 0 : 1)) * B
                         : y + static_cast<int64_t>(row) * B;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          if (c < nb) dst[j0 + c] = acc[c];
        }
      }
      // empty rows before this segment's row; after the last row in the last chunk
      const int before = k == 0 ? prev_row
                                : __ldg(seg_row + static_cast<int64_t>(t) * R + k - 1);
      zero_rows(y, max(before + 1, 0), row, B, j0, nb, lane);
      if (t == T - 1 && k == L - 1) zero_rows(y, row + 1, m, B, j0, nb, lane);
    }
    if (L == 0 && t == T - 1 && warp == 0) {
      zero_rows(y, max(prev_row + 1, 0), m, B, j0, nb, lane);   // no real slot left
    }
    __syncthreads();   // prod is rewritten by the next column group
  }
}

// One warp per row that spans chunks: carry[i] = (row, first fragment slot
// 2*c0 + side, last chunk c1).  The row's fragments are f = 0 (part[first])
// and f = 1 .. c1 - c0 (segment 0 of chunk c0 + f).  Lane l adds fragments
// l, l+32, ... in increasing order, then the fixed shuffle tree sums the
// lanes: the hub row's hundred fragments cost four loads per lane, not a
// hundred dependent ones.
__global__ void __launch_bounds__(kCarryThreads)
segsum_carry_kernel(const int* __restrict__ carry, int P, const float* __restrict__ part,
                    float* __restrict__ y, int B, int T, int m) {
  const int i = blockIdx.x * (kCarryThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= P) return;   // the whole warp leaves together
  const int row = __ldg(carry + 3 * static_cast<int64_t>(i));
  const int first = __ldg(carry + 3 * static_cast<int64_t>(i) + 1);
  const int last = __ldg(carry + 3 * static_cast<int64_t>(i) + 2);
  const int c0 = first >> 1;
  if (row < 0 || row >= m || first < 0 || last >= T || c0 >= last) return;
  for (int j0 = 0; j0 < B; j0 += kMaxCols) {
    const int nb = min(kMaxCols, B - j0);
    float acc[kMaxCols];
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.f;
    for (int f = lane; f <= last - c0; f += 32) {
      const float* p = part + static_cast<int64_t>(f == 0 ? first : 2 * (c0 + f)) * B + j0;
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        if (k < nb) acc[k] = __fadd_rn(acc[k], p[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      acc[k] = warp_sum(acc[k]);
      if (lane == 0 && k < nb) y[static_cast<int64_t>(row) * B + j0 + k] = acc[k];
    }
  }
}

template <typename V, bool kScaled, int NB>
cudaError_t launch_chunks(const void* vals, const int* cols, const int* lseg, const int* seg_row,
                          const float* val_scale, int groups, const float* x,
                          long long x_rows, int B, float* y, float* part, int m, int T, int S,
                          int R, long long nnz, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(S) * NB + 2 * static_cast<size_t>(S) + 1) * 4;
  auto kernel = segsum_chunk_kernel<V, kScaled, NB>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int group = groups > 0 ? S / groups : 1;
  kernel<<<T, kThreads, smem, stream>>>(static_cast<const V*>(vals), cols, lseg, seg_row,
                                        val_scale, groups, group, x, x_rows, B, y, part, m, T,
                                        S, R, nnz);
  return cudaGetLastError();
}

template <typename V, bool kScaled>
cudaError_t launch(const void* vals, const int* cols, const int* lseg, const int* seg_row,
                   const int* carry, int P, const float* val_scale, int groups, const float* x,
                   long long x_rows, int B, float* y, float* part, int m, int T, int S, int R,
                   long long nnz, cudaStream_t stream) {
  const cudaError_t err =
      B == 1 ? launch_chunks<V, kScaled, 1>(vals, cols, lseg, seg_row, val_scale, groups, x,
                                            x_rows, B, y, part, m, T, S, R, nnz, stream)
             : launch_chunks<V, kScaled, kMaxCols>(vals, cols, lseg, seg_row, val_scale,
                                                   groups, x, x_rows, B, y, part, m, T, S,
                                                   R, nnz, stream);
  if (err != cudaSuccess || P == 0) return err;
  const int warps = kCarryThreads / 32;
  const int blocks = (P + warps - 1) / warps;
  segsum_carry_kernel<<<blocks, kCarryThreads, 0, stream>>>(carry, P, part, y, B, T, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// value_kind: 0 = float32, 1 = bfloat16, 2 = int8 (val_scale required).
// vals / cols / lseg: [T, S]; seg_row: [T, R]; val_scale: [T, groups];
// carry: [P, 3] (row, first fragment slot, last chunk) of the rows that
// span chunks; x: [x_rows, B]; y: [m, B]; part: [T, 2, B] scratch; nnz: real
// slots.
int repro_spmv_segsum(int value_kind, const void* vals, const int* cols, const int* lseg,
                      const int* seg_row, const int* carry, int P, const float* val_scale,
                      int groups, const float* x, long long x_rows, int B, float* y,
                      float* part, int m, int T, int S, int R, long long nnz, void* stream) {
  if (T <= 0 || S < 1 || R < 1 || B < 1 || m < 0 || P < 0 || nnz < 0 ||
      nnz > static_cast<long long>(T) * S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (value_kind) {
    case 0:
      return static_cast<int>(launch<float, false>(vals, cols, lseg, seg_row, carry, P, nullptr,
                                                   0, x, x_rows, B, y, part, m, T, S, R, nnz,
                                                   st));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16, false>(vals, cols, lseg, seg_row, carry, P,
                                                           nullptr, 0, x, x_rows, B, y, part,
                                                           m, T, S, R, nnz, st));
    case 2:
      if (val_scale == nullptr || groups <= 0 || S % groups)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch<int8_t, true>(vals, cols, lseg, seg_row, carry, P,
                                                   val_scale, groups, x, x_rows, B, y, part, m,
                                                   T, S, R, nnz, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_segsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
