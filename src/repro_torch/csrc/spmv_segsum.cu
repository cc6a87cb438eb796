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
// slot belongs to (empty rows) come out 0.  x and y are float32 or bfloat16
// (one type for both, as the Pallas kernel stores y in x's dtype): a bf16 x
// is widened to f32 as it is read, the fragments of rows that span chunks
// stay f32, and each row is rounded to bf16 once, when stored.
//
// Bound: bytes.  SpMV does 2 flops per slot and column and reads 5-8 bytes
// per slot, far below the card's ~20 flops per byte of float32 balance, so
// the least time is the bytes the work must move over the memory rate.  On
// a matrix whose columns are spread over an x larger than L1 (powerlaw_zipf:
// 1 MB of x, uniform columns) each slot's x gather is also a 32-byte L2
// sector; that traffic, not HBM, is the likeliest limit (a hypothesis: no
// counter has measured it on the card).
//
// Design: two launches on the caller's stream.
//   * Chunk pass: resident blocks of 8 warps, each warp walking chunks t,
//     t + warps, ...  A chunk's segment structure comes from the container's
//     segment-start table (SegSumCSR.seg_start: each chunk's L_t starts, a
//     few MB in all), never from local_seg, which is 4 bytes a slot; its
//     real slot count n_t = min(S, nnz - t S) is computed.  The table
//     entries, the first 32 seg_row entries, the neighbours' rows and (int8)
//     the scales of the next chunk are loaded a chunk ahead, into registers,
//     so no dependent load waits in the loop.  They become a bit mask of the
//     starts (and of n_t, where the tail chunk's padding begins) in shared
//     memory (one word per 32 slots, with prefix popcounts, so a slot's
//     segment index is a popcount).
//   * A chunk is read in rounds of 128 slots: lane l takes the 4-slot vector
//     at slots 4l..4l+3 of the round, one 16-byte load of columns and one
//     16-, 8- or 4-byte load of values, kept packed until it is summed and
//     not allocated in L1, which is left to x (the kernel also asks for no
//     more shared memory than it uses).  Only the real slots [0, n_t) are
//     read: the tail chunk's padding is skipped.  x is gathered through
//     the read-only path, up to 8 columns of an x row at B > 1 (float4
//     where aligned).  The kernel is held to 64 registers at B = 1; loads
//     of more rounds in flight spilled and ran slower (PERF.md).
//   * A lane sums its 4 products in slot order (__fmul_rn products,
//     __fadd_rn sums); a segment that starts and ends inside the lane is
//     written there.  The part open at the lane's end goes into a segmented
//     scan across the warp's lanes (a Hillis-Steele tree whose steps are
//     fixed by the start flags), which also takes the part carried from the
//     round before.  A lane holding a start closes the segment open before
//     it: that sum is the scan's value one lane down plus the lane's own
//     part before its first start.  So a segment's sum is taken in an order
//     fixed by the matrix alone, but not in slot order: it agrees with a
//     sequential sum within the bound (2 k_i + 2) eps32 (|A| |x|)_i, not
//     bit for bit.
//   * A segment whose row lies wholly in the chunk is written straight to
//     y.  A segment that continues from the previous chunk (only segment 0
//     can) or into the next one (only the last real segment can) is a
//     fragment: its sum goes to part[t, 0] (segment 0) or part[t, 1] (the
//     last segment), and nothing is written to y.
//   * The warp writes 0 to the rows between one segment's row and the next
//     (and, in the last chunk, after the last row; with no nnz, all rows).
//     So every row of y is written exactly once and y needs no clearing:
//     empty rows are 0 whatever the memory held before.
//   * int8: a scale group of whole rounds (every container's is 128 slots)
//     gives each round one scale, taken by a shuffle from the lane that
//     loaded it a chunk ahead: no load and no divide in the slot loop.
//     Other groups take one scale load per slot.
//   * Carry pass, one warp per row that spans chunks, from the container's
//     carry list (row, first fragment, last chunk; built on the host with
//     the chunks), so the pass never walks chunk boundaries.  Lane l adds
//     the row's fragments l, l+32, ... in order, then a fixed shuffle tree
//     sums the lanes: the hub row of a power-law matrix has a hundred
//     fragments.
//   * Deterministic sums, no float atomics (the start mask is built with
//     integer atomics in shared memory, whose result does not depend on
//     their order).  Column j takes the same operations in the same order
//     whatever B is, so repeat launches are bit-equal and column j of an
//     [n, B] launch equals an [n] launch on x[:, j].
//
// Plain C interface (loaded with ctypes); the launches are asynchronous on
// the caller's stream and the function returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;             // chunk pass: 8 warps, one chunk each at a time
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 128;               // chunks hold a multiple of 128 slots
constexpr int kMaxCols = 8;               // columns a warp sums per pass at B > 1
constexpr int kCarryThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;   // above this, dynamic shared memory needs opt-in
constexpr size_t kSmemPerSm = 228 * 1024; // an H100 SM's shared memory at most
constexpr unsigned kAll = 0xffffffffu;

// Loads of the nnz streams, read once: through the read-only path without
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
__device__ __forceinline__ int ld_stream(const int* p) {
  int r;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}

// Four consecutive slots of values as loaded, unpacked only when summed: f32
// as a float4, bf16 as a uint2, int8 codes as an int.
template <typename V> struct Values4;

template <> struct Values4<float> {
  float4 r;
  __device__ void clear() { r = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ void load(const float* v, int64_t i) {
    r = ld_stream(reinterpret_cast<const float4*>(v + i));
  }
  __device__ void load_one(const float* v, int64_t i, int e) {
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
  __device__ void load(const __nv_bfloat16* v, int64_t i) {
    r = ld_stream(reinterpret_cast<const uint2*>(v + i));
  }
  __device__ void load_one(const __nv_bfloat16* v, int64_t i, int e) {
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
  __device__ void load(const int8_t* v, int64_t i) {
    r = ld_stream(reinterpret_cast<const int*>(v + i));
  }
  __device__ void load_one(const int8_t* v, int64_t i, int e) {
    const int b = __ldg(reinterpret_cast<const unsigned char*>(v) + i);
    r = (r & ~(0xff << (8 * e))) | (b << (8 * e));
  }
  __device__ float get(int e) const { return static_cast<float>((r << (24 - 8 * e)) >> 24); }
};

__device__ __forceinline__ int pick(const int4& c, int e) {
  return e == 0 ? c.x : e == 1 ? c.y : e == 2 ? c.z : c.w;
}

// Fixed reduction tree over the warp; lane 0 holds the sum.
__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a = __fadd_rn(a, __shfl_down_sync(kAll, a, off));
  return a;
}

// Real slots of chunk t.
__device__ __forceinline__ int real_slots(int t, int S, long long nnz) {
  const long long left = nnz - static_cast<long long>(t) * S;
  return left <= 0 ? 0 : (left < S ? static_cast<int>(left) : S);
}

// Zero rows [lo, hi) of y, columns [j0, j0 + nb), one warp.
template <typename Y>
__device__ __forceinline__ void zero_rows(Y* y, int lo, int hi, int B, int j0, int nb,
                                          int lane) {
  for (int r = lo + lane; r < hi; r += 32) {
    for (int k = 0; k < nb; ++k) store_rounded(y + static_cast<int64_t>(r) * B + j0 + k, 0.f);
  }
}

// A chunk's segment structure as one lane holds it, loaded a chunk ahead:
// the table offsets of its list, its start and row number `lane` (the first
// 32), the last row of the chunk before, the first of the chunk after and,
// for int8 with at most 32 scale groups, the scale of group `lane`.
struct ChunkMeta {
  int p0, p1, st, row, prev_row, next_row;
  float scale;
};

__device__ __forceinline__ ChunkMeta load_meta(const int* table, const int* seg_row,
                                               const float* val_scale, int groups, int t,
                                               int q_prev, int q_cur, int q_next, int T, int S,
                                               int R, long long nnz, int lane) {
  ChunkMeta c{q_cur, q_next, -1, 0, -1, -1, 1.f};
  if (t >= T) return c;
  if (val_scale != nullptr && groups <= 32 && lane < groups)
    c.scale = __ldg(val_scale + static_cast<int64_t>(t) * groups + lane);
  const int L = max(min(q_next - q_cur, min(R, real_slots(t, S, nnz))), 0);
  if (lane < L) {
    c.st = __ldg(table + q_cur + lane);
    c.row = __ldg(seg_row + static_cast<int64_t>(t) * R + lane);
  }
  const int lp = q_cur - q_prev;   // real segments of chunk t - 1
  if (t > 0 && lp > 0) c.prev_row = __ldg(seg_row + static_cast<int64_t>(t - 1) * R + lp - 1);
  if (t + 1 < T && real_slots(t + 1, S, nnz) > 0)
    c.next_row = __ldg(seg_row + static_cast<int64_t>(t + 1) * R);
  return c;
}

// Where one segment's sums go: a row of y, rounded to y's type on store, or
// an f32 fragment slot of part; neither when default-built.
template <typename Y>
struct Dst {
  Y* y;
  float* p;
  static __device__ Dst row(Y* r) { return {r, nullptr}; }
  static __device__ Dst fragment(float* f) { return {nullptr, f}; }
  __device__ bool ok() const { return y != nullptr || p != nullptr; }
  __device__ void put(int j, float v) const {
    if (y != nullptr) {
      store_rounded(y + j, v);
    } else {
      p[j] = v;
    }
  }
};

template <>
struct Dst<float> {   // an f32 y and part: one pointer
  float* d;
  static __device__ Dst row(float* r) { return {r}; }
  static __device__ Dst fragment(float* f) { return {f}; }
  __device__ bool ok() const { return d != nullptr; }
  __device__ void put(int j, float v) const { d[j] = v; }
};

// Where chunk t's segment sums go: y for a row that lies wholly in the chunk,
// part[t, 0] or part[t, 1] for a fragment, nowhere for the dump row.
template <typename Y>
struct ChunkOut {
  const int* rows;   // [L] the chunk's real segments' rows (shared memory)
  int L, prev_row, next_row, m, B, t;
  Y* y;
  float* part;
  __device__ Dst<Y> dst(int k) const {
    const int row = rows[k];
    if (row < 0 || row >= m) return {};   // dump row (a malformed container only)
    if ((k == 0 && row == prev_row) || (k == L - 1 && row == next_row))
      return Dst<Y>::fragment(part + (static_cast<int64_t>(t) * 2 + (k == 0 ? 0 : 1)) * B);
    return Dst<Y>::row(y + static_cast<int64_t>(row) * B);
  }
};

// Load lane `lane`'s 4-slot vector of round r of chunk t (slots 128 r +
// 4 lane .. + 3, only those below n_t): values packed, columns.
template <typename V>
__device__ __forceinline__ void load_slots(Values4<V>& v, int4& c, const V* vals,
                                           const int* cols, int64_t base, int s, int n,
                                           bool vec) {
  v.clear();
  c = make_int4(0, 0, 0, 0);
  if (s >= n) return;
  if (vec && s + 4 <= n) {
    v.load(vals, base + s);
    c = ld_stream(reinterpret_cast<const int4*>(cols + base + s));
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (s + e < n) {
      v.load_one(vals, base + s + e, e);
      const int ce = __ldg(cols + base + s + e);
      if (e == 0) c.x = ce;
      if (e == 1) c.y = ce;
      if (e == 2) c.z = ce;
      if (e == 3) c.w = ce;
    }
  }
}

template <typename V, typename X, bool kScaled, int NB>
__global__ void __launch_bounds__(kThreads, NB == 1 ? 4 : 2)
segsum_chunk_kernel(const V* __restrict__ vals, const int* __restrict__ cols,
                    const int* __restrict__ table, const int* __restrict__ seg_row,
                    const float* __restrict__ val_scale, int groups, int group,
                    const X* __restrict__ x, long long x_rows, int B,
                    X* __restrict__ y, float* __restrict__ part, int m, int T, int S,
                    int R, long long nnz, bool vec) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int words = S / 32;
  // this warp's shared memory: start mask, prefix popcounts, segment rows
  unsigned* mask = reinterpret_cast<unsigned*>(smem) + (threadIdx.x >> 5) * (2 * words + R);
  int* cnt = reinterpret_cast<int*>(mask + words);
  int* rows = cnt + words;
  const int rounds = S / kRound;
  const int stride = gridDim.x * kWarps;
  // x rows can be read four values at a time when aligned to four values
  const bool x4 = NB == 8 && B % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(X) - 1)) == 0;
  // int8: a scale group of whole rounds gives each round one scale
  const bool round_scale = kScaled && group % kRound == 0;
  const int group_rounds = round_scale ? group / kRound : 1;

  int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= T) return;
  // the first chunk's structure; the table offsets of the one after it
  int q_prev = t > 0 ? __ldg(table + t - 1) : 0, q_cur = __ldg(table + t),
      q_next = __ldg(table + t + 1);
  ChunkMeta cur =
      load_meta(table, seg_row, val_scale, groups, t, q_prev, q_cur, q_next, T, S, R, nnz, lane);
  if (t + stride < T) {
    q_prev = __ldg(table + t + stride - 1);
    q_cur = __ldg(table + t + stride);
    q_next = __ldg(table + t + stride + 1);
  }
  for (; t < T; t += stride) {
    const int tn = t + stride;
    const int n_t = real_slots(t, S, nnz);
    const int64_t base = static_cast<int64_t>(t) * S;
    const int L = max(min(cur.p1 - cur.p0, min(R, n_t)), 0);   // real segments
    Values4<V> v;
    int4 c;
    load_slots(v, c, vals, cols, base, 4 * lane, n_t, vec);

    // the next chunk's structure, and the table offsets of the one after
    const ChunkMeta nxt = load_meta(table, seg_row, val_scale, groups, tn, q_prev, q_cur, q_next,
                                    T, S, R, nnz, lane);
    if (tn + stride < T) {
      q_prev = __ldg(table + tn + stride - 1);
      q_cur = __ldg(table + tn + stride);
      q_next = __ldg(table + tn + stride + 1);
    }
    // this chunk's rows, and a mask of the starts of its real segments and
    // of n_t (the tail chunk's padding is a segment of its own, never
    // written)
    for (int w = lane; w < words; w += 32) mask[w] = 0u;
    if (lane < L) rows[lane] = cur.row;
    for (int k = lane + 32; k < L; k += 32)
      rows[k] = __ldg(seg_row + static_cast<int64_t>(t) * R + k);
    __syncwarp();
    for (int k = lane; k < L; k += 32) {
      const int st = k < 32 ? cur.st : __ldg(table + cur.p0 + k);
      if (st >= 0 && st < S) atomicOr(mask + (st >> 5), 1u << (st & 31));
    }
    if (lane == 0 && n_t < S) atomicOr(mask + (n_t >> 5), 1u << (n_t & 31));
    __syncwarp();
    int run = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
      const int w = w0 + lane;
      const int own = w < words ? __popc(mask[w]) : 0;
      int inc = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kAll, inc, d);
        if (lane >= d) inc += o;
      }
      if (w < words) cnt[w] = run + inc - own;
      run += __shfl_sync(kAll, inc, 31);
    }
    __syncwarp();
    const ChunkOut<X> out{rows, L, cur.prev_row, cur.next_row, m, B, t, y, part};

    for (int j0 = 0; j0 < B; j0 += NB) {
      const int nb = min(NB, B - j0);
      float carry[NB];   // the sum open at the end of the previous round
#pragma unroll
      for (int k = 0; k < NB; ++k) carry[k] = 0.f;
      int g = 0, g_left = group_rounds;          // the round's scale group
      for (int r = 0; r < rounds; ++r) {
        const int s = r * kRound + 4 * lane;
        if (r > 0 || j0 > 0) load_slots(v, c, vals, cols, base, s, n_t, vec);

        // products of the lane's 4 slots (0 past n_t, where nothing is read)
        float sc = 1.f;
        if (round_scale) {
          sc = groups <= 32 ? __shfl_sync(kAll, cur.scale, g)
                            : __ldg(val_scale + static_cast<int64_t>(t) * groups + g);
          if (--g_left == 0) {
            ++g;
            g_left = group_rounds;
          }
        }
        float p[4][NB];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool real = s + e < n_t;
          float val = v.get(e);
          if (kScaled)
            val = __fmul_rn(val, round_scale ? sc
                                 : real ? __ldg(val_scale + static_cast<int64_t>(t) * groups +
                                                (s + e) / group)
                                        : 0.f);
          const int cc = pick(c, e);
          const bool in = real && cc >= 0 && cc < x_rows;
          if (NB == 1) {
            p[e][0] = __fmul_rn(val, in ? load_f32(x + cc) : 0.f);
            continue;
          }
          const X* xr = x + static_cast<int64_t>(in ? cc : 0) * B + j0;
          if (x4 && nb == NB) {
#pragma unroll
            for (int k = 0; k < NB; k += 4) {
              const float4 xv = in ? load_f32x4(xr + k) : make_float4(0.f, 0.f, 0.f, 0.f);
              p[e][k] = __fmul_rn(val, xv.x);
              p[e][k + 1] = __fmul_rn(val, xv.y);
              p[e][k + 2] = __fmul_rn(val, xv.z);
              p[e][k + 3] = __fmul_rn(val, xv.w);
            }
          } else {
#pragma unroll
            for (int k = 0; k < NB; ++k)
              p[e][k] = __fmul_rn(val, in && k < nb ? load_f32(xr + k) : 0.f);
          }
        }

        const unsigned word = mask[s >> 5];
        const int b = s & 31;
        const int nib = (word >> b) & 0xf;   // which of the lane's slots start a segment
        const int kb = cnt[s >> 5] + __popc(word & ((1u << b) - 1u));   // starts before s

        // in the lane: the part before its first start (head), the segments
        // that start and end here (written), the part open at its end (acc)
        float acc[NB], head[NB];
#pragma unroll
        for (int k = 0; k < NB; ++k) acc[k] = head[k] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool st = (nib >> e) & 1;
          if (st && e > 0) {
            if (nib & ((1 << e) - 1)) {
              const Dst<X> d = out.dst(kb + __popc(nib & ((1 << e) - 1)) - 1);
              if (d.ok()) {
#pragma unroll
                for (int k = 0; k < NB; ++k)
                  if (k < nb) d.put(j0 + k, acc[k]);
              }
            } else {
#pragma unroll
              for (int k = 0; k < NB; ++k) head[k] = acc[k];
            }
          }
#pragma unroll
          for (int k = 0; k < NB; ++k)
            acc[k] = (e == 0 || st) ? p[e][k] : __fadd_rn(acc[k], p[e][k]);
        }

        // across the lanes: a segmented scan of the open parts and the round
        // before's, then each lane with a start closes the segment open
        // before it
        const unsigned flags = __ballot_sync(kAll, nib != 0);
        const Dst<X> close = (nib != 0 && kb > 0) ? out.dst(kb - 1) : Dst<X>{};
        const bool has_head = (nib & 1) == 0;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          float a = acc[k];
          if (lane == 0 && nib == 0) a = __fadd_rn(carry[k], a);
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const float o = __shfl_up_sync(kAll, a, d);
            if (lane >= d && ((flags >> (lane - d + 1)) & ((1u << d) - 1u)) == 0u)
              a = __fadd_rn(o, a);
          }
          float before = __shfl_up_sync(kAll, a, 1);
          if (lane == 0) before = carry[k];
          if (close.ok() && k < nb)
            close.put(j0 + k, has_head ? __fadd_rn(before, head[k]) : before);
          carry[k] = __shfl_sync(kAll, a, 31);
        }
      }
      // the segment open at the chunk's end: the last real one when the
      // chunk is full, else the padding's
      if (lane == 0 && n_t == S && L > 0) {
        const Dst<X> d = out.dst(L - 1);
        if (d.ok()) {
#pragma unroll
          for (int k = 0; k < NB; ++k)
            if (k < nb) d.put(j0 + k, carry[k]);
        }
      }

      // empty rows before each segment's row; after the last row in the last chunk
      for (int k = 0; k < L; ++k) {
        const int lo = (k == 0 ? cur.prev_row : rows[k - 1]) + 1;
        if (lo < rows[k]) zero_rows(y, max(lo, 0), rows[k], B, j0, nb, lane);
      }
      if (t == T - 1)
        zero_rows(y, max((L > 0 ? rows[L - 1] : cur.prev_row) + 1, 0), m, B, j0, nb, lane);
    }
    cur = nxt;
    __syncwarp();                               // the mask and rows are read
  }
}

// One warp per row that spans chunks: carry[i] = (row, first fragment slot
// 2*c0 + side, last chunk c1).  The row's fragments are f = 0 (part[first])
// and f = 1 .. c1 - c0 (segment 0 of chunk c0 + f).  Lane l adds fragments
// l, l+32, ... in increasing order, then the fixed shuffle tree sums the
// lanes: the hub row's hundred fragments cost four loads per lane, not a
// hundred dependent ones.  The f32 sum is rounded to y's type once.
template <typename Y>
__global__ void __launch_bounds__(kCarryThreads)
segsum_carry_kernel(const int* __restrict__ carry, int P, const float* __restrict__ part,
                    Y* __restrict__ y, int B, int T, int m) {
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
      if (lane == 0 && k < nb) store_rounded(y + static_cast<int64_t>(row) * B + j0 + k, acc[k]);
    }
  }
}

// Blocks of one chunk-pass instance that fit on the current card at once:
// the grid of a launch whose warps walk the chunks.
template <typename V, typename X, bool kScaled, int NB>
int resident_blocks(size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                segsum_chunk_kernel<V, X, kScaled, NB>, kThreads,
                                                smem);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

template <typename V, typename X, bool kScaled, int NB>
cudaError_t launch_chunks(const void* vals, const int* cols, const int* table,
                          const int* seg_row, const float* val_scale, int groups,
                          const X* x, long long x_rows, int B, X* y, float* part, int m,
                          int T, int S, int R, long long nnz, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * (2 * (S / 32) + R) * 4;
  auto kernel = segsum_chunk_kernel<V, X, kScaled, NB>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // ask for no more shared memory than the resident blocks use (1 KB each
  // reserved besides), so L1 keeps as much of x as it can for the gathers
  const size_t resident = (smem + 1024) * (NB == 1 ? 4 : 2);
  const int percent = static_cast<int>(
      resident >= kSmemPerSm ? 100 : (resident * 100 + kSmemPerSm - 1) / kSmemPerSm);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, percent);
  const long long cap = resident_blocks<V, X, kScaled, NB>(smem);
  const long long need = (static_cast<long long>(T) + kWarps - 1) / kWarps;
  const int group = groups > 0 ? S / groups : 1;
  const V* v = static_cast<const V*>(vals);
  // 16-byte column vectors and 4-slot value vectors need aligned bases
  const bool vec = (reinterpret_cast<uintptr_t>(cols) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v) & (4 * sizeof(V) - 1)) == 0;
  kernel<<<static_cast<unsigned>(need < cap ? need : cap), kThreads, smem, stream>>>(
      v, cols, table, seg_row, val_scale, groups, group, x, x_rows, B, y, part, m, T, S, R,
      nnz, vec);
  return cudaGetLastError();
}

template <typename V, typename X, bool kScaled>
cudaError_t launch_x(const void* vals, const int* cols, const int* table, const int* seg_row,
                     const int* carry, int P, const float* val_scale, int groups,
                     const void* x_ptr, long long x_rows, int B, void* y_ptr, float* part,
                     int m, int T, int S, int R, long long nnz, cudaStream_t stream) {
  const X* x = static_cast<const X*>(x_ptr);
  X* y = static_cast<X*>(y_ptr);
  const cudaError_t err =
      B == 1 ? launch_chunks<V, X, kScaled, 1>(vals, cols, table, seg_row, val_scale, groups,
                                               x, x_rows, B, y, part, m, T, S, R, nnz, stream)
             : launch_chunks<V, X, kScaled, kMaxCols>(vals, cols, table, seg_row, val_scale,
                                                      groups, x, x_rows, B, y, part, m, T, S,
                                                      R, nnz, stream);
  if (err != cudaSuccess || P == 0) return err;
  const int warps = kCarryThreads / 32;
  const int blocks = (P + warps - 1) / warps;
  segsum_carry_kernel<X><<<blocks, kCarryThreads, 0, stream>>>(carry, P, part, y, B, T, m);
  return cudaGetLastError();
}

// x_kind: 0 = float32, 1 = bfloat16 (x and y alike).
template <typename V, bool kScaled>
cudaError_t launch(int x_kind, const void* vals, const int* cols, const int* table,
                   const int* seg_row, const int* carry, int P, const float* val_scale,
                   int groups, const void* x, long long x_rows, int B, void* y, float* part,
                   int m, int T, int S, int R, long long nnz, cudaStream_t stream) {
  switch (x_kind) {
    case 0:
      return launch_x<V, float, kScaled>(vals, cols, table, seg_row, carry, P, val_scale,
                                         groups, x, x_rows, B, y, part, m, T, S, R, nnz, stream);
    case 1:
      return launch_x<V, __nv_bfloat16, kScaled>(vals, cols, table, seg_row, carry, P,
                                                 val_scale, groups, x, x_rows, B, y, part, m, T,
                                                 S, R, nnz, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// value_kind: 0 = float32, 1 = bfloat16, 2 = int8 (val_scale required);
// x_kind: 0 = float32, 1 = bfloat16, the type of x and of y.
// vals / cols: [T, S] with S a multiple of 128; seg_start: the segment-start
// table, [T + 1] offsets into itself, then each chunk's L_t starts;
// seg_row: [T, R]; val_scale: [T, groups]; carry: [P, 3] (row, first
// fragment slot, last chunk) of the rows that span chunks; x: [x_rows, B];
// y: [m, B]; part: [T, 2, B] scratch; nnz: real slots.
int repro_spmv_segsum(int value_kind, int x_kind, const void* vals, const int* cols,
                      const int* seg_start, const int* seg_row, const int* carry, int P,
                      const float* val_scale, int groups, const void* x, long long x_rows,
                      int B, void* y, float* part, int m, int T, int S, int R, long long nnz,
                      void* stream) {
  if (T <= 0 || S < kRound || S % kRound || R < 1 || B < 1 || m < 0 || P < 0 || nnz < 0 ||
      nnz > static_cast<long long>(T) * S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (value_kind) {
    case 0:
      return static_cast<int>(launch<float, false>(x_kind, vals, cols, seg_start, seg_row,
                                                   carry, P, nullptr, 0, x, x_rows, B, y, part,
                                                   m, T, S, R, nnz, st));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16, false>(x_kind, vals, cols, seg_start,
                                                           seg_row, carry, P, nullptr, 0, x,
                                                           x_rows, B, y, part, m, T, S, R, nnz,
                                                           st));
    case 2:
      if (val_scale == nullptr || groups <= 0 || S % groups)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch<int8_t, true>(x_kind, vals, cols, seg_start, seg_row,
                                                   carry, P, val_scale, groups, x, x_rows, B, y,
                                                   part, m, T, S, R, nnz, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_segsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
