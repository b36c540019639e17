// The bridged unstructured SpMV tier on Hopper: the stream gather (the stream
// form of K2) and the bucketed combine K7.
//
// Replaces, in the JAX package's BridgedPlan.matvec
// (elemental_tpu/kernels/unstructured.py:267-282), the three TPU stages
// gather_multiply (K2, column-sorted), the extend-add route of the product
// stream into a bucket-major layout (K1 rounds), and onehot_combine_bucketed
// (K7).  The route exists on the TPU only because Mosaic has no vector
// scatter; the port's plan stores the entries already in bucket-major order,
// so the tier is two kernels:
//
// 1. stream gather, over every slot j in [0, nbuckets * SUB * 1024):
//
//        P[j] = vals_b[j] * x[cols_b[j]]     where cols_b[j] >= 0
//        P[j] = 0                            where cols_b[j] == -1 (padding)
//
//    A padding slot writes +0 and never reads x: in the reference padding is
//    never routed and stays exactly 0, and 0 * x[c] would turn an inf in x
//    into a NaN in y.  What bounds it: the scattered reads of x, then bytes.
//    vals_b and cols_b stream once and P is written once (12 bytes a slot
//    in f32 with int32 columns: 126 MB at n = 2^20, d = 10), but each read
//    of x touches its own 32-byte L2 sector, as in K2 (csr_spmv.cu): on the
//    H100 at 700 W the d = 10 gather takes about twice as long as the same
//    bytes with x read in slot order (tools/k2_profile.py, PERF.md).  So,
//    as K2 does: a thread reads the columns and values of one 16-byte
//    vector of values (4 slots in f32, 2 in f64) with streaming loads
//    (__ldcs, evict first, so the stream does not push x out of L2), skips
//    the values of a vector that is all padding (a bucket's padding is one
//    run at its end: most of the slots of a matrix with skewed buckets),
//    issues all its reads of x before it multiplies any, and writes its
//    products as one 16-byte store, which leaves P in L2 for K7.  Tried on
//    the card and no faster over the whole matvec: 2 or 4 vectors a
//    thread, launch bounds, L2-only reads of x, streaming and evict-last
//    stores of P, and slots sorted by column within a bucket (the gather
//    gains, K7 through the permutation loses more).  The slot count is a
//    multiple of 1024, so no thread has a ragged vector.
//
// 2. K7, for every bucket b and local row r in [0, bucket):
//
//        y[b * bucket + r] = sum over the slots j of bucket b with
//                            LR[j] == r, in slot order, of (float) P[j]
//
//    THE ORDER: a row's products, in slot order, are cut into chunks of
//    CHUNK = 8 from the row's first product; each chunk is added left to
//    right into a float32 sum that starts at +0, and the chunk sums are
//    added pairwise: (c0 + c1), (c2 + c3), ..., then those pairs pairwise,
//    and so on, a lone last node passing up unchanged.  So y's bits depend
//    only on each row's products in plan order: the same on every run,
//    whatever the launch.  A zero product changes no sum (x + 0 == x, and
//    no partial sum is ever -0), so padding (P = +0) at the end of a row
//    leaves its bits alone: the plan built from LR alone, which puts
//    plan_bridged_spmv's padding after row 0's products, gives the bits of
//    the plan that leaves the padding out.  A row with no product is
//    exactly +0; a local row outside [0, bucket) is not summed.  y is
//    float32 whatever P's type, as the reference's out_shape is; every
//    `precision` of the reference is this plain f32 sum.
//
//    The order comes from a summation plan built once from LR (the wrapper's
//    CombinePlan): off[b, r] .. off[b, r+1] are row r's positions in bucket
//    b's list of slots stably sorted by local row, and order[b, k] is the
//    slot at position k, or absent when the list is the slots themselves
//    (plan_bridged_spmv's layout: CSR order is row order inside a bucket,
//    padding at its end).  The work is shared out by row length, so that a
//    row of 65,536 products is not added by one thread, with the same order
//    in every tier:
//      - a row of at most THREAD_ROW = 32 products: one thread, its <= 4
//        chunk sums added pairwise in registers (the tier of every row of a
//        matrix of short rows);
//      - at most WARP_ROW = 2048: one warp, the plan's list warp_rows;
//      - longer: one block of 8 warps, the plan's list block_rows.
//    A warp reads a row a span of 32 chunks (256 products) at a time, 4
//    spans in flight, coalesced, through shared memory; lane l adds chunk l
//    and a butterfly adds the 32 chunk sums pairwise; a stack of partial
//    sums joins the spans pairwise.  In a block, warp w takes the aligned
//    run of spans [w K, w K + K) (K the least power of two with 8 K >= the
//    row's spans), and the 8 warps' sums are added in a fixed tree.
//    Pairwise trees of any power-of-two width give the same bits, since the
//    chunks past the row's end are +0.  Blocks of long rows come first in
//    the grid, then the warps, then one thread a row over all rows (which
//    leaves the listed rows to their teams): no atomics, one writer a row.
//    Products are read with read-only loads, in list order (a thread's
//    reads of a short row share sectors with its neighbours' in L1), or
//    through order's permutation from the bucket's P in L2.  K7 does not
//    read LR: P, the plan's offsets (4 bytes a row) and order (4 a slot,
//    when there is one) are read once, y is written once.
//
// Indices: cols_b is int32 while the slot count and n_cols are below 2^31
// and int64 above (the port's one index-width rule); the summation plan's
// offsets and order are int32 positions inside one bucket (SUB * 1024 slots,
// below 2^31); slot positions across buckets, and the rows of warp_rows and
// block_rows (b * bucket + r), run in int64.  cols_b, vals_b and P must be
// 16-byte aligned (the wrapper checks).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kBlock = 256;                    // K7's threads a block
constexpr int kWarps = kBlock / 32;
constexpr int kChunk = 8;                      // products added in a row
constexpr int kThreadRow = 4 * kChunk;         // longest row of a thread
constexpr int kSpan = 32 * kChunk;             // products a warp reads
constexpr int kSpans = 4;                      // spans read at a time
constexpr int kStage = 32 * (kChunk + 1);      // a span in shared memory
constexpr unsigned kFull = 0xffffffffu;

// K consecutive values of U (8 bytes, or whole 16-byte vectors) as
// streaming loads
template <int K, typename U>
__device__ __forceinline__ void load_cs(const U* src, U* o) {
  if constexpr (K * sizeof(U) == 8) {
    union { int2 v; U e[K]; } u;
    u.v = __ldcs(reinterpret_cast<const int2*>(src));
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = u.e[k];
  } else {
    constexpr int kPer = 16 / sizeof(U);
    static_assert(K % kPer == 0, "8 bytes or whole 16-byte vectors only");
#pragma unroll
    for (int i = 0; i < K / kPer; ++i) {
      union { int4 v; U e[kPer]; } u;
      u.v = __ldcs(reinterpret_cast<const int4*>(src) + i);
#pragma unroll
      for (int k = 0; k < kPer; ++k) o[i * kPer + k] = u.e[k];
    }
  }
}

// one 16-byte vector of U
template <typename U>
__device__ __forceinline__ void store16(U* dst, const U* o) {
  constexpr int kPer = 16 / sizeof(U);
  union { int4 v; U e[kPer]; } u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) u.e[k] = o[k];
  *reinterpret_cast<int4*>(dst) = u.v;
}

// Thread t takes the slots of the t-th 16-byte vector of values (4 in f32,
// 2 in f64), so each load and store instruction of a warp covers 512
// neighbouring bytes of values.
template <typename T, typename I>
__global__ void __launch_bounds__(kGatherThreads)
stream_gather_kernel(const I* __restrict__ cols, const T* __restrict__ vals,
                     const T* __restrict__ x, T* __restrict__ p,
                     int64_t slots) {
  constexpr int kPer = 16 / sizeof(T);
  const int64_t j = (static_cast<int64_t>(blockIdx.x) * kGatherThreads
                     + threadIdx.x) * kPer;
  if (j >= slots) return;
  I c[kPer];
  T v[kPer];
  load_cs<kPer>(cols + j, c);
  bool any = false;
#pragma unroll
  for (int k = 0; k < kPer; ++k) any |= c[k] >= 0;
  if (any) {
    load_cs<kPer>(vals + j, v);
  } else {                                   // padding: its values unread
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = T(0);
  }
  T xv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) xv[k] = c[k] >= 0 ? __ldg(x + c[k]) : T(0);
  T out[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) out[k] = c[k] >= 0 ? v[k] * xv[k] : T(0);
  store16(p + j, out);
}

// The products of one bucket's list: position k holds P[k], or
// P[order[k]] (kOrdered).
template <typename T, bool kOrdered>
struct List {
  const T* p;
  const int32_t* q;
  // v[i] = (float) the product at position s + i for i < n, else +0; all
  // loads issued before any is used
  template <int N>
  __device__ __forceinline__ void load(int s, int n, float* v) const {
    if constexpr (kOrdered) {
      int32_t k[N];
#pragma unroll
      for (int i = 0; i < N; ++i) k[i] = i < n ? __ldg(q + s + i) : -1;
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = k[i] >= 0 ? static_cast<float>(__ldg(p + k[i])) : 0.0f;
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = i < n ? static_cast<float>(__ldg(p + s + i)) : 0.0f;
    }
  }
  // v[i] = (float) the product at position s + 32 i for 32 i < n, else +0
  template <int N>
  __device__ __forceinline__ void load_strided(int s, int n, float* v) const {
    if constexpr (kOrdered) {
      int32_t k[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        k[i] = 32 * i < n ? __ldg(q + s + 32 * i) : -1;
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = k[i] >= 0 ? static_cast<float>(__ldg(p + k[i])) : 0.0f;
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = 32 * i < n ? static_cast<float>(__ldg(p + s + 32 * i))
                          : 0.0f;
    }
  }
};

// one chunk, left to right from +0
__device__ __forceinline__ float chunk_sum(const float* v) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) acc += v[i];
  return acc;
}

// A warp's pairwise sum of the row's spans [j0, j0 + cnt), a span being 32
// chunks (256 products) from the row's start, j0 a multiple of a power of
// two K >= cnt (spans up to j0 + K past the row are +0).  The warp loads
// kSpans spans at a time into registers, coalesced (product k of a span by
// lane k % 32), then passes each through its stage in shared memory, where
// chunk c sits at 9 c (odd stride: lane l reads chunk l without bank
// conflicts); lane l adds chunk l, the butterfly adds
// the 32 chunk sums pairwise (each step adds neighbouring pairs, so every
// lane ends with the span's pairwise tree), and a binary counter of
// partial sums joins the spans: stk[l] the sum of 2^l spans, the open ones
// joined from the lowest up.  The row's products lie at list positions
// [s, s + n).  Every lane returns the sum.
template <typename T, bool kOrdered>
__device__ float warp_spans(const List<T, kOrdered>& list, int s, int n,
                            int j0, int cnt, float* stage, int lane) {
  float stk[32];
  for (int j = 0; j < cnt; j += kSpans) {
    float v[kSpans][kChunk];
#pragma unroll
    for (int h = 0; h < kSpans; ++h) {
      const int pos = (j0 + j + h) * kSpan + lane;
      list.template load_strided<kChunk>(s + pos, j + h < cnt ? n - pos : 0,
                                         v[h]);
    }
#pragma unroll
    for (int h = 0; h < kSpans; ++h) {
      const int q = j + h;
      if (q >= cnt) break;                   // the same in every lane
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int k = lane + 32 * i;
        stage[(k >> 3) * 9 + (k & 7)] = v[h][i];
      }
      __syncwarp();
      float x = chunk_sum(stage + 9 * lane);
      __syncwarp();
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
      int l = 0;
      for (int bits = q; bits & 1; bits >>= 1) x = stk[l++] + x;
      stk[l] = x;
    }
  }
  float acc = 0.0f;
  bool open = false;
  for (int l = 0, c = cnt; c != 0; ++l, c >>= 1)
    if (c & 1) {
      acc = open ? stk[l] + acc : stk[l];
      open = true;
    }
  return acc;
}

// Grid: n_block blocks (block_rows[i]), then warp_blocks blocks of 8 warps
// (warp_rows[i]), then one thread a row over all nbuckets * bucket rows.
// off holds (bucket + 1) offsets a bucket; order (kOrdered) per_bucket slot
// positions a bucket.
template <typename T, bool kOrdered>
__global__ void __launch_bounds__(kBlock)
combine_kernel(const T* __restrict__ p, const int32_t* __restrict__ off,
               const int32_t* __restrict__ order,
               const int64_t* __restrict__ block_rows,
               const int64_t* __restrict__ warp_rows, float* __restrict__ y,
               int64_t per_bucket, int64_t bucket, int64_t rows,
               int64_t n_block, int64_t n_warp, int64_t warp_blocks) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t blk = blockIdx.x;
  const int tier = blk < n_block ? 0 : blk < n_block + warp_blocks ? 1 : 2;
  int64_t r;
  if (tier == 0) {
    r = block_rows[blk];
  } else if (tier == 1) {
    const int64_t w = (blk - n_block) * kWarps + warp;
    if (w >= n_warp) return;                 // whole warps leave together
    r = warp_rows[w];
  } else {
    r = (blk - n_block - warp_blocks) * kBlock + t;
    if (r >= rows) return;
  }
  const int64_t b = r / bucket;
  const int32_t* ob = off + b * (bucket + 1) + (r - b * bucket);
  const int s = ob[0], n = ob[1] - s;
  const List<T, kOrdered> list{p + b * per_bucket,
                               kOrdered ? order + b * per_bucket : nullptr};
  __shared__ float stage[kWarps][kStage];
  const int spans = (n + kSpan - 1) / kSpan;
  if (tier == 0) {                           // one row, 8 warps
    __shared__ float part[kWarps];
    int k = 1;                               // spans a warp: 8 k >= spans
    while (kWarps * k < spans) k <<= 1;
    const int j0 = warp * k;
    const float x = j0 < spans ? warp_spans(list, s, n, j0,
                                            min(k, spans - j0), stage[warp],
                                            lane)
                               : 0.0f;
    if (lane == 0) part[warp] = x;
    __syncthreads();
    if (t == 0)
      y[r] = ((part[0] + part[1]) + (part[2] + part[3]))
             + ((part[4] + part[5]) + (part[6] + part[7]));
  } else if (tier == 1) {                    // one row, one warp
    const float x = warp_spans(list, s, n, 0, spans, stage[warp], lane);
    if (lane == 0) y[r] = x;
  } else if (n <= kThreadRow) {              // one row, one thread
    constexpr int kq = kThreadRow / kChunk;
    float v[kThreadRow], c[kq];
    list.template load<kThreadRow>(s, n, v);
#pragma unroll
    for (int q = 0; q < kq; ++q) c[q] = chunk_sum(v + q * kChunk);
#pragma unroll
    for (int w = 1; w < kq; w <<= 1)         // pairwise
#pragma unroll
      for (int q = 0; q + w < kq; q += 2 * w) c[q] = c[q] + c[q + w];
    y[r] = c[0];
  }
}

template <typename T, typename I>
int gather(const void* cols, const void* vals, const void* x, void* p,
           int64_t slots, void* stream) {
  if (slots <= 0) return 0;
  if (slots % (16 / sizeof(T)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = static_cast<int64_t>(kGatherThreads)
                            * (16 / sizeof(T));
  stream_gather_kernel<T, I><<<static_cast<unsigned>(
                                   (slots + per_block - 1) / per_block),
                               kGatherThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const I*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(p), slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine(const void* p, const void* off, const void* order,
            const void* block_rows, int64_t n_block, const void* warp_rows,
            int64_t n_warp, void* y, int64_t nbuckets, int64_t per_bucket,
            int64_t bucket, void* stream) {
  if (nbuckets <= 0 || bucket <= 0) return 0;
  if (per_bucket >= (int64_t{1} << 31) || bucket >= (int64_t{1} << 31)
      || n_block < 0 || n_warp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = nbuckets * bucket;
  const int64_t warp_blocks = (n_warp + kWarps - 1) / kWarps;
  const int64_t blocks = n_block + warp_blocks + (rows + kBlock - 1) / kBlock;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pp = static_cast<const T*>(p);
  const int32_t* po = static_cast<const int32_t*>(off);
  const int32_t* pq = static_cast<const int32_t*>(order);
  const int64_t* pb = static_cast<const int64_t*>(block_rows);
  const int64_t* pw = static_cast<const int64_t*>(warp_rows);
  float* py = static_cast<float*>(y);
  if (pq != nullptr)
    combine_kernel<T, true><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        pp, po, pq, pb, pw, py, per_bucket, bucket, rows, n_block, n_warp,
        warp_blocks);
  else
    combine_kernel<T, false><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        pp, po, pq, pb, pw, py, per_bucket, bucket, rows, n_block, n_warp,
        warp_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define EL_GATHER(NAME, T, I)                                                 \
  int NAME(const void* cols, const void* vals, const void* x, void* p,        \
           int64_t slots, void* stream) {                                     \
    return gather<T, I>(cols, vals, x, p, slots, stream);                     \
  }

EL_GATHER(el_stream_gather_f32_i32, float, int32_t)
EL_GATHER(el_stream_gather_f32_i64, float, int64_t)
EL_GATHER(el_stream_gather_f64_i32, double, int32_t)
EL_GATHER(el_stream_gather_f64_i64, double, int64_t)

#undef EL_GATHER

// order may be null: the bucket's sorted list is its slots in order;
// block_rows and warp_rows hold the rows (b * bucket + r) of more than
// THREAD_ROW products (int64)
#define EL_COMBINE(NAME, T)                                                   \
  int NAME(const void* p, const void* off, const void* order,                 \
           const void* block_rows, int64_t n_block, const void* warp_rows,    \
           int64_t n_warp, void* y, int64_t nbuckets, int64_t per_bucket,     \
           int64_t bucket, void* stream) {                                    \
    return combine<T>(p, off, order, block_rows, n_block, warp_rows, n_warp,  \
                      y, nbuckets, per_bucket, bucket, stream);               \
  }

EL_COMBINE(el_combine_bucketed_f32, float)
EL_COMBINE(el_combine_bucketed_f64, double)

#undef EL_COMBINE

}  // extern "C"
