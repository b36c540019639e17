// K2: the general (unstructured) sparse matrix-vector product over a CSR
// matrix, on Hopper.
//
// Replaces the TPU kernel elemental_tpu/kernels/unstructured.py:
// gather_multiply (body _gather_kernel) together with the segment_sum that
// GatherPlan.matvec applies to its output: the JAX package reaches both from
// the 'gather_csr' tier of elemental_tpu/sparse/auto_plan.py:plan_spmv.
//
// What it computes, for every row r in [0, n_rows):
//
//     y[r] = sum over k in [rowptr[r], rowptr[r+1]) of vals[k] * x[colind[k]]
//
// What bounds it: the scattered reads of x, then bytes.  A product streams
// vals and colind once (nnz * (sizeof(T) + sizeof(I))), rowptr once, writes
// y, and reads x at random.  At n = 2^20 with 10 entries a row in f32 the
// CSR's own bytes are ~96 MB (29 us at 3.35 TB/s), but every random read of
// x touches its own 32-byte L2 sector: 10.5 M sectors, ~335 MB of L2
// traffic.  So the kernel has to keep many reads of x in flight and keep x
// in L2 while the CSR streams past it.
//
// Design: the entries, not the rows, are shared out.  Warp w owns the
// SHARE = 256 consecutive entries [256 w, 256 w + 256); lane l of it owns 8
// of them, read as 16-byte vectors with streaming loads (__ldcs: evict
// first, so the 84 MB stream does not push x out of L2).  The lane issues
// all 8 gathers of x through the read-only path before it uses any, then
// walks its entries in order with a running sum, writing each row that
// ends inside it.  The partial sums that cross lanes are joined by a
// segmented scan over the warp keyed by row, in a fixed order.  A row that
// crosses into the next share by at most TAIL = 32 entries (every such row
// of a matrix of short rows) is finished by the share it starts in, which
// reads those entries one a lane.  Any other row that crosses a share
// boundary leaves a partial sum in each share it touches, and a second,
// small kernel adds them in share order, one warp a row, for the rows the
// plan lists.  No atomics: y has the same bits on every run.  (An L2
// evict_last policy on x, and L2-only loads of x, were no faster on the
// card.)
//
// Rows are found without a search over the whole matrix: the plan stores
// split[w] = the row that holds entry 256 w (np.searchsorted(rowptr,
// 256 w, 'right') - 1, and n_rows past the end), so a lane searches only
// the rows of its own share.  Row ownership:
//   - a non-empty row is written by the share that holds its last entry,
//     or by the share it starts in (a short crossing), or by the fix-up;
//   - an empty row is written, as 0, by the lane that ends the row before
//     it, or by warp 0 when no row before it has an entry.
//
// The TPU kernel sorted the entries by column and cut them into 1024-entry
// tiles that each read a 256-column window of x, because its only vector
// gather works within one (8, 128) register; the row sums then went
// through XLA's scalar scatter.  The H100 gathers x directly from device
// memory, so the gather and the row sum fuse into this one pass.
//
// Indices: rowptr, colind, split and fix are of type I, int32 while nnz,
// n_rows and n_cols are below 2^31 and int64 above (the port's one
// index-width rule), so a lane's rows and entry positions run in I.  vals
// and colind must be 16-byte aligned (the wrapper checks).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing (the
// caller passes 2 * n_shares values of scratch), returns cudaGetLastError()
// so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int LANE_ENTRIES = 8;
constexpr int SHARE = 32 * LANE_ENTRIES;   // entries a warp
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// A row [rs, re) that starts in the share at e0 and ends at most TAIL
// entries into the next share is finished by the share it starts in, which
// reads those entries itself; every other row that crosses a share
// boundary is finished by the fix-up kernel.
constexpr int TAIL = 32;
__device__ __forceinline__ bool short_split(int64_t rs, int64_t re,
                                            int64_t e0) {
  return rs >= e0 && rs < e0 + SHARE && re > e0 + SHARE
         && re - (e0 + SHARE) <= TAIL;
}

// eight consecutive values as 16-byte streaming loads
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const double* p, double* o) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p) + i);
    o[2 * i] = a.x; o[2 * i + 1] = a.y;
  }
}
__device__ __forceinline__ void load8(const int32_t* p, int32_t* o) {
  const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
  const int4 b = __ldcs(reinterpret_cast<const int4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const int64_t* p, int64_t* o) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p) + i);
    o[2 * i] = a.x; o[2 * i + 1] = a.y;
  }
}

// At most 48 registers a thread (five blocks of 256 on an SM), the best of
// the bounds tried on the card for both dtypes.
template <typename T, typename I>
__global__ void __launch_bounds__(THREADS, 5) csr_spmv_kernel(
    const I* __restrict__ rowptr, const I* __restrict__ colind,
    const T* __restrict__ vals, const I* __restrict__ split,
    const T* __restrict__ x, T* __restrict__ y, T* __restrict__ first_part,
    T* __restrict__ last_part, int64_t n_rows, int64_t nnz,
    int64_t n_shares) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * THREADS
                     + threadIdx.x) >> 5;
  if (w >= n_shares) return;                 // whole warps leave together
  const int64_t e0 = w * SHARE;
  const int64_t e1 = imin(e0 + SHARE, nnz);
  const int64_t lo = split[w], hi = split[w + 1];
  if (w == 0)                                // rows before the first entry
    for (int64_t r = lane; r < lo; r += 32) y[r] = T(0);

  const int64_t e = e0 + lane * LANE_ENTRIES;
  const int cnt = e < e1 ? static_cast<int>(imin(LANE_ENTRIES, e1 - e)) : 0;
  T prod[LANE_ENTRIES];
  if (cnt == LANE_ENTRIES) {
    I c[LANE_ENTRIES];
    T v[LANE_ENTRIES];
    load8(colind + e, c);
    load8(vals + e, v);
    T xv[LANE_ENTRIES];
#pragma unroll
    for (int k = 0; k < LANE_ENTRIES; ++k)
      xv[k] = __ldg(x + c[k]);
#pragma unroll
    for (int k = 0; k < LANE_ENTRIES; ++k) prod[k] = v[k] * xv[k];
  } else {
#pragma unroll
    for (int k = 0; k < LANE_ENTRIES; ++k)
      prod[k] = k < cnt ? vals[e + k] * x[colind[e + k]] : T(0);
  }

  // the row of the lane's first entry: the last row in [lo, hi] that
  // starts at or before it.  Rows and entry positions fit in I (the
  // index-width rule), so the walk and the scan's keys run in I.
  const I el = static_cast<I>(e);
  I r = 0, nb = 0, rstart = 0;
  if (cnt > 0) {
    I a = static_cast<I>(lo), b = static_cast<I>(hi);
    while (a < b) {
      const I m = a + (b - a + 1) / 2;
      if (rowptr[m] <= el) a = m; else b = m - 1;
    }
    r = a;
    rstart = rowptr[r];
    nb = rowptr[r + 1];
  }
  const I rows = static_cast<I>(n_rows);
  T acc = T(0), first_val = T(0);
  I first_row = -1, first_end = 0;
#pragma unroll
  for (int k = 0; k < LANE_ENTRIES; ++k) {
    if (k < cnt) {
      acc += prod[k];
      const I pos = el + k + 1;
      if (pos == nb) {                       // entry k ends row r
        if (first_row < 0) {
          first_row = r;
          first_val = acc;
          first_end = pos;
        } else {
          y[r] = acc;                        // started inside this lane
        }
        acc = T(0);
        ++r;
        while (r < rows && (nb = rowptr[r + 1]) == pos) y[r++] = T(0);
      }
    }
  }

  // segmented inclusive scan of the lanes' open sums, keyed by row (keys
  // rise with the lane, so equal keys are neighbours)
  const I key = cnt > 0 ? r : static_cast<I>(sizeof(I) == 4 ? INT32_MAX
                                                             : INT64_MAX);
  T scan = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T v = __shfl_up_sync(FULL, scan, d);
    const I k2 = __shfl_up_sync(FULL, key, d);
    if (lane >= d && k2 == key) scan += v;
  }
  const T prev = __shfl_up_sync(FULL, scan, 1);
  const I prev_key = __shfl_up_sync(FULL, key, 1);
  if (first_row >= 0) {
    const T tot = lane > 0 && prev_key == first_row ? prev + first_val
                                                    : first_val;
    if (rstart >= e0) y[first_row] = tot;
    else if (!short_split(rstart, first_end, e0 - SHARE))
      first_part[w] = tot;                   // started in an earlier share
    // else the share before finished the row
  }
  // the share's open row: the one the last lane with entries leaves open
  // (hi, the row that holds entry e1, when it also has entries here)
  const int last = static_cast<int>((e1 - e0 - 1) / LANE_ENTRIES);
  const T open_sum = __shfl_sync(FULL, scan, last);
  if (hi >= n_rows) return;
  const int64_t ks = rowptr[hi], ke = rowptr[hi + 1];
  if (ks >= e1) return;                      // no entry of it here
  if (short_split(ks, ke, e0)) {
    // its few entries past the share are read here, one a lane
    const int64_t k = e1 + lane;
    T t = k < ke ? vals[k] * __ldg(x + colind[k]) : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(FULL, t, o);
    if (lane == 0) y[hi] = open_sum + t;
  } else if (lane == 0) {
    last_part[w] = open_sum;
    if (ks < e0) first_part[w] = open_sum;   // the row spans the share
  }
}

// y[r] for each row r the plan lists for the fix-up: r ends in share w =
// fix[f] but started in an earlier share ws and is not a short split.
// y[r] = last_part[ws] + (first_part[ws+1] + ... + first_part[w]), the
// bracket summed by a warp in a fixed order.
template <typename T, typename I>
__global__ void __launch_bounds__(THREADS) csr_fixup_kernel(
    const I* __restrict__ rowptr, const I* __restrict__ split,
    const I* __restrict__ fix, const T* __restrict__ first_part,
    const T* __restrict__ last_part, T* __restrict__ y, int64_t n_fix) {
  const int lane = threadIdx.x & 31;
  const int64_t f = (static_cast<int64_t>(blockIdx.x) * THREADS
                     + threadIdx.x) >> 5;
  if (f >= n_fix) return;                    // whole warps leave together
  const int64_t w = fix[f];
  const int64_t r = split[w];                // the row that holds entry e0
  const int64_t ws = static_cast<int64_t>(rowptr[r]) / SHARE;
  T acc = T(0);
  for (int64_t v = ws + 1 + lane; v <= w; v += 32) acc += first_part[v];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  if (lane == 0) y[r] = last_part[ws] + acc;
}

template <typename T, typename I>
int launch(const void* rowptr, const void* colind, const void* vals,
           const void* split, const void* fix, const void* x, void* y,
           void* parts, int64_t n_rows, int64_t nnz, int64_t n_shares,
           int64_t n_fix, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_shares < 1 || n_shares != (nnz + SHARE - 1) / SHARE + (nnz == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* first = static_cast<T*>(parts);
  csr_spmv_kernel<T, I><<<static_cast<unsigned>(
                              (n_shares * 32 + THREADS - 1) / THREADS),
                          THREADS, 0, s>>>(
      static_cast<const I*>(rowptr), static_cast<const I*>(colind),
      static_cast<const T*>(vals), static_cast<const I*>(split),
      static_cast<const T*>(x), static_cast<T*>(y), first, first + n_shares,
      n_rows, nnz, n_shares);
  if (n_fix > 0)
    csr_fixup_kernel<T, I><<<static_cast<unsigned>(
                                 (n_fix * 32 + THREADS - 1) / THREADS),
                             THREADS, 0, s>>>(
        static_cast<const I*>(rowptr), static_cast<const I*>(split),
        static_cast<const I*>(fix), first, first + n_shares,
        static_cast<T*>(y), n_fix);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define EL_CSR(NAME, T, I)                                                   \
  int NAME(const void* rowptr, const void* colind, const void* vals,         \
           const void* split, const void* fix, const void* x, void* y,       \
           void* parts, int64_t n_rows, int64_t nnz, int64_t n_shares,       \
           int64_t n_fix, void* stream) {                                    \
    return launch<T, I>(rowptr, colind, vals, split, fix, x, y, parts,       \
                        n_rows, nnz, n_shares, n_fix, stream);               \
  }

EL_CSR(el_csr_spmv_f32_i32, float, int32_t)
EL_CSR(el_csr_spmv_f32_i64, float, int64_t)
EL_CSR(el_csr_spmv_f64_i32, double, int32_t)
EL_CSR(el_csr_spmv_f64_i64, double, int64_t)

#undef EL_CSR

}  // extern "C"
