// K10: the plain tree solve's level step, by substitution, on Hopper.
//
// Replaces no TPU kernel: the JAX package runs this step,
// elemental_tpu/sparse_direct/numeric.py:_level_solve, as a batched
// triangular solve that XLA compiles.  The port ran it the same way: every
// level step of every solve built masked nf x S x S unit-lower panels from
// the pool (arange, compares, where, eye) and solved over the whole padded
// S x S triangle.  At 48^3 that is ~44x the bytes of the L panels a solve
// needs, and ~47 kernels a level step.
//
// What it computes, for each front f of one level (ns pivots, sz real rows,
// padded order S; rows[f, :] its permuted row ids) and each column c of xe:
//   forward:  w1 = L11^-1 x1 (unit lower), written over the pivot rows
//             x1 = xe[rows[f, :ns]];  delta[f*S + i] = -(L21 w1)_i for the
//             update rows ns <= i < sz (K9 then adds them into xe);
//   backward: w1 = L11^-T (x1 - L21^T x2), x2 = xe[rows[f, ns:sz]], written
//             over the pivot rows; L^H for a Hermitian factor (conj != 0).
// Fronts of one level are independent siblings: a front's pivot rows are
// written by that front alone and read by no other front of the level.
// L is read in place from the pool, front f at pool[f*S*S + i*S + j], and
// only at j < ns, j < i < sz: no padded slot, no diagonal (D), no trailing
// block.  Flat offsets are 64-bit (the 48^3 pool holds 1.46 G entries).
//
// What bounds it: the L panels' bytes (264 MB a direction at 48^3 in f64,
// ~0.08 ms at 3.35 TB/s), then the top of the tree, where a level is one or
// two fronts and the triangular solve of a front is a chain of dependent
// 32-row diagonal blocks (the root's ns = 2,563: 81 of them).
//
// Design: one block a front and column (forward_front, backward_front),
// 32 * warps threads.
//   * Forward, pivot rows, left-looking: for each 32-row diagonal block the
//     block's threads take the columns j left of it (one j a thread, its 32
//     rows' entries L[r0+s, j] coalesced across threads), each warp reduces
//     its 32 row sums by a transposing butterfly (31 shuffles), warp 0 adds
//     the warps' sums in order and solves the diagonal block, staged in
//     shared memory, by shuffles.
//   * Forward, update rows: one warp a block of 32 rows, lanes over j, the
//     same butterfly; no reduction across warps.
//   * Backward: first x1 -= L21^T x2 in 32-column tiles (lanes over j,
//     warps over rows, the rows' values staged in shared memory, the warps'
//     partial sums added in order), then the triangle right-looking from
//     the bottom: warp 0 solves a diagonal block (its transposed entries
//     read along rows of the staged tile), then every thread takes a column
//     j left of it and subtracts the block's 32 entries L[jb+s, j]
//     (coalesced across threads) times the block's w.
//   * A level of a front with more than PANEL = 256 pivots, or of few fronts
//     with large L21 panels, is split: the front kernels solve one panel of
//     256 pivots a launch, and between panels the panel's products with the
//     rest of the front (the rows below it, forward_update; the columns left
//     of it and, first, L21^T, backward_update) run over many blocks, so
//     that no block walks a long panel alone.  The 48^3 root (ns = 2,563)
//     takes 11 panels, 22 launches a direction from one host call; the
//     host's plan (solve_plan.py) chooses the split per level.
//   * The front kernels keep the panel's pivot values in shared memory.
// Every loop over L issues a batch of loads before it uses them, with no
// branch between them (a row or column past the panel's edge is clamped to
// its last one and its product left out): the top levels are chains of
// small steps on few SMs, where loads in flight are what sets the time.
// No atomics and a fixed summation order: the same inputs give the same
// bits.  xe is read and written through plain global loads and stores (a
// block's own writes are visible to it after __syncthreads).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NB = 32;            // rows of a diagonal block; lanes a warp
constexpr int MAX_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

template <typename R>
struct alignas(2 * sizeof(R)) Complex {
  R re, im;
};

template <typename R>
__device__ __forceinline__ Complex<R> operator+(Complex<R> a, Complex<R> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename R>
__device__ __forceinline__ Complex<R> operator-(Complex<R> a, Complex<R> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename R>
__device__ __forceinline__ Complex<R> operator-(Complex<R> a) {
  return {-a.re, -a.im};
}
template <typename R>
__device__ __forceinline__ Complex<R> operator*(Complex<R> a, Complex<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

__device__ __forceinline__ float conj_if(float a, bool) { return a; }
__device__ __forceinline__ double conj_if(double a, bool) { return a; }
template <typename R>
__device__ __forceinline__ Complex<R> conj_if(Complex<R> a, bool c) {
  return c ? Complex<R>{a.re, -a.im} : a;
}

__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(FULL, v, m);
}
__device__ __forceinline__ double shfl_xor(double v, int m) {
  return __shfl_xor_sync(FULL, v, m);
}
template <typename R>
__device__ __forceinline__ Complex<R> shfl_xor(Complex<R> v, int m) {
  return {shfl_xor(v.re, m), shfl_xor(v.im, m)};
}
__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(FULL, v, src);
}
__device__ __forceinline__ double shfl(double v, int src) {
  return __shfl_sync(FULL, v, src);
}
template <typename R>
__device__ __forceinline__ Complex<R> shfl(Complex<R> v, int src) {
  return {shfl(v.re, src), shfl(v.im, src)};
}

// One level as the kernels see it.
template <typename T, typename I>
struct Level {
  const T* pool;     // the level's first front
  const I* rows;     // (nf, S) permuted row ids, padding -> n
  const I* ns;       // (nf,) pivots a front
  const I* sz;       // (nf,) real rows a front
  T* xe;             // (n + 1, k)
  T* delta;          // (nf * S, k): forward's -L21 w1 at the update slots
  int64_t S, k;
  bool conj;         // backward: L^H
};

// One stage of transpose_reduce: lanes pair across bit H; each keeps the
// half of its values that the pair's bit selects and adds its partner's.
template <int H, typename T>
__device__ __forceinline__ void transpose_stage(T (&v)[NB], int lane) {
  const bool hi = lane & H;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const T send = hi ? v[r] : v[r + H];
    const T keep = hi ? v[r + H] : v[r];
    v[r] = keep + shfl_xor(send, H);
  }
}

// The sums over the 32 lanes of v[s], s < 32: lane s gets row s's (31
// shuffles); the order of every addition is fixed.  The stages are written
// out so that every index into v is a constant and v stays in registers.
template <typename T>
__device__ __forceinline__ T transpose_reduce(T (&v)[NB], int lane) {
  transpose_stage<16>(v, lane);
  transpose_stage<8>(v, lane);
  transpose_stage<4>(v, lane);
  transpose_stage<2>(v, lane);
  transpose_stage<1>(v, lane);
  return v[0];
}

// Rows of one batch of loads: as many as keep the batch and the 32 row
// sums in registers.  A batch's loads are issued before its products, and
// every load is unconditional: a row or column past the panel's edge is
// clamped to its last one (an L entry) and its product left out, so that no
// branch stands between two loads and the batch is in flight at once.
template <typename T>
struct Batch {
  static constexpr int rows = sizeof(T) >= 16 ? 8 : 16;
};

// acc[s] += Σ over this thread's columns of L[r0 + s, j] · w_j, s < nr, for
// the 32 rows of the block at r0; col points at L[r0, j].
template <typename T>
__device__ __forceinline__ void add_rows(T (&acc)[NB], const T* col,
                                         int64_t S, int nr, T w) {
  constexpr int B = Batch<T>::rows;
#pragma unroll
  for (int b = 0; b < NB; b += B) {
    T v[B];
#pragma unroll
    for (int s = 0; s < B; ++s)
      v[s] = col[static_cast<int64_t>(min(b + s, nr - 1)) * S];
#pragma unroll
    for (int s = 0; s < B; ++s)
      if (b + s < nr) acc[b + s] = acc[b + s] + v[s] * w;
  }
}

// A front's triangle is solved a panel of PANEL pivots at a time by one
// block; between two panels, the panel's products with the rows below it
// (forward) or the columns left of it (backward) are spread over many
// blocks.  A level whose fronts fit one panel and whose L21 panels are
// small takes one launch a direction instead.
constexpr int PANEL = NB * MAX_WARPS;

// A front's pivot values w[j]: the panel's copy in shared memory (xs[j - p0]
// for the panel's pivots) where a front kernel keeps one, else xe.
template <typename T, typename I>
struct Pivots {
  const Level<T, I>& lv;
  const I* r;
  T* xs;
  int p0, c;
  __device__ __forceinline__ T& operator[](int j) const {
    return xs ? xs[j - p0] : lv.xe[static_cast<int64_t>(r[j]) * lv.k + c];
  }
};

// Copy the pivot values p0 <= j < pe between xe and w's shared copy, the
// whole block.
template <typename T, typename I>
__device__ __forceinline__ void copy_panel(const Pivots<T, I>& w, int pe,
                                           bool in) {
  for (int j = w.p0 + threadIdx.x; j < pe; j += blockDim.x) {
    T& x = w.lv.xe[static_cast<int64_t>(w.r[j]) * w.lv.k + w.c];
    if (in)
      w.xs[j - w.p0] = x;
    else
      x = w.xs[j - w.p0];
  }
}

// Σ_{jbegin <= j < jend} L[r0 + s, j] · w[j] for s < nr, by the whole block
// (one column j a thread); lane s of warp 0 gets row s's sum.
template <typename T, typename I>
__device__ T block_row_sums(const T* L, int64_t S, const Pivots<T, I>& w,
                            int r0, int nr, int jbegin, int jend,
                            T (*red)[NB]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T acc[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) acc[s] = T{};
  for (int j = jbegin + static_cast<int>(threadIdx.x); j < jend;
       j += blockDim.x)
    add_rows(acc, L + static_cast<int64_t>(r0) * S + j, S, nr, w[j]);
  red[warp][lane] = transpose_reduce(acc, lane);
  __syncthreads();
  T t = T{};
  if (warp == 0)
    for (int q = 0; q < static_cast<int>(blockDim.x >> 5); ++q)
      t = t + red[q][lane];
  return t;
}

// Forward, one warp: delta[f*S + r0 + s] = -Σ_{j < ns} L[r0 + s, j] · w[j]
// for the update rows r0 + s < sz; a lane past ns reads column ns - 1 and
// adds nothing.
template <typename T, typename I>
__device__ void warp_update_rows(const Level<T, I>& lv, int64_t f,
                                 const T* L, const Pivots<T, I>& w, int r0,
                                 int nr, int ns) {
  const int lane = threadIdx.x & 31;
  T acc[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) acc[s] = T{};
  for (int j0 = 0; j0 < ns; j0 += NB) {
    const int j = min(j0 + lane, ns - 1);
    T wj = w[j];
    if (j0 + lane >= ns) wj = T{};
    add_rows(acc, L + static_cast<int64_t>(r0) * lv.S + j, lv.S, nr, wj);
  }
  const T t = transpose_reduce(acc, lane);
  if (lane < nr) lv.delta[(f * lv.S + r0 + lane) * lv.k + w.c] = -t;
}

// Backward, the whole block: x[j] -= Σ_{ibegin <= i < iend} op(L[i, j]) ·
// xe[rows[i]] for the 32 columns j0 <= j < min(j0 + 32, jend).  The rows
// go in chunks of one row a thread: each thread gathers its row's value
// into shared memory, and the next chunk's while this one is summed; each
// warp takes 32 rows of the chunk in one batch of loads (two for
// complex128), lanes over j, and the warps' sums are added in order.
template <typename T, typename I>
__device__ void block_col_update(const T* L, const Pivots<T, I>& x, int j0,
                                 int jend, int ibegin, int iend,
                                 T (*red)[NB], T* stage) {
  constexpr int B = sizeof(T) >= 16 ? NB / 2 : NB;
  const Level<T, I>& lv = x.lv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int chunk = blockDim.x;
  const int j = min(j0 + lane, jend - 1);
  auto gather = [&](int i) {
    return i < iend ? lv.xe[static_cast<int64_t>(x.r[i]) * lv.k + x.c]
                    : T{};
  };
  T next = gather(ibegin + static_cast<int>(threadIdx.x));
  T acc = T{};
  for (int c0 = ibegin; c0 < iend; c0 += chunk) {
    const int ch = min(chunk, iend - c0);
    __syncthreads();
    stage[threadIdx.x] = next;
    __syncthreads();
    next = gather(c0 + chunk + static_cast<int>(threadIdx.x));
    const int i0 = warp * NB;
    if (i0 < ch) {
      const T* col = L + static_cast<int64_t>(c0 + i0) * lv.S + j;
#pragma unroll
      for (int b = 0; b < NB; b += B) {
        T l[B];
#pragma unroll
        for (int u = 0; u < B; ++u)
          l[u] = col[static_cast<int64_t>(min(b + u, ch - i0 - 1)) * lv.S];
#pragma unroll
        for (int u = 0; u < B; ++u)
          if (i0 + b + u < ch)
            acc = acc + conj_if(l[u], lv.conj) * stage[i0 + b + u];
      }
    }
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && j0 + lane < jend) {
    T s = T{};
    for (int q = 0; q < warps; ++q) s = s + red[q][lane];
    x[j] = x[j] - s;
  }
  __syncthreads();
}

// Stage the strictly lower part of the diagonal block at (b0, b0), nb rows,
// into tile (rows of tile[s][q], q < s).
template <typename T>
__device__ __forceinline__ void stage_tile(const T* L, int64_t S, int b0,
                                           int nb, T (*tile)[NB + 1]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < nb; s += blockDim.x >> 5)
    if (lane < s) tile[s][lane] = L[static_cast<int64_t>(b0 + s) * S + b0 +
                                    lane];
}

// Blocks an SM must hold of the kernels with 32 values a thread (row sums
// or a batch of loads): two (at most 128 registers a thread) but for
// complex128, whose values alone take 128.  More registers made the
// backward front kernel slower even alone on an SM (the 48^3 root's
// backward step 3.7 ms against 1.6 ms at 128, on an H100).
template <typename T>
struct Occupancy {
  static constexpr int blocks = sizeof(T) >= 16 ? 1 : 2;
};

// Forward, the pivots p0 <= j < pe of each front (pe = ns where the level
// is fused, then also its update rows; else the panel's end).
template <typename T, typename I>
__global__ void __launch_bounds__(NB * MAX_WARPS, Occupancy<T>::blocks)
    forward_front(Level<T, I> lv, int p0, bool fused) {
  __shared__ T tile[NB][NB + 1];
  __shared__ T red[MAX_WARPS][NB];
  __shared__ T xs[PANEL];
  const int64_t f = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ns = static_cast<int>(lv.ns[f]);
  if (p0 >= ns) return;
  const int pe = fused ? ns : min(p0 + PANEL, ns);
  const T* L = lv.pool + f * lv.S * lv.S;
  const Pivots<T, I> w{lv, lv.rows + f * lv.S, xs, p0,
                       static_cast<int>(blockIdx.y)};
  copy_panel(w, pe, true);
  for (int r0 = p0; r0 < pe; r0 += NB) {
    const int nr = min(NB, pe - r0);
    stage_tile(L, lv.S, r0, nr, tile);
    T t = T{};
    if (r0 > p0) t = block_row_sums(L, lv.S, w, r0, nr, p0, r0, red);
    __syncthreads();
    if (warp == 0) {
      T x = lane < nr ? w[r0 + lane] - t : T{};
      for (int q = 0; q < nr; ++q) {
        const T wq = shfl(x, q);
        if (lane > q && lane < nr) x = x - tile[lane][q] * wq;
      }
      if (lane < nr) w[r0 + lane] = x;
    }
    __syncthreads();
  }
  copy_panel(w, pe, false);
  if (!fused) return;
  const int sz = static_cast<int>(lv.sz[f]);
  for (int r0 = ns + warp * NB; r0 < sz; r0 += (blockDim.x >> 5) * NB)
    warp_update_rows(lv, f, L, w, r0, min(NB, sz - r0), ns);
}

// Forward, after forward_front's panel at p0: the rows below the panel take
// its product, block b of front f the 32 rows from the panel's end + 32 b
// (threads over the panel's columns).  Pivot rows of later panels are
// updated in xe, update rows accumulate -L21·w1 in delta from p0 = 0 on.
template <typename T, typename I>
__global__ void __launch_bounds__(NB * MAX_WARPS, Occupancy<T>::blocks)
    forward_update(Level<T, I> lv, int p0, int per_front) {
  __shared__ T red[MAX_WARPS][NB];
  const int64_t f = blockIdx.x / per_front;
  const int b = blockIdx.x - static_cast<int>(f) * per_front;
  const int c = blockIdx.y;
  const int ns = static_cast<int>(lv.ns[f]);
  const int sz = static_cast<int>(lv.sz[f]);
  if (p0 >= ns) return;
  const int pe = min(p0 + PANEL, ns);
  const int r0 = pe + b * NB;
  if (r0 >= sz) return;
  const int nr = min(NB, sz - r0);
  const Pivots<T, I> w{lv, lv.rows + f * lv.S, nullptr, 0, c};
  const T t = block_row_sums(lv.pool + f * lv.S * lv.S, lv.S, w, r0, nr, p0,
                             pe, red);
  const int i = r0 + (threadIdx.x & 31);
  if (threadIdx.x < NB && i - r0 < nr) {
    if (i < ns) {
      w[i] = w[i] - t;
    } else {
      T& d = lv.delta[(f * lv.S + i) * lv.k + c];
      d = p0 == 0 ? -t : d - t;
    }
  }
}

// Backward, block b of front f: the 32 columns from 32 b left of the rows
// it applies take their product: with p0 < 0 the update rows ns <= i < sz
// (L21^T, before any panel), else the panel p0 <= i < min(p0 + PANEL, ns)
// just solved (the columns j < p0).
template <typename T, typename I>
__global__ void __launch_bounds__(NB * MAX_WARPS)
    backward_update(Level<T, I> lv, int p0, int per_front) {
  __shared__ T red[MAX_WARPS][NB];
  __shared__ T stage[NB * MAX_WARPS];
  const int64_t f = blockIdx.x / per_front;
  const int j0 = (blockIdx.x - static_cast<int>(f) * per_front) * NB;
  const int ns = static_cast<int>(lv.ns[f]);
  const int sz = static_cast<int>(lv.sz[f]);
  if (p0 >= ns) return;
  const int jend = p0 < 0 ? ns : p0;
  if (j0 >= jend) return;
  const Pivots<T, I> x{lv, lv.rows + f * lv.S, nullptr, 0,
                       static_cast<int>(blockIdx.y)};
  block_col_update(lv.pool + f * lv.S * lv.S, x, j0, jend,
                   p0 < 0 ? ns : p0, p0 < 0 ? sz : min(p0 + PANEL, ns), red,
                   stage);
}

// Backward, the pivots p0 <= j < pe of each front, from the bottom (pe = ns
// where the level is fused, which first applies L21^T here; else the
// panel's end).
template <typename T, typename I>
__global__ void __launch_bounds__(NB * MAX_WARPS, Occupancy<T>::blocks)
    backward_front(Level<T, I> lv, int p0, bool fused) {
  __shared__ T tile[NB][NB + 1];
  __shared__ T red[MAX_WARPS][NB];
  __shared__ T wsh[NB];
  __shared__ T stage[NB * MAX_WARPS];
  __shared__ T xs[PANEL];
  const int64_t f = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ns = static_cast<int>(lv.ns[f]);
  if (p0 >= ns) return;
  const int pe = fused ? ns : min(p0 + PANEL, ns);
  const T* L = lv.pool + f * lv.S * lv.S;
  const Pivots<T, I> w{lv, lv.rows + f * lv.S, xs, p0,
                       static_cast<int>(blockIdx.y)};
  copy_panel(w, pe, true);
  __syncthreads();
  if (fused) {
    const int sz = static_cast<int>(lv.sz[f]);
    for (int j0 = 0; j0 < ns; j0 += NB)
      block_col_update(L, w, j0, ns, ns, sz, red, stage);
  }
  for (int jb = p0 + (pe - 1 - p0) / NB * NB; jb >= p0; jb -= NB) {
    const int nb = min(NB, pe - jb);
    stage_tile(L, lv.S, jb, nb, tile);
    __syncthreads();
    if (warp == 0) {
      T y = lane < nb ? w[jb + lane] : T{};
      for (int q = nb - 1; q >= 0; --q) {
        const T wq = shfl(y, q);
        if (lane < q) y = y - conj_if(tile[q][lane], lv.conj) * wq;
      }
      if (lane < nb) {
        w[jb + lane] = y;
        wsh[lane] = y;
      }
    }
    __syncthreads();
    for (int j = p0 + static_cast<int>(threadIdx.x); j < jb;
         j += blockDim.x) {
      const T* col = L + static_cast<int64_t>(jb) * lv.S + j;
      T v[NB];
#pragma unroll
      for (int s = 0; s < NB; ++s)
        v[s] = col[static_cast<int64_t>(min(s, nb - 1)) * lv.S];
      T acc = w[j];
#pragma unroll
      for (int s = 0; s < NB; ++s)
        if (s < nb) acc = acc - conj_if(v[s], lv.conj) * wsh[s];
      w[j] = acc;
    }
    __syncthreads();
  }
  copy_panel(w, pe, false);
}

template <typename T, typename I>
int launch(const void* pool, int64_t offset, int64_t S, int64_t nf,
           const void* rows, const void* ns, const void* sz, void* xe,
           int64_t k, void* delta, int forward, int conj, int warps,
           int split, int update_warps, int64_t max_ns, void* stream) {
  if (nf <= 0 || k <= 0) return 0;
  Level<T, I> lv{static_cast<const T*>(pool) + offset,
                 static_cast<const I*>(rows),
                 static_cast<const I*>(ns),
                 static_cast<const I*>(sz),
                 static_cast<T*>(xe),
                 static_cast<T*>(delta),
                 S,
                 k,
                 conj != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 fronts(static_cast<unsigned>(nf), static_cast<unsigned>(k));
  auto per_front = [&](int per) {
    return dim3(static_cast<unsigned>(nf * per), static_cast<unsigned>(k));
  };
  const int threads = NB * warps;
  if (!split) {
    if (forward)
      forward_front<T, I><<<fronts, threads, 0, st>>>(lv, 0, true);
    else
      backward_front<T, I><<<fronts, threads, 0, st>>>(lv, 0, true);
  } else if (forward) {
    for (int p0 = 0; p0 < max_ns; p0 += PANEL) {
      forward_front<T, I><<<fronts, threads, 0, st>>>(lv, p0, false);
      const int per = static_cast<int>((S - p0 + NB - 1) / NB);
      forward_update<T, I><<<per_front(per), NB * update_warps, 0, st>>>(
          lv, p0, per);
    }
  } else {
    const int tiles = static_cast<int>((max_ns + NB - 1) / NB);
    backward_update<T, I><<<per_front(tiles), PANEL, 0, st>>>(lv, -1,
                                                                   tiles);
    for (int p0 = static_cast<int>((max_ns - 1) / PANEL * PANEL); p0 >= 0;
         p0 -= PANEL) {
      backward_front<T, I><<<fronts, threads, 0, st>>>(lv, p0, false);
      const int left = (p0 + NB - 1) / NB;
      if (left)
        backward_update<T, I><<<per_front(left), PANEL, 0, st>>>(lv, p0,
                                                                     left);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define EL_LV(NAME, T, I)                                                    \
  int NAME(const void* pool, int64_t offset, int64_t S, int64_t nf,          \
           const void* rows, const void* ns, const void* sz, void* xe,       \
           int64_t k, void* delta, int forward, int conj, int warps,         \
           int split, int update_warps, int64_t max_ns, void* stream) {      \
    return launch<T, I>(pool, offset, S, nf, rows, ns, sz, xe, k, delta,     \
                        forward, conj, warps, split, update_warps, max_ns,   \
                        stream);                                             \
  }

EL_LV(el_level_solve_f32_i32, float, int32_t)
EL_LV(el_level_solve_f32_i64, float, int64_t)
EL_LV(el_level_solve_f64_i32, double, int32_t)
EL_LV(el_level_solve_f64_i64, double, int64_t)
EL_LV(el_level_solve_c64_i32, Complex<float>, int32_t)
EL_LV(el_level_solve_c64_i64, Complex<float>, int64_t)
EL_LV(el_level_solve_c128_i32, Complex<double>, int32_t)
EL_LV(el_level_solve_c128_i64, Complex<double>, int64_t)

#undef EL_LV

}  // extern "C"
