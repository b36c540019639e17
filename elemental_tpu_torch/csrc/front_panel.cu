// K8: one panel of the blocked LDLᵀ (LDLᴴ) front factor, for every front of
// an elimination-tree level in one launch.
//
// Replaces no TPU kernel: the JAX package leaves the panel's column loop of
// elemental_tpu/sparse_direct/numeric.py:_masked_partial_ldl_blocked to XLA,
// which compiles the loop into one program.  The port ran the same loop
// from Python, about 15 small tensor operations a column over the level's
// whole padded batch (elemental_tpu_torch/kernels/front_panel.py:
// ldl_panel_plain), and that host loop held the card idle for most of a
// factor.  This kernel takes the loop's place; the trailing rank-nb update
// stays a batched matmul (sparse_direct/numeric.py).
//
// What it computes, for each front f of the level (F: nf fronts of S rows,
// row major with ldf values a row, lower triangle meaningful: a square
// front has ldf = S; the distributed front's gathered panel, its rows from
// the panel's first pivot down, has ldf = w) and the panel's columns
// [j0, j0 + w):
// for k = j0 .. j0 + w - 1 in turn,
//   dk   = F[k][k], clamped by the signed floor pf[f][k] where ns[f] > k
//          (numeric._clamp_pivot: a too-small pivot's magnitude raised to
//          |s|, its sign kept; an exactly-zero pivot takes the floor's);
//   safe = dk == 0 ? 1 : dk;
//   c_i  = ns[f] > k && i > k ? F[i][k] / safe : 0, for every row i;
//   F[i][j] -= (c_i · c'_j) · dk for i > k and panel columns j > k, with
//          c' = conj(c) for an LDLᴴ factor (conjugate) and c' = c otherwise;
//   F[i][k] = c_i where c_i was computed (i > k, ns[f] > k); F[k][k] = dk.
// With scratch pointers it also writes the masked panel Lp[f][i - j0][t] =
// (i > j0 + t && j0 + t < ns[f]) ? F[i][j0 + t] : 0 and Lp·dp (each entry
// times its column's pivot dk) for the rows i >= j0, so the caller's
// trailing update is one matmul and one subtraction.
//
// Every product, quotient and difference is rounded on its own
// (__fmul_rn, __dsub_rn, ...), in the plain loop's order, so nothing is
// contracted into an FMA: float32 and float64 come out bit-equal to the
// plain loop.  Complex values take the textbook product and PyTorch's
// quotient: a pivot with no imaginary part gives PyTorch's bits, a complex
// one values within a few ulps of them.
//
// What bounds it: bytes.  The panel is read and written once, and the two
// scratch panels written once: 4 · nf · (S - j0) · w values.  The work,
// ~1.5 w² flops a row, is small beside that, but each row's w steps are a
// chain of dependent divisions and updates.
//
// Design.  Rows below the panel's diagonal block depend only on the
// factored w × w diagonal block (its pivots and its columns' values), so
// the grid is one block per (front, tile of R rows below the diagonal
// block).  Each block
//   1. loads its front's diagonal block into shared memory, and warp 0
//      eliminates it, one lane a row, the steps kept in order by
//      __syncwarp; each step's pivot, its divisor and the block's column
//      c' go to shared memory.  The front's last block to have read the
//      diagonal block (a counter a front, arrivals[f], which that block
//      resets to 0) stores it factored, with its scratch rows: blocks run
//      in no order, and none may read what another writes;
//   2. loads its R rows' w panel values (a row's panel entries are w
//      contiguous values of the row-major front, so a warp reads a row's
//      32 values in one coalesced transaction), and one thread a row runs
//      the row's w-step substitution in shared memory (row stride w + 1:
//      no bank conflicts); then the tile is stored the same way.
// R is 128, halved down to 32 while the level has fewer than two blocks an
// SM, so a level of one large front (the root) still spreads over the card.
// The ragged last panel (w < 32, S - j0 = w) is just a narrower panel: a
// level is never padded.
//
// Complex pools (complex64, complex128) run the same kernel on a value
// type of two reals, as K1 does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing (the
// caller gives arrivals, nf zeroed ints, and gets them back zeroed),
// returns the first CUDA error of the launch so the caller can raise.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NB = 32;           // widest panel
constexpr int LDS = NB + 1;      // shared row stride: no bank conflicts
constexpr int MAX_ROWS = 128;    // rows (threads) a block

template <typename R>
struct alignas(2 * sizeof(R)) Complex {
  R re, im;
};

// Each operation rounded on its own: the plain loop's tensor operations
#define EL_OP(T, NAME, INTRINSIC)                                         \
  __device__ __forceinline__ T NAME(T a, T b) { return INTRINSIC(a, b); }
EL_OP(float, mul, __fmul_rn)
EL_OP(double, mul, __dmul_rn)
EL_OP(float, sub, __fsub_rn)
EL_OP(double, sub, __dsub_rn)
EL_OP(float, add, __fadd_rn)
EL_OP(double, add, __dadd_rn)
EL_OP(float, quo, __fdiv_rn)
EL_OP(double, quo, __ddiv_rn)
EL_OP(float, mag, hypotf)
EL_OP(double, mag, hypot)
#undef EL_OP
__device__ __forceinline__ float mag(float a) { return fabsf(a); }
__device__ __forceinline__ double mag(double a) { return fabs(a); }

template <typename R>
__device__ __forceinline__ Complex<R> mul(Complex<R> a, Complex<R> b) {
  return {sub(mul(a.re, b.re), mul(a.im, b.im)),
          add(mul(a.re, b.im), mul(a.im, b.re))};
}
template <typename R>
__device__ __forceinline__ Complex<R> sub(Complex<R> a, Complex<R> b) {
  return {sub(a.re, b.re), sub(a.im, b.im)};
}
// PyTorch's quotient (c10::complex): Smith's, scaled by the larger part of
// the divisor, the numerator times the reciprocal of the denominator; by a
// real divisor it is a·(1/c), as PyTorch computes it
template <typename R>
__device__ __forceinline__ Complex<R> quo(Complex<R> a, Complex<R> b) {
  if (mag(b.re) >= mag(b.im)) {
    const R r = quo(b.im, b.re);
    const R scl = quo(R(1), add(b.re, mul(b.im, r)));
    return {mul(add(a.re, mul(a.im, r)), scl),
            mul(sub(a.im, mul(a.re, r)), scl)};
  }
  const R r = quo(b.re, b.im);
  const R scl = quo(R(1), add(b.im, mul(b.re, r)));
  return {mul(add(mul(a.re, r), a.im), scl),
          mul(sub(mul(a.im, r), a.re), scl)};
}

template <typename T> struct Num;

template <typename R>
struct NumReal {
  __device__ static R zero() { return R(0); }
  __device__ static R one() { return R(1); }
  __device__ static bool is_zero(R x) { return x == R(0); }
  __device__ static R conj(R x) { return x; }
  // numeric._clamp_pivot on reals: sgn(·)·|s| is ±|s| exactly
  __device__ static R clamp(R dk, R s) {
    const R m = mag(s);
    if (s != R(0) && mag(dk) < m) {
      const R sg = dk == R(0) ? s : dk;
      return sg > R(0) ? m : (sg < R(0) ? -m : R(0));
    }
    return dk;
  }
};
template <> struct Num<float> : NumReal<float> {};
template <> struct Num<double> : NumReal<double> {};

template <typename R>
struct Num<Complex<R>> {
  using T = Complex<R>;
  __device__ static T zero() { return {R(0), R(0)}; }
  __device__ static T one() { return {R(1), R(0)}; }
  __device__ static bool is_zero(T x) { return x.re == R(0) && x.im == R(0); }
  __device__ static T conj(T x) { return {x.re, -x.im}; }
  // numeric._clamp_pivot on complex values: the sign is z/|z|
  __device__ static T clamp(T dk, T s) {
    const R m = mag(s.re, s.im);
    if (!is_zero(s) && mag(dk.re, dk.im) < m) {
      const T z = is_zero(dk) ? s : dk;
      const R a = mag(z.re, z.im);
      const T sg = {quo(z.re, a), quo(z.im, a)};
      return mul(sg, T{m, R(0)});
    }
    return dk;
  }
};

template <typename T>
__global__ void __launch_bounds__(MAX_ROWS) ldl_panel_kernel(
    T* __restrict__ F, const int64_t* __restrict__ ns,
    const T* __restrict__ pf, T* __restrict__ lp, T* __restrict__ ld,
    int* __restrict__ arrivals, int64_t S, int64_t ldf, int64_t j0, int w,
    int conjugate, int64_t tiles) {
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const int rows = blockDim.x;               // R: one thread a row
  T* tile = reinterpret_cast<T*>(smem_raw);  // rows × LDS (first w: block)
  T* rowv = tile + rows * LDS;               // NB × NB: step kk's c'
  T* dks = rowv + NB * NB;                   // step kk's pivot
  T* safes = dks + NB;                       // and its divisor
  int* elim = reinterpret_cast<int*>(safes + NB);

  const int tid = threadIdx.x;
  const int64_t f = blockIdx.x / tiles;
  const int64_t t = blockIdx.x % tiles;
  T* Ff = F + f * S * ldf;
  const int64_t nsf = ns[f];
  const int64_t rs = S - j0;                 // scratch rows of a front

  // 1. the diagonal block, read by every block of the front; the last
  // block to have read it (arrivals[f]) stores it factored, so no block
  // reads a value another one writes.  The last resets arrivals[f] to 0
  // for the next launch.
  for (int e = tid; e < w * w; e += rows) {
    const int r = e / w, c = e % w;
    tile[r * LDS + c] = Ff[(j0 + r) * ldf + j0 + c];
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(arrivals + f, 1) == tiles - 1;
    if (last) arrivals[f] = 0;
  }
  // warp 0 eliminates it, one lane a row
  if (tid < 32) {
    const int lane = tid;
    for (int kk = 0; kk < w; ++kk) {
      const bool el = nsf > j0 + kk;
      T dk = tile[kk * LDS + kk];
      if (el && pf != nullptr) dk = N::clamp(dk, pf[f * S + j0 + kk]);
      const T safe = N::is_zero(dk) ? N::one() : dk;
      const bool below = el && lane > kk && lane < w;
      T c = N::zero();
      if (below) c = quo(tile[lane * LDS + kk], safe);
      rowv[kk * NB + lane] = conjugate ? N::conj(c) : c;
      if (lane == 0) {
        dks[kk] = dk;
        safes[kk] = safe;
        elim[kk] = el;
      }
      __syncwarp();
      if (lane > kk && lane < w) {
        T* row = tile + lane * LDS;
        for (int jj = kk + 1; jj < w; ++jj)
          row[jj] = sub(row[jj], mul(mul(c, rowv[kk * NB + jj]), dk));
        if (below) row[kk] = c;
      }
      if (lane == kk) tile[kk * LDS + kk] = dk;
      __syncwarp();
    }
  }
  __syncthreads();
  if (last) {
    for (int e = tid; e < w * w; e += rows) {
      const int r = e / w, c = e % w;
      const T v = tile[r * LDS + c];
      Ff[(j0 + r) * ldf + j0 + c] = v;
      if (lp != nullptr) {
        const T l = (r > c && elim[c]) ? v : N::zero();
        const int64_t o = (f * rs + r) * w + c;
        lp[o] = l;
        ld[o] = mul(l, dks[c]);
      }
    }
  }
  const int64_t r0 = j0 + w + t * rows;      // this block's first row
  if (r0 >= S) return;
  const int nr = static_cast<int>(S - r0 < rows ? S - r0 : rows);
  __syncthreads();                           // the block is read: reuse tile

  // 2. this block's rows below the diagonal block, one thread a row; where
  // ns[f] <= k, c = 0 and the update subtracts (0 · c'_j) · dk, as the
  // plain loop does
  for (int e = tid; e < nr * w; e += rows) {
    const int r = e / w, c = e % w;
    tile[r * LDS + c] = Ff[(r0 + r) * ldf + j0 + c];
  }
  __syncthreads();
  if (tid < nr) {
    T* row = tile + tid * LDS;
    for (int kk = 0; kk < w; ++kk) {
      const bool el = elim[kk];
      const T c = el ? quo(row[kk], safes[kk]) : N::zero();
      const T dk = dks[kk];
      for (int jj = kk + 1; jj < w; ++jj)
        row[jj] = sub(row[jj], mul(mul(c, rowv[kk * NB + jj]), dk));
      if (el) row[kk] = c;
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * w; e += rows) {
    const int r = e / w, c = e % w;
    const T v = tile[r * LDS + c];
    Ff[(r0 + r) * ldf + j0 + c] = v;
    if (lp != nullptr) {
      const T l = elim[c] ? v : N::zero();
      const int64_t o = (f * rs + (r0 - j0) + r) * w + c;
      lp[o] = l;
      ld[o] = mul(l, dks[c]);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess)
    return 132;
  return sms;
}

template <typename T>
int launch(void* F, const void* ns, const void* pf, void* lp, void* ld,
           void* arrivals, int64_t nf, int64_t S, int64_t ldf, int64_t j0,
           int64_t w, int64_t conjugate, void* stream) {
  if (nf <= 0) return 0;
  // rows below the diagonal block; R halved while the level would have
  // fewer than two blocks an SM
  const int64_t below = S - j0 - w;
  const int64_t want = 2 * static_cast<int64_t>(sm_count());
  int rows = MAX_ROWS;
  auto tiles_of = [&](int r) {
    return below > 0 ? (below + r - 1) / r : int64_t(1);
  };
  while (rows > 32 && nf * tiles_of(rows) < want) rows /= 2;
  const int64_t tiles = tiles_of(rows);
  const size_t smem = sizeof(T) * (static_cast<size_t>(rows) * LDS
                                   + NB * NB + 2 * NB) + sizeof(int) * NB;
  cudaError_t err = cudaFuncSetAttribute(
      ldl_panel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ldl_panel_kernel<T><<<static_cast<unsigned>(nf * tiles), rows, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(F), static_cast<const int64_t*>(ns),
      static_cast<const T*>(pf), static_cast<T*>(lp), static_cast<T*>(ld),
      static_cast<int*>(arrivals), S, ldf, j0, static_cast<int>(w),
      static_cast<int>(conjugate), tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define EL_PANEL(NAME, T)                                                    \
  int NAME(void* F, const void* ns, const void* pf, void* lp, void* ld,     \
           void* arrivals, int64_t nf, int64_t S, int64_t ldf, int64_t j0,   \
           int64_t w, int64_t conjugate, void* stream) {                     \
    return launch<T>(F, ns, pf, lp, ld, arrivals, nf, S, ldf, j0, w,         \
                     conjugate, stream);                                     \
  }

EL_PANEL(el_ldl_panel_f32, float)
EL_PANEL(el_ldl_panel_f64, double)
EL_PANEL(el_ldl_panel_c64, Complex<float>)
EL_PANEL(el_ldl_panel_c128, Complex<double>)

#undef EL_PANEL

}  // extern "C"
