// K9: the tree solve's level scatter, xe[front_rows] += w - xf, on Hopper.
//
// Replaces no TPU kernel: the JAX package leaves this scatter,
// elemental_tpu/sparse_direct/numeric.py:_level_solve's
// xe.at[rows.reshape(-1)].add(w - xf), to XLA.  The port ran it as an
// elementwise w - xf and an atomic index_add_ over all nf*S slots of the
// level.  The symbolic plan pads every front of a level to the level's
// largest size S and points every padded slot at the dummy row n, so most
// of those atomics (77 % of the LP KKT plan's slots at n1 = 224, 68 % of the
// 48^3 Laplacian's) added zeros into one address, serialised: ~200 ms of a
// 260 ms refined KKT solve.
//
// What it computes, per (destination row r = rows[i], column c):
//   acc = xe[r, c];  for s in slots[off[i] : off[i+1]] (ascending):
//   acc += w[s, c] - xf[s, c];  xe[r, c] = acc.
// With xf null it adds w[s, c] alone: the plain solve's forward step adds
// K10's -L21 w1 (csrc/level_solve.cu) over a plan of the update slots.
// The plan (elemental_tpu_torch/sparse_direct/solve_plan.py) holds only the
// real slots, as CSR segments by destination row with each segment in
// ascending slot order, so the sum is the one a sequential index_add_ of the
// same deltas takes, bit for bit, and the same on every run.  No padded
// slot is read and row n is never written.
//
// What bounds it: launches.  The LP plan has 1.05 M real slots over 37
// levels; a tree-solve direction reads w, xf and a slot id a slot and an
// offset, a row id and xe's value (read and written) a row: ~22 MB in f32,
// ~7 us at 3.35 TB/s over 37 launches of a few us each.
//
// Design: one thread a (row, column) pair, neighbouring columns on
// neighbouring threads; no atomics, no shared memory.  Complex values run on
// a value type of two reals with componentwise + and -, aligned as the
// tensor's elements, as K1 takes them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename R>
struct alignas(2 * sizeof(R)) Complex {
  R re, im;
  __device__ Complex& operator+=(const Complex& o) {
    re += o.re;
    im += o.im;
    return *this;
  }
  __device__ Complex operator-(const Complex& o) const {
    Complex r;
    r.re = re - o.re;
    r.im = im - o.im;
    return r;
  }
};

constexpr int THREADS = 256;

template <typename T, typename I, bool DIFF>
__global__ void __launch_bounds__(THREADS) level_scatter_kernel(
    T* xe, const T* __restrict__ w, const T* __restrict__ xf,
    const I* __restrict__ rows, const I* __restrict__ off,
    const I* __restrict__ slots, int64_t n_rows, int64_t k) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= n_rows * k) return;
  const int64_t i = t / k;
  const int64_t c = t - i * k;
  const int64_t dst = static_cast<int64_t>(rows[i]) * k + c;
  const I e = off[i + 1];
  T acc = xe[dst];
  for (I s = off[i]; s < e; ++s) {
    const int64_t q = static_cast<int64_t>(slots[s]) * k + c;
    if constexpr (DIFF)
      acc += w[q] - xf[q];
    else
      acc += w[q];
  }
  xe[dst] = acc;
}

template <typename T, typename I>
int launch(void* xe, const void* w, const void* xf, const void* rows,
           const void* off, const void* slots, int64_t n_rows, int64_t k,
           void* stream) {
  const int64_t blocks = (n_rows * k + THREADS - 1) / THREADS;
  if (blocks <= 0) return 0;
  const unsigned grid = static_cast<unsigned>(blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xf)
    level_scatter_kernel<T, I, true><<<grid, THREADS, 0, st>>>(
        static_cast<T*>(xe), static_cast<const T*>(w),
        static_cast<const T*>(xf), static_cast<const I*>(rows),
        static_cast<const I*>(off), static_cast<const I*>(slots), n_rows, k);
  else
    level_scatter_kernel<T, I, false><<<grid, THREADS, 0, st>>>(
        static_cast<T*>(xe), static_cast<const T*>(w), nullptr,
        static_cast<const I*>(rows), static_cast<const I*>(off),
        static_cast<const I*>(slots), n_rows, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define EL_LS(NAME, T, I)                                                    \
  int NAME(void* xe, const void* w, const void* xf, const void* rows,        \
           const void* off, const void* slots, int64_t n_rows, int64_t k,    \
           void* stream) {                                                   \
    return launch<T, I>(xe, w, xf, rows, off, slots, n_rows, k, stream);     \
  }

EL_LS(el_level_scatter_f32_i32, float, int32_t)
EL_LS(el_level_scatter_f32_i64, float, int64_t)
EL_LS(el_level_scatter_f64_i32, double, int32_t)
EL_LS(el_level_scatter_f64_i64, double, int64_t)
EL_LS(el_level_scatter_c64_i32, Complex<float>, int32_t)
EL_LS(el_level_scatter_c64_i64, Complex<float>, int64_t)
EL_LS(el_level_scatter_c128_i32, Complex<double>, int32_t)
EL_LS(el_level_scatter_c128_i64, Complex<double>, int64_t)

#undef EL_LS

}  // extern "C"
