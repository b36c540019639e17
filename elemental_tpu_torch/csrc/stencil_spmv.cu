// K3: the stencil (DIA) sparse matrix-vector product, on Hopper.
//
// Replaces the TPU kernel elemental_tpu/kernels/spmv.py:stencil_spmv (body
// _stencil_kernel), which the JAX package reaches from the 'stencil' and
// 'stencil_rcm' tiers of elemental_tpu/sparse/auto_plan.py:plan_spmv.
//
// What it computes, for every row i in [0, n):
//
//     y[i] = sum over s in [0, S) of w[s*n + i] * x[i + off[s]]
//
// with x[j] read as 0 for j outside [0, width).  The sum runs over the
// diagonals in plan order, as the reference's acc = acc + w[s]*xs does.
//
// Design: one thread per output row, grid-stride.  The TPU kernel viewed x
// as a (rows x 1024-lane) panel with a lane halo, so that each diagonal
// became one static (row, lane) shift of a VMEM-resident panel: the TPU's
// gathers are scalar and its vector slices must be static.  Here each
// thread reads x at its own row plus the diagonal's offset: for a fixed s,
// the 32 threads of a warp read 32 neighbouring weights and 32 neighbouring
// x values, so every read is coalesced, and the diagonals' overlapping
// windows of x are served from L1/L2.  The offsets are a small int64 array
// in device memory; all threads of a warp read the same offset, which the
// hardware broadcasts.  S is a run-time value (plan_spmv admits up to
// max(8, 16*nnz/n) diagonals), so no template constant caps it.
//
// What bounds it: bytes.  A product streams S weight planes, reads x (once
// from DRAM, S times from cache) and writes y: (S+2)*n*sizeof(T) bytes of
// DRAM traffic.  For the 1024^2 Laplacian in f32 that is 29.4 MB, about
// 9 us at 3.35 TB/s, so at that size launch overhead is a large share.
// Vector loads and a register tile of rows per thread are left for later
// work.
//
// Indices: the weight index s*n + i is of type I, int32 while S*n < 2^31
// and int64 above (the port's one index-width rule); the row loop and the
// column i + off[s] run in int64, so neither can overflow.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cstdint>

template <typename T, typename I>
__global__ void stencil_spmv_kernel(const T* __restrict__ w,
                                    const int64_t* __restrict__ off,
                                    const T* __restrict__ x,
                                    T* __restrict__ y, I n, int64_t width,
                                    int S) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x; i < n; i += stride) {
    const I row = static_cast<I>(i);
    T acc = T(0);
    for (int s = 0; s < S; ++s) {
      const int64_t j = i + off[s];
      const T xv = (j >= 0 && j < width) ? x[j] : T(0);
      acc = acc + w[static_cast<I>(s) * n + row] * xv;
    }
    y[i] = acc;
  }
}

template <typename T, typename I>
static int launch(const void* w, const void* off, const void* x, void* y,
                  int64_t n, int64_t width, int64_t S, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t max_blocks = 65535;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  stencil_spmv_kernel<T, I><<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const int64_t*>(off),
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<I>(n), width,
      static_cast<int>(S));
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

#define EL_STENCIL(NAME, T, I)                                              \
  int NAME(const void* w, const void* off, const void* x, void* y,          \
           int64_t n, int64_t width, int64_t S, void* stream) {             \
    return launch<T, I>(w, off, x, y, n, width, S, stream);                 \
  }

EL_STENCIL(el_stencil_spmv_f32_i32, float, int32_t)
EL_STENCIL(el_stencil_spmv_f32_i64, float, int64_t)
EL_STENCIL(el_stencil_spmv_f64_i32, double, int32_t)
EL_STENCIL(el_stencil_spmv_f64_i64, double, int64_t)

#undef EL_STENCIL

}  // extern "C"
