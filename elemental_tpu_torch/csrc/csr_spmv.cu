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
// Design: a group of G lanes (a power of two, 2 to 32, chosen by the caller
// from the mean row length) per row.  Lane l of a group sums the entries
// k = rowptr[r] + l, + l + G, ... in order; the G partial sums are then
// combined by a shuffle tree in a fixed order.  No atomics, so y is the
// same from run to run.  The TPU kernel sorted the entries by column and
// cut them into 1024-entry tiles that each read a 256-column window of x,
// because its only vector gather works within one (8, 128) register; the
// row sums then went through XLA's scalar scatter.  The H100 gathers x
// directly from device memory (through L1/L2), and a row's entries are
// contiguous in CSR, so the gather and the row sum fuse into this one pass.
//
// What bounds it: bytes, and the latency of the scattered reads of x.  A
// product streams vals and colind once (nnz * (sizeof(T) + sizeof(I))),
// rowptr once, writes y, and reads x at random: for uniform random columns
// each read of x touches its own 32-byte sector.  At n = 2^20 with 10
// entries a row in f32 the streamed bytes are ~96 MB, about 29 us at
// 3.35 TB/s; x (4 MB) fits in the 50 MB L2, so its random reads hit L2.
// Vector loads of vals/colind and a tuned group size are left for later
// work.
//
// Indices: rowptr and colind are of type I, int32 while nnz and n_cols are
// below 2^31 and int64 above (the port's one index-width rule); rows and
// entry positions run in int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cstdint>

template <typename T, typename I, int G>
__global__ void csr_spmv_kernel(const I* __restrict__ rowptr,
                                const I* __restrict__ colind,
                                const T* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y,
                                int64_t n_rows) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int lane = threadIdx.x & (G - 1);
  const int64_t n_groups = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  // The loop bound is the same for every lane of a warp (a warp holds
  // 32 / G whole groups and the first row of the warp is the test), so all
  // 32 lanes reach the shuffles together.
  const int64_t warp_first = (tid & ~int64_t(31)) / G;
  for (int64_t base = warp_first; base < n_rows; base += n_groups) {
    const int64_t r = base + (tid / G - warp_first);
    T acc = T(0);
    if (r < n_rows) {
      const int64_t e = rowptr[r + 1];
      for (int64_t k = rowptr[r] + lane; k < e; k += G)
        acc = acc + vals[k] * x[colind[k]];
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      acc = acc + __shfl_down_sync(0xffffffffu, acc, o, G);
    if (lane == 0 && r < n_rows) y[r] = acc;
  }
}

template <typename T, typename I, int G>
static void launch_g(const void* rowptr, const void* colind, const void* vals,
                     const void* x, void* y, int64_t n_rows,
                     cudaStream_t stream) {
  const int threads = 256;
  const int64_t max_blocks = 65535;
  int64_t blocks = (n_rows * G + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  csr_spmv_kernel<T, I, G><<<static_cast<unsigned>(blocks), threads, 0,
                             stream>>>(
      static_cast<const I*>(rowptr), static_cast<const I*>(colind),
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), n_rows);
}

template <typename T, typename I>
static int launch(const void* rowptr, const void* colind, const void* vals,
                  const void* x, void* y, int64_t n_rows, int64_t group,
                  void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 2: launch_g<T, I, 2>(rowptr, colind, vals, x, y, n_rows, s); break;
    case 4: launch_g<T, I, 4>(rowptr, colind, vals, x, y, n_rows, s); break;
    case 8: launch_g<T, I, 8>(rowptr, colind, vals, x, y, n_rows, s); break;
    case 16: launch_g<T, I, 16>(rowptr, colind, vals, x, y, n_rows, s); break;
    case 32: launch_g<T, I, 32>(rowptr, colind, vals, x, y, n_rows, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

#define EL_CSR(NAME, T, I)                                                  \
  int NAME(const void* rowptr, const void* colind, const void* vals,        \
           const void* x, void* y, int64_t n_rows, int64_t group,           \
           void* stream) {                                                  \
    return launch<T, I>(rowptr, colind, vals, x, y, n_rows, group, stream); \
  }

EL_CSR(el_csr_spmv_f32_i32, float, int32_t)
EL_CSR(el_csr_spmv_f32_i64, float, int64_t)
EL_CSR(el_csr_spmv_f64_i32, double, int32_t)
EL_CSR(el_csr_spmv_f64_i64, double, int64_t)

#undef EL_CSR

}  // extern "C"
