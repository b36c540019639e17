// K4 and K5: the tiled matrix product and the masked rank-k update, on
// Hopper.
//
// Replaces the TPU kernels elemental_tpu/kernels/matmul.py:matmul
// (_matmul_kernel, K4) and masked_rank_k_update (its inner kernel, K5).
//
// What they compute, for a (m, k), b (k, n), c and out (m, n), all
// row-major and contiguous:
//
//     K4:  out = a · b, summed in float32 for float32 and bfloat16 inputs
//          and in float64 for float64, stored in a's dtype
//     K5:  out[r, j] = c[r, j] + alpha * (a · b)[r, j]   where r >= j (lower)
//                                                        or r <= j (upper)
//          out[r, j] = c[r, j]                           elsewhere
//
// K5 rounds its epilogue as the plain version does: the product is cast to
// c's dtype, multiplied by alpha, and added to c, each step rounded once
// (__fmul_rn then __fadd_rn: never contracted into one FMA).  Entries
// outside the triangle are copies of c, bit for bit, and a block whose tile
// lies wholly outside the triangle copies its tile of c and computes no
// product.
//
// Design: one 128 x 128 output tile per block of 256 threads, each thread a
// register tile of 8 x 8 (rows ty + 16 i, columns tx + 16 j, so neighbouring
// threads read neighbouring shared-memory words and store neighbouring
// columns).  A k-loop in steps of 8 stages the (128 x 8) tile of a,
// transposed and padded against bank conflicts, and the (8 x 128) tile of b
// in shared memory, converted to the summing type.  Ragged edges are
// handled by bounds checks: out-of-range elements load as 0 and are never
// stored.  The reference's tile_m/n/k arguments and fit() sized VMEM
// blocks; they have no counterpart here.
//
// Precision: float32 is true float32, one FFMA per term, never TF32.  Hopper's
// tensor cores take float32 only as TF32, so a later wgmma redesign can keep
// float32 accuracy only through a split scheme (three bf16 or TF32 passes).
// float64 sums in float64 (the reference summed float64 in float32, as the
// MXU has no float64).
//
// What bounds it: arithmetic.  At 4096^3 the product is 137 GFLOP against
// 402 MB of operands, far above the card's balance point, so the time is
// the FFMA/DFMA rate of the CUDA cores (67 TFLOP/s float32 and 34 float64
// on the H100 SXM without tensor cores) times how well this kernel feeds
// them from shared memory; no cp.async, TMA, double buffering or tensor
// cores yet.  bfloat16 runs at the float32 rate here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int RS = BM / TM;                 // row stride of a thread's tile
constexpr int CS = BN / TN;                 // column stride
constexpr int THREADS = RS * CS;            // 256
constexpr int PAD = 4;
constexpr int64_t kMaxGridY = 65535;

enum Mode { kPlain = 0, kLower = 1, kUpper = 2 };

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// c + alpha * p with each operation rounded once
__device__ __forceinline__ float update(float c, float alpha, float p) {
  return __fadd_rn(c, __fmul_rn(alpha, p));
}
__device__ __forceinline__ double update(double c, double alpha, double p) {
  return __dadd_rn(c, __dmul_rn(alpha, p));
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            const T* __restrict__ c, T* __restrict__ out, int64_t m,
            int64_t n, int64_t k, double alpha) {
  using Acc = typename AccOf<T>::type;
  __shared__ Acc as[BK][BM + PAD];
  __shared__ Acc bs[BK][BN];
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % CS, ty = tid / CS;

  if constexpr (MODE != kPlain) {
    const bool outside = MODE == kLower ? row0 + BM - 1 < col0
                                        : row0 > col0 + BN - 1;
    if (outside) {
      for (int i = 0; i < TM; ++i) {
        const int64_t r = row0 + ty + i * RS;
        if (r >= m) break;
        for (int j = 0; j < TN; ++j) {
          const int64_t col = col0 + tx + j * CS;
          if (col < n) out[r * n + col] = c[r * n + col];
        }
      }
      return;
    }
  }

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BM * BK / THREADS; ++q) {
      const int idx = tid + q * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const int64_t gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? to_acc(a[gr * k + gk]) : Acc(0);
    }
#pragma unroll
    for (int q = 0; q < BK * BN / THREADS; ++q) {
      const int idx = tid + q * THREADS;
      const int kk = idx / BN, col = idx % BN;
      const int64_t gk = k0 + kk, gc = col0 + col;
      bs[kk][col] = (gk < k && gc < n) ? to_acc(b[gk * n + gc]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc af[TM], bf[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) af[i] = as[kk][ty + i * RS];
#pragma unroll
      for (int j = 0; j < TN; ++j) bf[j] = bs[kk][tx + j * CS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_rn(af[i], bf[j],
                                                        acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty + i * RS;
    if (r >= m) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t col = col0 + tx + j * CS;
      if (col >= n) continue;
      if constexpr (MODE == kPlain) {
        store(out + r * n + col, acc[i][j]);
      } else {
        const T cv = c[r * n + col];
        const bool inside = MODE == kLower ? r >= col : r <= col;
        out[r * n + col] = inside ? update(cv, static_cast<T>(alpha),
                                           acc[i][j])
                                  : cv;
      }
    }
  }
}

template <typename T, int MODE>
int launch(const void* a, const void* b, const void* c, void* out,
           int64_t m, int64_t n, int64_t k, double alpha, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t gy = (m + BM - 1) / BM, gx = (n + BN - 1) / BN;
  if (gy > kMaxGridY || gx > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  gemm_kernel<T, MODE><<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(out), m, n, k, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define EL_GEMM(NAME, T, MODE)                                               \
  int NAME(const void* a, const void* b, const void* c, void* out,           \
           int64_t m, int64_t n, int64_t k, double alpha, void* stream) {    \
    return launch<T, MODE>(a, b, c, out, m, n, k, alpha, stream);            \
  }

EL_GEMM(el_matmul_f32, float, kPlain)
EL_GEMM(el_matmul_f64, double, kPlain)
EL_GEMM(el_matmul_bf16, __nv_bfloat16, kPlain)
EL_GEMM(el_rank_k_lower_f32, float, kLower)
EL_GEMM(el_rank_k_lower_f64, double, kLower)
EL_GEMM(el_rank_k_upper_f32, float, kUpper)
EL_GEMM(el_rank_k_upper_f64, double, kUpper)

#undef EL_GEMM

}  // extern "C"
