// K6: the elementwise and transpose kernels, on Hopper.
//
// Replaces the TPU kernels of elemental_tpu/kernels/elementwise.py: the five
// streaming ops that go through _ew_call (axpy, scale, hadamard, copy) and
// fill, and the out-of-place transpose.  They are the reference's own
// Hydrogen kernels (Axpy.cu, Scale.cu, Hadamard.cu, Copy.cu, Fill.cu,
// Transpose.cu) on a contiguous row-major 2-D tensor of n elements:
//
//     axpy      out = y + alpha * x      one rounding: fma(alpha, x, y)
//     scale     out = alpha * x
//     hadamard  out = x * y
//     copy      out = x                  bit for bit
//     fill      out = value              bit for bit (the bits of value in
//                                        the dtype, rounded on the host)
//     transpose out (n, m) = x (m, n)^T  bit for bit
//
// float32 and float64 compute in their own type; bfloat16 computes in
// float32 and rounds once on the store.  axpy's rounding is chosen on
// purpose: the fused multiply-add rounds once, where y + alpha * x in two
// steps rounds twice, so a plain version that does not fuse may differ from
// it by one rounding of alpha * x.  copy, fill and transpose move bits and
// are instantiated by element size (2, 4 or 8 bytes).
//
// Design: when every pointer is 16-byte aligned, the streaming ops run one
// pass over 16-byte packs (4 float32, 2 float64 or 8 bfloat16): each thread
// of a block of 128 loads one pack (of x and of y), computes and stores it;
// the grid covers the tensor once (no grid-stride loop), and the last block
// also takes the n % pack elements of the tail.  Otherwise a grid-stride
// loop of one element a step.  The reference's _tile_grid cut the arrays
// into VMEM blocks and has no counterpart.  transpose stages a 32 x 32
// tile in shared memory with one word of padding a row, so that both the
// load of a row of x and the store of a row of out are coalesced and the
// column read of the tile is free of bank conflicts; blocks of 32 x 8
// threads walk the tiles grid-stride.
//
// What bounds them: bytes.  Each op reads and writes every element once
// (axpy and hadamard read two inputs, fill reads none), so at 3.35 TB/s an
// 8192 x 8192 float32 axpy (805 MB) takes at least 0.24 ms.  What the
// design does about it is keep enough loads in flight with few
// instructions: a grid-stride loop over a grid capped at 132 x 16 blocks
// fell behind torch's own kernels, where a grid that covers the tensor once
// keeps pace with them.  On the H100, two or four packs a thread (loads
// first, then arithmetic and stores) and evict-first loads and stores
// (__ldcs, __stcs) were no faster than one pack a thread, so they are not
// used.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;          // the scalar grid-stride loop
constexpr int kPackThreads = 128;       // one 16-byte pack a thread
constexpr int64_t kMaxBlocks = 132 * 16;
constexpr int kTile = 32, kRowsPerStep = 8;

enum Op { kAxpy = 0, kScale = 1, kHadamard = 2, kCopy = 3, kFill = 4 };

template <typename T> struct MathOf { using type = T; };
template <> struct MathOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float load(float v) { return v; }
__device__ __forceinline__ double load(double v) { return v; }
__device__ __forceinline__ float load(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ T round_to(double v) {
  return v;
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T, int OP>
__device__ __forceinline__ T apply(T xv, T yv, typename MathOf<T>::type a,
                                   T fill_value) {
  if constexpr (OP == kCopy) {
    return xv;
  } else if constexpr (OP == kFill) {
    return fill_value;
  } else {
    using M = typename MathOf<T>::type;
    const M x = load(xv);
    M r;
    if constexpr (OP == kAxpy) r = fma_rn(a, x, M(load(yv)));
    else if constexpr (OP == kScale) r = mul_rn(a, x);
    else r = mul_rn(x, M(load(yv)));
    return round_to<T>(r);
  }
}

template <typename T>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// pack i of p as one 128-bit load or store
template <typename T>
__device__ __forceinline__ Pack<T> load_pack(const T* p, int64_t i) {
  Pack<T> r;
  *reinterpret_cast<uint4*>(&r) = reinterpret_cast<const uint4*>(p)[i];
  return r;
}

template <typename T>
__device__ __forceinline__ void store_pack(T* p, int64_t i,
                                           const Pack<T>& v) {
  reinterpret_cast<uint4*>(p)[i] = *reinterpret_cast<const uint4*>(&v);
}

// x and y are read only where the op has them; T is the element type, or
// for copy and fill an unsigned integer of the element's size
template <typename T, int OP>
__global__ void __launch_bounds__(kPackThreads)
stream_pack_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   T* __restrict__ out, int64_t n, double alpha,
                   T fill_value) {
  constexpr bool kReadsX = OP != kFill;
  constexpr bool kReadsY = OP == kAxpy || OP == kHadamard;
  using M = typename MathOf<T>::type;
  using P = Pack<T>;
  const M a = static_cast<M>(alpha);
  const int64_t packs = n / P::kN;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPackThreads
                    + threadIdx.x;
  if (i < packs) {
    P xp, yp, op;
    if constexpr (kReadsX) xp = load_pack(x, i);
    if constexpr (kReadsY) yp = load_pack(y, i);
#pragma unroll
    for (int e = 0; e < P::kN; ++e)
      op.v[e] = apply<T, OP>(kReadsX ? xp.v[e] : fill_value,
                             kReadsY ? yp.v[e] : fill_value, a, fill_value);
    store_pack(out, i, op);
  }
  if (blockIdx.x == gridDim.x - 1) {
    const int64_t i = packs * P::kN + threadIdx.x;
    if (i < n)
      out[i] = apply<T, OP>(kReadsX ? x[i] : fill_value,
                            kReadsY ? y[i] : fill_value, a, fill_value);
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
stream_scalar_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     T* __restrict__ out, int64_t n, double alpha,
                     T fill_value) {
  constexpr bool kReadsX = OP != kFill;
  constexpr bool kReadsY = OP == kAxpy || OP == kHadamard;
  using M = typename MathOf<T>::type;
  const M a = static_cast<M>(alpha);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x; i < n; i += stride)
    out[i] = apply<T, OP>(kReadsX ? x[i] : fill_value,
                          kReadsY ? y[i] : fill_value, a, fill_value);
}

template <typename T, int OP>
int stream_op(const void* x, const void* y, void* out, int64_t n,
              double alpha, T fill_value, int64_t vec, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  if (vec) {
    int64_t blocks = (n / Pack<T>::kN + kPackThreads - 1) / kPackThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    stream_pack_kernel<T, OP><<<static_cast<unsigned>(blocks), kPackThreads,
                                0, s>>>(xt, yt, ot, n, alpha, fill_value);
  } else {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    stream_scalar_kernel<T, OP><<<static_cast<unsigned>(blocks), kThreads,
                                  0, s>>>(xt, yt, ot, n, alpha, fill_value);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename U>
__global__ void __launch_bounds__(kTile * kRowsPerStep)
transpose_kernel(const U* __restrict__ x, U* __restrict__ out, int64_t m,
                 int64_t n, int64_t tiles_n, int64_t tiles) {
  __shared__ U tile[kTile][kTile + 1];
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t r0 = (t / tiles_n) * kTile, c0 = (t % tiles_n) * kTile;
    for (int i = threadIdx.y; i < kTile; i += kRowsPerStep) {
      const int64_t r = r0 + i, c = c0 + threadIdx.x;
      if (r < m && c < n) tile[i][threadIdx.x] = x[r * n + c];
    }
    __syncthreads();
    for (int i = threadIdx.y; i < kTile; i += kRowsPerStep) {
      const int64_t r = c0 + i, c = r0 + threadIdx.x;   // out is (n, m)
      if (r < n && c < m) out[r * m + c] = tile[threadIdx.x][i];
    }
    __syncthreads();
  }
}

template <typename U>
int transpose(const void* x, void* out, int64_t m, int64_t n,
              void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t tiles_m = (m + kTile - 1) / kTile;
  const int64_t tiles_n = (n + kTile - 1) / kTile;
  const int64_t tiles = tiles_m * tiles_n;
  const int64_t blocks = tiles < kMaxBlocks ? tiles : kMaxBlocks;
  transpose_kernel<U><<<static_cast<unsigned>(blocks),
                        dim3(kTile, kRowsPerStep), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(x), static_cast<U*>(out), m, n, tiles_n, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// one signature for the five streaming ops: x, y, out, n, alpha, the bits
// of the fill value, whether every pointer is 16-byte aligned, the stream
#define EL_MATH(NAME, T, OP)                                                 \
  int NAME(const void* x, const void* y, void* out, int64_t n,               \
           double alpha, uint64_t, int64_t vec, void* stream) {              \
    return stream_op<T, OP>(x, y, out, n, alpha, T(), vec, stream);          \
  }

EL_MATH(el_axpy_f32, float, kAxpy)
EL_MATH(el_axpy_f64, double, kAxpy)
EL_MATH(el_axpy_bf16, __nv_bfloat16, kAxpy)
EL_MATH(el_scale_f32, float, kScale)
EL_MATH(el_scale_f64, double, kScale)
EL_MATH(el_scale_bf16, __nv_bfloat16, kScale)
EL_MATH(el_hadamard_f32, float, kHadamard)
EL_MATH(el_hadamard_f64, double, kHadamard)
EL_MATH(el_hadamard_bf16, __nv_bfloat16, kHadamard)

#undef EL_MATH

#define EL_BITS(NAME, U, OP)                                                 \
  int NAME(const void* x, const void* y, void* out, int64_t n,               \
           double alpha, uint64_t bits, int64_t vec, void* stream) {         \
    return stream_op<U, OP>(x, y, out, n, alpha, static_cast<U>(bits), vec,  \
                            stream);                                         \
  }

EL_BITS(el_copy_2, uint16_t, kCopy)
EL_BITS(el_copy_4, uint32_t, kCopy)
EL_BITS(el_copy_8, uint64_t, kCopy)
EL_BITS(el_fill_2, uint16_t, kFill)
EL_BITS(el_fill_4, uint32_t, kFill)
EL_BITS(el_fill_8, uint64_t, kFill)

#undef EL_BITS

#define EL_TRANSPOSE(NAME, U)                                                \
  int NAME(const void* x, void* out, int64_t m, int64_t n, void* stream) {   \
    return transpose<U>(x, out, m, n, stream);                               \
  }

EL_TRANSPOSE(el_transpose_2, uint16_t)
EL_TRANSPOSE(el_transpose_4, uint32_t)
EL_TRANSPOSE(el_transpose_8, uint64_t)

#undef EL_TRANSPOSE

}  // extern "C"
