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
//    A padding slot writes 0 and never reads x: in the reference padding is
//    never routed and stays exactly 0, and 0 * x[c] would turn an inf in x
//    into a NaN in y.  One thread per slot, grid-stride; bounded by bytes:
//    vals_b and cols_b stream once, P is written once, x is read at random
//    (from L2 while it fits in its 50 MB).
//
// 2. K7, for every bucket b and local row r in [0, bucket):
//
//        y[b * bucket + r] = sum over slots j of bucket b with LR[j] == r
//                            of (float) P[j]
//
//    y is float32 whatever P's type, as the reference's out_shape is.  One
//    thread block per bucket: the block zeroes a bucket-float accumulator in
//    shared memory (32 KiB at bucket = 8192), adds its SUB * 1024 products
//    into it with shared-memory atomicAdd at LR, then writes its bucket rows
//    of y with coalesced stores.  No one-hot contraction and no bf16 hi/lo
//    split: every `precision` of the reference is a plain f32 sum here.
//    Zero products (padding) are skipped: the accumulator starts at +0, so
//    adding a signed zero would change no bit.  A local row outside
//    [0, bucket) is skipped too, so no input can write outside the block's
//    shared memory.  The order of the shared atomics varies from run to run,
//    so y is NOT bit-identical between runs; compare with a tolerance.
//    Bounded by bytes (P and LR stream once, y is written once) and by the
//    shared-atomic rate when many products of a warp hit one row.
//
// Indices: cols_b is int32 while the slot count and n_cols are below 2^31
// and int64 above (the port's one index-width rule); LR holds local rows
// (below bucket) and is int32; slot positions run in int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() (or the error of a refused shared-memory request) so
// the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kGatherThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;
constexpr int kCombineThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kStaticSmemLimit = 48 * 1024;

template <typename T, typename I>
__global__ void stream_gather_kernel(const I* __restrict__ cols,
                                     const T* __restrict__ vals,
                                     const T* __restrict__ x,
                                     T* __restrict__ p, int64_t slots) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x; j < slots; j += stride) {
    const I c = cols[j];
    p[j] = c >= 0 ? vals[j] * x[c] : T(0);
  }
}

__device__ __forceinline__ void combine_add(float* acc, int32_t r, float v,
                                            int bucket) {
  if (v != 0.0f && static_cast<uint32_t>(r) < static_cast<uint32_t>(bucket))
    atomicAdd(acc + r, v);
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const T* __restrict__ p, const int32_t* __restrict__ lr,
               float* __restrict__ y, int64_t per_bucket, int bucket) {
  extern __shared__ float acc[];
  const int64_t b = blockIdx.x;
  for (int i = threadIdx.x; i < bucket; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const T* pb = p + b * per_bucket;
  const int32_t* lb = lr + b * per_bucket;
  const int64_t step = blockDim.x;
  int64_t j = threadIdx.x;
  // kUnroll independent loads in flight before their atomics
  for (; j + (kUnroll - 1) * step < per_bucket; j += kUnroll * step) {
    float v[kUnroll];
    int32_t r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = static_cast<float>(pb[j + u * step]);
      r[u] = lb[j + u * step];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) combine_add(acc, r[u], v[u], bucket);
  }
  for (; j < per_bucket; j += step)
    combine_add(acc, lb[j], static_cast<float>(pb[j]), bucket);
  __syncthreads();
  float* yb = y + b * bucket;
  for (int i = threadIdx.x; i < bucket; i += blockDim.x) yb[i] = acc[i];
}

template <typename T, typename I>
int gather(const void* cols, const void* vals, const void* x, void* p,
           int64_t slots, void* stream) {
  if (slots <= 0) return 0;
  int64_t blocks = (slots + kGatherThreads - 1) / kGatherThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  stream_gather_kernel<T, I><<<static_cast<unsigned>(blocks), kGatherThreads,
                               0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const I*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(p), slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine(const void* p, const void* lr, void* y, int64_t nbuckets,
            int64_t per_bucket, int64_t bucket, void* stream) {
  if (nbuckets <= 0) return 0;
  const size_t smem = static_cast<size_t>(bucket) * sizeof(float);
  if (smem > kStaticSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        combine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  combine_kernel<T><<<static_cast<unsigned>(nbuckets), kCombineThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const int32_t*>(lr),
      static_cast<float*>(y), per_bucket, static_cast<int>(bucket));
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

#define EL_COMBINE(NAME, T)                                                   \
  int NAME(const void* p, const void* lr, void* y, int64_t nbuckets,          \
           int64_t per_bucket, int64_t bucket, void* stream) {                \
    return combine<T>(p, lr, y, nbuckets, per_bucket, bucket, stream);        \
  }

EL_COMBINE(el_combine_bucketed_f32, float)
EL_COMBINE(el_combine_bucketed_f64, double)

#undef EL_COMBINE

}  // extern "C"
