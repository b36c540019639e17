// K1: the multifrontal extend-add of one elimination-tree level, on Hopper.
//
// Replaces the TPU kernel elemental_tpu/kernels/extend_add.py:ea_route_add
// (body _route_kernel), which the JAX package drives level by level from
// elemental_tpu/sparse_direct/numeric.py:_ea_apply.
//
// What it computes, for every unique destination i of the level:
//
//     pool[udst[i]] += sum over k in [off[i], off[i+1]) of pool[src[k]]
//
// i.e. pool[child_dst] += pool[child_src] with duplicate destinations summed.
// The plan (elemental_tpu_torch/sparse_direct/ea_plan.py) checks on the host
// that the destinations are unique and lie in the level's own segment of the
// pool, and that no source lies in that segment, so the update in place never
// reads a value that another thread writes.
//
// Design: one thread per unique destination.  No atomics, and the sources of
// a destination are summed in the plan's order, so the result is
// deterministic from run to run.  The TPU kernel's 128-lane windows, rounds
// and spill existed because the TPU has no fast element gather or scatter;
// the H100 has both, so none of that carries over.
//
// What bounds it: bytes.  Each (source, destination) pair reads one index and
// one value; each destination reads two offsets and an index and updates one
// value.  At the at-scale LP (concat_fd_2d n1 = 224, KKT N = 150,528) one
// factor's extend-add moves 28.5 M pairs, a fraction of a GB, against the 2 GB
// f32 front pool that the front kernels of the same factor sweep many times:
// it is far from the factor's critical path.  Source reads are scattered
// (child Schur rows are contiguous, so neighbouring pairs are often
// neighbouring addresses, but a thread walks its own sources serially).
// Making it fast (a warp per destination run, cp.async staging) is left for
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cstdint>

template <typename T, typename I>
__global__ void extend_add_kernel(T* pool, const I* __restrict__ udst,
                                  const I* __restrict__ off,
                                  const I* __restrict__ src, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n) return;
  const I b = off[i];
  const I e = off[i + 1];
  T acc = T(0);
  for (I k = b; k < e; ++k) acc += pool[src[k]];
  pool[udst[i]] += acc;
}

template <typename T, typename I>
static int launch(void* pool, const void* udst, const void* off,
                  const void* src, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  extend_add_kernel<T, I><<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(pool), static_cast<const I*>(udst),
      static_cast<const I*>(off), static_cast<const I*>(src), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int el_extend_add_f32_i32(void* pool, const void* udst, const void* off,
                          const void* src, int64_t n, void* stream) {
  return launch<float, int32_t>(pool, udst, off, src, n, stream);
}

int el_extend_add_f32_i64(void* pool, const void* udst, const void* off,
                          const void* src, int64_t n, void* stream) {
  return launch<float, int64_t>(pool, udst, off, src, n, stream);
}

int el_extend_add_f64_i32(void* pool, const void* udst, const void* off,
                          const void* src, int64_t n, void* stream) {
  return launch<double, int32_t>(pool, udst, off, src, n, stream);
}

int el_extend_add_f64_i64(void* pool, const void* udst, const void* off,
                          const void* src, int64_t n, void* stream) {
  return launch<double, int64_t>(pool, udst, off, src, n, stream);
}

}  // extern "C"
