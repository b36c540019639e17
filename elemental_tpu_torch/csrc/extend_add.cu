// K1: the multifrontal extend-add of one elimination-tree level, on Hopper.
//
// Replaces the TPU kernel elemental_tpu/kernels/extend_add.py:ea_route_add
// (body _route_kernel), which the JAX package drives level by level from
// elemental_tpu/sparse_direct/numeric.py:_ea_apply.
//
// What it computes: pool[child_dst] += pool[child_src] over the level's
// (destination, source) pairs, with duplicate destinations summed.  The plan
// (elemental_tpu_torch/sparse_direct/ea_plan.py) gives the pairs in two
// disjoint parts:
//
//   runs:  pool[run_dst[j] + t] += pool[run_src[j] + t],
//          t in [0, run_off[j+1] - run_off[j]), one source a destination;
//   multi: pool[udst[i]] += sum over k in [off[i], off[i+1]) of
//          pool[src[k]], for the destinations with two or more sources.
//
// The plan checks on the host that the destinations lie in the level's own
// segment of the pool and no source does, so the update in place never
// reads a value that another thread writes, and that no destination is in
// both parts.
//
// What bounds it: bytes.  Any implementation reads every source value once
// and reads and writes every destination once: at the at-scale LP
// (concat_fd_2d n1 = 224, KKT N = 150,528) 28.5 M pairs and 26.5 M
// destinations a factor, 326 MB in f32 (97 us at 3.35 TB/s).  Nine
// destinations in ten have one source, and in the symbolic plan's order
// (each child Schur row in turn) their pairs form 2.4 M runs along which
// source and destination both step by 1, so the run part needs 12 bytes of
// index a run, not 8 a pair, and reads and writes neighbouring addresses.
//
// Design: one launch a level, two kinds of block.
//   - Multi blocks, one thread a destination: its sources summed in the
//     plan's order, then added to the destination.  They come first in the
//     grid, since their chains of dependent loads are the longest.
//   - Run blocks, balanced by pairs: block b owns run pairs
//     [RUN_BLOCK b, RUN_BLOCK (b+1)).  The plan stores run_blk[b], the run
//     that holds its first pair, so the block stages its runs' bases into
//     shared memory, marks where each run starts, and a block-wide prefix
//     sum of the marks gives every pair its run.  Thread t then updates
//     pairs t, t + 256, ...: neighbouring lanes touch neighbouring
//     addresses wherever a run is longer than a lane or two, which a warp
//     a run would not (the leaf levels' runs are 1.5-3 pairs long).  A
//     thread loads all 8 of its sources and destinations before it stores
//     any sum, so 16 reads are in flight (the plan guarantees that no
//     source is a destination of the level).
// No atomics, and every sum has a fixed order: the same bits on every run.
//
// Complex pools (complex64, complex128) run the same kernel on a value type
// of two reals with a componentwise +, aligned as the pool's elements (8 or
// 16 bytes), so each value moves in one load and one store and the plan's
// indices stay in elements.  A view of the pool as reals with doubled
// indices would compute the same sums but double the plan or its index
// arithmetic; the value type keeps one plan for every dtype.  The bound
// doubles with the itemsize: complex64 moves float64's bytes.
// The TPU kernel's 128-lane windows, rounds and spill existed because the
// TPU has no fast element gather or scatter; none of that carries over.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>
#include <cstdint>

namespace {

// a complex value: two reals, added componentwise; T(0) is 0 + 0i
template <typename R>
struct alignas(2 * sizeof(R)) Complex {
  R re, im;
  Complex() = default;
  __device__ explicit Complex(int zero) : re(R(zero)), im(R(zero)) {}
  __device__ Complex& operator+=(const Complex& o) {
    re += o.re;
    im += o.im;
    return *this;
  }
  __device__ Complex operator+(const Complex& o) const {
    Complex r = *this;
    r += o;
    return r;
  }
};

constexpr int THREADS = 256;
constexpr int RUN_BLOCK = 2048;             // run pairs a block
constexpr int PER_THREAD = RUN_BLOCK / THREADS;

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS) extend_add_kernel(
    T* pool, const I* __restrict__ run_dst, const I* __restrict__ run_src,
    const I* __restrict__ run_off, const I* __restrict__ run_blk,
    int64_t n_runs, int64_t n_run_pairs, const I* __restrict__ udst,
    const I* __restrict__ off, const I* __restrict__ src, int64_t n_multi,
    int64_t n_multi_blocks) {
  using Scan = cub::BlockScan<int, THREADS>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int run_of[RUN_BLOCK];          // each pair's run, from r0
  __shared__ I dst_base[RUN_BLOCK + 1];      // run_dst - run_off of a run
  __shared__ I src_base[RUN_BLOCK + 1];

  if (blockIdx.x < n_multi_blocks) {
    // the multi-source destinations first: their chains of dependent
    // loads are the longest, so they start with the first wave
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS
                      + threadIdx.x;
    if (i >= n_multi) return;
    const I b = off[i];
    const I e = off[i + 1];
    T acc = T(0);
#pragma unroll 4
    for (I k = b; k < e; ++k) acc += pool[src[k]];
    pool[udst[i]] += acc;
    return;
  }
  const int64_t blk = static_cast<int64_t>(blockIdx.x) - n_multi_blocks;
  const int64_t p0 = blk * RUN_BLOCK;
  const int n = static_cast<int>(
      n_run_pairs - p0 < RUN_BLOCK ? n_run_pairs - p0 : RUN_BLOCK);
  const int64_t r0 = run_blk[blk];
  // the runs from r0 to the one that holds pair p0 + RUN_BLOCK
  const int64_t r_end = static_cast<int64_t>(run_blk[blk + 1]) + 1;
  const int nr = static_cast<int>((r_end < n_runs ? r_end : n_runs) - r0);
  // this thread's runs (at most two: nr <= RUN_BLOCK + 1), loaded while
  // the marks are cleared
  I o[2], d[2], s[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int j = threadIdx.x + q * THREADS;
    if (j < nr) {
      o[q] = run_off[r0 + j];
      d[q] = run_dst[r0 + j];
      s[q] = run_src[r0 + j];
    }
  }
  for (int j = 2 * THREADS + threadIdx.x; j < nr; j += THREADS) {
    const I oj = run_off[r0 + j];            // RUN_BLOCK > 2 * THREADS
    dst_base[j] = run_dst[r0 + j] - oj;
    src_base[j] = run_src[r0 + j] - oj;
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) run_of[threadIdx.x + k * THREADS] = 0;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int j = threadIdx.x + q * THREADS;
    if (j < nr) {
      dst_base[j] = d[q] - o[q];
      src_base[j] = s[q] - o[q];
      if (j > 0 && o[q] - p0 < RUN_BLOCK) run_of[o[q] - p0] = 1;
    }
  }
  for (int j = 2 * THREADS + threadIdx.x; j < nr; j += THREADS) {
    const int64_t oj = run_off[r0 + j];
    if (oj - p0 < RUN_BLOCK) run_of[oj - p0] = 1;
  }
  __syncthreads();
  int v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k)
    v[k] = run_of[threadIdx.x * PER_THREAD + k];
  Scan(scan_tmp).InclusiveSum(v, v);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k)
    run_of[threadIdx.x * PER_THREAD + k] = v[k];
  __syncthreads();
  // every source and destination value of the thread's pairs in flight
  // together, then the sums stored (sources never alias destinations)
  int64_t di[PER_THREAD];
  T a[PER_THREAD], b[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < n) {
      const int j = run_of[i];
      di[k] = static_cast<int64_t>(dst_base[j]) + p0 + i;
      a[k] = pool[static_cast<int64_t>(src_base[j]) + p0 + i];
      b[k] = pool[di[k]];
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k)
    if (threadIdx.x + k * THREADS < n) pool[di[k]] = b[k] + a[k];
}

template <typename T, typename I>
int launch(void* pool, const void* run_dst, const void* run_src,
           const void* run_off, const void* run_blk, int64_t n_runs,
           int64_t n_run_pairs, const void* udst, const void* off,
           const void* src, int64_t n_multi, void* stream) {
  const int64_t n_multi_blocks = (n_multi + THREADS - 1) / THREADS;
  const int64_t blocks = n_multi_blocks
                         + (n_run_pairs + RUN_BLOCK - 1) / RUN_BLOCK;
  if (blocks <= 0) return 0;
  extend_add_kernel<T, I><<<static_cast<unsigned>(blocks), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(pool), static_cast<const I*>(run_dst),
      static_cast<const I*>(run_src), static_cast<const I*>(run_off),
      static_cast<const I*>(run_blk), n_runs, n_run_pairs,
      static_cast<const I*>(udst), static_cast<const I*>(off),
      static_cast<const I*>(src), n_multi, n_multi_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {


#define EL_EA(NAME, T, I)                                                    \
  int NAME(void* pool, const void* run_dst, const void* run_src,             \
           const void* run_off, const void* run_blk, int64_t n_runs,         \
           int64_t n_run_pairs, const void* udst, const void* off,           \
           const void* src, int64_t n_multi, void* stream) {                 \
    return launch<T, I>(pool, run_dst, run_src, run_off, run_blk, n_runs,    \
                        n_run_pairs, udst, off, src, n_multi, stream);       \
  }

EL_EA(el_extend_add_f32_i32, float, int32_t)
EL_EA(el_extend_add_f32_i64, float, int64_t)
EL_EA(el_extend_add_f64_i32, double, int32_t)
EL_EA(el_extend_add_f64_i64, double, int64_t)
EL_EA(el_extend_add_c64_i32, Complex<float>, int32_t)
EL_EA(el_extend_add_c64_i64, Complex<float>, int64_t)
EL_EA(el_extend_add_c128_i32, Complex<double>, int32_t)
EL_EA(el_extend_add_c128_i64, Complex<double>, int64_t)

#undef EL_EA

}  // extern "C"
