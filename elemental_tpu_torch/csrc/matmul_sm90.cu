// K4 and K5 redesigned for Hopper: three kernels for C = A·B, one per
// dtype, and two for the masked rank-k update on the float32 and float64
// ones' main loops.
//
// Replaces the TPU kernels elemental_tpu/kernels/matmul.py:matmul
// (_matmul_kernel, K4) and masked_rank_k_update (its inner kernel, K5).
// For a (m, k), b (k, n), c and out (m, n), all row-major and contiguous:
//
//     K4:  out = a · b, float32 sums for bfloat16 and float32 inputs,
//          float64 sums for float64, stored in a's dtype
//     K5:  out[r, j] = c[r, j] + alpha * (a · b)[r, j]   where r >= j (lower)
//                                                        or r <= j (upper)
//          out[r, j] = c[r, j], bit for bit              elsewhere
//
// The SIMT kernels of matmul.cu stay for the shapes these cannot take; the
// wrapper (elemental_tpu_torch/kernels/matmul.py, _matmul_path and
// _rank_k_path) chooses by a fixed rule of dtype, shape and alignment, never
// on a failure.  All need k > 0, k and n multiples of one 16-byte vector (8
// bfloat16, 4 float32, 2 float64) and 16-byte aligned bases, so that a
// vector of a row is either wholly inside the matrix or wholly outside it.
//
// What bounds them: arithmetic.  At 4096^3 the product is 137 GFLOP against
// 100-400 MB of operands.  On the H100 SXM the ceilings are 989 TFLOP/s for
// bfloat16 on the tensor cores, 67 TFLOP/s for float64 on the tensor cores
// and 67 TFLOP/s for float32 on the CUDA cores (FFMA): float32 has no tensor
// path here, because Hopper's is TF32 and K4's float32 is true float32.
//
// wgmma_bf16_kernel: a 128 x 256 output tile per block of three warpgroups.
// Warpgroup 0 is the producer: one thread issues TMA loads of the 128 x 64
// tile of a and four 64 x 64 tiles of b into a ring of 4 stages (48 KB
// each, in dynamic shared memory, 128-byte swizzle), with a full and an
// empty mbarrier per stage.  Warpgroups 1 and 2 are consumers: each issues
// wgmma.mma_async m64n256k16 (bf16 x bf16 -> f32) on its 64 rows, four per
// stage, with the 128 f32 sums a thread holds in registers; it keeps one
// group in flight and frees a stage once the group after it is issued.
// setmaxnreg moves registers from the producer to the consumers.  a's tile
// is K-major (k contiguous); b's is MN-major (n contiguous), so its
// descriptor sets the transpose bit and strides 8 KB between its 64-column
// tiles (the leading byte offset) and 1 KB between groups of 8 k-rows (the
// stride byte offset).  TMA fills the parts of a tile outside the matrix
// with zeros; the epilogue rounds each sum once to bfloat16
// (__floats2bfloat162_rn) and stores inside (m, n) only.
//
// dmma_f64_kernel: a 128 x 128 tile per block of 8 warps, each warp 64 x 32
// as 4 x 4 tiles of mma.sync m16n8k4 with float64 operands and sums (the
// f64 tensor cores; wgmma has no float64).  A 3-stage ring of 128 x 32 and
// 32 x 128 tiles (208 KB) filled by 16-byte cp.async (zero-filled outside
// the matrix), rows padded to 36 and 132 doubles so the fragment loads are
// free of bank conflicts.  On the H100 this ran faster than k-steps of 16
// (3 or 4 stages) and than the m16n8k8 and m16n8k16 shapes.
//
// ffma_f32_kernel: a 128 x 128 tile per block of 256 threads, each thread 8
// x 8 sums as four 4 x 4 quadrants (rows 4ty..4ty+3 and 64+4ty.., columns
// likewise), so every shared-memory read is a 16-byte LDS.128 of a's tile
// (stored k-major, transposed through registers on the way in) or of b's
// (copied by cp.async, which keeps 8 registers free: with b through
// registers too the kernel spilled at its 128-register cap and ran
// slower).  k steps of 16 through two shared-memory buffers: the loads of
// the next step are in flight while the 16 x 64 FFMAs of this one run.
// One FMA per term in k order, as the SIMT kernel and the plain version
// sum.
//
// K5, rank_k_ffma_kernel and rank_k_dmma_kernel.  What bounds it: bytes.
// At 4096², k = 128, c is read and out written whole (134 MB in float32,
// 268 MB in float64: 0.041 and 0.083 ms at 3.35 TB/s), while the triangle's
// product is 2.15 GFLOP (~0.05 ms at K4's FFMA or DMMA rate).  The design
// overlaps the stream of c with the product.  One block takes one 128 x 128
// tile, and the grid is a list of tiles that mixes product tiles (inside
// the triangle, or crossing its diagonal) with copy tiles (wholly outside):
// tile rows paired from the outside in (0 and gy - 1, 1 and gy - 2, ...),
// each pair's tiles alternating between its two rows.  The hardware hands
// the next tile of the list to whichever SM frees a slot, so the walk
// balances itself although tiles differ in cost; a persistent grid with a
// fixed stride would not.
// - float32: a product tile's block also copies its mirror (the tile with
//   tile row and column swapped, a copy tile exactly when this one
//   multiplies, since the tiles are square), and the copy tiles without a
//   product mirror copy themselves.  Thread 0 has the TMA unit stream, a
//   chunk of 16 rows each k-step, the tile of c into shared memory and the
//   mirror through two chunk buffers to out (2-D tensor maps, L2
//   evict-first; the unit zero-fills and clips outside (m, n)).  Both FFMA
//   blocks of an SM keep all their warps on the FMAs: the FFMA loop needs
//   both to reach its rate, and together they fill the register file, so
//   a block that copied instead would take one of them away.  One thread
//   and one box a chunk, because every copy a math warp issues, and every
//   burst of loads ahead of the loop's loads of a and b, adds its time to
//   the FMAs' (measured, PERF.md).
// - float64: the DMMA loop with k-steps of 16 through 2 stages (73 KB, not
//   K4's 208 KB), beside c's 128 x 128 tile (rows padded to 136 doubles,
//   so rows g and g + 1 fall 64 bytes apart in the banks): 209 KB, one
//   block an SM and no room to stage a mirror.  Warp 0 has the TMA unit
//   bring c's rows in before the loop; copy tiles are blocks of their own.
// - A copy tile that copies itself moves c to out in 16-byte integer
//   vectors with streaming hints (ld/st.global.cs), 8 loads in flight a
//   thread.
// - The epilogue adds alpha times the sums to c's tile in shared memory,
//   masks element by element only on diagonal tiles (by global indices, so
//   m != n and ragged edges hold) and stores 16-byte vectors with the
//   streaming hint.  It rounds as the plain version rounds: __fmul_rn(alpha,
//   p), then __fadd_rn(c, .), each once, never contracted (__dmul_rn and
//   __dadd_rn in float64).  No atomics and one sum order: the same bits on
//   every call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (elemental_tpu_torch/_build.py), loaded with ctypes.
// The TMA descriptors are encoded on the host for each call with the
// driver's cuTensorMapEncodeTiled, reached through the runtime's
// cudaGetDriverEntryPoint, so the library does not link libcuda.
// Launch rules: runs on the stream it is given, allocates nothing, returns
// cudaGetLastError() (or a negative code when a TMA descriptor cannot be
// made) so the caller can raise on a refused launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- wgmma + TMA, bfloat16 ---------------------------------------------------

constexpr int WG_BM = 128, WG_BN = 256, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_THREADS = 384;
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;              // 16 KB
constexpr int WG_B_SUB = 64 * WG_BK * 2;                   // 8 KB: 64 columns
constexpr int WG_B_BYTES = WG_BN * WG_BK * 2;              // 32 KB
constexpr int WG_STAGE_BYTES = WG_A_BYTES + WG_B_BYTES;
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024 + 2 * WG_STAGES * 8;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// the same under the L2 policy ``policy``
__device__ __forceinline__ void tma_load_hinted(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0, int c1,
                                                uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "l"(policy) : "memory");
}

// a TMA store of the box at (c0, c1) of ``map`` from shared memory, in this
// thread's open bulk group, under the L2 policy ``policy``; the parts of
// the box outside the tensor are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "l"(policy) : "memory");
}

// a shared-memory matrix descriptor for the 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | 1ull << 62;
}

// keep the compiler from moving reads or writes of the sums across the
// asynchronous wgmma that owns them
__device__ __forceinline__ void fence_sums(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define EL_D8(i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),                \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256, f32) += A (64 x 16, K-major) · B (16 x 256, MN-major)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : EL_D8(0), EL_D8(8), EL_D8(16), EL_D8(24), EL_D8(32), EL_D8(40),
        EL_D8(48), EL_D8(56), EL_D8(64), EL_D8(72), EL_D8(80), EL_D8(88),
        EL_D8(96), EL_D8(104), EL_D8(112), EL_D8(120)
      : "l"(da), "l"(db), "r"(1));
}

#undef EL_D8

__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  __nv_bfloat16* __restrict__ out, int64_t m, int64_t n,
                  int64_t k) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1 KB: align the ring to it
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + WG_STAGES * WG_STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;
  const int m0 = static_cast<int>(blockIdx.y) * WG_BM;
  const int n0 = static_cast<int>(blockIdx.x) * WG_BN;
  const int tiles = static_cast<int>((k + WG_BK - 1) / WG_BK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);          // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int t = 0; t < tiles; ++t) {
        const int s = t % WG_STAGES;
        mbar_wait(&empty[s], ((t / WG_STAGES) & 1) ^ 1);
        uint8_t* sa = ring + s * WG_STAGE_BYTES;
        uint8_t* sb = sa + WG_A_BYTES;
        mbar_expect_tx(&full[s], WG_STAGE_BYTES);
        tma_load(sa, &map_a, &full[s], t * WG_BK, m0);
#pragma unroll
        for (int j = 0; j < WG_BN / 64; ++j)
          tma_load(sb + j * WG_B_SUB, &map_b, &full[s], n0 + 64 * j,
                   t * WG_BK);
      }
    }
  } else {
    // consumers: warpgroup c multiplies rows 64c..64c+63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      const int s = t % WG_STAGES;
      mbar_wait(&full[s], (t / WG_STAGES) & 1);
      const uint8_t* sa = ring + s * WG_STAGE_BYTES + c * 64 * 128;
      const uint8_t* sb = ring + s * WG_STAGE_BYTES + WG_A_BYTES;
      fence_sums(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        // a: 16 k = 32 bytes along its swizzled rows; b: 16 k-rows of 128 B
        wgmma_m64n256k16(d, sw128_desc(sa + kk * 32, 16, 1024),
                         sw128_desc(sb + kk * 16 * 128, WG_B_SUB, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // this stage's group may still run; the previous stage's is done
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_sums(d);
      if (t > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(t + WG_STAGES - 1) % WG_STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_sums(d);
    // d[4j + h] sits at row 16·warp + lane/4 + 8·(h/2), column 8j +
    // 2·(lane%4) + h%2 of the warpgroup's 64 x 256 tile
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int64_t r0 = m0 + 64 * c + 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
      const int64_t col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= n) continue;                   // n even: col + 1 < n too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = r0 + 8 * h;
        if (r < m)
          *reinterpret_cast<__nv_bfloat162*>(out + r * n + col) =
              __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) bfloat16 matrix, loaded in boxes of box_rows x 64
// columns (128 bytes) with the 128-byte swizzle
bool bf16_map(CUtensorMap* map, EncodeTiled encode, const void* base,
              int64_t rows, int64_t cols, uint32_t box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* a, const void* b, void* out, int64_t m,
                 int64_t n, int64_t k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t gy = (m + WG_BM - 1) / WG_BM, gx = (n + WG_BN - 1) / WG_BN;
  if (gy > kMaxGridY || k > INT32_MAX || n > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap map_a, map_b;
  if (!bf16_map(&map_a, encode, a, m, k, WG_BM) ||
      !bf16_map(&map_b, encode, b, k, n, WG_BK))
    return -2;
  cudaFuncSetAttribute(wgmma_bf16_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  wgmma_bf16_kernel<<<dim3(static_cast<unsigned>(gx),
                           static_cast<unsigned>(gy)),
                      WG_THREADS, WG_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// -- cp.async, shared by the float64 and float32 kernels ---------------------

// 16 bytes from global to shared; 0 source bytes fill the 16 with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool inside) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(inside ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// -- mma.sync m16n8k4, float64 -----------------------------------------------

constexpr int DM_BM = 128, DM_BN = 128, DM_THREADS = 256;
constexpr int DM_BS = DM_BN + 4;        // b's row stride in doubles

// one stage of a ring of k-steps of bk, in doubles: a's 128 x bk tile, rows
// padded to bk + 4, and b's bk x 128 tile, rows padded to DM_BS
__host__ __device__ constexpr int dm_stage(int bk) {
  return DM_BM * (bk + 4) + bk * DM_BS;
}

// K4's ring: k-steps of 32 through 3 stages (208 KB)
constexpr int DM_BK = 32, DM_STAGES = 3;
constexpr int DM_SMEM = DM_STAGES * dm_stage(DM_BK) * 8;

// c (16 x 8) += a (16 x 4) · b (4 x 8); with g = lane / 4, q = lane % 4:
// a = {A[g][q], A[g + 8][q]}, b = B[q][g], c = {C[g][2q], C[g][2q + 1],
// C[g + 8][2q], C[g + 8][2q + 1]}
__device__ __forceinline__ void dmma_16x8x4(double (&c)[4], double a0,
                                            double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The DMMA main loop, K4's and K5's: warp w's 64 x 32 sums of the 128 x 128
// tile at (m0, n0), c = a · b (c[i][j] the 16 x 8 tile at the warp's row 16i
// and column 8j, as dmma_16x8x4 lays it out), through a ring of STAGES
// k-steps of BK at the start of dynamic shared memory.
template <int BK, int STAGES>
__device__ __forceinline__ void dmma_mainloop(const double* __restrict__ a,
                                              const double* __restrict__ b,
                                              int64_t m0, int64_t n0,
                                              int64_t m, int64_t n, int64_t k,
                                              double (&c)[4][4][4]) {
  extern __shared__ __align__(16) double dm_smem[];
  constexpr int AS = BK + 4, STAGE = dm_stage(BK);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int tiles = static_cast<int>((k + BK - 1) / BK);

  // each thread copies BK / 4 16-byte vectors of a's tile and BK / 4 of b's
  auto load = [&](int t) {
    double* sa = dm_smem + (t % STAGES) * STAGE;
    double* sb = sa + DM_BM * AS;
    const int64_t k0 = static_cast<int64_t>(t) * BK;
#pragma unroll
    for (int i = 0; i < DM_BM * BK / 2 / DM_THREADS; ++i) {
      const int v = tid + i * DM_THREADS;
      const int r = v / (BK / 2), kc = 2 * (v % (BK / 2));
      const bool in = m0 + r < m && k0 + kc < k;
      cp_async16(sa + r * AS + kc, in ? a + (m0 + r) * k + k0 + kc : a, in);
    }
#pragma unroll
    for (int i = 0; i < BK * DM_BN / 2 / DM_THREADS; ++i) {
      const int v = tid + i * DM_THREADS;
      const int r = v / 64, nc = 2 * (v % 64);
      const bool in = k0 + r < k && n0 + nc < n;
      cp_async16(sb + r * DM_BS + nc, in ? b + (k0 + r) * n + n0 + nc : b, in);
    }
  };

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.0;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage refilled here was read in step t - 1, before the barrier
    if (t + STAGES - 1 < tiles) load(t + STAGES - 1);
    cp_async_commit();
    const double* sa = dm_smem + (t % STAGES) * STAGE;
    const double* sb = sa + DM_BM * AS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 4) {
      double af[4][2], bf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        af[i][0] = sa[(wm + 16 * i + g) * AS + ks + q];
        af[i][1] = sa[(wm + 16 * i + g + 8) * AS + ks + q];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bf[j] = sb[(ks + q) * DM_BS + wn + 8 * j + g];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dmma_16x8x4(c[i][j], af[i][0], af[i][1], bf[j]);
    }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(DM_THREADS, 1)
dmma_f64_kernel(const double* __restrict__ a, const double* __restrict__ b,
                double* __restrict__ out, int64_t m, int64_t n, int64_t k) {
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * DM_BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * DM_BN;
  double c[4][4][4];
  dmma_mainloop<DM_BK, DM_STAGES>(a, b, m0, n0, m, n, k, c);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = m0 + wm + 16 * i + g + 8 * h;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = n0 + wn + 8 * j + 2 * q;
        if (col < n)                            // n even: col + 1 < n too
          *reinterpret_cast<double2*>(out + r * n + col) =
              make_double2(c[i][j][2 * h], c[i][j][2 * h + 1]);
      }
    }
}

int launch_dmma(const void* a, const void* b, void* out, int64_t m,
                int64_t n, int64_t k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t gy = (m + DM_BM - 1) / DM_BM, gx = (n + DM_BN - 1) / DM_BN;
  if (gy > kMaxGridY || gx > INT32_MAX || k / DM_BK >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(dmma_f64_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, DM_SMEM);
  dmma_f64_kernel<<<dim3(static_cast<unsigned>(gx),
                         static_cast<unsigned>(gy)),
                    DM_THREADS, DM_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<double*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// -- FFMA, float32 -----------------------------------------------------------

constexpr int FF_BM = 128, FF_BN = 128, FF_BK = 16, FF_THREADS = 256;
constexpr int FF_AS = FF_BM + 4;        // a's k-major rows, padded

// The FFMA main loop, K4's and K5's: thread (tx, ty) = (tid % 16, tid / 16)
// sums its 8 x 8 of the 128 x 128 tile at (m0, n0), acc = a · b, acc[i][j]
// at row 4·ty + i (+ 60 for i >= 4) and column 4·tx + j (+ 60 for j >= 4).
// Every thread calls hook(t) at the start of k-step t (K5 drives its copy
// stream from there; K4's hook does nothing).
template <typename Hook>
__device__ __forceinline__ void ffma_mainloop(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              int64_t m0, int64_t n0,
                                              int64_t m, int64_t n, int64_t k,
                                              float (&acc)[8][8], Hook hook) {
  __shared__ __align__(16) float as[2][FF_BK][FF_AS];
  __shared__ __align__(16) float bs[2][FF_BK][FF_BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tiles = static_cast<int>((k + FF_BK - 1) / FF_BK);

  // this thread's two 4-vectors of a (rows ar, ar + 64; k 4·ak..), through
  // registers, and of b (k-rows br, br + 8; columns 4·bc..), by cp.async
  const int ar = tid / 4, ak = tid % 4, br = tid / 32, bc = tid % 32;
  float4 pa[2];
  auto fetch = [&](int t, int buf) {
    const int64_t k0 = static_cast<int64_t>(t) * FF_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t r = m0 + ar + 64 * i, kk = k0 + 4 * ak;
      pa[i] = r < m && kk < k
                  ? *reinterpret_cast<const float4*>(a + r * k + kk)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      const int64_t kb = k0 + br + 8 * i, col = n0 + 4 * bc;
      const bool in = kb < k && col < n;
      cp_async16(&bs[buf][br + 8 * i][4 * bc], in ? b + kb * n + col : b, in);
    }
    cp_async_commit();
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* col = &as[buf][4 * ak][ar + 64 * i];
      col[0] = pa[i].x;
      col[FF_AS] = pa[i].y;
      col[2 * FF_AS] = pa[i].z;
      col[3 * FF_AS] = pa[i].w;
    }
    cp_async_wait<0>();
  };

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (tiles > 0) {
    fetch(0, 0);
    stash(0);
  }
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < tiles) fetch(t + 1, cur ^ 1);   // in flight during the FFMAs
    hook(t);
#pragma unroll
    for (int kk = 0; kk < FF_BK; ++kk) {
      float av[8], bv[8];
      *reinterpret_cast<float4*>(&av[0]) =
          *reinterpret_cast<const float4*>(&as[cur][kk][4 * ty]);
      *reinterpret_cast<float4*>(&av[4]) =
          *reinterpret_cast<const float4*>(&as[cur][kk][64 + 4 * ty]);
      *reinterpret_cast<float4*>(&bv[0]) =
          *reinterpret_cast<const float4*>(&bs[cur][kk][4 * tx]);
      *reinterpret_cast<float4*>(&bv[4]) =
          *reinterpret_cast<const float4*>(&bs[cur][kk][64 + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read in step t - 1, before that barrier
    if (t + 1 < tiles) stash(cur ^ 1);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(FF_THREADS, 2)
ffma_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int64_t m, int64_t n, int64_t k) {
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * FF_BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * FF_BN;
  float acc[8][8];
  ffma_mainloop(a, b, m0, n0, m, n, k, acc, [](int) {});

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = m0 + 4 * ty + i + (i >= 4 ? 60 : 0);
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t col = n0 + 4 * tx + 64 * h;
      if (col < n)                              // n % 4 == 0: col + 3 < n
        *reinterpret_cast<float4*>(out + r * n + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

int launch_ffma(const void* a, const void* b, void* out, int64_t m,
                int64_t n, int64_t k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t gy = (m + FF_BM - 1) / FF_BM, gx = (n + FF_BN - 1) / FF_BN;
  if (gy > kMaxGridY || gx > INT32_MAX || k / FF_BK >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  ffma_f32_kernel<<<dim3(static_cast<unsigned>(gx),
                         static_cast<unsigned>(gy)),
                    FF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// -- K5: the masked rank-k update on the FFMA and DMMA tiles -----------------

constexpr int RK_BM = 128, RK_BN = 128;     // both dtypes' output tiles

enum TileKind { kCopy, kInside, kDiagonal };

struct RankKTile {
  int64_t m0, n0;
  TileKind kind;
};

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

// tile t of the list: tile rows paired from the outside in (0 and gy - 1,
// 1 and gy - 2, ...), each pair's tiles alternating between its two rows;
// its kind from the global indices of its part inside (m, n)
template <bool LOWER>
__device__ __forceinline__ RankKTile rank_k_tile(int t, int gy, int gx,
                                                 int64_t m, int64_t n) {
  const int pairs = gy / 2;
  int ti, tj;
  if (t < 2 * pairs * gx) {
    const int p = t / (2 * gx), u = t % (2 * gx);
    ti = u % 2 ? gy - 1 - p : p;
    tj = u / 2;
  } else {                                  // the middle row of an odd gy
    ti = pairs;
    tj = t - 2 * pairs * gx;
  }
  RankKTile tile;
  tile.m0 = static_cast<int64_t>(ti) * RK_BM;
  tile.n0 = static_cast<int64_t>(tj) * RK_BN;
  const int64_t r1 = min64(tile.m0 + RK_BM, m) - 1;     // last row inside
  const int64_t c1 = min64(tile.n0 + RK_BN, n) - 1;     // last column
  if (LOWER)                                            // rows >= columns
    tile.kind = r1 < tile.n0 ? kCopy : tile.m0 >= c1 ? kInside : kDiagonal;
  else                                                  // rows <= columns
    tile.kind = tile.m0 > c1 ? kCopy : r1 <= tile.n0 ? kInside : kDiagonal;
  return tile;
}

// out = c on the tile at (m0, n0), by 16-byte integer vectors with the
// streaming hint, 8 loads in flight a thread before their stores
template <typename T, int THREADS>
__device__ __forceinline__ void copy_tile(const T* __restrict__ c,
                                          T* __restrict__ out, int64_t m0,
                                          int64_t n0, int64_t m, int64_t n) {
  constexpr int VEC = 16 / sizeof(T), VPR = RK_BN / VEC, U = 8;
  static_assert(RK_BM * VPR % (U * THREADS) == 0, "whole rounds of loads");
  const int64_t rows = min64(RK_BM, m - m0), cols = min64(RK_BN, n - n0);
#pragma unroll 1
  for (int v0 = threadIdx.x; v0 < RK_BM * VPR; v0 += U * THREADS) {
    int4 buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * THREADS, r = v / VPR, col = v % VPR * VEC;
      if (r < rows && col < cols)
        buf[u] = __ldcs(reinterpret_cast<const int4*>(c + (m0 + r) * n + n0
                                                       + col));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * THREADS, r = v / VPR, col = v % VPR * VEC;
      if (r < rows && col < cols)
        __stcs(reinterpret_cast<int4*>(out + (m0 + r) * n + n0 + col),
               buf[u]);
    }
  }
}

// a 1-D TMA copy of ``bytes`` (a multiple of 16) from global to shared
// memory, completing on ``bar``, under the L2 policy ``policy``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)),
         "l"(policy) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// until all of this thread's bulk groups are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// c and out pass through L2 once: evict them first
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// warp 0 has the TMA unit copy the tile's rows of c inside (m, n) into cs
// (rows CS elements apart); ``bar`` completes when all have landed
template <typename T, int CS>
__device__ __forceinline__ void prefetch_c(const T* __restrict__ c, T* cs,
                                           uint64_t* bar, int64_t m0,
                                           int64_t n0, int64_t m, int64_t n) {
  if (threadIdx.x >= 32) return;
  const int rows = static_cast<int>(min64(RK_BM, m - m0));
  const uint32_t bytes =
      static_cast<uint32_t>(min64(RK_BN, n - n0) * sizeof(T));
  if (threadIdx.x == 0) mbar_expect_tx(bar, rows * bytes);
  __syncwarp();
  const uint64_t policy = evict_first();
  for (int r = threadIdx.x; r < rows; r += 32)
    bulk_load(cs + r * CS, c + (m0 + r) * n + n0, bytes, bar, policy);
}

// float32 streams c's tile in, and its mirror tile through, in chunks of
// RK_CHUNK rows: TMA boxes of RK_CHUNK x RK_BN
constexpr int RK_CHUNK = 16, RK_CHUNKS = RK_BM / RK_CHUNK;
constexpr int RK_CHUNK_BYTES = RK_CHUNK * RK_BN * 4;

// the chunks of the tile at row m0 that hold rows inside m
__device__ __forceinline__ int chunks_inside(int64_t m0, int64_t m) {
  const int64_t left = (m - m0 + RK_CHUNK - 1) / RK_CHUNK;
  return static_cast<int>(left < RK_CHUNKS ? left : RK_CHUNKS);
}

// Tick s of the copy c -> out of the tile at (mr, mc) through the two chunk
// buffers ``buf`` and their mbarriers ``bar``, by one thread: store chunk
// s - 1, loaded one tick ago, then load chunk s into the buffer whose last
// store (chunk s - 2's) was issued one tick ago.  The TMA unit zero-fills
// what lies outside c and leaves out alone there.  Ticks 0 .. RK_CHUNKS
// move the tile; later ones do nothing.
__device__ __forceinline__ void mirror_tick(int s, const CUtensorMap* map_c,
                                            const CUtensorMap* map_out,
                                            float* buf, uint64_t* bar,
                                            int64_t mr, int64_t mc,
                                            int64_t m, uint64_t policy) {
  const int chunks = chunks_inside(mr, m);
  const int col = static_cast<int>(mc);
  if (s >= 1 && s <= chunks) {
    const int j = s - 1, half = j & 1;
    mbar_wait(&bar[half], (j >> 1) & 1);
    tma_store(map_out, buf + half * RK_CHUNK * RK_BN, col,
              static_cast<int>(mr) + j * RK_CHUNK, policy);
    bulk_commit();
  }
  if (s < chunks) {
    const int half = s & 1;
    bulk_wait_read<1>();
    mbar_expect_tx(&bar[half], RK_CHUNK_BYTES);
    tma_load_hinted(buf + half * RK_CHUNK * RK_BN, map_c, &bar[half], col,
                    static_cast<int>(mr) + s * RK_CHUNK, policy);
  }
}

// ``count`` mbarriers, each for one arrival
__device__ __forceinline__ void init_barriers(uint64_t* bar, int count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < count; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// c + alpha·p, each operation rounded once, where (r, col) lies in the
// triangle (everywhere off a diagonal tile); c itself elsewhere
template <bool LOWER>
__device__ __forceinline__ float masked_update(float c, float p, float alpha,
                                               bool diagonal, int64_t r,
                                               int64_t col) {
  const bool inside = !diagonal || (LOWER ? r >= col : r <= col);
  return inside ? __fadd_rn(c, __fmul_rn(alpha, p)) : c;
}

template <bool LOWER>
__device__ __forceinline__ double masked_update(double c, double p,
                                                double alpha, bool diagonal,
                                                int64_t r, int64_t col) {
  const bool inside = !diagonal || (LOWER ? r >= col : r <= col);
  return inside ? __dadd_rn(c, __dmul_rn(alpha, p)) : c;
}

// float32, in dynamic shared memory beside the FFMA loop's static 33 KB:
// c's 128 x 128 tile (64 KB), the mirror stream's two buffers (16 KB), and
// three mbarriers (c's tile, the two buffers)
constexpr int RK_FF_STAGE = RK_BM * RK_BN;                    // floats
constexpr int RK_FF_SMEM = (RK_FF_STAGE + 2 * RK_CHUNK * RK_BN) * 4 + 3 * 8;

template <bool LOWER>
__global__ void __launch_bounds__(FF_THREADS, 2)
rank_k_ffma_kernel(const __grid_constant__ CUtensorMap map_c,
                   const __grid_constant__ CUtensorMap map_out,
                   const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ c, float* __restrict__ out,
                   int64_t m, int64_t n, int64_t k, float alpha, int gy,
                   int gx) {
  extern __shared__ __align__(128) float rk_cs[];
  float* stage = rk_cs + RK_FF_STAGE;
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + 2 * RK_CHUNK * RK_BN);
  const RankKTile tile = rank_k_tile<LOWER>(blockIdx.x, gy, gx, m, n);
  // the mirror of an off-diagonal tile (its tile column and row swapped):
  // with square tiles it is a copy tile exactly when this one multiplies
  const bool mirrored = tile.m0 != tile.n0 && tile.n0 < m && tile.m0 < n;
  if (tile.kind == kCopy) {
    if (!mirrored)                  // else its mirror's block copies it
      copy_tile<float, FF_THREADS>(c, out, tile.m0, tile.n0, m, n);
    return;
  }
  init_barriers(bar, 3);
  // thread 0 has the TMA unit stream c's tile in, and the mirror through,
  // a chunk of rows a k-step: no warp leaves the FFMAs for them, and no
  // burst of loads holds up the loop's loads of a and b
  const bool lead = threadIdx.x == 0;
  const int c_chunks = chunks_inside(tile.m0, m);
  if (lead) mbar_expect_tx(bar, c_chunks * RK_CHUNK_BYTES);
  auto tick = [&](int s) {
    if (!lead) return;
    const uint64_t policy = evict_first();
    if (s < c_chunks)
      tma_load_hinted(rk_cs + s * RK_CHUNK * RK_BN, &map_c, bar,
                      static_cast<int>(tile.n0),
                      static_cast<int>(tile.m0) + s * RK_CHUNK, policy);
    if (mirrored)
      mirror_tick(s, &map_c, &map_out, stage, bar + 1, tile.n0, tile.m0, m,
                  policy);
  };
  float acc[8][8];
  ffma_mainloop(a, b, tile.m0, tile.n0, m, n, k, acc, tick);
  for (int s = static_cast<int>((k + FF_BK - 1) / FF_BK); s <= RK_CHUNKS;
       ++s)
    tick(s);
  mbar_wait(bar, 0);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool diagonal = tile.kind == kDiagonal;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = 4 * ty + i + (i >= 4 ? 60 : 0);
    const int64_t r = tile.m0 + lr;
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lc = 4 * tx + 64 * h;
      const int64_t col = tile.n0 + lc;
      if (col >= n) continue;                   // n % 4 == 0: col + 3 < n
      const float4 cv = *reinterpret_cast<const float4*>(rk_cs + lr * RK_BN
                                                         + lc);
      float4 o;
      o.x = masked_update<LOWER>(cv.x, acc[i][4 * h], alpha, diagonal, r,
                                 col);
      o.y = masked_update<LOWER>(cv.y, acc[i][4 * h + 1], alpha, diagonal, r,
                                 col + 1);
      o.z = masked_update<LOWER>(cv.z, acc[i][4 * h + 2], alpha, diagonal, r,
                                 col + 2);
      o.w = masked_update<LOWER>(cv.w, acc[i][4 * h + 3], alpha, diagonal, r,
                                 col + 3);
      __stcs(reinterpret_cast<float4*>(out + r * n + col), o);
    }
  }
  if (lead && mirrored) bulk_wait_all();    // before its buffers are freed
}

// float64: the DMMA loop with k-steps of 16 through 2 stages (73 KB), then
// c's tile with rows padded to 136 doubles (136 KB), then its mbarrier
constexpr int RK_DM_BK = 16, RK_DM_STAGES = 2;
constexpr int RK_DM_CS = RK_BN + 8;
constexpr int RK_DM_RING = RK_DM_STAGES * dm_stage(RK_DM_BK);   // doubles
constexpr int RK_DM_SMEM = (RK_DM_RING + RK_BM * RK_DM_CS) * 8 + 16;

template <bool LOWER>
__global__ void __launch_bounds__(DM_THREADS, 1)
rank_k_dmma_kernel(const double* __restrict__ a, const double* __restrict__ b,
                   const double* __restrict__ c, double* __restrict__ out,
                   int64_t m, int64_t n, int64_t k, double alpha, int gy,
                   int gx) {
  extern __shared__ __align__(16) double dm_smem[];
  double* cs = dm_smem + RK_DM_RING;
  uint64_t* bar = reinterpret_cast<uint64_t*>(cs + RK_BM * RK_DM_CS);
  const RankKTile tile = rank_k_tile<LOWER>(blockIdx.x, gy, gx, m, n);
  if (tile.kind == kCopy) {
    copy_tile<double, DM_THREADS>(c, out, tile.m0, tile.n0, m, n);
    return;
  }
  init_barriers(bar, 1);
  prefetch_c<double, RK_DM_CS>(c, cs, bar, tile.m0, tile.n0, m, n);
  double acc[4][4][4];
  dmma_mainloop<RK_DM_BK, RK_DM_STAGES>(a, b, tile.m0, tile.n0, m, n, k,
                                        acc);
  mbar_wait(bar, 0);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const bool diagonal = tile.kind == kDiagonal;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wm + 16 * i + g + 8 * h;
      const int64_t r = tile.m0 + lr;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lc = wn + 8 * j + 2 * q;
        const int64_t col = tile.n0 + lc;
        if (col >= n) continue;                 // n even: col + 1 < n too
        const double2 cv =
            *reinterpret_cast<const double2*>(cs + lr * RK_DM_CS + lc);
        double2 o;
        o.x = masked_update<LOWER>(cv.x, acc[i][j][2 * h], alpha, diagonal,
                                   r, col);
        o.y = masked_update<LOWER>(cv.y, acc[i][j][2 * h + 1], alpha,
                                   diagonal, r, col + 1);
        __stcs(reinterpret_cast<double2*>(out + r * n + col), o);
      }
    }
}

// a row-major (rows, cols) float32 matrix in the chunk boxes of RK_CHUNK
// rows x RK_BN columns, unswizzled
bool chunk_map(CUtensorMap* map, EncodeTiled encode, const void* base,
               int64_t rows, int64_t cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {RK_BN, RK_CHUNK};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one block a tile: the grid is the tile list
template <bool LOWER, typename T>
int launch_rank_k(const void* a, const void* b, const void* c, void* out,
                  int64_t m, int64_t n, int64_t k, double alpha,
                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t gy = (m + RK_BM - 1) / RK_BM, gx = (n + RK_BN - 1) / RK_BN;
  if (gy > kMaxGridY || gy * gx > INT32_MAX || k / 16 >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(gy * gx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, float>) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return -1;
    CUtensorMap map_c, map_out;
    if (m > INT32_MAX || n > INT32_MAX ||
        !chunk_map(&map_c, encode, c, m, n) ||
        !chunk_map(&map_out, encode, out, m, n))
      return -2;
    auto kernel = rank_k_ffma_kernel<LOWER>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         RK_FF_SMEM);
    // room for two blocks an SM
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    kernel<<<grid, FF_THREADS, RK_FF_SMEM, s>>>(
        map_c, map_out, static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<const float*>(c),
        static_cast<float*>(out), m, n, k,
        static_cast<float>(alpha), static_cast<int>(gy),
        static_cast<int>(gx));
  } else {
    auto kernel = rank_k_dmma_kernel<LOWER>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         RK_DM_SMEM);
    kernel<<<grid, DM_THREADS, RK_DM_SMEM, s>>>(
        static_cast<const double*>(a), static_cast<const double*>(b),
        static_cast<const double*>(c), static_cast<double*>(out), m, n, k,
        alpha, static_cast<int>(gy), static_cast<int>(gx));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int el_matmul_wgmma_bf16(const void* a, const void* b, void* out, int64_t m,
                         int64_t n, int64_t k, void* stream) {
  return launch_wgmma(a, b, out, m, n, k, stream);
}

int el_matmul_dmma_f64(const void* a, const void* b, void* out, int64_t m,
                       int64_t n, int64_t k, void* stream) {
  return launch_dmma(a, b, out, m, n, k, stream);
}

int el_matmul_ffma_f32(const void* a, const void* b, void* out, int64_t m,
                       int64_t n, int64_t k, void* stream) {
  return launch_ffma(a, b, out, m, n, k, stream);
}

#define EL_RANK_K(NAME, LOWER, T)                                            \
  int NAME(const void* a, const void* b, const void* c, void* out,           \
           int64_t m, int64_t n, int64_t k, double alpha, void* stream) {    \
    return launch_rank_k<LOWER, T>(a, b, c, out, m, n, k, alpha, stream);    \
  }

EL_RANK_K(el_rank_k_ffma_lower_f32, true, float)
EL_RANK_K(el_rank_k_ffma_upper_f32, false, float)
EL_RANK_K(el_rank_k_dmma_lower_f64, true, double)
EL_RANK_K(el_rank_k_dmma_upper_f64, false, double)

#undef EL_RANK_K

}  // extern "C"
