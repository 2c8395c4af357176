// Hopper (sm_90a) building blocks shared by the EGCL edge tile
// (egcl_edge_tile.cuh: K1, K2), the chained products (chain_kernel.cuh:
// P2, P4) and the SiLU product (probe_pipeline.cu: P3): mbarriers, TMA
// loads (plain and multicast) and stores, thread-block clusters and
// distributed shared memory, the wgmma synchronisation, 128-byte-swizzled
// matrix descriptors, K-major wgmma products in bf16 and int8, a transpose,
// and tensor-map encoding on the host.
//
// Nothing here knows a kernel's tiles: a kernel brings its own layouts.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// --- mbarriers, TMA, proxies ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
// Makes mbarrier initialisations visible to the other blocks of the cluster
// and to the async proxy; call before the first cluster barrier.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Waits for the phase of parity `parity` to complete. A wait that never ends
// (a schedule that producer and consumers disagree on) traps, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++tries == (1u << 26)) __trap();
  } while (!done);
}
// One look at the phase of parity `parity`, without waiting: true if it
// has completed (try_wait may suspend the thread for a while; this does
// not).
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}
// The same box to every block of the cluster named in `mask` (bit = rank),
// at the same shared-memory offset in each, completing on the mbarrier at
// the same offset in each.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int col,
                                                   int row, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(col),
      "r"(row)
      : "memory");
}
// The box at (col, row) of `map` from this block's shared memory at `src`
// (laid out as the box lands in a load), as a bulk async-group of the
// issuing thread; elements outside the matrix are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
// Until at most N of this thread's bulk groups are still under way.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}
// Generic-proxy writes of shared memory made visible to the async proxy
// (wgmma, bulk copies); each writing thread fences before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --- thread-block clusters and distributed shared memory ---

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Barrier of every thread of the cluster, in two halves.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
// The shared::cluster address of this block's shared address `addr` in the
// block of rank `rank`.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// One arrival on an mbarrier of any block of the cluster (`bar` from
// map_to_rank).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Bulk copy of `bytes` (a multiple of 16) from this block's shared memory to
// shared memory of a block of the cluster; completes as transaction bytes on
// that block's mbarrier (`dst` and `bar` from map_to_rank).
__device__ __forceinline__ void dsmem_copy(uint32_t dst, uint32_t src,
                                           uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// --- wgmma ---

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float* d, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int* d, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

// K-major tiles of any element size: rows of 128 bytes of K (a "K-block":
// 64 bf16 or 128 int8), 8-row groups 1024 bytes apart, the 16-byte chunks of
// a row XORed with the row (the 128-byte swizzle, as TMA writes it);
// K-blocks of a `rows`-row tile follow each other rows * 128 bytes apart.
// Byte offset of the element at row r, byte kb of K.
__device__ __forceinline__ uint32_t kmajor_offset(int r, int kb, int rows) {
  return (kb >> 7) * (rows * 128) + r * 128 +
         ((((kb >> 4) & 7) ^ (r & 7)) << 4) + (kb & 15);
}
// Descriptor of the 32 bytes of K from byte kb on, of such a tile (both
// operands of the K-major products below).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kb,
                                                int rows) {
  return sw128_desc(tile + (kb >> 7) * (rows * 128) + (kb & 127), 16, 1024);
}

#define HOPPER_ACC8(c, i)                                            \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),       \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define HOPPER_F "+f"
#define HOPPER_R "+r"
#define HOPPER_REGS32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define HOPPER_REGS64                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"

#define HOPPER_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"

// d[64 x NW] += A[64 x 32 bytes of K] @ B[NW x 32 bytes of K]^T, both
// operands K-major in shared memory (kmajor_desc): bf16 into float32
// (m64nNWk16), NW = 64, 128 or 256.
template <int NW>
__device__ __forceinline__ void wgmma_kmajor(float* d, uint64_t da,
                                             uint64_t db) {
  static_assert(NW == 64 || NW == 128 || NW == 256, "width not built");
  if constexpr (NW == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_ACC8(HOPPER_F, 0), HOPPER_ACC8(HOPPER_F, 8),
          HOPPER_ACC8(HOPPER_F, 16), HOPPER_ACC8(HOPPER_F, 24)
        : "l"(da), "l"(db), "r"(1));
  } else if constexpr (NW == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOPPER_REGS128
        ", %128, %129, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_ACC8(HOPPER_F, 0),
          HOPPER_ACC8(HOPPER_F, 8),
          HOPPER_ACC8(HOPPER_F, 16),
          HOPPER_ACC8(HOPPER_F, 24),
          HOPPER_ACC8(HOPPER_F, 32),
          HOPPER_ACC8(HOPPER_F, 40),
          HOPPER_ACC8(HOPPER_F, 48),
          HOPPER_ACC8(HOPPER_F, 56),
          HOPPER_ACC8(HOPPER_F, 64),
          HOPPER_ACC8(HOPPER_F, 72),
          HOPPER_ACC8(HOPPER_F, 80),
          HOPPER_ACC8(HOPPER_F, 88),
          HOPPER_ACC8(HOPPER_F, 96),
          HOPPER_ACC8(HOPPER_F, 104),
          HOPPER_ACC8(HOPPER_F, 112),
          HOPPER_ACC8(HOPPER_F, 120)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_REGS64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_ACC8(HOPPER_F, 0), HOPPER_ACC8(HOPPER_F, 8),
          HOPPER_ACC8(HOPPER_F, 16), HOPPER_ACC8(HOPPER_F, 24),
          HOPPER_ACC8(HOPPER_F, 32), HOPPER_ACC8(HOPPER_F, 40),
          HOPPER_ACC8(HOPPER_F, 48), HOPPER_ACC8(HOPPER_F, 56)
        : "l"(da), "l"(db), "r"(1));
  }
}
// The same in int8 into int32 (m64nNWk32, NW = 128 or 256; 8-bit operands
// are K-major only).
template <int NW>
__device__ __forceinline__ void wgmma_kmajor(int* d, uint64_t da,
                                             uint64_t db) {
  static_assert(NW == 128 || NW == 256, "width not built");
  if constexpr (NW == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " HOPPER_REGS128
        ", %128, %129, p;\n}\n"
        : HOPPER_ACC8(HOPPER_R, 0),
          HOPPER_ACC8(HOPPER_R, 8),
          HOPPER_ACC8(HOPPER_R, 16),
          HOPPER_ACC8(HOPPER_R, 24),
          HOPPER_ACC8(HOPPER_R, 32),
          HOPPER_ACC8(HOPPER_R, 40),
          HOPPER_ACC8(HOPPER_R, 48),
          HOPPER_ACC8(HOPPER_R, 56),
          HOPPER_ACC8(HOPPER_R, 64),
          HOPPER_ACC8(HOPPER_R, 72),
          HOPPER_ACC8(HOPPER_R, 80),
          HOPPER_ACC8(HOPPER_R, 88),
          HOPPER_ACC8(HOPPER_R, 96),
          HOPPER_ACC8(HOPPER_R, 104),
          HOPPER_ACC8(HOPPER_R, 112),
          HOPPER_ACC8(HOPPER_R, 120)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HOPPER_REGS64
        ", %64, %65, p;\n}\n"
        : HOPPER_ACC8(HOPPER_R, 0), HOPPER_ACC8(HOPPER_R, 8),
          HOPPER_ACC8(HOPPER_R, 16), HOPPER_ACC8(HOPPER_R, 24),
          HOPPER_ACC8(HOPPER_R, 32), HOPPER_ACC8(HOPPER_R, 40),
          HOPPER_ACC8(HOPPER_R, 48), HOPPER_ACC8(HOPPER_R, 56)
        : "l"(da), "l"(db), "r"(1));
  }
}
#undef HOPPER_ACC8
#undef HOPPER_F
#undef HOPPER_R
#undef HOPPER_REGS32
#undef HOPPER_REGS64
#undef HOPPER_REGS128

// --- a transpose (the K-major B operand, once per call) ---

// out[c, r] = in[r, c] for a row-major [rows, cols] matrix, rows and cols
// multiples of 32; blocks of 256 threads on a (cols / 32, rows / 32) grid.
template <typename T>
__global__ void __launch_bounds__(256)
    transpose_kernel(const T* in, T* out, int rows, int cols) {
  __shared__ T tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  for (int r = ty; r < 32; r += 8)
    tile[r][tx] = in[size_t(r0 + r) * cols + c0 + tx];
  __syncthreads();
  for (int r = ty; r < 32; r += 8)
    out[size_t(c0 + r) * rows + r0 + tx] = tile[tx][r];
}

// --- host: tensor maps ---

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, reached through the runtime (no
// link against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Map of a row-major [rows, cols] matrix of 1-byte (int8) or 2-byte (bf16)
// elements in boxes of box_rows x 128 bytes with the 128-byte swizzle: a
// box lands in shared memory as a K-major tile (kmajor_offset). Rows past
// the end of the matrix load as zero.
inline int encode_kmajor(CUtensorMap* map, const void* m, int rows, int cols,
                         int elem_bytes, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return int(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * elem_bytes};
  const cuuint32_t box[2] = {cuuint32_t(128 / elem_bytes),
                             cuuint32_t(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map,
                        elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(m), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

}  // namespace hopper
