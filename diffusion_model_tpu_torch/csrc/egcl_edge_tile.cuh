// The edge tile shared by the EGCL edge kernels for Hopper (sm_90a):
// egcl_pair.cu (K1, the dense pair grid) and egcl_knn.cu (K2, kNN lists).
//
// bf16 path (edge_kernel below): a block of 288 threads, two consumer
// warpgroups and one producer warp, owns a run of consecutive targets in the
// flattened (b, i) order, compacts their live edges (target, then j or slot)
// and walks them in tiles of 64 rows, so no row is computed for a dead pair
// except the ragged tail of the block's last tile. Per tile:
//   * the metadata: each warp finds the sources of its 8 rows with warp
//     ballots, the loads of all 8 in flight at once; geometry in float32;
//   * per branch, the build writes A = silu(a_i + b_j + d2 * w_d) in bf16,
//     one row per warp and step, 16-byte loads, straight into the wgmma
//     K-major layout with the 128-byte swizzle (K2 first puts h_j @ W_j
//     there on the tensor cores); SiLU runs on the hardware tanh;
//   * the products A @ W2m and A @ W2x run as wgmma m64nNk16 (bf16 in, f32
//     accumulate in registers), A from shared memory, B from a ring of four
//     16 KB stages that the producer warp fills with TMA (64 x 64 boxes,
//     128-byte swizzle, completion on mbarriers). Each warpgroup takes half
//     of a pass's columns, so both share one A tile and each W slice is
//     read once per tile; a stage holds one warpgroup's half of a 64-row
//     slice, so the two run out of step and one's wait on the ring overlaps
//     the other's products;
//   * the epilogue runs on the accumulator registers: bias, SiLU, the gate
//     and the wx3 head as row reductions across the quad and the two
//     warpgroups (the bias and head vectors held in shared memory), and the
//     per-target sums as segmented scans over the tile's rows (shuffles
//     within a warp, a warp's last row through shared memory). A target's
//     sums are carried to the next tile in shared memory until its last
//     edge, then written.
// What bounds it: W. Every 64-row tile streams all of W2m and W2x (2.5 MB at
// F1 = 1024, Fm = 256) from L2 for 64 x 2.62 MFLOP, 64 FLOP per byte; with
// A at 128 KB a larger tile does not fit, so the two warpgroups split the
// columns of one tile instead of owning a tile each. The ring (64 KB, what
// shared memory leaves) and its per-stage handshake, not the L2 bandwidth,
// hold the product loop below the tensor-core peak: a lone block takes as
// long per tile as a full card.
// Sums are taken in a fixed order with no float atomics, so two runs give
// identical bits.
//
// float32 path (kept as it was, the tight parity check): a block owns TI
// target rows of one graph and walks their padded edges in tiles of 16 with
// plain FMAs (tile_product, message_epilogue, coord_epilogue); never TF32.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace egcl {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;    // float32 path
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTI = 8;        // target rows per block, at most (float32)
constexpr int kPass = 256;       // output columns per product pass
constexpr int kLdc = kPass + 4;  // float row stride of the product tile
constexpr size_t kMaxSmem = 232448;
constexpr int kM32 = 16;         // edges per float32 tile

// Second-layer weights and the width-1 heads (the same for K1 and K2).
struct HeadWeights {
  const void* w2m;                // [F1, Fm] T
  const float *b2m, *wa, *ba;     // [Fm], [Fm], [1]
  const void* w2x;                // [F1, F1] T
  const float *b2x, *wx3, *bx3;   // [F1], [F1], [1]
};

__host__ __device__ constexpr size_t align128(size_t v) {
  return (v + 127) / 128 * 128;
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// float32 path
// ---------------------------------------------------------------------------

// Shared memory carve-up of the float32 path: the A tile, the product tile,
// the per-target message sums, the edge metadata, and `extra_bytes` of the
// kernel's own.
struct Layout {
  size_t a, c, msum, meta, extra, total;
  __host__ __device__ Layout(int F1, int Fm, size_t extra_bytes) {
    a = 0;
    c = align128(size_t(4) * kM32 * (F1 + 4));
    msum = c + align128(size_t(kM32) * kLdc * 4);
    meta = msum + align128(size_t(kMaxTI) * Fm * 4);
    // iloc, j, pm, d2, w, s (6 x M) + diff, upd (2 x 3M) + xacc
    extra = meta + align128(size_t(12) * kM32 * 4 + kMaxTI * 3 * 4);
    total = extra + align128(extra_bytes);
  }
};

// Per-tile edge metadata in shared memory (M entries each, row r = edge r
// of the tile) and the per-target coordinate sums kept across tiles.
struct EdgeTile {
  int* iloc;    // target row within the block; -1: no edge
  int* j;       // source node
  float* pm;    // edge weight: pair mask (K1) or edge mask (K2)
  float* d2;    // |x_i - x_j|^2, float32
  float* w;     // attention gate * pm
  float* s;     // coordinate scalar, summed over the passes
  float* diff;  // [M, 3] x_i - x_j
  float* upd;   // [M, 3] coordinate update of the edge
  float* xacc;  // [kMaxTI, 3] per-target sums of the updates
};

__device__ inline EdgeTile carve_meta(unsigned char* base, int M) {
  EdgeTile e;
  e.iloc = reinterpret_cast<int*>(base);
  e.j = e.iloc + M;
  e.pm = reinterpret_cast<float*>(e.j + M);
  e.d2 = e.pm + M;
  e.w = e.d2 + M;
  e.s = e.w + M;
  e.diff = e.s + M;
  e.upd = e.diff + 3 * M;
  e.xacc = e.upd + 3 * M;
  return e;
}

// Row r of the tile: edge (target row il, source j) with weight pm.
__device__ __forceinline__ void set_edge(const EdgeTile& e, int r, int il,
                                         int j, float pm, const float d[3],
                                         float d2) {
  e.iloc[r] = il;
  e.j[r] = j;
  e.pm[r] = pm;
  e.d2[r] = d2;
  e.s[r] = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) e.diff[r * 3 + c] = d[c];
}

// C[0:16, 0:ncols] = A[0:16, 0:K] @ W[0:K, col0:col0+ncols]: one thread per
// output column, plain FMAs over K, W read straight from global memory.
// Ends with a barrier.
__device__ inline void tile_product(const float* A, int lda, const float* W,
                                    int ldw, int col0, int ncols, int K,
                                    float* C) {
  constexpr int M = kM32;
  const int col = threadIdx.x;
  if (col < ncols) {
    float acc[M];
#pragma unroll
    for (int r = 0; r < M; ++r) acc[r] = 0.0f;
    const float* w = W + col0 + col;
    for (int k = 0; k < K; ++k) {
      const float wk = w[size_t(k) * ldw];
#pragma unroll
      for (int r = 0; r < M; ++r) acc[r] = fmaf(A[r * lda + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < M; ++r) C[r * kLdc + col] = acc[r];
  }
  __syncthreads();
}

// h branch of one tile, from A = silu(pre_m): messages, the attention gate
// and their sum into msum[target row]. Call after a barrier that follows the
// write of A; leaves C and e.w for nobody else.
__device__ inline void message_epilogue(const float* A, int lda, float* C,
                                        float* msum, const EdgeTile& e,
                                        const HeadWeights& hw, int F1,
                                        int Fm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  tile_product(A, lda, static_cast<const float*>(hw.w2m), Fm, 0, Fm, F1, C);
  for (int r = warp; r < kM32; r += kWarps) {
    float part = 0.0f;
    for (int c = lane; c < Fm; c += 32) {
      const float m = silu(C[r * kLdc + c] + hw.b2m[c]);
      C[r * kLdc + c] = m;
      part += m * hw.wa[c];
    }
    part = warp_sum(part);
    if (lane == 0) e.w[r] = sigmoid(part + hw.ba[0]) * e.pm[r];
  }
  __syncthreads();
  for (int c = tid; c < Fm; c += kThreads) {
    for (int r = 0; r < kM32; ++r) {
      const int il = e.iloc[r];
      if (il >= 0) msum[il * Fm + c] += C[r * kLdc + c] * e.w[r];
    }
  }
}

// x branch of one tile, from A = silu(pre_x): the coordinate scalar per
// edge in 256-column passes, the edge's update and its sum into e.xacc.
// Call after a barrier that follows the write of A. Ends with a barrier.
__device__ inline void coord_epilogue(const float* A, int lda, float* C,
                                      const EdgeTile& e,
                                      const HeadWeights& hw, int F1, int TI) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int col0 = 0; col0 < F1; col0 += kPass) {
    const int ncols = F1 - col0 < kPass ? F1 - col0 : kPass;
    tile_product(A, lda, static_cast<const float*>(hw.w2x), F1, col0, ncols,
                 F1, C);
    for (int r = warp; r < kM32; r += kWarps) {
      float part = 0.0f;
      for (int c = lane; c < ncols; c += 32) {
        const float u = silu(C[r * kLdc + c] + hw.b2x[col0 + c]);
        part += u * hw.wx3[col0 + c];
      }
      part = warp_sum(part);
      if (lane == 0) e.s[r] += part;
    }
    __syncthreads();
  }
  if (tid < kM32) {
    const float pm = e.pm[tid];
    const float s = e.s[tid] + hw.bx3[0];
    const float norm = sqrtf(pm > 0.0f ? fmaxf(e.d2[tid], 1e-12f) : 1.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      e.upd[tid * 3 + c] = e.diff[tid * 3 + c] * s / (norm + 1.0f) * pm;
  }
  __syncthreads();
  if (tid < TI * 3) {
    const int il = tid / 3;
    const int c = tid - il * 3;
    float acc = e.xacc[tid];
    for (int r = 0; r < kM32; ++r)
      if (e.iloc[r] == il) acc += e.upd[r * 3 + c];
    e.xacc[tid] = acc;
  }
  __syncthreads();
}

// Zero the per-target sums before the first tile. Needs a barrier after.
__device__ inline void clear_targets(float* msum, const EdgeTile& e, int TI,
                                     int Fm) {
  for (int v = threadIdx.x; v < TI * Fm; v += kThreads) msum[v] = 0.0f;
  if (threadIdx.x < TI * 3) e.xacc[threadIdx.x] = 0.0f;
}

// m_sum and x_out of the block's target rows i0 .. i0+TI-1 (< N) of the
// graph whose first node is node0; x points at that graph's coordinates.
__device__ inline void write_targets(float* m_sum, float* x_out,
                                     const float* msum, const EdgeTile& e,
                                     const float* x, size_t node0, int i0,
                                     int TI, int N, int Fm) {
  const int tid = threadIdx.x;
  for (int v = tid; v < TI * Fm; v += kThreads) {
    const int il = v / Fm;
    const int i = i0 + il;
    if (i < N) m_sum[(node0 + i) * Fm + (v - il * Fm)] = msum[v];
  }
  if (tid < TI * 3) {
    const int il = tid / 3;
    const int c = tid - il * 3;
    const int i = i0 + il;
    if (i < N) x_out[(node0 + i) * 3 + c] = x[i * 3 + c] + e.xacc[tid];
  }
}

// Rows i per float32 block: as many whole targets of `edges_per_target`
// edges as fit one tile of 16 edges, between 1 and kMaxTI.
inline int targets_per_block(int edges_per_target) {
  const int ti = kM32 / edges_per_target;
  return ti < 1 ? 1 : (ti > kMaxTI ? kMaxTI : ti);
}

// ---------------------------------------------------------------------------
// bf16 path: live-edge tiles, TMA-fed wgmma
// ---------------------------------------------------------------------------

constexpr int kConsumers = 256;                  // two consumer warpgroups
constexpr int kHopperThreads = kConsumers + 32;  // and one producer warp
constexpr int kRows = 64;                        // rows of a tile (wgmma M)
constexpr int kStages = 4;                       // ring of W slices
constexpr int kSliceK = 64;                      // W rows per slice
constexpr int kBoxBytes = kSliceK * 128;         // one 64 x 64 bf16 box
constexpr int kStageBytes = 2 * kBoxBytes;       // 16 KB: one warpgroup's
                                                 // columns of a slice
constexpr int kKBlock = kRows * 128;             // 64 rows x 64 bf16 of A
constexpr int kMaxTB = 1024;                     // targets per block, at most
constexpr int kMaxF1 = 1024;                     // A = F1 x 128 bytes
constexpr int kTilesPerBlock = 4;                // sizing goal of the grid
constexpr int kSMs = 132;
constexpr int kMaxHp = 48;                       // K2's h_j width, padded

// Targets per block from the mask-independent shape: T targets of at most
// E edges each. Enough blocks for about kTilesPerBlock full tiles each when
// every edge is live, at most one per SM, then as few targets per block as
// that allows (at most kMaxTB). ops/egcl_pair.py and ops/egcl_knn.py
// `edge_tiles` state the same rule.
inline int targets_per_block_bf16(long long T, long long E) {
  const long long per_block = 64LL * kTilesPerBlock;
  long long want = (T * E + per_block - 1) / per_block;
  want = want < 1 ? 1 : (want > kSMs ? kSMs : want);
  long long tb = (T + want - 1) / want;
  return int(tb < 1 ? 1 : (tb > kMaxTB ? kMaxTB : tb));
}

// Everything a bf16 launch needs; the tensor maps live in the kernel's
// parameter space (__grid_constant__).
struct EdgeArgs {
  CUtensorMap w2m, w2x;     // [F1, Fm], [F1, F1] bf16, boxes of 32 x 64
  CUtensorMap wmj, wxj;     // K2: [H, F1] bf16, boxes of Hp x 64
  const bf16 *am, *ax;      // [B*N, F1] i-side projections
  const bf16 *bm, *bx;      // K1: [B*N, F1] j-side projections
  const bf16* h;            // K2: [B*N, H]
  const float* x;           // [B*N, 3]
  const float* mask;        // K1: [B*N]
  const int* idx;           // K2: [B*N, K]
  const float* em;          // K2: [B*N, K]
  const bf16 *w_dm, *w_dx;  // [F1]
  const float *b2m, *wa, *ba, *b2x, *wx3, *bx3;
  float *m_sum, *x_out;     // [B*N, Fm], [B*N, 3]
  int* rows;                // tile rows computed, summed over the blocks
  int N, K, H, Hp, F1, Fm, T, TB;
};

// Per-tile state in shared memory.
struct TileMeta {
  int tgt[kRows];            // target of the row within the block; -1: tail
  int jn[kRows];             // source node, flattened b * N + j
  float pm[kRows], d2[kRows], s[kRows];
  float diff[kRows * 3];
  float red[3][2][kRows];    // row partials of each warpgroup: x passes
                             // (two, alternating) and the message
  float last[2][4][128];     // scan value of each warp's last row
  float mcarry[2][kPass];    // message sums carried to the next tile
  float xcarry[2][4];        // coordinate sums carried likewise
  float xlast[4];            // scan value of row 31 (the first warp's last)
  int ctgt[2];               // target the carry belongs to; -1: none
  // the epilogue's vectors, read once per block
  float b2m[kPass], wa[kPass], b2x[kMaxF1], wx3[kMaxF1];
};

// Shared memory of a bf16 block: A (F1/64 K-blocks of 64 rows x 128 bytes),
// the ring, the h_j tile (K2), the mbarriers, the targets' edge offsets and
// the tile state; 1024 bytes of slack align the base for the swizzle.
struct HopperLayout {
  size_t ring, ah, bars, off, meta, total;
  __host__ __device__ HopperLayout(int F1, int TB, bool jside) {
    ring = size_t(F1) * 128;
    ah = ring + size_t(kStages) * kStageBytes;
    bars = ah + (jside ? size_t(kKBlock) : 0);
    off = bars + 2 * kStages * 8;
    meta = off + align128(size_t(TB + 1) * 4);
    total = meta + sizeof(TileMeta) + 1024;
  }
};

// --- PTX: mbarriers, TMA, wgmma (hopper_ptx.cuh) ---

using namespace hopper;

// Barrier of the two consumer warpgroups only.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// A operand (K-major): columns k0 .. k0+15 of a tile stored as 64-column
// K-blocks of kKBlock bytes, rows 128 bytes apart, 8-row groups 1024 apart.
__device__ __forceinline__ uint64_t a_desc(uint32_t a, int k0) {
  return sw128_desc(a + (k0 >> 6) * kKBlock + (k0 & 63) * 2, 16, 1024);
}
// B operand (N-major, as W is stored): rows k0 .. k0+15 of TMA boxes of 64
// columns (128-byte rows, 8-row groups 1024 apart), boxes `box` bytes apart.
__device__ __forceinline__ uint64_t b_desc(uint32_t b, int k0, uint32_t box) {
  return sw128_desc(b + k0 * 128, box, 1024);
}
// Byte offset of element (r, k) in a K-major swizzled tile.
__device__ __forceinline__ uint32_t a_offset(int r, int k) {
  return (k >> 6) * kKBlock + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) +
         (k & 7) * 2;
}

#define EGCL_ACC8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] += A[64 x 16] @ B[16 x 64], B transposed (N-major).
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : EGCL_ACC8(0), EGCL_ACC8(8), EGCL_ACC8(16), EGCL_ACC8(24)
      : "l"(da), "l"(db), "r"(1));
}
// d[64 x 128] += A[64 x 16] @ B[16 x 128], B transposed (N-major).
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : EGCL_ACC8(0), EGCL_ACC8(8), EGCL_ACC8(16), EGCL_ACC8(24),
        EGCL_ACC8(32), EGCL_ACC8(40), EGCL_ACC8(48), EGCL_ACC8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef EGCL_ACC8

// --- host: tensor maps ---

// Map of a row-major [rows, cols] bf16 matrix in boxes of box_rows x 64
// with the 128-byte swizzle; rows past the end of the matrix load as zero.
inline int encode_weight(CUtensorMap* map, const void* w, int rows, int cols,
                         int box_rows) {
  return encode_kmajor(map, w, rows, cols, 2, box_rows);
}

// --- device: the consumers' pieces ---

// SiLU of the bf16 path, silu(v) = h + h tanh(h) with h = v / 2, on the
// hardware tanh: one special-function operation (relative error ~5e-4,
// below bf16's rounding), where an exponential and an IEEE division would
// cost the builds and the epilogue more than the products.
__device__ __forceinline__ float silu_bf(float v) {
  const float h = 0.5f * v;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// The consumers' view of the ring. Every stage belongs to one warpgroup:
// the producer fills the stages in one fixed sequence and position pos of
// it lands in stage pos % kStages, in that stage's (pos / kStages)-th use.
struct Ring {
  uint32_t base, full, empty;
  __device__ uint32_t wait(int pos) const {
    const int st = pos % kStages;
    mbar_wait(full + st * 8, (pos / kStages) & 1);
    return base + st * kStageBytes;
  }
  // Hands position pos back to the producer: one arrival per warp of the
  // warpgroup that used it.
  __device__ void release(int pos) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + (pos % kStages) * 8);
  }
};

// Columns of a pass of `width` that the first warpgroup takes (a multiple
// of 64); the second takes the rest.
__device__ __forceinline__ int first_half(int width) {
  return (width / 64 + 1) / 2 * 64;
}

// acc[64 x NW] = A @ (this warpgroup's NW columns of W), over F1 / kSliceK
// slices at ring positions pos0, pos0 + stride, ...; each stage goes back
// to the producer as soon as its products are done. The two warpgroups
// work on their own stages, so one's wait overlaps the other's products.
// NW = 0: the warpgroup has no columns in this pass.
template <int NW>
__device__ void wg_product(float* acc, uint32_t a, const Ring& ring,
                           int pos0, int stride, int nslices) {
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
  if constexpr (NW > 0) {
    for (int s = 0; s < nslices; ++s) {
      const int pos = pos0 + s * stride;
      const uint32_t st = ring.wait(pos);
      wgmma_fence();
      fence_regs(acc, NW / 2);
#pragma unroll
      for (int t = 0; t < kSliceK / 16; ++t) {
        const uint64_t da = a_desc(a, s * kSliceK + t * 16);
        const uint64_t db = b_desc(st, t * 16, kBoxBytes);
        if constexpr (NW == 64)
          wgmma_n64(acc, da, db);
        else
          wgmma_n128(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc, NW / 2);
      ring.release(pos);
    }
  }
}

// K2's j-side first layer: A[:, kb] = bf16(h_j @ W_j[:, kb]) for every
// 64-column K-block kb, on the tensor cores from the h_j tile at ah; ring
// position pos0 + kb holds K-block kb of W_j, and warpgroup kb % 2 takes it.
__device__ void jside_product(uint8_t* A, uint32_t ah, const Ring& ring,
                              int pos0, int F1, int Hp, int wg) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int q = lane & 3;
  for (int kb = wg; kb < F1 / 64; kb += 2) {
    const uint32_t st = ring.wait(pos0 + kb);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    wgmma_fence();
    fence_regs(acc, 32);
#pragma unroll
    for (int t = 0; t < kMaxHp / 16; ++t)
      if (t < Hp / 16)
        wgmma_n64(acc, a_desc(ah, t * 16), b_desc(st, t * 16, Hp * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc, 32);
    ring.release(pos0 + kb);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(
            A + a_offset(r0 + 8 * h, kb * 64 + 8 * i + 2 * q)) =
            __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
}

// silu(a + b + d2 * w) of two bf16 pairs, in float32, rounded once.
__device__ __forceinline__ uint32_t silu_pre2(uint32_t a, uint32_t b,
                                              uint32_t w, float d2) {
  const float2 af = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 bf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  const float2 wf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  __nv_bfloat162 o = __floats2bfloat162_rn(silu_bf(af.x + bf.x + d2 * wf.x),
                                           silu_bf(af.y + bf.y + d2 * wf.y));
  return *reinterpret_cast<uint32_t*>(&o);
}

// The build: A[r, :] = silu(a_i + b_j + d2 * w_d) for every row, 8 bf16
// (16 bytes) per load and store; tail rows are zero. b_j is the source
// node's row of b_rows (K1), or what A already holds (K2: h_j @ W_j). One
// row per warp and step, with every load of the row in flight before the
// first use; each lane keeps its part of w_d in registers.
template <bool kFromA>
__device__ void build_rows(uint8_t* A, const bf16* a_rows, const bf16* b_rows,
                           const bf16* w_d, const TileMeta& mt, int node0,
                           int F1) {
  constexpr int kCh = kMaxF1 / 256;  // 16-byte chunks of a row per lane
  const int lane = threadIdx.x & 31;
  const int nch = F1 / 8;
  const uint4* wd = reinterpret_cast<const uint4*>(w_d);
  uint4 wv[kCh];
#pragma unroll
  for (int u = 0; u < kCh; ++u)
    if (lane + 32 * u < nch) wv[u] = wd[lane + 32 * u];
  for (int r = threadIdx.x >> 5; r < kRows; r += kConsumers / 32) {
    const int t = mt.tgt[r];
    const float d2 = mt.d2[r];
    const uint4* ai = reinterpret_cast<const uint4*>(
        a_rows + size_t(node0 + (t < 0 ? 0 : t)) * F1);
    const uint4* bj = reinterpret_cast<const uint4*>(
        kFromA ? a_rows : b_rows + size_t(mt.jn[r]) * F1);
    uint4 av[kCh], bv[kCh];
#pragma unroll
    for (int u = 0; u < kCh; ++u) {
      const int ch = lane + 32 * u;
      if (t >= 0 && ch < nch) {
        av[u] = ai[ch];
        bv[u] = kFromA
                    ? *reinterpret_cast<const uint4*>(A + a_offset(r, ch * 8))
                    : bj[ch];
      }
    }
#pragma unroll
    for (int u = 0; u < kCh; ++u) {
      const int ch = lane + 32 * u;
      if (ch >= nch) continue;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (t >= 0) {
        out.x = silu_pre2(av[u].x, bv[u].x, wv[u].x, d2);
        out.y = silu_pre2(av[u].y, bv[u].y, wv[u].y, d2);
        out.z = silu_pre2(av[u].z, bv[u].z, wv[u].z, d2);
        out.w = silu_pre2(av[u].w, bv[u].w, wv[u].w, d2);
      }
      *reinterpret_cast<uint4*>(A + a_offset(r, ch * 8)) = out;
    }
  }
}

// Live edges of target `node`: positions (j or slot) below Op::width that
// Op::lane_live accepts. Warp-collective.
template <class Op>
__device__ int live_count(const EdgeArgs& p, int node, int lane) {
  const int width = Op::width(p);
  int n = 0;
  for (int c0 = 0; c0 < width; c0 += 32)
    n += __popc(__ballot_sync(
        0xffffffffu, c0 + lane < width && Op::lane_live(p, node, c0 + lane)));
  return n;
}

// Edge metadata of tile `tile`: row r is edge tile * 64 + r of the block
// in (target, j or slot) order. A warp finds the positions of its 8 rows
// together (warp ballots over the targets' positions, the loads of all 8
// rows in flight at once); then one thread a row reads the source (Op::
// source), its weight and the geometry, which stays float32. K2 also
// gathers the rows' h_j into the h_j tile (64 bf16 columns, zero past H).
template <class Op>
__device__ void tile_meta(const EdgeArgs& p, TileMeta& mt, const int* off,
                          int ntb, int n_edges, int tile, int node0,
                          uint8_t* ah) {
  constexpr int kWarpsC = kConsumers / 32;
  constexpr int kPer = kRows / kWarpsC;  // rows a warp: warp, warp + 8, ...
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = Op::width(p);
  int t[kPer], q[kPer], pos[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = tile * kRows + warp + kWarpsC * u;
    t[u] = -1;
    q[u] = 0;
    pos[u] = -1;
    if (e < n_edges) {
      int lo = 0, hi = ntb - 1;  // the last target whose edges start <= e
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (off[mid] <= e) lo = mid; else hi = mid - 1;
      }
      t[u] = lo;
      q[u] = e - off[lo];
    }
  }
  for (int c0 = 0; c0 < width; c0 += 32) {
    bool ok[kPer];
    const int pc = min(c0 + lane, width - 1);
#pragma unroll
    for (int u = 0; u < kPer; ++u)  // loads unconditional: all 8 in flight
      ok[u] = Op::lane_live(p, node0 + max(t[u], 0), pc) & (t[u] >= 0) &
              (pos[u] < 0) & (c0 + lane < width);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      unsigned bits = __ballot_sync(0xffffffffu, ok[u]);
      const int n = __popc(bits);
      if (t[u] >= 0 && pos[u] < 0) {
        if (q[u] < n) {  // the lane with q live positions below it
          const unsigned hit = __ballot_sync(
              0xffffffffu,
              ok[u] && __popc(bits & ((1u << lane) - 1u)) == q[u]);
          pos[u] = c0 + __ffs(hit) - 1;
        } else {
          q[u] -= n;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (lane == u) {
      mt.tgt[warp + kWarpsC * u] = t[u];
      mt.jn[warp + kWarpsC * u] = pos[u];
    }
  consumer_sync();
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x, tr = mt.tgt[r];
    int jn = 0;
    float w = 0.0f, d[3] = {0.0f, 0.0f, 0.0f};
    if (tr >= 0) {
      Op::source(p, node0 + tr, mt.jn[r], &jn, &w);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        d[c] = p.x[size_t(node0 + tr) * 3 + c] - p.x[size_t(jn) * 3 + c];
    }
    mt.jn[r] = jn;
    mt.pm[r] = w;
    mt.d2[r] = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    mt.s[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) mt.diff[r * 3 + c] = d[c];
  }
  if constexpr (Op::kJside) {
    consumer_sync();
    constexpr int kPerThread = kRows * 64 / kConsumers;
    bf16 v[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int idx = threadIdx.x + kConsumers * u;
      const int r = idx >> 6, c = idx & 63;
      v[u] = mt.tgt[r] >= 0 && c < p.H ? p.h[size_t(mt.jn[r]) * p.H + c]
                                        : __float2bfloat16(0.0f);
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int idx = threadIdx.x + kConsumers * u;
      *reinterpret_cast<bf16*>(ah + a_offset(idx >> 6, idx & 63)) = v[u];
    }
  }
}

// The gate of the message branch: m = silu(acc + b2m) in place, then
// acc = m * sigmoid(m . wa + ba) * pm, the row sum taken over the quad and
// then over the two warpgroups in a fixed order.
template <int NW>
__device__ void message_gate(float* acc, int col0, const EdgeArgs& p,
                             TileMeta& mt) {
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, q = lane & 3;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2), r1 = r0 + 8;
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int i = 0; i < NW / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 8 * i + 2 * q + h;
      const float b = mt.b2m[c], wa = mt.wa[c];
      acc[4 * i + h] = silu_bf(acc[4 * i + h] + b);
      acc[4 * i + 2 + h] = silu_bf(acc[4 * i + 2 + h] + b);
      p0 += acc[4 * i + h] * wa;
      p1 += acc[4 * i + 2 + h] * wa;
    }
  p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
  p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
  if (q == 0) {
    mt.red[2][wg][r0] = p0;
    mt.red[2][wg][r1] = p1;
  }
  consumer_sync();
  const float g0 = 1.0f / (1.0f + __expf(-(mt.red[2][0][r0] + mt.red[2][1][r0] +
                                           p.ba[0]))) * mt.pm[r0];
  const float g1 = 1.0f / (1.0f + __expf(-(mt.red[2][0][r1] + mt.red[2][1][r1] +
                                           p.ba[0]))) * mt.pm[r1];
#pragma unroll
  for (int i = 0; i < NW / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * i + h] *= g0;
      acc[4 * i + 2 + h] *= g1;
    }
}

// Per-target sums of the gated messages over the tile's rows, for this
// warpgroup's NW columns: a segmented inclusive scan over each warp's 16
// rows (shuffles), each warp's last row through shared memory to the warps
// after it, the sum carried from the previous tile; the row that ends a
// target's segment writes m_sum (its last edge) or the carry (the target
// goes on in the next tile). par: the tile's parity.
template <int NW>
__device__ void message_sums(float* acc, int col0, const EdgeArgs& p,
                             TileMeta& mt, const int* off, int tile,
                             int node0, int par) {
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int r0 = w * 16 + g, r1 = r0 + 8;
  const int t0 = mt.tgt[r0], t1 = mt.tgt[r1];
  bool f0[3], f1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f0[k] = g >= (1 << k) && mt.tgt[r0 - (1 << k)] == t0;
    f1[k] = g >= (1 << k) && mt.tgt[r1 - (1 << k)] == t1;
  }
  const bool join = mt.tgt[w * 16 + 7] == t1;
#pragma unroll
  for (int i = 0; i < NW / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = acc[4 * i + h], b = acc[4 * i + 2 + h];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float ua = __shfl_up_sync(0xffffffffu, a, 4 << k);
        const float ub = __shfl_up_sync(0xffffffffu, b, 4 << k);
        if (f0[k]) a += ua;
        if (f1[k]) b += ub;
      }
      const float end0 = __shfl_sync(0xffffffffu, a, 28 + q);
      if (join) b += end0;
      acc[4 * i + h] = a;
      acc[4 * i + 2 + h] = b;
      if (g == 7) mt.last[wg][w][8 * i + 2 * q + h] = b;
    }
  consumer_sync();
  const int tw = mt.tgt[w * 16];
  const int ct = mt.ctgt[par];
  const float* cin = mt.mcarry[par];
  float* cout = mt.mcarry[par ^ 1];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = hr ? r1 : r0;
    const int t = hr ? t1 : t0;
    if (t < 0 || (r < kRows - 1 && mt.tgt[r + 1] == t)) continue;
    const bool done = tile * kRows + r == off[t + 1] - 1;
#pragma unroll
    for (int i = 0; i < NW / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * i + 2 * q + h;
        float v = acc[4 * i + 2 * hr + h];
        if (t == tw) {
          for (int v2 = w - 1; v2 >= 0; --v2) {
            if (mt.tgt[v2 * 16 + 15] != t) break;
            v += mt.last[wg][v2][c];
            if (mt.tgt[v2 * 16] != t) break;
          }
        }
        if (t == ct) v += cin[col0 + c];
        if (done)
          p.m_sum[size_t(node0 + t) * p.Fm + col0 + c] = v;
        else
          cout[col0 + c] = v;
      }
  }
}

// The coordinate head over this warpgroup's NW columns of one W2x pass:
// sum_c silu(acc + b2x) * wx3 per row, over the quad, into red[slot][wg].
template <int NW>
__device__ void coord_pass(const float* acc, int col0, TileMeta& mt,
                           int slot) {
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, q = lane & 3;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int i = 0; i < NW / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 8 * i + 2 * q + h;
      const float b = mt.b2x[c], wx = mt.wx3[c];
      p0 += silu_bf(acc[4 * i + h] + b) * wx;
      p1 += silu_bf(acc[4 * i + 2 + h] + b) * wx;
    }
  p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
  p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
  if (q == 0) {
    mt.red[slot][wg][r0] = p0;
    mt.red[slot][wg][r0 + 8] = p1;
  }
}

template <int NW>
__device__ void message_branch(uint32_t a, const Ring& ring, int pos0,
                               int stride, int col0, const EdgeArgs& p,
                               TileMeta& mt, const int* off, int tile,
                               int node0, int par) {
  float acc[NW > 0 ? NW / 2 : 1];
  wg_product<NW>(acc, a, ring, pos0, stride, p.F1 / kSliceK);
  message_gate<NW>(acc, col0, p, mt);
  message_sums<NW>(acc, col0, p, mt, off, tile, node0, par);
}

template <int NW>
__device__ void coord_branch(uint32_t a, const Ring& ring, int pos0,
                             int stride, int col0, const EdgeArgs& p,
                             TileMeta& mt, int slot) {
  float acc[NW > 0 ? NW / 2 : 1];
  wg_product<NW>(acc, a, ring, pos0, stride, p.F1 / kSliceK);
  coord_pass<NW>(acc, col0, mt, slot);
}

// --- the kernel ---
//
// Op (K1: egcl_pair.cu, K2: egcl_knn.cu) supplies
//   kJside: whether the j-side first layer runs in the kernel (K2);
//   width(p): positions of a target (N for j, K for slots);
//   lane_live(p, node, pos): whether position pos (< width) of target
//     `node` is a live edge, with no branch around its loads;
//   source(p, node, pos, &jn, &w): that edge's source node (flattened
//     b * N + j) and weight.
template <class Op>
__global__ void __launch_bounds__(kHopperThreads, 1)
    edge_kernel(__grid_constant__ const EdgeArgs p) {
  extern __shared__ unsigned char smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const HopperLayout lay(p.F1, p.TB, Op::kJside);
  uint8_t* A = base;
  const uint32_t a_u32 = smem_u32(A);
  const uint32_t ring_u32 = smem_u32(base + lay.ring);
  const uint32_t ah_u32 = smem_u32(base + lay.ah);
  const uint32_t full = smem_u32(base + lay.bars);
  const uint32_t empty = full + kStages * 8;
  int* off = reinterpret_cast<int*>(base + lay.off);
  TileMeta& mt = *reinterpret_cast<TileMeta*>(base + lay.meta);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kAllWarps = kHopperThreads / 32;
  const int node0 = blockIdx.x * p.TB;
  const int ntb = min(p.TB, p.T - node0);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s * 8, 1);
      mbar_init(empty + s * 8, 4);  // the warps of one warpgroup
    }
    fence_mbarrier_init();
    off[0] = 0;
    mt.ctgt[0] = -1;
  }
  for (int t = warp; t < ntb; t += kAllWarps) {
    const int c = live_count<Op>(p, node0 + t, lane);
    if (lane == 0) off[t + 1] = c;
  }
  for (int c = tid; c < p.Fm; c += kHopperThreads) {
    mt.b2m[c] = p.b2m[c];
    mt.wa[c] = p.wa[c];
  }
  for (int c = tid; c < p.F1; c += kHopperThreads) {
    mt.b2x[c] = p.b2x[c];
    mt.wx3[c] = p.wx3[c];
  }
  __syncthreads();
  if (warp == 0) {  // off[t]: the block's edges before target t
    int carry = 0;
    for (int c0 = 1; c0 <= ntb; c0 += 32) {
      const int t = c0 + lane;
      int v = t <= ntb ? off[t] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (t <= ntb) off[t] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  // a target with no live edge: no message, coordinates unchanged
  for (int t = warp; t < ntb; t += kAllWarps) {
    if (off[t + 1] != off[t]) continue;
    const size_t node = size_t(node0 + t);
    for (int c = lane; c < p.Fm; c += 32) p.m_sum[node * p.Fm + c] = 0.0f;
    if (lane < 3) p.x_out[node * 3 + lane] = p.x[node * 3 + lane];
  }
  const int n_edges = off[ntb];
  const int tiles = (n_edges + kRows - 1) / kRows;
  if (tid == 0 && tiles > 0) atomicAdd(p.rows, tiles * kRows);

  if (warp == kConsumers / 32) {
    // --- producer: keeps the ring full, in the consumers' order ---
    if (lane == 0) {
      int pos = 0;
      auto put = [&](const CUtensorMap* map, int nbox, int col, int row,
                     int box_bytes) {
        const int st = pos % kStages;
        mbar_wait(empty + st * 8, ((pos / kStages) & 1) ^ 1);
        const uint32_t bar = full + st * 8;
        mbar_expect_tx(bar, nbox * box_bytes);
        const uint32_t dst = ring_u32 + st * kStageBytes;
        for (int b = 0; b < nbox; ++b)
          tma_load(dst + b * box_bytes, map, bar, col + b * 64, row);
        ++pos;
      };
      // a pass of `width` columns: per slice, a stage of the first
      // warpgroup's columns, then one of the second's (if it has any)
      auto pass = [&](const CUtensorMap* map, int col0, int width) {
        const int n0 = first_half(width), n1 = width - n0;
        for (int k = 0; k < p.F1; k += kSliceK) {
          put(map, n0 / 64, col0, k, kBoxBytes);
          if (n1 > 0) put(map, n1 / 64, col0 + n0, k, kBoxBytes);
        }
      };
      const int F1 = p.F1;
      for (int tile = 0; tile < tiles; ++tile) {
        if constexpr (Op::kJside)
          for (int kb = 0; kb < F1 / 64; ++kb)
            put(&p.wmj, 1, kb * 64, 0, p.Hp * 128);
        pass(&p.w2m, 0, p.Fm);
        if constexpr (Op::kJside)
          for (int kb = 0; kb < F1 / 64; ++kb)
            put(&p.wxj, 1, kb * 64, 0, p.Hp * 128);
        for (int c0 = 0; c0 < F1; c0 += kPass)
          pass(&p.w2x, c0, min(kPass, F1 - c0));
      }
    }
    return;
  }

  // --- consumers: two warpgroups ---
  const Ring ring{ring_u32, full, empty};
  const int wg = tid >> 7;
  const int nslices = p.F1 / kSliceK;
  int pos = 0;  // the next ring position, the same in every consumer
  for (int tile = 0; tile < tiles; ++tile) {
    const int par = tile & 1;
    tile_meta<Op>(p, mt, off, ntb, n_edges, tile, node0, base + lay.ah);
    fence_proxy_async();
    consumer_sync();
    if (tid == 0) {  // the target that goes on into the next tile
      const int t = mt.tgt[kRows - 1];
      mt.ctgt[par ^ 1] =
          t >= 0 && (tile + 1) * kRows - 1 != off[t + 1] - 1 ? t : -1;
    }

    // --- h branch: messages, gate, sums over the target's edges ---
    if constexpr (Op::kJside) {
      jside_product(A, ah_u32, ring, pos, p.F1, p.Hp, wg);
      pos += p.F1 / 64;
      consumer_sync();
    }
    build_rows<Op::kJside>(A, p.am, p.bm, p.w_dm, mt, node0, p.F1);
    fence_proxy_async();
    consumer_sync();
    {
      const int n0 = first_half(p.Fm), n1 = p.Fm - n0;
      const int nw = wg ? n1 : n0;
      const int col0 = wg ? n0 : 0;
      const int per = n1 > 0 ? 2 : 1;  // stages a slice
      if (nw == 128)
        message_branch<128>(a_u32, ring, pos + wg, per, col0, p, mt, off,
                            tile, node0, par);
      else if (nw == 64)
        message_branch<64>(a_u32, ring, pos + wg, per, col0, p, mt, off,
                           tile, node0, par);
      else
        message_branch<0>(a_u32, ring, pos + wg, per, col0, p, mt, off,
                          tile, node0, par);
      pos += per * nslices;
    }
    consumer_sync();  // every product of the branch has read A

    // --- x branch: coordinate scalar per edge, update, sums ---
    if constexpr (Op::kJside) {
      jside_product(A, ah_u32, ring, pos, p.F1, p.Hp, wg);
      pos += p.F1 / 64;
      consumer_sync();
    }
    build_rows<Op::kJside>(A, p.ax, p.bx, p.w_dx, mt, node0, p.F1);
    fence_proxy_async();
    consumer_sync();
    int slot = 0;
    for (int c0 = 0; c0 < p.F1; c0 += kPass, slot ^= 1) {
      const int width = min(kPass, p.F1 - c0);
      const int n0 = first_half(width), n1 = width - n0;
      const int nw = wg ? n1 : n0;
      const int col0 = c0 + (wg ? n0 : 0);
      const int per = n1 > 0 ? 2 : 1;
      if (nw == 128)
        coord_branch<128>(a_u32, ring, pos + wg, per, col0, p, mt, slot);
      else if (nw == 64)
        coord_branch<64>(a_u32, ring, pos + wg, per, col0, p, mt, slot);
      else
        coord_branch<0>(a_u32, ring, pos + wg, per, col0, p, mt, slot);
      pos += per * nslices;
      consumer_sync();
      if (tid < kRows) mt.s[tid] += mt.red[slot][0][tid] + mt.red[slot][1][tid];
    }
    // the update of each row, then the per-target sums: a segmented scan
    // over the rows (two warps, row 31 through shared memory); the row that
    // ends a target's segment adds the carry and writes x_out or the carry
    float v[3] = {0.0f, 0.0f, 0.0f};
    const int tr = tid < kRows ? mt.tgt[tid] : -1;
    if (tid < kRows) {
      const float pm = mt.pm[tid];
      const float s = mt.s[tid] + p.bx3[0];
      const float norm = sqrtf(pm > 0.0f ? fmaxf(mt.d2[tid], 1e-12f) : 1.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c] = mt.diff[tid * 3 + c] * s / (norm + 1.0f) * pm;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const bool same = lane >= o && mt.tgt[tid - o] == tr;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float u = __shfl_up_sync(0xffffffffu, v[c], o);
          if (same) v[c] += u;
        }
      }
      if (tid == 31)
        for (int c = 0; c < 3; ++c) mt.xlast[c] = v[c];
    }
    consumer_sync();
    if (tid < kRows && tr >= 0 &&
        (tid == kRows - 1 || mt.tgt[tid + 1] != tr)) {
      const bool joined = tid >= 32 && mt.tgt[31] == tr;
      const bool carried = tr == mt.ctgt[par];
      const bool done = tile * kRows + tid == off[tr + 1] - 1;
      const size_t node = size_t(node0 + tr);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float tot = v[c];
        if (joined) tot += mt.xlast[c];
        if (carried) tot += mt.xcarry[par][c];
        if (done)
          p.x_out[node * 3 + c] = p.x[node * 3 + c] + tot;
        else
          mt.xcarry[par ^ 1][c] = tot;
      }
    }
    consumer_sync();
  }
}

// Launches edge_kernel<Op> over T targets of at most `edges_per_target`
// edges each; the caller has filled `a` (tensor maps included) but TB.
template <class Op>
int launch_edges(EdgeArgs& a, long long edges_per_target,
                 cudaStream_t stream) {
  a.TB = targets_per_block_bf16(a.T, edges_per_target);
  const HopperLayout lay(a.F1, a.TB, Op::kJside);
  if (a.F1 > kMaxF1 || lay.total > kMaxSmem) return int(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      edge_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(lay.total));
  if (err != cudaSuccess) return int(err);
  const int grid = (a.T + a.TB - 1) / a.TB;
  edge_kernel<Op><<<grid, kHopperThreads, lay.total, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace egcl
