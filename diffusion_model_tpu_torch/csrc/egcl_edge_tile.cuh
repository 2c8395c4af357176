// The edge tile shared by the EGCL edge kernels for Hopper (sm_90a):
// egcl_pair.cu (K1, the dense pair grid) and egcl_knn.cu (K2, kNN lists).
//
// A block owns TI target rows i of one graph and walks over their edges in
// tiles of M edges (64 in bf16, 16 in float32). For each tile the kernel
// fills the edge metadata (EdgeTile: target row, source j, edge weight pm,
// d2, diff) and one A = silu(pre) tile per branch in shared memory; the
// pieces here do the rest:
//   * tile_product: C = A @ W on the tensor cores (WMMA, bf16 in, f32
//     accumulate), W staged through shared memory; the float32 variant runs
//     plain FMAs and never TF32;
//   * message_epilogue: m = silu(A @ W2m + b2m), the gate
//     sigmoid(m . wa + ba) * pm, and the per-target sum of m * gate;
//   * coord_epilogue: s = silu(A @ W2x + b2x) . wx3 + bx3 in 256-column
//     passes, the update diff * s / (|diff| + 1) * pm and its per-target sum;
//   * write_targets: m_sum and x_out = x_i + the summed update.
// Sums over a target's edges are taken inside the block, in a fixed order,
// with no atomics, so two runs give identical bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace egcl {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTI = 8;        // target rows per block, at most
constexpr int kPass = 256;       // output columns per product pass
constexpr int kKChunk = 64;      // rows of W staged per step (bf16 path)
constexpr int kLdc = kPass + 4;  // float row stride of the product tile
constexpr int kLdb = kPass + 8;  // bf16 row stride of the staged W slice
constexpr size_t kMaxSmem = 232448;

template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int M = 64; };
template <> struct Tile<float> { static constexpr int M = 16; };

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

// Shared memory carve-up, the same on host and device: the A tile, the
// product tile (which also stages W), the per-target message sums, the edge
// metadata, and `extra_bytes` of the kernel's own.
struct Layout {
  size_t a, c, msum, meta, extra, total;
  __host__ __device__ Layout(size_t elem, int M, int F1, int Fm,
                             size_t extra_bytes) {
    const size_t lda = F1 + 16 / elem;
    const size_t staged = elem == 2 ? size_t(kKChunk) * kLdb * 2 : 0;
    const size_t tile = size_t(M) * kLdc * 4;
    a = 0;
    c = align128(elem * M * lda);
    msum = c + align128(staged > tile ? staged : tile);
    meta = msum + align128(size_t(kMaxTI) * Fm * 4);
    // iloc, j, pm, d2, w, s (6 x M) + diff, upd (2 x 3M) + xacc
    extra = meta + align128(size_t(12) * M * 4 + kMaxTI * 3 * 4);
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float v, float* out) { *out = v; }
__device__ __forceinline__ void store_as(float v, bf16* out) {
  *out = __float2bfloat16(v);
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

// C[0:64, 0:ncols] = A[0:64, 0:K] @ W[0:K, col0:col0+ncols] on the tensor
// cores. The W slice is staged through the C region, so C is written only
// after the last slice has been read. Ends with a barrier.
__device__ inline void tile_product(const bf16* A, int lda, const bf16* W,
                                    int ldw, int col0, int ncols, int K,
                                    float* C) {
  using namespace nvcuda;
  bf16* Bs = reinterpret_cast<bf16*>(C);
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;  // rows wm*32 .. +32
  const int wn = warp & 3;   // cols wn*64 .. +64
  const bool active = wn * 64 < ncols;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) wmma::fill_fragment(acc[a][b], 0.0f);

  const int vec_per_row = ncols / 8;
  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    __syncthreads();  // the previous slice (or C) has been read
    for (int v = threadIdx.x; v < kKChunk * vec_per_row; v += kThreads) {
      const int row = v / vec_per_row;
      const int c8 = v - row * vec_per_row;
      *reinterpret_cast<uint4*>(Bs + row * kLdb + c8 * 8) =
          *reinterpret_cast<const uint4*>(W + size_t(k0 + row) * ldw + col0 +
                                          c8 * 8);
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kKChunk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
#pragma unroll
        for (int a = 0; a < 2; ++a)
          wmma::load_matrix_sync(af[a], A + (wm * 32 + a * 16) * lda + k0 + kk,
                                 lda);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          wmma::load_matrix_sync(bfr, Bs + kk * kLdb + wn * 64 + b * 16, kLdb);
#pragma unroll
          for (int a = 0; a < 2; ++a)
            wmma::mma_sync(acc[a][b], af[a], bfr, acc[a][b]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the staged slice
  if (active) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        wmma::store_matrix_sync(C + (wm * 32 + a * 16) * kLdc + wn * 64 + b * 16,
                                acc[a][b], kLdc, wmma::mem_row_major);
  }
  __syncthreads();
}

// Float32 variant: one thread per output column, plain FMAs over K, W read
// straight from global memory. Ends with a barrier.
__device__ inline void tile_product(const float* A, int lda, const float* W,
                                    int ldw, int col0, int ncols, int K,
                                    float* C) {
  constexpr int M = Tile<float>::M;
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
template <typename T, int M>
__device__ void message_epilogue(const T* A, int lda, float* C, float* msum,
                                 const EdgeTile& e, const HeadWeights& hw,
                                 int F1, int Fm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  tile_product(A, lda, static_cast<const T*>(hw.w2m), Fm, 0, Fm, F1, C);
  for (int r = warp; r < M; r += kWarps) {
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
    for (int r = 0; r < M; ++r) {
      const int il = e.iloc[r];
      if (il >= 0) msum[il * Fm + c] += C[r * kLdc + c] * e.w[r];
    }
  }
}

// x branch of one tile, from A = silu(pre_x): the coordinate scalar per
// edge in 256-column passes, the edge's update and its sum into e.xacc.
// Call after a barrier that follows the write of A. Ends with a barrier.
template <typename T, int M>
__device__ void coord_epilogue(const T* A, int lda, float* C,
                               const EdgeTile& e, const HeadWeights& hw,
                               int F1, int TI) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int col0 = 0; col0 < F1; col0 += kPass) {
    const int ncols = F1 - col0 < kPass ? F1 - col0 : kPass;
    tile_product(A, lda, static_cast<const T*>(hw.w2x), F1, col0, ncols, F1,
                 C);
    for (int r = warp; r < M; r += kWarps) {
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
  if (tid < M) {
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
    for (int r = 0; r < M; ++r)
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

// Rows i per block: as many whole targets of `edges_per_target` edges as
// fit one tile of M edges, between 1 and kMaxTI.
inline int targets_per_block(int M, int edges_per_target) {
  const int ti = M / edges_per_target;
  return ti < 1 ? 1 : (ti > kMaxTI ? kMaxTI : ti);
}

}  // namespace egcl
