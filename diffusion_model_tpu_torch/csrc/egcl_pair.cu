// EGCL edge work over the dense pair grid, for Hopper (sm_90a).
//
// Replaces diffusion_model_tpu/ops/egcl_pallas.py:171 egcl_pair_kernel (the
// Pallas TPU kernel). For graph b and every ordered pair (i, j) of real atoms
// with i != j (pair mask pm):
//
//   pre_m = Am_i + Bm_j + d2_ij * w_dm
//   m     = silu(silu(pre_m) @ W2m + b2m)
//   m_sum_i = sum_j m * sigmoid(m . wa + ba) * pm
//   pre_x = Ax_i + Bx_j + d2_ij * w_dx
//   s     = silu(silu(pre_x) @ W2x + b2x) . wx3 + bx3
//   x_out_i = x_i + sum_j (x_i - x_j) * s / (|x_i - x_j| + 1) * pm
//
// What bounds it: tensor-core FLOPs. Each edge costs 2*F1*Fm + 2*F1*F1
// FLOPs (2.62 MFLOP at F1=1024, Fm=256) in the two second-layer products,
// against at most 8 KB of node input (four F1-wide bf16 projection rows),
// i.e. >= 320 FLOP per byte even with no reuse, above the H100's ~295
// FLOP/byte ridge; the 2.5 MB of W2m and W2x are re-read from L2 by every
// tile of edges. What the design does about it:
//   * one block owns TI rows i of one graph and loops over all j itself, so
//     the sums over j are taken inside the block, in a fixed order, with no
//     atomics and nothing carried between blocks;
//   * a tile of M edges (64 in bf16) is built in shared memory as
//     silu(pre) once, and both products run on the tensor cores (WMMA,
//     bf16 in, f32 accumulate) with W staged through shared memory;
//   * bias, SiLU, the attention gate and the width-1 heads (wa, wx3) are
//     folded into the epilogue as row reductions, so no [edges, F1] tensor
//     ever reaches device memory;
//   * geometry (d2, the norm, the coordinate update) stays float32, with
//     sqrt(max(d2, 1e-12)) on real pairs and 1 elsewhere.
// The float32 variant (M = 16) runs the products as plain FMAs, for the
// tight parity check; it never uses TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTI = 8;        // rows i per block, at most
constexpr int kPass = 256;       // output columns per product pass
constexpr int kKChunk = 64;      // rows of W staged per step (bf16 path)
constexpr int kLdc = kPass + 4;  // float row stride of the product tile
constexpr int kLdb = kPass + 8;  // bf16 row stride of the staged W slice
constexpr size_t kMaxSmem = 232448;

template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int M = 64; };
template <> struct Tile<float> { static constexpr int M = 16; };

struct Params {
  const void *am, *bm, *ax, *bx;  // [B, N, F1] T
  const float *x, *mask;          // [B, N, 3], [B, N]
  const void *w_dm, *w_dx;        // [F1] T
  const void *w2m;                // [F1, Fm] T
  const float *b2m, *wa, *ba;     // [Fm], [Fm], [1]
  const void *w2x;                // [F1, F1] T
  const float *b2x, *wx3, *bx3;   // [F1], [F1], [1]
  float *m_sum, *x_out;           // [B, N, Fm], [B, N, 3]
  int B, N, F1, Fm, TI;
};

__host__ __device__ constexpr size_t align128(size_t v) {
  return (v + 127) / 128 * 128;
}

// Shared memory carve-up, the same on host and device.
struct Layout {
  size_t a, c, msum, meta, total;
  __host__ __device__ Layout(size_t elem, int M, int F1, int Fm) {
    const size_t lda = F1 + 16 / elem;
    const size_t staged = elem == 2 ? size_t(kKChunk) * kLdb * 2 : 0;
    const size_t tile = size_t(M) * kLdc * 4;
    a = 0;
    c = align128(elem * M * lda);
    msum = c + align128(staged > tile ? staged : tile);
    meta = msum + align128(size_t(kMaxTI) * Fm * 4);
    // iloc, j, pm, d2, w, s_acc (6 x M) + diff, upd (2 x 3M) + xacc
    total = meta + align128(size_t(12) * M * 4 + kMaxTI * 3 * 4);
  }
};

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

// A[r, k] = silu(a_i[k] + b_j[k] + d2 * w_d[k]) for the tile's edges; rows
// that are no edge of this block are zero.
template <typename T, int M>
__device__ void build_pre(T* A, int lda, const T* a_rows, const T* b_rows,
                          const T* w_d, const int* e_iloc, const int* e_j,
                          const float* e_d2, int i0, int F1) {
  for (int idx = threadIdx.x; idx < M * F1; idx += kThreads) {
    const int r = idx / F1;
    const int k = idx - r * F1;
    const int il = e_iloc[r];
    float v = 0.0f;
    if (il >= 0) {
      const float pre = to_f32(a_rows[size_t(i0 + il) * F1 + k]) +
                        to_f32(b_rows[size_t(e_j[r]) * F1 + k]) +
                        e_d2[r] * to_f32(w_d[k]);
      v = silu(pre);
    }
    store_as(v, &A[r * lda + k]);
  }
}

// C[0:64, 0:ncols] = A[0:64, 0:K] @ W[0:K, col0:col0+ncols] on the tensor
// cores. The W slice is staged through the C region, so C is written only
// after the last slice has been read. Ends with a barrier.
__device__ void tile_product(const bf16* A, int lda, const bf16* W, int ldw,
                             int col0, int ncols, int K, float* C) {
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
__device__ void tile_product(const float* A, int lda, const float* W, int ldw,
                             int col0, int ncols, int K, float* C) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads) egcl_pair_kernel(Params p) {
  constexpr int M = Tile<T>::M;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * p.TI;
  const int N = p.N, F1 = p.F1, Fm = p.Fm, TI = p.TI;
  const int lda = F1 + 16 / int(sizeof(T));

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(sizeof(T), M, F1, Fm);
  T* A = reinterpret_cast<T*>(smem + lay.a);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  float* msum = reinterpret_cast<float*>(smem + lay.msum);
  int* e_iloc = reinterpret_cast<int*>(smem + lay.meta);  // -1: no edge
  int* e_j = e_iloc + M;
  float* e_pm = reinterpret_cast<float*>(e_j + M);
  float* e_d2 = e_pm + M;
  float* e_w = e_d2 + M;
  float* s_acc = e_w + M;
  float* e_diff = s_acc + M;   // [M, 3]
  float* e_upd = e_diff + 3 * M;  // [M, 3]
  float* xacc = e_upd + 3 * M;    // [TI, 3]

  const size_t node0 = size_t(b) * N;
  const T* am = static_cast<const T*>(p.am) + node0 * F1;
  const T* bm = static_cast<const T*>(p.bm) + node0 * F1;
  const T* ax = static_cast<const T*>(p.ax) + node0 * F1;
  const T* bx = static_cast<const T*>(p.bx) + node0 * F1;
  const float* x = p.x + node0 * 3;
  const float* mask = p.mask + node0;

  for (int idx = tid; idx < TI * Fm; idx += kThreads) msum[idx] = 0.0f;
  if (tid < TI * 3) xacc[tid] = 0.0f;

  const int n_edges = TI * N;
  for (int c0 = 0; c0 < n_edges; c0 += M) {
    // --- edge geometry of this tile (f32) ---
    if (tid < M) {
      const int e = c0 + tid;
      const int il = e / N;
      const int j = e - il * N;
      const int i = i0 + il;
      const bool edge = e < n_edges && i < N;
      float d[3] = {0.0f, 0.0f, 0.0f};
      float d2 = 0.0f, pm = 0.0f;
      if (edge) {
#pragma unroll
        for (int c = 0; c < 3; ++c) d[c] = x[i * 3 + c] - x[j * 3 + c];
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
        pm = i != j ? mask[i] * mask[j] : 0.0f;
      }
      e_iloc[tid] = edge ? il : -1;
      e_j[tid] = edge ? j : 0;
      e_pm[tid] = pm;
      e_d2[tid] = d2;
      s_acc[tid] = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) e_diff[tid * 3 + c] = d[c];
    }
    __syncthreads();

    // --- h branch: messages, attention gate, sum over j ---
    build_pre<T, M>(A, lda, am, bm, static_cast<const T*>(p.w_dm), e_iloc,
                    e_j, e_d2, i0, F1);
    __syncthreads();
    tile_product(A, lda, static_cast<const T*>(p.w2m), Fm, 0, Fm, F1, C);
    for (int r = warp; r < M; r += kWarps) {
      float part = 0.0f;
      for (int c = lane; c < Fm; c += 32) {
        const float m = silu(C[r * kLdc + c] + p.b2m[c]);
        C[r * kLdc + c] = m;
        part += m * p.wa[c];
      }
      part = warp_sum(part);
      if (lane == 0) e_w[r] = sigmoid(part + p.ba[0]) * e_pm[r];
    }
    __syncthreads();
    for (int c = tid; c < Fm; c += kThreads) {
      for (int r = 0; r < M; ++r) {
        const int il = e_iloc[r];
        if (il >= 0) msum[il * Fm + c] += C[r * kLdc + c] * e_w[r];
      }
    }

    // --- x branch: scalar per edge, coordinate update ---
    build_pre<T, M>(A, lda, ax, bx, static_cast<const T*>(p.w_dx), e_iloc,
                    e_j, e_d2, i0, F1);
    __syncthreads();
    for (int col0 = 0; col0 < F1; col0 += kPass) {
      const int ncols = F1 - col0 < kPass ? F1 - col0 : kPass;
      tile_product(A, lda, static_cast<const T*>(p.w2x), F1, col0, ncols, F1,
                   C);
      for (int r = warp; r < M; r += kWarps) {
        float part = 0.0f;
        for (int c = lane; c < ncols; c += 32) {
          const float u = silu(C[r * kLdc + c] + p.b2x[col0 + c]);
          part += u * p.wx3[col0 + c];
        }
        part = warp_sum(part);
        if (lane == 0) s_acc[r] += part;
      }
      __syncthreads();
    }
    if (tid < M) {
      const float pm = e_pm[tid];
      const float s = s_acc[tid] + p.bx3[0];
      const float norm = sqrtf(pm > 0.0f ? fmaxf(e_d2[tid], 1e-12f) : 1.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        e_upd[tid * 3 + c] = e_diff[tid * 3 + c] * s / (norm + 1.0f) * pm;
    }
    __syncthreads();
    if (tid < TI * 3) {
      const int il = tid / 3;
      const int c = tid - il * 3;
      float acc = xacc[tid];
      for (int r = 0; r < M; ++r)
        if (e_iloc[r] == il) acc += e_upd[r * 3 + c];
      xacc[tid] = acc;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < TI * Fm; idx += kThreads) {
    const int il = idx / Fm;
    const int i = i0 + il;
    if (i < N) p.m_sum[(node0 + i) * Fm + (idx - il * Fm)] = msum[idx];
  }
  if (tid < TI * 3) {
    const int il = tid / 3;
    const int c = tid - il * 3;
    const int i = i0 + il;
    if (i < N) p.x_out[(node0 + i) * 3 + c] = x[i * 3 + c] + xacc[tid];
  }
}

template <typename T>
int launch(const Params& base, cudaStream_t stream) {
  constexpr int M = Tile<T>::M;
  Params p = base;
  int ti = M / p.N;
  p.TI = ti < 1 ? 1 : (ti > kMaxTI ? kMaxTI : ti);
  const Layout lay(sizeof(T), M, p.F1, p.Fm);
  if (lay.total > kMaxSmem) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      egcl_pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(lay.total));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.N + p.TI - 1) / p.TI, p.B);
  egcl_pair_kernel<T><<<grid, kThreads, lay.total, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// Shapes the kernel does not take (F1 or Fm not a multiple of 64, Fm above
// 256, more shared memory than a block has) return cudaErrorInvalidValue.
int egcl_pair_forward(int use_bf16, const void* am, const void* bm,
                      const void* ax, const void* bx, const void* x,
                      const void* mask, const void* w_dm, const void* w_dx,
                      const void* w2m, const void* b2m, const void* wa,
                      const void* ba, const void* w2x, const void* b2x,
                      const void* wx3, const void* bx3, void* m_sum,
                      void* x_out, int B, int N, int F1, int Fm,
                      void* stream) {
  if (B < 1 || N < 1 || F1 % 64 != 0 || Fm % 64 != 0 || Fm > kPass ||
      F1 < 64 || Fm < 64)
    return int(cudaErrorInvalidValue);
  Params p;
  p.am = am; p.bm = bm; p.ax = ax; p.bx = bx;
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.w_dm = w_dm; p.w_dx = w_dx; p.w2m = w2m; p.w2x = w2x;
  p.b2m = static_cast<const float*>(b2m);
  p.wa = static_cast<const float*>(wa);
  p.ba = static_cast<const float*>(ba);
  p.b2x = static_cast<const float*>(b2x);
  p.wx3 = static_cast<const float*>(wx3);
  p.bx3 = static_cast<const float*>(bx3);
  p.m_sum = static_cast<float*>(m_sum);
  p.x_out = static_cast<float*>(x_out);
  p.B = B; p.N = N; p.F1 = F1; p.Fm = Fm; p.TI = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return use_bf16 ? launch<bf16>(p, s) : launch<float>(p, s);
}

const char* egcl_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
