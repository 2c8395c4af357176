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
// tight parity check; it never uses TF32. The tile, its products and its
// epilogue are shared with the kNN kernel (egcl_edge_tile.cuh).

#include "egcl_edge_tile.cuh"

namespace {

using namespace egcl;

struct Params {
  const void *am, *bm, *ax, *bx;  // [B, N, F1] T
  const float *x, *mask;          // [B, N, 3], [B, N]
  const void *w_dm, *w_dx;        // [F1] T
  HeadWeights hw;
  float *m_sum, *x_out;           // [B, N, Fm], [B, N, 3]
  int B, N, F1, Fm, TI;
};

// A[r, k] = silu(a_i[k] + b_j[k] + d2 * w_d[k]) for the tile's edges; rows
// that are no edge of this block are zero.
template <typename T, int M>
__device__ void build_pre(T* A, int lda, const T* a_rows, const T* b_rows,
                          const T* w_d, const EdgeTile& e, int i0, int F1) {
  for (int idx = threadIdx.x; idx < M * F1; idx += kThreads) {
    const int r = idx / F1;
    const int k = idx - r * F1;
    const int il = e.iloc[r];
    float v = 0.0f;
    if (il >= 0) {
      const float pre = to_f32(a_rows[size_t(i0 + il) * F1 + k]) +
                        to_f32(b_rows[size_t(e.j[r]) * F1 + k]) +
                        e.d2[r] * to_f32(w_d[k]);
      v = silu(pre);
    }
    store_as(v, &A[r * lda + k]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) egcl_pair_kernel(Params p) {
  constexpr int M = Tile<T>::M;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * p.TI;
  const int N = p.N, F1 = p.F1, Fm = p.Fm, TI = p.TI;
  const int lda = F1 + 16 / int(sizeof(T));

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(sizeof(T), M, F1, Fm, 0);
  T* A = reinterpret_cast<T*>(smem + lay.a);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  float* msum = reinterpret_cast<float*>(smem + lay.msum);
  const EdgeTile e = carve_meta(smem + lay.meta, M);

  const size_t node0 = size_t(b) * N;
  const T* am = static_cast<const T*>(p.am) + node0 * F1;
  const T* bm = static_cast<const T*>(p.bm) + node0 * F1;
  const T* ax = static_cast<const T*>(p.ax) + node0 * F1;
  const T* bx = static_cast<const T*>(p.bx) + node0 * F1;
  const float* x = p.x + node0 * 3;
  const float* mask = p.mask + node0;

  clear_targets(msum, e, TI, Fm);

  const int n_edges = TI * N;
  for (int c0 = 0; c0 < n_edges; c0 += M) {
    // --- edge geometry of this tile (f32) ---
    if (tid < M) {
      const int r = c0 + tid;
      const int il = r / N;
      const int j = r - il * N;
      const int i = i0 + il;
      const bool edge = r < n_edges && i < N;
      float d[3] = {0.0f, 0.0f, 0.0f};
      float d2 = 0.0f, pm = 0.0f;
      if (edge) {
#pragma unroll
        for (int c = 0; c < 3; ++c) d[c] = x[i * 3 + c] - x[j * 3 + c];
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
        pm = i != j ? mask[i] * mask[j] : 0.0f;
      }
      set_edge(e, tid, edge ? il : -1, edge ? j : 0, pm, d, d2);
    }
    __syncthreads();

    // --- h branch: messages, attention gate, sum over j ---
    build_pre<T, M>(A, lda, am, bm, static_cast<const T*>(p.w_dm), e, i0, F1);
    __syncthreads();
    message_epilogue<T, M>(A, lda, C, msum, e, p.hw, F1, Fm);

    // --- x branch: scalar per edge, coordinate update ---
    build_pre<T, M>(A, lda, ax, bx, static_cast<const T*>(p.w_dx), e, i0, F1);
    __syncthreads();
    coord_epilogue<T, M>(A, lda, C, e, p.hw, F1, TI);
  }

  write_targets(p.m_sum, p.x_out, msum, e, x, node0, i0, TI, N, Fm);
}

template <typename T>
int launch(const Params& base, cudaStream_t stream) {
  constexpr int M = Tile<T>::M;
  Params p = base;
  p.TI = targets_per_block(M, p.N);
  const Layout lay(sizeof(T), M, p.F1, p.Fm, 0);
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
  p.w_dm = w_dm; p.w_dx = w_dx;
  p.hw.w2m = w2m; p.hw.w2x = w2x;
  p.hw.b2m = static_cast<const float*>(b2m);
  p.hw.wa = static_cast<const float*>(wa);
  p.hw.ba = static_cast<const float*>(ba);
  p.hw.b2x = static_cast<const float*>(b2x);
  p.hw.wx3 = static_cast<const float*>(wx3);
  p.hw.bx3 = static_cast<const float*>(bx3);
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
