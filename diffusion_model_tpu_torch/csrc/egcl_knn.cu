// EGCL edge work over fixed-degree kNN neighbour lists, for Hopper (sm_90a).
//
// Replaces diffusion_model_tpu/ops/egcl_pallas_sparse.py:177 egcl_knn_kernel
// (the Pallas TPU kernel). For graph b, target i and slot k < K with source
// j = idx[b, i, k] and edge weight em = edge_mask[b, i, k]:
//
//   pre_m = Am_i + h_j @ Wm_j + d2_ij * w_dm
//   m     = silu(silu(pre_m) @ W2m + b2m)
//   m_sum_i = sum_k m * sigmoid(m . wa + ba) * em
//   pre_x = Ax_i + h_j @ Wx_j + d2_ij * w_dx
//   s     = silu(silu(pre_x) @ W2x + b2x) . wx3 + bx3
//   x_out_i = x_i + sum_k (x_i - x_j) * s / (|x_i - x_j| + 1) * em
//
// What bounds it: tensor-core FLOPs, as in the dense kernel. An edge costs
// 2*F1*Fm + 2*F1*F1 FLOPs in the second-layer products plus 4*H*F1 in the
// j-side first layer (2.77 MFLOP at F1=1024, Fm=256, H=36), against the
// H + 3 values of node j it reads; the projections of target i are read
// once per tile. The j-side projection h_j @ W_j is computed per edge, so
// only the H-wide rows of h cross device memory and no [edges, F1] tensor
// is ever stored. What the design does about it:
//   * one block owns TI = M / K whole targets of one graph (2 at K=32, 4 at
//     K=15; one target over several tiles when K > M), so each target's sum
//     over its K slots is taken inside the block, in a fixed order, with no
//     atomics and nothing carried between blocks;
//   * the block reads its own idx rows, gathers the tile's h_j (f32) and
//     x_j rows into shared memory, and never reads a node outside [0, N):
//     a slot whose index lies outside is treated as masked;
//   * the first layer runs as f32 FMAs from shared memory (H <= 48, each
//     thread holds the W_j column of its output column in registers; ~5% of
//     the FLOPs) and is rounded once to the compute dtype as silu(pre);
//   * the second-layer products and the epilogue are the dense kernel's
//     (egcl_edge_tile.cuh): WMMA bf16 with f32 accumulation, bias, SiLU,
//     gate and the width-1 heads folded in, geometry in float32.
// A masked slot contributes exactly nothing, so a padded target (all slots
// masked) gets m_sum = 0 and x_out = x_i exactly. The float32 variant
// (M = 16) runs every product as plain FMAs; it never uses TF32.

#include "egcl_edge_tile.cuh"

namespace {

using namespace egcl;

constexpr int kMaxH = 48;  // node feature width, at most

struct Params {
  const void *am, *ax;        // [B, N, F1] T
  const void* h;              // [B, N, H] T
  const float* x;             // [B, N, 3]
  const int* idx;             // [B, N, K]
  const float* em;            // [B, N, K]
  const void *wm_j, *wx_j;    // [H, F1] T
  const void *w_dm, *w_dx;    // [F1] T
  HeadWeights hw;
  float *m_sum, *x_out;       // [B, N, Fm], [B, N, 3]
  int B, N, H, K, F1, Fm, TI;
};

__host__ __device__ constexpr int h_stride(int H) { return (H + 3) / 4 * 4; }

// A[r, k] = silu(a_i[k] + h_j . W_j[:, k] + d2 * w_d[k]) for the tile's
// live edges (hj holds their h_j rows, zero-padded to ldh); other rows are
// zero.
template <typename T, int M>
__device__ void build_pre(T* A, int lda, const T* a_rows, const T* w_j,
                          const T* w_d, const float* hj, int ldh,
                          const EdgeTile& e, int i0, int H, int F1) {
  for (int k = threadIdx.x; k < F1; k += kThreads) {
    float w[kMaxH];
#pragma unroll
    for (int c = 0; c < kMaxH; ++c)
      w[c] = c < H ? to_f32(w_j[size_t(c) * F1 + k]) : 0.0f;
    const float wd = to_f32(w_d[k]);
    for (int r = 0; r < M; ++r) {
      const int il = e.iloc[r];
      float v = 0.0f;
      if (il >= 0 && e.pm[r] != 0.0f) {
        float acc = to_f32(a_rows[size_t(i0 + il) * F1 + k]) + e.d2[r] * wd;
        const float4* hr = reinterpret_cast<const float4*>(hj + r * ldh);
#pragma unroll
        for (int c4 = 0; c4 < kMaxH / 4; ++c4) {
          if (4 * c4 < H) {
            const float4 hv = hr[c4];
            acc = fmaf(hv.x, w[4 * c4], acc);
            acc = fmaf(hv.y, w[4 * c4 + 1], acc);
            acc = fmaf(hv.z, w[4 * c4 + 2], acc);
            acc = fmaf(hv.w, w[4 * c4 + 3], acc);
          }
        }
        v = silu(acc);
      }
      store_as(v, &A[r * lda + k]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) egcl_knn_kernel(Params p) {
  constexpr int M = Tile<T>::M;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * p.TI;
  const int N = p.N, H = p.H, K = p.K, F1 = p.F1, Fm = p.Fm, TI = p.TI;
  const int lda = F1 + 16 / int(sizeof(T));
  const int ldh = h_stride(H);

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(sizeof(T), M, F1, Fm, size_t(M) * ldh * 4);
  T* A = reinterpret_cast<T*>(smem + lay.a);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  float* msum = reinterpret_cast<float*>(smem + lay.msum);
  const EdgeTile e = carve_meta(smem + lay.meta, M);
  float* hj = reinterpret_cast<float*>(smem + lay.extra);  // [M, ldh]

  const size_t node0 = size_t(b) * N;
  const T* am = static_cast<const T*>(p.am) + node0 * F1;
  const T* ax = static_cast<const T*>(p.ax) + node0 * F1;
  const T* h = static_cast<const T*>(p.h) + node0 * H;
  const float* x = p.x + node0 * 3;
  const int* idx = p.idx + node0 * K;
  const float* em = p.em + node0 * K;

  clear_targets(msum, e, TI, Fm);

  const int n_edges = TI * K;
  for (int c0 = 0; c0 < n_edges; c0 += M) {
    // --- edge geometry of this tile (f32): slot -> source j ---
    if (tid < M) {
      const int r = c0 + tid;
      const int il = r / K;
      const int i = i0 + il;
      const bool edge = r < n_edges && i < N;
      float d[3] = {0.0f, 0.0f, 0.0f};
      float d2 = 0.0f, pm = 0.0f;
      int j = 0;
      if (edge) {
        const size_t slot = size_t(i) * K + (r - il * K);
        const int src = idx[slot];
        const float w = em[slot];
        if (src >= 0 && src < N && w != 0.0f) {
          j = src;
          pm = w;
#pragma unroll
          for (int c = 0; c < 3; ++c) d[c] = x[i * 3 + c] - x[j * 3 + c];
          d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
        }
      }
      set_edge(e, tid, edge ? il : -1, j, pm, d, d2);
    }
    __syncthreads();

    // --- gather h_j of the live edges (f32, zero elsewhere) ---
    for (int v = tid; v < M * ldh; v += kThreads) {
      const int r = v / ldh;
      const int c = v - r * ldh;
      float val = 0.0f;
      if (c < H && e.iloc[r] >= 0 && e.pm[r] != 0.0f)
        val = to_f32(h[size_t(e.j[r]) * H + c]);
      hj[v] = val;
    }
    __syncthreads();

    // --- h branch: messages, attention gate, sum over the slots ---
    build_pre<T, M>(A, lda, am, static_cast<const T*>(p.wm_j),
                    static_cast<const T*>(p.w_dm), hj, ldh, e, i0, H, F1);
    __syncthreads();
    message_epilogue<T, M>(A, lda, C, msum, e, p.hw, F1, Fm);

    // --- x branch: scalar per edge, coordinate update ---
    build_pre<T, M>(A, lda, ax, static_cast<const T*>(p.wx_j),
                    static_cast<const T*>(p.w_dx), hj, ldh, e, i0, H, F1);
    __syncthreads();
    coord_epilogue<T, M>(A, lda, C, e, p.hw, F1, TI);
  }

  write_targets(p.m_sum, p.x_out, msum, e, x, node0, i0, TI, N, Fm);
}

template <typename T>
int launch(const Params& base, cudaStream_t stream) {
  constexpr int M = Tile<T>::M;
  Params p = base;
  p.TI = targets_per_block(M, p.K);
  const Layout lay(sizeof(T), M, p.F1, p.Fm, size_t(M) * h_stride(p.H) * 4);
  if (lay.total > kMaxSmem) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      egcl_knn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(lay.total));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.N + p.TI - 1) / p.TI, p.B);
  egcl_knn_kernel<T><<<grid, kThreads, lay.total, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// Shapes the kernel does not take (F1 or Fm not a multiple of 64, Fm above
// 256, H outside 1..48, more shared memory than a block has) return
// cudaErrorInvalidValue.
int egcl_knn_forward(int use_bf16, const void* am, const void* ax,
                     const void* h, const void* x, const void* idx,
                     const void* edge_mask, const void* wm_j,
                     const void* wx_j, const void* w_dm, const void* w_dx,
                     const void* w2m, const void* b2m, const void* wa,
                     const void* ba, const void* w2x, const void* b2x,
                     const void* wx3, const void* bx3, void* m_sum,
                     void* x_out, int B, int N, int H, int K, int F1, int Fm,
                     void* stream) {
  if (B < 1 || N < 1 || K < 1 || H < 1 || H > kMaxH || F1 % 64 != 0 ||
      Fm % 64 != 0 || Fm > kPass || F1 < 64 || Fm < 64)
    return int(cudaErrorInvalidValue);
  Params p;
  p.am = am; p.ax = ax; p.h = h;
  p.x = static_cast<const float*>(x);
  p.idx = static_cast<const int*>(idx);
  p.em = static_cast<const float*>(edge_mask);
  p.wm_j = wm_j; p.wx_j = wx_j; p.w_dm = w_dm; p.w_dx = w_dx;
  p.hw.w2m = w2m; p.hw.w2x = w2x;
  p.hw.b2m = static_cast<const float*>(b2m);
  p.hw.wa = static_cast<const float*>(wa);
  p.hw.ba = static_cast<const float*>(ba);
  p.hw.b2x = static_cast<const float*>(b2x);
  p.hw.wx3 = static_cast<const float*>(wx3);
  p.hw.bx3 = static_cast<const float*>(bx3);
  p.m_sum = static_cast<float*>(m_sum);
  p.x_out = static_cast<float*>(x_out);
  p.B = B; p.N = N; p.H = H; p.K = K; p.F1 = F1; p.Fm = Fm; p.TI = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return use_bf16 ? launch<bf16>(p, s) : launch<float>(p, s);
}

const char* egcl_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
