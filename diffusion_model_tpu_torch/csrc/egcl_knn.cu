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
// What bounds it: tensor-core FLOPs of the live slots, as in the dense
// kernel. An edge costs 2*F1*Fm + 2*F1*F1 FLOPs in the second-layer
// products plus 4*H*F1 in the j-side first layer (2.77 MFLOP at F1=1024,
// Fm=256, H=36), against the H + 3 values of node j it reads; inside the
// kernel the L2 traffic of W comes next (egcl_edge_tile.cuh). The j-side
// projection h_j @ W_j is computed per edge, so only the H-wide rows of h
// cross device memory and no [edges, F1] tensor is ever stored. What the
// design does about it (bf16):
//   * live-slot tiles: a block owns a run of consecutive targets in the
//     flattened (b, i) order, across graphs; it counts each target's live
//     slots (em != 0 and 0 <= idx < N) with warp ballots and walks only
//     those, in (i, slot) order, in 64-row tiles. It assumes nothing about
//     where live slots sit in a row, and never reads a node outside [0, N);
//   * the j-side first layer runs on the tensor cores: the tile's h_j rows
//     (bf16, zero past H) times W_j (TMA boxes of Hp = 16 ceil(H/16) rows,
//     zero-filled past H) as wgmma with f32 accumulation, rounded to bf16
//     into the A tile as the reference rounds it (f32 FMAs would run at
//     1/15 of the tensor-core rate); the build then adds a_i and
//     d2 * w_d 8 bf16 at a time, one row per warp;
//   * the second-layer products, the epilogue and the per-target sums are
//     the dense kernel's (egcl_edge_tile.cuh), geometry in float32.
// A masked slot contributes exactly nothing, so a padded target (all slots
// masked) gets m_sum = 0 and x_out = x_i exactly. The float32 variant keeps
// the padded schedule (TI = 16 / K targets a block, tiles of 16 slots) with
// every product as plain FMAs, for the tight parity check; it never uses
// TF32. Both count the tile rows they compute into `rows`.

#include "egcl_edge_tile.cuh"

namespace {

using namespace egcl;

constexpr int kMaxH = 48;  // node feature width, at most

// --- bf16: the live-slot schedule ---

struct KnnOp {
  static constexpr bool kJside = true;

  __device__ static int width(const EdgeArgs& p) { return p.K; }

  // Slot k of target `node` is live: unmasked, with a source inside the
  // graph.
  __device__ static bool lane_live(const EdgeArgs& p, int node, int k) {
    const size_t slot = size_t(node) * p.K + k;
    const int j = p.idx[slot];
    return (p.em[slot] != 0.0f) & (j >= 0) & (j < p.N);
  }

  __device__ static void source(const EdgeArgs& p, int node, int k, int* jn,
                                float* w) {
    const size_t slot = size_t(node) * p.K + k;
    *jn = node / p.N * p.N + p.idx[slot];
    *w = p.em[slot];
  }
};

// --- float32: the padded schedule ---

struct Params {
  const float *am, *ax;       // [B, N, F1]
  const float* h;             // [B, N, H]
  const float* x;             // [B, N, 3]
  const int* idx;             // [B, N, K]
  const float* em;            // [B, N, K]
  const float *wm_j, *wx_j;   // [H, F1]
  const float *w_dm, *w_dx;   // [F1]
  HeadWeights hw;
  float *m_sum, *x_out;       // [B, N, Fm], [B, N, 3]
  int* rows;
  int B, N, H, K, F1, Fm, TI;
};

__host__ __device__ constexpr int h_stride(int H) { return (H + 3) / 4 * 4; }

// A[r, k] = silu(a_i[k] + h_j . W_j[:, k] + d2 * w_d[k]) for the tile's
// live edges (hj holds their h_j rows, zero-padded to ldh); other rows are
// zero.
__device__ void build_pre(float* A, int lda, const float* a_rows,
                          const float* w_j, const float* w_d, const float* hj,
                          int ldh, const EdgeTile& e, int i0, int H, int F1) {
  for (int k = threadIdx.x; k < F1; k += kThreads) {
    float w[kMaxH];
#pragma unroll
    for (int c = 0; c < kMaxH; ++c) w[c] = c < H ? w_j[size_t(c) * F1 + k] : 0.0f;
    const float wd = w_d[k];
    for (int r = 0; r < kM32; ++r) {
      const int il = e.iloc[r];
      float v = 0.0f;
      if (il >= 0 && e.pm[r] != 0.0f) {
        float acc = a_rows[size_t(i0 + il) * F1 + k] + e.d2[r] * wd;
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
      A[r * lda + k] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads) egcl_knn_f32(Params p) {
  constexpr int M = kM32;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * p.TI;
  const int N = p.N, H = p.H, K = p.K, F1 = p.F1, Fm = p.Fm, TI = p.TI;
  const int lda = F1 + 4;
  const int ldh = h_stride(H);

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(F1, Fm, size_t(M) * ldh * 4);
  float* A = reinterpret_cast<float*>(smem + lay.a);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  float* msum = reinterpret_cast<float*>(smem + lay.msum);
  const EdgeTile e = carve_meta(smem + lay.meta, M);
  float* hj = reinterpret_cast<float*>(smem + lay.extra);  // [M, ldh]

  const size_t node0 = size_t(b) * N;
  const float* am = p.am + node0 * F1;
  const float* ax = p.ax + node0 * F1;
  const float* h = p.h + node0 * H;
  const float* x = p.x + node0 * 3;
  const int* idx = p.idx + node0 * K;
  const float* em = p.em + node0 * K;

  clear_targets(msum, e, TI, Fm);

  const int n_edges = TI * K;
  if (tid == 0) atomicAdd(p.rows, (n_edges + M - 1) / M * M);
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

    // --- gather h_j of the live edges (zero elsewhere) ---
    for (int v = tid; v < M * ldh; v += kThreads) {
      const int r = v / ldh;
      const int c = v - r * ldh;
      float val = 0.0f;
      if (c < H && e.iloc[r] >= 0 && e.pm[r] != 0.0f)
        val = h[size_t(e.j[r]) * H + c];
      hj[v] = val;
    }
    __syncthreads();

    // --- h branch: messages, attention gate, sum over the slots ---
    build_pre(A, lda, am, p.wm_j, p.w_dm, hj, ldh, e, i0, H, F1);
    __syncthreads();
    message_epilogue(A, lda, C, msum, e, p.hw, F1, Fm);

    // --- x branch: scalar per edge, coordinate update ---
    build_pre(A, lda, ax, p.wx_j, p.w_dx, hj, ldh, e, i0, H, F1);
    __syncthreads();
    coord_epilogue(A, lda, C, e, p.hw, F1, TI);
  }

  write_targets(p.m_sum, p.x_out, msum, e, x, node0, i0, TI, N, Fm);
}

int launch_f32(const Params& base, cudaStream_t stream) {
  Params p = base;
  p.TI = targets_per_block(p.K);
  const Layout lay(p.F1, p.Fm, size_t(kM32) * h_stride(p.H) * 4);
  if (lay.total > kMaxSmem) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      egcl_knn_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(lay.total));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.N + p.TI - 1) / p.TI, p.B);
  egcl_knn_f32<<<grid, kThreads, lay.total, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// `rows` (one int32, zeroed by the caller) receives the tile rows computed.
// Shapes the kernel does not take (F1 or Fm not a multiple of 64, Fm above
// 256, H outside 1..48, bf16 F1 above 1024, more shared memory than a block
// has) return cudaErrorInvalidValue.
int egcl_knn_forward(int use_bf16, const void* am, const void* ax,
                     const void* h, const void* x, const void* idx,
                     const void* edge_mask, const void* wm_j,
                     const void* wx_j, const void* w_dm, const void* w_dx,
                     const void* w2m, const void* b2m, const void* wa,
                     const void* ba, const void* w2x, const void* b2x,
                     const void* wx3, const void* bx3, void* m_sum,
                     void* x_out, void* rows, int B, int N, int H, int K,
                     int F1, int Fm, void* stream) {
  if (B < 1 || N < 1 || K < 1 || H < 1 || H > kMaxH || F1 % 64 != 0 ||
      Fm % 64 != 0 || Fm > kPass || F1 < 64 || Fm < 64)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!use_bf16) {
    Params p;
    p.am = static_cast<const float*>(am);
    p.ax = static_cast<const float*>(ax);
    p.h = static_cast<const float*>(h);
    p.x = static_cast<const float*>(x);
    p.idx = static_cast<const int*>(idx);
    p.em = static_cast<const float*>(edge_mask);
    p.wm_j = static_cast<const float*>(wm_j);
    p.wx_j = static_cast<const float*>(wx_j);
    p.w_dm = static_cast<const float*>(w_dm);
    p.w_dx = static_cast<const float*>(w_dx);
    p.hw.w2m = w2m; p.hw.w2x = w2x;
    p.hw.b2m = static_cast<const float*>(b2m);
    p.hw.wa = static_cast<const float*>(wa);
    p.hw.ba = static_cast<const float*>(ba);
    p.hw.b2x = static_cast<const float*>(b2x);
    p.hw.wx3 = static_cast<const float*>(wx3);
    p.hw.bx3 = static_cast<const float*>(bx3);
    p.m_sum = static_cast<float*>(m_sum);
    p.x_out = static_cast<float*>(x_out);
    p.rows = static_cast<int*>(rows);
    p.B = B; p.N = N; p.H = H; p.K = K; p.F1 = F1; p.Fm = Fm; p.TI = 1;
    return launch_f32(p, s);
  }
  const int hp = (H + 15) / 16 * 16;
  EdgeArgs a = {};
  int err = encode_weight(&a.w2m, w2m, F1, Fm, kSliceK);
  if (err == 0) err = encode_weight(&a.w2x, w2x, F1, F1, kSliceK);
  if (err == 0) err = encode_weight(&a.wmj, wm_j, H, F1, hp);
  if (err == 0) err = encode_weight(&a.wxj, wx_j, H, F1, hp);
  if (err != 0) return err;
  a.am = static_cast<const bf16*>(am);
  a.ax = static_cast<const bf16*>(ax);
  a.h = static_cast<const bf16*>(h);
  a.x = static_cast<const float*>(x);
  a.idx = static_cast<const int*>(idx);
  a.em = static_cast<const float*>(edge_mask);
  a.w_dm = static_cast<const bf16*>(w_dm);
  a.w_dx = static_cast<const bf16*>(w_dx);
  a.b2m = static_cast<const float*>(b2m);
  a.wa = static_cast<const float*>(wa);
  a.ba = static_cast<const float*>(ba);
  a.b2x = static_cast<const float*>(b2x);
  a.wx3 = static_cast<const float*>(wx3);
  a.bx3 = static_cast<const float*>(bx3);
  a.m_sum = static_cast<float*>(m_sum);
  a.x_out = static_cast<float*>(x_out);
  a.rows = static_cast<int*>(rows);
  a.N = N; a.K = K; a.H = H; a.Hp = hp; a.F1 = F1; a.Fm = Fm; a.T = B * N;
  return launch_edges<KnnOp>(a, K, s);
}

const char* egcl_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
