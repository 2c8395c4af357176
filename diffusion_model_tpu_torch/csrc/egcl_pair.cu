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
// What bounds it: tensor-core FLOPs of the live pairs. Each costs 2*F1*Fm +
// 2*F1*F1 FLOPs (2.62 MFLOP at F1=1024, Fm=256) in the two second-layer
// products, against at most 8 KB of node input (four bf16 projection rows),
// above the H100's ~295 FLOP/byte ridge even with no reuse; inside the
// kernel, the L2 traffic of W2m and W2x (every 64-row tile streams all 2.5
// MB of them) comes next. What the design does about it (bf16):
//   * live-edge tiles: a block owns a run of consecutive targets in the
//     flattened (b, i) order, across graphs; it counts each target's live
//     pairs (pm != 0: both atoms real, i != j) from the mask itself with
//     warp ballots, and walks only those, in (i, j) order, in 64-row tiles.
//     The padded grid costs nothing but the ragged tail of a block's last
//     tile (at 80 x 16 the grid holds 5.4x the live pairs);
//   * the build reads a_i, b_j and w_d 8 bf16 at a time, one row per warp
//     with the whole row's loads in flight, and writes silu(pre) straight
//     into the swizzled wgmma layout; SiLU runs on the hardware tanh (probe
//     P1 measured an element-wise build at 59% of an edge tile);
//   * both products run as wgmma from that tile, W streamed by TMA through a
//     four-stage ring by a producer warp; bias, SiLU, the gate and the
//     width-1 heads are folded into the epilogue on the accumulator
//     registers, so no [edges, F1] tensor reaches device memory
//     (egcl_edge_tile.cuh);
//   * sums over j are taken inside the block in a fixed order (a target's
//     partial sums wait in shared memory when it spans two tiles), with no
//     float atomics and nothing carried between blocks;
//   * geometry (d2, the norm, the coordinate update) stays float32, with
//     sqrt(max(d2, 1e-12)) on real pairs and 1 elsewhere.
// The float32 variant keeps the padded schedule (TI rows of one graph, tiles
// of 16 edges, plain FMAs, never TF32) for the tight parity check. Both count
// the tile rows they compute into `rows`.

#include "egcl_edge_tile.cuh"

namespace {

using namespace egcl;

// --- bf16: the live-pair schedule ---

struct PairOp {
  static constexpr bool kJside = false;

  __device__ static int width(const EdgeArgs& p) { return p.N; }

  // Pair (i, j) of target node = (b, i) is live: both atoms real, i != j.
  __device__ static bool lane_live(const EdgeArgs& p, int node, int j) {
    const int b = node / p.N, i = node - b * p.N;
    const float* mask = p.mask + size_t(b) * p.N;
    return (j != i) & (mask[i] != 0.0f) & (mask[j] != 0.0f);
  }

  __device__ static void source(const EdgeArgs& p, int node, int j, int* jn,
                                float* w) {
    const int jj = node / p.N * p.N + j;
    *jn = jj;
    *w = p.mask[node] * p.mask[jj];
  }
};

// --- float32: the padded schedule ---

struct Params {
  const float *am, *bm, *ax, *bx;  // [B, N, F1]
  const float *x, *mask;           // [B, N, 3], [B, N]
  const float *w_dm, *w_dx;        // [F1]
  HeadWeights hw;
  float *m_sum, *x_out;            // [B, N, Fm], [B, N, 3]
  int* rows;
  int B, N, F1, Fm, TI;
};

// A[r, k] = silu(a_i[k] + b_j[k] + d2 * w_d[k]) for the tile's edges; rows
// that are no edge of this block are zero.
__device__ void build_pre(float* A, int lda, const float* a_rows,
                          const float* b_rows, const float* w_d,
                          const EdgeTile& e, int i0, int F1) {
  for (int idx = threadIdx.x; idx < kM32 * F1; idx += kThreads) {
    const int r = idx / F1;
    const int k = idx - r * F1;
    const int il = e.iloc[r];
    float v = 0.0f;
    if (il >= 0) {
      const float pre = a_rows[size_t(i0 + il) * F1 + k] +
                        b_rows[size_t(e.j[r]) * F1 + k] + e.d2[r] * w_d[k];
      v = silu(pre);
    }
    A[r * lda + k] = v;
  }
}

__global__ void __launch_bounds__(kThreads) egcl_pair_f32(Params p) {
  constexpr int M = kM32;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * p.TI;
  const int N = p.N, F1 = p.F1, Fm = p.Fm, TI = p.TI;
  const int lda = F1 + 4;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(F1, Fm, 0);
  float* A = reinterpret_cast<float*>(smem + lay.a);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  float* msum = reinterpret_cast<float*>(smem + lay.msum);
  const EdgeTile e = carve_meta(smem + lay.meta, M);

  const size_t node0 = size_t(b) * N;
  const float* am = p.am + node0 * F1;
  const float* bm = p.bm + node0 * F1;
  const float* ax = p.ax + node0 * F1;
  const float* bx = p.bx + node0 * F1;
  const float* x = p.x + node0 * 3;
  const float* mask = p.mask + node0;

  clear_targets(msum, e, TI, Fm);

  const int n_edges = TI * N;
  if (tid == 0) atomicAdd(p.rows, (n_edges + M - 1) / M * M);
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
    build_pre(A, lda, am, bm, p.w_dm, e, i0, F1);
    __syncthreads();
    message_epilogue(A, lda, C, msum, e, p.hw, F1, Fm);

    // --- x branch: scalar per edge, coordinate update ---
    build_pre(A, lda, ax, bx, p.w_dx, e, i0, F1);
    __syncthreads();
    coord_epilogue(A, lda, C, e, p.hw, F1, TI);
  }

  write_targets(p.m_sum, p.x_out, msum, e, x, node0, i0, TI, N, Fm);
}

int launch_f32(const Params& base, cudaStream_t stream) {
  Params p = base;
  p.TI = targets_per_block(p.N);
  const Layout lay(p.F1, p.Fm, 0);
  if (lay.total > kMaxSmem) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      egcl_pair_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(lay.total));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.N + p.TI - 1) / p.TI, p.B);
  egcl_pair_f32<<<grid, kThreads, lay.total, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// `rows` (one int32, zeroed by the caller) receives the tile rows computed.
// Shapes the kernel does not take (F1 or Fm not a multiple of 64, Fm above
// 256, bf16 F1 above 1024, more shared memory than a block has) return
// cudaErrorInvalidValue.
int egcl_pair_forward(int use_bf16, const void* am, const void* bm,
                      const void* ax, const void* bx, const void* x,
                      const void* mask, const void* w_dm, const void* w_dx,
                      const void* w2m, const void* b2m, const void* wa,
                      const void* ba, const void* w2x, const void* b2x,
                      const void* wx3, const void* bx3, void* m_sum,
                      void* x_out, void* rows, int B, int N, int F1, int Fm,
                      void* stream) {
  if (B < 1 || N < 1 || F1 % 64 != 0 || Fm % 64 != 0 || Fm > kPass ||
      F1 < 64 || Fm < 64)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!use_bf16) {
    Params p;
    p.am = static_cast<const float*>(am);
    p.bm = static_cast<const float*>(bm);
    p.ax = static_cast<const float*>(ax);
    p.bx = static_cast<const float*>(bx);
    p.x = static_cast<const float*>(x);
    p.mask = static_cast<const float*>(mask);
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
    p.B = B; p.N = N; p.F1 = F1; p.Fm = Fm; p.TI = 1;
    return launch_f32(p, s);
  }
  EdgeArgs a = {};
  int err = encode_weight(&a.w2m, w2m, F1, Fm, kSliceK);
  if (err == 0) err = encode_weight(&a.w2x, w2x, F1, F1, kSliceK);
  if (err != 0) return err;
  a.am = static_cast<const bf16*>(am);
  a.bm = static_cast<const bf16*>(bm);
  a.ax = static_cast<const bf16*>(ax);
  a.bx = static_cast<const bf16*>(bx);
  a.x = static_cast<const float*>(x);
  a.mask = static_cast<const float*>(mask);
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
  a.N = N; a.F1 = F1; a.Fm = Fm; a.T = B * N;
  return launch_edges<PairOp>(a, N - 1, s);
}

const char* egcl_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
