// Tensor-core and CUDA-core work in one loop, for Hopper (sm_90a).
//
// Replaces benchmarks/probe_overlap.py:45 make_call (the Pallas TPU probe
// of whether the vector unit's work hides behind the matrix unit's). Three
// modes of one kernel, as the TPU probe has them:
//   mxu   the int8 chain of probe P2, x <- clip((x @ w) >> 9, +-127),
//         `steps` links ([M, N] @ [N, N], int32 accumulation);
//   vpu   an independent float32 chain y <- y * sigmoid(y) + 0.3, four
//         times a link, on [M, N];
//   both  the two chains at once on the same SMs, with no data between
//         them.
// On this card "mxu" means the tensor cores and "vpu" the CUDA cores and
// the special-function unit (MUFU: the exp2 and the reciprocal of the
// sigmoid).
//
// What bounds it: mxu by a chain link's latency (P2's int8 block chain);
// vpu by the SFU, 2 MUFU operations a sigmoid at 16 a clock on an SM, so
// 2 * 4 * M * N * steps / 16 clocks spread over the SMs that hold the
// grid; both by whichever is longer if an SM runs SFU and tensor-core
// work at once, and by their sum if it does not. That is what the probe
// measures.
//
// What the design does about it. The grid is P2's int8 block chain
// (chain_kernel.cuh: 64-row chains in thread-block clusters, x whole in
// each block, requantised slices handed to the peers over DSMEM, w
// resident where it fits, the launch plan of make_plan), with a side
// warpgroup in every block that carries y over the block's own rows and
// columns of the chain (64 x NS values, NS / 2 a thread, in registers: 64
// at a time at NS = 128, all of them at M = 512 on 64 blocks; 32 at a time
// at NS = 256). The side warpgroup waits on none of the chain's barriers.
// The mode chooses which warpgroups work on the one grid (the chain runs no
// links in vpu, the side warpgroup none in mxu), so the three modes measure
// the same SMs. A sigmoid is ex2.approx and rcp.approx: two MUFU operations
// and three float32 ones.

#include "chain_kernel.cuh"

namespace {

constexpr int kRepeat = 4;   // sigmoid links of y per link of x
enum Mode { kMxu = 0, kVpu = 1, kBoth = 2 };

__device__ __forceinline__ float sigmoid_link(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return y * r + 0.3f;
}

// The y chain over a block's 64 rows from row0 and NS columns from col0,
// thread t of 128. A value's links depend on nothing else, so the values go
// through all their links a batch of whole rows at a time, the batch in
// registers: 64 values a thread, or 32 at NS = 256, where 64 beside the
// chain's 128 accumulators spill. Value i of a batch lies i * 128 / NS rows
// and (i * 128) % NS + t columns from the batch's corner, so a warp's loads
// and stores are 128 bytes in a row and every address is the corner's plus
// constants.
struct YChain {
  static constexpr int kThreads = 128;
  template <int NS>
  __device__ static void run(const chain::ChainArgs& p, int row0, int col0,
                             int t) {
    static_assert(NS % kThreads == 0, "whole rows a batch");
    constexpr int kBatch = NS == 128 ? 64 : 32;      // values a thread
    constexpr int kRowsBatch = kBatch * kThreads / NS;
#pragma unroll 1
    for (int r0 = row0; r0 < row0 + chain::kRows; r0 += kRowsBatch) {
      const float* in = p.y_in + size_t(r0) * p.N + col0 + t;
      float* out = p.y_out + size_t(r0) * p.N + col0 + t;
      float y[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int dr = i * kThreads / NS, dc = i * kThreads % NS;
        y[i] = r0 + dr < p.M ? in[dr * p.N + dc] : 0.f;
      }
      for (int step = 0; step < p.y_steps; ++step)
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
#pragma unroll
          for (int k = 0; k < kRepeat; ++k) y[i] = sigmoid_link(y[i]);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int dr = i * kThreads / NS, dc = i * kThreads % NS;
        if (r0 + dr < p.M) out[dr * p.N + dc] = y[i];
      }
    }
  }
};

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// mode 0 mxu, 1 vpu, 2 both. a, x_out [M, N] int8, w and the scratch wT
// [N, N] int8, y, y_out [M, N] float32, row-major; M >= 1, N a multiple of
// 256. plan_out, on the host, receives the chain's plan as probe_chain
// reports it (8 integers and the clusters the card holds at once). Shapes
// the kernel does not take return cudaErrorInvalidValue.
int probe_overlap(int mode, const void* a, const void* w, void* wT,
                  const void* y, void* x_out, void* y_out, int M, int N,
                  int steps, int* plan_out, void* stream) {
  if (M < 1 || N < 256 || N % 256 != 0 || steps < 0 || wT == nullptr ||
      plan_out == nullptr || mode < kMxu || mode > kBoth)
    return int(cudaErrorInvalidValue);
  chain::ChainArgs args{};
  args.y_in = static_cast<const float*>(y);
  args.y_out = static_cast<float*>(y_out);
  args.y_steps = mode == kMxu ? 0 : steps;
  return chain::launch<int8_t, YChain>(
      0, a, w, x_out, wT, M, N, mode == kVpu ? 0 : steps, chain::kMaxCluster,
      chain::kMaxStages, plan_out, args, static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` blocks of `smem` bytes that the card holds at once,
// for this kernel at slice width `ns` (0 where it refuses the shape); the
// wrapper plans through this, as P2's does.
int probe_overlap_active_clusters(int ns, int cluster, int smem) {
  return chain::active_for<int8_t, YChain>(ns, cluster, smem);
}

const char* probe_overlap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
