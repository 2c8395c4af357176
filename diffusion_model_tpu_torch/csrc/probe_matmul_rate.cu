// Chained tensor-core products, bf16 and int8, for Hopper (sm_90a): probe
// P2's entry points.
//
// Replaces benchmarks/probe_matmul_rate.py:45 pallas_chain (block chains)
// and :71 pallas_chain_ilp (warp chains), the Pallas TPU probe of the
// matrix unit's rate. The kernel, what bounds it and what its design does
// about that, and its launch plan are in chain_kernel.cuh; P2 runs it with
// no side warpgroup.

#include "chain_kernel.cuh"

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// a and out are [M, N], w and the scratch wT [N, N], all int8 or all bf16,
// row-major; M >= 1, N a multiple of 256. max_cluster: the most blocks a
// cluster may have (a power of two up to 16); max_stages: the most stages
// the ring of w may have (2 to 32). plan_out, on the host,
// receives the 8 integers of the plan used (struct Plan, in order) and the
// clusters of that shape the card holds at once (0: it cannot schedule one,
// and the launch is refused with cudaErrorInvalidConfiguration). phases, on
// the device or null, receives block 0's cycles per part of a link (and
// selects the kernel that reads the clock). Shapes
// the kernel does not take return cudaErrorInvalidValue.
int probe_chain(int int8, int warp_chains, const void* a, const void* w,
                void* out, void* wT, int M, int N, int steps,
                int max_cluster, int max_stages, int* plan_out,
                long long* phases, void* stream) {
  if (M < 1 || N < 256 || N % 256 != 0 || steps < 0 || wT == nullptr ||
      plan_out == nullptr || max_stages < 2 || max_stages > chain::kMaxStages)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chain::ChainArgs args{};
  args.phases = phases;
  return int8 ? chain::launch<int8_t, chain::NoSide>(
                    warp_chains, a, w, out, wT, M, N, steps, max_cluster,
                    max_stages, plan_out, args, s)
              : chain::launch<chain::bf16, chain::NoSide>(
                    warp_chains, a, w, out, wT, M, N, steps, max_cluster,
                    max_stages, plan_out, args, s);
}

// Clusters of `cluster` blocks of `smem` bytes that the card holds at once,
// for the kernel built for this type and slice width `ns`; 0 where the card
// refuses the shape or there is no such kernel. chain_plan asks through this.
int probe_chain_active_clusters(int int8, int ns, int cluster, int smem) {
  return int8 ? chain::active_for<int8_t, chain::NoSide>(ns, cluster, smem)
              : chain::active_for<chain::bf16, chain::NoSide>(ns, cluster,
                                                              smem);
}

const char* probe_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
