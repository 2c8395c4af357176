// Chained tensor-core products, bf16 and int8, for Hopper (sm_90a): the
// kernel of the chained-product probe (probe_matmul_rate.cu, P2) and of the
// overlap probe (probe_overlap.cu, P4), which adds a side warpgroup.
//
// The chain of benchmarks/probe_matmul_rate.py:45 pallas_chain and :71
// pallas_chain_ilp (the Pallas TPU probe of the matrix unit's rate): the
// serial chain x <- requant(x @ w), `steps` times, with x
// [M, N] and w [N, N]: int8 products into int32 and requant
// clip(o >> 9, +-127), or bf16 products into float32 and requant bf16(o/32).
// Every link needs the whole previous x, so no loop transform can drop one.
//
// What bounds it on this card. Operations: 2*M*N*N per link. At a
// card-filling M (16,896 rows) that is the bound, 9.17 ms for 256 links at
// the 989 TFLOP/s bf16 peak and half that in int8. At the TPU probe's
// M = 512 the operations are 0.278 ms (bf16) and what a chain pays for is
// its latency: rows are independent but an output row needs the whole
// input row, wgmma takes 64 rows, so M = 512 is 8 independent chains; one
// SM per chain would be 8 of 132 SMs at 17.9 us of products a link. What
// then limits a link is the W stream (a 64-row group pulls all of w, 2 MB
// in bf16, from L2 for every link, 64 FLOP per byte) and the hand-over of x
// between the blocks that share a chain.
//
// What the design does about it:
//   * a thread-block cluster carries a 64-row group's chain. Each of its
//     `cs` blocks owns N / cs output columns and holds the whole x of the
//     group in shared memory for all links (K-major, 128-byte swizzle: the
//     A operand of wgmma), so x never goes back to device memory;
//   * products are wgmma m64nNSk16 (bf16 -> f32) or m64nNSk32 (int8 ->
//     int32), both operands from shared memory, started by one consumer
//     warpgroup at the full width NS of the block's slice (64, 128 or
//     256). The tensor cores are not what a link waits for (the warpgroup
//     spends 2-4% of a link in wgmma.wait_group), so one warpgroup is
//     enough, and a link has fewer barriers to pass. What a stage costs is what the loop does around
//     its four products: the indices are kept by increments, with no
//     division by a runtime value, which was a third of a link. int8 wgmma
//     takes K-major operands only, so w is transposed once per call
//     (hopper::transpose_kernel) and both types read the same layouts;
//   * a producer warp streams the block's slice of w^T through a ring of
//     TMA stages (NS rows x 128 bytes of K), running ahead across links;
//     where the whole slice fits beside x (int8 at N = 1024, cs = 8) it is
//     loaded once and stays. The warpgroup keeps one stage's products in
//     flight while it waits for the next stage (wgmma.wait_group 1) and
//     looks at the next stage's barrier meanwhile. In bf16 this stream is
//     what bounds a link: x leaves the ring 96 KB, and every stage taken
//     from the ring (max_stages) costs more than the one before;
//   * the hand-over: after a link the warpgroup requantises its
//     accumulators straight into the block's own columns of its x, and
//     sends that slice to every other block of the chain with one bulk
//     copy each through distributed shared memory (one lane a peer; each
//     block starts with another peer, so no block is everyone's first
//     target), which completes on the receiver's mbarrier for that slice
//     (`xin`). A link
//     walks K in the order the slices arrive, its own first, so the copies
//     still under way hide behind the products. Nobody overwrites an x that
//     is still being read: a block tells its peers with a remote mbarrier
//     arrival (`xfree`) when its products of the link are done, and a block
//     writes and copies only after all have. No staging tile (the ring gets
//     that room) and no cluster-wide barrier inside the chain.
// Two schedules of one function, as the TPU probe has two:
//   * block chains (pallas_chain): a cluster is one chain; with few row
//     groups the cluster is as wide as the card holds all clusters at once,
//     so the link's latency is what is measured;
//   * warp chains (pallas_chain_ilp, independent chains in flight): a
//     cluster carries two chains, one per half, each half its own row
//     group with its own hand-over barriers; the two blocks that own the
//     same columns share one W stream, loaded once by TMA multicast, so a
//     link of one chain runs while the other hands over. (A "warp chain"
//     is a half-cluster's; a single warp cannot start a wgmma.)
// The launch plan (cluster, column slice, ring, shared memory) follows one
// rule, make_plan below, stated again in probes/matmul_rate.py chain_plan;
// the launch reports the plan it used and the wrapper compares the two.
// The clock64 reading of a link (chain_phases) runs a second instantiation
// of the kernel, so the kernel that is timed from outside carries none of it.
// A side warpgroup (the template's Side; none in P2) runs in every block of
// the same grid on work of its own and waits on none of the chain's
// barriers.

#pragma once

#include <map>

#include "hopper_ptx.cuh"

namespace chain {
namespace {  // one copy in each library that includes this

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                 // rows of a chain (wgmma M)
constexpr int kConsumers = 128;           // one consumer warpgroup
constexpr int kProducer = 32;             // and one producer warp
constexpr int kMaxSmem = 232448;
constexpr int kMaxCluster = 16;           // blocks of a cluster, at most
constexpr int kMaxStages = 32;            // ring stages, at most
constexpr int kMinStages = 3;             // and at least, unless capped lower
constexpr int kBarBytes = 1024;           // room for the mbarriers
constexpr int kPlanInts = 8;

// The launch plan. probes/matmul_rate.py chain_plan states the same rule.
struct Plan {
  int row_groups;  // ceil(M / 64)
  int chains;      // chains (row groups) of a cluster: 1 block, 2 warp
  int cs;          // blocks of a chain = column slices of N
  int ns;          // columns of a slice, N / cs
  int stages;      // ring stages
  int resident;    // 1: the ring holds the block's whole slice of w
  int smem;        // dynamic shared memory of a block, bytes
  int blocks;      // grid
};

// Shared memory of a block for slice width ns; fills stages and resident.
// x, the ring (stages of ns rows x 128 bytes of K: all the room there is,
// up to max_stages stages or the whole slice of w) and the barriers, plus
// 1024 bytes to align the base for the swizzle.
bool size_block(int N, int eb, int ns, int max_stages, Plan* p) {
  const int x = kRows * N * eb;
  const int stage = ns * 128, per_link = N * eb / 128;
  const int room = kMaxSmem - 1024 - kBarBytes - x;
  const int least = max_stages < kMinStages ? max_stages : kMinStages;
  if (room < least * stage) return false;
  p->resident = per_link <= max_stages && per_link * stage <= room;
  const int fit = p->resident ? per_link : room / stage;
  p->stages = fit < max_stages ? fit : max_stages;
  p->smem = 1024 + x + p->stages * stage + kBarBytes;
  return true;
}

template <typename T> struct Elem;
template <> struct Elem<bf16> {
  using Acc = float;
};
template <> struct Elem<int8_t> {
  using Acc = int;
};

struct ChainArgs {
  CUtensorMap map_a;   // a [M, N], boxes of 64 rows x 128 bytes
  CUtensorMap map_w;   // w^T [N, N], boxes of NS rows x 128 bytes
  void* out;           // [M, N]
  long long* phases;   // cycles of block 0 per part of a link, or null
  const float* y_in;   // the side warpgroup's [M, N] (null without one)
  float* y_out;
  int M, N, steps, chains, cs, stages, resident;
  int y_steps;         // the side warpgroup's links
};

// The side warpgroup of a kernel without one.
struct NoSide {
  static constexpr int kThreads = 0;
  template <int NS>
  __device__ static void run(const ChainArgs&, int, int, int) {}
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// requant of two neighbouring accumulators, stored at `dst`.
__device__ __forceinline__ void store_pair(uint8_t* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) =
      __floats2bfloat162_rn(a * 0.03125f, b * 0.03125f);
}
__device__ __forceinline__ void store_pair(uint8_t* dst, int a, int b) {
  const int lo = max(-127, min(127, a >> 9));
  const int hi = max(-127, min(127, b >> 9));
  *reinterpret_cast<uint16_t*>(dst) =
      uint16_t((lo & 0xff) | ((hi & 0xff) << 8));
}

// One block of a chain: rank s of `cs` in its half of the cluster, NS
// columns. See the note at the top of the file. Timed: thread 0 of block 0
// reads clock64 around the parts of a link and reports through p.phases;
// without it every `if (timed)` below is compiled away. Side: a warpgroup
// of work of its own after the producer warp (Side::kThreads threads, 0 for
// none), given its block's rows and columns; it takes part in the cluster
// barriers that open and close the kernel and in nothing else.
template <typename T, int NS, bool Timed, class Side>
__global__ void __launch_bounds__(kConsumers + kProducer + Side::kThreads, 1)
    chain_kernel(const __grid_constant__ ChainArgs p) {
  using Acc = typename Elem<T>::Acc;
  constexpr int eb = sizeof(T);
  constexpr int kStage = NS * 128;           // bytes of a ring stage
  constexpr int kSlice = kRows * NS * eb;    // bytes of a slice of x
  constexpr int kSliceBlocks = NS * eb / 128;  // K-blocks of a slice
  extern __shared__ unsigned char smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int per_link = p.N * eb / 128;       // K-blocks of x = ring
                                             // positions of a link
  const uint32_t xbytes = kRows * p.N * eb;
  const int rank = int(cluster_rank());
  const int half = rank / p.cs, s = rank % p.cs;
  uint8_t* X = base;
  uint8_t* S = X + s * kSlice;  // this block's own columns of x
  const uint32_t x_u32 = smem_u32(X), s_u32 = smem_u32(S);
  const uint32_t ring = x_u32 + xbytes;
  const uint32_t full = ring + p.stages * kStage;
  const uint32_t empty = full + p.stages * 8;
  const uint32_t xin = empty + p.stages * 8;  // one per slice of x
  const uint32_t xfree = xin + p.cs * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cluster = blockIdx.x / (p.chains * p.cs);
  const int row0 = (cluster * p.chains + half) * kRows;
  const bool timed =
      Timed && p.phases != nullptr && blockIdx.x == 0 && tid == 0;
  long long t_ring = 0, t_x = 0, t_mma = 0, t_prod = 0, t_free = 0, t_hand = 0;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i * 8, 1);
      mbar_init(empty + i * 8, 4 * p.chains);  // the consumer warps of each
    }                                          // block that shares the stage
    for (int i = 0; i < p.cs; ++i) mbar_init(xin + i * 8, 1);
    mbar_init(xfree, p.cs);
    fence_mbarrier_init();
    // x of link 0: the rows of a (zero past M), slice by slice
    for (int sl = 0; sl < p.cs; ++sl) {
      mbar_expect_tx(xin + sl * 8, kSlice);
      for (int b = 0; b < kSliceBlocks; ++b) {
        const int kb = sl * kSliceBlocks + b;
        tma_load(x_u32 + kb * (kRows * 128), &p.map_a, xin + sl * 8,
                 kb * (128 / eb), row0);
      }
    }
  }
  // no block touches a peer's barriers before they exist
  cluster_arrive();
  cluster_wait();

  if (warp > kConsumers / 32) {
    Side::template run<NS>(p, row0, s * NS, tid - kConsumers - kProducer);
  } else if (warp == kConsumers / 32) {
    // --- producer: the block's slice of w^T, in the consumers' order ---
    if (lane == 0) {
      const bool leader = half == 0;  // loads for every block of its columns
      const uint16_t mask = uint16_t(1u << s | 1u << (p.cs + s));
      const int total = p.resident ? (p.steps > 0 ? per_link : 0)
                                   : p.steps * per_link;
      // stage and its use; the slice (its own first, then the others in the
      // order their copies arrive: each block sends to s + 1 first) and the
      // K-block in it
      int st = 0, use = 0, sl = s, b = 0;
      for (int pos = 0; pos < total; ++pos) {
        const int kb = sl * kSliceBlocks + b;
        const uint32_t bar = full + st * 8;
        if (leader) {
          if (use > 0) mbar_wait(empty + st * 8, (use & 1) ^ 1);
          mbar_expect_tx(bar, kStage);
          const uint32_t dst = ring + st * kStage;
          if (p.chains == 2)
            tma_load_multicast(dst, &p.map_w, bar, kb * (128 / eb), s * NS,
                               mask);
          else
            tma_load(dst, &p.map_w, bar, kb * (128 / eb), s * NS);
        } else {
          // the leader's load lands here too; this block only arms its own
          // barrier, once the stage's last use has completed
          if (use > 0) mbar_wait(bar, (use - 1) & 1);
          mbar_expect_tx(bar, kStage);
        }
        if (++st == p.stages) st = 0, ++use;
        if (++b == kSliceBlocks) {
          b = 0;
          sl = sl == 0 ? p.cs - 1 : sl - 1;
        }
      }
    }
  } else {
    // --- consumers: one warpgroup, all NS columns ---
    const int q = lane & 3;
    const int r0 = warp * 16 + (lane >> 2);
    const uint32_t leader_empty = map_to_rank(empty, s);
    // hands stage st back to the block that loads it
    auto release = [&](int st) {
      if (p.resident || lane != 0) return;
      if (p.chains == 1)
        mbar_arrive(empty + st * 8);
      else
        mbar_arrive_cluster(leader_empty + st * 8);
    };
    Acc acc[NS / 2];
    int st = 0, par = 0;  // the ring stage of the next position, its parity
    bool ready = false;   // that stage is known to be full
    for (int link = 0; link < p.steps; ++link) {
      long long t0 = timed ? clock64() : 0;
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) acc[i] = 0;
      int before = -1;  // the stage of the products still in flight
      int sl = s;       // the slice being walked: its own first, then the
                        // others in the order their copies arrive
      for (int i = 0; i < p.cs; ++i, sl = sl == 0 ? p.cs - 1 : sl - 1) {
        long long tw = timed ? clock64() : 0;
        mbar_wait(xin + sl * 8, link & 1);
        if (timed) t_x += clock64() - tw;
        for (int b = 0; b < kSliceBlocks; ++b) {
          const int kbyte = (sl * kSliceBlocks + b) * 128;
          if (!ready) {
            if (timed) tw = clock64();
            mbar_wait(full + st * 8, par);
            if (timed) t_ring += clock64() - tw;
          }
          const uint32_t w = ring + st * kStage;
          const int here = st;
          if (++st == p.stages) {
            st = 0;
            par ^= !p.resident;  // a resident stage stays in its first use
          }
          wgmma_fence();
          fence_regs(acc, NS / 2);
#pragma unroll
          for (int t = 0; t < 4; ++t)  // 128 bytes of K, 32 a product
            wgmma_kmajor<NS>(acc, kmajor_desc(x_u32, kbyte + t * 32, kRows),
                             kmajor_desc(w, t * 32, NS));
          wgmma_commit();
          // a look at the next stage while these products run: a resident
          // stage is there after the first link
          ready = (p.resident && link > 0) || mbar_test(full + st * 8, par);
          if (before >= 0) {  // the stage before this one: hand it back
            if (timed) tw = clock64();
            wgmma_wait<1>();
            if (timed) t_mma += clock64() - tw;
            release(before);
          }
          before = here;
        }
      }
      {
        const long long tw = timed ? clock64() : 0;
        wgmma_wait<0>();
        if (timed) t_mma += clock64() - tw;
      }
      fence_regs(acc, NS / 2);
      release(before);
      consumer_sync();  // every warp has read x for the last time
      if (timed) { const long long t = clock64(); t_prod += t - t0; t0 = t; }
      if (tid == 0)
        mbar_arrive(xfree);
      else if (tid < p.cs)  // one lane a peer
        mbar_arrive_cluster(
            map_to_rank(xfree, half * p.cs + (s + tid) % p.cs));
      // every block of the chain is done with x, and with it the copies of
      // the link before have left this block's slice
      mbar_wait(xfree, link & 1);
      if (timed) { const long long t = clock64(); t_free += t - t0; t0 = t; }
#pragma unroll
      for (int i = 0; i < NS / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(S + kmajor_offset(r0 + 8 * h, (8 * i + 2 * q) * eb,
                                       kRows),
                     acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      fence_proxy_async();
      consumer_sync();
      if (tid < p.cs) {  // one lane a slice and a peer
        // the next x: this block's slice is there, the others arrive as
        // bytes on their barriers
        if (tid == s)
          mbar_arrive(xin + tid * 8);
        else
          mbar_expect_tx(xin + tid * 8, kSlice);
        if (tid > 0) {
          const uint32_t to = half * p.cs + (s + tid) % p.cs;
          dsmem_copy(map_to_rank(s_u32, to), s_u32, kSlice,
                     map_to_rank(xin + s * 8, to));
        }
      }
      if (timed) t_hand += clock64() - t0;
    }
    // x after the last link: this block writes its own columns
    const long long t0 = timed ? clock64() : 0;
    for (int sl = 0; sl < p.cs; ++sl) mbar_wait(xin + sl * 8, p.steps & 1);
    if (timed) t_x += clock64() - t0;
    constexpr int kChunks = NS * eb / 16;  // 16-byte chunks of a slice row
    uint8_t* out = static_cast<uint8_t*>(p.out);
    for (int v = tid; v < kRows * kChunks; v += kConsumers) {
      const int r = v / kChunks, kbyte = s * NS * eb + (v % kChunks) * 16;
      if (row0 + r < p.M)
        *reinterpret_cast<uint4*>(out + (size_t(row0 + r) * p.N) * eb +
                                  kbyte) =
            *reinterpret_cast<const uint4*>(X + kmajor_offset(r, kbyte, kRows));
    }
    if (timed) {
      p.phases[0] = t_prod;  // a link's products, the two waits included
      p.phases[1] = t_ring;  // of which waiting for stages of w
      p.phases[2] = t_x;     // and for slices of x still on their way
      p.phases[3] = t_free;  // waiting for the chain's blocks to finish x
      p.phases[4] = t_hand;  // requant into x, issuing the copies
      p.phases[5] = t_mma;   // and for products to finish (wait_group)
      p.phases[6] = p.steps;
    }
  }
  // nobody leaves while a peer may still copy from it or arrive on it
  __syncwarp();
  cluster_arrive();
  cluster_wait();
}

void configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int threads,
               int cluster, int smem, int blocks, cudaStream_t stream) {
  *cfg = {};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

cudaError_t allow(const void* kernel, int cluster, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Clusters of `cluster` blocks with `smem` bytes each that the card holds
// at once (cudaOccupancyMaxActiveClusters; 0 where it refuses the shape),
// asked once per shape, of the kernel without the clock readings.
template <typename T, int NS, class Side>
int active_clusters(int cluster, int smem) {
  static std::map<long long, int> asked;
  const long long key = (long long)cluster << 32 | smem;
  auto it = asked.find(key);
  if (it == asked.end()) {
    int n = 0;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    const void* kernel =
        reinterpret_cast<const void*>(chain_kernel<T, NS, false, Side>);
    configure(&cfg, &attr, kConsumers + kProducer + Side::kThreads, cluster,
              smem, cluster, nullptr);
    if (allow(kernel, cluster, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      n = 0;
    }
    it = asked.emplace(key, n).first;
  }
  return it->second;
}

// Calls f.template operator()<T, NS>() for the kernel built for element
// type T and slice width ns (64 bf16 columns, or 128 or 256 of either
// type: whole 128-byte K-blocks); false where there is none. Only T's
// kernels are instantiated.
template <typename T, class F>
bool with_kernel(int ns, F&& f) {
  if constexpr (sizeof(T) == 2) {
    if (ns == 64) return f.template operator()<T, 64>(), true;
  }
  if (ns == 128) return f.template operator()<T, 128>(), true;
  if (ns == 256) return f.template operator()<T, 256>(), true;
  return false;
}

template <class Side>
struct AskActive {
  int cluster, smem, n;
  template <typename T, int NS> void operator()() {
    n = active_clusters<T, NS, Side>(cluster, smem);
  }
};

template <typename T, class Side>
int active_for(int ns, int cluster, int smem) {
  AskActive<Side> ask{cluster, smem, 0};
  return with_kernel<T>(ns, ask) ? ask.n : 0;
}

// The rule: of the cluster shapes the kernel is built for (slices of 64,
// 128 or 256 columns, whole 128-byte K-blocks, at most max_cluster blocks)
// the widest whose clusters the card holds all at once; if none does (many
// row groups), the narrowest, which does the most products per hand-over.
template <typename T, class Side>
bool make_plan(int warp, int M, int N, int max_cluster, int max_stages,
               Plan* out) {
  constexpr int eb = sizeof(T);
  Plan best{};
  bool found = false;
  const int chains = warp ? 2 : 1;
  const int row_groups = (M + kRows - 1) / kRows;
  const int clusters = (row_groups + chains - 1) / chains;
  for (int cs = 1; cs <= kMaxCluster; cs *= 2) {
    const int cluster = chains * cs;
    if (N % cs != 0 || cluster > max_cluster || cluster > kMaxCluster)
      continue;
    const int ns = N / cs;
    if ((ns != 64 && ns != 128 && ns != 256) || (ns * eb) % 128 != 0) continue;
    Plan p{row_groups, chains, cs, ns, 0, 0, 0, clusters * cluster};
    if (!size_block(N, eb, ns, max_stages, &p)) continue;
    if (found && clusters > active_for<T, Side>(ns, cluster, p.smem)) break;
    best = p;
    found = true;
  }
  *out = best;
  return found;
}

template <class Side>
struct Launch {
  const ChainArgs* args;
  const Plan* plan;
  cudaStream_t stream;
  int rc;
  template <typename T, int NS> void operator()() {
    if (args->phases != nullptr)
      go(chain_kernel<T, NS, true, Side>);
    else
      go(chain_kernel<T, NS, false, Side>);
  }
  void go(void (*kernel)(const ChainArgs)) {
    const int cluster = plan->chains * plan->cs;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    configure(&cfg, &attr, kConsumers + kProducer + Side::kThreads, cluster,
              plan->smem, plan->blocks, stream);
    const cudaError_t err = allow(reinterpret_cast<const void*>(kernel),
                                  cluster, plan->smem);
    rc = err != cudaSuccess ? int(err)
                            : int(cudaLaunchKernelEx(&cfg, kernel, *args));
  }
};

// Plans, transposes w into wT and launches; `args` brings what the plan does
// not decide (the side warpgroup's arrays and links, the clock readings).
template <typename T, class Side>
int launch(int warp, const void* a, const void* w, void* out, void* wT, int M,
           int N, int steps, int max_cluster, int max_stages, int* plan_out,
           ChainArgs args, cudaStream_t stream) {
  constexpr int eb = sizeof(T);
  Plan plan;
  if (!make_plan<T, Side>(warp, M, N, max_cluster, max_stages, &plan))
    return int(cudaErrorInvalidValue);
  const int report[kPlanInts] = {plan.row_groups, plan.chains, plan.cs,
                                 plan.ns, plan.stages, plan.resident,
                                 plan.smem, plan.blocks};
  for (int i = 0; i < kPlanInts; ++i) plan_out[i] = report[i];
  int rc = encode_kmajor(&args.map_a, a, M, N, eb, kRows);
  if (rc == 0) rc = encode_kmajor(&args.map_w, wT, N, N, eb, plan.ns);
  if (rc != 0) return rc;
  args.out = out;
  args.M = M;
  args.N = N;
  args.steps = steps;
  args.chains = plan.chains;
  args.cs = plan.cs;
  args.stages = plan.stages;
  args.resident = plan.resident;
  plan_out[kPlanInts] =
      active_for<T, Side>(plan.ns, plan.chains * plan.cs, plan.smem);
  if (plan_out[kPlanInts] < 1) return int(cudaErrorInvalidConfiguration);
  transpose_kernel<T><<<dim3(N / 32, N / 32), 256, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(wT), N, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  Launch<Side> go{&args, &plan, stream, 0};
  with_kernel<T>(plan.ns, go);
  return go.rc;
}

}  // namespace
}  // namespace chain
