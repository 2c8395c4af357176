// bf16(silu(a @ w)) with and without an overlapped epilogue, for Hopper
// (sm_90a).
//
// Replaces benchmarks/probe_pipeline.py:40 make_seq and :66 make_pipelined
// (the Pallas TPU probe of software pipelining at the flagship EGCL's
// second-layer shape, a [36864, 1024] @ w [1024, 1024], bf16 in, float32
// accumulation, SiLU, bf16 out).
//
// What bounds it: tensor-core operations, 2*R*K*N = 77.3 GFLOP at the probe's
// shape (78 us at the 989 TFLOP/s bf16 peak), against 153 MB of a, w and
// out (46 us at 3.35 TB/s). One PyTorch call, F.silu(a @ w), is a GEMM and
// then a second pass over the 75 MB product; the fused epilogue saves that
// pass, so the kernel has to run its products near the tensor cores' rate.
//
// What the design does about it. A persistent grid, one block an SM, walks
// the output tiles (tile t, t + grid, ...; neighbouring blocks share rows of
// a in L2, and all of w stays there). A producer warp keeps a ring of
// stages full by TMA (one 64-wide K-block of the a rows and of the w
// columns a stage, 128-byte swizzle), running ahead across tiles; two
// consumer warpgroups multiply with wgmma (bf16 -> f32) straight from the
// ring, one stage's products in flight while they wait for the next, and
// hand each stage back as soon as its products are done. The epilogue is
// SiLU on the accumulator registers (silu(v) = h + h tanh(h), h = v / 2:
// one MUFU.TANH a value), bf16, written 64 x 64 at a time into a swizzled
// staging tile of the warpgroup and stored by TMA, so the stores cost the
// load-store unit nothing and write whole lines. The wgmma descriptors here
// are K-major (hopper_ptx.cuh), so w is transposed once per call
// (transpose_kernel, 2 MB, inside the call).
// Two schedules of one kernel, as the TPU probe has two:
//   seq        (the "cooperative" shape) both consumer warpgroups share a
//              128 x 256 tile, 64 rows each, and run its epilogue after its
//              products; the producer loads the next tile's stages
//              meanwhile, but the tensor cores wait for the epilogue.
//   pipelined  (the "ping-pong" shape) the warpgroups take alternate tiles
//              of 128 x 128 (two m64n128 products a step each), so one
//              warpgroup's SiLU and stores run while the other's products
//              do. Their mainloops take turns (an mbarrier a warpgroup,
//              `turn`): a warpgroup starts a tile's products only when the
//              other has finished the tile before. That keeps every wait
//              on a ring stage within one phase of the stage's barrier: an
//              mbarrier's parity tells only two phases apart, and a
//              warpgroup that ran a tile ahead would take an earlier load
//              of its stage for its own.
// Both keep 128 accumulators a thread; a stage is 48 KB (seq) or 32 KB
// (pipelined), 4 or 6 of them, 192 KB of ring beside 32 KB of staging.

#include "hopper_ptx.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;          // rows of a tile
constexpr int kBK = 64;           // K of a stage: one 128-byte K-block
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kChunk = 64 * 64 * 2;        // bytes of a 64 x 64 staging tile
constexpr int kStaging = 2 * 2 * kChunk;   // two a warpgroup
constexpr int kAlign = 1024;               // the swizzle's period

template <bool kPingPong>
struct Shape {
  static constexpr int kBN = kPingPong ? 128 : 256;   // columns of a tile
  static constexpr int kStages = kPingPong ? 6 : 4;
  static constexpr int kStageA = kBM * 128;           // bytes
  static constexpr int kStageB = kBN * 128;
  static constexpr int kStage = kStageA + kStageB;
  static constexpr int kUsers = kPingPong ? 1 : 2;    // warpgroups a stage
  static constexpr int kSmem =
      kAlign + kStages * kStage + kStaging + kStages * 16 + 16;
  static_assert(kSmem <= 232448, "shared memory");
};

struct Args {
  CUtensorMap map_a;   // a [R, K], boxes of 128 rows x 64
  CUtensorMap map_b;   // w^T [N, K], boxes of kBN rows x 64
  CUtensorMap map_o;   // out [R, N], boxes of 64 rows x 64
  int R, K, N;
};

__device__ __forceinline__ float silu(float v) {
  const float h = 0.5f * v;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}

template <bool kPingPong>
__global__ void __launch_bounds__(kThreads, 1)
    pipeline_kernel(const __grid_constant__ Args p) {
  using S = Shape<kPingPong>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + kAlign - 1) & ~uint32_t(kAlign - 1);
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t ring = base;
  const uint32_t staging = ring + S::kStages * S::kStage;
  const uint32_t full = staging + kStaging;
  const uint32_t empty = full + S::kStages * 8;
  const uint32_t turn = empty + S::kStages * 8;  // pipelined: one a warpgroup
  const int tid = threadIdx.x, warp = tid >> 5;
  const int tiles_n = (p.N + S::kBN - 1) / S::kBN;
  const int tiles = (p.R / kBM) * tiles_n;
  const int kblocks = p.K / kBK;

  if (tid == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(full + i * 8, 1);
      mbar_init(empty + i * 8, 4 * S::kUsers);  // each consumer warp
    }
    // a warpgroup's turn comes when each warp of the other has finished
    // the products of the tile before
    for (int g = 0; g < 2; ++g) mbar_init(turn + g * 8, 4);
    fence_mbarrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // --- producer: every tile's stages, in tile order ---
    if ((tid & 31) == 0) {
      int st = 0, round = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row = (t / tiles_n) * kBM, col = (t % tiles_n) * S::kBN;
        for (int kb = 0; kb < kblocks; ++kb) {
          const uint32_t bar = full + st * 8, dst = ring + st * S::kStage;
          if (round > 0) mbar_wait(empty + st * 8, (round - 1) & 1);
          mbar_expect_tx(bar, S::kStage);
          tma_load(dst, &p.map_a, bar, kb * kBK, row);
          tma_load(dst + S::kStageA, &p.map_b, bar, kb * kBK, col);
          if (++st == S::kStages) st = 0, ++round;
        }
      }
    }
    return;
  }

  // --- consumers ---
  const int wg = warp >> 2, wtid = tid & 127, lane = tid & 31;
  const int q = lane & 3, r0 = (warp & 3) * 16 + (lane >> 2);
  unsigned char* stage_out = base_ptr + (staging - base) + wg * 2 * kChunk;
  const uint32_t stage_out_u32 = staging + wg * 2 * kChunk;
  float acc[128];
  int chunks = 0;  // staging tiles this warpgroup has filled
  // tiles of this warpgroup: all (seq) or every other one (pipelined)
  const int first = kPingPong ? wg : 0, every = kPingPong ? 2 : 1;
  int c = first;
  for (int t = blockIdx.x + first * gridDim.x; t < tiles;
       t += every * gridDim.x, c += every) {
    const int row = (t / tiles_n) * kBM, col = (t % tiles_n) * S::kBN;
    // tile c - 1 (the other warpgroup's) has had its products
    if (kPingPong && c > 0) mbar_wait(turn + wg * 8, ((c - 1) >> 1) & 1);
    // this tile's first ring position
    int st = (c * kblocks) % S::kStages, round = (c * kblocks) / S::kStages;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int before = -1;
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(full + st * 8, round & 1);
      const uint32_t a = ring + st * S::kStage, b = a + S::kStageA;
      wgmma_fence();
      fence_regs(acc, 128);
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // 128 bytes of K, 32 a product
        if constexpr (kPingPong) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            wgmma_kmajor<128>(acc + 64 * mi,
                              sw128_desc(a + mi * 8192 + k * 32, 16, 1024),
                              sw128_desc(b + k * 32, 16, 1024));
        } else {
          wgmma_kmajor<256>(acc, sw128_desc(a + wg * 8192 + k * 32, 16, 1024),
                            sw128_desc(b + k * 32, 16, 1024));
        }
      }
      wgmma_commit();
      if (before >= 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + before * 8);
      }
      before = st;
      if (++st == S::kStages) st = 0, ++round;
    }
    wgmma_wait<0>();
    fence_regs(acc, 128);
    if (lane == 0) {
      mbar_arrive(empty + before * 8);
      if (kPingPong) mbar_arrive(turn + (wg ^ 1) * 8);  // the other's turn
    }

    // --- epilogue: four 64 x 64 chunks, SiLU, bf16, TMA stores ---
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      // seq: rows 64 wg .. of the tile, columns 64 ch ..; pipelined: rows
      // 64 (ch / 2) .., columns 64 (ch % 2) ..
      const int mi = kPingPong ? ch >> 1 : 0;
      const int cb = kPingPong ? ch & 1 : ch;
      const int rows = row + (kPingPong ? 64 * mi : 64 * wg);
      const float* v = acc + 64 * mi + 32 * cb;
      const int buf = chunks & 1;
      if (wtid == 0) bulk_wait_read<1>();  // the store of two chunks ago
      wg_sync(wg);
      unsigned char* dst = stage_out + buf * kChunk;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(
              silu(v[4 * j + 2 * h]), silu(v[4 * j + 2 * h + 1]));
          *reinterpret_cast<__nv_bfloat162*>(
              dst + kmajor_offset(r0 + 8 * h, (8 * j + 2 * q) * 2, 64)) = pair;
        }
      fence_proxy_async();
      wg_sync(wg);
      if (wtid == 0) {
        tma_store(&p.map_o, stage_out_u32 + buf * kChunk, col + 64 * cb,
                  rows);
        bulk_commit();
      }
      ++chunks;
    }
  }
  if (wtid == 0) bulk_wait<0>();
}

int multiprocessors() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

template <bool kPingPong>
int launch(const bf16* a, const bf16* w, bf16* out, bf16* wT, int R, int K,
           int N, cudaStream_t stream) {
  using S = Shape<kPingPong>;
  Args args{};
  int rc = encode_kmajor(&args.map_a, a, R, K, 2, kBM);
  if (rc == 0) rc = encode_kmajor(&args.map_b, wT, N, K, 2, S::kBN);
  if (rc == 0) rc = encode_kmajor(&args.map_o, out, R, N, 2, 64);
  if (rc != 0) return rc;
  args.R = R;
  args.K = K;
  args.N = N;
  const int sms = multiprocessors();
  if (sms == 0) return int(cudaErrorInvalidDevice);
  cudaError_t err = cudaFuncSetAttribute(
      pipeline_kernel<kPingPong>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (err != cudaSuccess) return int(err);
  transpose_kernel<bf16><<<dim3(N / 32, K / 32), 256, 0, stream>>>(w, wT, K,
                                                                   N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int tiles = (R / kBM) * ((N + S::kBN - 1) / S::kBN);
  pipeline_kernel<kPingPong>
      <<<tiles < sms ? tiles : sms, kThreads, S::kSmem, stream>>>(args);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// a [R, K], w [K, N], out [R, N] and the scratch wT [N, K], bf16,
// row-major. R and N must be multiples of 128 and K of 64; else
// cudaErrorInvalidValue.
int probe_pipeline(int pipelined, const void* a, const void* w, void* out,
                   void* wT, int R, int K, int N, void* stream) {
  if (R < kBM || R % kBM != 0 || N < 128 || N % 128 != 0 || K < kBK ||
      K % kBK != 0 || wT == nullptr)
    return int(cudaErrorInvalidValue);
  const bf16* a_ = static_cast<const bf16*>(a);
  const bf16* w_ = static_cast<const bf16*>(w);
  bf16* out_ = static_cast<bf16*>(out);
  bf16* wT_ = static_cast<bf16*>(wT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pipelined ? launch<true>(a_, w_, out_, wT_, R, K, N, s)
                   : launch<false>(a_, w_, out_, wT_, R, K, N, s);
}

const char* probe_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
