// bf16(silu(a @ w)) with and without an overlapped epilogue, for Hopper
// (sm_90a).
//
// Replaces benchmarks/probe_pipeline.py:40 make_seq and :66 make_pipelined
// (the Pallas TPU probe of software pipelining at the flagship EGCL's
// second-layer shape, a [36864, 1024] @ w [1024, 1024], bf16 in, float32
// accumulation, SiLU, bf16 out). Two schedules of one kernel, as the TPU
// probe has two:
//   seq        each persistent block computes an output tile's product,
//              then its SiLU epilogue and store, then the next tile;
//   pipelined  each persistent block splits into 8 product warps and 4
//              epilogue warps (warp specialisation): the product warps
//              write tile c's float32 sums into one of two shared-memory
//              buffers and go on to tile c+1 while the epilogue warps apply
//              SiLU to tile c and store it. Named barriers (bar.sync /
//              bar.arrive) hand each buffer over, full and back empty.
//
// What bounds it: tensor-core operations, 2*R*K*N = 77.3 GFLOP at the probe's
// shape (78 us at the 989 TFLOP/s bf16 peak), against 153 MB of a, w and
// out (46 us at 3.35 TB/s). The tiles are 128 x 128 with k-slices of 64
// staged through shared memory (WMMA m16n16k16 bf16 -> f32, each of 8 warps
// 32 x 64); one persistent block an SM walks the tiles in row-major order,
// so neighbouring blocks share rows of a in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kMmaThreads = 256;  // 8 warps, 4 x 2, each 32 x 64
constexpr int kEpiThreads = 128;  // the epilogue warps of `pipelined`
constexpr int kLda = kBK + 8;     // bf16 row stride of the staged a slice
constexpr int kLdb = kBN + 8;     // bf16 row stride of the staged w slice
constexpr int kLde = kBN + 4;     // float row stride of an epilogue tile
constexpr size_t kStageA = size_t(kBM) * kLda * 2;
constexpr size_t kStageB = size_t(kBK) * kLdb * 2;
constexpr size_t kTileE = size_t(kBM) * kLde * 4;

// Named barriers; 0 is __syncthreads.
constexpr int kMainloopBar = 1;  // among the product warps
constexpr int kFullBar = 2;      // + buffer: sums written
constexpr int kEmptyBar = 4;     // + buffer: sums read

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

struct Problem {
  const bf16* a;  // [R, K]
  const bf16* w;  // [K, N]
  bf16* out;      // [R, N]
  int R, K, N;
};

using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                   float>;

// acc = the product of output tile (tm, tn); product warps only.
__device__ void tile_mainloop(const Problem& p, int tm, int tn, bf16* As,
                              bf16* Bs, Acc (&acc)[2][4]) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const bf16* a = p.a + size_t(tm) * kBM * p.K;
  const bf16* w = p.w + size_t(tn) * kBN;
  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    bar_sync(kMainloopBar, kMmaThreads);  // the previous slices are read
    for (int v = tid; v < kBM * kBK / 8; v += kMmaThreads) {
      const int r = v / (kBK / 8);
      const int c = (v % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * kLda + c) =
          *reinterpret_cast<const uint4*>(a + size_t(r) * p.K + k0 + c);
    }
    for (int v = tid; v < kBK * kBN / 8; v += kMmaThreads) {
      const int r = v / (kBN / 8);
      const int c = (v % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + r * kLdb + c) =
          *reinterpret_cast<const uint4*>(w + size_t(k0 + r) * p.N + c);
    }
    bar_sync(kMainloopBar, kMmaThreads);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * kLda + kk,
                               kLda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(bfr, Bs + kk * kLdb + wn * 64 + j * 16, kLdb);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
  }
}

__device__ void store_acc(float* E, Acc (&acc)[2][4]) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(E + (wm * 32 + i * 16) * kLde + wn * 64 + j * 16,
                              acc[i][j], kLde, wmma::mem_row_major);
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// Two bf16(silu(.)) values packed as one 32-bit word, lower column first.
__device__ __forceinline__ uint32_t pack_silu(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(silu(lo), silu(hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// out tile (tm, tn) = bf16(silu(E)), by `n` threads numbered t, 8 columns
// (one 16-byte store) at a time.
__device__ void epilogue(const Problem& p, const float* E, int tm, int tn,
                         int t, int n) {
  for (int v = t; v < kBM * kBN / 8; v += n) {
    const int r = v / (kBN / 8);
    const int c = (v % (kBN / 8)) * 8;
    const float4 lo = *reinterpret_cast<const float4*>(E + r * kLde + c);
    const float4 hi = *reinterpret_cast<const float4*>(E + r * kLde + c + 4);
    const uint4 q = {pack_silu(lo.x, lo.y), pack_silu(lo.z, lo.w),
                     pack_silu(hi.x, hi.y), pack_silu(hi.z, hi.w)};
    *reinterpret_cast<uint4*>(p.out + size_t(tm * kBM + r) * p.N + tn * kBN +
                              c) = q;
  }
}

template <bool PIPELINED>
__global__ void __launch_bounds__(PIPELINED ? kMmaThreads + kEpiThreads
                                            : kMmaThreads)
    pipeline_kernel(Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + kStageA);
  float* E[2] = {reinterpret_cast<float*>(smem + kStageA + kStageB),
                 reinterpret_cast<float*>(smem + kStageA + kStageB + kTileE)};
  const int tiles_n = p.N / kBN;
  const int tiles = (p.R / kBM) * tiles_n;
  const int tid = threadIdx.x;

  if (!PIPELINED) {
    Acc acc[2][4];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      tile_mainloop(p, t / tiles_n, t % tiles_n, As, Bs, acc);
      store_acc(E[0], acc);  // the mainloop's barriers ordered E's readers
      bar_sync(kMainloopBar, kMmaThreads);
      epilogue(p, E[0], t / tiles_n, t % tiles_n, tid, kMmaThreads);
    }
    return;
  }
  const int mine = (tiles - int(blockIdx.x) + int(gridDim.x) - 1) /
                   int(gridDim.x);
  const int all = kMmaThreads + kEpiThreads;
  if (tid < kMmaThreads) {
    Acc acc[2][4];
    int c = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++c) {
      tile_mainloop(p, t / tiles_n, t % tiles_n, As, Bs, acc);
      const int b = c & 1;
      if (c >= 2) bar_sync(kEmptyBar + b, all);  // tile c-2 has left E[b]
      store_acc(E[b], acc);
      bar_arrive(kFullBar + b, all);
    }
  } else {
    int c = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++c) {
      const int b = c & 1;
      bar_sync(kFullBar + b, all);
      epilogue(p, E[b], t / tiles_n, t % tiles_n, tid - kMmaThreads,
               kEpiThreads);
      if (c + 2 < mine) bar_arrive(kEmptyBar + b, all);
    }
  }
}

template <bool PIPELINED>
int launch(const Problem& p, cudaStream_t stream) {
  const size_t smem = kStageA + kStageB + (PIPELINED ? 2 : 1) * kTileE;
  cudaError_t err = cudaFuncSetAttribute(
      pipeline_kernel<PIPELINED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const int tiles = (p.R / kBM) * (p.N / kBN);
  const int grid = tiles < sms ? tiles : sms;
  pipeline_kernel<PIPELINED>
      <<<grid, PIPELINED ? kMmaThreads + kEpiThreads : kMmaThreads, smem,
         stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// a [R, K], w [K, N], out [R, N], bf16, row-major. R and N must be multiples
// of 128 and K of 64; else cudaErrorInvalidValue.
int probe_pipeline(int pipelined, const void* a, const void* w, void* out,
                   int R, int K, int N, void* stream) {
  if (R < kBM || R % kBM != 0 || N < kBN || N % kBN != 0 || K < kBK ||
      K % kBK != 0)
    return int(cudaErrorInvalidValue);
  Problem p{static_cast<const bf16*>(a), static_cast<const bf16*>(w),
            static_cast<bf16*>(out), R, K, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pipelined ? launch<true>(p, s) : launch<false>(p, s);
}

const char* probe_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
