// Chained tensor-core products, bf16 and int8, for Hopper (sm_90a).
//
// Replaces benchmarks/probe_matmul_rate.py:45 pallas_chain and :71
// pallas_chain_ilp (the Pallas TPU probe of the matrix unit's rate). Both
// compute the serial chain x <- requant(x @ w), `steps` times, with x
// [M, N] and w [N, N]: int8 products into int32 and requant
// clip(o >> 9, +-127), or bf16 products into float32 and requant bf16(o/32).
// Every link needs the whole previous x, so no loop transform can drop one.
//
// What bounds it: tensor-core operations, 2*M*N*N per link (275 G ops for
// 256 links at M = 512, N = 1024: 278 us at the 989 TFLOP/s bf16 peak, 139 us
// at the 1,979 TOP/s int8 peak), against w (2 MB bf16, 1 MB int8), which
// stays in the 50 MB L2. At M = 512 the chain is narrow: 16 blocks of 32 rows
// for 132 SMs, so the TPU probe's shape cannot fill this card; the probe's
// main() also times a card-filling M.
//
// Two schedules of one function, as the TPU probe has two:
//   * block chains (pallas_chain): a block owns 32 rows and carries their
//     chain in shared memory (two buffers, x and the next x) for all links;
//     its 8 warps split the columns, w streams from L2 in 64-row slices
//     through shared memory, the requant happens in the epilogue, and block
//     barriers separate the slices and the links;
//   * warp chains (pallas_chain_ilp): each warp owns 32 rows and runs its
//     own chain, with no barrier but __syncwarp; fragments of x and w come
//     straight from device memory (L1/L2), x ping-pongs between the output
//     and a scratch array, and a small per-warp tile holds the requant.
// Products use WMMA m16n16k16 (bf16 -> f32, int8 -> int32).

#include "probe_mma.cuh"

namespace {

using namespace probe;

constexpr int kBlockRows = 32;      // rows of one block chain
constexpr int kWarpRows = 32;       // rows of one warp chain
constexpr int kWarpCols = 64;       // output columns a warp computes at once
constexpr int kWarpsPerBlock = 4;   // warp chains in a block
constexpr int kLdst = kWarpCols + 4;

template <typename T>
size_t block_smem(int N) {
  const size_t ldx = size_t(N) + Mma<T>::kPad;
  return 2 * align128(kBlockRows * ldx * sizeof(T)) + staged_bytes<T>() +
         tile_bytes(kBlockRows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chain_block_kernel(const T* a, const T* w, T* out, int N, int steps) {
  using Acc = typename Mma<T>::Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = N + Mma<T>::kPad;
  const size_t xb = align128(size_t(kBlockRows) * ldx * sizeof(T));
  T* X = reinterpret_cast<T*>(smem);
  T* Xn = reinterpret_cast<T*>(smem + xb);
  T* Ws = reinterpret_cast<T*>(smem + 2 * xb);
  Acc* C = reinterpret_cast<Acc*>(smem + 2 * xb + staged_bytes<T>());
  const size_t row0 = size_t(blockIdx.x) * kBlockRows;

  load_rows(X, ldx, a + row0 * N, kBlockRows, N);
  for (int s = 0; s < steps; ++s) {
    chain_link<T, kBlockRows>(X, Xn, ldx, w, N, C, Ws);
    T* t = X;
    X = Xn;
    Xn = t;
  }
  __syncthreads();
  store_rows(out + row0 * N, X, ldx, kBlockRows, N);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    chain_warp_kernel(const T* a, const T* w, T* out, T* scratch, int N,
                      int steps) {
  using namespace nvcuda;
  using Acc = typename Mma<T>::Acc;
  __shared__ __align__(128) Acc stage[kWarpsPerBlock][kWarpRows * kLdst];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row0 =
      (size_t(blockIdx.x) * kWarpsPerBlock + warp) * kWarpRows;
  Acc* st = stage[warp];
  T* bufs[2] = {out + row0 * N, scratch + row0 * N};
  const T* src = a + row0 * N;

  for (int s = 0; s < steps; ++s) {
    T* dst = bufs[s & 1];
    for (int col0 = 0; col0 < N; col0 += kWarpCols) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], Acc(0));
      for (int k = 0; k < N; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bfr;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], src + size_t(i * 16) * N + k, N);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::load_matrix_sync(bfr, w + size_t(k) * N + col0 + j * 16, N);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::store_matrix_sync(st + i * 16 * kLdst + j * 16, acc[i][j],
                                  kLdst, wmma::mem_row_major);
      __syncwarp();
      for (int v = lane; v < kWarpRows * kWarpCols; v += 32) {
        const int r = v / kWarpCols;
        const int c = v - r * kWarpCols;
        dst[size_t(r) * N + col0 + c] = requant(st[r * kLdst + c]);
      }
      __syncwarp();  // dst is complete and visible to the warp; st is free
    }
    src = dst;
  }
  if (src != bufs[0]) {  // the last link (or none) left x elsewhere
    for (int v = lane; v < kWarpRows * N; v += 32) bufs[0][v] = src[v];
  }
}

template <typename T>
int launch(int warp_chains, const void* a, const void* w, void* out,
           void* scratch, int M, int N, int steps, cudaStream_t stream) {
  const T* a_ = static_cast<const T*>(a);
  const T* w_ = static_cast<const T*>(w);
  T* out_ = static_cast<T*>(out);
  if (warp_chains) {
    const int rows = kWarpsPerBlock * kWarpRows;
    if (M % rows != 0 || scratch == nullptr) return int(cudaErrorInvalidValue);
    chain_warp_kernel<T><<<M / rows, kWarpsPerBlock * 32, 0, stream>>>(
        a_, w_, out_, static_cast<T*>(scratch), N, steps);
  } else {
    if (M % kBlockRows != 0) return int(cudaErrorInvalidValue);
    const size_t smem = block_smem<T>(N);
    if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        chain_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
    chain_block_kernel<T><<<M / kBlockRows, kThreads, smem, stream>>>(
        a_, w_, out_, N, steps);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// a, out (and scratch, for warp chains) are [M, N], w [N, N], all int8 or
// all bf16, row-major. Shapes the kernel does not take (N not a multiple of
// 256, M not a multiple of 32 rows for block chains or 128 for warp chains)
// return cudaErrorInvalidValue.
int probe_chain(int int8, int warp_chains, const void* a, const void* w,
                void* out, void* scratch, int M, int N, int steps,
                void* stream) {
  if (M < 1 || N < kPass || N % kPass != 0 || steps < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? launch<int8_t>(warp_chains, a, w, out, scratch, M, N, steps, s)
              : launch<bf16>(warp_chains, a, w, out, scratch, M, N, steps, s);
}

const char* probe_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
