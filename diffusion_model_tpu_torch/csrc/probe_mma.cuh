// The block-wide tile product shared by the hardware probes for Hopper
// (sm_90a): probe_matmul_rate.cu (P2), probe_overlap.cu (P4) and
// probe_kernel_stages.cu (P1).
//
// block_product computes C[0:BM, 0:256] = A[0:BM, 0:K] @ W[0:K, col0:+256]
// on the tensor cores with WMMA m16n16k16: bf16 in and float32 out, or int8
// in and int32 out. A lies in shared memory; W is read from device memory
// (it stays in L2) and staged through shared memory 64 rows at a time. The
// 8 warps of the block split the 256 columns (and, at BM = 64, the rows).
// A hook runs after the products of every staged slice, so a caller can put
// independent work between the tensor-core instructions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace probe {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kPass = 256;       // output columns of one block_product
constexpr int kKChunk = 64;      // rows of W staged per slice
constexpr int kLdc = kPass + 4;  // row stride of the product tile C
constexpr size_t kMaxSmem = 232448;

// Accumulator type and row padding (16 bytes) of each input type.
template <typename T> struct Mma;
template <> struct Mma<bf16> {
  using Acc = float;
  static constexpr int kPad = 8;
};
template <> struct Mma<int8_t> {
  using Acc = int;
  static constexpr int kPad = 16;
};

template <typename T>
constexpr int kLdw = kPass + Mma<T>::kPad;  // row stride of the staged W

__host__ __device__ constexpr size_t align128(size_t v) {
  return (v + 127) / 128 * 128;
}

// Shared-memory bytes of the staged W slice and of the product tile.
template <typename T>
__host__ __device__ constexpr size_t staged_bytes() {
  return align128(size_t(kKChunk) * kLdw<T> * sizeof(T));
}
__host__ __device__ constexpr size_t tile_bytes(int bm) {
  return align128(size_t(bm) * kLdc * 4);
}

struct NoHook {
  __device__ void operator()(int) const {}
};

// C[0:BM, 0:kPass] = A[0:BM, 0:K] @ W[0:K, col0:col0+kPass]. A has row
// stride lda (a multiple of 16 bytes), W row stride ldw; K is a multiple of
// kKChunk. after_slice(s) runs after the products of slice s = k0 / kKChunk.
// Starts with a barrier (so C may still be read when it is called) and ends
// with one (so C is complete when it returns). Ws may lie inside C.
template <typename T, int BM, typename Hook = NoHook>
__device__ void block_product(const T* A, int lda, const T* W, int ldw,
                              int col0, int K, typename Mma<T>::Acc* C, T* Ws,
                              Hook after_slice = Hook()) {
  using namespace nvcuda;
  using Acc = typename Mma<T>::Acc;
  constexpr int WR = BM >= 64 ? 2 : 1;  // warps along the rows
  constexpr int WC = 8 / WR;            // warps along the columns
  constexpr int TM = BM / WR, TN = kPass / WC;
  constexpr int FM = TM / 16, FN = TN / 16;
  constexpr int ldw_s = kLdw<T>;
  constexpr int kVec = 16 / int(sizeof(T));  // elements of a 16-byte load
  constexpr int vec_per_row = kPass / kVec;
  static_assert(BM % 16 == 0 && TM % 16 == 0 && TN % 16 == 0, "tile shape");

  const int warp = threadIdx.x >> 5;
  const int wm = warp / WC, wn = warp % WC;
  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[FM][FN];
#pragma unroll
  for (int a = 0; a < FM; ++a)
#pragma unroll
    for (int b = 0; b < FN; ++b) wmma::fill_fragment(acc[a][b], Acc(0));

  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    __syncthreads();  // the previous slice (and C) have been read
    for (int v = threadIdx.x; v < kKChunk * vec_per_row; v += kThreads) {
      const int row = v / vec_per_row;
      const int c = (v - row * vec_per_row) * kVec;
      *reinterpret_cast<uint4*>(Ws + row * ldw_s + c) =
          *reinterpret_cast<const uint4*>(W + size_t(k0 + row) * ldw + col0 +
                                          c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bfr;
#pragma unroll
      for (int a = 0; a < FM; ++a)
        wmma::load_matrix_sync(af[a], A + (wm * TM + a * 16) * lda + k0 + kk,
                               lda);
#pragma unroll
      for (int b = 0; b < FN; ++b) {
        wmma::load_matrix_sync(bfr, Ws + kk * ldw_s + wn * TN + b * 16, ldw_s);
#pragma unroll
        for (int a = 0; a < FM; ++a)
          wmma::mma_sync(acc[a][b], af[a], bfr, acc[a][b]);
      }
    }
    after_slice(k0 / kKChunk);
  }
  __syncthreads();  // the last slice is read: Ws may alias C
#pragma unroll
  for (int a = 0; a < FM; ++a)
#pragma unroll
    for (int b = 0; b < FN; ++b)
      wmma::store_matrix_sync(C + (wm * TM + a * 16) * kLdc + wn * TN + b * 16,
                              acc[a][b], kLdc, wmma::mem_row_major);
  __syncthreads();
}

// The chain's requantisation: int8 clip(o >> 9, +-127) (an arithmetic
// shift), bf16 round-to-nearest of o / 32.
__device__ __forceinline__ int8_t requant(int o) {
  const int v = o >> 9;
  return int8_t(v < -127 ? -127 : (v > 127 ? 127 : v));
}
__device__ __forceinline__ bf16 requant(float o) {
  return __float2bfloat16_rn(o * 0.03125f);
}

// One link of the chain on a block's BM rows: Xn = requant(X @ W), W square
// [N, N]; X and Xn have row stride ldx. after_slice(s) gets the slice's
// number counted over the whole link. Ends without a barrier: the next
// block_product starts with one.
template <typename T, int BM, typename Hook = NoHook>
__device__ void chain_link(const T* X, T* Xn, int ldx, const T* W, int N,
                           typename Mma<T>::Acc* C, T* Ws,
                           Hook after_slice = Hook()) {
  const int slices = N / kKChunk;
  for (int col0 = 0; col0 < N; col0 += kPass) {
    const int base = (col0 / kPass) * slices;
    block_product<T, BM>(X, ldx, W, N, col0, N, C, Ws,
                         [&](int s) { after_slice(base + s); });
    for (int v = threadIdx.x; v < BM * kPass; v += kThreads) {
      const int r = v / kPass;
      const int c = v - r * kPass;
      Xn[r * ldx + col0 + c] = requant(C[r * kLdc + c]);
    }
  }
}

// Copies BM rows of N elements between a row-major [*, N] array in device
// memory and a shared-memory tile of row stride ldx, 16 bytes a thread.
template <typename T>
__device__ void load_rows(T* X, int ldx, const T* src, int rows, int N) {
  const int vec = 16 / int(sizeof(T));
  const int per_row = N / vec;
  for (int v = threadIdx.x; v < rows * per_row; v += blockDim.x) {
    const int r = v / per_row;
    const int c = (v - r * per_row) * vec;
    *reinterpret_cast<uint4*>(X + r * ldx + c) =
        *reinterpret_cast<const uint4*>(src + size_t(r) * N + c);
  }
}
template <typename T>
__device__ void store_rows(T* dst, const T* X, int ldx, int rows, int N) {
  const int vec = 16 / int(sizeof(T));
  const int per_row = N / vec;
  for (int v = threadIdx.x; v < rows * per_row; v += blockDim.x) {
    const int r = v / per_row;
    const int c = (v - r * per_row) * vec;
    *reinterpret_cast<uint4*>(dst + size_t(r) * N + c) =
        *reinterpret_cast<const uint4*>(X + r * ldx + c);
  }
}

}  // namespace probe
