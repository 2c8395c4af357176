// Tensor-core and CUDA-core work in one loop, for Hopper (sm_90a).
//
// Replaces benchmarks/probe_overlap.py:45 make_call (the Pallas TPU probe
// of whether the vector unit's work hides behind the matrix unit's). Three
// modes of one kernel, as the TPU probe has them:
//   mxu   the int8 chain of probe_matmul_rate.cu, x <- clip((x @ w) >> 9),
//         `steps` links ([M, N] @ [N, N], int32 accumulation);
//   vpu   an independent float32 chain y <- y * sigmoid(y) + 0.3, four
//         times a link, on [M, N];
//   both  the two chains in the same loop body of the same warps, with no
//         data between them.
// On this card "mxu" means the tensor cores and "vpu" the CUDA cores and
// the SFU (expf and the reciprocal of the sigmoid).
//
// What bounds it: mxu is bound by tensor-core operations (2*M*N*N a link);
// vpu by the SFU and FMA pipes (4 sigmoids a link for each of M*N values);
// both are bound by whichever is longer if the SM overlaps them, and by
// their sum if it does not. That is what the probe measures.
//
// What the design does about it. A block owns 16 rows; x and the next x
// are two int8 tiles in shared memory and w streams from L2 in 64-row
// slices, as in the block chains of probe_matmul_rate.cu. y does not fit
// beside them at 32 rows (32 x 1024 x 4 B = 128 KB), so a block holds 16
// rows, and y (64 KB) lies in shared memory. Each thread owns the y values
// of its index modulo 256 and advances 1024 / N of them after the products
// of every staged w slice: in "both" the SFU work of a warp sits between its
// tensor-core instructions, where the warp scheduler can overlap the two.

#include "probe_mma.cuh"

namespace {

using namespace probe;

constexpr int kRows = 16;    // rows of a block
constexpr int kRepeat = 4;   // sigmoid links of y per link of x
enum Mode { kMxu = 0, kVpu = 1, kBoth = 2 };

__device__ __forceinline__ float vpu_link(float y) {
#pragma unroll
  for (int r = 0; r < kRepeat; ++r) y = y * (1.0f / (1.0f + expf(-y))) + 0.3f;
  return y;
}

size_t smem_bytes(int N) {
  const size_t xb = align128(size_t(kRows) * (N + Mma<int8_t>::kPad));
  return 2 * xb + staged_bytes<int8_t>() + tile_bytes(kRows) +
         align128(size_t(kRows) * N * 4);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    overlap_kernel(const int8_t* a, const int8_t* w, const float* y_in,
                   int8_t* x_out, float* y_out, int N, int steps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int ldx = N + Mma<int8_t>::kPad;
  const size_t xb = align128(size_t(kRows) * ldx);
  int8_t* X = reinterpret_cast<int8_t*>(smem);
  int8_t* Xn = reinterpret_cast<int8_t*>(smem + xb);
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + 2 * xb);
  int* C = reinterpret_cast<int*>(smem + 2 * xb + staged_bytes<int8_t>());
  float* Y = reinterpret_cast<float*>(smem + 2 * xb +
                                      staged_bytes<int8_t>() +
                                      tile_bytes(kRows));
  const size_t off = size_t(blockIdx.x) * kRows * N;
  const int count = kRows * N;
  const int slices = (N / kPass) * (N / kKChunk);  // w slices in a link
  const int per = count / (kThreads * slices);     // y values a slice

  load_rows(X, ldx, a + off, kRows, N);
  // thread tid owns Y[v] for v = tid (mod kThreads): no barrier needed
  for (int v = tid; v < count; v += kThreads) Y[v] = y_in[off + v];
  auto vpu_slice = [&](int s) {
    for (int i = 0; i < per; ++i) {
      const int v = (s * per + i) * kThreads + tid;
      Y[v] = vpu_link(Y[v]);
    }
  };

  for (int step = 0; step < steps; ++step) {
    if (MODE == kVpu) {
      for (int s = 0; s < slices; ++s) vpu_slice(s);
    } else {
      if (MODE == kBoth)
        chain_link<int8_t, kRows>(X, Xn, ldx, w, N, C, Ws, vpu_slice);
      else
        chain_link<int8_t, kRows>(X, Xn, ldx, w, N, C, Ws);
      int8_t* t = X;
      X = Xn;
      Xn = t;
    }
  }
  __syncthreads();
  store_rows(x_out + off, X, ldx, kRows, N);
  for (int v = tid; v < count; v += kThreads) y_out[off + v] = Y[v];
}

template <int MODE>
int launch(const void* a, const void* w, const void* y, void* x_out,
           void* y_out, int M, int N, int steps, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      overlap_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  overlap_kernel<MODE><<<M / kRows, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(y), static_cast<int8_t*>(x_out),
      static_cast<float*>(y_out), N, steps);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// mode 0 mxu, 1 vpu, 2 both. a, x_out [M, N] int8, w [N, N] int8, y, y_out
// [M, N] float32, row-major. N must be 256, 512 or 1024 and M a multiple of
// 16; else cudaErrorInvalidValue.
int probe_overlap(int mode, const void* a, const void* w, const void* y,
                  void* x_out, void* y_out, int M, int N, int steps,
                  void* stream) {
  if (M < kRows || M % kRows != 0 || N < kPass || N % kPass != 0 ||
      1024 % N != 0 || steps < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kMxu: return launch<kMxu>(a, w, y, x_out, y_out, M, N, steps, s);
    case kVpu: return launch<kVpu>(a, w, y, x_out, y_out, M, N, steps, s);
    case kBoth: return launch<kBoth>(a, w, y, x_out, y_out, M, N, steps, s);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* probe_overlap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
