// Fused bias add and SiLU in bfloat16, rounded as the JAX package rounds
// it, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package computes a Dense's bias add and
// the SiLU after it as separate ops (flax nn.Dense, then nn.silu =
// x * sigmoid(x), jax.nn.sigmoid = 1 / (1 + exp(-x))), each rounded to the
// compute dtype, and XLA fuses them into one pass. The port's op-by-op
// statement of the same rounding (ops/activations.py bias_silu_reference) is
// five elementwise launches and a bias add where torch's F.linear + F.silu,
// which round once, were one; this kernel takes them back to one launch on
// the node side's no-grad path (nn/egnn.py, parallel/ring.py). For each
// element, with r the round-to-nearest-even to bfloat16 and every op in
// float32 as torch's bf16 elementwise kernels compute it:
//
//   t = r(v + b)   e = r(exp(-t))   d = r(1 + e)   s = r(1 / d)   y = r(t * s)
//
// so the output is bit for bit the statement's. expf and the division are
// the accurate ones (no fast math), as in torch's kernels; the rounding is
// cvt.rn.bf16.f32 (__float2bfloat16), as c10::BFloat16 rounds on sm_80+.
//
// What bounds it: bytes. v [rows, F] is read once and y written once (4
// bytes an element), b once; ~10 flops and one MUFU exp an element are far
// below the card's rate. One thread takes 8 consecutive elements of a row
// with 16-byte loads and stores where F is a multiple of 8 and the pointers
// are 16-byte aligned (every node-side width of the port's models), else
// one element, so a warp reads 512 (or 64) contiguous bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ __nv_bfloat16 bias_silu1(__nv_bfloat16 v,
                                                    __nv_bfloat16 b) {
  const float t = round_bf16(__bfloat162float(v) + __bfloat162float(b));
  const float e = round_bf16(expf(-t));
  const float d = round_bf16(1.0f + e);
  const float s = round_bf16(1.0f / d);
  return __float2bfloat16(t * s);
}

// Eight elements a thread: n8 = rows * F / 8 chunks, F a multiple of 8.
__global__ void bias_silu_vec8(const uint4* __restrict__ v,
                               const uint4* __restrict__ b,
                               uint4* __restrict__ y, int n8, int f8) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n8) return;
  const uint4 vv = v[i];
  const uint4 bb = b[i % f8];
  const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
  const __nv_bfloat16* be = reinterpret_cast<const __nv_bfloat16*>(&bb);
  uint4 out;
  __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int k = 0; k < 8; ++k) oe[k] = bias_silu1(ve[k], be[k]);
  y[i] = out;
}

// One element a thread, any F.
__global__ void bias_silu_scalar(const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ b,
                                 __nv_bfloat16* __restrict__ y, int n,
                                 int f) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  y[i] = bias_silu1(v[i], b[i % f]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// y[r, c] = silu(v[r, c] + b[c]) in bf16, rounded op by op (above), on
// `stream`. rows * f < 2^31. Returns the launch's cudaError_t.
int bias_silu_forward(const void* v, const void* b, void* y, int rows, int f,
                      cudaStream_t stream) {
  const int n = rows * f;
  if (n <= 0) return cudaSuccess;
  if (f % 8 == 0 && aligned16(v) && aligned16(b) && aligned16(y)) {
    const int n8 = n / 8;
    bias_silu_vec8<<<(n8 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const uint4*>(v), static_cast<const uint4*>(b),
        static_cast<uint4*>(y), n8, f / 8);
  } else {
    bias_silu_scalar<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(y), n, f);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bias_silu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
