// The int8 EGCL edge tile in stages, for Hopper (sm_90a).
//
// Replaces benchmarks/probe_kernel_stages.py:126 make_call (modes mm,
// mm_post, full_serial), :169 make_call_x and :239 make_call_xblk (the
// Pallas TPU probe that splits the planned int8 EGCL edge kernel's time
// into products, epilogue and pre-activation build). For graph b, target i
// and every source j (E = N x N edge rows):
//   mm           om = qm @ w2m_q, ox = qx @ w2x_q from prebuilt int8 rows
//                (int32 sums); m_sum_i = sum_j bf16(om), x_out_i[0:8] =
//                sum_j bf16(ox[:, 0:8]);
//   mm_post      m = bf16(silu(om / 2048)), gate sigmoid(m . bf16(wa)) * pm,
//                m_sum_i = sum_j bf16(m * gate); u = bf16(silu(ox / 2048)),
//                s = u . bf16(wx3), x_out_i[0:3] = sum_j bf16(diff * s * pm /
//                (norm + 1)) with norm = sqrt(max(d2, 1e-12)) where pm, else 1;
//   full_serial  as mm_post, with qm, qx built in the kernel: q = clip(round(
//                32 silu(bf16(bf16(a_i + a_j) + bf16(bf16(d2) * w_d)))), +-127);
//   x            ox = q @ w (int8 -> int32 or bf16 -> f32) alone, x_out_i =
//                sum_j bf16(ox[:, 0:8]);
//   xblk         s = sum over 256-column blocks of bf16(silu(q @ w / 2048))
//                . bf16(wx3), x_out_i[0:8] = sum_j bf16(s).
// x_i and mask_i are rounded to bf16 as the TPU probe's one-hot repeat
// rounds them; pm = mask_i mask_j (i != j).
//
// What bounds it: tensor-core operations. At N = 192, F1 = 1024, FM = 256 a
// call needs 2 N^2 (F1^2 + F1 FM) = 96.6 G int8 operations (49 us at 1,979
// TOP/s); mm and mm_post also read 75.5 MB of prebuilt int8 rows (23 us at
// 3.35 TB/s), more than the 50 MB L2 holds, as the stage intends.
//
// What the design does about it. The TPU probe's [TI x N] edge block, its
// one-hot row repeat and its selection-matmul group sums are not carried
// over. As in the EGCL pair kernel, a block owns one target i and walks its
// sources j in tiles of 64 edges; the tile of int8 (or bf16) rows sits in
// shared memory, both products run on the tensor cores (WMMA m16n16k16,
// probe_mma.cuh) with w streamed from L2 through shared memory, and the
// sums over j are taken in the block in the order of j, so they need no
// atomics. mm and x feed only 8 of the F1 product columns to x_out, and a
// compiler would drop the rest: every int32 (float32) product is also added
// into a per-target checksum (a wrapping int32 sum, a float32 sum for bf16),
// written to `check`, so every column reaches memory.

#include <type_traits>

#include "probe_mma.cuh"

namespace {

using namespace probe;

constexpr int kM = 64;  // edges (sources j of one target) per tile
enum Mode { kMm = 0, kMmPost = 1, kFullSerial = 2, kX = 3, kXblk = 4 };
constexpr int kMeta = 7 * kM + 8 + 8;  // d2 pm s gate diff[3]; xacc; red

struct Params {
  const bf16 *am_i, *am_j, *ax_i, *ax_j;  // [B, N, F1]
  const float *x, *mask;                  // [B, N, 3], [B, N]
  const void *qm, *qx;                    // [B, N*N, F1] (x, xblk: q in qx)
  const bf16 *w_dm, *w_dx;                // [F1]
  const int8_t* w2m;                      // [F1, FM]
  const void* w2x;                        // [F1, F1]
  const float *wx3, *wa;                  // [F1], [FM]
  float *m_sum, *x_out;                   // [B, N, FM], [B, N, 8]
  void* check;                            // [B, N] int32 or float32
  int N, F1, FM;
};

// Shared memory: the edge tile A, the product tile C (which also stages
// w), the per-target message sums and the per-edge metadata.
template <typename T>
struct Layout {
  size_t a, c, msum, meta, total;
  __host__ __device__ Layout(int F1, int FM) {
    const size_t cb = tile_bytes(kM) > staged_bytes<T>() ? tile_bytes(kM)
                                                         : staged_bytes<T>();
    a = 0;
    c = align128(size_t(kM) * (F1 + Mma<T>::kPad) * sizeof(T));
    msum = c + cb;
    meta = msum + align128(size_t(FM) * 4);
    total = meta + align128(size_t(kMeta) * 4);
  }
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}
__device__ __forceinline__ float silu(float v) { return v * sigmoid(v); }

template <typename S>
__device__ __forceinline__ S warp_sum(S v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows j0 .. j0+live-1 of a prebuilt [*, F1] edge array into A; the other
// rows of the tile are zero.
template <typename T>
__device__ void load_tile(T* A, int lda, const T* src, int live, int F1) {
  constexpr int vec = 16 / int(sizeof(T));
  const int per_row = F1 / vec;
  for (int v = threadIdx.x; v < kM * per_row; v += kThreads) {
    const int r = v / per_row;
    const int c = (v - r * per_row) * vec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < live)
      val = *reinterpret_cast<const uint4*>(src + size_t(r) * F1 + c);
    *reinterpret_cast<uint4*>(A + r * lda + c) = val;
  }
}

// The full_serial build: A[r, k] = clip(round(32 silu(pre)), +-127) with
// pre = bf16(bf16(a_i[k] + a_j[k]) + bf16(bf16(d2_r) * w_d[k])).
__device__ void build_tile(int8_t* A, int lda, const bf16* a_i,
                           const bf16* a_j, const bf16* w_d, const float* d2,
                           int j0, int live, int F1) {
  for (int idx = threadIdx.x; idx < kM * F1; idx += kThreads) {
    const int r = idx / F1;
    const int k = idx - r * F1;
    int q = 0;
    if (r < live) {
      const float t1 = bf16r(__bfloat162float(a_i[k]) +
                             __bfloat162float(a_j[size_t(j0 + r) * F1 + k]));
      const float t2 = bf16r(bf16r(d2[r]) * __bfloat162float(w_d[k]));
      const float v = rintf(silu(bf16r(t1 + t2)) * 32.0f);
      q = int(fminf(fmaxf(v, -127.0f), 127.0f));
    }
    A[r * lda + k] = int8_t(q);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) stages_kernel(Params p) {
  using Acc = typename Mma<T>::Acc;
  using Sum = typename std::conditional<std::is_same<T, int8_t>::value,
                                        uint32_t, float>::type;
  constexpr bool kPost = MODE == kMmPost || MODE == kFullSerial;
  constexpr bool kHasM = MODE <= kFullSerial;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> lay(p.F1, p.FM);
  T* A = reinterpret_cast<T*>(smem + lay.a);
  Acc* C = reinterpret_cast<Acc*>(smem + lay.c);
  float* Cf = reinterpret_cast<float*>(smem + lay.c);
  T* Ws = reinterpret_cast<T*>(smem + lay.c);  // staged inside C
  float* msum = reinterpret_cast<float*>(smem + lay.msum);
  float* d2 = reinterpret_cast<float*>(smem + lay.meta);
  float* pm = d2 + kM;
  float* s = pm + kM;
  float* gate = s + kM;
  float* diff = gate + kM;  // [kM, 3]; the update after the x branch
  float* xacc = diff + 3 * kM;
  Sum* red = reinterpret_cast<Sum*>(xacc + 8);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x, N = p.N, F1 = p.F1;
  const size_t node0 = size_t(blockIdx.y) * N;
  const int lda = F1 + Mma<T>::kPad;
  const size_t row0 = (node0 + i) * N;  // first edge row of target i
  Sum check = 0;

  if constexpr (kHasM)
    for (int c = tid; c < p.FM; c += kThreads) msum[c] = 0.0f;
  if (tid < 8) xacc[tid] = 0.0f;

  for (int j0 = 0; j0 < N; j0 += kM) {
    const int live = N - j0 < kM ? N - j0 : kM;
    __syncthreads();  // the previous tile's metadata has been read
    if (tid < kM) {
      const int r = tid;
      float dd[3] = {0.0f, 0.0f, 0.0f}, pmr = 0.0f;
      if (kPost && r < live) {
        const int j = j0 + r;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          dd[k] = bf16r(p.x[(node0 + i) * 3 + k]) - p.x[(node0 + j) * 3 + k];
        pmr = i != j ? bf16r(p.mask[node0 + i]) * p.mask[node0 + j] : 0.0f;
      }
      d2[r] = __fadd_rn(__fadd_rn(__fmul_rn(dd[0], dd[0]),
                                  __fmul_rn(dd[1], dd[1])),
                        __fmul_rn(dd[2], dd[2]));
      pm[r] = pmr;
      s[r] = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) diff[r * 3 + k] = dd[k];
    }
    __syncthreads();

    // --- h branch: om = qm @ w2m_q (FM = 256: one pass, one column a thread)
    if constexpr (kHasM) {
      if (MODE == kFullSerial)
        build_tile(A, lda, p.am_i + (node0 + i) * F1, p.am_j + node0 * F1,
                   p.w_dm, d2, j0, live, F1);
      else
        load_tile(A, lda, static_cast<const int8_t*>(p.qm) + (row0 + j0) * F1,
                  live, F1);
      block_product<int8_t, kM>(A, lda, p.w2m, p.FM, 0, F1, C, Ws);
      const int c = tid;
      float acc = msum[c];
      if (!kPost) {
        for (int r = 0; r < live; ++r) {
          const int v = C[r * kLdc + c];
          check += uint32_t(v);
          acc += bf16r(float(v));
        }
      } else {
        for (int r = 0; r < kM; ++r) {
          const int v = C[r * kLdc + c];
          if (r < live) check += uint32_t(v);
          Cf[r * kLdc + c] = bf16r(silu(float(v) * (1.0f / 2048.0f)));
        }
        __syncthreads();
        for (int r = warp; r < live; r += kThreads / 32) {
          float part = 0.0f;
          for (int k = lane; k < kPass; k += 32)
            part += Cf[r * kLdc + k] * bf16r(p.wa[k]);
          part = warp_sum(part);
          if (lane == 0) gate[r] = sigmoid(part) * pm[r];
        }
        __syncthreads();
        for (int r = 0; r < live; ++r) acc += bf16r(Cf[r * kLdc + c] * gate[r]);
      }
      msum[c] = acc;
    }

    // --- x branch: ox = qx @ w2x in 256-column passes
    if constexpr (MODE == kFullSerial)
      build_tile(A, lda, p.ax_i + (node0 + i) * F1, p.ax_j + node0 * F1,
                 p.w_dx, d2, j0, live, F1);
    else
      load_tile(A, lda, static_cast<const T*>(p.qx) + (row0 + j0) * F1, live,
                F1);
    for (int col0 = 0; col0 < F1; col0 += kPass) {
      block_product<T, kM>(A, lda, static_cast<const T*>(p.w2x), F1, col0, F1,
                           C, Ws);
      const int c = tid;
      if (MODE == kMm || MODE == kX) {
        const bool first = col0 == 0 && c < 8;
        float acc = first ? xacc[c] : 0.0f;
        for (int r = 0; r < live; ++r) {
          const Acc v = C[r * kLdc + c];
          check += Sum(v);
          if (first) acc += bf16r(float(v));
        }
        if (first) xacc[c] = acc;
      } else {
        const float w3 = bf16r(p.wx3[col0 + c]);
        for (int r = 0; r < kM; ++r) {
          const Acc v = C[r * kLdc + c];
          if (r < live) check += Sum(v);
          Cf[r * kLdc + c] = bf16r(silu(float(v) * (1.0f / 2048.0f))) * w3;
        }
        __syncthreads();
        for (int r = warp; r < live; r += kThreads / 32) {
          float part = 0.0f;
          for (int k = lane; k < kPass; k += 32) part += Cf[r * kLdc + k];
          part = warp_sum(part);
          if (lane == 0) s[r] += part;
        }
      }
    }
    if (MODE == kMm || MODE == kX) continue;
    __syncthreads();  // s is complete
    if (kPost && tid < live) {
      const int r = tid;
      const float pmr = pm[r];
      const float norm = sqrtf(pmr > 0.0f ? fmaxf(d2[r], 1e-12f) : 1.0f);
      const float f = s[r] * pmr / (norm + 1.0f);
#pragma unroll
      for (int k = 0; k < 3; ++k) diff[r * 3 + k] *= f;
    }
    __syncthreads();
    if (tid < (kPost ? 3 : 8)) {
      float acc = xacc[tid];
      for (int r = 0; r < live; ++r)
        acc += bf16r(kPost ? diff[r * 3 + tid] : s[r]);
      xacc[tid] = acc;
    }
  }

  __syncthreads();
  const Sum total = warp_sum(check);
  if (lane == 0) red[warp] = total;
  __syncthreads();
  if constexpr (kHasM)
    for (int c = tid; c < p.FM; c += kThreads)
      p.m_sum[(node0 + i) * p.FM + c] = msum[c];
  if (tid < 8) p.x_out[(node0 + i) * 8 + tid] = xacc[tid];
  if (tid == 0) {
    Sum t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
    static_cast<Sum*>(p.check)[node0 + i] = t;
  }
}

template <typename T, int MODE>
int launch(const Params& p, int B, cudaStream_t stream) {
  const Layout<T> lay(p.F1, p.FM);
  if (lay.total > kMaxSmem) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      stages_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(lay.total));
  if (err != cudaSuccess) return int(err);
  stages_kernel<T, MODE><<<dim3(p.N, B), kThreads, lay.total, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// mode: 0 mm, 1 mm_post, 2 full_serial (int8 only, FM = 256), 3 x, 4 xblk
// (q in qx, w in w2x, int8 or bf16). Pointers a mode does not read may be
// null. F1 must be a multiple of 256; else cudaErrorInvalidValue.
int probe_stages(int mode, int int8, const void* am_i, const void* am_j,
                 const void* ax_i, const void* ax_j, const void* x,
                 const void* mask, const void* qm, const void* qx,
                 const void* w_dm, const void* w_dx, const void* w2m,
                 const void* w2x, const void* wx3, const void* wa,
                 void* m_sum, void* x_out, void* check, int B, int N, int F1,
                 int FM, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || F1 < kPass || F1 % kPass != 0)
    return int(cudaErrorInvalidValue);
  if (mode <= kFullSerial && (!int8 || FM != kPass))
    return int(cudaErrorInvalidValue);
  Params p;
  p.am_i = static_cast<const bf16*>(am_i);
  p.am_j = static_cast<const bf16*>(am_j);
  p.ax_i = static_cast<const bf16*>(ax_i);
  p.ax_j = static_cast<const bf16*>(ax_j);
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.qm = qm;
  p.qx = qx;
  p.w_dm = static_cast<const bf16*>(w_dm);
  p.w_dx = static_cast<const bf16*>(w_dx);
  p.w2m = static_cast<const int8_t*>(w2m);
  p.w2x = w2x;
  p.wx3 = static_cast<const float*>(wx3);
  p.wa = static_cast<const float*>(wa);
  p.m_sum = static_cast<float*>(m_sum);
  p.x_out = static_cast<float*>(x_out);
  p.check = check;
  p.N = N;
  p.F1 = F1;
  p.FM = mode <= kFullSerial ? FM : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kMm: return launch<int8_t, kMm>(p, B, s);
    case kMmPost: return launch<int8_t, kMmPost>(p, B, s);
    case kFullSerial: return launch<int8_t, kFullSerial>(p, B, s);
    case kX:
      return int8 ? launch<int8_t, kX>(p, B, s) : launch<bf16, kX>(p, B, s);
    case kXblk:
      return int8 ? launch<int8_t, kXblk>(p, B, s)
                  : launch<bf16, kXblk>(p, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* probe_stages_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
