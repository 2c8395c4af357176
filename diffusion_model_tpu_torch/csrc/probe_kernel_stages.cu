// The int8 EGCL edge tile in stages, for Hopper (sm_90a).
//
// Replaces benchmarks/probe_kernel_stages.py:126 make_call (modes mm,
// mm_post, full_serial), :169 make_call_x and :239 make_call_xblk (the
// Pallas TPU probe that splits the planned int8 EGCL edge kernel's time
// into products, epilogue and pre-activation build). For graph b, target i
// and every source j (E = B N N edge rows, row (b N + i) N + j):
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
// rounds them; pm = mask_i mask_j (i != j). mm and x feed only 8 of the F1
// product columns to x_out, and a compiler would drop the rest: every
// int32 (float32) product is also added into a per-target checksum (a
// wrapping int32 sum, a float32 sum for bf16), written to `check`.
//
// What bounds it: tensor-core operations. At N = 192, F1 = 1024, FM = 256 a
// call needs 2 N^2 (F1^2 + F1 FM) = 96.6 G int8 operations (49 us at 1,979
// TOP/s); mm and mm_post also read 75.5 MB of prebuilt int8 rows (23 us at
// 3.35 TB/s). Below the operations, the L2: a tile of R edge rows reads all
// of W (1.25 MB) once, so W costs E / R x 1.25 MB a call.
//
// What the design does about it. The edge rows of all targets are walked
// flattened, in tiles of 128 rows (so a tile straddles targets), by a
// persistent grid of thread-block clusters of two, one block an SM: cluster
// c takes the tile pairs c, c + C, ... and its two blocks one tile of each
// pair, so both walk the same W stream, which each loads half of by TMA
// multicast into both: W costs 288 / 2 x 1.25 MB = 180 MB of L2 reads at
// N = 192 (the WMMA tile of 64 rows read 720 MB). A block has two consumer
// warpgroups (64 rows each, m64n256 accumulators: 128 registers a thread,
// 232 a thread taken by setmaxnreg) and a producer warpgroup (40 a
// thread): one thread keeps a ring of stages full across passes and tiles
// (a stage is one 128-byte K-block of the tile's rows, TMA with the
// 128-byte swizzle, and of 256 columns of W^T; 48 KB, four stages), three
// warps complete the split targets of a tile while the consumers go on to
// the next. The products run as wgmma (int8: m64n256k32 into int32; bf16:
// m64n256k16 into float32) straight from the ring, each stage handed back
// to both blocks' producers (an mbarrier of 16 warp arrivals) as soon as
// its products are done.
// full_serial builds the tile's int8 rows in the kernel instead: A stays in
// shared memory (128 rows x F1 <= 1024 bytes), written 16 values a lane in
// the swizzled K-major layout from 16-byte loads, SiLU as v / (1 + exp(-v))
// (exp2 and reciprocal on the SFU: its rounding to the nearest integer
// after x32 would amplify tanh.approx's error), and the ring holds two
// stages of W^T only. W is transposed once a call (transpose_kernel, inside
// the call) to the K-major layout both operands need.
// Epilogues run on the accumulator registers: SiLU as h + h tanh(h), h = v /
// 2 (one MUFU.TANH), the gate and the wx3 head as row reductions over the
// quad (a warpgroup holds all 256 columns of its rows), s over the F1 / 256
// passes in registers before the update. Per-target sums: per warp a
// butterfly over its 16 rows where they hold one target, else a segmented
// scan, each warp's sum through shared memory; a target inside one tile
// writes its outputs, a target across tiles writes one piece a tile to
// `pieces`, and the block that writes a target's last piece (a counter a
// target) adds them in tile order. Every float sum runs in a fixed order
// with no float atomics, so two runs give identical bits.
// Resources (nvcc -Xptxas -v, sm_90a): 384 threads, 168 registers a thread
// at launch, 64-144-byte stack frames; 209 KB of shared memory (4 x 48 KB
// of ring or 128 + 2 x 32 KB, and 16 KB of tile state). The grid is as
// many clusters as the card holds at once (at most 66 on 132 SMs) or as
// tile pairs: the 288 tiles at N = 192 take three rounds where 2.18 would.

#include <type_traits>

#include "hopper_ptx.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kRows = 128;                 // edge rows of a tile
constexpr int kCols = 256;                 // product columns of a pass
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kProducerRegs = 40;   // setmaxnreg: the producer gives up
constexpr int kConsumerRegs = 232;  // registers the consumers take
constexpr int kBox = kRows * 128;          // bytes of a 128 x 128-byte box
constexpr int kAlign = 1024;               // the swizzle's period
constexpr int kMaxBuildF1 = 1024;          // full_serial keeps A whole
constexpr int kPieceTail = 16;             // x (8), check (1), padding
constexpr size_t kMaxSmem = 232448;

enum Mode { kMm = 0, kMmPost = 1, kFullSerial = 2, kX = 3, kXblk = 4 };

template <typename T, int MODE>
struct Shape {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr bool kBuild = MODE == kFullSerial;
  static constexpr bool kHasM = MODE <= kFullSerial;
  static constexpr bool kPost = MODE == kMmPost || MODE == kFullSerial;
  static constexpr int kStages = kBuild ? 2 : 4;
  static constexpr int kStageA = kBuild ? 0 : kBox;  // A's box, then W^T's
  static constexpr int kStage = kStageA + 2 * kBox;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  using Sum = typename std::conditional<kInt8, uint32_t, float>::type;
};

struct Args {
  CUtensorMap map_qm, map_qx;  // [E, F1] edge rows, boxes of 128 x 128 bytes
  CUtensorMap map_wm, map_wx;  // w2m^T [FM, F1], w2x^T [F1, F1], the same
  const bf16 *am_i, *am_j, *ax_i, *ax_j, *w_dm, *w_dx;
  const float *x, *mask, *wx3, *wa;
  float *m_sum, *x_out;
  void* check;
  float* pieces;  // [piece, FM + kPieceTail] per-tile parts of split targets
  int* count;     // [G] pieces written, per target
  long long E;
  int N, F1, FM, tiles, pairs;
};

// Per-tile state in shared memory (row r = edge row tile * 128 + r).
struct Meta {
  int tgt[kRows];          // target b N + i; -1 past the last edge row
  int jn[kRows];           // source node b N + j
  float pm[kRows], d2[kRows], diff[kRows][3];
  float rowx[kRows][8];    // each row's summands of x_out
  uint32_t rowc[kRows];    // each row's checksum (bits)
  float last[8][kCols];    // column scans: each warp's row 15
  uint32_t xl[4][9];       // row scans: each warp's row 31 (x, check)
  int fin[2][2];           // targets the helpers complete (by tile parity)
};

template <typename T, int MODE>
size_t smem_bytes(int F1) {
  using S = Shape<T, MODE>;
  return kAlign + (S::kBuild ? size_t(kRows) * F1 : 0) +
         size_t(S::kStages) * S::kStage + 2 * S::kStages * 8 + sizeof(Meta);
}

// --- the plan: the tiles of a target, the index of its pieces ---

__host__ __device__ inline int first_tile(long long g, int N) {
  return int(g * N / kRows);
}
__host__ __device__ inline int last_tile(long long g, int N) {
  return int((g * N + N - 1) / kRows);
}
// A split target's piece of tile t sits at index g + t: unique, since the
// next target starts in or after this one's last tile.
__device__ inline float* piece(const Args& p, int g, int t) {
  return p.pieces + size_t(g + t) * (p.FM + kPieceTail);
}

// --- small pieces ---

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}
__device__ __forceinline__ void wg0_sync() {  // the first warpgroup
  asm volatile("bar.sync 2, 128;" ::: "memory");
}
// Hand-over of a tile's pieces from the consumers to the helper warps (3)
// and back (4); the helpers' own barrier (5).
constexpr int kHelpers = 96;  // warps 9-11, beside the producer's warp 8
__device__ __forceinline__ void handover_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kConsumers + kHelpers)
               : "memory");
}
__device__ __forceinline__ void handover_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kConsumers + kHelpers)
               : "memory");
}
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 5, %0;" ::"n"(kHelpers) : "memory");
}
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// Both values rounded to bf16 by one packed conversion.
__device__ __forceinline__ void bf16r2(float& a, float& b) {
  const float2 f = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  a = f.x;
  b = f.y;
}
// silu(v) = h + h tanh(h), h = v / 2: one MUFU.TANH (relative error ~5e-4,
// below the bf16 rounding that follows).
__device__ __forceinline__ float silu_tanh(float v) {
  const float h = 0.5f * v;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}
// silu(v) = v / (1 + exp(-v)): MUFU.EX2 and MUFU.RCP, relative error ~1e-6.
__device__ __forceinline__ float silu_exp(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + __expf(-v));
}
template <typename V>
__device__ __forceinline__ V quad_sum(V v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
template <typename V>
__device__ __forceinline__ uint32_t bits(V v) {
  if constexpr (std::is_same<V, float>::value)
    return __float_as_uint(v);
  else
    return v;
}
template <typename V>
__device__ __forceinline__ V from_bits(uint32_t b) {
  if constexpr (std::is_same<V, float>::value)
    return __uint_as_float(b);
  else
    return b;
}

// --- the ring ---

// Stages of one fixed sequence of positions, the same in both blocks of the
// cluster: position pos lands in stage pos % kStages, in its (pos /
// kStages)-th use. Each is handed back to both blocks' producers (each
// loaded half of its W^T box into both blocks).
template <class S>
struct Ring {
  uint32_t base, full, empty, peer_empty;
  __device__ uint32_t wait(int pos) const {
    const int st = pos % S::kStages;
    mbar_wait(full + st * 8, (pos / S::kStages) & 1);
    return base + st * S::kStage;
  }
  __device__ void release(int pos) const {
    if ((threadIdx.x & 31) == 0) {
      const int st = pos % S::kStages;
      mbar_arrive(empty + st * 8);
      mbar_arrive_cluster(peer_empty + st * 8);
    }
  }
};

// acc[64 x 256] = this warpgroup's 64 rows of A @ the pass's 256 columns of
// W, over `kblocks` 128-byte K-blocks at ring positions pos, pos + 1, ...
// A comes from each stage, or (a_whole) from the resident tile; one stage's
// products stay in flight while the next is waited for.
template <class S, typename Acc>
__device__ void product(Acc* acc, const Ring<S>& ring, int& pos, int kblocks,
                        uint32_t a_whole) {
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  int before = -1;
  for (int kb = 0; kb < kblocks; ++kb) {
    const uint32_t st = ring.wait(pos);
    const uint32_t a =
        (S::kBuild ? a_whole + kb * kBox : st) + wg * (kBox / 2);
    const uint32_t b = st + S::kStageA;
    wgmma_fence();
    fence_regs(acc, 128);
#pragma unroll
    for (int k = 0; k < 4; ++k)  // 128 bytes of K, 32 a product
      wgmma_kmajor<256>(acc, sw128_desc(a + k * 32, 16, 1024),
                        sw128_desc(b + k * 32, 16, 1024));
    wgmma_commit();
    if (before >= 0) {
      wgmma_wait<1>();
      ring.release(before);
    }
    before = pos++;
  }
  wgmma_wait<0>();
  fence_regs(acc, 128);
  ring.release(before);
}

// The products of rows R0 (c0) and R1 (c1) added into their checksums.
template <typename Acc, typename Sum>
__device__ __forceinline__ void add_check(const Acc* acc, Sum& c0, Sum& c1) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    c0 += Sum(acc[4 * i]) + Sum(acc[4 * i + 1]);
    c1 += Sum(acc[4 * i + 2]) + Sum(acc[4 * i + 3]);
  }
}

// --- tile state ---

template <int MODE>
__device__ void tile_meta(const Args& p, Meta& mt, int tile) {
  constexpr bool kPost = MODE == kMmPost || MODE == kFullSerial;
  const int r = threadIdx.x;
  if (r >= kRows) return;
  const long long row = (long long)tile * kRows + r;
  int t = -1, jn = 0;
  float pm = 0.0f, d[3] = {0.0f, 0.0f, 0.0f};
  if (tile < p.tiles && row < p.E) {
    t = int(row / p.N);
    const int j = int(row - (long long)t * p.N);
    const int b = t / p.N;
    jn = b * p.N + j;
    if constexpr (kPost) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        d[k] = bf16r(p.x[size_t(t) * 3 + k]) - p.x[size_t(jn) * 3 + k];
      pm = t - b * p.N != j ? bf16r(p.mask[t]) * p.mask[jn] : 0.0f;
    }
  }
  mt.tgt[r] = t;
  mt.jn[r] = jn;
  mt.pm[r] = pm;
  mt.d2[r] = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                       __fmul_rn(d[2], d[2]));
#pragma unroll
  for (int k = 0; k < 3; ++k) mt.diff[r][k] = d[k];
}

// Values of the full_serial build, rounded as the TPU probe rounds them.
// Two of them (a, b, w: bf16 pairs), as the two low bytes of the result;
// each bf16 rounding is one packed conversion for both.
__device__ __forceinline__ uint32_t quant2(uint32_t a, uint32_t b, uint32_t w,
                                           float d2b) {
  const float2 af = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 bf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  const float2 wf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  float t1x = __fadd_rn(af.x, bf.x), t1y = __fadd_rn(af.y, bf.y);
  float t2x = __fmul_rn(d2b, wf.x), t2y = __fmul_rn(d2b, wf.y);
  bf16r2(t1x, t1y);
  bf16r2(t2x, t2y);
  float px = __fadd_rn(t1x, t2x), py = __fadd_rn(t1y, t2y);
  bf16r2(px, py);
  const int qx = __float2int_rn(__fmul_rn(silu_exp(px), 32.0f));
  const int qy = __float2int_rn(__fmul_rn(silu_exp(py), 32.0f));
  return (uint32_t(min(max(qx, -127), 127)) & 0xffu) |
         (uint32_t(min(max(qy, -127), 127)) & 0xffu) << 8;
}

// The full_serial build: A[r, :] = quant(a_i, a_j, w_d, d2_r) for the
// tile's rows, straight into the swizzled K-major layout, 16 values (one
// 16-byte store) a lane and step, from 16-byte loads; one row a warp and
// step; each lane keeps its part of w_d in registers. Tail rows are zero.
__device__ void build_rows(uint8_t* A, const bf16* a_i, const bf16* a_j,
                           const bf16* w_d, const Meta& mt, int F1) {
  constexpr int kCh = kMaxBuildF1 / 16 / 32;  // 16-value chunks a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = F1 / 16;
  uint4 wv[kCh][2];
#pragma unroll
  for (int u = 0; u < kCh; ++u) {
    const int ch = lane + 32 * u;
    if (ch < nch) {
      wv[u][0] = reinterpret_cast<const uint4*>(w_d)[2 * ch];
      wv[u][1] = reinterpret_cast<const uint4*>(w_d)[2 * ch + 1];
    }
  }
  for (int r = warp; r < kRows; r += kConsumers / 32) {
    const int t = mt.tgt[r];
    const float d2b = bf16r(mt.d2[r]);
    const uint4* ai = reinterpret_cast<const uint4*>(
        a_i + size_t(t < 0 ? 0 : t) * F1);
    const uint4* aj = reinterpret_cast<const uint4*>(a_j + size_t(mt.jn[r]) *
                                                               F1);
    uint4 av[kCh][2], bv[kCh][2];
#pragma unroll
    for (int u = 0; u < kCh; ++u) {
      const int ch = lane + 32 * u;
      if (t >= 0 && ch < nch) {
        av[u][0] = ai[2 * ch];
        av[u][1] = ai[2 * ch + 1];
        bv[u][0] = aj[2 * ch];
        bv[u][1] = aj[2 * ch + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < kCh; ++u) {
      const int ch = lane + 32 * u;
      if (ch >= nch) continue;
      uint32_t out[4] = {0u, 0u, 0u, 0u};
      if (t >= 0) {
#pragma unroll
        for (int v = 0; v < 8; ++v) {  // bf16 pairs: values 2v, 2v + 1
          const uint32_t pair =
              quant2(reinterpret_cast<const uint32_t*>(av[u])[v],
                     reinterpret_cast<const uint32_t*>(bv[u])[v],
                     reinterpret_cast<const uint32_t*>(wv[u])[v], d2b);
          out[v >> 1] |= pair << (16 * (v & 1));
        }
      }
      *reinterpret_cast<uint4*>(A + kmajor_offset(r, 16 * ch, kRows)) =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

// --- per-target sums ---

// The m_sum row of target t, or its piece of this tile if t is split.
__device__ __forceinline__ float* m_dst(const Args& p, int t, int tile) {
  return first_tile(t, p.N) == last_tile(t, p.N) ? p.m_sum + size_t(t) * p.FM
                                                  : piece(p, t, tile);
}

// Sums over each target's rows of the tile, for 256 columns held in the
// accumulator layout (v[4i + 2h + e]: row 16 warp + lane / 4 + 8h, column
// 8i + 2 (lane % 4) + e). Per warp, the sum of the run of rows that ends at
// its row 15 goes to shared memory (`last`): a butterfly over the warp's 16
// rows where they hold one target, else a segmented scan, whose rows that
// end a target inside the warp write it. Then one column a thread adds up
// the warps of each target that ends at a warp's row 15 and writes it.
// Ends with a barrier.
__device__ void column_sums(float* v, const Args& p, Meta& mt, int tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  if (mt.tgt[16 * warp] == mt.tgt[16 * warp + 15]) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = v[4 * i + h] + v[4 * i + 2 + h];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g == 0) mt.last[warp][8 * i + 2 * q + h] = s;
      }
    consumer_sync();
  } else {
    const int r0 = 16 * warp + g, r1 = r0 + 8;
    const int t0 = mt.tgt[r0], t1 = mt.tgt[r1];
    bool f0[3], f1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f0[k] = g >= (1 << k) && mt.tgt[r0 - (1 << k)] == t0;
      f1[k] = g >= (1 << k) && mt.tgt[r1 - (1 << k)] == t1;
    }
    const bool join = mt.tgt[16 * warp + 7] == t1;
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = v[4 * i + h], b = v[4 * i + 2 + h];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float ua = __shfl_up_sync(0xffffffffu, a, 4 << k);
          const float ub = __shfl_up_sync(0xffffffffu, b, 4 << k);
          if (f0[k]) a += ua;
          if (f1[k]) b += ub;
        }
        const float end0 = __shfl_sync(0xffffffffu, a, 28 + q);
        if (join) b += end0;
        v[4 * i + h] = a;
        v[4 * i + 2 + h] = b;
        if (g == 7) mt.last[warp][8 * i + 2 * q + h] = b;
      }
    consumer_sync();
    // targets that end inside this warp: the row that ends one writes it,
    // with the runs of the warps before where it began there
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = hr ? r1 : r0, t = hr ? t1 : t0;
      if (t < 0 || r % 16 == 15 || mt.tgt[r + 1] == t) continue;
      int lo = warp;
      if (mt.tgt[16 * warp] == t)
        while (lo > 0 && mt.tgt[16 * lo - 1] == t) --lo;
      float* dst = m_dst(p, t, tile);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float a = v[4 * i + 2 * hr], b = v[4 * i + 2 * hr + 1];
        for (int w = warp - 1; w >= lo; --w) {
          a += mt.last[w][8 * i + 2 * q];
          b += mt.last[w][8 * i + 2 * q + 1];
        }
        *reinterpret_cast<float2*>(dst + 8 * i + 2 * q) = make_float2(a, b);
      }
    }
  }
  // targets that end at a warp's row 15: column threadIdx.x, the warps in
  // order
  for (int w = 0; w < kConsumers / 32; ++w) {
    const int t = mt.tgt[16 * w + 15];
    if (t < 0 || (w < kConsumers / 32 - 1 && mt.tgt[16 * w + 16] == t))
      continue;
    int lo = w;
    while (lo > 0 && mt.tgt[16 * lo - 1] == t) --lo;
    float s = 0.0f;
    for (int w2 = lo; w2 <= w; ++w2) s += mt.last[w2][threadIdx.x];
    m_dst(p, t, tile)[threadIdx.x] = s;
  }
  consumer_sync();
}

// The same over the rows' x summands and checksums (rowx, rowc): one row a
// thread of the first warpgroup, a segmented scan over a warp's 32 rows,
// each warp's row 31 through shared memory.
template <typename Sum>
__device__ void row_sums(const Args& p, Meta& mt, int tile) {
  const int r = threadIdx.x, lane = r & 31, w = r >> 5;
  const int t = mt.tgt[r];
  float xv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) xv[k] = mt.rowx[r][k];
  Sum c = from_bits<Sum>(mt.rowc[r]);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const bool same = lane >= o && mt.tgt[r - (lane >= o ? o : 0)] == t;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float u = __shfl_up_sync(0xffffffffu, xv[k], o);
      if (same) xv[k] += u;
    }
    const Sum u = __shfl_up_sync(0xffffffffu, c, o);
    if (same) c += u;
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < 8; ++k) mt.xl[w][k] = __float_as_uint(xv[k]);
    mt.xl[w][8] = bits(c);
  }
  wg0_sync();
  if (t < 0 || (r < kRows - 1 && mt.tgt[r + 1] == t)) return;
  if (mt.tgt[32 * w] == t)
    for (int w2 = w - 1; w2 >= 0; --w2) {
      if (mt.tgt[32 * w2 + 31] != t) break;
#pragma unroll
      for (int k = 0; k < 8; ++k) xv[k] += __uint_as_float(mt.xl[w2][k]);
      c += from_bits<Sum>(mt.xl[w2][8]);
      if (mt.tgt[32 * w2] != t) break;
    }
  if (first_tile(t, p.N) == last_tile(t, p.N)) {
#pragma unroll
    for (int k = 0; k < 8; ++k) p.x_out[size_t(t) * 8 + k] = xv[k];
    static_cast<Sum*>(p.check)[t] = c;
  } else {
    float* dst = piece(p, t, tile) + p.FM;
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[k] = xv[k];
    reinterpret_cast<uint32_t*>(dst)[8] = bits(c);
  }
}

// m_sum, x_out and check of a split target from its pieces, in tile order;
// thread h of n.
template <typename Sum>
__device__ void finish(const Args& p, int t, int h, int n) {
  const int t0 = first_tile(t, p.N), t1 = last_tile(t, p.N);
  for (int c = h; c <= p.FM + 8; c += n) {
    if (c < p.FM + 8) {
      float v = 0.0f;
      for (int k = t0; k <= t1; ++k) v += __ldcg(piece(p, t, k) + c);
      if (c < p.FM)
        p.m_sum[size_t(t) * p.FM + c] = v;
      else
        p.x_out[size_t(t) * 8 + c - p.FM] = v;
    } else {
      Sum v = 0;
      for (int k = t0; k <= t1; ++k)
        v += from_bits<Sum>(__ldcg(
            reinterpret_cast<const unsigned int*>(piece(p, t, k) + c)));
      static_cast<Sum*>(p.check)[t] = v;
    }
  }
}

// --- the kernel ---

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    stages_kernel(const __grid_constant__ Args p) {
  using S = Shape<T, MODE>;
  using Acc = typename S::Acc;
  using Sum = typename S::Sum;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t a_whole = base;  // full_serial's A
  const uint32_t ring = base + (S::kBuild ? uint32_t(kRows) * p.F1 : 0u);
  const uint32_t full = ring + S::kStages * S::kStage;
  const uint32_t empty = full + S::kStages * 8;
  Meta& mt = *reinterpret_cast<Meta*>(base_ptr + (empty + S::kStages * 8 -
                                                  base));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = int(cluster_rank());
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  const int kblocks = p.F1 * int(sizeof(T)) / 128;
  const int xpasses = p.F1 / kCols;

  if (tid == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(full + i * 8, 1);
      mbar_init(empty + i * 8, 2 * kConsumers / 32);  // both blocks' warps
    }
    fence_mbarrier_init();
  }
  // no block touches a peer's barriers before they exist
  cluster_arrive();
  cluster_wait();

  if (warp >= kConsumers / 32) {
    // --- producer: the tiles' stages, in the consumers' order ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp > kConsumers / 32) {
      // --- helpers: split targets completed, a tile behind the consumers
      const int h = tid - kConsumers - 32;
      int k = 0;
      for (int pair = cluster; pair < p.pairs; pair += clusters, ++k) {
        const int tile = 2 * pair + rank;
        handover_sync(3);  // the consumers' pieces of the tile are out
        if (h == 0) {  // its split targets: its first and its last
          int cand[2] = {-1, -1};
          if (tile < p.tiles) {
            const long long lo = (long long)tile * kRows;
            const long long hi = lo + kRows < p.E ? lo + kRows : p.E;
            cand[0] = int(lo / p.N);
            cand[1] = int((hi - 1) / p.N);
            if (cand[1] == cand[0]) cand[1] = -1;
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int t = cand[j];
            int done = -1;
            if (t >= 0 && first_tile(t, p.N) != last_tile(t, p.N)) {
              const int n = last_tile(t, p.N) - first_tile(t, p.N) + 1;
              if (atomicAdd(p.count + t, 1) == n - 1) done = t;
            }
            mt.fin[k & 1][j] = done;
          }
        }
        helpers_sync();
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (mt.fin[k & 1][j] >= 0) {
            __threadfence();
            finish<Sum>(p, mt.fin[k & 1][j], h, kHelpers);
          }
        handover_arrive(4);
      }
    } else if (warp == kConsumers / 32 && lane == 0) {
      const uint16_t both = 0x3;
      int pos = 0;
      for (int pair = cluster; pair < p.pairs; pair += clusters) {
        const int row = (2 * pair + rank) * kRows;
        for (int pass = 0; pass < xpasses + (S::kHasM ? 1 : 0); ++pass) {
          const bool mpass = S::kHasM && pass == 0;
          const CUtensorMap* ma = mpass ? &p.map_qm : &p.map_qx;
          const CUtensorMap* mb = mpass ? &p.map_wm : &p.map_wx;
          const int col = (pass - (S::kHasM ? 1 : 0)) * kCols;
          const int brow = (mpass ? 0 : col) + rank * (kCols / 2);
          for (int kb = 0; kb < kblocks; ++kb, ++pos) {
            const int st = pos % S::kStages, use = pos / S::kStages;
            const uint32_t bar = full + st * 8, dst = ring + st * S::kStage;
            if (use > 0) mbar_wait(empty + st * 8, (use - 1) & 1);
            mbar_expect_tx(bar, S::kStage);
            if constexpr (!S::kBuild)
              tma_load(dst, ma, bar, kb * (128 / int(sizeof(T))), row);
            // this block's half of the 256 columns, into both blocks
            tma_load_multicast(dst + S::kStageA + rank * kBox, mb, bar,
                               kb * (128 / int(sizeof(T))), brow, both);
          }
        }
      }
    }
  } else {
    // --- consumers: two warpgroups, 64 rows each ---
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const Ring<S> rg{ring, full, empty,
                     map_to_rank(empty, uint32_t(rank ^ 1))};
    const int q = lane & 3;
    const int R0 = 16 * warp + (lane >> 2), R1 = R0 + 8;
    Acc acc[128];
    int pos = 0;
    bool handed = false;  // a tile has gone to the helpers
    for (int pair = cluster; pair < p.pairs; pair += clusters) {
      const int tile = 2 * pair + rank;
      tile_meta<MODE>(p, mt, tile);
      consumer_sync();
      Sum c0 = 0, c1 = 0;    // rows R0, R1: checksums
      float s0 = 0.0f, s1 = 0.0f;  // and the x head (post, xblk)

      if constexpr (S::kHasM) {
        // --- h branch: om, its summands, their sums over each target ---
        if constexpr (S::kBuild) {
          build_rows(base_ptr, p.am_i, p.am_j, p.w_dm, mt, p.F1);
          fence_proxy_async();
          consumer_sync();
        }
        product<S>(acc, rg, pos, kblocks, a_whole);
        add_check(acc, c0, c1);
        float v[128];
        if constexpr (MODE == kMm) {
#pragma unroll
          for (int i = 0; i < 128; ++i) v[i] = float(acc[i]);
#pragma unroll
          for (int i = 0; i < 128; i += 2) bf16r2(v[i], v[i + 1]);
        } else {
          float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float2 wa =
                __ldg(reinterpret_cast<const float2*>(p.wa) + 4 * i + q);
            const float w0 = bf16r(wa.x), w1 = bf16r(wa.y);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = 4 * i + 2 * h;
              v[j] = silu_tanh(float(acc[j]) * (1.0f / 2048.0f));
              v[j + 1] = silu_tanh(float(acc[j + 1]) * (1.0f / 2048.0f));
              bf16r2(v[j], v[j + 1]);
              (h ? p1 : p0) += v[j] * w0 + v[j + 1] * w1;
            }
          }
          const float g0 = sigmoid(quad_sum(p0)) * mt.pm[R0];
          const float g1 = sigmoid(quad_sum(p1)) * mt.pm[R1];
#pragma unroll
          for (int i = 0; i < 32; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = 4 * i + 2 * h;
              v[j] *= h ? g1 : g0;
              v[j + 1] *= h ? g1 : g0;
              bf16r2(v[j], v[j + 1]);
            }
        }
        column_sums(v, p, mt, tile);
        if constexpr (S::kBuild) {
          build_rows(base_ptr, p.ax_i, p.ax_j, p.w_dx, mt, p.F1);
          fence_proxy_async();
          consumer_sync();
        }
      }

      // --- x branch: ox in 256-column passes ---
      for (int px = 0; px < xpasses; ++px) {
        product<S>(acc, rg, pos, kblocks, a_whole);
        add_check(acc, c0, c1);
        if constexpr (MODE == kMm || MODE == kX) {
          if (px == 0) {  // columns 0..7: x_out's summands
            float a = float(acc[0]), b = float(acc[1]);
            float c = float(acc[2]), d = float(acc[3]);
            bf16r2(a, b);
            bf16r2(c, d);
            mt.rowx[R0][2 * q] = a;
            mt.rowx[R0][2 * q + 1] = b;
            mt.rowx[R1][2 * q] = c;
            mt.rowx[R1][2 * q + 1] = d;
          }
        } else {
          const float2* wx =
              reinterpret_cast<const float2*>(p.wx3 + px * kCols);
          float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float2 w = __ldg(wx + 4 * i + q);
            const float w0 = bf16r(w.x), w1 = bf16r(w.y);
            float u[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              u[e] = silu_tanh(float(acc[4 * i + e]) * (1.0f / 2048.0f));
            bf16r2(u[0], u[1]);
            bf16r2(u[2], u[3]);
            p0 += u[0] * w0 + u[1] * w1;
            p1 += u[2] * w0 + u[3] * w1;
          }
          s0 += quad_sum(p0);
          s1 += quad_sum(p1);
        }
      }

      // --- the rows' x summands and checksums, then the sums per target ---
      c0 = quad_sum(c0);
      c1 = quad_sum(c1);
      if (q == 0) {
        mt.rowc[R0] = bits(c0);
        mt.rowc[R1] = bits(c1);
        if constexpr (S::kPost) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = h ? R1 : R0;
            const float pm = mt.pm[r];
            const float norm = sqrtf(pm > 0.0f ? fmaxf(mt.d2[r], 1e-12f)
                                               : 1.0f);
            const float f = (h ? s1 : s0) * pm / (norm + 1.0f);
#pragma unroll
            for (int k = 0; k < 8; ++k)
              mt.rowx[r][k] = k < 3 ? bf16r(mt.diff[r][k] * f) : 0.0f;
          }
        } else if constexpr (MODE == kXblk) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            mt.rowx[R0][k] = bf16r(s0);
            mt.rowx[R1][k] = bf16r(s1);
          }
        }
      }
      consumer_sync();
      if (tid < kRows) row_sums<Sum>(p, mt, tile);
      // the pieces out before the helpers count them; the helpers done
      // with the tile before
      __threadfence();
      if (handed) handover_sync(4);
      handover_arrive(3);
      handed = true;
    }
    if (handed) handover_sync(4);
  }
  // nobody leaves while a peer may still load into it or arrive on it
  __syncwarp();
  cluster_arrive();
  cluster_wait();
}

void configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
               int blocks, size_t smem, cudaStream_t stream) {
  *cfg = {};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Clusters of two the card holds at once for this instantiation (0: none,
// or the query failed).
template <typename T, int MODE>
int active_clusters(int F1) {
  const size_t smem = smem_bytes<T, MODE>(F1);
  const void* kernel = reinterpret_cast<const void*>(stages_kernel<T, MODE>);
  if (smem > kMaxSmem ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem)) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(&cfg, &attr, 2, smem, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// One buffer of scratch a launch needs, as byte offsets: W^T (w2m^T, then
// w2x^T) from 0, the split targets' pieces ([G + tiles - 1, FM + kPieceTail]
// floats: target g's piece of tile t at g + t) from `pieces`, their counters
// ([G] ints) from `count`, `bytes` in all.
struct Scratch {
  size_t pieces, count, bytes;
};
Scratch scratch_layout(int mode, int int8, long long G, long long tiles,
                       int F1, int FM) {
  const size_t fm = mode <= kFullSerial ? FM : 0;
  Scratch s;
  s.pieces = (fm + F1) * F1 * (int8 ? 1 : 2);
  s.count = s.pieces + size_t(G + tiles - 1) * (fm + kPieceTail) * 4;
  s.bytes = s.count + size_t(G) * 4;
  return s;
}

template <typename T, int MODE>
int launch(Args& a, const void* qm, const void* qx, const void* w2m,
           const void* w2x, uint8_t* wT, int G, int blocks,
           cudaStream_t stream) {
  using S = Shape<T, MODE>;
  constexpr int eb = sizeof(T);
  const size_t smem = smem_bytes<T, MODE>(a.F1);
  if (smem > kMaxSmem || (S::kBuild && a.F1 > kMaxBuildF1))
    return int(cudaErrorInvalidValue);
  T* w2mT = reinterpret_cast<T*>(wT);
  T* w2xT = reinterpret_cast<T*>(wT + size_t(a.FM) * a.F1 * eb);
  const int rows = int(a.E);
  int rc = 0;
  if (S::kHasM && !S::kBuild) rc = encode_kmajor(&a.map_qm, qm, rows, a.F1,
                                                  eb, kRows);
  if (rc == 0 && !S::kBuild)
    rc = encode_kmajor(&a.map_qx, qx, rows, a.F1, eb, kRows);
  if (rc == 0 && S::kHasM)
    rc = encode_kmajor(&a.map_wm, w2mT, a.FM, a.F1, eb, kRows);
  if (rc == 0) rc = encode_kmajor(&a.map_wx, w2xT, a.F1, a.F1, eb, kRows);
  if (rc != 0) return rc;
  const void* kernel = reinterpret_cast<const void*>(stages_kernel<T, MODE>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (S::kHasM)
    transpose_kernel<T><<<dim3(a.FM / 32, a.F1 / 32), 256, 0, stream>>>(
        static_cast<const T*>(w2m), w2mT, a.F1, a.FM);
  transpose_kernel<T><<<dim3(a.F1 / 32, a.F1 / 32), 256, 0, stream>>>(
      static_cast<const T*>(w2x), w2xT, a.F1, a.F1);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.count, 0, size_t(G) * sizeof(int), stream);
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(&cfg, &attr, blocks, smem, stream);
  return int(cudaLaunchKernelEx(&cfg, stages_kernel<T, MODE>, a));
}

// The instantiation of (mode, int8), called as f.template operator()<T,
// MODE>(); false if there is none.
template <class F>
bool dispatch(int mode, int int8, F& f) {
  switch (mode) {
    case kMm: if (!int8) return false; f.template operator()<int8_t, kMm>();
      return true;
    case kMmPost: if (!int8) return false;
      f.template operator()<int8_t, kMmPost>(); return true;
    case kFullSerial: if (!int8) return false;
      f.template operator()<int8_t, kFullSerial>(); return true;
    case kX:
      if (int8) f.template operator()<int8_t, kX>();
      else f.template operator()<bf16, kX>();
      return true;
    case kXblk:
      if (int8) f.template operator()<int8_t, kXblk>();
      else f.template operator()<bf16, kXblk>();
      return true;
    default: return false;
  }
}

struct AskActive {
  int F1, n;
  template <typename T, int MODE> void operator()() {
    n = active_clusters<T, MODE>(F1);
  }
};

struct Launch {
  Args* a;
  const void *qm, *qx, *w2m, *w2x;
  uint8_t* wT;
  int G, blocks;
  cudaStream_t stream;
  int rc;
  template <typename T, int MODE> void operator()() {
    rc = launch<T, MODE>(*a, qm, qx, w2m, w2x, wT, G, blocks, stream);
  }
};

}  // namespace

extern "C" {

// Clusters of two blocks the card holds at once for this mode's kernel
// (probes/kernel_stages.py `grid` sizes the persistent grid from it); 0 if
// the mode does not exist or the query failed.
int probe_stages_active_clusters(int mode, int int8, int F1) {
  AskActive ask{F1, 0};
  return dispatch(mode, int8, ask) ? ask.n : 0;
}

// Bytes of the one scratch buffer a launch of this mode and shape needs
// (W^T, the pieces of split targets, their counters); 0 for no such mode.
long long probe_stages_scratch_bytes(int mode, int int8, int B, int N,
                                     int F1, int FM) {
  if (mode < kMm || mode > kXblk || B < 1 || N < 1) return 0;
  const long long G = (long long)B * N;
  return (long long)scratch_layout(mode, int8, G, (G * N + kRows - 1) / kRows,
                                   F1, FM).bytes;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// mode: 0 mm, 1 mm_post, 2 full_serial (int8 only, FM = 256, F1 <= 1024),
// 3 x, 4 xblk (q in qx, w in w2x, int8 or bf16). Pointers a mode does not
// read may be null. F1 must be a multiple of 256. `scratch` holds
// `scratch_bytes`, at least probe_stages_scratch_bytes; `blocks` is the
// persistent grid, even and at most twice the tile pairs. Else
// cudaErrorInvalidValue.
int probe_stages(int mode, int int8, const void* am_i, const void* am_j,
                 const void* ax_i, const void* ax_j, const void* x,
                 const void* mask, const void* qm, const void* qx,
                 const void* w_dm, const void* w_dx, const void* w2m,
                 const void* w2x, const void* wx3, const void* wa,
                 void* m_sum, void* x_out, void* check, void* scratch,
                 long long scratch_bytes, int B, int N, int F1, int FM,
                 int blocks, void* stream) {
  if (B < 1 || N < 1 || F1 < kCols || F1 % kCols != 0 || scratch == nullptr)
    return int(cudaErrorInvalidValue);
  if (mode <= kFullSerial && (!int8 || FM != kCols))
    return int(cudaErrorInvalidValue);
  const long long G = (long long)B * N, E = G * N;
  const long long tiles = (E + kRows - 1) / kRows;
  const long long pairs = (tiles + 1) / 2;
  if (E > 0x7fffffffLL || blocks < 2 || blocks % 2 != 0 ||
      blocks > 2 * pairs)
    return int(cudaErrorInvalidValue);
  const Scratch s = scratch_layout(mode, int8, G, tiles, F1, FM);
  if (scratch_bytes < 0 || size_t(scratch_bytes) < s.bytes)
    return int(cudaErrorInvalidValue);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  Args a{};
  a.am_i = static_cast<const bf16*>(am_i);
  a.am_j = static_cast<const bf16*>(am_j);
  a.ax_i = static_cast<const bf16*>(ax_i);
  a.ax_j = static_cast<const bf16*>(ax_j);
  a.w_dm = static_cast<const bf16*>(w_dm);
  a.w_dx = static_cast<const bf16*>(w_dx);
  a.x = static_cast<const float*>(x);
  a.mask = static_cast<const float*>(mask);
  a.wx3 = static_cast<const float*>(wx3);
  a.wa = static_cast<const float*>(wa);
  a.m_sum = static_cast<float*>(m_sum);
  a.x_out = static_cast<float*>(x_out);
  a.check = check;
  a.E = E;
  a.N = N;
  a.F1 = F1;
  a.FM = mode <= kFullSerial ? FM : 0;
  a.tiles = int(tiles);
  a.pairs = int(pairs);
  a.pieces = reinterpret_cast<float*>(base + s.pieces);
  a.count = reinterpret_cast<int*>(base + s.count);
  Launch go{&a, qm, qx, w2m, w2x, base, int(G), blocks,
            static_cast<cudaStream_t>(stream), 0};
  if (!dispatch(mode, int8, go)) return int(cudaErrorInvalidValue);
  return go.rc;
}

const char* probe_stages_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
