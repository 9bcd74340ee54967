// Phase A of the binned exact top-k, for sm_90a: each bin's maximum score,
// without writing the (B, C) scores.
//
// Replaces no pallas_call: phase A of models_tpu/ops/topk.py::binned_topk
// (:416-438, K4), which XLA fuses on the TPU into one pass that reads the
// catalog once and writes only the (B, L) bin maxima.
//
//   out[b, l] = max_{s < bs} score(b, l * bs + s)
//   score(b, c) = sum_d q[b, d] * cand[c, d]
//
// over the L = C / bs full bins of the C rows given. Candidates are fp32,
// bf16 or int8 rows. fp32 and bf16 rows take fp32 queries and fp32 sums;
// int8 rows take the int8 queries (the per-row quantization of the binned
// route) and exact int32 sums. With `scale` (C,) f32, the int8 index's
// dequantization: per_bin, the bin's max times the scale of its first row,
// one fp32 multiply (the bin-quantized index: the scale is constant within
// a bin and commutes with the max); otherwise each score times its row's
// scale before the max. An int32 sum is converted to fp32 before the max,
// which leaves the max as the plain version's: conversion rounds
// monotonically, so the max of the converted scores is the converted max.
// A NaN score gives a NaN bin maximum, as torch.amax does (fmaxf would drop
// it).
//
// Two designs, chosen by shape at plan time (ops/topk.py::bin_max_design;
// the wrapper passes the choice, and a design given shapes it does not take
// is refused, never replaced):
//
// "wgmma" (bin_max_wg), the serving paths' shapes: rows of at most 128
// elements whose pitch is a whole number of 16-byte pieces, on a 16-byte
// address, and bins of a multiple of 64 rows (D = 128 the two-tower and the
// 1M / 2^24 layers, 64 the MF, 32 YouTube-DNN).
//   - Block: CONS warpgroups of 64 query rows each; block x is (row block
//     x % row_blocks, split x / row_blocks), a split's row blocks adjacent
//     so that they walk its catalog rows together (the second read an L2
//     hit). Splits: as many as fill the card once at the occupancy it
//     reports, so each block walks a long run of whole bins and one tile's
//     epilogue overlaps the next tiles' copies. Every bin has one writer:
//     no atomics, the same bits every call.
//   - Catalog: thread 0 issues one TMA box a 128-byte slab of a 64-row tile
//     (tma_load_2d, 128-byte swizzle: 32 fp32, 64 bf16 or 128 int8 columns;
//     columns past D arrive as zeros, so narrow rows take the same box) into
//     a ring of STAGES tiles, each with a full and an empty mbarrier: the
//     first STAGES tiles at the start, then each tile into the stage of the
//     tile every warp released one tile before. The tiles go to wgmma as its
//     K-major B operand as they landed, never rewritten into another
//     layout.
//   - Query: resident for the block's life in registers, as wgmma's A
//     fragment (hopper.cuh's layout): fp32 queries split hi / lo in TF32
//     (split_tf32), or in three bf16 parts (split3_bf16) for bf16 rows, or
//     the int8 queries as they are. Products: m64n64 (one 64-row tile, one
//     bin of 64) with k8 (tf32), k16 (bf16) or k32 (s8) a step.
//   - fp32 rows, 3xTF32: q_lo c_hi + q_hi c_lo + q_hi c_hi. After a tile
//     lands, the block splits it once, in place: each value rounded to
//     TF32 (its 13 low bits zero) and the remainder into one of two lo
//     buffers, then fence.proxy.async and a block barrier; the next tile's
//     split runs before this tile's maxima are taken. wgmma drops an fp32
//     operand's 13 low bits (on an H100, a split that left the value in
//     place and wrote only its truncated remainder stayed within fp32's
//     error); the rounded split does not depend on that and was as fast.
//   - bf16 rows: the tile is the bf16 B operand straight from TMA; the three
//     bf16 parts of the query times it, each product exact in fp32 (the
//     2xTF32 form's error, on bf16 wgmma at twice TF32's rate).
//   - int8 rows: s8 x s8 into exact int32. No per-row scale: the bin's max
//     on the int32 accumulators, one conversion and (per-bin scale) one
//     multiply per (b, l). Per-row scale: each score converted and scaled
//     before the max, as the first design does.
//   - fp32 and bf16 sums: each 32 deep summed from zero by the tensor cores
//     and added to the fp32 sum (mma_tf32.cuh: the cores round toward zero),
//     so phase A keeps fp32's error against phase B (K5's 3xTF32 / 2xTF32),
//     which the bin margin needs (models_tpu/ops/topk.py:319-327).
//   - Epilogue in the accumulator layout: a thread's 16 values of each of
//     its two rows maxed as a tree (max.NaN.f32 keeps a NaN, where fmaxf
//     drops it; int32 sums as integers), two quad shuffles, a running max
//     over a bin's tiles, taken at the bin's last tile by lane t = 0. The
//     scales a tile needs are loaded before its products. fp32 and bf16
//     write each maximum at once; int8 stages a warp's 16 rows x 32 bins in
//     shared memory and writes 128 bytes of a row at a time.
//   - Time on an H100 (chip_smoke.py's phase_a_split, PERF.md): the fp32
//     and bf16 forms spend half a tile's time or more in the products; the
//     int8 form's tile is a few hundred cycles of products against its
//     waits, barriers and epilogue, which four warpgroups on one tile do not
//     hide (deeper rings, two tiles a wait, two warpgroups: no faster).
//   - Budget (the crux). Registers: 64 K of them an SM, 16 K on each of its
//     four sub-partitions. fp32 holds q_hi and q_lo (D / 2 registers each,
//     128 at D = 128), the sum and the part in flight (32 + 32): some 200 a
//     thread, so two warpgroups (8 warps, two a sub-partition: at most 255
//     each; a ninth, copying warp would cap them at 168 and spill): 128
//     query rows a block, the catalog read twice at B = 256 (the second
//     from L2). bf16 holds three parts (3 D / 4 = 96) and the same sums:
//     also two. int8 holds D / 8 = 16 and 32 int32 sums: four warpgroups
//     (at most 128 each), 256 rows, the catalog read once at B = 256.
//     Shared memory (of 227 KB): fp32 a 32 KB tile, 4 stages and two lo
//     buffers, 193 KB; bf16 16 KB, 6 stages; int8 8 KB, 8 stages and 32 KB
//     of staged maxima. A cluster of two with a multicast load would read
//     fp32 / bf16 rows once; they are bound by operations, not bytes.
//
// "mma_sync" (bin_max_kernel, the first design), every other shape: D = 130
// or 300, rows off 16-byte pieces or addresses, bins of 8, 40, ...
//   - Blocks: x a tile of 16 * nw query rows (nw warps, 16 rows each, up to
//     8), y a split of the bins. A block walks its bins' rows in tiles of TC
//     = 64 candidate rows; the catalog is streamed ceil(B / (16 nw)) times,
//     the row blocks of one split side by side in the grid so that they
//     read it from L2 together.
//   - Copies: every thread of the block copies, cp.async 16 bytes at a time
//     where rows are whole 16-byte pieces on 16-byte addresses (plain loads
//     and stores otherwise), into a ring of two stages: the next tile lands
//     while this one is scored. The query rows stay in shared memory where
//     the width padded to 32 fits a 256-deep slab; wider rows stream with
//     the tiles, slab by slab. Depths past D are zero.
//   - Products, K6's fragments (mma_tf32.cuh): a warp's 16 x 64 scores in
//     registers, mma.sync.m16n8k8 in 3xTF32 for fp32 rows, 2xTF32 for bf16
//     rows (exact in TF32: two products, the rows read as bf16 and never
//     widened in memory), each 32-deep part summed from zero and added to
//     the fp32 accumulator; int8 rows on mma.sync.m16n8k32 s8 into int32. A
//     lane reads its A and B operands as one 8-byte piece a k-step: the
//     depths A and B agree on are permuted within the k-step, which leaves
//     every sum as it is (int) or within the fragment's own order (fp32).
//   - Reduction: for bs a multiple of 64, a lane takes the max of its 16
//     scores of each of its two rows, two shuffles give the quad's (the
//     row's 64), and a running max across the bin's tiles is written by
//     lane t = 0 at the bin's last tile. Other bin sizes: the warp writes
//     its 16 x 64 scores to shared memory and 16 lanes walk them, one row
//     each, carrying the bin's running max across tiles.
//
// Bound on an H100 SXM at the bench's shape (C = 1M, D = 128, B = 256):
// operations, the 2*B*C*D = 6.55e10 of the scores as 3xTF32 (0.40 ms at
// 495 / 3 TFLOP/s) or 3xbf16 (bf16 rows: 0.20 ms at 989 / 3); int8 rows
// bytes, their 128 MB read once at 3.35 TB/s (0.038 ms; the s8 products
// take 0.033 ms at 1979 TOP/s). Before K4 the port wrote the (B, C) fp32 or int32
// scores (1.02 GB there) and read them back, and widened a bf16 catalog to
// fp32 on every call.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int TC = 64;        // candidate rows per tile
constexpr int NJ = TC / 8;    // n-tiles of a warp's 16 x TC scores
constexpr int WARPS_MAX = 8;  // warps a block, 16 query rows each
constexpr int STAGES = 2;
constexpr int SLAB = 256;     // widest depth a stage holds
constexpr int SLD = TC + 8;   // score buffer row stride (floats)
constexpr unsigned FULL = 0xffffffffu;

// The storage of a candidate row, its query rows' type, and the bytes
// after a shared candidate row (PAD; int8 rows are padded to 32 bytes mod
// 128 instead: an 8-byte read a lane, conflict-free a half warp).
template <typename T>
struct Rows;

template <>
struct Rows<float> {
  using Q = float;
  static constexpr int PAD = 32;
  // the values at depths 2t and 2t + 1, as TF32 operands
  __device__ static void pair(const char* p, uint32_t& x, uint32_t& y) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x = __float_as_uint(v.x);
    y = __float_as_uint(v.y);
  }
};

template <>
struct Rows<uint16_t> {  // bf16, its raw bits
  using Q = float;
  static constexpr int PAD = 16;
  __device__ static void pair(const char* p, uint32_t& x, uint32_t& y) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    x = w << 16;
    y = w & 0xffff0000u;
  }
};

template <>
struct Rows<int8_t> {
  using Q = int8_t;
  static constexpr int PAD = 0;
};

// The shapes one launch runs at, the same on the host and on the card.
struct Geo {
  int qres;    // the query rows stay in shared memory for the whole walk
  int slab;    // depth of a stage: the width padded to 32, or SLAB when cut
  int nslab;   // stages a tile
  int ldq;     // bytes of a shared query row
  int ldc;     // bytes of a shared candidate row
  int qbytes;  // bytes of the block's query rows (one slab)
  int stage;   // bytes of one stage: the tile (and the query slab)
  int wbytes;  // bytes of a warp's score buffer (other bin sizes only)
};

template <typename T>
__host__ __device__ Geo geometry(int D, int nw, bool rows_form) {
  Geo g;
  const int dw = (D + 31) / 32 * 32;
  g.qres = dw <= SLAB;
  g.slab = g.qres ? dw : SLAB;
  g.nslab = (dw + g.slab - 1) / g.slab;
  if (std::is_same<T, int8_t>::value) {
    g.ldq = g.ldc = g.slab + ((32 - g.slab) % 128 + 128) % 128;  // 32 bytes mod 128
  } else {
    g.ldq = (g.slab + 8) * 4;  // 8 words mod 32 banks
    g.ldc = g.slab * (int)sizeof(T) + Rows<T>::PAD;
  }
  g.qbytes = 16 * nw * g.ldq;
  g.stage = TC * g.ldc + (g.qres ? 0 : g.qbytes);
  g.wbytes = rows_form ? 16 * SLD * 4 : 0;
  return g;
}

size_t smem_bytes(const Geo& g, int nw) {
  return (g.qres ? (size_t)g.qbytes : 0) + (size_t)STAGES * g.stage + (size_t)nw * g.wbytes;
}

// rows [r0, r0 + rows) x depths [d0, d0 + w) of a (n, D) matrix of E into
// shared rows of `ld` bytes, by every thread of the block; rows at or past
// r_end and depths at or past D are zero. vec: D * sizeof(E) % 16 == 0 and
// src 16-byte aligned: cp.async of 16 bytes (zero-filled where out of
// range); otherwise plain loads and stores.
template <typename E>
__device__ __forceinline__ void load_rows(char* dst, int ld, const E* __restrict__ src, int r0,
                                          int rows, int r_end, int D, int d0, int w, bool vec) {
  if (vec) {
    constexpr int PER = 16 / (int)sizeof(E);
    const int P = w / PER;
    for (int i = threadIdx.x; i < rows * P; i += blockDim.x) {
      const int r = i / P, e = (i - r * P) * PER, c = d0 + e;
      const bool ok = r0 + r < r_end && c < D;
      cp_async16(dst + r * ld + e * (int)sizeof(E), ok ? src + (size_t)(r0 + r) * D + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
      const int r = i / w, e = i - r * w, c = d0 + e;
      const bool ok = r0 + r < r_end && c < D;
      reinterpret_cast<E*>(dst + r * ld)[e] = ok ? src[(size_t)(r0 + r) * D + c] : E(0);
    }
  }
}

// acc += the warp's 16 x TC scores over `width` depths: query rows qw
// (shared, fp32, ldq bytes a row), candidate rows cs (shared, ldc bytes a
// row). Element e of acc[j] is query row g + 8 (e >> 1), candidate 8j + 2t
// + (e & 1). Within each k-step of 8 the logical depths t and t + 4 read
// the physical depths 2t and 2t + 1 (streaming_topk.cu's scheme).
template <typename T>
__device__ __forceinline__ void products(float (&acc)[NJ][4], const char* qw, int ldq,
                                         const char* cs, int ldc, int width, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* qa = reinterpret_cast<const float*>(qw + g * ldq) + 2 * t;
  const float* qb = reinterpret_cast<const float*>(qw + (g + 8) * ldq) + 2 * t;
  const char* cb = cs + g * ldc + 2 * t * (int)sizeof(T);
  for (int k0 = 0; k0 < width; k0 += 32) {
    float part[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
    for (int kd = k0; kd < k0 + 32; kd += 8) {
      const float2 x = *reinterpret_cast<const float2*>(qa + kd);
      const float2 y = *reinterpret_cast<const float2*>(qb + kd);
      uint32_t ab[4], al[4];
      split_tf32(x.x, ab[0], al[0]);
      split_tf32(y.x, ab[1], al[1]);
      split_tf32(x.y, ab[2], al[2]);
      split_tf32(y.y, ab[3], al[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b[2];  // b0 (t, g), b1 (t + 4, g): candidate 8j + g
        Rows<T>::pair(cb + 8 * j * ldc + kd * (int)sizeof(T), b[0], b[1]);
        if constexpr (std::is_same<T, float>::value) {
          uint32_t bb[2], bl[2];
          split_tf32(__uint_as_float(b[0]), bb[0], bl[0]);
          split_tf32(__uint_as_float(b[1]), bb[1], bl[1]);
          mma_3xtf32(part[j], ab, al, bb, bl);
        } else {
          mma_2xtf32(part[j], ab, al, b);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

// The int8 form: exact int32 sums on mma.sync.m16n8k32. Lane t reads the 8
// bytes at physical depths 8t .. 8t + 7 of each 32-deep k-step as its
// logical depths 4t.. (a0, a1, b0) and 4t + 16.. (a2, a3, b1).
__device__ __forceinline__ void products_s8(int (&acc)[NJ][4], const char* qw, int ldq,
                                            const char* cs, int ldc, int width, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const char* qa = qw + g * ldq + 8 * t;
  const char* qb = qa + 8 * ldq;
  const char* cb = cs + g * ldc + 8 * t;
  for (int kd = 0; kd < width; kd += 32) {
    const uint2 x = *reinterpret_cast<const uint2*>(qa + kd);
    const uint2 y = *reinterpret_cast<const uint2*>(qb + kd);
    const uint32_t a[4] = {x.x, y.x, x.y, y.y};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint2 v = *reinterpret_cast<const uint2*>(cb + 8 * j * ldc + kd);
      const uint32_t b[2] = {v.x, v.y};
      mma_s8(acc[j], a, b);
    }
  }
}

// the larger of two scores, NaN if either is (torch.amax's rule; fmaxf
// would drop it): max.NaN, one instruction
__device__ __forceinline__ float nanmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int x) { return __int2float_rn(x); }

// Block (x: 16 nw query rows from row0, y: bins [bin0, bin1)). Dynamic
// shared memory: the resident query rows (qres), STAGES stages, each warp's
// score buffer (other bin sizes).
template <typename T>
__global__ void __launch_bounds__(WARPS_MAX * 32)
bin_max_kernel(const void* __restrict__ qv, const T* __restrict__ cand,
               const float* __restrict__ scale, int per_bin, float* __restrict__ out, int B,
               int D, int L, int bs, int bins_per_split, int vq, int vc) {
  using Q = typename Rows<T>::Q;
  using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;
  extern __shared__ __align__(16) char smem[];
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, g = lane >> 2;
  const int row0 = blockIdx.x * 16 * nw;
  const int bin0 = blockIdx.y * bins_per_split;
  const int bin1 = min(bin0 + bins_per_split, L);
  if (bin0 >= bin1) return;  // block-uniform
  const int r_begin = bin0 * bs, r_end = bin1 * bs;
  const bool rows_form = bs % TC != 0;
  const Geo geo = geometry<T>(D, nw, rows_form);
  const Q* q = static_cast<const Q*>(qv);
  char* q_res = smem;
  char* stages = smem + (geo.qres ? geo.qbytes : 0);
  float* sbuf = reinterpret_cast<float*>(stages + STAGES * geo.stage) + warp * 16 * SLD;
  const int ntiles = (r_end - r_begin + TC - 1) / TC;
  const int steps = ntiles * geo.nslab;
  const bool active = row0 + 16 * warp < B;  // warp-uniform: the warp has a row below B

  auto fetch = [&](int st) {
    const int ti = st / geo.nslab, si = st - ti * geo.nslab;
    char* sg = stages + (st % STAGES) * geo.stage;
    if (st == 0 && geo.qres)
      load_rows<Q>(q_res, geo.ldq, q, row0, 16 * nw, B, D, 0, geo.slab, vq);
    load_rows<T>(sg, geo.ldc, cand, r_begin + ti * TC, TC, r_end, D, si * geo.slab, geo.slab,
                 vc);
    if (!geo.qres)
      load_rows<Q>(sg + TC * geo.ldc, geo.ldq, q, row0, 16 * nw, B, D, si * geo.slab, geo.slab,
                   vq);
    cp_async_commit();
  };
  // the bin's score of a row, finished: the per-bin scale where one is given
  auto finish = [&](float m, int bin) {
    return scale && per_bin ? __fmul_rn(m, __ldg(scale + (size_t)bin * bs)) : m;
  };

  Acc acc[NJ][4];
  float run[2] = {0.f, 0.f};  // the fragment form: rows g and g + 8's running max
  float rrun = 0.f;           // the rows form: row `lane`'s running max,
  int rbin = bin0, rcnt = 0;  // its bin and the bin's rows seen
  fetch(0);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st landed; every warp is done with stage st - 1
    if (st + 1 < steps) fetch(st + 1);
    if (!active) continue;
    const int ti = st / geo.nslab, si = st - ti * geo.nslab;
    const char* sg = stages + (st % STAGES) * geo.stage;
    const char* qw = (geo.qres ? q_res : sg + TC * geo.ldc) + 16 * warp * geo.ldq;
    if (si == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = Acc(0);
    }
    if constexpr (std::is_same<T, int8_t>::value)
      products_s8(acc, qw, geo.ldq, sg, geo.ldc, geo.slab, lane);
    else
      products<T>(acc, qw, geo.ldq, sg, geo.ldc, geo.slab, lane);
    if (si != geo.nslab - 1) continue;

    // the tile's scores in fp32, each row's scale where it is per row
    const int c0 = r_begin + ti * TC;
    float v[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * j + 2 * t + (e & 1);
        float x = to_f32(acc[j][e]);
        if (scale && !per_bin && c < r_end) x = __fmul_rn(x, __ldg(scale + c));
        v[j][e] = x;
      }
    if (!rows_form) {
      float m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = v[0][2 * h];
#pragma unroll
        for (int j = 0; j < NJ; ++j) m[h] = nanmax(nanmax(m[h], v[j][2 * h]), v[j][2 * h + 1]);
        m[h] = nanmax(m[h], __shfl_xor_sync(FULL, m[h], 1));
        m[h] = nanmax(m[h], __shfl_xor_sync(FULL, m[h], 2));
      }
      const int tiles_per_bin = bs / TC, k = ti % tiles_per_bin;
#pragma unroll
      for (int h = 0; h < 2; ++h) run[h] = k == 0 ? m[h] : nanmax(run[h], m[h]);
      if (k == tiles_per_bin - 1 && t == 0) {
        const int bin = bin0 + ti / tiles_per_bin;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = row0 + 16 * warp + g + 8 * h;
          if (b < B) out[(size_t)b * L + bin] = finish(run[h], bin);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        *reinterpret_cast<float2*>(sbuf + g * SLD + 8 * j + 2 * t) = make_float2(v[j][0], v[j][1]);
        *reinterpret_cast<float2*>(sbuf + (g + 8) * SLD + 8 * j + 2 * t) =
            make_float2(v[j][2], v[j][3]);
      }
      __syncwarp();
      if (lane < 16) {
        const float* srow = sbuf + lane * SLD;
        const int n = min(TC, r_end - c0);
        const int b = row0 + 16 * warp + lane;
        for (int i = 0; i < n; ++i) {
          rrun = rcnt == 0 ? srow[i] : nanmax(rrun, srow[i]);
          if (++rcnt == bs) {
            if (b < B) out[(size_t)b * L + rbin] = finish(rrun, rbin);
            ++rbin;
            rcnt = 0;
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// The wgmma design
// ---------------------------------------------------------------------------

constexpr int WG_TN = 64;             // catalog rows a tile: wgmma's N, one bin of 64
constexpr int WG_SLAB = WG_TN * 128;  // a tile's 128 bytes of depth, swizzled: one TMA box
constexpr int WG_LO = 2;              // fp32's lo buffers
constexpr int WG_OUT = 32;            // bins of maxima a warp stages before writing them

// warpgroups a block (at most), ring stages, bytes an element
template <typename T>
struct Wg;
template <>
struct Wg<float> {
  static constexpr int CONS = 2, STAGES = 4, SIZE = 4;
};
template <>
struct Wg<uint16_t> {
  static constexpr int CONS = 2, STAGES = 6, SIZE = 2;
};
template <>
struct Wg<int8_t> {
  static constexpr int CONS = 4, STAGES = 8, SIZE = 1;
};

// slabs of a tile and 32-byte k-steps (k8 tf32, k16 bf16, k32 s8) at the
// padded width DP
template <typename T, int DP>
__host__ __device__ constexpr int wg_slabs() {
  return (DP * Wg<T>::SIZE + 127) / 128;
}
template <typename T, int DP>
__host__ __device__ constexpr int wg_ksteps() {
  return DP * Wg<T>::SIZE / 32;
}
template <typename T, int DP>
__host__ __device__ constexpr int wg_stage_bytes() {
  return wg_slabs<T, DP>() * WG_SLAB;
}

// 1024 bytes of slack to align the tiles for the swizzle, the ring, fp32's
// lo buffers, a full and an empty barrier a stage, int8's staged maxima
template <typename T, int DP>
__host__ __device__ constexpr size_t wg_smem() {
  return 1024 + (size_t)(Wg<T>::STAGES + (std::is_same<T, float>::value ? WG_LO : 0)) *
                    wg_stage_bytes<T, DP>() +
         2 * Wg<T>::STAGES * 8 +
         (std::is_same<T, int8_t>::value ? (size_t)Wg<T>::CONS * 4 * 16 * WG_OUT * 4 : 0);
}

// the descriptor offset of k-step k within a tile: slab k / 4, 32 bytes a step
__device__ __forceinline__ uint64_t kstep_off(int k) {
  return (uint64_t)(((k >> 2) * WG_SLAB + (k & 3) * 32) >> 4);
}

// D (+)= A B, m64n64, A from registers (hopper.cuh's fragment), B a K-major
// tile in the 128-byte swizzle; scale_d 0 starts D from zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fence_regs_i(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// mbar_wait that traps once it has waited 2^35 cycles (some 18 s): a fault
// in the ring ends the launch with an error instead of holding the card
__device__ __forceinline__ void ring_wait(uint64_t* bar, int parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (!t0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 35))
      __trap();
  }
}

// The query fragments a thread holds for the block's life: rows ra and
// ra + 8, zero past B and past D.
template <typename T, int DP>
struct QueryFrags;

template <int DP>
struct QueryFrags<float, DP> {  // fp32 rows: hi and lo in TF32
  static constexpr int KS = wg_ksteps<float, DP>();
  uint32_t hi[KS][4], lo[KS][4];
  __device__ __forceinline__ void load(const float* q, int B, int D, int ra, int t) {
    auto at = [&](int r, int d) { return r < B && d < D ? q[(size_t)r * D + d] : 0.f; };
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int d0 = 8 * k + t;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(at(ra + 8 * (i & 1), d0 + 4 * (i >> 1)), hi[k][i], lo[k][i]);
    }
  }
};

template <int DP>
struct QueryFrags<uint16_t, DP> {  // bf16 rows: the fp32 query in three bf16 parts
  static constexpr int KS = wg_ksteps<uint16_t, DP>();
  uint32_t part[3][KS][4];  // hi, mid, lo
  __device__ __forceinline__ void load(const float* q, int B, int D, int ra, int t) {
    auto at = [&](int r, int d) { return r < B && d < D ? q[(size_t)r * D + d] : 0.f; };
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ra + 8 * (i & 1), d = 16 * k + 2 * t + 8 * (i >> 1);
        split3_bf16(at(r, d), at(r, d + 1), part[0][k][i], part[1][k][i], part[2][k][i]);
      }
  }
};

template <int DP>
struct QueryFrags<int8_t, DP> {  // int8 rows: the int8 queries, four a register
  static constexpr int KS = wg_ksteps<int8_t, DP>();
  uint32_t a[KS][4];
  __device__ __forceinline__ void load(const int8_t* q, int B, int D, int ra, int t) {
    auto at = [&](int r, int d) {
      return r < B && d < D ? (uint32_t)(uint8_t)q[(size_t)r * D + d] : 0u;
    };
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ra + 8 * (i & 1), d = 32 * k + 4 * t + 16 * (i >> 1);
        a[k][i] = at(r, d) | at(r, d + 1) << 8 | at(r, d + 2) << 16 | at(r, d + 3) << 24;
      }
  }
};

// S = the warpgroup's 64 x 64 sums of the tile at descriptor ds (fp32: its
// lo part at dl), each 32 deep summed from zero and added in depth order
template <int DP>
__device__ __forceinline__ void wg_products(float (&S)[32], const QueryFrags<float, DP>& f,
                                            uint64_t ds, uint64_t dl) {
  float P[32];
#pragma unroll
  for (int p = 0; p < DP / 32; ++p) {
    fence_regs(P);
    wgmma_fence();
#pragma unroll
    for (int k = 4 * p; k < 4 * p + 4; ++k) {
      const uint64_t off = kstep_off(k);
      wgmma_tf32(P, f.lo[k], ds + off, k != 4 * p);  // q_lo c_hi
      wgmma_tf32(P, f.hi[k], dl + off, 1);           // q_hi c_lo
      wgmma_tf32(P, f.hi[k], ds + off, 1);           // q_hi c_hi
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(P);
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] = p == 0 ? P[i] : S[i] + P[i];
  }
}

template <int DP>
__device__ __forceinline__ void wg_products(float (&S)[32], const QueryFrags<uint16_t, DP>& f,
                                            uint64_t ds, uint64_t) {
  float P[32];
#pragma unroll
  for (int p = 0; p < DP / 32; ++p) {
    fence_regs(P);
    wgmma_fence();
#pragma unroll
    for (int k = 2 * p; k < 2 * p + 2; ++k) {
      const uint64_t off = kstep_off(k);
      wgmma_bf16(P, f.part[2][k], ds + off, k != 2 * p);  // the small parts first
      wgmma_bf16(P, f.part[1][k], ds + off, 1);
      wgmma_bf16(P, f.part[0][k], ds + off, 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(P);
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] = p == 0 ? P[i] : S[i] + P[i];
  }
}

template <int DP>
__device__ __forceinline__ void wg_products(int (&S)[32], const QueryFrags<int8_t, DP>& f,
                                            uint64_t ds, uint64_t) {
  fence_regs_i(S);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < QueryFrags<int8_t, DP>::KS; ++k) wgmma_s8(S, f.a[k], ds + kstep_off(k), k);
  wgmma_commit();
  wgmma_wait();
  fence_regs_i(S);
}

// fp32's split of 16-byte pieces [i0, i1) of a landed tile, by every
// thread of the block: each value rounded to TF32 in place, its remainder
// to `lo` at the same offset (the swizzle is the same)
__device__ __forceinline__ void split_tile(unsigned char* tile, unsigned char* lo, int i0,
                                           int i1) {
  float4* t4 = reinterpret_cast<float4*>(tile);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll 4
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const float4 v = t4[i];
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    t4[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                        __uint_as_float(h[3]));
    l4[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                        __uint_as_float(l[3]));
  }
}

__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return nanmax(a, b); }

// the max of v[0 .. 16) as a tree (four levels, not a chain of fifteen)
template <typename V>
__device__ __forceinline__ V tree_max(V (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = vmax(v[i], v[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = vmax(v[i], v[i + 4]);
#pragma unroll
  for (int i = 0; i < 2; ++i) v[i] = vmax(v[i], v[i + 2]);
  return vmax(v[0], v[1]);
}

// the 16 per-row scales of a thread's columns of the tile from c0
__device__ __forceinline__ void load_scales(const float* __restrict__ scale, int c0, int t,
                                            float (&sc)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) sc[2 * j + e] = __ldg(scale + c0 + 8 * j + 2 * t + e);
}

// The max of a thread's two rows (h = 0: row ra, 1: ra + 8) over the tile's
// 64 columns, finished across the quad: each score scaled first where the
// scale is per row (sc, the thread's columns' scales); int32 sums maxed as
// integers otherwise (then one conversion: it rounds monotonically)
template <typename A>
__device__ __forceinline__ void tile_max(const A (&S)[32], bool row_scale, const float (&sc)[16],
                                         float (&m)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row_scale) {
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        v[i] = __fmul_rn(to_f32(S[4 * (i >> 1) + 2 * h + (i & 1)]), sc[i]);
      m[h] = tree_max(v);
    } else {
      A v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = S[4 * (i >> 1) + 2 * h + (i & 1)];
      m[h] = to_f32(tree_max(v));
    }
    m[h] = nanmax(m[h], __shfl_xor_sync(FULL, m[h], 1));
    m[h] = nanmax(m[h], __shfl_xor_sync(FULL, m[h], 2));
  }
}

// Block x: (row block x % row_blocks: 64 rows a warpgroup, split x /
// row_blocks: bins [bin0, bin1)). cmap: the catalog's L * bs rows as boxes
// of 128 bytes by 64 rows, 128-byte swizzle; nslabs: the slabs that hold
// depths below D (the others of every stage are zeroed once). Thread 0
// keeps the ring full: tiles 0 .. STAGES - 1 first, then at tile it, once
// every warp has released tile it - 1, tile it - 1 + STAGES into its stage.
// (A ninth, copying warp would put three warps on one of the SM's four
// sub-partitions and cap a thread at 168 registers; fp32 needs some 200.)
template <typename T, int DP>
__global__ void __launch_bounds__(Wg<T>::CONS * 128, 1)
bin_max_wg(const __grid_constant__ CUtensorMap cmap, const void* __restrict__ qv,
           const float* __restrict__ scale, int per_bin, float* __restrict__ out, int B, int D,
           int L, int bs, int bins_per_split, int row_blocks, int nslabs) {
  using W = Wg<T>;
  using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int SL = wg_slabs<T, DP>(), STAGE = wg_stage_bytes<T, DP>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* lo_buf = ring + W::STAGES * STAGE;  // fp32: WG_LO tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_buf + (F32 ? WG_LO * STAGE : 0));
  uint64_t* empty = full + W::STAGES;
  const int nthreads = blockDim.x, cons = nthreads >> 7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x % row_blocks) * 64 * cons;
  const int bin0 = (blockIdx.x / row_blocks) * bins_per_split;
  const int bin1 = min(bin0 + bins_per_split, L);
  const int per = bs / WG_TN;  // tiles a bin
  const int ntiles = (bin1 - bin0) * per;
  if (threadIdx.x == 0) {
    for (int i = 0; i < W::STAGES; ++i) {
      mbar_init(full + i, 1);          // the copying thread, and its expected bytes
      mbar_init(empty + i, 4 * cons);  // lane 0 of each warp
    }
    mbar_init_fence();
  }
  if (nslabs < SL) {
    const int tiles = W::STAGES + (F32 ? WG_LO : 0), per_tile = (SL - nslabs) * WG_SLAB / 16;
    for (int i = threadIdx.x; i < tiles * per_tile; i += nthreads)
      reinterpret_cast<float4*>(ring + (i / per_tile) * STAGE + nslabs * WG_SLAB)[i % per_tile] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    fence_proxy_async();
  }
  __syncthreads();
  if (ntiles <= 0) return;  // block-uniform
  const int c_begin = bin0 * bs;
  auto issue = [&](int tile) {  // thread 0: one tile into its stage
    const int st = tile % W::STAGES;
    mbar_arrive_expect(full + st, nslabs * WG_SLAB);
    for (int s = 0; s < nslabs; ++s)
      tma_load_2d(ring + st * STAGE + s * WG_SLAB, &cmap, s * (128 / W::SIZE),
                  c_begin + tile * WG_TN, full + st);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < W::STAGES && i < ntiles; ++i) issue(i);

  const int g = lane >> 2, t = lane & 3;
  const int ra = row0 + 64 * (warp >> 2) + 16 * (warp & 3) + g;  // rows ra, ra + 8
  QueryFrags<T, DP> frags;
  frags.load(static_cast<const typename Rows<T>::Q*>(qv), B, D, ra, t);
  const uint64_t d_ring = wgmma_desc(ring, 16, 1024);
  const uint64_t d_lo = wgmma_desc(lo_buf, 16, 1024);
  const bool row_scale = scale && !per_bin;
  if constexpr (F32) {
    ring_wait(full, 0);
    split_tile(ring, lo_buf, 0, nslabs * WG_SLAB / 16);
    fence_proxy_async();
    __syncthreads();
  }
  // int8 stages each warp's 16 rows x WG_OUT bins of maxima and writes them
  // WG_OUT bins of a row at a time (128 bytes) instead of 4 bytes a row and
  // bin; fp32 and bf16 write each maximum as it is taken (staging measured
  // slower there)
  constexpr bool STAGE_OUT = std::is_same<T, int8_t>::value;
  float* staged = reinterpret_cast<float*>(empty + W::STAGES) + warp * 16 * WG_OUT;
  const int r_warp = row0 + 64 * (warp >> 2) + 16 * (warp & 3);
  int n_staged = 0, staged_bin0 = bin0;
  auto flush = [&]() {
    __syncwarp();
#pragma unroll 4
    for (int r = 0; r < 16; ++r)
      if (lane < n_staged && r_warp + r < B)
        out[(size_t)(r_warp + r) * L + staged_bin0 + lane] = staged[r * WG_OUT + lane];
    __syncwarp();
    staged_bin0 += n_staged;
    n_staged = 0;
  };
  float run[2] = {0.f, 0.f};  // rows ra, ra + 8: the bin's running max
  int k = 0, bin = bin0;      // tile it is tile k of bin `bin`
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % W::STAGES;
    const int c0 = c_begin + it * WG_TN;
    // the scales this tile needs, loaded before its products
    float sc[16];
    if (row_scale) load_scales(scale, c0, t, sc);
    const float sc_bin = scale && per_bin && k == per - 1 ? __ldg(scale + (size_t)bin * bs) : 1.f;
    if constexpr (!F32) ring_wait(full + st, (it / W::STAGES) & 1);
    Acc S[32];
    wg_products<DP>(S, frags, d_ring + (uint64_t)((st * STAGE) >> 4),
                    d_lo + (uint64_t)(((it & 1) * STAGE) >> 4));
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
    if (threadIdx.x == 0 && it >= 1 && it - 1 + W::STAGES < ntiles) {
      ring_wait(empty + (it - 1) % W::STAGES, ((it - 1) / W::STAGES) & 1);
      issue(it - 1 + W::STAGES);
    }
    __syncwarp();
    if constexpr (F32) {
      if (it + 1 < ntiles) {  // the next tile's split, before this tile's maxima
        const int nx = (it + 1) % W::STAGES;
        ring_wait(full + nx, ((it + 1) / W::STAGES) & 1);
        split_tile(ring + nx * STAGE, lo_buf + ((it + 1) & 1) * STAGE, 0,
                   nslabs * WG_SLAB / 16);
        fence_proxy_async();
      }
    }
    float m[2];
    tile_max(S, row_scale, sc, m);
#pragma unroll
    for (int h = 0; h < 2; ++h) run[h] = k == 0 ? m[h] : nanmax(run[h], m[h]);
    if (++k == per) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = scale && per_bin ? __fmul_rn(run[h], sc_bin) : run[h];
        if constexpr (STAGE_OUT) {
          if (t == 0) staged[(g + 8 * h) * WG_OUT + n_staged] = v;
        } else {
          const int b = ra + 8 * h;
          if (t == 0 && b < B) out[(size_t)b * L + bin] = v;
        }
      }
      if constexpr (STAGE_OUT)
        if (++n_staged == WG_OUT) flush();
      k = 0;
      ++bin;
    }
    if constexpr (F32) __syncthreads();  // the next tile is split everywhere
  }
  if constexpr (STAGE_OUT)
    if (n_staged) flush();
}

// ---------------------------------------------------------------------------
// Plans and launches
// ---------------------------------------------------------------------------

constexpr int DESIGN_MMA = 0, DESIGN_WG = 1;

// The launch: threads a block (mma_sync: 32 a warp of 16 query rows;
// wgmma: 128 a warpgroup of 64), the query
// rows of a block, the reduction (mma_sync), ring stages, the bins' split,
// shared memory.
struct Plan {
  int threads, query_tile, rows_form, stages, row_blocks, splits, bins_per_split;
  size_t smem;
};

// The host's work of a launch is cached, since a 256-row request is bound
// by it: the card's SMs and shared memory a block, read once a device; a
// kernel's blocks an SM, once a device and block shape (its shared-memory
// limit raised as launches need); the catalog's tensor map, once an
// (address, rows, width).
constexpr int MAX_DEVICES = 64, CACHED = 64;

cudaError_t device_info(int* sms, int* smem_max) {
  static std::mutex mu;
  static int seen_sms[MAX_DEVICES], seen_smem[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (!seen_sms[dev]) {
    int a = 0, b = 0;
    err = cudaDeviceGetAttribute(&b, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&a, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    seen_smem[dev] = b;
    seen_sms[dev] = a;
  }
  *sms = seen_sms[dev];
  *smem_max = seen_smem[dev];
  return cudaSuccess;
}

// blocks of `fn` an SM at `threads` and `smem` bytes of dynamic shared
// memory, its limit on this device raised to `smem` first where it is lower
// (never lowered: a cached plan may launch with more)
cudaError_t blocks_per_sm(const void* fn, int threads, size_t smem, int* per_sm) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> limits;
  static std::map<std::tuple<int, const void*, int, size_t>, int> fits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(mu);
  const auto key = std::make_tuple(dev, fn, threads, smem);
  const auto hit = fits.find(key);
  if (hit != fits.end()) {
    *per_sm = hit->second;
    return cudaSuccess;
  }
  size_t& limit = limits[{dev, fn}];
  if (limit < smem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    limit = smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads, smem);
  if (err == cudaSuccess) fits[key] = *per_sm;
  return err;
}

// as many (row block, split) blocks as the card holds at once, at least one
// split and at most one a bin
void fill_splits(Plan* p, int per_sm, int sms, int L, int max_splits) {
  int splits = per_sm * sms / p->row_blocks;
  splits = splits < 1 ? 1 : splits > L ? L : splits > max_splits ? max_splits : splits;
  p->bins_per_split = (L + splits - 1) / splits;
  p->splits = (L + p->bins_per_split - 1) / p->bins_per_split;
}

template <typename T>
cudaError_t make_plan(int B, int D, int L, int bs, Plan* p) {
  int sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t err = device_info(&sms, &smem_max);
  if (err != cudaSuccess) return err;
  // as many warps as the rows need (at most 8), fewer where shared memory
  // does not hold them
  p->rows_form = bs % TC != 0;
  int nw = 0;
  const int want = (B + 15) / 16 < WARPS_MAX ? (B + 15) / 16 : WARPS_MAX;
  for (int w = want; w >= 1 && !nw; --w) {
    const size_t bytes = smem_bytes(geometry<T>(D, w, p->rows_form), w);
    if (bytes <= (size_t)smem_max) {
      nw = w;
      p->smem = bytes;
    }
  }
  if (!nw) return cudaErrorInvalidValue;
  err = blocks_per_sm((const void*)bin_max_kernel<T>, 32 * nw, p->smem, &per_sm);
  if (err != cudaSuccess) return err;
  p->threads = 32 * nw;
  p->query_tile = 16 * nw;
  p->stages = STAGES;
  p->row_blocks = (B + p->query_tile - 1) / p->query_tile;
  fill_splits(p, per_sm, sms, L, 65535);
  return cudaSuccess;
}

template <typename T, int DP>
cudaError_t make_plan_wg(int B, int L, Plan* p) {
  int sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t err = device_info(&sms, &smem_max);
  if (err != cudaSuccess) return err;
  const int cons = (B + 63) / 64 < Wg<T>::CONS ? (B + 63) / 64 : Wg<T>::CONS;
  p->threads = 128 * cons;
  p->query_tile = 64 * cons;
  p->rows_form = 0;
  p->stages = Wg<T>::STAGES;
  p->smem = wg_smem<T, DP>();
  if (p->smem > (size_t)smem_max) return cudaErrorInvalidValue;
  err = blocks_per_sm((const void*)bin_max_wg<T, DP>, p->threads, p->smem, &per_sm);
  if (err != cudaSuccess) return err;
  p->row_blocks = (B + p->query_tile - 1) / p->query_tile;
  fill_splits(p, per_sm, sms, L, 1 << 30);
  return cudaSuccess;
}

int elem_bytes(int cand_dtype) { return cand_dtype == 0 ? 4 : cand_dtype == 1 ? 2 : 1; }

// the padded width of the wgmma design, 0 where it does not take the shapes
int wg_width(int cand_dtype, int D, int bs) {
  if (D < 1 || D > 128 || D * elem_bytes(cand_dtype) % 16 != 0 || bs % WG_TN != 0) return 0;
  return D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

template <typename T>
cudaError_t make_plan_wg_dp(int dp, int B, int L, Plan* p) {
  return dp == 32 ? make_plan_wg<T, 32>(B, L, p)
       : dp == 64 ? make_plan_wg<T, 64>(B, L, p)
                  : make_plan_wg<T, 128>(B, L, p);
}

cudaError_t plan_for(int cand_dtype, int design, int B, int D, int L, int bs, Plan* p) {
  if (B < 1 || D < 1 || L < 1 || bs < 1 || cand_dtype < 0 || cand_dtype > 2)
    return cudaErrorInvalidValue;
  if (design == DESIGN_WG) {
    const int dp = wg_width(cand_dtype, D, bs);
    if (!dp) return cudaErrorInvalidValue;  // shapes the design does not take
    if (cand_dtype == 0) return make_plan_wg_dp<float>(dp, B, L, p);
    if (cand_dtype == 1) return make_plan_wg_dp<uint16_t>(dp, B, L, p);
    return make_plan_wg_dp<int8_t>(dp, B, L, p);
  }
  if (design != DESIGN_MMA) return cudaErrorInvalidValue;
  if (cand_dtype == 0) return make_plan<float>(B, D, L, bs, p);
  if (cand_dtype == 1) return make_plan<uint16_t>(B, D, L, bs, p);
  return make_plan<int8_t>(B, D, L, bs, p);
}

template <typename T>
cudaError_t launch(const Plan& p, const void* q, const void* cand, const float* scale,
                   int per_bin, float* out, int B, int D, int L, int bs, cudaStream_t stream) {
  using Q = typename Rows<T>::Q;
  const int vq = (D * (int)sizeof(Q)) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int vc = (D * (int)sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(cand) % 16 == 0;
  const dim3 grid(p.row_blocks, p.splits);
  bin_max_kernel<T><<<grid, p.threads, p.smem, stream>>>(
      q, static_cast<const T*>(cand), scale, per_bin, out, B, D, L, bs, p.bins_per_split, vq, vc);
  return cudaGetLastError();
}

// the catalog's rows as boxes of 128 bytes by 64 rows in the 128-byte
// swizzle; columns past D read as zeros. A map depends on nothing but its
// key (address, rows, width), so a cached one is never stale.
template <typename T>
cudaError_t cand_map(CUtensorMap* map, const void* base, int rows, int D) {
  struct Cached { const void* base; int rows, D; CUtensorMap map; };
  static std::mutex mu;
  static Cached seen[CACHED];
  static int n = 0;
  std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < n && i < CACHED; ++i)
    if (seen[i].base == base && seen[i].rows == rows && seen[i].D == D) {
      *map = seen[i].map;
      return cudaSuccess;
    }
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const CUtensorMapDataType type = std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : std::is_same<T, uint16_t>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)WG_TN};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  Cached& c = seen[n++ % CACHED];
  c.base = base;
  c.rows = rows;
  c.D = D;
  c.map = *map;
  return cudaSuccess;
}

template <typename T, int DP>
cudaError_t launch_wg(const Plan& p, const void* q, const void* cand, const float* scale,
                      int per_bin, float* out, int B, int D, int L, int bs,
                      cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(cand) % 16 != 0) return cudaErrorInvalidValue;  // TMA's rule
  CUtensorMap map;
  cudaError_t err = cand_map<T>(&map, cand, L * bs, D);
  if (err != cudaSuccess) return err;
  const int nslabs = (D * (int)sizeof(T) + 127) / 128;
  bin_max_wg<T, DP><<<p.row_blocks * p.splits, p.threads, p.smem, stream>>>(
      map, q, scale, per_bin, out, B, D, L, bs, p.bins_per_split, p.row_blocks, nslabs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wg_dp(int dp, const Plan& p, const void* q, const void* cand,
                         const float* scale, int per_bin, float* out, int B, int D, int L, int bs,
                         cudaStream_t stream) {
  return dp == 32 ? launch_wg<T, 32>(p, q, cand, scale, per_bin, out, B, D, L, bs, stream)
       : dp == 64 ? launch_wg<T, 64>(p, q, cand, scale, per_bin, out, B, D, L, bs, stream)
                  : launch_wg<T, 128>(p, q, cand, scale, per_bin, out, B, D, L, bs, stream);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// How bin_max launches for these shapes with design 0 (mma_sync) or 1
// (wgmma), a report: info[0..7] = threads a block, query rows a block,
// whether it reduces through shared memory (mma_sync, bin sizes other than
// multiples of 64), ring stages, row blocks, splits of the bins, bins a
// split, dynamic shared memory in bytes. Returns a CUDA error, 0 on
// success (cudaErrorInvalidValue for shapes the design does not take).
extern "C" int bin_max_plan(int cand_dtype, int design, int B, int D, int L, int bs, int* info) {
  Plan p;
  const cudaError_t err = plan_for(cand_dtype, design, B, D, L, bs, &p);
  if (err != cudaSuccess) return (int)err;
  const int v[8] = {p.threads, p.query_tile, p.rows_form, p.stages,
                    p.row_blocks, p.splits, p.bins_per_split, (int)p.smem};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return 0;
}

// q (B, D): f32 for fp32 and bf16 rows, int8 for int8 rows; cand (L * bs,
// D) f32, bf16 or int8 (cand_dtype 0, 1, 2); scale (L * bs,) f32 or null,
// per_bin: the bin's first row's scale multiplies its max; out (B, L) f32;
// design 0 (mma_sync) or 1 (wgmma: the shapes of wg_width and a 16-byte
// aligned cand, else cudaErrorInvalidValue). Returns cudaGetLastError()
// after the launch.
extern "C" int bin_max(const void* q, const void* cand, int cand_dtype, const float* scale,
                       int per_bin, float* out, int B, int D, int L, int bs, int design,
                       cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_for(cand_dtype, design, B, D, L, bs, &p);
  if (err != cudaSuccess) return (int)err;
  if (design == DESIGN_WG) {
    const int dp = wg_width(cand_dtype, D, bs);
    err = cand_dtype == 0
              ? launch_wg_dp<float>(dp, p, q, cand, scale, per_bin, out, B, D, L, bs, stream)
          : cand_dtype == 1
              ? launch_wg_dp<uint16_t>(dp, p, q, cand, scale, per_bin, out, B, D, L, bs, stream)
              : launch_wg_dp<int8_t>(dp, p, q, cand, scale, per_bin, out, B, D, L, bs, stream);
    return (int)err;
  }
  err = cand_dtype == 0 ? launch<float>(p, q, cand, scale, per_bin, out, B, D, L, bs, stream)
      : cand_dtype == 1 ? launch<uint16_t>(p, q, cand, scale, per_bin, out, B, D, L, bs, stream)
                        : launch<int8_t>(p, q, cand, scale, per_bin, out, B, D, L, bs, stream);
  return (int)err;
}
