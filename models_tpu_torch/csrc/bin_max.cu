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
// Design (simple; wgmma and TMA are later work):
//   - Blocks: x a tile of 16 * nw query rows (nw warps, 16 rows each, up to
//     8), y a split of the bins. A block walks its bins' rows in tiles of TC
//     = 64 candidate rows; the catalog is streamed ceil(B / (16 nw)) times,
//     the row blocks of one split side by side in the grid so that they
//     read it from L2 together. Splits: as many as fill the card at the
//     occupancy it reports. Every bin has one writer: no atomics, the same
//     bits every call.
//   - Copies: every thread of the block copies, cp.async 16 bytes at a time
//     where rows are whole 16-byte pieces on 16-byte addresses (plain loads
//     and stores otherwise), into a ring of two stages: the next tile lands
//     while this one is scored. The query rows stay in shared memory where
//     the width padded to 32 fits a 256-deep slab; wider rows stream with
//     the tiles, slab by slab. Depths past D are zero.
//   - Products, K6's fragments (mma_tf32.cuh): a warp's 16 x 64 scores in
//     registers, mma.sync.m16n8k8 in 3xTF32 for fp32 rows (fp32's error:
//     phase B, K5, scores alike, so the bin margin covers their last-bit
//     differences), 2xTF32 for bf16 rows (exact in TF32: two products, the
//     rows read as bf16 and never widened in memory), each 32-deep part
//     summed from zero and added to the fp32 accumulator; int8 rows on
//     mma.sync.m16n8k32 s8 into int32. A lane reads its A and B operands as
//     one 8-byte piece a k-step: the depths A and B agree on are permuted
//     within the k-step, which leaves every sum as it is (int) or within
//     the fragment's own order (fp32).
//   - Reduction: for bs a multiple of 64, a lane takes the max of its 16
//     scores of each of its two rows, two shuffles give the quad's (the
//     row's 64), and a running max across the bin's tiles is written by
//     lane t = 0 at the bin's last tile. Other bin sizes: the warp writes
//     its 16 x 64 scores to shared memory and 16 lanes walk them, one row
//     each, carrying the bin's running max across tiles.
//
// Bound on an H100 SXM at the bench's shape (C = 1M, D = 128, B = 256):
// operations, the 2*B*C*D = 6.55e10 of the scores as 3xTF32 (0.40 ms at
// 495 / 3 TFLOP/s) or 2xTF32 (bf16 rows: 0.26 ms); int8 rows bytes, their
// 128 MB read once at 3.35 TB/s (0.038 ms). Before this kernel the port
// wrote the (B, C) fp32 or int32 scores (1.02 GB there) and read them back,
// and widened a bf16 catalog to fp32 on every call.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

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

// the larger of two scores, NaN if either is (torch.amax's rule)
__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || a != a) ? a : b; }

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

// The launch: warps a block, the bins' split, shared memory.
struct Plan {
  int nw, rows_form, splits, bins_per_split;
  size_t smem;
};

template <typename T>
cudaError_t make_plan(int B, int D, int L, int bs, Plan* p) {
  int dev = 0, smem_max = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // as many warps as the rows need (at most 8), fewer where shared memory
  // does not hold them
  p->rows_form = bs % TC != 0;
  p->nw = 0;
  const int want = (B + 15) / 16 < WARPS_MAX ? (B + 15) / 16 : WARPS_MAX;
  for (int nw = want; nw >= 1 && !p->nw; --nw) {
    const size_t bytes = smem_bytes(geometry<T>(D, nw, p->rows_form), nw);
    if (bytes <= (size_t)smem_max) {
      p->nw = nw;
      p->smem = bytes;
    }
  }
  if (!p->nw) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bin_max_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p->smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bin_max_kernel<T>, 32 * p->nw,
                                                        p->smem);
  if (err != cudaSuccess) return err;
  // as many (row block, split) blocks as the card holds at once, at least one
  // split and at most one a bin
  const int row_blocks = (B + 16 * p->nw - 1) / (16 * p->nw);
  int splits = per_sm * sms / row_blocks;
  splits = splits < 1 ? 1 : splits > L ? L : splits > 65535 ? 65535 : splits;
  p->bins_per_split = (L + splits - 1) / splits;
  p->splits = (L + p->bins_per_split - 1) / p->bins_per_split;
  return cudaSuccess;
}

cudaError_t plan_for(int cand_dtype, int B, int D, int L, int bs, Plan* p) {
  if (B < 1 || D < 1 || L < 1 || bs < 1) return cudaErrorInvalidValue;
  if (cand_dtype == 0) return make_plan<float>(B, D, L, bs, p);
  if (cand_dtype == 1) return make_plan<uint16_t>(B, D, L, bs, p);
  if (cand_dtype == 2) return make_plan<int8_t>(B, D, L, bs, p);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const Plan& p, const void* q, const void* cand, const float* scale,
                   int per_bin, float* out, int B, int D, int L, int bs, cudaStream_t stream) {
  using Q = typename Rows<T>::Q;
  const int vq = (D * (int)sizeof(Q)) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int vc = (D * (int)sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(cand) % 16 == 0;
  const dim3 grid((B + 16 * p.nw - 1) / (16 * p.nw), p.splits);
  bin_max_kernel<T><<<grid, 32 * p.nw, p.smem, stream>>>(
      q, static_cast<const T*>(cand), scale, per_bin, out, B, D, L, bs, p.bins_per_split, vq, vc);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// How bin_max launches for these shapes (a report): warps a block (16
// query rows each), whether it reduces through shared memory (bin sizes
// other than multiples of 64), the splits of the bins, bins a split and
// dynamic shared memory in bytes. Returns a CUDA error, 0 on success.
extern "C" int bin_max_plan(int cand_dtype, int B, int D, int L, int bs, int* nw, int* rows_form,
                            int* splits, int* bins_per_split, int* smem) {
  Plan p;
  const cudaError_t err = plan_for(cand_dtype, B, D, L, bs, &p);
  if (err != cudaSuccess) return (int)err;
  *nw = p.nw;
  *rows_form = p.rows_form;
  *splits = p.splits;
  *bins_per_split = p.bins_per_split;
  *smem = (int)p.smem;
  return 0;
}

// q (B, D): f32 for fp32 and bf16 rows, int8 for int8 rows; cand (L * bs,
// D) f32, bf16 or int8 (cand_dtype 0, 1, 2); scale (L * bs,) f32 or null,
// per_bin: the bin's first row's scale multiplies its max; out (B, L) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int bin_max(const void* q, const void* cand, int cand_dtype, const float* scale,
                       int per_bin, float* out, int B, int D, int L, int bs,
                       cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_for(cand_dtype, B, D, L, bs, &p);
  if (err != cudaSuccess) return (int)err;
  err = cand_dtype == 0 ? launch<float>(p, q, cand, scale, per_bin, out, B, D, L, bs, stream)
      : cand_dtype == 1 ? launch<uint16_t>(p, q, cand, scale, per_bin, out, B, D, L, bs, stream)
                        : launch<int8_t>(p, q, cand, scale, per_bin, out, B, D, L, bs, stream);
  return (int)err;
}
