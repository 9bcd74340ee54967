// Streaming exact top-k over a candidate matrix, for sm_90a, on the tensor
// cores.
//
// Replaces the TPU kernel models_tpu/ops/topk.py::pallas_topk (K6).
//
//   score(b, c) = (sum_d q[b, d] * cand[c, d]) * scale[c]
//
// the sum at fp32 accuracy, then one fp32 multiply by the row's scale where
// one is given (the int8 index's per-row dequantization, as the JAX
// package's blockwise route applies its col_scale). Candidates are fp32, bf16
// or int8 rows; the queries stay fp32. Rows at or past c_real never rank.
// Each query row keeps the k best by (score descending, position ascending),
// the order of lax.top_k and of pallas_topk's first-occurrence max, for any
// k >= 1. The list starts as k entries (finfo(f32).min, -1) ranked before
// every candidate, as the TPU kernel's running list does; ids are mapped at
// the end.
//
// Design. The TPU grid walks the catalog in order and carries the (B, k) list
// in VMEM from step to step. Blocks on Hopper run in parallel and carry
// nothing, so the catalog is cut into `splits` chunks, as many as fill the
// card at the occupancy it reports; pass 1 keeps a sorted list per (row,
// chunk), pass 2 merges them in order. No atomics: the same bits every call.
//   - Products: mma.sync.m16n8k8 in TF32 with the 3xTF32 split of
//     mma_tf32.cuh (x = big + small, about 2^-21 relative per product). A
//     bf16 or int8 row is exact in TF32, so its small part is zero and it
//     takes two products (q_big * c + q_small * c), fp32 rows three. Each
//     score is summed over 32 depth positions from zero and then added to an
//     fp32 accumulator (the tensor cores round their sums toward zero). The
//     split is elementwise and every column of an mma is computed alike, so
//     equal rows give bit-equal scores and a planted duplicate ranks at its
//     lowest position.
//   - Warps own rows: a block has up to 8 scoring warps of 16 query rows,
//     resident in shared memory, and streams its chunk in tiles of TC = 64
//     candidate rows. Within each k-step of 8 the logical depths t and t + 4
//     of the fragments read the physical depths 2t and 2t + 1, so a lane
//     takes its A operand as two float2 and its B operand as one 8-, 4- or
//     2-byte load; bf16 and int8 values are widened as the fragment is
//     formed. Shared rows are padded to 8 (fp32) or 4 (bf16, int8) words mod
//     32 banks: conflict-free.
//   - Copies: one more warp copies. It fills a ring of 2-4 stages (as many
//     as shared memory holds) with one bulk copy a row (cp.async.bulk, the
//     query rows' and the tile's D elements, 16-byte aligned) and the tile's
//     scales, and marks each stage full on an mbarrier that counts the bytes
//     as they land. A scoring warp releases a stage on a second mbarrier as
//     soon as its products have read it, before its merges: no barrier
//     across the block, so a warp that merges holds no other back. Padding
//     past D is zeroed once and never copied over (the width runs padded to
//     a multiple of 32, no branch on D inside the products). Rows that are
//     not 16-byte rows, and widths past 256 (which stream the query rows with
//     the tiles, in 256-deep slabs), are copied element by element.
//   - The threshold test in registers: each lane compares the scores in its
//     C fragment with its two rows' k-th best, held in registers and read
//     again after each merge. Only a tile where some score passes goes
//     through shared memory (the warp's 16 x 64 scores), and only the rows
//     with a passing score are merged. For k <= 32 a row's list sits one
//     entry a lane in registers while the passing scores go in, in position
//     order; past 32 the warp compacts the row's passing scores, ranks them
//     among themselves, and moves each list entry down by the number of new
//     scores above it.
//   - Lists of any length: each row's list sits in shared memory, with fewer
//     warps a block where k needs the room; past what one warp's 16 lists can
//     hold there, the lists live in the partial output in global memory.
//   pass 2, topk_merge: one warp per query row merges the `splits` sorted
//     lists by k rounds of a warp-wide arg-max and maps positions to ids.
//
// Bound on an H100 SXM at B = 4096, C = 56,680, D = 128: operations, the
// 2*B*C*D = 59.4 GFLOP of the scores run as 3xTF32 (fp32 rows: 178 GFLOP,
// 0.360 ms at 495 TFLOP/s) or 2xTF32 (bf16, int8: 0.240 ms); as fp32 on the
// CUDA cores (the earlier design) 0.887 ms at 67 TFLOP/s. The catalog
// stream, C*D*itemsize bytes at 3.35 TB/s, is far smaller. What held the
// earlier design (3.78 ms) back, and what this one does about it: fp32 FMAs
// on the CUDA cores (the tensor cores); 8 shared loads for every 16 FMAs
// (fragments of 16 x 64 scores from 2 + 8 loads a k-step); synchronous
// 4-byte tile loads with a divide and a modulo each, two barriers a slice
// (bulk copies into a ring, no block barrier); every score through shared
// memory before its threshold test (the test in registers); lists fixed at
// 512 entries (sized from k).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int TC = 64;           // candidate rows per tile
constexpr int NJ = TC / 8;       // n-tiles of a warp's 16 x TC scores
constexpr int WARPS_MAX = 8;     // scoring warps a block, 16 query rows each
constexpr int STAGES_MAX = 4;
constexpr int SLAB = 256;        // widest depth a stage holds
constexpr int SLD = TC + 8;      // score buffer row stride: 8 mod 32 banks
constexpr int BATCH = 64;        // entries of a warp's merge buffers
constexpr int BAR_BYTES = 16 * 2 * STAGES_MAX;  // the ring's mbarriers, padded
constexpr int MERGE_WARPS = 4;
constexpr int SPLITS_MAX = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -FLT_MAX;  // finfo(float32).min, not -inf

static_assert(TC == 64, "a row's tile scores are lanes lane and lane + 32");

// The storage of a candidate row: float, the bits of a bf16, or int8. PAD:
// bytes after a shared row. pair(): the values at depths 2t and 2t + 1, as
// TF32 operands (bf16 and int8 exactly).
template <typename T>
struct Rows;

template <>
struct Rows<float> {
  static constexpr int PAD = 32;
  __device__ static void pair(const char* p, uint32_t& x, uint32_t& y) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x = __float_as_uint(v.x);
    y = __float_as_uint(v.y);
  }
};

template <>
struct Rows<uint16_t> {
  static constexpr int PAD = 16;
  __device__ static void pair(const char* p, uint32_t& x, uint32_t& y) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    x = w << 16;
    y = w & 0xffff0000u;
  }
};

template <>
struct Rows<int8_t> {
  static constexpr int PAD = 16;
  __device__ static void pair(const char* p, uint32_t& x, uint32_t& y) {
    const int16_t w = *reinterpret_cast<const int16_t*>(p);
    x = __float_as_uint((float)(int8_t)(w & 0xff));
    y = __float_as_uint((float)(w >> 8));
  }
};

// The shapes one launch runs at, the same on the host and on the card.
struct Geo {
  int qres;    // the query rows stay in shared memory for the whole chunk
  int slab;    // depth of a stage: the padded width, or SLAB when cut
  int nslab;   // stages a tile
  int ldq;     // floats of a shared query row
  int ldc;     // bytes of a shared candidate row
  int stage;   // bytes of one stage: the tile, its scales (and query slab)
  int qbytes;  // bytes of the resident query rows
  int wbytes;  // bytes of a scoring warp's own area
};

template <typename T>
__host__ __device__ Geo geometry(int D, int nw, int k) {
  Geo g;
  const int dw = (D + 31) / 32 * 32;
  g.qres = dw <= SLAB;
  g.slab = g.qres ? dw : SLAB;
  g.nslab = (dw + g.slab - 1) / g.slab;
  g.ldq = g.slab + 8;
  g.ldc = g.slab * (int)sizeof(T) + Rows<T>::PAD;
  g.stage = TC * g.ldc + TC * 4 + (g.qres ? 0 : 16 * nw * g.ldq * 4);
  g.qbytes = g.qres ? 16 * nw * g.ldq * 4 : 0;
  // its 16 x TC scores, and for lists past 32 two (score, position) buffers
  // of BATCH entries (the passing scores, then the same sorted)
  g.wbytes = 16 * SLD * 4 + (k > 32 ? 4 * BATCH * 4 : 0);
  return g;
}

// shared memory: the ring's mbarriers, the resident query rows, ns stages,
// each scoring warp's area, then the lists where they are shared
template <typename T>
size_t smem_bytes(const Geo& g, int nw, int ns, int k, bool lists_shared) {
  return BAR_BYTES + (size_t)g.qbytes + (size_t)ns * g.stage + (size_t)nw * g.wbytes +
         (lists_shared ? (size_t)16 * nw * k * 8 : 0);
}

// rows [r0, r0 + rows) x depths [d0, d0 + w) of a (n, D) matrix into shared
// rows of `ld` bytes, by the 32 lanes of one warp. bulk: one bulk copy per
// row below r_end, of its D elements (D * sizeof(T) % 16 == 0, src 16-byte
// aligned, w = the padded width), counted on `bar`; the rest of the shared
// rows is left as it is. Otherwise plain loads and stores, rows at or past
// r_end and depths at or past D zero.
template <typename T>
__device__ void copy_rows(char* dst, int ld, const T* __restrict__ src, int r0, int rows,
                          int r_end, int D, int d0, int w, bool bulk, uint64_t* bar, int lane) {
  if (bulk) {
    const int n = min(rows, r_end - r0);
    for (int r = lane; r < n; r += 32)
      bulk_copy(dst + r * ld, src + (size_t)(r0 + r) * D, D * (int)sizeof(T), bar);
    return;
  }
  int r = lane / w, e = lane - r * w;
  for (; r < rows;) {
    const int d = d0 + e;
    const bool ok = r0 + r < r_end && d < D;
    reinterpret_cast<T*>(dst + r * ld)[e] = ok ? src[(size_t)(r0 + r) * D + d] : T(0);
    for (e += 32; e >= w; e -= w) ++r;
  }
}

// acc += the warp's 16 x TC scores over `width` depths: query rows qw
// (shared, ldq floats a row), candidate rows cs (shared, ldc bytes a row).
// Element e of acc[j] is query row g + 8 (e >> 1), candidate 8j + 2t + (e & 1).
template <typename T>
__device__ __forceinline__ void products(float acc[NJ][4], const float* qw, int ldq,
                                         const char* cs, int ldc, int width, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* qa = qw + g * ldq + 2 * t;
  const float* qb = qa + 8 * ldq;
  const char* cb = cs + g * ldc + 2 * t * (int)sizeof(T);
  for (int k0 = 0; k0 < width; k0 += 32) {
    float part[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
    for (int kd = k0; kd < k0 + 32; kd += 8) {
      // a0 (g, t) and a2 (g, t + 4) at depths kd + 2t, kd + 2t + 1; a1, a3 row g + 8
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

// merge_row for k <= 32: lane i holds list entry i in registers, and the
// passing scores go in one at a time, in position order, each at the count
// of listed scores >= it (listed positions are lower), the entries below it
// shifted down one lane; a score the risen k-th best no longer passes is
// dropped unread.
__device__ void merge_row_short(const float* srow, int c0, float* L, int* P, int k, int lane) {
  float lv = lane < k ? L[lane] : 0.f;
  int lp = lane < k ? P[lane] : 0;
  float kth = __shfl_sync(FULL, lv, k - 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v = srow[lane + 32 * h];
    unsigned hits = __ballot_sync(FULL, v > kth);
    while (hits) {
      const int src = __ffs(hits) - 1;
      const float s = __shfl_sync(FULL, v, src);
      const int at = __popc(__ballot_sync(FULL, lane < k && lv >= s));
      const float up_v = __shfl_up_sync(FULL, lv, 1);
      const int up_p = __shfl_up_sync(FULL, lp, 1);
      if (lane > at) { lv = up_v; lp = up_p; }
      if (lane == at) { lv = s; lp = c0 + 32 * h + src; }
      kth = __shfl_sync(FULL, lv, k - 1);
      hits &= __ballot_sync(FULL, v > kth) & ~((2u << src) - 1u);
    }
  }
  if (lane < k) { L[lane] = lv; P[lane] = lp; }
  __syncwarp();
}

// Merge one row's tile scores (srow[i] at position c0 + i; -inf past the
// chunk) that rank above its k-th best into its sorted list L / P, in shared
// or global memory. A whole warp calls it; bs/bp and ss/sp are its buffers.
// Every listed position is below c0, so a listed entry ranks before a new
// score it equals.
__device__ void merge_row(const float* srow, int c0, float* L, int* P, int k, float* bs,
                          int* bp, float* ss, int* sp, int lane) {
  const float kth = L[k - 1];
  float v[2];
  int pos[2], slot[2], fin[2];
  bool in[2];
  unsigned bal[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v[h] = srow[lane + 32 * h];
    pos[h] = c0 + lane + 32 * h;
    in[h] = v[h] > kth;
    bal[h] = __ballot_sync(FULL, in[h]);
  }
  const unsigned below = (1u << lane) - 1u;
  const int n0 = __popc(bal[0]), m = n0 + __popc(bal[1]);
  slot[0] = __popc(bal[0] & below);
  slot[1] = n0 + __popc(bal[1] & below);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (in[h]) { bs[slot[h]] = v[h]; bp[slot[h]] = pos[h]; }
  __syncwarp();
  // rank among the passing scores (they come in position order), and the
  // place in the merged list: after every listed score >= it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!in[h]) continue;
    int r = 0;
    for (int j = 0; j < m; ++j) {
      const float b = bs[j];
      r += b > v[h] || (b == v[h] && j < slot[h]);
    }
    ss[r] = v[h];
    sp[r] = pos[h];
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (L[mid] >= v[h]) lo = mid + 1; else hi = mid;
    }
    fin[h] = lo + r;
  }
  __syncwarp();
  // entries below the best new score move down by the new scores above them,
  // the top chunk of 32 first: each chunk reads all its entries before it
  // writes, and writes only at or above its own first index
  const float top = ss[0];
  int first = 0, hi = k;
  while (first < hi) {
    const int mid = (first + hi) >> 1;
    if (L[mid] >= top) first = mid + 1; else hi = mid;
  }
  for (int base = ((k - 1) >> 5) << 5; base >= (first & ~31); base -= 32) {
    const int i = base + lane;
    float lv = 0.f;
    int lp = 0, to = k;
    if (i >= first && i < k) {
      lv = L[i];
      lp = P[i];
      int a = 0, b = m;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (ss[mid] > lv) a = mid + 1; else b = mid;
      }
      to = i + a;
    }
    __syncwarp();
    if (to < k) { L[to] = lv; P[to] = lp; }
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (in[h] && fin[h] < k) { L[fin[h]] = v[h]; P[fin[h]] = pos[h]; }
  __syncwarp();
}

// Block (row block x, split y): nw scoring warps, 16 query rows each, and
// one copying warp (the last), against the candidates [y * chunk,
// min((y + 1) * chunk, c_real)); the sorted list of k per row goes to
// part_s / part_p (B, splits, k). The copying warp fills a ring of ns stages
// and marks each full on an mbarrier; a scoring warp releases a stage on
// another as soon as its products have read it, before its merges, so that
// a warp busy merging holds no other back.
template <typename T>
__global__ void __launch_bounds__((WARPS_MAX + 1) * 32)
topk_partial(const float* __restrict__ q, const T* __restrict__ cand,
             const float* __restrict__ scale, float* part_s, int* part_p, int B, int D,
             int c_real, int k, int chunk, int splits, int ns, int lists_shared, int bulk) {
  extern __shared__ __align__(16) char smem[];
  const int nw = (blockDim.x >> 5) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int QB = 16 * nw;
  const int row0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int c_begin = split * chunk;
  const int c_end = min(c_begin + chunk, c_real);
  const Geo geo = geometry<T>(D, nw, k);

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES_MAX;
  float* q_res = reinterpret_cast<float*>(smem + BAR_BYTES);  // [QB][ldq] where resident
  char* stages = smem + BAR_BYTES + geo.qbytes;
  char* areas = stages + ns * geo.stage;
  float* lsh = reinterpret_cast<float*>(areas + nw * geo.wbytes);
  int* lph = reinterpret_cast<int*>(lsh + QB * k);
  const int ntiles = c_end > c_begin ? (c_end - c_begin + TC - 1) / TC : 0;
  const int steps = ntiles * geo.nslab;

  // bulk copies write whole rows of D elements and nothing else: the
  // padding past D (and past B) stays the zeros written here. Rows past the
  // chunk in its last tile keep an earlier tile's values, whose scores are
  // replaced by -inf
  bulk = bulk && geo.qres;
  if (bulk) {
    for (int i = threadIdx.x; i < (geo.qbytes + ns * geo.stage) / 16; i += blockDim.x)
      reinterpret_cast<float4*>(smem + BAR_BYTES)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < ns; ++i) {
      mbar_init(full + i, 33);  // the copying warp's lanes, and its expected bytes
      mbar_init(empty + i, nw);  // one lane of each scoring warp
    }
  __syncthreads();

  if (warp == nw) {  // the copying warp
    for (int st = 0; st < steps; ++st) {
      const int sb = st % ns;
      if (st >= ns) mbar_wait(empty + sb, (st / ns - 1) & 1);  // tile st - ns is scored
      const int ti = st / geo.nslab, d0 = (st - ti * geo.nslab) * geo.slab;
      const int c0 = c_begin + ti * TC;
      char* sg = stages + sb * geo.stage;
      if (lane == 0) {
        int bytes = 0;
        if (bulk) {
          bytes = min(TC, c_end - c0) * D * (int)sizeof(T);
          if (st == 0) bytes += min(QB, B - row0) * D * 4;
        }
        mbar_arrive_expect(full + sb, bytes);
      }
      __syncwarp();
      if (st == 0 && geo.qres)
        copy_rows<float>(smem + BAR_BYTES, geo.ldq * 4, q, row0, QB, B, D, 0, geo.slab, bulk,
                         full + sb, lane);
      copy_rows<T>(sg, geo.ldc, cand, c0, TC, c_end, D, d0, geo.slab, bulk, full + sb, lane);
      if (!geo.qres)
        copy_rows<float>(sg + TC * geo.ldc + TC * 4, geo.ldq * 4, q, row0, QB, B, D, d0,
                         geo.slab, false, full + sb, lane);
      if (scale) {
        float* to = reinterpret_cast<float*>(sg + TC * geo.ldc);
        for (int i = lane; i < TC; i += 32) to[i] = c0 + i < c_end ? scale[c0 + i] : 0.f;
      }
      mbar_arrive(full + sb);
    }
    return;
  }

  char* own = areas + warp * geo.wbytes;
  float* sbuf = reinterpret_cast<float*>(own);  // [16][SLD]
  float* bs = sbuf + 16 * SLD;
  int* bp = reinterpret_cast<int*>(bs + BATCH);
  float* ss = reinterpret_cast<float*>(bp + BATCH);
  int* sp = reinterpret_cast<int*>(ss + BATCH);
  // the list of block row r: shared, or the row's slot of the partial output
  auto list_s = [&](int r) {
    return lists_shared ? lsh + r * k : part_s + ((size_t)(row0 + r) * splits + split) * k;
  };
  auto list_p = [&](int r) {
    return lists_shared ? lph + r * k : part_p + ((size_t)(row0 + r) * splits + split) * k;
  };
  const int nrows = max(0, min(16, B - row0 - 16 * warp));  // the warp's rows below B
  for (int r = 16 * warp; r < 16 * warp + nrows; ++r) {
    float* L = list_s(r);
    int* P = list_p(r);
    for (int i = lane; i < k; i += 32) { L[i] = NEG_INF; P[i] = -1; }
  }
  __syncwarp();
  // the lane's rows g and g + 8: their k-th best (+inf past B: never passed)
  float kth[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kth[h] = g + 8 * h < nrows ? NEG_INF : INFINITY;

  float acc[NJ][4];
  for (int st = 0; st < steps; ++st) {
    const int sb = st % ns;
    mbar_wait(full + sb, (st / ns) & 1);
    const int ti = st / geo.nslab, si = st - ti * geo.nslab;
    const int c0 = c_begin + ti * TC;
    const char* sg = stages + sb * geo.stage;
    const float* sc = reinterpret_cast<const float*>(sg + TC * geo.ldc);
    float scl[NJ][2];
    if (nrows > 0) {
      const float* qw = (geo.qres ? q_res : reinterpret_cast<const float*>(sg + TC * geo.ldc + TC * 4)) +
                        16 * warp * geo.ldq;
      if (si == 0) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
      products<T>(acc, qw, geo.ldq, sg, geo.ldc, geo.slab, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        scl[j][0] = scale ? sc[8 * j + 2 * t] : 1.f;
        scl[j][1] = scale ? sc[8 * j + 2 * t + 1] : 1.f;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + sb);  // this warp is done with the stage
    if (nrows == 0 || si != geo.nslab - 1) continue;

    // the tile's scores, and the threshold test in registers
    bool hit[2] = {false, false};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const float x = scale ? acc[j][e] * scl[j][e & 1] : acc[j][e];
        acc[j][e] = c0 + col < c_end ? x : -INFINITY;
        hit[e >> 1] |= acc[j][e] > kth[e >> 1];
      }
    if (!__any_sync(FULL, hit[0] || hit[1])) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<float2*>(sbuf + g * SLD + 8 * j + 2 * t) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(sbuf + (g + 8) * SLD + 8 * j + 2 * t) =
          make_float2(acc[j][2], acc[j][3]);
    }
    __syncwarp();
    const unsigned hits[2] = {__ballot_sync(FULL, hit[0]), __ballot_sync(FULL, hit[1])};
    for (int r = 0; r < 16; ++r) {
      if (!((hits[r >> 3] >> (4 * (r & 7))) & 0xfu)) continue;
      if (k <= 32)
        merge_row_short(sbuf + r * SLD, c0, list_s(16 * warp + r), list_p(16 * warp + r), k, lane);
      else
        merge_row(sbuf + r * SLD, c0, list_s(16 * warp + r), list_p(16 * warp + r), k, bs, bp,
                  ss, sp, lane);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (g + 8 * h < nrows) kth[h] = list_s(16 * warp + g + 8 * h)[k - 1];
  }

  if (lists_shared) {  // the warp's own rows
    for (int r = 16 * warp; r < 16 * warp + nrows; ++r)
      for (int i = lane; i < k; i += 32) {
        const size_t o = ((size_t)(row0 + r) * splits + split) * k + i;
        part_s[o] = lsh[r * k + i];
        part_p[o] = lph[r * k + i];
      }
  }
}

// (s, p) ranks before (t, r)
__device__ __forceinline__ bool ranks_before(float s, int p, float t, int r) {
  return s > t || (s == t && p < r);
}

__global__ void __launch_bounds__(MERGE_WARPS * 32)
topk_merge(const float* __restrict__ part_s, const int* __restrict__ part_p,
           const int* __restrict__ ids, float* __restrict__ out_s,
           int* __restrict__ out_i, int B, int k, int splits) {
  __shared__ int heads[MERGE_WARPS][SPLITS_MAX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * MERGE_WARPS + warp;
  if (b >= B) return;  // warp-uniform
  int* head = heads[warp];
  for (int sp = lane; sp < splits; sp += 32) head[sp] = 0;
  __syncwarp();
  const float* S = part_s + (size_t)b * splits * k;
  const int* Pp = part_p + (size_t)b * splits * k;
  for (int j = 0; j < k; ++j) {
    float s = -INFINITY;
    int p = INT32_MAX, from = -1;
    for (int sp = lane; sp < splits; sp += 32) {
      const int h = head[sp];
      if (h < k) {
        const float t = S[(size_t)sp * k + h];
        const int r = Pp[(size_t)sp * k + h];
        if (from < 0 || ranks_before(t, r, s, p)) { s = t; p = r; from = sp; }
      }
    }
    for (int off = 16; off; off >>= 1) {
      const float t = __shfl_xor_sync(FULL, s, off);
      const int r = __shfl_xor_sync(FULL, p, off);
      const int f = __shfl_xor_sync(FULL, from, off);
      const bool take = f >= 0 && (from < 0 || ranks_before(t, r, s, p) ||
                                   (t == s && r == p && f < from));
      if (take) { s = t; p = r; from = f; }
    }
    if (lane == (from & 31)) head[from] += 1;
    if (lane == 0) {
      out_s[(size_t)b * k + j] = s;
      out_i[(size_t)b * k + j] = p < 0 ? -1 : (ids ? ids[p] : p);
    }
    __syncwarp();
  }
}

// The launch: scoring warps a block, ring stages, where the lists live,
// shared memory and the catalog's split into chunks.
struct Plan {
  int nw, ns, lists_shared, splits, chunk;
  size_t smem;
};

template <typename T>
cudaError_t make_plan(int B, int D, int c_real, int k, Plan* p) {
  int dev = 0, smem_max = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // as many scoring warps as the rows need (at most 8), fewer where the
  // lists need the room, then as many stages as fit (at least 2); lists too
  // long for one warp's 16 go to global memory
  const int want = (B + 15) / 16 < WARPS_MAX ? (B + 15) / 16 : WARPS_MAX;
  p->nw = 0;
  for (int shared = 1; shared >= 0 && !p->nw; --shared)
    for (int nw = want; nw >= 1 && !p->nw; --nw)
      for (int ns = STAGES_MAX; ns >= 2; --ns) {
        const size_t bytes = smem_bytes<T>(geometry<T>(D, nw, k), nw, ns, k, shared);
        if (bytes <= (size_t)smem_max) {
          p->nw = nw;
          p->ns = ns;
          p->lists_shared = shared;
          p->smem = bytes;
          break;
        }
      }
  if (!p->nw) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(topk_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p->smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_partial<T>,
                                                        32 * (p->nw + 1), p->smem);
  if (err != cudaSuccess) return err;
  // as many (row block, split) blocks as the card holds at once, at least one
  // split and at most one a tile
  const int row_blocks = (B + 16 * p->nw - 1) / (16 * p->nw);
  const int tiles = c_real > 0 ? (c_real + TC - 1) / TC : 1;
  int splits = (per_sm * sms) / row_blocks;
  splits = splits < 1 ? 1 : splits > tiles ? tiles : splits > SPLITS_MAX ? SPLITS_MAX : splits;
  p->chunk = (tiles + splits - 1) / splits * TC;
  p->splits = c_real > 0 ? (c_real + p->chunk - 1) / p->chunk : 1;  // each holds a row
  return cudaSuccess;
}

cudaError_t plan_for(int cand_dtype, int B, int D, int c_real, int k, Plan* p) {
  if (cand_dtype == 0) return make_plan<float>(B, D, c_real, k, p);
  if (cand_dtype == 1) return make_plan<uint16_t>(B, D, c_real, k, p);
  if (cand_dtype == 2) return make_plan<int8_t>(B, D, c_real, k, p);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_partial(const Plan& p, const float* q, const void* cand, const float* scale,
                           float* part_s, int* part_p, int B, int D, int c_real, int k,
                           cudaStream_t stream) {
  const int bulk = (D * 4) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   (D * (int)sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(cand) % 16 == 0;
  const dim3 grid((B + 16 * p.nw - 1) / (16 * p.nw), p.splits);
  topk_partial<T><<<grid, 32 * (p.nw + 1), p.smem, stream>>>(
      q, static_cast<const T*>(cand), scale, part_s, part_p, B, D, c_real, k, p.chunk,
      p.splits, p.ns, p.lists_shared, bulk);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The number of catalog splits streaming_topk cuts c_real rows into for
// these shapes; the caller sizes part_s / part_p as (B, splits, k). A
// negative value is a CUDA error, negated.
extern "C" int streaming_topk_splits(int cand_dtype, int B, int D, int c_real, int k) {
  if (B < 1 || D < 1 || k < 1 || c_real < 0) return -(int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan_for(cand_dtype, B, D, c_real, k, &p);
  return err == cudaSuccess ? p.splits : -(int)err;
}

// Scoring warps a block, ring stages, lists in shared memory (1) or global
// (0), and dynamic shared memory in bytes, of the partial pass for these
// shapes (a report).
extern "C" int streaming_topk_plan(int cand_dtype, int B, int D, int c_real, int k,
                                   int* nw, int* ns, int* lists_shared, int* smem) {
  Plan p;
  const cudaError_t err = plan_for(cand_dtype, B, D, c_real, k, &p);
  if (err != cudaSuccess) return (int)err;
  *nw = p.nw;
  *ns = p.ns;
  *lists_shared = p.lists_shared;
  *smem = (int)p.smem;
  return 0;
}

// q (B, D) f32; cand (C, D) f32, bf16 or int8 (cand_dtype 0, 1, 2); scale
// (C,) f32 or null; ids (C,) int32 or null (positions are returned);
// part_s/part_p (B, splits, k) scratch with splits = streaming_topk_splits;
// out_s/out_i (B, k). Returns cudaGetLastError() after the launches.
extern "C" int streaming_topk(const float* q, const void* cand, int cand_dtype,
                              const float* scale, const int* ids,
                              float* part_s, int* part_p, float* out_s, int* out_i,
                              int B, int D, int c_real, int k, int splits,
                              cudaStream_t stream) {
  if (B < 1 || D < 1 || k < 1 || c_real < 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_for(cand_dtype, B, D, c_real, k, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.splits != splits) return (int)cudaErrorInvalidValue;
  err = cand_dtype == 0 ? launch_partial<float>(p, q, cand, scale, part_s, part_p, B, D, c_real, k, stream)
      : cand_dtype == 1 ? launch_partial<uint16_t>(p, q, cand, scale, part_s, part_p, B, D, c_real, k, stream)
                        : launch_partial<int8_t>(p, q, cand, scale, part_s, part_p, B, D, c_real, k, stream);
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0, stream>>>(
      part_s, part_p, ids, out_s, out_i, B, k, splits);
  return (int)cudaGetLastError();
}
