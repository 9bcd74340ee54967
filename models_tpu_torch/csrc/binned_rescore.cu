// Phase-B rescore of the binned top-k, for sm_90a.
//
// Replaces the TPU kernel models_tpu/ops/topk.py::_binned_rescore (K5).
//
//   out[b, j*bs + s] = sum_d q[b, d] * cand[bin_idx[b, j]*bs + s, d]
//
// fp32 and bf16 candidates (fp32 queries, fp32 out): bf16 rows are widened to
// fp32 exactly; the bin-major form takes the products on the tensor cores at
// fp32's error (3xTF32; 2xTF32 for bf16 rows, which TF32 holds exactly), the
// first design in fp32 FMAs. A bin index outside [0, n_bins) gives NaN, not
// a fault.
//
// int8 candidates (int8 queries, int32 out), the int8 index's phase B: sums
// in int32 (mma.sync s8 in the bin-major form; __dp4a, four products a word,
// in the first design when a row is whole 4-byte words). Integer sums are
// exact in any order, so the result is the plain version's bit for bit
// (|sum| <= 127*127*D, which int32 holds for D < 133,000). A bin index
// outside [0, n_bins) gives INT32_MIN.
//
// Design: bin-major (rescore_bins), one launch. The (B, kb) selections name
// far fewer distinct bins than pairs (at the serving shape, B = 256, kb = 13
// over 886 bins of 64 rows: 3,328 pairs, some 500 bins, the most popular
// picked by 70 queries), so a bin is read once for many queries.
//   - Keys and ownership: the pairs of bin n from one group of QUERY_GROUP
//     query rows (b / QUERY_GROUP = h) form key n * ng + h, so that a bin
//     every query picked is spread over ng = ceil(B / QUERY_GROUP) blocks.
//     The grid G is the largest power of two the card holds at once
//     (occupancy x SMs) with at most one block a key; block g owns the keys
//     k with k % G == g (a mask). Out of range bins belong to block 0, which
//     writes their NaN or INT32_MIN.
//   - Scan: a block reads the selections, WINDOW = 4096 at a time (13 KB of
//     int32 at the serving shape, from L2; all of a thread's loads issued
//     before the first is looked at), counts the pairs of each key it
//     owns in shared memory and lists them key by key (a counting sort), in
//     items of at most QC pairs. A window past 4096 pairs (B kb > 4096) is a
//     chunk of its own: a key with pairs in two windows is read twice, and
//     one block may own every pair.
//   - Copies: an item is one bulk copy (cp.async.bulk) of its bin, 64 rows of
//     D in one contiguous run of at most STAGE_BYTES = 32 KB (fp32 64 x 128),
//     into a ring of two bin stages, and one of each pair's query row into a
//     ring of four query stages, counted on the bin stage's mbarrier and
//     issued by the lanes of warp 0. A bin stage is free again once the
//     block holds the bin in registers, so the next two items' copies land
//     while this one is scored.
//   - Scoring, on the tensor cores: warp w holds bin rows 8 w .. 8 w + 7 in
//     registers as the B operand of mma.sync (lane 4 g + t: row 8 w + g,
//     the row's 16-byte chunks t, t + 4, ...), and an item's query rows,
//     at most QC = 8 pairs, are the A operand (rows 0..7; rows 8..15 zero):
//     one 16 x 8 product over the row's depth a warp and item, in 3xTF32
//     for fp32 rows (fp32's error), 2xTF32 for bf16 rows (exact in TF32),
//     int8 x int8 into int32 (exact) for int8 rows. Lane 4 g + t stores the
//     scores of pair g with rows 8 w + 2t and 8 w + 2t + 1.
//   - Each output has one writer and a fixed order of sums: the same bits
//     every call.
// The route rule (rescore_route): bins of 64 rows, rows of whole 16-byte
// pieces and at most 512 bytes, query rows of at most QROW_MAX bytes,
// 16-byte aligned query rows and catalog, fewer than 2^24 pairs, and at
// most NLOC_MAX keys a block. Other shapes take the first design, kept as a
// route: one block per query row (the row in shared memory), each warp in
// turn one candidate row of the selected bins, its lanes on neighbouring
// elements, a shuffle tree, lane 0 storing 4 bytes (rescore, rescore_i8).
// What held it at the serving shape (0.0566 ms for fp32 on an H100 80GB HBM3
// at 700 W, 9% of its bound): one row in flight a warp, 16 warps an SM, and
// every (query, bin) pair reading its bin again, 109 MB through L2 where
// 15.5 MB are distinct. The TPU kernel's 8-row query blocks, static unroll
// and D % 128 == 0 condition were Mosaic workarounds and are gone.
//
// Bound on an H100 SXM: memory. Each distinct selected bin once
// (n_distinct*bs*D*itemsize bytes: 15.5 MB fp32 at the serving shape), the
// query rows, the selections and the output, at 3.35 TB/s; the
// 2*B*kb*bs*D operations are far below the tensor cores' rates (and the 67
// TFLOP/s of the FMA units the first design uses).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// the bin-major form
constexpr int BS = 64;                           // the rows of a bin it takes
constexpr int STAGE_BYTES = BS * 512;            // a bin of rows of at most 512 bytes
constexpr int QROW_MAX = 512;                    // the longest query row it takes (bytes)
constexpr int QC = 8;                            // pairs of an item: query rows a stage holds
constexpr int STAGES = 2;                        // bins in flight
constexpr int QSTAGES = 2 * STAGES;              // query stages: one is scored while bins land
constexpr int WINDOW = 4096;                     // selections a block scans at a time
constexpr int PER_THREAD = WINDOW / THREADS;
constexpr int NLOC_MAX = 512;                    // keys a block owns, at most
constexpr int ITEMS_MAX = NLOC_MAX + WINDOW / QC;
// queries of a group: a bin's pairs from one group of QUERY_GROUP query rows
// form one key, so that a bin many queries picked is spread over blocks
constexpr int QUERY_GROUP = 32;
constexpr int BAR_BYTES = 128;
constexpr size_t BINS_SMEM = BAR_BYTES + (size_t)STAGES * STAGE_BYTES +
                             (size_t)QSTAGES * QC * QROW_MAX +
                             (WINDOW + 2 * NLOC_MAX + 1 + 2 * ITEMS_MAX) * sizeof(int);

enum Kind { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// the bin-major form
// ---------------------------------------------------------------------------

// c += a * b on int8 operands into int32, exact: mma.sync.m16n8k32 (lane =
// 4 g + t, four int8 a register): A (16 x 32) a0 (g, 4t..), a1 (g + 8, 4t..),
// a2 (g, 4t + 16..), a3 (g + 8, 4t + 16..); B (32 x 8, k x n) b0 (4t.., g),
// b1 (4t + 16.., g); C as m16n8k8's
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An item's scores on the tensor cores, for one warp: the 16 x 8 product of
// the item's query rows (A: pairs g < m in rows 0..7, rows 8..15 zero) with
// the warp's 8 rows of the bin (B), over the row's depth. mma_tf32.cuh's
// fragments (lane = 4 g + t). The depth is taken in any order A and B agree
// on: lane t holds the 16-byte chunks t + 4 j (j < NCH) of its row g, and
// each chunk gives the k-steps in which logical depths t and t + 4 (fp32,
// bf16) or 4t.. and 4t + 16.. (int8) are its consecutive elements or words.
//   fp32: 3xTF32 (mma.m16n8k8), two k-steps a chunk; the bin's parts are
//         split once an item (`big`, `small`), the query's a step;
//   bf16: 2xTF32 (a bf16 value is exact in TF32), four k-steps a chunk;
//   int8: mma.m16n8k32 s8 into int32, exact, two k-steps a chunk.
// fp32 sums start from zero every 32 depth positions and are then added to
// the accumulator (mma_tf32.cuh: the tensor cores round their sums toward
// zero). Returns the scores of pair g for bin rows 2t, 2t + 1 of the warp.
template <int KIND, int NCH>
struct Scores;

template <int NCH>
struct Scores<F32, NCH> {
  uint32_t big[NCH][4], small[NCH][4];
  __device__ __forceinline__ void hold(const uint4 (&w)[NCH]) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      split_tf32(__uint_as_float(w[j].x), big[j][0], small[j][0]);
      split_tf32(__uint_as_float(w[j].y), big[j][1], small[j][1]);
      split_tf32(__uint_as_float(w[j].z), big[j][2], small[j][2]);
      split_tf32(__uint_as_float(w[j].w), big[j][3], small[j][3]);
    }
  }
  // q: the lane's query row (pair g), null past the item's pairs. The
  // depth runs in groups of two chunks (32 positions), each summed from zero
  // in its own registers, the groups' products issued in turn so that their
  // chains overlap; the groups are added in order
  __device__ __forceinline__ float2 run(const unsigned char* q, int t, int pr) const {
    constexpr int NG = (NCH + 1) / 2;
    float c[NG][4];
#pragma unroll
    for (int k = 0; k < NG; ++k) c[k][0] = c[k][1] = c[k][2] = c[k][3] = 0.f;
#pragma unroll
    for (int step = 0; step < 4; ++step)
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int j = 2 * k + step / 2, h = step % 2;
        if (j >= NCH) continue;
        const bool in = q != nullptr && t + 4 * j < pr;
        const float4 x = in ? reinterpret_cast<const float4*>(q)[t + 4 * j]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        uint32_t ab[4] = {0u, 0u, 0u, 0u}, as[4] = {0u, 0u, 0u, 0u};
        split_tf32(h ? x.z : x.x, ab[0], as[0]);
        split_tf32(h ? x.w : x.y, ab[2], as[2]);
        const uint32_t bb[2] = {big[j][2 * h], big[j][2 * h + 1]};
        const uint32_t bs[2] = {small[j][2 * h], small[j][2 * h + 1]};
        mma_3xtf32(c[k], ab, as, bb, bs);
      }
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      acc.x += c[k][0];
      acc.y += c[k][1];
    }
    return acc;
  }
};

template <int NCH>
struct Scores<BF16, NCH> {
  uint32_t w[NCH][4];  // eight bf16 a chunk, the lower address in each word's low half
  __device__ __forceinline__ void hold(const uint4 (&v)[NCH]) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      w[j][0] = v[j].x;
      w[j][1] = v[j].y;
      w[j][2] = v[j].z;
      w[j][3] = v[j].w;
    }
  }
  // each chunk (32 depth positions) summed from zero in its own registers,
  // the chunks' products issued in turn, then added in order
  __device__ __forceinline__ float2 run(const unsigned char* q, int t, int pr) const {
    float c[NCH][4];
#pragma unroll
    for (int j = 0; j < NCH; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const bool in = q != nullptr && t + 4 * j < pr;
        const float4 x = in ? reinterpret_cast<const float4*>(q)[2 * (t + 4 * j) + h / 2]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        uint32_t ab[4] = {0u, 0u, 0u, 0u}, as[4] = {0u, 0u, 0u, 0u};
        split_tf32(h % 2 ? x.z : x.x, ab[0], as[0]);
        split_tf32(h % 2 ? x.w : x.y, ab[2], as[2]);
        const uint32_t b[2] = {w[j][h] << 16, w[j][h] & 0xffff0000u};
        mma_2xtf32(c[j], ab, as, b);
      }
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      acc.x += c[j][0];
      acc.y += c[j][1];
    }
    return acc;
  }
};

template <int NCH>
struct Scores<I8, NCH> {
  uint32_t w[NCH][4];  // sixteen int8 a chunk
  __device__ __forceinline__ void hold(const uint4 (&v)[NCH]) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      w[j][0] = v[j].x;
      w[j][1] = v[j].y;
      w[j][2] = v[j].z;
      w[j][3] = v[j].w;
    }
  }
  __device__ __forceinline__ int2 run(const unsigned char* q, int t, int pr) const {
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const bool in = q != nullptr && t + 4 * j < pr;
      const uint4 x = in ? reinterpret_cast<const uint4*>(q)[t + 4 * j] : make_uint4(0, 0, 0, 0);
      const uint32_t a0[4] = {x.x, 0u, x.y, 0u}, a1[4] = {x.z, 0u, x.w, 0u};
      const uint32_t b0[2] = {w[j][0], w[j][1]}, b1[2] = {w[j][2], w[j][3]};
      mma_s8(c, a0, b0);
      mma_s8(c, a1, b1);
    }
    return make_int2(c[0], c[1]);
  }
};

// 16 bytes of shared memory, read now: the compiler may not read them again
// later, after the stage has been refilled
__device__ __forceinline__ uint4 ld_shared_v4(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(smem_addr(p)));
  return v;
}

// e / kb for 0 <= e < 2^24: the float quotient is off by at most one
__device__ __forceinline__ int row_of(int e, int kb, float inv_kb) {
  int b = __float2int_rz((float)e * inv_kb);
  b += (b + 1) * kb <= e;
  b -= b * kb > e;
  return b;
}

// Block g of G scores the keys it owns, window by window (module comment).
// Dynamic shared memory: the ring's barriers; STAGES bin stages
// (STAGE_BYTES) and QSTAGES query stages (the query rows of up to QC pairs,
// QROW_MAX each); the window's pair list (WINDOW), sorted by key; for each of
// the nloc keys a block owns its count and its start in the list (one more);
// and the items, runs of at most QC pairs of one key (their first and last +
// 1 in the list). Warp w holds rows 8 w .. 8 w + 7 of the bin as the B
// operand of Scores (lane 4 g + t: row 8 w + g, NCH = L / 4 chunks of it; L
// the power of two at or above the row's 16-byte pieces).
template <int KIND, int L>
__global__ void __launch_bounds__(THREADS, 2)
rescore_bins(const void* __restrict__ q, const unsigned char* __restrict__ cand,
             const int* __restrict__ bin_idx, void* __restrict__ out, int B, int D, int kb,
             int n_bins, int ng, int nloc) {
  using Acc = typename std::conditional<KIND == I8, int, float>::type;
  constexpr int NCH = L / 4;  // 16-byte chunks of its row a lane holds
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* bins = smem + BAR_BYTES;
  unsigned char* qrows = bins + STAGES * STAGE_BYTES;
  int* list = reinterpret_cast<int*>(qrows + QSTAGES * QC * QROW_MAX);
  int* cnt = list + WINDOW;
  int* start = cnt + nloc;
  int* item_a = start + nloc + 1;
  int* item_z = item_a + ITEMS_MAX;
  __shared__ int n_items;

  const int tid = threadIdx.x, lane = tid & 31, g = blockIdx.x;
  const int gshift = __ffs(gridDim.x) - 1;  // the grid is a power of two
  const float inv_kb = 1.f / kb;
  const int item = KIND == I8 ? 1 : KIND == BF16 ? 2 : 4;
  const int row_bytes = D * item, pr = row_bytes / 16, bin_bytes = BS * row_bytes;
  const int qrow_bytes = KIND == I8 ? D : D * 4;
  const int g4 = lane >> 2, t4 = lane & 3;  // the lane's row of A / B and column group
  const int row = 8 * (tid >> 5) + g4;       // the bin row the lane holds
  const int total = B * kb;
  const unsigned char* qb = static_cast<const unsigned char*>(q);
  Acc* o = static_cast<Acc*>(out);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
  }
  __syncthreads();

  int used = 0;  // items copied and scored so far, the same in every thread
  for (int w0 = 0; w0 < total; w0 += WINDOW) {
    for (int i = tid; i < nloc; i += THREADS) cnt[i] = 0;
    // the scan: this block's pairs, each with its key and its place among
    // the key's pairs; every selection loaded before the first is looked at
    int key[PER_THREAD], slot[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = w0 + i * THREADS + tid;
      key[i] = e < total ? bin_idx[e] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = w0 + i * THREADS + tid, bin = key[i];
      key[i] = -1;
      if (e >= total) continue;
      if (bin < 0 || bin >= n_bins) {
        if (g == 0)
          for (int t = 0; t < BS; ++t)
            o[(size_t)e * BS + t] = KIND == I8 ? (Acc)INT32_MIN : (Acc)__int_as_float(0x7fc00000);
        continue;
      }
      const int k = bin * ng + row_of(e, kb, inv_kb) / QUERY_GROUP;
      if ((k & (gridDim.x - 1)) != g) continue;
      key[i] = k >> gshift;
      slot[i] = atomicAdd(cnt + key[i], 1);
    }
    __syncthreads();
    if (tid < 32) {  // each key's start in the list, and its items in order
      int carry = 0, items = 0;
      for (int i0 = 0; i0 < nloc; i0 += 32) {
        const int i = i0 + lane, n = i < nloc ? cnt[i] : 0, m = (n + QC - 1) / QC;
        int x = n, y = m;  // inclusive scans of the counts and of the items
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int xo = __shfl_up_sync(FULL, x, off), yo = __shfl_up_sync(FULL, y, off);
          if (lane >= off) {
            x += xo;
            y += yo;
          }
        }
        const int a = carry + x - n;
        if (i < nloc) start[i] = a;
        for (int t = 0; t < m; ++t) {
          item_a[items + y - m + t] = a + t * QC;
          item_z[items + y - m + t] = a + min(n, (t + 1) * QC);
        }
        carry += __shfl_sync(FULL, x, 31);
        items += __shfl_sync(FULL, y, 31);
      }
      if (lane == 0) {
        start[nloc] = carry;
        n_items = items;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      if (key[i] >= 0) list[start[key[i]] + slot[i]] = w0 + i * THREADS + tid;
    __syncthreads();

    const int nb = n_items;
    // warp 0: the copies of item n, its bin into bin stage u % STAGES and
    // the query rows of its pairs, in order, into query stage u % QSTAGES,
    // both counted on barrier u % STAGES (u: the item's number in the block)
    auto issue = [&](int n, int u) {
      const int a = item_a[n], m = item_z[n] - a;
      uint64_t* bar = full + u % STAGES;
      unsigned char* qs = qrows + (u % QSTAGES) * (QC * QROW_MAX);
      if (lane == 0) {
        mbar_arrive_expect(bar, bin_bytes + m * qrow_bytes);
        bulk_copy(bins + (u % STAGES) * STAGE_BYTES, cand + (size_t)bin_idx[list[a]] * bin_bytes,
                  bin_bytes, bar);
      }
      __syncwarp();
      if (lane < m)
        bulk_copy(qs + lane * qrow_bytes, qb + (size_t)row_of(list[a + lane], kb, inv_kb) *
                  qrow_bytes, qrow_bytes, bar);
    };
    if (tid < 32)
      for (int n = 0; n < nb && n < STAGES; ++n) issue(n, used + n);
    for (int n = 0; n < nb; ++n, ++used) {
      mbar_wait(full + used % STAGES, (used / STAGES) & 1);
      const unsigned char* st = bins + (used % STAGES) * STAGE_BYTES;
      uint4 w[NCH];
#pragma unroll
      for (int j = 0; j < NCH; ++j)
        w[j] = t4 + 4 * j < pr ? ld_shared_v4(st + row * row_bytes + 16 * (t4 + 4 * j))
                               : make_uint4(0, 0, 0, 0);
      Scores<KIND, NCH> sc;
      sc.hold(w);
      // the bin stage is read (the query stage of item `used` is next
      // written by item used + QSTAGES, issued after this item is scored)
      __syncthreads();
      if (tid < 32 && n + STAGES < nb) issue(n + STAGES, used + STAGES);
      const int a = item_a[n], m = item_z[n] - a;
      const unsigned char* qs = qrows + (used % QSTAGES) * (QC * QROW_MAX);
      const auto v = sc.run(g4 < m ? qs + g4 * qrow_bytes : nullptr, t4, pr);
      if (g4 < m) {
        Acc* to = o + (size_t)list[a + g4] * BS + 8 * (tid >> 5) + 2 * t4;
        to[0] = v.x;
        to[1] = v.y;
      }
    }
    __syncthreads();  // the window's list and counts are done with
  }
}

// ---------------------------------------------------------------------------
// the first design: the route for other shapes
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
rescore(const float* __restrict__ q, const T* __restrict__ cand,
        const int* __restrict__ bin_idx, float* __restrict__ out,
        int D, int kb, int bs, int n_bins) {
  extern __shared__ float qs[];  // [D]
  const int b = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += THREADS) qs[d] = q[(size_t)b * D + d];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = kb * bs;
  for (int r = warp; r < rows; r += WARPS) {
    const int j = r / bs;
    const int s = r - j * bs;
    const int bin = bin_idx[(size_t)b * kb + j];
    float acc = 0.f;
    if (bin >= 0 && bin < n_bins) {  // warp-uniform
      const T* row = cand + ((size_t)bin * bs + s) * D;
#pragma unroll 4
      for (int d = lane; d < D; d += 32) acc = fmaf(qs[d], to_f32(row[d]), acc);
      for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
    } else {
      acc = __int_as_float(0x7fc00000);  // NaN
    }
    if (lane == 0) out[(size_t)b * rows + r] = acc;
  }
}

// int8 x int8 -> int32; PACKED: D % 4 == 0 and the catalog 4-byte aligned,
// so that every row is whole 4-byte words
template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
rescore_i8(const int8_t* __restrict__ q, const int8_t* __restrict__ cand,
           const int* __restrict__ bin_idx, int* __restrict__ out,
           int D, int kb, int bs, int n_bins) {
  extern __shared__ int qw[];  // [ceil(D/4)] words: the query row's bytes
  int8_t* qs = reinterpret_cast<int8_t*>(qw);
  const int b = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += THREADS) qs[d] = q[(size_t)b * D + d];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = kb * bs;
  for (int r = warp; r < rows; r += WARPS) {
    const int j = r / bs;
    const int s = r - j * bs;
    const int bin = bin_idx[(size_t)b * kb + j];
    int acc = 0;
    if (bin >= 0 && bin < n_bins) {  // warp-uniform
      const int8_t* row = cand + ((size_t)bin * bs + s) * D;
      if (PACKED) {
        const int* roww = reinterpret_cast<const int*>(row);
#pragma unroll 4
        for (int w = lane; w < D / 4; w += 32) acc = __dp4a(qw[w], roww[w], acc);
      } else {
        for (int d = lane; d < D; d += 32) acc += (int)qs[d] * (int)row[d];
      }
      for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
    } else {
      acc = INT32_MIN;
    }
    if (lane == 0) out[(size_t)b * rows + r] = acc;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// the lanes a row of the bin-major form takes: the power of two at or above
// its 16-byte pieces (4 to 32), or 0 where it takes no such rows
int lanes_for(int kind, int D) {
  const int item = kind == I8 ? 1 : kind == BF16 ? 2 : 4;
  const long row_bytes = (long)D * item;
  if (row_bytes % 16 || row_bytes > 512) return 0;
  const int pr = (int)(row_bytes / 16);
  return pr <= 4 ? 4 : pr <= 8 ? 8 : pr <= 16 ? 16 : 32;
}

// a bin-major kernel, its shared memory allowed, and the blocks the card
// holds at once (the first call's card; a negative value is a CUDA error,
// negated)
template <int KIND, int L>
int bins_cap() {
  static const int cap = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rescore_bins<KIND, L>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BINS_SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rescore_bins<KIND, L>,
                                                          THREADS, BINS_SMEM);
    return err != cudaSuccess ? -(int)err : per_sm * sms > 0 ? per_sm * sms : 1;
  }();
  return cap;
}

template <int KIND>
int cap_lanes(int L) {
  return L == 4 ? bins_cap<KIND, 4>() : L == 8 ? bins_cap<KIND, 8>()
                : L == 16 ? bins_cap<KIND, 16>() : bins_cap<KIND, 32>();
}

int cap_for(int kind, int L) {
  return kind == I8 ? cap_lanes<I8>(L) : kind == BF16 ? cap_lanes<BF16>(L) : cap_lanes<F32>(L);
}

// the bin-major form's keys (bins times query groups), and its grid for them
// on this card: a power of two (ownership by a mask), at most the blocks the
// card holds at once and at most one block a key
long bins_keys(int B, int n_bins) { return (long)n_bins * ((B + QUERY_GROUP - 1) / QUERY_GROUP); }

int bins_grid(int cap, int B, int n_bins) {
  const long keys = bins_keys(B, n_bins);
  int G = 1;
  while (2L * G <= cap && 2L * G <= keys) G *= 2;
  return G;
}

template <int KIND, int L>
void launch_bins(int G, const void* q, const unsigned char* c, const int* bin_idx, void* out,
                 int B, int D, int kb, int n_bins, int ng, int nloc, cudaStream_t stream) {
  rescore_bins<KIND, L><<<G, THREADS, BINS_SMEM, stream>>>(q, c, bin_idx, out, B, D, kb, n_bins,
                                                          ng, nloc);
}

template <int KIND>
void launch_lanes(int L, int G, const void* q, const unsigned char* c, const int* bin_idx,
                  void* out, int B, int D, int kb, int n_bins, int ng, int nloc,
                  cudaStream_t stream) {
  if (L == 4)
    launch_bins<KIND, 4>(G, q, c, bin_idx, out, B, D, kb, n_bins, ng, nloc, stream);
  else if (L == 8)
    launch_bins<KIND, 8>(G, q, c, bin_idx, out, B, D, kb, n_bins, ng, nloc, stream);
  else if (L == 16)
    launch_bins<KIND, 16>(G, q, c, bin_idx, out, B, D, kb, n_bins, ng, nloc, stream);
  else
    launch_bins<KIND, 32>(G, q, c, bin_idx, out, B, D, kb, n_bins, ng, nloc, stream);
}

// 1 where the bin-major form takes these operands (the module comment's
// rule), 0 where the first design does; a negative value is a CUDA error,
// negated
int route(const void* q, const void* cand, int kind, int D, int bs, int n_bins, int B, int kb) {
  const int L = lanes_for(kind, D);
  const long qrow_bytes = kind == I8 ? D : 4L * D;
  if (bs != BS || !L || qrow_bytes > QROW_MAX || !aligned16(q) || !aligned16(cand) ||
      (long)B * kb >= 1L << 24 || bins_keys(B, n_bins) > INT32_MAX)
    return 0;
  const int cap = cap_for(kind, L);
  if (cap < 0) return cap;
  const int G = bins_grid(cap, B, n_bins);
  return (bins_keys(B, n_bins) + G - 1) / G <= NLOC_MAX ? 1 : 0;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 where binned_rescore launches the bin-major form (rescore_bins) for these
// operands, 0 where it launches the first design (rescore, rescore_i8); a
// negative value is a CUDA error, negated. Arguments as binned_rescore's.
extern "C" int binned_rescore_route(const void* q, const void* cand, int cand_dtype, int B,
                                    int D, int kb, int bs, int n_bins) {
  if (cand_dtype < 0 || cand_dtype > 2 || kb < 1) return -(int)cudaErrorInvalidValue;
  return route(q, cand, cand_dtype, D, bs, n_bins, B, kb);
}

// The bin-major form's grid (blocks) for these bins and this row width on
// this card; a negative value is a CUDA error, negated.
extern "C" int binned_rescore_grid(int cand_dtype, int B, int D, int n_bins) {
  const int L = lanes_for(cand_dtype, D);
  if (cand_dtype < 0 || cand_dtype > 2 || !L) return -(int)cudaErrorInvalidValue;
  const int cap = cap_for(cand_dtype, L);
  return cap < 0 ? cap : bins_grid(cap, B, n_bins);
}

// The bin-major form's constants: the selections a block scans at a time
// (0), the query rows of a group (1), the pairs of an item (2).
extern "C" int binned_rescore_const(int which) {
  return which == 0 ? WINDOW : which == 1 ? QUERY_GROUP : which == 2 ? QC : -1;
}

// cand_dtype 0: q (B, D) f32, cand (n_bins*bs, D) f32, out (B, kb*bs) f32;
// 1: the same with bf16 cand; 2: q and cand int8, out int32. bin_idx (B, kb)
// int32. Returns cudaGetLastError() after the launch.
extern "C" int binned_rescore(const void* q, const void* cand, int cand_dtype,
                              const int* bin_idx, void* out, int B, int D, int kb,
                              int bs, int n_bins, cudaStream_t stream) {
  if (B < 1 || D < 1 || kb < 1 || bs < 1 || n_bins < 1 || cand_dtype < 0 || cand_dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int by_bins = route(q, cand, cand_dtype, D, bs, n_bins, B, kb);
  if (by_bins < 0) return -by_bins;
  if (by_bins) {
    const int L = lanes_for(cand_dtype, D);
    const int G = bins_grid(cap_for(cand_dtype, L), B, n_bins);
    const int ng = (B + QUERY_GROUP - 1) / QUERY_GROUP;
    const int nloc = (int)((bins_keys(B, n_bins) + G - 1) / G);
    const unsigned char* c = static_cast<const unsigned char*>(cand);
    if (cand_dtype == I8)
      launch_lanes<I8>(L, G, q, c, bin_idx, out, B, D, kb, n_bins, ng, nloc, stream);
    else if (cand_dtype == BF16)
      launch_lanes<BF16>(L, G, q, c, bin_idx, out, B, D, kb, n_bins, ng, nloc, stream);
    else
      launch_lanes<F32>(L, G, q, c, bin_idx, out, B, D, kb, n_bins, ng, nloc, stream);
    return (int)cudaGetLastError();
  }
  if (cand_dtype == I8) {
    const size_t smem = (size_t)(D + 3) / 4 * sizeof(int);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int8_t* q8 = static_cast<const int8_t*>(q);
    const int8_t* c8 = static_cast<const int8_t*>(cand);
    int* o = static_cast<int*>(out);
    if (D % 4 == 0 && (reinterpret_cast<uintptr_t>(cand) & 3u) == 0)
      rescore_i8<true><<<B, THREADS, smem, stream>>>(q8, c8, bin_idx, o, D, kb, bs, n_bins);
    else
      rescore_i8<false><<<B, THREADS, smem, stream>>>(q8, c8, bin_idx, o, D, kb, bs, n_bins);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  if (cand_dtype == BF16)
    rescore<__nv_bfloat16><<<B, THREADS, smem, stream>>>(
        qf, static_cast<const __nv_bfloat16*>(cand), bin_idx, o, D, kb, bs, n_bins);
  else
    rescore<float><<<B, THREADS, smem, stream>>>(
        qf, static_cast<const float*>(cand), bin_idx, o, D, kb, bs, n_bins);
  return (int)cudaGetLastError();
}
