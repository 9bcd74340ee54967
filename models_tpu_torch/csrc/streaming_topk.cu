// Streaming exact top-k over a candidate matrix, for sm_90a.
//
// Replaces the TPU kernel models_tpu/ops/topk.py::pallas_topk (K6).
//
//   score(b, c) = (sum_d q[b, d] * cand[c, d]) * scale[c]
//
// in fp32 FMAs, d = 0 .. D-1 in order, then one fp32 multiply by the row's
// scale where one is given (the int8 index's per-row dequantization, as the
// JAX package's blockwise route applies its col_scale). bf16 and int8 rows
// are widened to fp32 exactly; the queries stay fp32.
// No TF32 and no tensor cores: every candidate row is scored by the same
// sequence of operations, so equal rows give bitwise-equal scores. Rows at or
// past c_real never rank. Each query row keeps the k best by (score
// descending, position ascending), the order of lax.top_k and of pallas_topk's
// first-occurrence max. The list starts as k entries (finfo(f32).min, -1)
// ranked before every candidate, as the TPU kernel's running list does.
//
// Design. The TPU grid walks the catalog in order and carries the (B, k) list
// in VMEM from step to step. Blocks on Hopper run in parallel and carry
// nothing, so the catalog is cut into `splits` chunks of `chunk` rows:
//   pass 1, topk_partial: block (row block, split) scores QB query rows
//     against its chunk, TC candidate rows at a time. The dot products run as
//     a shared-memory tiled product DK deep, each thread holding an RQ x RC
//     register tile. The tile's scores go through shared memory to one warp
//     per query row. The warp inserts each score above its running k-th best
//     into a sorted (score, position) list in shared memory, in position
//     order. After a few tiles almost no score passes the k-th best.
//   pass 2, topk_merge: one warp per query row merges the `splits` sorted
//     lists by k rounds of a warp-wide arg-max and maps positions to ids.
//
// Bound on an H100 SXM: 2*B*C*D fp32 operations at 67 TFLOP/s (fp32 outside
// the tensor cores). The catalog stream, C*D*itemsize bytes (plus 4*C of
// scales) at 3.35 TB/s, is far smaller at serving batch sizes. This first
// version issues 8 shared loads for every 16 FMAs, so shared-memory
// bandwidth, not the FMA rate, limits it.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int QB = 32;        // query rows per block
constexpr int TC = 128;       // candidate rows per tile
constexpr int DK = 32;        // depth of one shared-memory slice
constexpr int THREADS = 256;  // 8 warps
constexpr int RQ = 4;         // query rows per thread (and per selecting warp)
constexpr int RC = 4;         // candidate rows per thread
constexpr int KMAX = 512;     // list entries per row held in shared memory
constexpr int MERGE_WARPS = 4;
constexpr int SPLITS_MAX = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -FLT_MAX;  // finfo(float32).min, not -inf

static_assert(QB == RQ * (THREADS / 32), "one warp selects RQ rows");
static_assert(TC == RC * 32, "a warp spans a tile's candidates");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// (s, p) ranks before (t, r)
__device__ __forceinline__ bool ranks_before(float s, int p, float t, int r) {
  return s > t || (s == t && p < r);
}

// Insert (s, c) into the sorted list L/P of k entries. Called by a whole warp.
// Every listed position is below c, so entries with an equal score stay first.
__device__ void list_insert(float* L, int* P, int k, float s, int c, int lane) {
  int at = 0;
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    at += __popc(__ballot_sync(FULL, i < k && L[i] >= s));
  }
  if (at >= k) return;  // warp-uniform
  // shift [at, k-2] one place up, top chunk first: each chunk reads all its
  // entries before writing, and its top write lands in a chunk already moved
  for (int base = ((k - 1) / 32) * 32; base >= 0; base -= 32) {
    const int i = base + lane;
    const bool move = i >= at && i < k - 1;
    float v = 0.f;
    int p = 0;
    if (move) { v = L[i]; p = P[i]; }
    __syncwarp();
    if (move) { L[i + 1] = v; P[i + 1] = p; }
    __syncwarp();
  }
  if (lane == 0) { L[at] = s; P[at] = c; }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_partial(const float* __restrict__ q, const T* __restrict__ cand,
             const float* __restrict__ scale, float* __restrict__ part_s, int* __restrict__ part_p,
             int B, int D, int c_real, int k, int chunk, int splits) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [QB][DK]
  float* cs = qs + QB * DK;             // [TC][DK + 1], padded: no bank conflicts
  float* ss = cs + TC * (DK + 1);       // [QB][TC] scores of the current tile
  float* ls = ss + QB * TC;             // [QB][k] list scores
  int* lp = reinterpret_cast<int*>(ls + QB * k);  // [QB][k] list positions

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int c_begin = split * chunk;
  const int c_end = min(c_begin + chunk, c_real);

  for (int i = tid; i < QB * k; i += THREADS) { ls[i] = NEG_INF; lp[i] = -1; }

  for (int c0 = c_begin; c0 < c_end; c0 += TC) {
    float acc[RQ][RC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();  // the previous slice (and tile's selection) is done
      for (int i = tid; i < QB * DK; i += THREADS) {
        const int r = i / DK, d = d0 + i % DK, b = row0 + r;
        qs[i] = (b < B && d < D) ? q[(size_t)b * D + d] : 0.f;
      }
      for (int i = tid; i < TC * DK; i += THREADS) {
        const int r = i / DK, d = d0 + i % DK, c = c0 + r;
        cs[r * (DK + 1) + i % DK] =
            (c < c_end && d < D) ? to_f32(cand[(size_t)c * D + d]) : 0.f;
      }
      __syncthreads();
      const int depth = min(DK, D - d0);
      for (int d = 0; d < depth; ++d) {
        float a[RQ], v[RC];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = qs[(warp * RQ + i) * DK + d];
#pragma unroll
        for (int j = 0; j < RC; ++j) v[j] = cs[(lane + 32 * j) * (DK + 1) + d];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
      }
    }
    float scl[RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int c = c0 + lane + 32 * j;
      scl[j] = (scale != nullptr && c < c_end) ? scale[c] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j)
        ss[(warp * RQ + i) * TC + lane + 32 * j] =
            scale != nullptr ? acc[i][j] * scl[j] : acc[i][j];
    __syncthreads();

    // selection: warp w owns rows w*RQ .. w*RQ + RQ-1 of the block
    for (int i = 0; i < RQ; ++i) {
      const int r = warp * RQ + i;
      if (row0 + r >= B) break;  // warp-uniform
      float* L = ls + r * k;
      int* P = lp + r * k;
      for (int j0 = 0; j0 < TC; j0 += 32) {
        const int c = c0 + j0 + lane;
        const float s = ss[r * TC + j0 + lane];
        unsigned hits = __ballot_sync(FULL, c < c_end && s > L[k - 1]);
        while (hits) {  // in position order
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          list_insert(L, P, k, __shfl_sync(FULL, s, src), c0 + j0 + src, lane);
        }
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < QB * k; i += THREADS) {
    const int b = row0 + i / k;
    if (b < B) {
      const size_t o = ((size_t)b * splits + split) * k + i % k;
      part_s[o] = ls[i];
      part_p[o] = lp[i];
    }
  }
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
        const float t = S[sp * k + h];
        const int r = Pp[sp * k + h];
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

template <typename T>
cudaError_t launch_partial(const float* q, const void* cand, const float* scale,
                           float* part_s, int* part_p,
                           int B, int D, int c_real, int k, int chunk, int splits,
                           cudaStream_t stream) {
  const size_t smem = (size_t)(QB * DK + TC * (DK + 1) + QB * TC) * sizeof(float) +
                      (size_t)QB * k * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + QB - 1) / QB, splits);
  topk_partial<T><<<grid, THREADS, smem, stream>>>(
      q, static_cast<const T*>(cand), scale, part_s, part_p, B, D, c_real, k, chunk, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int streaming_topk_kmax() { return KMAX; }
extern "C" int streaming_topk_splits_max() { return SPLITS_MAX; }

// q (B, D) f32; cand (C, D) f32, bf16 or int8 (cand_dtype 0, 1, 2); scale
// (C,) f32 or null; ids (C,) int32 or null (positions are returned);
// part_s/part_p (B, splits, k) scratch; out_s/out_i (B, k). Split s covers
// rows [s*chunk, min((s+1)*chunk, c_real)). Returns cudaGetLastError() after
// the launches.
extern "C" int streaming_topk(const float* q, const void* cand, int cand_dtype,
                              const float* scale, const int* ids,
                              float* part_s, int* part_p, float* out_s, int* out_i,
                              int B, int D, int c_real, int k, int chunk, int splits,
                              cudaStream_t stream) {
  if (B < 1 || D < 1 || k < 1 || k > KMAX || splits < 1 || splits > SPLITS_MAX || chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (cand_dtype == 0)
    err = launch_partial<float>(q, cand, scale, part_s, part_p, B, D, c_real, k, chunk, splits,
                                stream);
  else if (cand_dtype == 1)
    err = launch_partial<__nv_bfloat16>(q, cand, scale, part_s, part_p, B, D, c_real, k, chunk,
                                        splits, stream);
  else if (cand_dtype == 2)
    err = launch_partial<int8_t>(q, cand, scale, part_s, part_p, B, D, c_real, k, chunk, splits,
                                 stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0, stream>>>(
      part_s, part_p, ids, out_s, out_i, B, k, splits);
  return (int)cudaGetLastError();
}
