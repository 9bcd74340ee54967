// Flash sampled-softmax cross-entropy for sm_90a: the forward log-sum-exp and
// the two backward products, none of which writes the (Q, N) logit matrix.
//
// Replaces the TPU kernels of models_tpu/ops/flash_ce.py:
//   flash_ce_lse_forward  <- lse_forward (K1)
//   flash_ce_grad_query   <- grad_query  (K2)
//   flash_ce_grad_neg     <- grad_neg    (K3)
//
// For query row i and negative row j the logit is
//   x_ij = (sum_d q[i,d] * neg[j,d] + bias[j]) / T,
// with the sum before the division replaced by MIN_FLOAT (float16.min / 100)
// where downscoring is on and nid[j] == pid[i]. A null pid, nid or bias means
// none (no masking, zero bias). D <= 256; any Q and N >= 1.
//
//   K1: (m_i, s_i) with m_i = max(pos_i, max_j x_ij) and
//       s_i = exp(pos_i - m_i) + sum_j exp(x_ij - m_i).
//   K2: dq[i]   = sum_j coef_ij * neg[j],  coef_ij = gw_i * exp(x_ij - lse_i) / T
//   K3: dneg[j] = sum_i coef_ij * q[i]
//
// Design. The TPU grid walked the negatives in order and carried (m, s), or
// the dq / dneg block, in VMEM from one grid step to the next. Blocks on
// Hopper run in parallel and carry nothing.
//   K1: block (row tile, split) scores BR query rows against its split of the
//     negatives, BC rows at a time, in fp32 FMAs over d in order. Each thread
//     keeps an online (max, sum) for its 4 rows over the columns it scores;
//     at the end the 16 threads sharing a row merge theirs with shuffles and
//     write one partial per (split, row). lse_merge folds the partials and
//     the positive logit. Splits are sized so that the grid fills the card
//     once. Its tiles are loaded without double buffering.
//   K2 / K3: one kernel, grad_rows, on the tensor cores. A block owns GBR = 64
//     rows (queries for K2, negatives for K3) and streams one chunk of the
//     other side in tiles of 64 rows (32 at D > 128).
//     - Products: both, the logit recompute own x tile^T over d and
//       coef x tile over the tile's rows, run on
//       mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 with the 3xTF32 split:
//       x = big + small, big x's TF32 part, small the exact remainder (the
//       tensor core reads its top 10 mantissa bits), and a product is
//       small*big' + big*small' + big*big' in fp32: about 2^-21 relative per
//       product, near fp32's, where one TF32 pass gives 1e-3.
//     - Sums: the tensor cores round their fp32 sums toward zero. In one
//       accumulator over a chunk's 4096 rows that drift passes the
//       kernel's tolerance; in 64-row sums (24 mma) the kernel keeps it, but
//       the drift is one-signed, and the model's parameter gradients, sums
//       over 8192 rows whose query and negative parts nearly cancel,
//       multiply it many times. So each sum of the second product runs over
//       32 rows (12 mma) and each of the logits over 32 columns, starts from
//       0 and joins its accumulator by an fp32 add (round to nearest). The
//       split rounds to nearest too: a truncating one shrinks every product.
//     - Warps own rows: each of the 4 warps owns 16 rows, computes their
//       16 x 64 logits, turns them into coefficients in registers and
//       accumulates its 16 x D result in registers (64 per lane at D = 128).
//       The coefficients go from the first product's C fragment straight to
//       the second's A fragment: k-step j of the second product takes the
//       tile rows 8j + 2t (k = t) and 8j + 2t + 1 (k = t + 4) for lane
//       quad position t, the two columns that lane holds; a sum over the
//       rows is order-free. No coefficient crosses a warp.
//     - Copies: the tiles, with their per-row bias / ids / lse / gw, arrive
//       by cp.async (16 bytes where D % 4 == 0 and the rows are aligned,
//       else 4) into a ring of two stages: the next tile is in flight while
//       the current one is consumed, one __syncthreads a tile. Rows past the
//       end and columns past D are zero-filled (source size 0); widths run
//       padded to DP in {64, 128, 256}: the zeros add exact zeros, and no
//       branch on D sits inside the products, so that loads and independent
//       mma chains interleave. Shared rows are DP + 4 floats, 4 mod 32
//       banks: the logits' fragments come by ldmatrix.x4 (four 8 x 4 fp32
//       matrices a load), the second product's by 4-byte loads, all
//       conflict-free.
//     - Filling the card: the streamed side is cut into S chunks, as K1
//       cuts its negatives, S = (blocks the card holds) / (own tiles), so
//       that at Q = N = 8192 the grid is 128 x 2 = 256 blocks, two per SM.
//       Each (own tile, chunk) block writes a partial (S, n_own, D) to
//       scratch the caller gives, and grad_merge sums the partials in chunk
//       order; with one chunk the block writes the result. No atomics: the
//       result is the same bits from run to run.
//
// Bound on an H100 SXM at Q = N = 8192, D = 128: operations. K1 does
// 2*Q*N*D = 17.2 GFLOP (0.256 ms at 67 TFLOP/s, fp32 outside the tensor
// cores). K2 and K3 do 4*Q*N*D = 34.4 GFLOP each (the recompute and the
// product); as 3xTF32 that is 103 GFLOP on the TF32 tensor cores, 0.208 ms
// at 495 TFLOP/s (0.513 ms as fp32 on the CUDA cores, the earlier design's
// bound). Their operands are 4 MB; Q*N exponentials add little. What held
// the fp32 design (1.59 ms) back, and what this one does about it: the CUDA
// cores' 67 TFLOP/s ceiling (the tensor cores at 3xTF32); one block of 8
// warps per SM on 128 of 132 SMs (two blocks of 4 warps on every SM, through
// the chunks); synchronous 4-byte tile loads and three barriers a tile
// (cp.async into two stages, one barrier, coefficients kept in registers).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BR = 64;         // rows a block owns
constexpr int BC = 64;         // rows of one streamed tile
constexpr int THREADS = 256;   // 16 x 16 threads: ty = tid / 16, tx = tid % 16
constexpr int PAD = 4;         // floats after each shared row: conflict-free float4 reads
constexpr int DMAX = 256;
constexpr int SPLITS_MAX = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float MIN_FLOAT = -0x1.47851ep+9f;  // float16.min / 100 = -655.04, as float32
constexpr float EMPTY = -FLT_MAX;             // the max over no logit

static_assert(THREADS == 256 && BR == 64 && BC == 64, "thread (ty, tx) holds rows ty + 16a, columns tx + 16b");

template <int DP>
constexpr size_t lse_smem() { return (size_t)(BR + BC) * (DP + PAD) * sizeof(float); }

// rows [r0, r0 + 64) of a (rows, D) matrix into shared memory as [64][DP + PAD];
// rows at or past `rows` and columns at or past D are zero
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int r0, int rows, int D) {
  for (int i = threadIdx.x; i < 64 * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    float v = 0.f;
    if (r0 + r < rows && d < D) v = src[(size_t)(r0 + r) * D + d];
    dst[r * (DP + PAD) + d] = v;
  }
}

// acc[a][b] = dot(A row ty + 16a, B row tx + 16b), fp32 FMAs over d in order
template <int DP>
__device__ __forceinline__ void dot_tile(const float* As, const float* Bs, int ty, int tx,
                                         float acc[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(As + (ty + 16 * a) * (DP + PAD) + d);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bv[b] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * b) * (DP + PAD) + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        acc[a][b] = fmaf(av[a].x, bv[b].x, acc[a][b]);
        acc[a][b] = fmaf(av[a].y, bv[b].y, acc[a][b]);
        acc[a][b] = fmaf(av[a].z, bv[b].z, acc[a][b]);
        acc[a][b] = fmaf(av[a].w, bv[b].w, acc[a][b]);
      }
  }
}

__device__ __forceinline__ float logit(float dot, float bias, bool masked, float T) {
  const float x = masked ? MIN_FLOAT : dot + bias;
  return x / T;
}

// ---------------------------------------------------------------------------
// K1: online log-sum-exp
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(THREADS)
lse_partial(const float* __restrict__ q, const float* __restrict__ neg,
            const int* __restrict__ pid, const int* __restrict__ nid,
            const float* __restrict__ bias, float* __restrict__ part_m,
            float* __restrict__ part_s, int Q, int N, int D, float T, int downscore,
            int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [BR][DP + PAD]
  float* ns = qs + BR * (DP + PAD);  // [BC][DP + PAD]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * BR;
  const int split = blockIdx.y;
  const int c_begin = split * chunk;
  const int c_end = min(c_begin + chunk, N);

  load_rows<DP>(qs, q, r0, Q, D);
  int my_pid[4];
  float m[4], s[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = r0 + ty + 16 * a;
    my_pid[a] = (downscore && i < Q) ? pid[i] : 0;
    m[a] = EMPTY;
    s[a] = 0.f;
  }

  for (int c0 = c_begin; c0 < c_end; c0 += BC) {
    __syncthreads();  // the previous tile is consumed
    load_rows<DP>(ns, neg, c0, c_end, D);
    __syncthreads();
    float acc[4][4];
    dot_tile<DP>(qs, ns, ty, tx, acc);
    float bj[4];
    int nj[4];
    bool ok[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = c0 + tx + 16 * b;
      ok[b] = j < c_end;
      bj[b] = (bias && ok[b]) ? bias[j] : 0.f;
      nj[b] = (downscore && ok[b]) ? nid[j] : 0;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float x[4];
      float tmax = EMPTY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        x[b] = logit(acc[a][b], bj[b], downscore && nj[b] == my_pid[a], T);
        if (ok[b]) tmax = fmaxf(tmax, x[b]);
      }
      const float mn = fmaxf(m[a], tmax);
      float add = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (ok[b]) add += expf(x[b] - mn);
      s[a] = s[a] * expf(m[a] - mn) + add;
      m[a] = mn;
    }
  }

  // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int off = 8; off; off >>= 1) {
      const float mo = __shfl_xor_sync(FULL, m[a], off);
      const float so = __shfl_xor_sync(FULL, s[a], off);
      const float mn = fmaxf(m[a], mo);
      s[a] = s[a] * expf(m[a] - mn) + so * expf(mo - mn);
      m[a] = mn;
    }
    const int i = r0 + ty + 16 * a;
    if (tx == 0 && i < Q) {
      part_m[(size_t)split * Q + i] = m[a];
      part_s[(size_t)split * Q + i] = s[a];
    }
  }
}

__global__ void lse_merge(const float* __restrict__ pos_logit, const float* __restrict__ part_m,
                          const float* __restrict__ part_s, float* __restrict__ m_out,
                          float* __restrict__ s_out, int Q, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const float pos = pos_logit[i];
  float m = pos;
  for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, part_m[(size_t)sp * Q + i]);
  float s = expf(pos - m);
  for (int sp = 0; sp < splits; ++sp)
    s += part_s[(size_t)sp * Q + i] * expf(part_m[(size_t)sp * Q + i] - m);
  m_out[i] = m;
  s_out[i] = s;
}

// ---------------------------------------------------------------------------
// K2 / K3: the backward products on the tensor cores (3xTF32 mma.sync)
// ---------------------------------------------------------------------------

constexpr int GBR = 64;        // own rows a block holds: 4 warps x 16
constexpr int GTHREADS = 128;
constexpr int GPAD = 4;        // row stride DP + 4 = 4 mod 32 banks

// streamed rows per tile: at DP = 256 the 16 x DP accumulator takes 128
// registers a lane, so the logit tile shrinks to 16 x 32
template <int DP>
__host__ __device__ constexpr int grad_bc() { return DP == 256 ? 32 : 64; }

// one stage: the tile [BC][DP + GPAD], then BC floats each of the streamed
// rows' first and second float input and their ids
template <int DP>
__host__ __device__ constexpr int grad_stage() { return grad_bc<DP>() * (DP + GPAD) + 3 * grad_bc<DP>(); }

template <int DP>
constexpr size_t grad_smem() {
  return ((size_t)GBR * (DP + GPAD) + 2 * (size_t)grad_stage<DP>()) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [r0, r0 + ROWS) of a (rows, D) matrix, those below r_end, into shared
// [ROWS][DP + GPAD] by cp.async; other rows and columns at or past D are
// zero-filled. vec: D % 4 == 0 and src 16-byte aligned.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ src,
                                                int r0, int r_end, int D, bool vec) {
  constexpr int LD = DP + GPAD;
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int i = threadIdx.x; i < ROWS * C4; i += GTHREADS) {
      const int r = i / C4, c = 4 * (i % C4);
      const bool ok = r0 + r < r_end && c < D;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * D + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += GTHREADS) {
      const int r = i / DP, c = i % DP;
      const bool ok = r0 + r < r_end && c < D;
      cp_async4(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * D + c : src, ok ? 4 : 0);
    }
  }
}

// n 4-byte entries [c0, c0 + n) of a vector, those below c_end, into shared;
// the rest, or all of them where src is null, zero-filled (`any` is a valid
// address that is not read)
__device__ __forceinline__ void load_vec_async(void* dst, const void* src, int c0, int c_end,
                                               int n, const void* any) {
  for (int i = threadIdx.x; i < n; i += GTHREADS) {
    const bool ok = src && c0 + i < c_end;
    cp_async4(static_cast<char*>(dst) + 4 * i,
              ok ? static_cast<const char*>(src) + 4 * (size_t)(c0 + i) : any, ok ? 4 : 0);
  }
}

// x = big + small: big x rounded to TF32 (to nearest, ties away: add half a
// TF32 ulp, clear the 13 low bits), small the exact remainder, of which the
// tensor core reads the top 10 mantissa bits. Three instructions; with
// cvt.rna.tf32, which guards infinities, five
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// four 8 x 4 fp32 matrices from shared memory: lane 8i + r gives the address
// of row r of matrix i; register i of lane 4g + t is element (g, t) of
// matrix i, a TF32 fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: the small terms first, then big * big
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t a_big[4],
                                           const uint32_t a_small[4], const uint32_t b_big[2],
                                           const uint32_t b_small[2]) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// OWN_Q: the block owns query rows and streams negatives (K2, dq); otherwise
// it owns negative rows and streams queries (K3, dneg). Block (own tile x,
// chunk y) streams rows [y * chunk, min((y + 1) * chunk, n_strm)) and writes
// its (n_own, D) sum to dst + y * n_own * D.
//
// Fragments of m16n8k8 (lane = 4 g + t): A (16 x 8) a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, k x n) b0 (t, g), b1 (t + 4, g);
// C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
template <int DP, bool OWN_Q>
__global__ void __launch_bounds__(GTHREADS)
grad_rows(const float* __restrict__ q, const float* __restrict__ neg,
          const float* __restrict__ lse, const float* __restrict__ gw,
          const int* __restrict__ pid, const int* __restrict__ nid,
          const float* __restrict__ bias, float* __restrict__ dst, int Q, int N, int D,
          float T, int downscore, int chunk, int vec) {
  // MG: output n-tiles a pass; JG: k-steps of the second product summed
  // from 0 before each fp32 add (see "Sums" above)
  constexpr int BCT = grad_bc<DP>(), LD = DP + GPAD, NJ = BCT / 8, NM = DP / 8, MG = 8;
  constexpr int JG = NJ < 4 ? NJ : 4;
  constexpr int STAGE = grad_stage<DP>();
  extern __shared__ __align__(16) float smem[];
  float* os = smem;               // [GBR][LD] own rows
  float* stages = os + GBR * LD;  // two stages
  const float* own = OWN_Q ? q : neg;
  const float* strm = OWN_Q ? neg : q;
  const int n_own = OWN_Q ? Q : N;
  const int n_strm = OWN_Q ? N : Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * GBR;
  const int c_begin = blockIdx.y * chunk;
  const int c_end = min(c_begin + chunk, n_strm);
  // the streamed rows' inputs: K2 (bias, -, nid), K3 (lse, gw, pid)
  const float* s_f0 = OWN_Q ? bias : lse;
  const float* s_f1 = OWN_Q ? nullptr : gw;
  const int* s_id = downscore ? (OWN_Q ? nid : pid) : nullptr;

  auto load_stage = [&](int buf, int c0) {
    float* ss = stages + buf * STAGE;
    load_tile_async<DP, BCT>(ss, strm, c0, c_end, D, vec);
    float* meta = ss + BCT * LD;
    load_vec_async(meta, s_f0, c0, c_end, BCT, strm);
    load_vec_async(meta + BCT, s_f1, c0, c_end, BCT, strm);
    load_vec_async(meta + 2 * BCT, s_id, c0, c_end, BCT, strm);
    cp_async_commit();
  };
  load_tile_async<DP, GBR>(os, own, r0, n_own, D, vec);
  load_stage(0, c_begin);  // one group: the own rows and the first tile

  // the lane's own rows: g and g + 8 of the warp's 16; (lse, gw, pid) for a
  // query, (bias, nid) for a negative
  float o_lse[2], o_gw[2], o_bias[2];
  int o_id[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    const bool ok = r < n_own;
    o_lse[h] = (OWN_Q && ok) ? lse[r] : 0.f;
    o_gw[h] = (OWN_Q && ok) ? gw[r] : 0.f;
    o_bias[h] = (!OWN_Q && bias && ok) ? bias[r] : 0.f;
    o_id[h] = (downscore && ok) ? (OWN_Q ? pid[r] : nid[r]) : 0;
  }

  // 1/T once: two IEEE divisions per coefficient would cost as much as the
  // products' operand splits (exact at T = 1; one ulp of the logit else)
  const float inv_t = 1.f / T;
  float acc[NM][4];
#pragma unroll
  for (int m = 0; m < NM; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  int buf = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += BCT, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in, and every warp is done with the other stage
    if (c0 + BCT < c_end) load_stage(buf ^ 1, c0 + BCT);
    const float* ss = stages + buf * STAGE;
    // ldmatrix rows: lane 8i + r reads row r of matrix i; A: rows + 8 (i & 1),
    // columns + 4 (i >> 1); B (a pair of j): rows + 8 (i >> 1), columns + 4 (i & 1)
    const float* a_ldm = os + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 4 * (lane >> 4);
    const float* b_ldm = ss + (8 * (lane >> 4) + (lane & 7)) * LD + 4 * ((lane >> 3) & 1);
    const float* m_f0 = ss + BCT * LD;
    const float* m_f1 = m_f0 + BCT;
    const int* m_id = reinterpret_cast<const int*>(m_f1 + BCT);

    // the warp's 16 x BCT logits: s[j] covers tile rows 8j .. 8j + 7. Each
    // 32 columns of d are summed from 0 and join s by an fp32 add. Columns
    // past D are zeros: no branch inside the products, so that loads and
    // independent mma chains interleave
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int k0 = 0; k0 < DP; k0 += 32) {
      float part[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
      for (int kd = k0; kd < k0 + 32; kd += 8) {
        uint32_t ab[4], al[4];
        ldmatrix_x4(ab, a_ldm + kd);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(ab[e]), ab[e], al[e]);
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t bb[4], bl[4];  // b0, b1 of j, then of j + 1
          ldmatrix_x4(bb, b_ldm + 8 * j * LD + kd);
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(bb[e]), bb[e], bl[e]);
          mma_3xtf32(part[j], ab, al, bb, bl);
          mma_3xtf32(part[j + 1], ab, al, bb + 2, bl + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
    }

    // coefficients, in place: element e of s[j] is own row g + 8 (e >> 1),
    // tile row 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const bool ok = c0 + col < c_end;
        const bool masked = downscore && o_id[h] == m_id[col];
        const float x = (masked ? MIN_FLOAT : s[j][e] + (OWN_Q ? m_f0[col] : o_bias[h])) * inv_t;
        const float l = OWN_Q ? o_lse[h] : m_f0[col];
        const float w = OWN_Q ? o_gw[h] : m_f1[col];
        s[j][e] = ok ? w * expf(x - l) * inv_t : 0.f;
      }

    // acc += coef x tile: k-step j takes tile rows 8j + 2t (k = t) and
    // 8j + 2t + 1 (k = t + 4), so A is (c0, c2, c1, c3) of s[j], split where
    // it is used. MG output n-tiles a pass (MG independent mma chains); each
    // sums JG k-steps from 0 before its fp32 add. Output columns past D are
    // computed (zeros) and not stored
    const float* b0 = ss + 2 * t * LD + g;
#pragma unroll
    for (int m0 = 0; m0 < NM; m0 += MG) {
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += JG) {
        float sum[MG][4];
#pragma unroll
        for (int u = 0; u < MG; ++u) sum[u][0] = sum[u][1] = sum[u][2] = sum[u][3] = 0.f;
#pragma unroll
        for (int j = j0; j < j0 + JG; ++j) {
          uint32_t cb[4], cl[4];
          split_tf32(s[j][0], cb[0], cl[0]);
          split_tf32(s[j][2], cb[1], cl[1]);
          split_tf32(s[j][1], cb[2], cl[2]);
          split_tf32(s[j][3], cb[3], cl[3]);
#pragma unroll
          for (int u = 0; u < MG; ++u) {
            uint32_t bb[2], bl[2];
            split_tf32(b0[8 * j * LD + 8 * (m0 + u)], bb[0], bl[0]);
            split_tf32(b0[(8 * j + 1) * LD + 8 * (m0 + u)], bb[1], bl[1]);
            mma_3xtf32(sum[u], cb, cl, bb, bl);
          }
        }
#pragma unroll
        for (int u = 0; u < MG; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m0 + u][e] += sum[u][e];
      }
    }
  }

  float* out = dst + (size_t)blockIdx.y * n_own * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= n_own) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int d = 8 * m + 2 * t;
      if (d < D) out[(size_t)r * D + d] = acc[m][2 * h];
      if (d + 1 < D) out[(size_t)r * D + d + 1] = acc[m][2 * h + 1];
    }
  }
}

// out[i] = sum over the chunks of part[chunk][i], in chunk order
__global__ void grad_merge(const float* __restrict__ part, float* __restrict__ out, size_t n,
                           int chunks) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int c = 1; c < chunks; ++c) v += part[(size_t)c * n + i];
    out[i] = v;
  }
}

// the padded width a D runs at
int dp_for(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

template <int DP>
cudaError_t lse_blocks_per_sm(int* blocks) {
  const size_t smem = lse_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      lse_partial<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lse_partial<DP>, THREADS, smem);
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// as many (row tile, split) blocks as the card holds at once, at least one
// split and at most one a tile
int fill_splits(int per_sm, int sms, int row_blocks, int tiles) {
  const int splits = (per_sm * sms) / row_blocks;
  return splits < 1 ? 1 : splits > tiles ? tiles : splits > SPLITS_MAX ? SPLITS_MAX : splits;
}

int lse_splits(int Q, int N, int D) {
  int per_sm = 1, sms = 1;
  cudaError_t err = dp_for(D) == 64 ? lse_blocks_per_sm<64>(&per_sm)
                  : dp_for(D) == 128 ? lse_blocks_per_sm<128>(&per_sm)
                                     : lse_blocks_per_sm<256>(&per_sm);
  if (err != cudaSuccess) return -(int)err;
  if ((err = sm_count(&sms)) != cudaSuccess) return -(int)err;
  const int tiles = N > 0 ? (N + BC - 1) / BC : 1;
  return fill_splits(per_sm, sms, (Q + BR - 1) / BR, tiles);
}

template <int DP>
cudaError_t launch_lse(const float* q, const float* neg, const int* pid, const int* nid,
                       const float* bias, float* part_m, float* part_s, int Q, int N, int D,
                       float T, int downscore, int chunk, int splits, cudaStream_t stream) {
  const size_t smem = lse_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      lse_partial<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + BR - 1) / BR, splits);
  lse_partial<DP><<<grid, THREADS, smem, stream>>>(q, neg, pid, nid, bias, part_m, part_s, Q,
                                                   N, D, T, downscore, chunk);
  return cudaGetLastError();
}

template <int DP, bool OWN_Q>
cudaError_t grad_attr() {
  return cudaFuncSetAttribute(grad_rows<DP, OWN_Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)grad_smem<DP>());
}

template <int DP, bool OWN_Q>
int grad_splits_dp(int n_own, int n_strm) {
  int per_sm = 1, sms = 1;
  cudaError_t err = grad_attr<DP, OWN_Q>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grad_rows<DP, OWN_Q>, GTHREADS,
                                                        grad_smem<DP>());
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = (n_strm + grad_bc<DP>() - 1) / grad_bc<DP>();
  return fill_splits(per_sm, sms, (n_own + GBR - 1) / GBR, tiles);
}

template <bool OWN_Q>
int grad_splits(int Q, int N, int D) {
  const int n_own = OWN_Q ? Q : N, n_strm = OWN_Q ? N : Q;
  const int dp = dp_for(D);
  return dp == 64 ? grad_splits_dp<64, OWN_Q>(n_own, n_strm)
       : dp == 128 ? grad_splits_dp<128, OWN_Q>(n_own, n_strm)
                   : grad_splits_dp<256, OWN_Q>(n_own, n_strm);
}

template <int DP, bool OWN_Q>
cudaError_t launch_grad(const float* q, const float* neg, const float* lse, const float* gw,
                        const int* pid, const int* nid, const float* bias, float* part,
                        float* out, int Q, int N, int D, float T, int downscore, int splits,
                        cudaStream_t stream) {
  const int n_own = OWN_Q ? Q : N, n_strm = OWN_Q ? N : Q;
  const int tiles = (n_strm + grad_bc<DP>() - 1) / grad_bc<DP>();
  const int chunk = (tiles + splits - 1) / splits * grad_bc<DP>();
  const int used = (n_strm + chunk - 1) / chunk;  // chunks that hold a streamed row
  if (used > 1 && !part) return cudaErrorInvalidValue;
  cudaError_t err = grad_attr<DP, OWN_Q>();
  if (err != cudaSuccess) return err;
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(neg) % 16 == 0;
  const dim3 grid((n_own + GBR - 1) / GBR, used);
  grad_rows<DP, OWN_Q><<<grid, GTHREADS, grad_smem<DP>(), stream>>>(
      q, neg, lse, gw, pid, nid, bias, used > 1 ? part : out, Q, N, D, T, downscore, chunk, vec);
  if ((err = cudaGetLastError()) != cudaSuccess || used == 1) return err;
  const size_t n = (size_t)n_own * D;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  grad_merge<<<blocks, 256, 0, stream>>>(part, out, n, used);
  return cudaGetLastError();
}

template <bool OWN_Q>
int grad(const float* q, const float* neg, const float* lse, const float* gw, const int* pid,
         const int* nid, const float* bias, float* part, float* out, int Q, int N, int D,
         float T, int downscore, int splits, cudaStream_t stream) {
  if (Q < 1 || N < 1 || D < 1 || D > DMAX || splits < 1 || splits > SPLITS_MAX)
    return (int)cudaErrorInvalidValue;
  downscore = downscore && pid && nid;
  const int dp = dp_for(D);
  cudaError_t err =
      dp == 64 ? launch_grad<64, OWN_Q>(q, neg, lse, gw, pid, nid, bias, part, out, Q, N, D, T, downscore, splits, stream)
      : dp == 128 ? launch_grad<128, OWN_Q>(q, neg, lse, gw, pid, nid, bias, part, out, Q, N, D, T, downscore, splits, stream)
                  : launch_grad<256, OWN_Q>(q, neg, lse, gw, pid, nid, bias, part, out, Q, N, D, T, downscore, splits, stream);
  return (int)err;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int flash_ce_dmax() { return DMAX; }

// The number of negative splits flash_ce_lse_forward cuts N into for these
// shapes; the caller sizes part_m and part_s as (splits, Q). A negative value
// is a CUDA error, negated.
extern "C" int flash_ce_lse_splits(int Q, int N, int D) {
  if (Q < 1 || N < 0 || D < 1 || D > DMAX) return -(int)cudaErrorInvalidValue;
  return lse_splits(Q, N, D);
}

// q (Q, D), pos_logit (Q,), neg (N, D), bias (N,) or null: float32.
// pid (Q,), nid (N,): int32 or null. part_m / part_s: (splits, Q) scratch with
// splits = flash_ce_lse_splits(Q, N, D). m, s: (Q,). Returns cudaGetLastError().
extern "C" int flash_ce_lse_forward(const float* q, const float* pos_logit, const float* neg,
                                    const int* pid, const int* nid, const float* bias,
                                    float* part_m, float* part_s, float* m, float* s, int Q,
                                    int N, int D, float T, int downscore, int splits,
                                    cudaStream_t stream) {
  if (Q < 1 || N < 0 || D < 1 || D > DMAX || splits < 1 || splits > SPLITS_MAX)
    return (int)cudaErrorInvalidValue;
  downscore = downscore && pid && nid;
  const int tiles = N > 0 ? (N + BC - 1) / BC : 1;
  const int chunk = (tiles + splits - 1) / splits * BC;
  const int used = N > 0 ? (N + chunk - 1) / chunk : 1;  // splits that hold a negative
  const int dp = dp_for(D);
  cudaError_t err =
      dp == 64 ? launch_lse<64>(q, neg, pid, nid, bias, part_m, part_s, Q, N, D, T, downscore, chunk, used, stream)
      : dp == 128 ? launch_lse<128>(q, neg, pid, nid, bias, part_m, part_s, Q, N, D, T, downscore, chunk, used, stream)
                  : launch_lse<256>(q, neg, pid, nid, bias, part_m, part_s, Q, N, D, T, downscore, chunk, used, stream);
  if (err != cudaSuccess) return (int)err;
  lse_merge<<<(Q + 255) / 256, 256, 0, stream>>>(pos_logit, part_m, part_s, m, s, Q, used);
  return (int)cudaGetLastError();
}

// The number of chunks flash_ce_grad_query (own_q != 0) or flash_ce_grad_neg
// cuts the streamed side into for these shapes; with more than one the
// caller passes part, (splits, Q, D) or (splits, N, D) float32 scratch. A
// negative value is a CUDA error, negated.
extern "C" int flash_ce_grad_splits(int Q, int N, int D, int own_q) {
  if (Q < 1 || N < 1 || D < 1 || D > DMAX) return -(int)cudaErrorInvalidValue;
  return own_q ? grad_splits<true>(Q, N, D) : grad_splits<false>(Q, N, D);
}

// Dynamic shared memory of a grad_rows block at width D, in bytes.
extern "C" int flash_ce_grad_smem(int D) {
  const int dp = dp_for(D);
  return (int)(dp == 64 ? grad_smem<64>() : dp == 128 ? grad_smem<128>() : grad_smem<256>());
}

// dq (Q, D) = sum_j coef_ij * neg[j]; lse, gw (Q,) float32; part as
// flash_ce_grad_splits says (null with one chunk); the rest as above.
extern "C" int flash_ce_grad_query(const float* q, const float* neg, const float* lse,
                                   const float* gw, const int* pid, const int* nid,
                                   const float* bias, float* part, float* dq, int Q, int N,
                                   int D, float T, int downscore, int splits,
                                   cudaStream_t stream) {
  return grad<true>(q, neg, lse, gw, pid, nid, bias, part, dq, Q, N, D, T, downscore, splits,
                    stream);
}

// dneg (N, D) = sum_i coef_ij * q[i].
extern "C" int flash_ce_grad_neg(const float* q, const float* neg, const float* lse,
                                 const float* gw, const int* pid, const int* nid,
                                 const float* bias, float* part, float* dneg, int Q, int N,
                                 int D, float T, int downscore, int splits,
                                 cudaStream_t stream) {
  return grad<false>(q, neg, lse, gw, pid, nid, bias, part, dneg, Q, N, D, T, downscore, splits,
                     stream);
}
