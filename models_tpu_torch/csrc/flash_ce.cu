// Flash sampled-softmax cross-entropy for sm_90a: the forward log-sum-exp and
// the two backward products, none of which writes the (Q, N) logit matrix.
//
// Replaces the TPU kernels of models_tpu/ops/flash_ce.py:
//   flash_ce_lse_forward  <- lse_forward (K1)
//   flash_ce_grad_query   <- grad_query  (K2)
//   flash_ce_grad_neg     <- grad_neg    (K3)
//
// q and neg are both fp32 or both bf16 (the mixed_bfloat16 policy, where the
// TPU kernels take bf16 operands); every other input and every output is
// fp32. For query row i and negative row j the logit is
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
//   K1: lse_partial, on the tensor cores: grad_rows' first half. A block of
//     4 warps owns GBR = 64 query rows (16 a warp) and streams its split of
//     the negatives in tiles through the same cp.async ring. The logits come
//     from the same 3xTF32 product with the same 32-column partial sums
//     (logit_products), so K1 computes bit for bit the logits K2 / K3
//     recompute, and the forward's lse and the backward's exp(x - lse) see
//     one x. Each lane keeps an online (max, sum) for the two rows its C
//     fragment holds; a quad shuffle merges them at the end and one partial
//     per (split, row) goes out. lse_merge folds the partials and the
//     positive logit. Splits are sized from the occupancy the card reports,
//     so that the grid fills the card once.
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
// The bf16 forms (TI = bf16) are the same kernels on 16-bit tiles, half the
// shared memory and copies of the fp32 ones:
//   - Logits: one bf16 product into fp32, mma.sync.m16n8k16, no split: bf16
//     products are exact in fp32, so only the sums round (toward zero on the
//     tensor cores: each 32 columns of d, two k16 steps, are summed from 0
//     and join s by an fp32 add, as in the fp32 forms). K1 and K2 / K3 take
//     them from one function, logit_products, as the fp32 forms do.
//   - Gradient products: the fp32 coefficients times the bf16 tile widened,
//     as 2xTF32 (mma_2xtf32): the bf16 row is exact in TF32, and coef splits
//     into a TF32 part and a TF32 remainder, so the product keeps about
//     2^-21 relative, near fp32's, where one TF32 or bf16 pass keeps 1e-3.
//     A three-part bf16 split of coef on m16n8k16 would cost 3 bf16 passes
//     (3/4 of 2xTF32's tensor time) and a transposed B tile (ldmatrix.trans);
//     2xTF32 keeps the fp32 forms' fragment layout and row permutation, the
//     tile read by 2-byte loads, conflict-free at the bf16 row stride.
//   - Copies: 16-byte cp.async of 8 elements where D % 8 == 0 and the rows
//     are 16-byte aligned, else plain element loads into shared (a 2-byte
//     element has no cp.async); rows padded by 16 bytes (DP + 8 elements),
//     so that ldmatrix and the 2-byte loads are conflict-free.
//
// Bound on an H100 SXM at Q = N = 8192, D = 128: operations. K1 does
// 2*Q*N*D = 17.2 GFLOP, as 3xTF32 51.5 GFLOP on the TF32 tensor cores: 0.104
// ms at 495 TFLOP/s (0.256 ms as fp32 on the CUDA cores, the earlier
// design's bound). K2 and K3 do 4*Q*N*D = 34.4 GFLOP each (the recompute and
// the product); as 3xTF32 that is 103 GFLOP, 0.208 ms (0.513 ms as fp32).
// Their operands are 4 MB; Q*N exponentials add little. What held the fp32
// designs back (K1 0.713 ms, K2 / K3 1.59), and what these do about it: the
// CUDA cores' 67 TFLOP/s ceiling (the tensor cores at 3xTF32); one block of
// 8 warps per SM on 128 of 132 SMs (two blocks of 4 warps on every SM,
// through the splits); synchronous 4-byte tile loads with no double
// buffering and two or three barriers a tile (cp.async into two stages, one
// barrier, coefficients kept in registers). bf16 forms: K1's logits are
// 17.2 GFLOP at 989 TFLOP/s (0.017 ms) and its Q*N = 67 M exponentials at
// the SFU's 16 a clock per SM (0.016 ms at 1.98 GHz); K2 / K3 add the
// gradient product, 17.2 GFLOP: 0.069 ms as the 2xTF32 these run (495 / 2
// TFLOP/s), 0.052 ms as a three-part bf16 split (989 / 3 TFLOP/s), the
// faster arithmetic of fp32's error and the one chip_smoke.py bounds them by
// (0.017 + 0.052 = 0.069 ms with the logits).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

constexpr int DMAX = 256;
constexpr int SPLITS_MAX = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float MIN_FLOAT = -0x1.47851ep+9f;  // float16.min / 100 = -655.04, as float32
constexpr float EMPTY = -FLT_MAX;             // the max over no logit

constexpr int GBR = 64;        // own rows a block holds: 4 warps x 16
constexpr int GTHREADS = 128;

using bf16 = uint16_t;         // a bfloat16's raw bits

// streamed rows per tile: at DP = 256 the 16 x DP accumulator takes 128
// registers a lane, so the logit tile shrinks to 16 x 32
template <int DP>
__host__ __device__ constexpr int grad_bc() { return DP == 256 ? 32 : 64; }

// shared row stride in elements: DP and 16 bytes (4 fp32 or 8 bf16), 4 mod
// 32 banks, so that ldmatrix's eight rows fall on distinct banks
template <int DP, typename TI>
__host__ __device__ constexpr int grad_ld() { return DP + 16 / (int)sizeof(TI); }

// one stage: the tile [BC][LD] of TI, then BC floats each of the streamed
// rows' first and second float input and their ids
template <int DP, typename TI>
__host__ __device__ constexpr int grad_stage_bytes() {
  return grad_bc<DP>() * grad_ld<DP, TI>() * (int)sizeof(TI) + 3 * grad_bc<DP>() * 4;
}

// the own rows [GBR][LD] of TI, then two stages
template <int DP, typename TI>
constexpr size_t grad_smem() {
  return (size_t)GBR * grad_ld<DP, TI>() * sizeof(TI) + 2 * (size_t)grad_stage_bytes<DP, TI>();
}

// rows [r0, r0 + ROWS) of a (rows, D) matrix, those below r_end, into shared
// [ROWS][LD], NT threads; other rows and columns past D zero. fp32: the
// cp.async loader of mma_tf32.cuh; bf16: 16-byte cp.async where vec (D % 8
// == 0, 16-byte aligned rows), else plain element loads, which the same
// barrier publishes
template <int DP, int ROWS, int NT, typename TI>
__device__ __forceinline__ void load_rows(TI* dst, const TI* __restrict__ src, int r0, int r_end,
                                          int D, bool vec) {
  if constexpr (sizeof(TI) == 4) {
    load_tile_async<DP, ROWS, NT, 4>(dst, src, r0, r_end, D, vec);
  } else {
    constexpr int LD = grad_ld<DP, TI>();
    if (vec) {
      constexpr int C8 = DP / 8;
      for (int i = threadIdx.x; i < ROWS * C8; i += NT) {
        const int r = i / C8, c = 8 * (i % C8);
        const bool ok = r0 + r < r_end && c < D;
        cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * D + c : src, ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
        const int r = i / DP, c = i % DP;
        dst[r * LD + c] = (r0 + r < r_end && c < D) ? src[(size_t)(r0 + r) * D + c] : bf16(0);
      }
    }
  }
}

// The warp's 16 x BCT logit products, own rows (16 * warp ..) of os against
// the tile ss, both [rows][LD] in shared memory: s[j] covers tile rows
// 8j .. 8j + 7 in the C fragment's layout. fp32: 3xTF32 on m16n8k8; bf16:
// one m16n8k16 product (exact products). Each 32 columns of d are summed
// from 0 and join s by an fp32 add. Columns past D are zeros: no branch
// inside the products, so that loads and independent mma chains
// interleave. K1 and K2 / K3 both take their logits from here, so that the
// forward's lse and the backward's exp(x - lse) see the same x.
template <int DP, int NJ, typename TI>
__device__ __forceinline__ void logit_products(const TI* os, const TI* ss, int warp,
                                               int lane, float s[NJ][4]) {
  constexpr int LD = grad_ld<DP, TI>();
  constexpr int E16 = 16 / (int)sizeof(TI);  // elements in 16 bytes: a matrix row
  // ldmatrix rows: lane 8i + r reads row r of matrix i; A: rows + 8 (i & 1),
  // columns + E16 (i >> 1); B (a pair of j): rows + 8 (i >> 1), columns + E16 (i & 1)
  const TI* a_ldm = os + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + E16 * (lane >> 4);
  const TI* b_ldm = ss + (8 * (lane >> 4) + (lane & 7)) * LD + E16 * ((lane >> 3) & 1);
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  for (int k0 = 0; k0 < DP; k0 += 32) {
    float part[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
    for (int kd = k0; kd < k0 + 32; kd += 2 * E16) {  // one k-step: 8 (fp32) or 16 (bf16)
      uint32_t ab[4], al[4];
      ldmatrix_x4(ab, a_ldm + kd);
      if constexpr (sizeof(TI) == 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(ab[e]), ab[e], al[e]);
      }
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t bb[4], bl[4];  // b0, b1 of j, then of j + 1
        ldmatrix_x4(bb, b_ldm + 8 * j * LD + kd);
        if constexpr (sizeof(TI) == 4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(bb[e]), bb[e], bl[e]);
          mma_3xtf32(part[j], ab, al, bb, bl);
          mma_3xtf32(part[j + 1], ab, al, bb + 2, bl + 2);
        } else {
          mma_bf16(part[j], ab, bb);
          mma_bf16(part[j + 1], ab, bb + 2);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
  }
}

// ---------------------------------------------------------------------------
// K1: online log-sum-exp on the tensor cores
// ---------------------------------------------------------------------------

// Block (own tile x, split y): the GBR query rows of tile x against the
// negatives [y * chunk, min((y + 1) * chunk, N)), BCT at a time through the
// cp.async ring; one (m, s) partial per (split, row).
template <int DP, typename TI>
__global__ void __launch_bounds__(GTHREADS)
lse_partial(const TI* __restrict__ q, const TI* __restrict__ neg,
            const int* __restrict__ pid, const int* __restrict__ nid,
            const float* __restrict__ bias, float* __restrict__ part_m,
            float* __restrict__ part_s, int Q, int N, int D, float T, int downscore,
            int chunk, int vec) {
  constexpr int BCT = grad_bc<DP>(), LD = grad_ld<DP, TI>(), NJ = BCT / 8;
  constexpr int STAGE = grad_stage_bytes<DP, TI>();
  extern __shared__ __align__(16) unsigned char smem[];
  TI* os = reinterpret_cast<TI*>(smem);  // [GBR][LD] own query rows
  unsigned char* stages = smem + GBR * LD * sizeof(TI);  // two stages: the tile, bias, -, nid
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * GBR;
  const int c_begin = blockIdx.y * chunk;
  const int c_end = min(c_begin + chunk, N);
  const int* s_id = downscore ? nid : nullptr;

  auto load_stage = [&](int buf, int c0) {
    TI* ss = reinterpret_cast<TI*>(stages + buf * STAGE);
    load_rows<DP, BCT, GTHREADS>(ss, neg, c0, c_end, D, vec);
    float* meta = reinterpret_cast<float*>(ss + BCT * LD);
    load_vec_async<GTHREADS>(meta, bias, c0, c_end, BCT, neg);
    load_vec_async<GTHREADS>(meta + 2 * BCT, s_id, c0, c_end, BCT, neg);
    cp_async_commit();
  };
  load_rows<DP, GBR, GTHREADS>(os, q, r0, Q, D, vec);
  load_stage(0, c_begin);  // one group: the own rows and the first tile

  // the lane's rows g and g + 8 of the warp's 16: an online (max, sum) each
  // over the columns its C fragments hold
  int o_id[2];
  float m[2], sum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    o_id[h] = (downscore && r < Q) ? pid[r] : 0;
    m[h] = EMPTY;
    sum[h] = 0.f;
  }
  const float inv_t = 1.f / T;  // as K2 / K3 scale their logits

  int buf = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += BCT, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in, and every warp is done with the other stage
    if (c0 + BCT < c_end) load_stage(buf ^ 1, c0 + BCT);
    const TI* ss = reinterpret_cast<const TI*>(stages + buf * STAGE);
    const float* m_bias = reinterpret_cast<const float*>(ss + BCT * LD);
    const int* m_id = reinterpret_cast<const int*>(m_bias + 2 * BCT);
    float s[NJ][4];
    logit_products<DP, NJ>(os, ss, warp, lane, s);
    // element e of s[j] is own row g + 8 (e >> 1), tile row 8j + 2t + (e & 1);
    // a column past the chunk's end is -inf: it moves no max and adds exp = 0
    float tmax[2] = {EMPTY, EMPTY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const bool masked = downscore && o_id[h] == m_id[col];
        const float x = (masked ? MIN_FLOAT : s[j][e] + m_bias[col]) * inv_t;
        s[j][e] = c0 + col < c_end ? x : -INFINITY;
        tmax[h] = fmaxf(tmax[h], s[j][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], tmax[h]);
      float add = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) add += expf(s[j][2 * h] - mn) + expf(s[j][2 * h + 1] - mn);
      sum[h] = sum[h] * expf(m[h] - mn) + add;
      m[h] = mn;
    }
  }

  // the four lanes of a quad hold the same two rows: merge, then write
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(FULL, m[h], off);
      const float so = __shfl_xor_sync(FULL, sum[h], off);
      const float mn = fmaxf(m[h], mo);
      sum[h] = sum[h] * expf(m[h] - mn) + so * expf(mo - mn);
      m[h] = mn;
    }
    const int r = r0 + 16 * warp + g + 8 * h;
    if (t == 0 && r < Q) {
      part_m[(size_t)blockIdx.y * Q + r] = m[h];
      part_s[(size_t)blockIdx.y * Q + r] = sum[h];
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

// OWN_Q: the block owns query rows and streams negatives (K2, dq); otherwise
// it owns negative rows and streams queries (K3, dneg). Block (own tile x,
// chunk y) streams rows [y * chunk, min((y + 1) * chunk, n_strm)) and writes
// its (n_own, D) sum to dst + y * n_own * D. Fragments as in mma_tf32.cuh.
template <int DP, bool OWN_Q, typename TI>
__global__ void __launch_bounds__(GTHREADS)
grad_rows(const TI* __restrict__ q, const TI* __restrict__ neg,
          const float* __restrict__ lse, const float* __restrict__ gw,
          const int* __restrict__ pid, const int* __restrict__ nid,
          const float* __restrict__ bias, float* __restrict__ dst, int Q, int N, int D,
          float T, int downscore, int chunk, int vec) {
  // MG: output n-tiles a pass; JG: k-steps of the second product summed
  // from 0 before each fp32 add (see "Sums" above)
  constexpr int BCT = grad_bc<DP>(), LD = grad_ld<DP, TI>(), NJ = BCT / 8, NM = DP / 8, MG = 8;
  constexpr int JG = NJ < 4 ? NJ : 4;
  constexpr int STAGE = grad_stage_bytes<DP, TI>();
  extern __shared__ __align__(16) unsigned char smem[];
  TI* os = reinterpret_cast<TI*>(smem);                  // [GBR][LD] own rows
  unsigned char* stages = smem + GBR * LD * sizeof(TI);  // two stages
  const TI* own = OWN_Q ? q : neg;
  const TI* strm = OWN_Q ? neg : q;
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
    TI* ss = reinterpret_cast<TI*>(stages + buf * STAGE);
    load_rows<DP, BCT, GTHREADS>(ss, strm, c0, c_end, D, vec);
    float* meta = reinterpret_cast<float*>(ss + BCT * LD);
    load_vec_async<GTHREADS>(meta, s_f0, c0, c_end, BCT, strm);
    load_vec_async<GTHREADS>(meta + BCT, s_f1, c0, c_end, BCT, strm);
    load_vec_async<GTHREADS>(meta + 2 * BCT, s_id, c0, c_end, BCT, strm);
    cp_async_commit();
  };
  load_rows<DP, GBR, GTHREADS>(os, own, r0, n_own, D, vec);
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
    const TI* ss = reinterpret_cast<const TI*>(stages + buf * STAGE);
    const float* m_f0 = reinterpret_cast<const float*>(ss + BCT * LD);
    const float* m_f1 = m_f0 + BCT;
    const int* m_id = reinterpret_cast<const int*>(m_f1 + BCT);

    // the warp's 16 x BCT logits: s[j] covers tile rows 8j .. 8j + 7
    float s[NJ][4];
    logit_products<DP, NJ>(os, ss, warp, lane, s);

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
    // computed (zeros) and not stored. The tile: fp32 split for 3xTF32, bf16
    // widened (exact in TF32) for 2xTF32
    const TI* b0 = ss + 2 * t * LD + g;
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
            if constexpr (sizeof(TI) == 4) {
              uint32_t bb[2], bl[2];
              split_tf32(b0[8 * j * LD + 8 * (m0 + u)], bb[0], bl[0]);
              split_tf32(b0[(8 * j + 1) * LD + 8 * (m0 + u)], bb[1], bl[1]);
              mma_3xtf32(sum[u], cb, cl, bb, bl);
            } else {
              const uint32_t bb[2] = {bf16_as_tf32(b0[8 * j * LD + 8 * (m0 + u)]),
                                      bf16_as_tf32(b0[(8 * j + 1) * LD + 8 * (m0 + u)])};
              mma_2xtf32(sum[u], cb, cl, bb);
            }
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

// 16-byte copies: D a whole number of 16-byte pieces and both operands
// 16-byte aligned
template <typename TI>
int vec_copies(const void* q, const void* neg, int D) {
  return D % (16 / (int)sizeof(TI)) == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(neg) % 16 == 0;
}

// K1 keeps grad_rows' layout: own rows, then two stages of a tile and its
// per-row inputs (the second vector unused)
template <int DP, typename TI>
cudaError_t lse_attr() {
  return cudaFuncSetAttribute(lse_partial<DP, TI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)grad_smem<DP, TI>());
}

template <int DP, typename TI>
cudaError_t lse_blocks_per_sm(int* blocks) {
  cudaError_t err = lse_attr<DP, TI>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lse_partial<DP, TI>, GTHREADS,
                                                       grad_smem<DP, TI>());
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

template <typename TI>
int lse_splits(int Q, int N, int D) {
  int per_sm = 1, sms = 1;
  const int dp = dp_for(D);
  cudaError_t err = dp == 64 ? lse_blocks_per_sm<64, TI>(&per_sm)
                  : dp == 128 ? lse_blocks_per_sm<128, TI>(&per_sm)
                              : lse_blocks_per_sm<256, TI>(&per_sm);
  if (err != cudaSuccess) return -(int)err;
  if ((err = sm_count(&sms)) != cudaSuccess) return -(int)err;
  const int bc = dp == 256 ? grad_bc<256>() : grad_bc<128>();
  return fill_splits(per_sm, sms, (Q + GBR - 1) / GBR, (N + bc - 1) / bc);
}

template <int DP, typename TI>
cudaError_t launch_lse(const TI* q, const float* pos_logit, const TI* neg, const int* pid,
                       const int* nid, const float* bias, float* part_m, float* part_s,
                       float* m, float* s, int Q, int N, int D, float T, int downscore,
                       int splits, cudaStream_t stream) {
  constexpr int BCT = grad_bc<DP>();
  const int tiles = (N + BCT - 1) / BCT;
  const int chunk = (tiles + splits - 1) / splits * BCT;
  const int used = (N + chunk - 1) / chunk;  // splits that hold a negative
  cudaError_t err = lse_attr<DP, TI>();
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + GBR - 1) / GBR, used);
  lse_partial<DP, TI><<<grid, GTHREADS, grad_smem<DP, TI>(), stream>>>(
      q, neg, pid, nid, bias, part_m, part_s, Q, N, D, T, downscore, chunk,
      vec_copies<TI>(q, neg, D));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  lse_merge<<<(Q + 255) / 256, 256, 0, stream>>>(pos_logit, part_m, part_s, m, s, Q, used);
  return cudaGetLastError();
}

template <typename TI>
int lse_forward(const void* q, const float* pos_logit, const void* neg, const int* pid,
                const int* nid, const float* bias, float* part_m, float* part_s, float* m,
                float* s, int Q, int N, int D, float T, int downscore, int splits,
                cudaStream_t stream) {
  const TI* qt = static_cast<const TI*>(q);
  const TI* nt = static_cast<const TI*>(neg);
  const int dp = dp_for(D);
  return (int)(dp == 64 ? launch_lse<64, TI>(qt, pos_logit, nt, pid, nid, bias, part_m, part_s, m, s, Q, N, D, T, downscore, splits, stream)
             : dp == 128 ? launch_lse<128, TI>(qt, pos_logit, nt, pid, nid, bias, part_m, part_s, m, s, Q, N, D, T, downscore, splits, stream)
                         : launch_lse<256, TI>(qt, pos_logit, nt, pid, nid, bias, part_m, part_s, m, s, Q, N, D, T, downscore, splits, stream));
}

template <int DP, bool OWN_Q, typename TI>
cudaError_t grad_attr() {
  return cudaFuncSetAttribute(grad_rows<DP, OWN_Q, TI>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)grad_smem<DP, TI>());
}

template <int DP, bool OWN_Q, typename TI>
int grad_splits_dp(int n_own, int n_strm) {
  int per_sm = 1, sms = 1;
  cudaError_t err = grad_attr<DP, OWN_Q, TI>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grad_rows<DP, OWN_Q, TI>,
                                                        GTHREADS, grad_smem<DP, TI>());
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = (n_strm + grad_bc<DP>() - 1) / grad_bc<DP>();
  return fill_splits(per_sm, sms, (n_own + GBR - 1) / GBR, tiles);
}

template <bool OWN_Q, typename TI>
int grad_splits(int Q, int N, int D) {
  const int n_own = OWN_Q ? Q : N, n_strm = OWN_Q ? N : Q;
  const int dp = dp_for(D);
  return dp == 64 ? grad_splits_dp<64, OWN_Q, TI>(n_own, n_strm)
       : dp == 128 ? grad_splits_dp<128, OWN_Q, TI>(n_own, n_strm)
                   : grad_splits_dp<256, OWN_Q, TI>(n_own, n_strm);
}

template <int DP, bool OWN_Q, typename TI>
cudaError_t launch_grad(const TI* q, const TI* neg, const float* lse, const float* gw,
                        const int* pid, const int* nid, const float* bias, float* part,
                        float* out, int Q, int N, int D, float T, int downscore, int splits,
                        cudaStream_t stream) {
  const int n_own = OWN_Q ? Q : N, n_strm = OWN_Q ? N : Q;
  const int tiles = (n_strm + grad_bc<DP>() - 1) / grad_bc<DP>();
  const int chunk = (tiles + splits - 1) / splits * grad_bc<DP>();
  const int used = (n_strm + chunk - 1) / chunk;  // chunks that hold a streamed row
  if (used > 1 && !part) return cudaErrorInvalidValue;
  cudaError_t err = grad_attr<DP, OWN_Q, TI>();
  if (err != cudaSuccess) return err;
  const dim3 grid((n_own + GBR - 1) / GBR, used);
  grad_rows<DP, OWN_Q, TI><<<grid, GTHREADS, grad_smem<DP, TI>(), stream>>>(
      q, neg, lse, gw, pid, nid, bias, used > 1 ? part : out, Q, N, D, T, downscore, chunk,
      vec_copies<TI>(q, neg, D));
  if ((err = cudaGetLastError()) != cudaSuccess || used == 1) return err;
  const size_t n = (size_t)n_own * D;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  grad_merge<<<blocks, 256, 0, stream>>>(part, out, n, used);
  return cudaGetLastError();
}

template <bool OWN_Q, typename TI>
int grad(const void* q, const void* neg, const float* lse, const float* gw, const int* pid,
         const int* nid, const float* bias, float* part, float* out, int Q, int N, int D,
         float T, int downscore, int splits, cudaStream_t stream) {
  if (Q < 1 || N < 1 || D < 1 || D > DMAX || splits < 1 || splits > SPLITS_MAX)
    return (int)cudaErrorInvalidValue;
  downscore = downscore && pid && nid;
  const TI* qt = static_cast<const TI*>(q);
  const TI* nt = static_cast<const TI*>(neg);
  const int dp = dp_for(D);
  cudaError_t err =
      dp == 64 ? launch_grad<64, OWN_Q, TI>(qt, nt, lse, gw, pid, nid, bias, part, out, Q, N, D, T, downscore, splits, stream)
      : dp == 128 ? launch_grad<128, OWN_Q, TI>(qt, nt, lse, gw, pid, nid, bias, part, out, Q, N, D, T, downscore, splits, stream)
                  : launch_grad<256, OWN_Q, TI>(qt, nt, lse, gw, pid, nid, bias, part, out, Q, N, D, T, downscore, splits, stream);
  return (int)err;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int flash_ce_dmax() { return DMAX; }

// Every entry takes is_bf16: 0 for fp32 q and neg, 1 for bf16 (their raw
// 16-bit values); the shapes and every other input are the same for both.

// The number of negative splits flash_ce_lse_forward cuts N into for these
// shapes; the caller sizes part_m and part_s as (splits, Q). A negative value
// is a CUDA error, negated.
extern "C" int flash_ce_lse_splits(int Q, int N, int D, int is_bf16) {
  if (Q < 1 || N < 1 || D < 1 || D > DMAX) return -(int)cudaErrorInvalidValue;
  return is_bf16 ? lse_splits<bf16>(Q, N, D) : lse_splits<float>(Q, N, D);
}

// q (Q, D), neg (N, D): fp32 or bf16; pos_logit (Q,), bias (N,) or null:
// float32. pid (Q,), nid (N,): int32 or null. part_m / part_s: (splits, Q)
// scratch with splits = flash_ce_lse_splits(Q, N, D, is_bf16). m, s: (Q,).
// Returns cudaGetLastError().
extern "C" int flash_ce_lse_forward(const void* q, const float* pos_logit, const void* neg,
                                    const int* pid, const int* nid, const float* bias,
                                    float* part_m, float* part_s, float* m, float* s, int Q,
                                    int N, int D, float T, int downscore, int splits,
                                    int is_bf16, cudaStream_t stream) {
  if (Q < 1 || N < 1 || D < 1 || D > DMAX || splits < 1 || splits > SPLITS_MAX)
    return (int)cudaErrorInvalidValue;
  downscore = downscore && pid && nid;
  return is_bf16 ? lse_forward<bf16>(q, pos_logit, neg, pid, nid, bias, part_m, part_s, m, s,
                                     Q, N, D, T, downscore, splits, stream)
                 : lse_forward<float>(q, pos_logit, neg, pid, nid, bias, part_m, part_s, m, s,
                                      Q, N, D, T, downscore, splits, stream);
}

// The number of chunks flash_ce_grad_query (own_q != 0) or flash_ce_grad_neg
// cuts the streamed side into for these shapes; with more than one the
// caller passes part, (splits, Q, D) or (splits, N, D) float32 scratch. A
// negative value is a CUDA error, negated.
extern "C" int flash_ce_grad_splits(int Q, int N, int D, int own_q, int is_bf16) {
  if (Q < 1 || N < 1 || D < 1 || D > DMAX) return -(int)cudaErrorInvalidValue;
  if (is_bf16) return own_q ? grad_splits<true, bf16>(Q, N, D) : grad_splits<false, bf16>(Q, N, D);
  return own_q ? grad_splits<true, float>(Q, N, D) : grad_splits<false, float>(Q, N, D);
}

// Dynamic shared memory of a grad_rows (and lse_partial) block at width D, in bytes.
extern "C" int flash_ce_grad_smem(int D, int is_bf16) {
  const int dp = dp_for(D);
  if (is_bf16)
    return (int)(dp == 64 ? grad_smem<64, bf16>() : dp == 128 ? grad_smem<128, bf16>()
                                                             : grad_smem<256, bf16>());
  return (int)(dp == 64 ? grad_smem<64, float>() : dp == 128 ? grad_smem<128, float>()
                                                            : grad_smem<256, float>());
}

// dq (Q, D) float32 = sum_j coef_ij * neg[j]; lse, gw (Q,) float32; part as
// flash_ce_grad_splits says (null with one chunk); the rest as above.
extern "C" int flash_ce_grad_query(const void* q, const void* neg, const float* lse,
                                   const float* gw, const int* pid, const int* nid,
                                   const float* bias, float* part, float* dq, int Q, int N,
                                   int D, float T, int downscore, int splits, int is_bf16,
                                   cudaStream_t stream) {
  return is_bf16 ? grad<true, bf16>(q, neg, lse, gw, pid, nid, bias, part, dq, Q, N, D, T,
                                    downscore, splits, stream)
                 : grad<true, float>(q, neg, lse, gw, pid, nid, bias, part, dq, Q, N, D, T,
                                     downscore, splits, stream);
}

// dneg (N, D) float32 = sum_i coef_ij * q[i].
extern "C" int flash_ce_grad_neg(const void* q, const void* neg, const float* lse,
                                 const float* gw, const int* pid, const int* nid,
                                 const float* bias, float* part, float* dneg, int Q, int N,
                                 int D, float T, int downscore, int splits, int is_bf16,
                                 cudaStream_t stream) {
  return is_bf16 ? grad<false, bf16>(q, neg, lse, gw, pid, nid, bias, part, dneg, Q, N, D, T,
                                     downscore, splits, stream)
                 : grad<false, float>(q, neg, lse, gw, pid, nid, bias, part, dneg, Q, N, D, T,
                                      downscore, splits, stream);
}
