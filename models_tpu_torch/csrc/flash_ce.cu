// Flash sampled-softmax cross-entropy for sm_90a: the forward log-sum-exp and
// the two backward products, none of which writes the (Q, N) logit matrix.
//
// Replaces the TPU kernels of models_tpu/ops/flash_ce.py:
//   flash_ce_lse_forward  <- lse_forward (K1; bf16 form: lse_wg)
//   flash_ce_grad_query   <- grad_query  (K2; bf16 form: grad_wg)
//   flash_ce_grad_neg     <- grad_neg    (K3; bf16 form: grad_wg)
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
//   K1: lse_partial (fp32; bf16 where lse_wg does not take the shape), on
//     the tensor cores: grad_rows' first half. A block of
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
// The bf16 forms (q and neg bf16, the mixed_bfloat16 path):
//   - K1-bf16: lse_wg, on wgmma with a TMA ring, and K2-bf16 / K3-bf16:
//     grad_wg, where D % 8 == 0, D <= 128 and both operands have 16-byte
//     aligned rows (the training path's shapes); other shapes (D = 100,
//     D = 256, an unaligned operand) keep lse_partial and grad_rows on bf16
//     tiles, chosen from the shape and pointers alone, the same rule for
//     all three (flash_ce_grad_route). lse_partial's bf16 logits: one bf16
//     product into fp32, mma.sync.m16n8k16, no split: bf16 products are
//     exact in fp32, so only the sums round (toward zero on the tensor
//     cores: each 32 columns of d, two k16 steps, are summed from 0 and
//     join s by an fp32 add); grad_rows' bf16 gradient products as 2xTF32
//     (the fp32 coefficient split in a TF32 part and a TF32 remainder, the
//     bf16 row exact in TF32).
//   - Copies of the bf16 lse_partial and grad_rows: 16-byte cp.async of 8
//     elements where D % 8 == 0 and the rows are 16-byte aligned, else plain
//     element loads into shared (a 2-byte element has no cp.async); rows
//     padded by 16 bytes (DP + 8 elements), so that ldmatrix and the 2-byte
//     loads are conflict-free.
//   grad_wg's bound at Q = N = 8192, D = 128: the logits, 17.2 GFLOP at the
//   bf16 peak (989 TFLOP/s), 0.017 ms, and the gradient product near fp32's
//   error as three bf16 passes, 51.5 GFLOP, 0.052 ms: 0.069 ms of tensor
//   time ("bf16 + 3xbf16"); the Q * N = 67 M exponentials take 0.016 ms of
//   the special function units (16 a clock per SM), beside it.
//   What held grad_rows' bf16 form (0.386 ms) back: K1-bf16 computes the same
//   logits and exponentials in 0.132 ms, so two thirds of the time went to
//   the gradient product: 2xTF32 on mma.sync (two passes at the TF32 rate,
//   the tensor time of four bf16 passes), its B fragments by scalar 2-byte
//   loads widened one by one, the coefficients split anew every k-step, one
//   warp doing everything in sequence behind a __syncthreads a tile.
//   grad_wg's design:
//   - Block: two consumer warpgroups own 64 rows each (wgmma's M: queries
//     for K2, negatives for K3) and one copying warp, 288 threads. The own
//     rows come once by TMA; the chunk's streamed rows come 64 at a time by
//     TMA into a ring of 4 stages (64-column boxes, 128-byte swizzle), with
//     their per-row inputs (bias and nid for K2; lse log2(e), gw / T and pid
//     for K3) loaded by the copying warp, one full and one empty mbarrier a
//     stage; both warpgroups read every stage.
//   - Logits: wgmma m64n64k16 bf16, both operands from shared memory,
//     K-major; each 32 deep summed from zero (scale-d 0) and added to an fp32
//     sum in depth order, as logit_products adds its parts. K1-bf16 on these
//     shapes (lse_wg) takes the same parts in the same order, so the
//     forward's lse and the backward's exp(x - lse) see one x; on every tile
//     the card was probed with, lse_partial's mma.sync logits (K1 on the
//     other shapes) equal them bit for bit too (chip_smoke.py checks both
//     each run, at D = 64 and 128).
//   - Coefficients in registers: the logit accumulator turns into
//     gw / T * 2^(x log2(e) / T - lse log2(e)) in place (one fma, one
//     ex2.approx, which keeps 2 ulp), masking and the chunk's end as in
//     grad_rows; then each pair splits into three bf16 parts (hopper.cuh,
//     split3_bf16, exact but below 2^-110) packed straight into wgmma's
//     register A fragment: for 16-bit types the accumulator's layout is the
//     A fragment's.
//   - Gradient product: the three parts against the same streamed tile read
//     MN-major (the transpose bit: one tile in shared memory serves both
//     products), wgmma m64n64k16 with A from registers, six (the small parts
//     first) into a 32-register sum from zero for each 32 tile rows and 64
//     columns, then one fp32 add into the (64 x D) result: the bound's own
//     arithmetic, summed as the fp32 forms sum (see "Sums" above).
//   - Registers: nine warps put three on one of the SM's four sub-partitions
//     (16 K registers each), so ptxas budgets 168 a thread; 32-register part
//     sums (m64n64) run unserialized in it. A 64-register sum (m64n128 at D =
//     128), two sums in flight, or setmaxnreg with a copying warpgroup made
//     ptxas serialize the wgmma or spill. A 256-thread block with no copying
//     warp (255 registers; the last warp done with a stage refilled it) ran
//     m64n128 unserialized once its sum no longer shared registers with the
//     logits' parts, at 241 registers, and was no faster.
//   - Filling the card: 128 own rows a block, the streamed side cut into
//     chunks from the occupancy the card reports (fill_splits: 2 at Q = N =
//     8192, 128 blocks), the chunks' partial sums merged in order by
//     grad_merge: no atomics, the same bits every call.
//   What still holds it (its times in PERF.md): the tensor work and the
//   exponentials, splits and adds barely overlap: probes without the
//   gradient products ran far faster, and those products alone, outside the
//   kernel, ran near the tensor cores' peak. Taking turns on the
//   tensor cores (named barriers), 64-row groups, half as many drains
//   (m64n128) and the coefficients' parts in shared memory (A from shared
//   memory: m64n64 then reads 4 KB a 32 clocks, the SM's whole shared-memory
//   rate) were no faster.
//   lse_wg (K1-bf16) replaces lse_partial<DP, bf16> on those shapes. Its
//   bound at Q = N = 8192, D = 128: the logits, 17.2 GFLOP at the bf16 peak,
//   0.0174 ms; the Q * N = 67 M exponentials take 0.016 ms of the special
//   function units beside it. What held lse_partial's bf16 form (0.131 ms,
//   13% of the bound, on an H100 80GB HBM3 at 700 W): mma.sync logits fed by
//   ldmatrix from a two-stage cp.async ring, one __syncthreads a tile, four
//   warps doing copies, products, one expf a logit and the online (max, sum)
//   in sequence. lse_wg's design:
//   - Block, ring and copying warp: grad_wg<DP, true>'s (wg_layout,
//     wg_fill: a 4-stage TMA ring of 64 negatives with their bias and nid),
//     with three consumer warpgroups, 192 own query rows (lse_wg keeps no
//     result: 128 registers a thread and no spill; a fourth warpgroup
//     spilled and serialized the wgmma); the negatives cut into splits from
//     the occupancy the card reports (fill_splits), the partials merged in
//     split order by lse_merge with the positive logit: the same bits every
//     call.
//   - Logits: the very parts of wg_logits in its order (each 32 deep summed
//     from zero by wgmma m64n64k16, added in depth order), so that K1-bf16's
//     logits equal K2-bf16 / K3-bf16's bit for bit by construction
//     (chip_smoke.py checks it through K1 itself).
//   - Overlap: two tiles' logits take turns in two 32-register sets; tile
//     i + 1's parts are issued before tile i's exponentials, which run in
//     DP / 32 - 1 chunks, one between each wait for a part and the issue of
//     the next. On the chunk's last tile the parts run again on that tile,
//     their sums unused: issued and waited for on every path, the wgmma stay
//     unserialized.
//   - Softmax in the accumulator layout (rows g and g + 8 of the warp's 16,
//     as lse_partial): each column pair's biases and ids by one 8-byte
//     shared load each and the mask with no branch (under the mask's
//     short-circuit every load became a branch around a generic load, 32 in
//     sequence a tile, and the kernel ran slower than lse_partial); the max
//     over x' + bias scaled once by 1/T (the same value as the max of the
//     scaled logits); each exponential one fma and one ex2.approx,
//     2^(fma(x' + bias, log2(e) / T, -m log2(e))); the running sum rescaled
//     by expf; the quad merge of lse_partial.
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
// the SFU's 16 a clock per SM (0.016 ms at 1.98 GHz); K2 / K3's bound is
// grad_wg's above (0.069 ms), what chip_smoke.py bounds them by.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int DMAX = 256;
constexpr int SPLITS_MAX = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float MIN_FLOAT = -0x1.47851ep+9f;  // float16.min / 100 = -655.04, as float32
constexpr float EMPTY = -FLT_MAX;             // the max over no logit
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = 2^(x log2(e))

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

// The four lanes of a quad (t = 0 .. 3) hold online (max, sum) pairs of the
// same two rows: merge them, then lane 0 writes the block's split's partial
// of each row below Q
__device__ __forceinline__ void write_partials(float (&m)[2], float (&sum)[2],
                                               const int (&rows)[2], int t, int Q,
                                               float* __restrict__ part_m,
                                               float* __restrict__ part_s) {
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
    if (t == 0 && rows[h] < Q) {
      part_m[(size_t)blockIdx.y * Q + rows[h]] = m[h];
      part_s[(size_t)blockIdx.y * Q + rows[h]] = sum[h];
    }
  }
}

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

  const int rows[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  write_partials(m, sum, rows, t, Q, part_m, part_s);
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

// ---------------------------------------------------------------------------
// K2 / K3, bf16 forms: grad_wg (wgmma, a TMA ring, the 3xbf16 gradient product)
// ---------------------------------------------------------------------------

constexpr int WG_BC = 64;                   // streamed rows a tile
constexpr int WG_STAGES = 4;                // tiles in the ring
// A block of the wgmma kernels: CONS consumer warpgroups of 64 own rows each
// and one copying warp. grad_wg takes two: nine warps put three on one of
// the SM's four sub-partitions, whose 16 K registers cap a thread at 168
// (ptxas' budget), which its 64 x D result needs. lse_wg keeps no result and
// fits 128 registers: a third warpgroup keeps more products in flight
constexpr int WG_CONSUMERS = 2;             // grad_wg's
constexpr int LSE_CONSUMERS = 3;            // lse_wg's
__host__ __device__ constexpr int wg_rows(int cons) { return 64 * cons; }
__host__ __device__ constexpr int wg_threads(int cons) { return 128 * cons + 32; }
constexpr int WG_ROWS = wg_rows(WG_CONSUMERS);
constexpr int WG_THREADS = wg_threads(WG_CONSUMERS);
constexpr int WG_SLAB = 64 * 128;           // 64 rows of 64 bf16, swizzled: one TMA box
constexpr int WG_META = 3 * WG_BC * 4;      // a tile's per-row inputs: two floats and an id

// one warpgroup's own rows, and one streamed tile: DP / 64 slabs
template <int DP> __host__ __device__ constexpr int wg_tile_bytes() { return DP / 64 * WG_SLAB; }

// 1024 bytes of slack to align the tiles for the swizzle, the own rows, the
// ring's tiles and per-row inputs, a full and an empty barrier a stage and
// the own rows' barrier
template <int DP, int CONS = WG_CONSUMERS>
__host__ __device__ constexpr size_t wg_smem() {
  return 1024 + (size_t)(CONS + WG_STAGES) * wg_tile_bytes<DP>() +
         (size_t)WG_STAGES * WG_META + (2 * WG_STAGES + 1) * 8;
}

// wg_smem's layout, shared by grad_wg and lse_wg
struct WgSmem {
  unsigned char* own;    // CONS tiles, 1024-byte aligned for the swizzle
  unsigned char* tiles;  // the ring: WG_STAGES tiles
  float* metas;          // [stage][3][WG_BC]: the tile's per-row inputs
  uint64_t* full;        // a stage's tile and inputs have arrived
  uint64_t* empty;       // every consuming thread is done with a stage
  uint64_t* own_bar;     // the own rows have arrived
};

// carve the layout out of the dynamic shared memory and initialise the
// barriers (one thread; the whole block waits)
template <int DP, int CONS = WG_CONSUMERS>
__device__ __forceinline__ WgSmem wg_layout(unsigned char* raw) {
  constexpr int TILE = wg_tile_bytes<DP>();
  WgSmem s;
  s.own = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                           ~uintptr_t(1023));
  s.tiles = s.own + CONS * TILE;
  s.metas = reinterpret_cast<float*>(s.tiles + WG_STAGES * TILE);
  s.full = reinterpret_cast<uint64_t*>(s.metas + WG_STAGES * 3 * WG_BC);
  s.empty = s.full + WG_STAGES;
  s.own_bar = s.empty + WG_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < WG_STAGES; ++i) {
      mbar_init(s.full + i, 32);           // the copying warp's lanes
      mbar_init(s.empty + i, 128 * CONS);  // every consuming thread
    }
    mbar_init(s.own_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  return s;
}

// The copying warp of grad_wg and lse_wg: the block's own rows [r0, r0 +
// 64 CONS) once by TMA, then the chunk's rows [c_begin, c_end) WG_BC at a
// time into the ring with their per-row inputs, scaled as the consumers
// take them: OWN_Q (K2, K1-bf16) the negatives' bias, -, nid; else (K3) the
// queries' lse log2(e), gw / T, pid. Null inputs arrive as zeros.
template <int DP, bool OWN_Q, int CONS = WG_CONSUMERS>
__device__ __forceinline__ void wg_fill(const WgSmem& sm, const void* own_map,
                                        const void* strm_map, const float* s_f0,
                                        const float* s_f1, const int* s_id, float inv_t,
                                        int r0, int c_begin, int c_end, int n_tiles) {
  constexpr int SL = DP / 64, TILE = wg_tile_bytes<DP>();
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_expect(sm.own_bar, CONS * TILE);
    for (int w = 0; w < CONS; ++w)
      for (int s = 0; s < SL; ++s)
        tma_load_2d(sm.own + w * TILE + s * WG_SLAB, own_map, 64 * s, r0 + 64 * w, sm.own_bar);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % WG_STAGES, c0 = c_begin + it * WG_BC;
    mbar_wait(sm.empty + st, ((it / WG_STAGES) & 1) ^ 1);  // tile it - WG_STAGES consumed
    float* meta = sm.metas + st * 3 * WG_BC;
    for (int r = lane; r < WG_BC; r += 32) {
      const bool ok = c0 + r < c_end;
      const float f0 = ok && s_f0 ? s_f0[c0 + r] : 0.f;
      meta[r] = OWN_Q ? f0 : f0 * LOG2E;
      meta[WG_BC + r] = ok && s_f1 ? s_f1[c0 + r] * inv_t : 0.f;
      reinterpret_cast<int*>(meta)[2 * WG_BC + r] = ok && s_id ? s_id[c0 + r] : 0;
    }
    if (lane == 0) {
      mbar_arrive_expect(sm.full + st, TILE);
      for (int s = 0; s < SL; ++s)
        tma_load_2d(sm.tiles + st * TILE + s * WG_SLAB, strm_map, 64 * s, c0, sm.full + st);
    } else {
      mbar_arrive(sm.full + st);
    }
  }
}

// 32-deep part p of the logits (k16 steps 2p and 2p + 1, in slab p / 2) of
// the warpgroup's 64 own rows against the 64 tile rows, from zero into d
__device__ __forceinline__ void logit_part(float (&d)[32], const unsigned char* own,
                                           const unsigned char* tile, int p) {
  const int off = (p >> 1) * WG_SLAB + (p & 1) * 64;
#pragma unroll
  for (int s = 0; s < 2; ++s)
    wgmma_ss(d, wgmma_desc(own + off + 32 * s, 16, 1024),
                 wgmma_desc(tile + off + 32 * s, 16, 1024), s);
}

// The warpgroup's 64 x 64 logit sums (before bias and 1/T) into S, in the
// accumulator layout (hopper.cuh): one m64n64k16 bf16 product a 16-deep
// step, each 32 deep summed from zero and added to S in depth order, as
// logit_products adds its parts. P: scratch for the part in flight.
template <int DP>
__device__ __forceinline__ void wg_logits(const unsigned char* own, const unsigned char* tile,
                                          float (&S)[32], float (&P)[32]) {
  fence_regs(S);
  fence_regs(P);
  wgmma_fence();
  logit_part(S, own, tile, 0);
  logit_part(P, own, tile, 1);
  wgmma_commit();
  wgmma_wait();
  fence_regs(S);
#pragma unroll
  for (int p = 2; p <= DP / 32; ++p) {
    fence_regs(P);
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] += P[i];
    if (p == DP / 32) break;
    wgmma_fence();
    logit_part(P, own, tile, p);
    wgmma_commit();
    wgmma_wait();
  }
}

// OWN_Q as in grad_rows. Block (own tile x of WG_ROWS rows, chunk y):
// warpgroups 0 and 1 own 64 rows each and consume; warp 8 fills the ring.
// The chunk's rows [y * chunk, min((y + 1) * chunk, n_strm)) come WG_BC at a
// time by TMA (own_map, strm_map: 64-column boxes, 128-byte swizzle, rows
// past the end zero), their per-row inputs by the copying warp's loads,
// scaled as the coefficients take them. A stage is full when the copying
// warp's lanes and the TMA bytes have arrived, empty when every consuming
// thread has.
template <int DP, bool OWN_Q>
__global__ void __launch_bounds__(WG_THREADS, 1)
grad_wg(const __grid_constant__ CUtensorMap own_map,
        const __grid_constant__ CUtensorMap strm_map, const float* __restrict__ lse,
        const float* __restrict__ gw, const int* __restrict__ pid,
        const int* __restrict__ nid, const float* __restrict__ bias, float* __restrict__ dst,
        int Q, int N, int D, float T, int downscore, int chunk) {
  constexpr int SL = DP / 64, TILE = wg_tile_bytes<DP>();
  extern __shared__ unsigned char smem_raw[];
  const WgSmem sm = wg_layout<DP>(smem_raw);
  unsigned char* tiles = sm.tiles;
  const float* metas = sm.metas;
  uint64_t* full = sm.full;
  uint64_t* empty = sm.empty;
  const int n_own = OWN_Q ? Q : N, n_strm = OWN_Q ? N : Q;
  const int r0 = blockIdx.x * WG_ROWS;
  const int c_begin = blockIdx.y * chunk;
  const int c_end = min(c_begin + chunk, n_strm);
  const int n_tiles = (c_end - c_begin + WG_BC - 1) / WG_BC;
  const int wg = threadIdx.x >> 7;
  // 1/T once, and the exponent in base 2: coef = gw / T * 2^(x' log2(e) / T
  // - lse log2(e)), x' the logit before 1/T: one fma and one ex2
  const float inv_t = 1.f / T, scale = inv_t * LOG2E;

  if (wg == WG_CONSUMERS) {  // the copying warp
    wg_fill<DP, OWN_Q>(sm, &own_map, &strm_map, OWN_Q ? bias : lse, OWN_Q ? nullptr : gw,
                       downscore ? (OWN_Q ? nid : pid) : nullptr, inv_t, r0, c_begin, c_end,
                       n_tiles);
    return;
  }

  const int tid = threadIdx.x & 127, wid = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = r0 + 64 * wg + 16 * wid + g;  // the thread's rows: row0, row0 + 8
  // the own rows' inputs: K2 (lse log2(e), gw / T, pid), K3 (bias, nid)
  float o_l2[2], o_wt[2], o_bias[2];
  int o_id[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const bool ok = r < n_own;
    o_l2[h] = (OWN_Q && ok) ? lse[r] * LOG2E : 0.f;
    o_wt[h] = (OWN_Q && ok) ? gw[r] * inv_t : 0.f;
    o_bias[h] = (!OWN_Q && bias && ok) ? bias[r] : 0.f;
    o_id[h] = (downscore && ok) ? (OWN_Q ? pid[r] : nid[r]) : 0;
  }
  const unsigned char* own = sm.own + wg * TILE;
  float acc[SL][32];
#pragma unroll
  for (int s = 0; s < SL; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[s][i] = 0.f;
  mbar_wait(sm.own_bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % WG_STAGES, c0 = c_begin + it * WG_BC;
    mbar_wait(full + st, (it / WG_STAGES) & 1);
    const unsigned char* tile = tiles + st * TILE;
    const float* m_f0 = metas + st * 3 * WG_BC;
    const float* m_f1 = m_f0 + WG_BC;
    const int* m_id = reinterpret_cast<const int*>(m_f1 + WG_BC);
    float S[32], P[32];
    wg_logits<DP>(own, tile, S, P);

    // coefficients, in place: register 4 j + e is own row g + 8 (e >> 1),
    // tile row 8 j + 2 t + (e & 1); ex2.approx (2 ulp; results below fp32's
    // normal range flush to 0). On the chunk's last tile, rows past its end
    // are 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const bool masked = downscore && o_id[h] == m_id[col];
        const float x = masked ? MIN_FLOAT : S[4 * j + e] + (OWN_Q ? m_f0[col] : o_bias[h]);
        const float l2 = OWN_Q ? o_l2[h] : m_f0[col];
        const float wt = OWN_Q ? o_wt[h] : m_f1[col];
        S[4 * j + e] = wt * ex2_approx(fmaf(x, scale, -l2));
      }
    const int valid = c_end - c0;
    if (valid < WG_BC) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= valid) S[4 * j + e] = 0.f;
    }

    // acc += coef x tile, 32 tile rows (k16 steps 2 q2, 2 q2 + 1) by 64
    // columns (slab s) at a time: the rows' coefficients (registers 8 k ..
    // 8 k + 7, the A fragment) split in three bf16 parts, six products (the
    // small parts first) from zero into P, then one fp32 add into acc[s]
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      uint32_t a[3][2][4];  // [lo, mid, hi][k - 2 q2][register]
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * (2 * q2 + u) + 2 * r;
          split3_bf16(S[i], S[i + 1], a[2][u][r], a[1][u][r], a[0][u][r]);
        }
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        fence_regs(P);
        wgmma_fence();
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            // tile rows 16 k .. 16 k + 15 of slab s, read MN-major: 8-row
            // groups 1024 bytes apart
            wgmma_rs_t(P, a[part][u],
                       wgmma_desc(tile + s * WG_SLAB + 16 * 128 * (2 * q2 + u), WG_SLAB, 1024),
                       part + u > 0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(P);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[s][i] += P[i];
      }
    }
    mbar_arrive(empty + st);  // this thread is done with the stage
  }

  // register 4 j + e of acc[s] is row g + 8 (e >> 1), column 64 s + 8 j + 2 t
  // + (e & 1); D % 8 == 0, so a pair is in or out whole
  float* out = dst + (size_t)blockIdx.y * n_own * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= n_own) continue;
#pragma unroll
    for (int s = 0; s < SL; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * s + 8 * j + 2 * t;
        if (d < D)
          *reinterpret_cast<float2*>(out + (size_t)r * D + d) =
              make_float2(acc[s][4 * j + 2 * h], acc[s][4 * j + 2 * h + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// K1-bf16: lse_wg (wgmma, a TMA ring, the next tile's logits in flight during
// this tile's exponentials)
// ---------------------------------------------------------------------------

// two adjacent 4-byte values of shared memory, 8-byte aligned (ordered after
// the barrier waits, which are volatile too)
__device__ __forceinline__ float2 lds_v2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(smem_addr(p)));
  return v;
}

// What a consuming thread of lse_wg keeps across tiles
struct LseThread {
  const unsigned char* own;    // its warpgroup's 64 own query rows
  const unsigned char* tiles;  // the ring (wg_smem's layout)
  const float* metas;
  uint64_t* full;
  uint64_t* empty;
  int n_tiles, c_begin, c_end;
  bool downscore;
  int t;               // its position in the quad: columns 8 j + 2 t, + 1
  int o_id[2];         // pid of its rows g and g + 8
  float inv_t, scale;  // 1 / T, and log2(e) / T
  float m[2], sum[2];  // the online (max, sum) of its two rows
};

// 32-deep part p of the logits of the warpgroup's own rows against `tile`,
// issued from zero into d (one commit group; the caller waits for it)
__device__ __forceinline__ void issue_part(float (&d)[32], const unsigned char* own,
                                           const unsigned char* tile, int p) {
  fence_regs(d);
  wgmma_fence();
  logit_part(d, own, tile, p);
  wgmma_commit();
}

// Tile `it` of the chunk: cur holds its logit sums (wg_logits' order). Tile it
// + 1's parts are issued after this tile's max and before its exponentials,
// each into tmp from zero and added to nxt in depth order once it has landed,
// as wg_logits adds them: nxt leaves with tile it + 1's logits, bit for bit
// wg_logits'.
//   x = (masked ? MIN_FLOAT : x' + bias) / T, x' the sum; the max is taken
//   over x' + bias (or MIN_FLOAT) and scaled once, m = max(m, vmax * (1/T)),
//   the same value as the max of the scaled x (rounding is monotone);
//   exp(x - m) = 2^(fma(x' + bias, log2(e) / T, -m log2(e))), one ex2.approx.
// Columns past the chunk's end are -inf: no max, exp 0.
template <int DP>
__device__ __forceinline__ void lse_tile(LseThread& th, int it, float (&cur)[32],
                                         float (&nxt)[32], float (&tmp)[32]) {
  constexpr int TILE = wg_tile_bytes<DP>(), NP = DP / 32, NC = NP - 1;
  const int st = it % WG_STAGES;
  // x' + bias, or MIN_FLOAT. Register 4 j + e is own row g + 8 (e >> 1),
  // tile column 8 j + 2 t + (e & 1): the thread's two columns of each j come
  // as one 8-byte shared load of their biases and one of their ids, with no
  // branch (a load under the mask's short-circuit became a branch around
  // each generic load, 32 round trips in sequence a tile)
  const float* m_bias = th.metas + st * 3 * WG_BC + 2 * th.t;
  const float* m_id = m_bias + 2 * WG_BC;  // the ids' bits
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = lds_v2(m_bias + 8 * j);
    const float2 id = lds_v2(m_id + 8 * j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col_id = __float_as_int(e & 1 ? id.y : id.x);
      const bool masked = th.downscore & (col_id == th.o_id[e >> 1]);
      cur[4 * j + e] = masked ? MIN_FLOAT : cur[4 * j + e] + (e & 1 ? b.y : b.x);
    }
  }
  const int valid = th.c_end - (th.c_begin + it * WG_BC);
  if (valid < WG_BC) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * th.t + (e & 1) >= valid) cur[4 * j + e] = -INFINITY;
  }
  float vmax[2] = {-INFINITY, -INFINITY}, nml[2], add[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) vmax[(i >> 1) & 1] = fmaxf(vmax[(i >> 1) & 1], cur[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(th.m[h], vmax[h] * th.inv_t);
    th.sum[h] *= expf(th.m[h] - mn);
    th.m[h] = mn;
    // while m is EMPTY the thread has seen only -inf columns: exp 0, not
    // 2^(-inf + inf)
    nml[h] = fminf(-mn * LOG2E, FLT_MAX);
  }
  // tile it + 1's parts; on the chunk's last tile the same products on this
  // tile again, their sums unused: the parts are issued and waited for on
  // every path (issued under one branch and waited for under another, they
  // made ptxas serialize the wgmma)
  const bool more = it + 1 < th.n_tiles;
  const int sn = more ? (it + 1) % WG_STAGES : st;
  const unsigned char* next_tile = th.tiles + sn * TILE;
  if (more) mbar_wait(th.full + sn, ((it + 1) / WG_STAGES) & 1);
  issue_part(nxt, th.own, next_tile, 0);
  issue_part(tmp, th.own, next_tile, 1);
  // the exponentials in NC chunks, one between each wait for a part and the
  // issue of the next
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 8 * c / NC; j < 8 * (c + 1) / NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        add[e >> 1] += ex2_approx(fmaf(cur[4 * j + e], th.scale, nml[e >> 1]));
    wgmma_wait();
    fence_regs(nxt);
    fence_regs(tmp);
#pragma unroll
    for (int i = 0; i < 32; ++i) nxt[i] += tmp[i];
    if (c + 2 < NP) issue_part(tmp, th.own, next_tile, c + 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) th.sum[h] += add[h];
  mbar_arrive(th.empty + st);  // this thread is done with the stage
}

// Block (own tile x of 64 LSE_CONSUMERS query rows, split y), fed as
// grad_wg<DP, true> is: the negatives [y * chunk, min((y + 1) * chunk, N))
// stream WG_BC at a time through the ring; one (m, s) partial per (split,
// row), merged by lse_merge.
template <int DP>
__global__ void __launch_bounds__(wg_threads(LSE_CONSUMERS), 1)
lse_wg(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap neg_map,
       const int* __restrict__ pid, const int* __restrict__ nid, const float* __restrict__ bias,
       float* __restrict__ part_m, float* __restrict__ part_s, int Q, int N, float T,
       int downscore, int chunk) {
  constexpr int TILE = wg_tile_bytes<DP>();
  extern __shared__ unsigned char smem_raw[];
  const WgSmem sm = wg_layout<DP, LSE_CONSUMERS>(smem_raw);
  const int r0 = blockIdx.x * wg_rows(LSE_CONSUMERS);
  const int c_begin = blockIdx.y * chunk;
  const int c_end = min(c_begin + chunk, N);
  const int n_tiles = (c_end - c_begin + WG_BC - 1) / WG_BC;
  const int wg = threadIdx.x >> 7;
  const float inv_t = 1.f / T;  // as lse_partial and grad_wg scale their logits
  if (wg == LSE_CONSUMERS) {    // the copying warp
    wg_fill<DP, true, LSE_CONSUMERS>(sm, &q_map, &neg_map, bias, nullptr,
                                     downscore ? nid : nullptr, inv_t, r0, c_begin, c_end,
                                     n_tiles);
    return;
  }

  const int tid = threadIdx.x & 127, lane = tid & 31;
  const int row0 = r0 + 64 * wg + 16 * (tid >> 5) + (lane >> 2);  // rows row0, row0 + 8
  LseThread th;
  th.own = sm.own + wg * TILE;
  th.tiles = sm.tiles;
  th.metas = sm.metas;
  th.full = sm.full;
  th.empty = sm.empty;
  th.n_tiles = n_tiles;
  th.c_begin = c_begin;
  th.c_end = c_end;
  th.downscore = downscore;
  th.t = lane & 3;
  th.inv_t = inv_t;
  th.scale = inv_t * LOG2E;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    th.o_id[h] = (downscore && r < Q) ? pid[r] : 0;
    th.m[h] = EMPTY;
    th.sum[h] = 0.f;
  }
  mbar_wait(sm.own_bar, 0);
  float S[32], A[32], B[32];  // two tiles' logits take turns; B: the part in flight
  mbar_wait(sm.full, 0);
  wg_logits<DP>(th.own, sm.tiles, S, B);
  for (int it = 0; it < n_tiles; it += 2) {
    lse_tile<DP>(th, it, S, A, B);
    if (it + 1 < n_tiles) lse_tile<DP>(th, it + 1, A, S, B);
  }
  const int rows[2] = {row0, row0 + 8};
  write_partials(th.m, th.sum, rows, th.t, Q, part_m, part_s);
}

// The logit invariant between lse_partial (logit_products on mma.sync) and
// grad_wg (wg_logits on wgmma): both stages on one 64 x 64 tile, q and neg (64, D)
// bf16, D % 8 == 0, D <= 128; out_mma and out_wg (64, 64) fp32 sums. One
// block of one warpgroup.
template <int DP>
__global__ void __launch_bounds__(128)
logit_probe(const bf16* __restrict__ q, const bf16* __restrict__ neg, float* __restrict__ out_mma,
            float* __restrict__ out_wg, int D) {
  constexpr int LD = grad_ld<DP, bf16>(), SL = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* own_sw = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* tile_sw = own_sw + SL * WG_SLAB;
  bf16* os = reinterpret_cast<bf16*>(tile_sw + SL * WG_SLAB);
  bf16* ss = os + 64 * LD;
  load_rows<DP, 64, 128>(os, q, 0, 64, D, true);
  load_rows<DP, 64, 128>(ss, neg, 0, 64, D, true);
  cp_async_commit();
  // the same rows in the 128-byte swizzle TMA writes
  for (int i = threadIdx.x; i < 64 * DP; i += 128) {
    const int r = i / DP, c = i % DP, cc = c % 64;
    const int at = (c / 64) * WG_SLAB + r * 128 + ((cc / 8) ^ (r % 8)) * 16 + (cc % 8) * 2;
    *reinterpret_cast<bf16*>(own_sw + at) = c < D ? q[r * D + c] : bf16(0);
    *reinterpret_cast<bf16*>(tile_sw + at) = c < D ? neg[r * D + c] : bf16(0);
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float s[8][4];
  logit_products<DP, 8>(os, ss, warp, lane, s);
  float S[32], P[32];
  wg_logits<DP>(own_sw, tile_sw, S, P);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (16 * warp + g + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1);
      out_mma[at] = s[j][e];
      out_wg[at] = S[4 * j + e];
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

// out = the chunks' partial sums of part, in chunk order
cudaError_t merge_chunks(const float* part, float* out, size_t n, int chunks,
                         cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  grad_merge<<<blocks, 256, 0, stream>>>(part, out, n, chunks);
  return cudaGetLastError();
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
  return merge_chunks(part, out, (size_t)n_own * D, used, stream);
}

// a (rows, D) bf16 matrix as boxes of 64 columns by `box_rows` rows, in the
// 128-byte swizzle; reads outside the matrix give zeros
cudaError_t bf16_tensor_map(CUtensorMap* map, const void* base, int rows, int D, int box_rows) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// grad_wg takes the bf16 shapes with 16-byte rows up to 128 wide; the
// splits follow from the shape alone, the route from the shape and the
// pointers (TMA wants 16-byte aligned rows): D = 100, 256 or an unaligned
// operand take grad_rows<..., bf16>
bool wg_shape(int D) { return D <= 128 && D % 8 == 0; }

bool wg_route(int D, const void* q, const void* neg) {
  return wg_shape(D) && vec_copies<bf16>(q, neg, D);
}

// a wgmma kernel (grad_wg, lse_wg) of width DP and CONS consumer
// warpgroups may take wg_smem<DP, CONS> bytes
template <int DP, int CONS, typename Kernel>
cudaError_t wg_attr(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)wg_smem<DP, CONS>());
}

// the splits of the streamed side that fill the card with blocks of a wgmma
// kernel over n_own own rows; a negative value is a CUDA error, negated
template <int DP, int CONS, typename Kernel>
int wg_splits_for(Kernel kernel, int n_own, int n_strm) {
  int per_sm = 1, sms = 1;
  cudaError_t err = wg_attr<DP, CONS>(kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wg_threads(CONS),
                                                        wg_smem<DP, CONS>());
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return -(int)err;
  return fill_splits(per_sm, sms, (n_own + wg_rows(CONS) - 1) / wg_rows(CONS),
                     (n_strm + WG_BC - 1) / WG_BC);
}

template <bool OWN_Q>
int wg_splits(int Q, int N, int D) {
  const int n_own = OWN_Q ? Q : N, n_strm = OWN_Q ? N : Q;
  return D <= 64 ? wg_splits_for<64, WG_CONSUMERS>(grad_wg<64, OWN_Q>, n_own, n_strm)
                 : wg_splits_for<128, WG_CONSUMERS>(grad_wg<128, OWN_Q>, n_own, n_strm);
}

// K1-bf16 on lse_wg: the negatives cut as grad_wg<..., true> cuts them
int lse_wg_splits(int Q, int N, int D) {
  return D <= 64 ? wg_splits_for<64, LSE_CONSUMERS>(lse_wg<64>, Q, N)
                 : wg_splits_for<128, LSE_CONSUMERS>(lse_wg<128>, Q, N);
}

template <int DP>
cudaError_t launch_lse_wg(const bf16* q, const float* pos_logit, const bf16* neg, const int* pid,
                          const int* nid, const float* bias, float* part_m, float* part_s,
                          float* m, float* s, int Q, int N, int D, float T, int downscore,
                          int splits, cudaStream_t stream) {
  const int tiles = (N + WG_BC - 1) / WG_BC;
  const int chunk = (tiles + splits - 1) / splits * WG_BC;
  const int used = (N + chunk - 1) / chunk;  // splits that hold a negative
  CUtensorMap q_map, neg_map;
  cudaError_t err = bf16_tensor_map(&q_map, q, Q, D, 64);
  if (err == cudaSuccess) err = bf16_tensor_map(&neg_map, neg, N, D, WG_BC);
  if (err == cudaSuccess) err = wg_attr<DP, LSE_CONSUMERS>(lse_wg<DP>);
  if (err != cudaSuccess) return err;
  constexpr int ROWS = wg_rows(LSE_CONSUMERS);
  const dim3 grid((Q + ROWS - 1) / ROWS, used);
  lse_wg<DP><<<grid, wg_threads(LSE_CONSUMERS), wg_smem<DP, LSE_CONSUMERS>(), stream>>>(
      q_map, neg_map, pid, nid, bias, part_m, part_s, Q, N, T, downscore, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  lse_merge<<<(Q + 255) / 256, 256, 0, stream>>>(pos_logit, part_m, part_s, m, s, Q, used);
  return cudaGetLastError();
}

template <int DP, bool OWN_Q>
cudaError_t launch_grad_wg(const bf16* q, const bf16* neg, const float* lse, const float* gw,
                           const int* pid, const int* nid, const float* bias, float* part,
                           float* out, int Q, int N, int D, float T, int downscore, int splits,
                           cudaStream_t stream) {
  const int n_own = OWN_Q ? Q : N, n_strm = OWN_Q ? N : Q;
  const int tiles = (n_strm + WG_BC - 1) / WG_BC;
  const int chunk = (tiles + splits - 1) / splits * WG_BC;
  const int used = (n_strm + chunk - 1) / chunk;  // chunks that hold a streamed row
  if (used > 1 && !part) return cudaErrorInvalidValue;
  CUtensorMap own_map, strm_map;
  cudaError_t err = bf16_tensor_map(&own_map, OWN_Q ? q : neg, n_own, D, 64);
  if (err == cudaSuccess) err = bf16_tensor_map(&strm_map, OWN_Q ? neg : q, n_strm, D, WG_BC);
  if (err == cudaSuccess) err = wg_attr<DP, WG_CONSUMERS>(grad_wg<DP, OWN_Q>);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_own + WG_ROWS - 1) / WG_ROWS, used);
  grad_wg<DP, OWN_Q><<<grid, WG_THREADS, wg_smem<DP>(), stream>>>(
      own_map, strm_map, lse, gw, pid, nid, bias, used > 1 ? part : out, Q, N, D, T, downscore,
      chunk);
  if ((err = cudaGetLastError()) != cudaSuccess || used == 1) return err;
  return merge_chunks(part, out, (size_t)n_own * D, used, stream);
}

// K1: lse_wg where wg_route says so (bf16, the training path's shapes), else
// lse_partial
template <typename TI>
int lse_forward(const void* q, const float* pos_logit, const void* neg, const int* pid,
                const int* nid, const float* bias, float* part_m, float* part_s, float* m,
                float* s, int Q, int N, int D, float T, int downscore, int splits,
                cudaStream_t stream) {
  const TI* qt = static_cast<const TI*>(q);
  const TI* nt = static_cast<const TI*>(neg);
  const int dp = dp_for(D);
  if constexpr (sizeof(TI) == 2) {
    if (wg_route(D, q, neg))
      return (int)(dp == 64 ? launch_lse_wg<64>(qt, pos_logit, nt, pid, nid, bias, part_m, part_s, m, s, Q, N, D, T, downscore, splits, stream)
                            : launch_lse_wg<128>(qt, pos_logit, nt, pid, nid, bias, part_m, part_s, m, s, Q, N, D, T, downscore, splits, stream));
  }
  return (int)(dp == 64 ? launch_lse<64, TI>(qt, pos_logit, nt, pid, nid, bias, part_m, part_s, m, s, Q, N, D, T, downscore, splits, stream)
             : dp == 128 ? launch_lse<128, TI>(qt, pos_logit, nt, pid, nid, bias, part_m, part_s, m, s, Q, N, D, T, downscore, splits, stream)
                         : launch_lse<256, TI>(qt, pos_logit, nt, pid, nid, bias, part_m, part_s, m, s, Q, N, D, T, downscore, splits, stream));
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
  if constexpr (sizeof(TI) == 2) {
    if (wg_route(D, q, neg))
      return (int)(dp == 64 ? launch_grad_wg<64, OWN_Q>(qt, nt, lse, gw, pid, nid, bias, part, out, Q, N, D, T, downscore, splits, stream)
                            : launch_grad_wg<128, OWN_Q>(qt, nt, lse, gw, pid, nid, bias, part, out, Q, N, D, T, downscore, splits, stream));
  }
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
// operands (the shapes, and the pointers, which choose between lse_wg and
// lse_partial as flash_ce_grad_route says); the caller sizes part_m and
// part_s as (splits, Q). A negative value is a CUDA error, negated.
extern "C" int flash_ce_lse_splits(int Q, int N, int D, const void* q, const void* neg,
                                   int is_bf16) {
  if (Q < 1 || N < 1 || D < 1 || D > DMAX) return -(int)cudaErrorInvalidValue;
  if (is_bf16 && wg_route(D, q, neg)) return lse_wg_splits(Q, N, D);
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
  if (is_bf16 && wg_shape(D)) return own_q ? wg_splits<true>(Q, N, D) : wg_splits<false>(Q, N, D);
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

// Which kernels flash_ce_lse_forward and flash_ce_grad_query /
// flash_ce_grad_neg launch for these operands: 1 lse_wg and grad_wg (bf16,
// D % 8 == 0, D <= 128, 16-byte aligned rows), 0 lse_partial and grad_rows.
extern "C" int flash_ce_grad_route(int D, const void* q, const void* neg, int is_bf16) {
  return is_bf16 && D >= 1 && wg_route(D, q, neg);
}

// Dynamic shared memory of a grad_wg block at width D (<= 128), in bytes.
extern "C" int flash_ce_grad_wg_smem(int D) {
  return (int)(D <= 64 ? wg_smem<64>() : wg_smem<128>());
}

// Dynamic shared memory of an lse_wg block at width D (<= 128), in bytes.
extern "C" int flash_ce_lse_wg_smem(int D) {
  return (int)(D <= 64 ? wg_smem<64, LSE_CONSUMERS>() : wg_smem<128, LSE_CONSUMERS>());
}

// The logits of lse_partial (logit_products, mma.sync) and of grad_wg (wgmma) on
// one tile: q, neg (64, D) bf16, 16-byte aligned, D % 8 == 0, D <= 128;
// out_mma, out_wg (64, 64) float32 sums q neg^T, before bias and 1/T.
extern "C" int flash_ce_logit_probe(const void* q, const void* neg, float* out_mma,
                                    float* out_wg, int D, cudaStream_t stream) {
  if (!wg_route(D, q, neg)) return (int)cudaErrorInvalidValue;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* nt = static_cast<const bf16*>(neg);
  const auto run = [&](auto kernel, int dp) {
    const int smem = 1024 + 2 * (dp / 64) * WG_SLAB + 2 * 64 * (dp + 8) * (int)sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
    kernel<<<1, 128, smem, stream>>>(qt, nt, out_mma, out_wg, D);
    return cudaGetLastError();
  };
  return (int)(D <= 64 ? run(logit_probe<64>, 64) : run(logit_probe<128>, 128));
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
