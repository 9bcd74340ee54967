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
// where downscoring is on and nid[j] == pid[i]. The dot runs in fp32 FMAs,
// d = 0 .. D-1 in order: no TF32 and no tensor cores. A null pid, nid or bias
// means none (no masking, zero bias).
//
//   K1: (m_i, s_i) with m_i = max(pos_i, max_j x_ij) and
//       s_i = exp(pos_i - m_i) + sum_j exp(x_ij - m_i).
//   K2: dq[i]   = sum_j coef_ij * neg[j],  coef_ij = gw_i * exp(x_ij - lse_i) / T
//   K3: dneg[j] = sum_i coef_ij * q[i]
//
// Design. The TPU grid walked the negatives in order and carried (m, s), or
// the dq / dneg block, in VMEM from one grid step to the next. Blocks on
// Hopper run in parallel and carry nothing:
//   K1: block (row tile, split) scores BR query rows against its split of the
//     negatives, BC rows at a time. Each thread keeps an online (max, sum)
//     for its 4 rows over the columns it scores; at the end the 16 threads
//     sharing a row merge theirs with shuffles and write one partial per
//     (split, row). lse_merge folds the partials and the positive logit.
//     Splits are sized so that the grid fills the card once.
//   K2 / K3: one kernel, grad_rows. A block owns BR rows (queries for K2,
//     negatives for K3) and streams ALL rows of the other side in tiles of
//     BC, so no sum crosses blocks and nothing is atomic: the result is the
//     same from run to run. Per tile it recomputes the BR x BC logits, turns
//     them into coefficients in shared memory, and accumulates
//     coef @ tile into a BR x D accumulator held in registers.
// Both products are register-tiled: a thread holds 4 x 4 logits and reads
// its operands from shared memory as float4, 8 vector loads for 64 FMAs.
// Tiles are loaded without double buffering.
//
// Bound on an H100 SXM at Q = N = 8192, D = 128: operations. K1 does
// 2*Q*N*D = 17.2 GFLOP (0.256 ms at 67 TFLOP/s, fp32 outside the tensor
// cores), K2 and K3 4*Q*N*D each (the recompute and the product, 0.513 ms);
// their operands are 4 MB. Q*N exponentials per kernel add little.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BR = 64;         // rows a block owns
constexpr int BC = 64;         // rows of one streamed tile
constexpr int THREADS = 256;   // 16 x 16 threads: ty = tid / 16, tx = tid % 16
constexpr int PAD = 4;         // floats after each shared row: conflict-free float4 reads
constexpr int CPAD = 16;       // the same for the coefficient tile
constexpr int DMAX = 256;
constexpr int SPLITS_MAX = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float MIN_FLOAT = -0x1.47851ep+9f;  // float16.min / 100 = -655.04, as float32
constexpr float EMPTY = -FLT_MAX;             // the max over no logit

static_assert(THREADS == 256 && BR == 64 && BC == 64, "thread (ty, tx) holds rows ty + 16a, columns tx + 16b");

template <int DP>
constexpr size_t lse_smem() { return (size_t)(BR + BC) * (DP + PAD) * sizeof(float); }

template <int DP>
constexpr size_t grad_smem() {
  return ((size_t)(BR + BC) * (DP + PAD) + (size_t)BR * (BC + CPAD)) * sizeof(float);
}

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

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
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
// K2 / K3: the backward products
// ---------------------------------------------------------------------------

// OWN_Q: the block owns query rows and streams negatives (K2, out = dq);
// otherwise it owns negative rows and streams queries (K3, out = dneg).
template <int DP, bool OWN_Q>
__global__ void __launch_bounds__(THREADS)
grad_rows(const float* __restrict__ q, const float* __restrict__ neg,
          const float* __restrict__ lse, const float* __restrict__ gw,
          const int* __restrict__ pid, const int* __restrict__ nid,
          const float* __restrict__ bias, float* __restrict__ out, int Q, int N, int D,
          float T, int downscore) {
  constexpr int NC = DP / 64;  // float4 columns of an output row per thread
  extern __shared__ __align__(16) float smem[];
  float* os = smem;                  // [BR][DP + PAD] own rows
  float* ss = os + BR * (DP + PAD);  // [BC][DP + PAD] streamed rows
  float* cs = ss + BC * (DP + PAD);  // [BR][BC + CPAD] coefficients
  const float* own = OWN_Q ? q : neg;
  const float* strm = OWN_Q ? neg : q;
  const int n_own = OWN_Q ? Q : N;
  const int n_strm = OWN_Q ? N : Q;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * BR;

  load_rows<DP>(os, own, r0, n_own, D);
  // per own row: (lse, gw, pid) for a query, (bias, nid) for a negative
  float o_lse[4], o_gw[4], o_bias[4];
  int o_id[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + 16 * a;
    const bool ok = r < n_own;
    if (OWN_Q) {
      o_lse[a] = ok ? lse[r] : 0.f;
      o_gw[a] = ok ? gw[r] : 0.f;
      o_bias[a] = 0.f;
      o_id[a] = (downscore && ok) ? pid[r] : 0;
    } else {
      o_lse[a] = 0.f;
      o_gw[a] = 0.f;
      o_bias[a] = (bias && ok) ? bias[r] : 0.f;
      o_id[a] = (downscore && ok) ? nid[r] : 0;
    }
  }

  float acc[4][NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[a][n][0] = acc[a][n][1] = acc[a][n][2] = acc[a][n][3] = 0.f;

  for (int c0 = 0; c0 < n_strm; c0 += BC) {
    __syncthreads();  // the previous tile and its coefficients are consumed
    load_rows<DP>(ss, strm, c0, n_strm, D);
    __syncthreads();
    float dot[4][4];
    dot_tile<DP>(os, ss, ty, tx, dot);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tx + 16 * b;
      const bool ok = c < n_strm;
      float c_lse = 0.f, c_gw = 0.f, c_bias = 0.f;
      int c_id = 0;
      if (OWN_Q) {
        c_bias = (bias && ok) ? bias[c] : 0.f;
        c_id = (downscore && ok) ? nid[c] : 0;
      } else {
        c_lse = ok ? lse[c] : 0.f;
        c_gw = ok ? gw[c] : 0.f;
        c_id = (downscore && ok) ? pid[c] : 0;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float x = logit(dot[a][b], OWN_Q ? c_bias : o_bias[a],
                              downscore && o_id[a] == c_id, T);
        const float l = OWN_Q ? o_lse[a] : c_lse;
        const float g = OWN_Q ? o_gw[a] : c_gw;
        cs[(ty + 16 * a) * (BC + CPAD) + tx + 16 * b] = ok ? (g * expf(x - l)) / T : 0.f;
      }
    }
    __syncthreads();
    // acc[row][d] += sum_c cs[row][c] * ss[c][d]; padded columns add 0 * 0
    for (int c = 0; c < BC; c += 4) {
      float4 cv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        cv[a] = *reinterpret_cast<const float4*>(cs + (ty + 16 * a) * (BC + CPAD) + c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* srow = ss + (c + k) * (DP + PAD) + 4 * tx;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float4 v = *reinterpret_cast<const float4*>(srow + 64 * n);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float w = comp(cv[a], k);
            acc[a][n][0] = fmaf(w, v.x, acc[a][n][0]);
            acc[a][n][1] = fmaf(w, v.y, acc[a][n][1]);
            acc[a][n][2] = fmaf(w, v.z, acc[a][n][2]);
            acc[a][n][3] = fmaf(w, v.w, acc[a][n][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + 16 * a;
    if (r >= n_own) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * n + 4 * tx + e;
        if (d < D) out[(size_t)r * D + d] = acc[a][n][e];
      }
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

int lse_splits(int Q, int N, int D) {
  int per_sm = 1, dev = 0, sms = 1;
  cudaError_t err = dp_for(D) == 64 ? lse_blocks_per_sm<64>(&per_sm)
                  : dp_for(D) == 128 ? lse_blocks_per_sm<128>(&per_sm)
                                     : lse_blocks_per_sm<256>(&per_sm);
  if (err != cudaSuccess) return -(int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  const int tiles = N > 0 ? (N + BC - 1) / BC : 1;
  const int row_blocks = (Q + BR - 1) / BR;
  // as many (row tile, split) blocks as the card holds at once
  const int splits = (per_sm * sms) / row_blocks;
  return splits < 1 ? 1 : splits > tiles ? tiles : splits > SPLITS_MAX ? SPLITS_MAX : splits;
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
cudaError_t launch_grad(const float* q, const float* neg, const float* lse, const float* gw,
                        const int* pid, const int* nid, const float* bias, float* out, int Q,
                        int N, int D, float T, int downscore, cudaStream_t stream) {
  const size_t smem = grad_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      grad_rows<DP, OWN_Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_own = OWN_Q ? Q : N;
  grad_rows<DP, OWN_Q><<<(n_own + BR - 1) / BR, THREADS, smem, stream>>>(
      q, neg, lse, gw, pid, nid, bias, out, Q, N, D, T, downscore);
  return cudaGetLastError();
}

template <bool OWN_Q>
int grad(const float* q, const float* neg, const float* lse, const float* gw, const int* pid,
         const int* nid, const float* bias, float* out, int Q, int N, int D, float T,
         int downscore, cudaStream_t stream) {
  if (Q < 1 || N < 1 || D < 1 || D > DMAX) return (int)cudaErrorInvalidValue;
  downscore = downscore && pid && nid;
  const int dp = dp_for(D);
  cudaError_t err =
      dp == 64 ? launch_grad<64, OWN_Q>(q, neg, lse, gw, pid, nid, bias, out, Q, N, D, T, downscore, stream)
      : dp == 128 ? launch_grad<128, OWN_Q>(q, neg, lse, gw, pid, nid, bias, out, Q, N, D, T, downscore, stream)
                  : launch_grad<256, OWN_Q>(q, neg, lse, gw, pid, nid, bias, out, Q, N, D, T, downscore, stream);
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

// dq (Q, D) = sum_j coef_ij * neg[j]; lse, gw (Q,) float32; the rest as above.
extern "C" int flash_ce_grad_query(const float* q, const float* neg, const float* lse,
                                   const float* gw, const int* pid, const int* nid,
                                   const float* bias, float* dq, int Q, int N, int D, float T,
                                   int downscore, cudaStream_t stream) {
  return grad<true>(q, neg, lse, gw, pid, nid, bias, dq, Q, N, D, T, downscore, stream);
}

// dneg (N, D) = sum_i coef_ij * q[i].
extern "C" int flash_ce_grad_neg(const float* q, const float* neg, const float* lse,
                                 const float* gw, const int* pid, const int* nid,
                                 const float* bias, float* dneg, int Q, int N, int D, float T,
                                 int downscore, cudaStream_t stream) {
  return grad<false>(q, neg, lse, gw, pid, nid, bias, dneg, Q, N, D, T, downscore, stream);
}
