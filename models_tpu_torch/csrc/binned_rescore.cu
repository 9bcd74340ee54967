// Phase-B rescore of the binned top-k, for sm_90a.
//
// Replaces the TPU kernel models_tpu/ops/topk.py::_binned_rescore (K5).
//
//   out[b, j*bs + s] = sum_d q[b, d] * cand[bin_idx[b, j]*bs + s, d]
//
// fp32 and bf16 candidates (fp32 queries, fp32 out): bf16 rows are widened to
// fp32 exactly, each lane accumulates its share of d with FMAs and the warp
// sums the 32 partial sums by shuffles. No tensor cores. A bin index outside
// [0, n_bins) gives NaN, not a fault.
//
// int8 candidates (int8 queries, int32 out), the int8 index's phase B: each
// lane sums its share of d in int32 (__dp4a, four products a word, when a
// row is whole 4-byte words), then the warp sums by shuffles. Integer sums
// are exact in any order, so the result is the plain version's bit for bit
// (|sum| <= 127*127*D, which int32 holds for D < 133,000). A bin index
// outside [0, n_bins) gives INT32_MIN.
//
// Design. One block per query row: the row sits in shared memory, and each
// warp in turn takes one candidate row of the selected bins, its lanes on
// neighbouring elements, so a row is read once, coalesced. The TPU kernel's
// 8-row query blocks, static unroll and D % 128 == 0 condition were Mosaic
// workarounds and are gone.
//
// Bound on an H100 SXM: memory. The selected rows, B*kb*bs*D*itemsize bytes
// (about 100 MB at B=256, kb=12, bs=64, D=128 fp32; a quarter of it int8),
// at 3.35 TB/s; the 2*B*kb*bs*D operations are far below the 67 TFLOP/s of
// the FMA units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cand_dtype 0: q (B, D) f32, cand (n_bins*bs, D) f32, out (B, kb*bs) f32;
// 1: the same with bf16 cand; 2: q and cand int8, out int32. bin_idx (B, kb)
// int32. Returns cudaGetLastError() after the launch.
extern "C" int binned_rescore(const void* q, const void* cand, int cand_dtype,
                              const int* bin_idx, void* out, int B, int D, int kb,
                              int bs, int n_bins, cudaStream_t stream) {
  if (B < 1 || D < 1 || kb < 1 || bs < 1 || n_bins < 1) return (int)cudaErrorInvalidValue;
  if (cand_dtype == 2) {
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
  if (cand_dtype == 1)
    rescore<__nv_bfloat16><<<B, THREADS, smem, stream>>>(
        qf, static_cast<const __nv_bfloat16*>(cand), bin_idx, o, D, kb, bs, n_bins);
  else if (cand_dtype == 0)
    rescore<float><<<B, THREADS, smem, stream>>>(
        qf, static_cast<const float*>(cand), bin_idx, o, D, kb, bs, n_bins);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
