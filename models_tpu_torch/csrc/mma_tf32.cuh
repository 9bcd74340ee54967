// Helpers shared by the tensor-core kernels of flash_ce.cu (K1-K3),
// streaming_topk.cu (K6), binned_rescore.cu (K5) and bin_max.cu (K4):
// asynchronous copies into shared memory, the 3xTF32 split of an fp32
// operand, mma.sync.m16n8k8 in TF32, m16n8k16 in bf16 and m16n8k32 in int8.
//
// Fragments of m16n8k8 (lane = 4 g + t): A (16 x 8) a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, k x n) b0 (t, g), b1 (t + 4, g);
// C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
//
// The tensor cores round their fp32 sums toward zero: a kernel sums each
// product over at most 32 depth positions (or 32 rows) from zero and adds
// that to its fp32 accumulator (round to nearest), so that the drift stays
// that of 32 terms.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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
// [ROWS][DP + PAD] by cp.async, NT threads; other rows and columns at or past
// D are zero-filled. vec: D % 4 == 0 and src 16-byte aligned.
template <int DP, int ROWS, int NT, int PAD>
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ src,
                                                int r0, int r_end, int D, bool vec) {
  constexpr int LD = DP + PAD;
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
      const int r = i / C4, c = 4 * (i % C4);
      const bool ok = r0 + r < r_end && c < D;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * D + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      const bool ok = r0 + r < r_end && c < D;
      cp_async4(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * D + c : src, ok ? 4 : 0);
    }
  }
}

// n 4-byte entries [c0, c0 + n) of a vector, those below c_end, into shared,
// NT threads; the rest, or all of them where src is null, zero-filled (`any`
// is a valid address that is not read)
template <int NT>
__device__ __forceinline__ void load_vec_async(void* dst, const void* src, int c0, int c_end,
                                               int n, const void* any) {
  for (int i = threadIdx.x; i < n; i += NT) {
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

// four 8 x 16-byte matrices from shared memory: lane 8i + r gives the
// address of row r of matrix i; register i of lane 4g + t holds bytes
// [4t, 4t + 4) of row g of matrix i: fp32 element (g, t), a TF32 fragment,
// or the bf16 pair (g, 2t), (g, 2t + 1), a bf16 fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
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

// c += a * b on bf16 operands into fp32: mma.sync.m16n8k16. Fragments (lane
// = 4 g + t, two bf16 a register, the lower column in the low half): A (16 x
// 16) a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
// B (16 x 8, k x n) b0 (2t.., g), b1 (2t + 8.., g); C as m16n8k8's. The
// products are exact; only the sums round
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a bf16 value (its raw bits) widened to fp32, which TF32 holds exactly
__device__ __forceinline__ uint32_t bf16_as_tf32(uint16_t bits) { return (uint32_t)bits << 16; }

// c += a * b in 2xTF32, for a B operand that TF32 holds exactly (bf16 or
// int8 values widened to fp32): its small part is zero
__device__ __forceinline__ void mma_2xtf32(float c[4], const uint32_t a_big[4],
                                           const uint32_t a_small[4], const uint32_t b[2]) {
  mma_tf32(c, a_small, b);
  mma_tf32(c, a_big, b);
}

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
