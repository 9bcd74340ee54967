// Hopper's asynchronous machinery, shared by flash_ce.cu (the bf16 K1-K3),
// streaming_topk.cu (K6) and bin_max.cu (K4's wgmma design): mbarriers, bulk
// and tensor (TMA) copies into shared memory, warpgroup products (wgmma) on
// bf16 operands, the three-part bf16 split of an fp32 value, and on the host
// cuTensorMapEncodeTiled, looked up at run time.
//
// wgmma (m64nNk16, one warpgroup of 4 warps): C / D, fp32, N / 2 registers a
// thread: warp w of the group, lane 4 g + t, register 4 j + e holds row
// 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1). An A operand from
// registers (bf16, 4 registers of 2) is mma.sync.m16n8k16's A fragment on
// the warp's 16 rows: a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
// a3 (g + 8, 2t + 8..), the lower column in the low half. So the C registers
// of columns 16 k .. 16 k + 15 (j = 2 k, 2 k + 1) are, pair by pair, the A
// fragment of k-step k: a product's result feeds the next product with no
// trip through shared memory.
//
// Operands in shared memory take the 128-byte swizzle that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B: a tile of rows of 64 bf16 (128 bytes) whose
// 16-byte piece c of row r sits at piece c ^ (r % 8), the tile 1024-byte
// aligned. Read K-major (each row a K run: the logits' A and B), 8-row
// groups are 1024 bytes apart (SBO) and a 16-deep step is 32 bytes further
// along the row. Read MN-major (the transpose bit: each row is one k, its 64
// elements along N), k runs down the rows (8-row groups 1024 bytes apart,
// SBO) and the next 64 columns of N are the next tile (LBO).

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// the barriers' initialisation, visible to the asynchronous copies
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive, and expect `bytes` more of bulk copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, counted on `bar` as it lands
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 tok;\n mbarrier.arrive.shared::cta.b64 tok, [%0];\n}\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// the box at (x, y) (element x of a row, row y) of a 2-D tensor map into
// shared memory, counted on `bar` as it lands; rows and columns outside the
// tensor arrive as zeros. `tmap` is the address of a __grid_constant__ kernel
// parameter
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, int x, int y,
                                            uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4}], [%2];\n"
               :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(tmap)),
                  "r"(smem_addr(bar)), "r"(x), "r"(y) : "memory");
}

// generic-proxy writes to shared memory (st.shared) made visible to the
// asynchronous proxy (wgmma, TMA) that reads it next
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a shared-memory matrix descriptor with the 128-byte swizzle: start address,
// LBO and SBO in bytes (16-byte units in the descriptor)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | (uint64_t)((lbo >> 4) & 0x3fff) << 16 |
         (uint64_t)((sbo >> 4) & 0x3fff) << 32 | 1ull << 62;
}

// wgmma.fence: registers written since the last products (accumulators, A
// fragments) are in place before the next products read them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until no product of this warpgroup is in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that write it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// 2^x, ex2.approx.ftz: within 2 ulp; a result below fp32's normal range is 0
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to nearest bf16, packed: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the low and high bf16 of a pair, widened to fp32 (exactly)
__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// c = hi + mid + lo for a pair (c0, c1), each part rounded to nearest bf16
// from the exact remainder of the parts before it. c - hi is exact in fp32
// (at most 16 significant bits), and so is c - hi - mid (at most 8, which
// bf16 holds): the three parts sum to c exactly while the remainders stay
// in bf16's normal range (|c| >= 2^-110); below it the last part is off by
// at most 2^-134 (half of bf16's smallest subnormal). A product of a part by
// a bf16 value is exact in fp32
__device__ __forceinline__ void split3_bf16(float c0, float c1, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  hi = pack_bf16x2(c0, c1);
  c0 -= bf16_lo(hi);
  c1 -= bf16_hi(hi);
  mid = pack_bf16x2(c0, c1);
  c0 -= bf16_lo(mid);
  c1 -= bf16_hi(mid);
  lo = pack_bf16x2(c0, c1);
}

// D (+)= A B, m64n64k16, bf16 operands, fp32 sums; scale_d 0 starts D from
// zero. _ss: A and B from shared memory, both K-major (the logits); _rs_t:
// A from registers, B from shared memory MN-major (the gradient product)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled through the runtime's entry-point query: no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (!found) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &status);
#endif
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || !p) return cudaErrorNotSupported;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}
