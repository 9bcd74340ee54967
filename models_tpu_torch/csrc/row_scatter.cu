// Row scatters of the row-sparse embedding optimizer, for sm_90a.
//
// Replaces the TPU kernels models_tpu/ops/scatter.py::pallas_row_scatter_add
// (K7) and ::pallas_row_scatter_write with its 16-bit route
// ::_block_write_kernel (K8a, K8b):
//
//   row_scatter_add:   table[ids[j]] += upd[j]   (fp32 add; a bf16 table's
//                                                  sum rounds to nearest)
//   row_scatter_write: table[ids[j]]  = rows[j]
//
// for every position j with valid[j] (every j when valid is null) and
// 0 <= ids[j] < R. An invalid position may hold any id: valid[j] is read
// first and the id is never used as an address; an id outside the table is
// dropped. The valid ids must be unique (dedup_rows makes them so): each row
// then has one writer, so there are no atomics, and each element takes one
// fp32 add or one copy, the plain version's result bit for bit.
//
// Design. One warp per position, a grid-stride loop over positions. The
// lanes take neighbouring 16-byte pieces of the row (a 128-wide fp32 row is
// one float4 per lane), when the row is whole pieces and the pointers are
// 16-byte aligned; otherwise each lane takes every 32nd element. The TPU
// kernels' DMA ring with dummy-slot pairing, the 128-lane routing and the
// 8-row block composition for 16-bit rows were Mosaic workarounds and are
// gone: on this card a row is a row. One write kernel, templated on the
// element type, serves fp32 (K8a) and bf16 (K8b).
//
// Bound on an H100 SXM: memory. The add moves 3*n_valid*D*4 bytes for an
// fp32 table (read the row, read the update, write the row) and the write
// 2*n_valid*D*itemsize, plus 5 bytes of id and flag per position, at
// 3.35 TB/s. At the model's batch (8192 rows of 128) that is a few
// microseconds, so launch latency sets the time there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 4096;  // the grid-stride loop takes the rest

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// one 16-byte piece of a row plus its fp32 updates
__device__ __forceinline__ uint4 add_piece(uint4 v, const float* u, float) {
  const float4 x = *reinterpret_cast<const float4*>(u);
  v.x = __float_as_uint(__uint_as_float(v.x) + x.x);
  v.y = __float_as_uint(__uint_as_float(v.y) + x.y);
  v.z = __float_as_uint(__uint_as_float(v.z) + x.z);
  v.w = __float_as_uint(__uint_as_float(v.w) + x.w);
  return v;
}

// two bf16 in one word (the lower address in the low half), each plus its
// update in fp32, rounded to nearest
__device__ __forceinline__ unsigned add_bf16x2(unsigned w, float a, float b) {
  const float lo = __uint_as_float(w << 16) + a;
  const float hi = __uint_as_float(w & 0xffff0000u) + b;
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint4 add_piece(uint4 v, const float* u, __nv_bfloat16) {
  const float4 x0 = *reinterpret_cast<const float4*>(u);
  const float4 x1 = *reinterpret_cast<const float4*>(u + 4);
  v.x = add_bf16x2(v.x, x0.x, x0.y);
  v.y = add_bf16x2(v.y, x0.z, x0.w);
  v.z = add_bf16x2(v.z, x1.x, x1.y);
  v.w = add_bf16x2(v.w, x1.z, x1.w);
  return v;
}

// the row position j writes, or -1 when j is skipped (warp-uniform)
__device__ __forceinline__ int target(const int* ids, const unsigned char* valid, int j, int R) {
  if (valid != nullptr && !valid[j]) return -1;
  const int id = ids[j];
  return (id >= 0 && id < R) ? id : -1;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
scatter_add(T* __restrict__ table, const int* __restrict__ ids, const float* __restrict__ upd,
            const unsigned char* __restrict__ valid, int N, int R, int D) {
  constexpr int V = 16 / sizeof(T);  // elements in a 16-byte piece
  const int lane = threadIdx.x & 31;
  for (int j = blockIdx.x * WARPS + (threadIdx.x >> 5); j < N; j += gridDim.x * WARPS) {
    const int id = target(ids, valid, j, R);
    if (id < 0) continue;
    T* row = table + (size_t)id * D;
    const float* u = upd + (size_t)j * D;
    if (VEC) {
      uint4* piece = reinterpret_cast<uint4*>(row);
      for (int c = lane; c < D / V; c += 32) piece[c] = add_piece(piece[c], u + c * V, T());
    } else {
      for (int d = lane; d < D; d += 32) store(row + d, to_f32(row[d]) + u[d]);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
scatter_write(T* __restrict__ table, const int* __restrict__ ids, const T* __restrict__ rows,
              const unsigned char* __restrict__ valid, int N, int R, int D) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  for (int j = blockIdx.x * WARPS + (threadIdx.x >> 5); j < N; j += gridDim.x * WARPS) {
    const int id = target(ids, valid, j, R);
    if (id < 0) continue;
    T* row = table + (size_t)id * D;
    const T* src = rows + (size_t)j * D;
    if (VEC) {
      uint4* dst4 = reinterpret_cast<uint4*>(row);
      const uint4* src4 = reinterpret_cast<const uint4*>(src);
      for (int c = lane; c < D / V; c += 32) dst4[c] = src4[c];
    } else {
      for (int d = lane; d < D; d += 32) row[d] = src[d];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int blocks_for(int N) {
  const int b = (N + WARPS - 1) / WARPS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

template <typename T>
void launch_add(void* table, const int* ids, const void* upd, const unsigned char* valid, int N,
                int R, int D, cudaStream_t stream) {
  T* t = static_cast<T*>(table);
  const float* u = static_cast<const float*>(upd);
  const bool vec = D % (16 / sizeof(T)) == 0 && aligned16(table) && aligned16(upd);
  if (vec)
    scatter_add<T, true><<<blocks_for(N), THREADS, 0, stream>>>(t, ids, u, valid, N, R, D);
  else
    scatter_add<T, false><<<blocks_for(N), THREADS, 0, stream>>>(t, ids, u, valid, N, R, D);
}

template <typename T>
void launch_write(void* table, const int* ids, const void* rows, const unsigned char* valid,
                  int N, int R, int D, cudaStream_t stream) {
  T* t = static_cast<T*>(table);
  const T* r = static_cast<const T*>(rows);
  const bool vec = D % (16 / sizeof(T)) == 0 && aligned16(table) && aligned16(rows);
  if (vec)
    scatter_write<T, true><<<blocks_for(N), THREADS, 0, stream>>>(t, ids, r, valid, N, R, D);
  else
    scatter_write<T, false><<<blocks_for(N), THREADS, 0, stream>>>(t, ids, r, valid, N, R, D);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table (R, D) f32 or bf16 (table_bf16 != 0), in place; ids (N,) int32;
// upd (N, D) f32; valid (N,) bool or null. Returns cudaGetLastError().
extern "C" int row_scatter_add(void* table, int table_bf16, const int* ids, const void* upd,
                               const unsigned char* valid, int N, int R, int D,
                               cudaStream_t stream) {
  if (N < 1 || R < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (table_bf16)
    launch_add<__nv_bfloat16>(table, ids, upd, valid, N, R, D, stream);
  else
    launch_add<float>(table, ids, upd, valid, N, R, D, stream);
  return (int)cudaGetLastError();
}

// table (R, D) and rows (N, D), both f32 or both bf16 (table_bf16 != 0);
// otherwise as row_scatter_add.
extern "C" int row_scatter_write(void* table, int table_bf16, const int* ids, const void* rows,
                                 const unsigned char* valid, int N, int R, int D,
                                 cudaStream_t stream) {
  if (N < 1 || R < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (table_bf16)
    launch_write<__nv_bfloat16>(table, ids, rows, valid, N, R, D, stream);
  else
    launch_write<float>(table, ids, rows, valid, N, R, D, stream);
  return (int)cudaGetLastError();
}
