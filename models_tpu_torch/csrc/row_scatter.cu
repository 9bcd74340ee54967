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
// 0 <= ids[j] < R. An invalid position may hold any id: it is never used as
// an address; an id outside the table is dropped. The valid ids must be
// unique (dedup_rows makes them so): each row then has one writer, so there
// are no atomics, and each element takes one fp32 add or one copy, the plain
// version's result bit for bit.
//
// Design.
//   K7 (scatter_add): a warp takes ADD_P = 8 positions at a time, a
//   grid-stride loop over such batches, the grid sized to what the card
//   holds at once (occupancy x SMs) or to the batches, if fewer. Lanes 0..7
//   read the batch's ids and valid flags in one coalesced load each, and
//   shuffles hand the targets to every lane; then each lane loads its
//   16-byte piece of the eight update rows (ld.global.nc, no L1 line: read
//   once) and of the eight table rows, all before the first add and store,
//   so that two dependent round trips to memory (ids, then rows) stand
//   before the stores. A D = 128 fp32 row is one float4 a lane; D = 256 two
//   pieces, one after the other; a bf16 row takes its fp32 updates as two
//   float4 a piece. Rows not whole 16-byte pieces, or pointers off 16
//   bytes, take each lane's every 32nd element, position by position.
//   What held the first design (one warp per position, 1024 blocks of 256
//   threads; 0.00838 ms at the path's shape, 45% of its bound, on an H100
//   80GB HBM3 at 700 W): three dependent round trips (valid[j], then ids[j],
//   then the rows behind the skip's branch), 1 KB in flight a warp, and a
//   launch of 1024 blocks for 8192 positions.
//   K8 (scatter_write): a warp takes WRITE_P = 8 positions at a time, with
//   K7's batch targets (one coalesced load of the ids and one of the flags,
//   shuffles) and its grid from occupancy. The batch's source rows are one
//   run of 16-byte pieces, which the lanes take in turn, 32 pieces an
//   instruction (two bf16 rows of 128, one fp32 row), each lane up to
//   WRITE_K of them read once before the first store; a lane finds its
//   piece's target by one shuffle. Where N <= R the rows are read beside the
//   ids, so that one round trip to memory stands before the stores; where
//   N > R (at least N - R positions invalid: a genres-like batch of 81,920
//   positions into 24 rows) after them, for the valid positions only. One
//   write kernel, templated on the element type, serves fp32 (K8a) and bf16
//   (K8b); rows not whole pieces, or pointers off 16 bytes, take each lane's
//   every 32nd element, position by position. What held the first design
//   (one warp per position, 1024 blocks of 256 threads; 0.00492 ms for bf16
//   rows at the path's shape, 26% of its bound, on an H100 80GB HBM3 at
//   700 W): three dependent round trips (valid[j], then ids[j], then the row
//   behind the skip's branch) and half of each warp idle on a 256-byte bf16
//   row. Batching alone, the ids first, left K8b where it was (0.00493 ms);
//   the rows beside the ids took it to 0.00377, and 16 positions a warp
//   were slower than 8.
// The TPU kernels' DMA ring with dummy-slot pairing, the 128-lane routing
// and the 8-row block composition for 16-bit rows were Mosaic workarounds and
// are gone: on this card a row is a row.
//
// Bound on an H100 SXM: memory. The add moves 3*n_valid*D*4 bytes for an
// fp32 table (read the row, read the update, write the row) and the write
// 2*n_valid*D*itemsize, plus 5 bytes of id and flag per position, at
// 3.35 TB/s: at the path's batch (8192 rows of 128 into the bench's 4M-row
// fp32 table) the add's bound is 0.00377 ms. Random rows of a 2 GB table
// also miss the TLB, which the byte bound leaves out; the userId table
// (162,544 rows) shows how much.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ADD_P = 8;          // K7: positions a warp takes at a time
constexpr int WRITE_P = 8;        // K8: positions a warp takes at a time
constexpr int WRITE_K = 8;        // K8: 16-byte pieces a lane holds at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16 bytes of updates, read once: through the non-coherent path, no L1 line
__device__ __forceinline__ float4 load_once(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// one 16-byte piece of a row plus its fp32 updates (one float4 for fp32)
__device__ __forceinline__ uint4 add_piece(uint4 v, const float4* x, float) {
  v.x = __float_as_uint(__uint_as_float(v.x) + x[0].x);
  v.y = __float_as_uint(__uint_as_float(v.y) + x[0].y);
  v.z = __float_as_uint(__uint_as_float(v.z) + x[0].z);
  v.w = __float_as_uint(__uint_as_float(v.w) + x[0].w);
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

// eight bf16 plus two float4 of updates
__device__ __forceinline__ uint4 add_piece(uint4 v, const float4* x, __nv_bfloat16) {
  v.x = add_bf16x2(v.x, x[0].x, x[0].y);
  v.y = add_bf16x2(v.y, x[0].z, x[0].w);
  v.z = add_bf16x2(v.z, x[1].x, x[1].y);
  v.w = add_bf16x2(v.w, x[1].z, x[1].w);
  return v;
}

// Lane p < P of a warp: the row that position b P + p of batch b writes, or
// -1 when it is past N, invalid or out of range; other lanes: -1. The ids
// and the flags come in one coalesced load each
__device__ __forceinline__ int batch_target(const int* ids, const unsigned char* valid, int b,
                                            int P, int N, int R, int lane) {
  const int j = b * P + lane;
  int id = -1, ok = 0;
  if (lane < P && j < N) {
    id = ids[j];
    ok = valid == nullptr || valid[j];
  }
  return ok && id >= 0 && id < R ? id : -1;
}

// K7. Warp w takes the batches b = w, w + (warps in the grid), ... of ADD_P
// positions [b ADD_P, (b + 1) ADD_P): lanes 0 .. ADD_P - 1 read the batch's
// ids and flags together (one coalesced load each), the targets go to every
// lane by shuffles, then each lane loads its 16-byte piece of the ADD_P
// update rows (read once) and of the ADD_P table rows, all before the first
// add and store. Positions past N, invalid or out of range load nothing.
// VEC false (D not whole pieces, or a pointer off 16 bytes): each lane takes
// every 32nd element of each row in turn.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
scatter_add(T* __restrict__ table, const int* __restrict__ ids, const float* __restrict__ upd,
            const unsigned char* __restrict__ valid, int N, int R, int D) {
  constexpr int V = 16 / sizeof(T), U = V / 4;  // elements in a piece; their float4 updates
  const int lane = threadIdx.x & 31;
  const int batches = (N + ADD_P - 1) / ADD_P;
  for (int b = blockIdx.x * WARPS + (threadIdx.x >> 5); b < batches; b += gridDim.x * WARPS) {
    const int mine = batch_target(ids, valid, b, ADD_P, N, R, lane);
    int tgt[ADD_P];
#pragma unroll
    for (int p = 0; p < ADD_P; ++p) tgt[p] = __shfl_sync(FULL, mine, p);
    const float* u0 = upd + (size_t)b * ADD_P * D;
    if (VEC) {
      for (int c = lane; c < (D / V + 31) / 32 * 32; c += 32) {
        const bool in = c < D / V;
        uint4 row[ADD_P];
        float4 u[ADD_P][U];
#pragma unroll
        for (int p = 0; p < ADD_P; ++p)
          if (in && tgt[p] >= 0) {
#pragma unroll
            for (int k = 0; k < U; ++k) u[p][k] = load_once(u0 + (size_t)p * D + c * V + 4 * k);
            row[p] = reinterpret_cast<const uint4*>(table + (size_t)tgt[p] * D)[c];
          }
#pragma unroll
        for (int p = 0; p < ADD_P; ++p)
          if (in && tgt[p] >= 0)
            reinterpret_cast<uint4*>(table + (size_t)tgt[p] * D)[c] = add_piece(row[p], u[p], T());
      }
    } else {
#pragma unroll
      for (int p = 0; p < ADD_P; ++p) {
        if (tgt[p] < 0) continue;
        T* row = table + (size_t)tgt[p] * D;
        const float* u = u0 + (size_t)p * D;
        for (int d = lane; d < D; d += 32) store(row + d, to_f32(row[d]) + u[d]);
      }
    }
  }
}

// K8. Warp w takes the batches of WRITE_P positions as K7's warps do, with
// their targets. VEC: the batch's source rows, P = min(WRITE_P, N - b
// WRITE_P) rows of pr = D / V pieces, are pieces f = 0 .. P pr - 1 of one
// run; lane l takes f = l, l + 32, ..., WRITE_K at a time: it loads them
// (read once), then stores each to row f / pr of the batch, at piece f % pr
// of its target. ROWS_FIRST: the loads go out beside the ids' (one round
// trip before the stores, every position's row read); otherwise after them,
// for the valid positions only (two round trips). Positions past N, invalid
// or out of range store nothing. VEC false: each lane takes every 32nd
// element of each row in turn.
template <typename T, bool VEC, bool ROWS_FIRST>
__global__ void __launch_bounds__(THREADS)
scatter_write(T* __restrict__ table, const int* __restrict__ ids, const T* __restrict__ rows,
              const unsigned char* __restrict__ valid, int N, int R, int D) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int batches = (N + WRITE_P - 1) / WRITE_P;
  for (int b = blockIdx.x * WARPS + (threadIdx.x >> 5); b < batches; b += gridDim.x * WARPS) {
    const int mine = batch_target(ids, valid, b, WRITE_P, N, R, lane);
    const T* src = rows + (size_t)b * WRITE_P * D;
    if (VEC) {
      const int pr = D / V;
      const int n = min(WRITE_P, N - b * WRITE_P) * pr;  // the batch's pieces
      for (int f0 = 0; f0 < n; f0 += 32 * WRITE_K) {
        uint4 v[WRITE_K];
        int tgt[WRITE_K];
#pragma unroll
        for (int k = 0; k < WRITE_K; ++k) {
          const int f = f0 + 32 * k + lane;
          if (ROWS_FIRST && f < n) v[k] = load_once(reinterpret_cast<const uint4*>(src) + f);
          tgt[k] = __shfl_sync(FULL, mine, f / pr);  // every lane, in or past the run
          if (!ROWS_FIRST && f < n && tgt[k] >= 0)
            v[k] = load_once(reinterpret_cast<const uint4*>(src) + f);
        }
#pragma unroll
        for (int k = 0; k < WRITE_K; ++k) {
          const int f = f0 + 32 * k + lane;
          if (f < n && tgt[k] >= 0)
            reinterpret_cast<uint4*>(table + (size_t)tgt[k] * D)[f % pr] = v[k];
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < WRITE_P; ++p) {
        const int tgt = __shfl_sync(FULL, mine, p);
        if (tgt < 0) continue;
        T* row = table + (size_t)tgt * D;
        const T* from = src + (size_t)p * D;
        for (int d = lane; d < D; d += 32) row[d] = from[d];
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// as many blocks of `kernel` as the card holds at once (the first call's
// card; a negative value is a CUDA error, negated)
template <typename Kernel>
int card_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  return err != cudaSuccess ? -(int)err : per_sm * sms > 0 ? per_sm * sms : 1;
}

// K7's grid: one warp a batch of ADD_P positions, at most what the card holds
template <typename T, bool VEC>
cudaError_t launch_add_as(T* table, const int* ids, const float* upd,
                          const unsigned char* valid, int N, int R, int D, cudaStream_t stream) {
  static const int cap = card_blocks(scatter_add<T, VEC>);
  if (cap < 0) return (cudaError_t)-cap;
  const int need = ((N + ADD_P - 1) / ADD_P + WARPS - 1) / WARPS;
  scatter_add<T, VEC><<<need < cap ? need : cap, THREADS, 0, stream>>>(table, ids, upd, valid, N,
                                                                       R, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_add(void* table, const int* ids, const void* upd, const unsigned char* valid,
                       int N, int R, int D, cudaStream_t stream) {
  T* t = static_cast<T*>(table);
  const float* u = static_cast<const float*>(upd);
  const bool vec = D % (16 / sizeof(T)) == 0 && aligned16(table) && aligned16(upd);
  return vec ? launch_add_as<T, true>(t, ids, u, valid, N, R, D, stream)
             : launch_add_as<T, false>(t, ids, u, valid, N, R, D, stream);
}

// K8's grid: one warp a batch of WRITE_P positions, at most what the card holds
template <typename T, bool VEC, bool ROWS_FIRST>
cudaError_t launch_write_as(T* table, const int* ids, const T* rows, const unsigned char* valid,
                            int N, int R, int D, cudaStream_t stream) {
  static const int cap = card_blocks(scatter_write<T, VEC, ROWS_FIRST>);
  if (cap < 0) return (cudaError_t)-cap;
  const int need = ((N + WRITE_P - 1) / WRITE_P + WARPS - 1) / WARPS;
  scatter_write<T, VEC, ROWS_FIRST><<<need < cap ? need : cap, THREADS, 0, stream>>>(
      table, ids, rows, valid, N, R, D);
  return cudaGetLastError();
}

// K8's order of loads, from the shape: the rows beside the ids where at most
// N <= R positions can be valid anyway (the valid ids are unique rows of the
// table), so that reading every position's row costs at most what a batch
// of N valid positions reads; after the ids where N > R, where at least N - R
// positions are invalid (a genres-like batch: 81,920 positions into 24 rows)
bool write_rows_first(int N, int R) { return N <= R; }

template <typename T>
cudaError_t launch_write(void* table, const int* ids, const void* rows,
                         const unsigned char* valid, int N, int R, int D, cudaStream_t stream) {
  T* t = static_cast<T*>(table);
  const T* r = static_cast<const T*>(rows);
  const bool vec = D % (16 / sizeof(T)) == 0 && aligned16(table) && aligned16(rows);
  if (!vec) return launch_write_as<T, false, false>(t, ids, r, valid, N, R, D, stream);
  return write_rows_first(N, R)
             ? launch_write_as<T, true, true>(t, ids, r, valid, N, R, D, stream)
             : launch_write_as<T, true, false>(t, ids, r, valid, N, R, D, stream);
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
  return (int)(table_bf16 ? launch_add<__nv_bfloat16>(table, ids, upd, valid, N, R, D, stream)
                          : launch_add<float>(table, ids, upd, valid, N, R, D, stream));
}

// The positions a warp of row_scatter_add takes at a time.
extern "C" int row_scatter_add_batch() { return ADD_P; }

// table (R, D) and rows (N, D), both f32 or both bf16 (table_bf16 != 0);
// otherwise as row_scatter_add.
extern "C" int row_scatter_write(void* table, int table_bf16, const int* ids, const void* rows,
                                 const unsigned char* valid, int N, int R, int D,
                                 cudaStream_t stream) {
  if (N < 1 || R < 0 || D < 1) return (int)cudaErrorInvalidValue;
  return (int)(table_bf16 ? launch_write<__nv_bfloat16>(table, ids, rows, valid, N, R, D, stream)
                          : launch_write<float>(table, ids, rows, valid, N, R, D, stream));
}

// The positions a warp of row_scatter_write takes at a time.
extern "C" int row_scatter_write_batch() { return WRITE_P; }

// 1 where row_scatter_write reads the source rows beside the ids (N <= R),
// 0 where after them.
extern "C" int row_scatter_write_rows_first(int N, int R) { return write_rows_first(N, R); }
