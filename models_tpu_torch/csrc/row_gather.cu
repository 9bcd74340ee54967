// Row gather from a device-resident table, for sm_90a.
//
// Replaces the TPU kernel models_tpu/ops/embedding_lookup.py::pallas_gather
// (K9):
//
//   out[j] = table[clamp(ids[j], 0, R - 1)]     for j in [0, B)
//
// for rows of 32-bit (fp32, int32) and 16-bit (bf16, fp16) elements; a copy,
// so the result is the table's row bit for bit. An id outside [0, R) is
// clamped into the table, as the JAX package's fallback
// jnp.take(mode="clip") does: no host sync, and no read outside the table.
// Its callers: the op-level bench's lookups, and the device-resident
// training route, which gathers each chunk's permuted rows of the packed
// (n, F) int32 columns (models/base.py, models/step_graph.py).
//
// Design. A row is copied in pieces of W bytes, the widest of 16, 8, 4 and 2
// that divides the row's bytes and both pointers' alignment (a 128-wide fp32
// row: 32 pieces of 16 bytes; the packed training columns, 26 int32 = 104
// bytes: 13 pieces of 8). L lanes take a row, L the power of two at or above
// its pieces, at least 4 and at most 32 (a row of more than 32 pieces takes
// them 32 at a time), so that one warp instruction covers 32 / L rows; the
// pack takes 16 lanes a row, 2 rows an instruction. A warp takes a batch of
// G = min(32, 8 * 32 / L) rows at a time, a grid-stride loop over batches,
// the grid sized to what the card holds at once (occupancy x SMs) or to the
// batches, if fewer: lanes 0 .. G - 1 read the batch's G ids in one
// coalesced load, shuffles hand each lane its rows' ids, then every lane
// loads its piece of the batch's U = 8 rows (4 at L = 4; ld.global.nc, no
// L1 line: read once) before the first store, so that each batch stands two
// dependent round trips (ids, then rows) before its stores, with U rows in
// flight a lane. The first design (one warp a row, at most 4096 blocks of 8
// warps, 4-byte copies where a row is not whole 16-byte pieces) held one row
// in flight a warp, and its resident warps too few bytes in flight for the
// pack. Measured on an H100 80GB HBM3 at 700 W (ab_kernels.py, L2 flushed
// dirty): the pack's chunk (131,072 ids into 2**20 rows) 0.0165 ms, against
// 0.0230 for the first design; 8192 ids into a 4M x 128 fp32 table 0.0055,
// as the first design: there every row is in flight at once either way, and
// the time is the flush's write-backs (0.0043 after a read-only flush) over
// a floor of 0.0028 with the L2 warm. Streaming stores and 4 rows a lane
// changed neither by more than the noise.
// The TPU kernel's ring of eight row DMAs, the ids padded to a multiple of
// the grid block and the 8-row aligned block fetched around each 16-bit id
// (8x the bytes, then a select) were Mosaic workarounds and are gone: on this
// card a row is a row.
//
// Bound on an H100 SXM: memory. Each row is read once and written once,
// 2 * B * row_bytes, plus 4 * B bytes of ids, at 3.35 TB/s. Random rows of a
// large table also miss the TLB and fetch whole 32-byte sectors (a 104-byte
// row touches 4 or 5), which the byte bound leaves out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 8;  // rows a lane holds in flight
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint2 load_once(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
      : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned load_once(const unsigned* p) {
  unsigned v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned short load_once(const unsigned short* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

// rows a lane holds in flight at L lanes a row: U, or fewer where the
// batch's ids would not fit one load (L = 4: 4 rows of 8 an instruction)
__host__ __device__ constexpr int rows_held(int L) { return L < U ? L : U; }

// rows a warp's batch holds at L lanes a row: 32 / L an instruction, each
// lane holding rows_held(L) of them; one id a lane
__host__ __device__ constexpr int batch_rows(int L) { return 32 / L * rows_held(L); }

// Warp w takes the batches b = w, w + (warps in the grid), ... of G rows
// [b G, (b + 1) G). Lane l is lane c = l % L of row s = l / L of each
// instruction; its rows in the batch are u (32 / L) + s for u < UL, of which
// it copies pieces c, c + L, ... Rows past B copy nothing.
template <typename P, int L>
__global__ void __launch_bounds__(THREADS)
gather(const P* __restrict__ table, const int* __restrict__ ids, P* __restrict__ out, int B,
       int R, int pieces) {
  constexpr int RPI = 32 / L;           // rows an instruction covers
  constexpr int UL = rows_held(L);
  constexpr int G = batch_rows(L);
  static_assert(G <= 32, "a batch's ids are one load of at most 32 lanes");
  const int lane = threadIdx.x & 31, s = lane / L, c = lane % L;
  const int batches = (B + G - 1) / G;
  for (int b = blockIdx.x * WARPS + (threadIdx.x >> 5); b < batches; b += gridDim.x * WARPS) {
    const int j0 = b * G;
    int mine = 0;
    if (lane < G && j0 + lane < B) {
      mine = ids[j0 + lane];
      mine = mine < 0 ? 0 : (mine >= R ? R - 1 : mine);
    }
    int id[UL];
#pragma unroll
    for (int u = 0; u < UL; ++u) id[u] = __shfl_sync(FULL, mine, u * RPI + s);
    for (int p = c; p < (pieces + L - 1) / L * L; p += L) {
      P v[UL];
#pragma unroll
      for (int u = 0; u < UL; ++u)
        if (p < pieces && j0 + u * RPI + s < B)
          v[u] = load_once(table + (size_t)id[u] * pieces + p);
#pragma unroll
      for (int u = 0; u < UL; ++u) {
        const int j = j0 + u * RPI + s;
        if (p < pieces && j < B) out[(size_t)j * pieces + p] = v[u];
      }
    }
  }
}

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

template <typename P, int L>
cudaError_t launch_as(const void* table, const int* ids, void* out, int B, int R, int pieces,
                      cudaStream_t stream) {
  static const int cap = card_blocks(gather<P, L>);
  if (cap < 0) return (cudaError_t)-cap;
  constexpr int G = batch_rows(L);
  const int need = ((B + G - 1) / G + WARPS - 1) / WARPS;
  gather<P, L><<<need < cap ? need : cap, THREADS, 0, stream>>>(
      static_cast<const P*>(table), ids, static_cast<P*>(out), B, R, pieces);
  return cudaGetLastError();
}

// the piece width: the widest of 16, 8, 4, 2 bytes dividing the row and both
// pointers' addresses
int piece_bytes(int row_bytes, const void* table, const void* out) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
                      (uintptr_t)row_bytes;
  for (int w = 16; w > 2; w /= 2)
    if ((a & (uintptr_t)(w - 1)) == 0) return w;
  return 2;
}

// lanes a row: the power of two at or above its pieces, in [4, 32]
int row_lanes(int pieces) {
  int lanes = 4;
  while (lanes < pieces && lanes < 32) lanes *= 2;
  return lanes;
}

template <typename P>
cudaError_t launch_piece(const void* table, const int* ids, void* out, int B, int R,
                         int pieces, cudaStream_t stream) {
  switch (row_lanes(pieces)) {
    case 4: return launch_as<P, 4>(table, ids, out, B, R, pieces, stream);
    case 8: return launch_as<P, 8>(table, ids, out, B, R, pieces, stream);
    case 16: return launch_as<P, 16>(table, ids, out, B, R, pieces, stream);
    default: return launch_as<P, 32>(table, ids, out, B, R, pieces, stream);
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table (R, D), itemsize 4 or 2 bytes (the copy does not look at the type);
// ids (B,) int32; out (B, D) of the table's type. Returns cudaGetLastError().
extern "C" int row_gather(const void* table, int itemsize, const int* ids, void* out, int B,
                          int R, int D, cudaStream_t stream) {
  if (B < 1 || R < 1 || D < 1 || (itemsize != 4 && itemsize != 2))
    return (int)cudaErrorInvalidValue;
  const int row = itemsize * D, w = piece_bytes(row, table, out), pieces = row / w;
  cudaError_t err;
  if (w == 16)
    err = launch_piece<uint4>(table, ids, out, B, R, pieces, stream);
  else if (w == 8)
    err = launch_piece<uint2>(table, ids, out, B, R, pieces, stream);
  else if (w == 4)
    err = launch_piece<unsigned>(table, ids, out, B, R, pieces, stream);
  else
    err = launch_piece<unsigned short>(table, ids, out, B, R, pieces, stream);
  return (int)err;
}

// How row_gather copies rows of `row_bytes` between these pointers:
// plan[0] the piece's bytes, plan[1] the lanes a row, plan[2] the rows a
// warp takes at a time.
extern "C" void row_gather_plan(int row_bytes, const void* table, const void* out, int* plan) {
  const int w = piece_bytes(row_bytes, table, out), lanes = row_lanes(row_bytes / w);
  plan[0] = w;
  plan[1] = lanes;
  plan[2] = batch_rows(lanes);
}
