// Row gather from a device-resident table, for sm_90a.
//
// Replaces the TPU kernel models_tpu/ops/embedding_lookup.py::pallas_gather
// (K9):
//
//   out[j] = table[clamp(ids[j], 0, R - 1)]     for j in [0, B)
//
// for 32-bit (fp32) and 16-bit (bf16, fp16) tables; a copy, so the result is
// the table's row bit for bit. An id outside [0, R) is clamped into the
// table, as the JAX package's fallback jnp.take(mode="clip") does: no host
// sync, and no read outside the table.
//
// Design. One warp per output row, a grid-stride loop over rows. The lanes
// take neighbouring 16-byte pieces of the row (a 128-wide fp32 row is one
// uint4 per lane) when a row is whole pieces and both pointers are 16-byte
// aligned; otherwise each lane copies every 32nd element. The TPU kernel's
// ring of eight row DMAs, the ids padded to a multiple of the grid block and
// the 8-row aligned block fetched around each 16-bit id (8x the bytes, then a
// select) were Mosaic workarounds and are gone: on this card a row is a row.
//
// Bound on an H100 SXM: memory. Each row is read once and written once,
// 2*B*D*itemsize bytes, plus 4*B bytes of ids, at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 4096;  // the grid-stride loop takes the rest

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
gather(const T* __restrict__ table, const int* __restrict__ ids, T* __restrict__ out,
       int B, int R, int D) {
  constexpr int V = 16 / sizeof(T);  // elements in a 16-byte piece
  const int lane = threadIdx.x & 31;
  for (int j = blockIdx.x * WARPS + (threadIdx.x >> 5); j < B; j += gridDim.x * WARPS) {
    int id = ids[j];
    id = id < 0 ? 0 : (id >= R ? R - 1 : id);
    const T* src = table + (size_t)id * D;
    T* dst = out + (size_t)j * D;
    if (VEC) {
      const uint4* src4 = reinterpret_cast<const uint4*>(src);
      uint4* dst4 = reinterpret_cast<uint4*>(dst);
      for (int c = lane; c < D / V; c += 32) dst4[c] = src4[c];
    } else {
      for (int d = lane; d < D; d += 32) dst[d] = src[d];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
void launch(const void* table, const int* ids, void* out, int B, int R, int D,
            cudaStream_t stream) {
  const T* t = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  const int blocks = (B + WARPS - 1) / WARPS < MAX_BLOCKS ? (B + WARPS - 1) / WARPS : MAX_BLOCKS;
  if (D % (16 / sizeof(T)) == 0 && aligned16(table) && aligned16(out))
    gather<T, true><<<blocks, THREADS, 0, stream>>>(t, ids, o, B, R, D);
  else
    gather<T, false><<<blocks, THREADS, 0, stream>>>(t, ids, o, B, R, D);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table (R, D), itemsize 4 or 2 bytes (the copy does not look at the type);
// ids (B,) int32; out (B, D) of the table's type. Returns cudaGetLastError().
extern "C" int row_gather(const void* table, int itemsize, const int* ids, void* out, int B,
                          int R, int D, cudaStream_t stream) {
  if (B < 1 || R < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (itemsize == 4)
    launch<uint32_t>(table, ids, out, B, R, D, stream);
  else if (itemsize == 2)
    launch<uint16_t>(table, ids, out, B, R, D, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
