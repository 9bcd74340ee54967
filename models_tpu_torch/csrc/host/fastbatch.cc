// fastbatch: the port's copy of the JAX package's native batcher
// (models_tpu/data/native/fastbatch.cc), on the host CPU.
//
// The loader's hot host loop is a list column's ragged rows (values and
// offsets) padded to a (batch, max_len) block with its mask; gather_rows
// takes the rows of a matrix by index. Single-pass loops with no numpy
// temporaries, a plain C interface, built with g++ -O3 -shared -fPIC at
// first use (models_tpu_torch/ops/kernels.py) and bound with ctypes in
// models_tpu_torch/data/native.py, which keeps the plain numpy versions the
// tests hold them to.

#include <cstdint>
#include <cstring>

extern "C" {

// values (n_values, width) laid out row-major; offsets (batch+1);
// out (batch, max_len, width); mask (batch, max_len) as uint8.
// width=1 covers scalar-element lists; width>1 covers vector elements.
void pad_ragged_f32(const float* values, const int64_t* offsets, int64_t batch,
                    int64_t max_len, int64_t width, float* out, uint8_t* mask) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t start = offsets[b];
    int64_t n = offsets[b + 1] - start;
    if (n > max_len) n = max_len;
    float* out_row = out + b * max_len * width;
    uint8_t* mask_row = mask + b * max_len;
    std::memcpy(out_row, values + start * width, n * width * sizeof(float));
    std::memset(out_row + n * width, 0, (max_len - n) * width * sizeof(float));
    std::memset(mask_row, 1, n);
    std::memset(mask_row + n, 0, max_len - n);
  }
}

void pad_ragged_i32(const int32_t* values, const int64_t* offsets, int64_t batch,
                    int64_t max_len, int64_t width, int32_t* out, uint8_t* mask) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t start = offsets[b];
    int64_t n = offsets[b + 1] - start;
    if (n > max_len) n = max_len;
    int32_t* out_row = out + b * max_len * width;
    uint8_t* mask_row = mask + b * max_len;
    std::memcpy(out_row, values + start * width, n * width * sizeof(int32_t));
    std::memset(out_row + n * width, 0, (max_len - n) * width * sizeof(int32_t));
    std::memset(mask_row, 1, n);
    std::memset(mask_row + n, 0, max_len - n);
  }
}

void pad_ragged_i64(const int64_t* values, const int64_t* offsets, int64_t batch,
                    int64_t max_len, int64_t width, int64_t* out, uint8_t* mask) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t start = offsets[b];
    int64_t n = offsets[b + 1] - start;
    if (n > max_len) n = max_len;
    int64_t* out_row = out + b * max_len * width;
    uint8_t* mask_row = mask + b * max_len;
    std::memcpy(out_row, values + start * width, n * width * sizeof(int64_t));
    std::memset(out_row + n * width, 0, (max_len - n) * width * sizeof(int64_t));
    std::memset(mask_row, 1, n);
    std::memset(mask_row + n, 0, max_len - n);
  }
}

// gather rows of a (n, width) matrix by index — the shuffle/epoch-permutation
// path (replaces arrow Table.take for flat numeric columns).
void gather_rows_f32(const float* src, const int64_t* idx, int64_t n_idx,
                     int64_t width, float* out) {
  for (int64_t i = 0; i < n_idx; ++i) {
    std::memcpy(out + i * width, src + idx[i] * width, width * sizeof(float));
  }
}

void gather_rows_i32(const int32_t* src, const int64_t* idx, int64_t n_idx,
                     int64_t width, int32_t* out) {
  for (int64_t i = 0; i < n_idx; ++i) {
    std::memcpy(out + i * width, src + idx[i] * width, width * sizeof(int32_t));
  }
}

}  // extern "C"
