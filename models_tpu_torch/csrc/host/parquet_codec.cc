// parquet_codec: the hot loops of the port's parquet reader and writer
// (models_tpu_torch/data/parquet.py), on the host CPU.
//
// The JAX package reads and writes parquet through pyarrow; the port reads
// and writes the format itself, and the loops that touch every value live
// here: snappy decompression and compression, the RLE / bit-packed hybrid
// (levels and dictionary indices) decoded and encoded, definition and
// repetition levels turned into row offsets and validity, the dictionary
// gather, and BYTE_ARRAY values unpacked from and packed into their 4-byte
// length prefixes. Each function has a plain Python / numpy version in
// models_tpu_torch/data/native.py that the tests hold it to.
//
// A plain C interface, built with g++ -O3 -shared -fPIC at first use
// (models_tpu_torch/ops/kernels.py) and bound with ctypes. Every function
// checks the bounds of what it reads and returns -1 (or another negative
// code) where the input is malformed, never reading or writing outside the
// buffers it was given.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// ---------------------------------------------------------------------------
// snappy (the raw format: a varint of the uncompressed length, then literal
// and copy elements)
// ---------------------------------------------------------------------------

int64_t read_varint32(const uint8_t* src, int64_t n, int64_t* pos, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (*pos < n && shift <= 35) {
    uint8_t b = src[(*pos)++];
    v |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return 0;
    }
    shift += 7;
  }
  return -1;
}

uint8_t* emit_literal(uint8_t* op, const uint8_t* lit, int64_t len) {
  int64_t n = len - 1;
  if (n < 60) {
    *op++ = uint8_t(n << 2);
  } else {
    int count = 0;
    uint8_t bytes[4];
    while (n > 0) {
      bytes[count++] = uint8_t(n & 0xff);
      n >>= 8;
    }
    *op++ = uint8_t((59 + count) << 2);
    for (int i = 0; i < count; ++i) *op++ = bytes[i];
  }
  std::memcpy(op, lit, len);
  return op + len;
}

uint8_t* emit_copy_upto64(uint8_t* op, int64_t offset, int64_t len) {
  if (len < 12 && offset < 2048) {
    *op++ = uint8_t(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *op++ = uint8_t(offset & 0xff);
  } else {
    *op++ = uint8_t(2 | ((len - 1) << 2));
    *op++ = uint8_t(offset & 0xff);
    *op++ = uint8_t(offset >> 8);
  }
  return op;
}

uint8_t* emit_copy(uint8_t* op, int64_t offset, int64_t len) {
  while (len >= 68) {
    op = emit_copy_upto64(op, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy_upto64(op, offset, 60);
    len -= 60;
  }
  return emit_copy_upto64(op, offset, len);
}

constexpr int kHashBits = 14;
constexpr int64_t kBlock = 1 << 16;
constexpr int64_t kMargin = 15;  // no match starts within the last bytes of a block

inline uint32_t hash4(uint32_t v) { return (v * 0x1e35a7bdu) >> (32 - kHashBits); }

// One block of at most 64 KiB: a greedy match finder over a hash of 4-byte
// sequences (positions within the block, so every offset fits 16 bits).
uint8_t* compress_block(const uint8_t* base, int64_t len, uint8_t* op, uint16_t* table) {
  const uint8_t* end = base + len;
  const uint8_t* next_emit = base;
  if (len >= kMargin) {
    std::memset(table, 0, sizeof(uint16_t) << kHashBits);
    const uint8_t* limit = end - kMargin;
    const uint8_t* ip = base + 1;
    uint32_t skip = 32;
    while (ip < limit) {
      uint32_t h = hash4(load32(ip));
      const uint8_t* cand = base + table[h];
      table[h] = uint16_t(ip - base);
      if (cand < ip && load32(cand) == load32(ip)) {
        if (ip > next_emit) op = emit_literal(op, next_emit, ip - next_emit);
        int64_t matched = 4;
        while (ip + matched < end && cand[matched] == ip[matched]) ++matched;
        op = emit_copy(op, ip - cand, matched);
        ip += matched;
        next_emit = ip;
        skip = 32;
        if (ip < limit) table[hash4(load32(ip - 1))] = uint16_t(ip - 1 - base);
      } else {
        ip += skip++ >> 5;  // step faster through bytes that find nothing
      }
    }
  }
  if (next_emit < end) op = emit_literal(op, next_emit, end - next_emit);
  return op;
}

// ---------------------------------------------------------------------------
// the RLE / bit-packed hybrid
// ---------------------------------------------------------------------------

uint8_t* put_varint(uint8_t* op, uint64_t v) {
  while (v >= 0x80) {
    *op++ = uint8_t(v | 0x80);
    v >>= 7;
  }
  *op++ = uint8_t(v);
  return op;
}

// values[0..count) bit-packed LSB first, count a multiple of 8
uint8_t* put_bitpacked(uint8_t* op, const int32_t* values, int64_t count, int bw) {
  uint64_t acc = 0;
  int bits = 0;
  for (int64_t i = 0; i < count; ++i) {
    acc |= uint64_t(uint32_t(values[i])) << bits;
    bits += bw;
    while (bits >= 8) {
      *op++ = uint8_t(acc & 0xff);
      acc >>= 8;
      bits -= 8;
    }
  }
  if (bits > 0) *op++ = uint8_t(acc & 0xff);
  return op;
}

}  // namespace

extern "C" {

// The uncompressed length a snappy stream states, or -1.
int64_t snappy_uncompressed_length(const uint8_t* src, int64_t n) {
  int64_t pos = 0;
  uint64_t len;
  if (read_varint32(src, n, &pos, &len) != 0) return -1;
  return int64_t(len);
}

// Decompress src[0..n) into dst[0..cap). Returns the bytes written, or -1
// if the stream is malformed or does not fill exactly its stated length.
int64_t snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t pos = 0;
  uint64_t want;
  if (read_varint32(src, n, &pos, &want) != 0 || int64_t(want) > cap) return -1;
  int64_t out = 0;
  while (pos < n) {
    uint8_t tag = src[pos++];
    int64_t len, offset;
    switch (tag & 3) {
      case 0: {  // literal
        len = tag >> 2;
        if (len >= 60) {
          int nb = int(len) - 59;
          if (pos + nb > n) return -1;
          len = 0;
          for (int i = 0; i < nb; ++i) len |= int64_t(src[pos + i]) << (8 * i);
          pos += nb;
        }
        len += 1;
        if (pos + len > n || out + len > int64_t(want)) return -1;
        std::memcpy(dst + out, src + pos, len);
        pos += len;
        out += len;
        continue;
      }
      case 1:
        if (pos + 1 > n) return -1;
        len = ((tag >> 2) & 7) + 4;
        offset = (int64_t(tag >> 5) << 8) | src[pos];
        pos += 1;
        break;
      case 2:
        if (pos + 2 > n) return -1;
        len = (tag >> 2) + 1;
        offset = int64_t(src[pos]) | (int64_t(src[pos + 1]) << 8);
        pos += 2;
        break;
      default:
        if (pos + 4 > n) return -1;
        len = (tag >> 2) + 1;
        offset = int64_t(load32(src + pos));
        pos += 4;
        break;
    }
    if (offset == 0 || offset > out || out + len > int64_t(want)) return -1;
    uint8_t* d = dst + out;
    const uint8_t* s = d - offset;
    if (offset >= len) {
      std::memcpy(d, s, len);
    } else {
      for (int64_t i = 0; i < len; ++i) d[i] = s[i];  // the copy overlaps its output
    }
    out += len;
  }
  return out == int64_t(want) ? out : -1;
}

int64_t snappy_max_compressed_length(int64_t n) { return 32 + n + n / 6; }

// Compress src[0..n) into dst (at least snappy_max_compressed_length(n)
// bytes). Returns the compressed length.
int64_t snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
  uint8_t* op = put_varint(dst, uint64_t(n));
  std::vector<uint16_t> table(size_t(1) << kHashBits);
  for (int64_t start = 0; start < n; start += kBlock) {
    int64_t len = n - start < kBlock ? n - start : kBlock;
    op = compress_block(src + start, len, op, table.data());
  }
  return op - dst;
}

// Decode `count` values of bit width `bw` (0..32) from the hybrid stream
// src[0..n) into out. Returns the bytes consumed, or -1.
int64_t rle_decode(const uint8_t* src, int64_t n, int32_t bw, int32_t* out, int64_t count) {
  if (bw < 0 || bw > 32) return -1;
  const int vbytes = (bw + 7) / 8;
  const uint64_t mask = bw == 32 ? 0xffffffffull : ((1ull << bw) - 1);
  int64_t pos = 0, got = 0;
  while (got < count) {
    uint64_t header;
    if (read_varint32(src, n, &pos, &header) != 0) return -1;
    if (header & 1) {  // bit-packed: (header >> 1) groups of 8 values
      int64_t values = int64_t(header >> 1) * 8;
      int64_t nbytes = int64_t(header >> 1) * bw;
      if (pos + nbytes > n) return -1;
      const uint8_t* p = src + pos;
      int64_t take = values < count - got ? values : count - got;
      uint64_t acc = 0;
      int bits = 0;
      int64_t byte = 0;
      for (int64_t i = 0; i < take; ++i) {
        while (bits < bw) {
          acc |= uint64_t(p[byte++]) << bits;
          bits += 8;
        }
        out[got + i] = int32_t(uint32_t(acc & mask));
        acc >>= bw;
        bits -= bw;
      }
      got += take;
      pos += nbytes;
    } else {  // a run of one value
      int64_t run = int64_t(header >> 1);
      if (pos + vbytes > n) return -1;
      uint32_t v = 0;
      for (int i = 0; i < vbytes; ++i) v |= uint32_t(src[pos + i]) << (8 * i);
      pos += vbytes;
      int64_t take = run < count - got ? run : count - got;
      for (int64_t i = 0; i < take; ++i) out[got + i] = int32_t(v);
      got += take;
    }
  }
  return pos;
}

// The most bytes rle_encode can write for `count` values of width `bw`.
int64_t rle_max_encoded_length(int64_t count, int32_t bw) {
  return 64 + (count / 8 + 1) * (2 * int64_t(bw) + 24);
}

// Encode values[0..count) of bit width `bw` as the hybrid: runs of at least
// 8 equal values as RLE runs, the rest bit-packed in groups of 8 (the last
// group padded with zeros). Returns the bytes written into dst.
int64_t rle_encode(const int32_t* values, int64_t count, int32_t bw, uint8_t* dst) {
  uint8_t* op = dst;
  const int vbytes = (bw + 7) / 8;
  std::vector<int32_t> pending;
  auto flush = [&](bool last) {
    if (pending.empty()) return;
    int64_t groups = (int64_t(pending.size()) + 7) / 8;
    if (!last && int64_t(pending.size()) % 8) return;  // caller keeps groups whole
    pending.resize(groups * 8, 0);
    op = put_varint(op, uint64_t(groups << 1) | 1);
    op = put_bitpacked(op, pending.data(), groups * 8, bw);
    pending.clear();
  };
  int64_t i = 0;
  while (i < count) {
    int64_t run = 1;
    while (i + run < count && values[i + run] == values[i]) ++run;
    // fill the pending groups to a whole 8 from the run before an RLE run
    int64_t fill = (8 - int64_t(pending.size()) % 8) % 8;
    if (run - fill >= 8) {
      for (int64_t k = 0; k < fill; ++k) pending.push_back(values[i]);
      flush(false);
      int64_t rest = run - fill;
      op = put_varint(op, uint64_t(rest) << 1);
      uint32_t v = uint32_t(values[i]);
      for (int b = 0; b < vbytes; ++b) *op++ = uint8_t(v >> (8 * b));
    } else {
      for (int64_t k = 0; k < run; ++k) pending.push_back(values[i]);
    }
    i += run;
  }
  flush(true);
  return op - dst;
}

// Definition (and repetition) levels -> rows and value slots.
//
// Flat column (rep == nullptr): one row and one slot a level;
// slot_valid[i] = def[i] == max_def; returns count.
// List column (max repetition 1): a level with rep 0 starts a row, which is
// non-null where def >= list_def; a level with def > list_def is one
// element slot, valid where def == max_def. offsets (rows + 1) gets each
// row's first slot. Returns the rows, or -1 if they exceed max_rows or the
// first level does not start a row.
int64_t levels_to_rows(const int32_t* def, const int32_t* rep, int64_t count, int32_t list_def,
                       int32_t max_def, int64_t* offsets, uint8_t* row_valid,
                       uint8_t* slot_valid, int64_t max_rows) {
  if (rep == nullptr) {
    if (count > max_rows) return -1;
    for (int64_t i = 0; i < count; ++i) {
      uint8_t v = def == nullptr || def[i] == max_def;
      slot_valid[i] = v;
      row_valid[i] = v;
    }
    return count;
  }
  int64_t rows = 0, slots = 0;
  for (int64_t i = 0; i < count; ++i) {
    int32_t d = def == nullptr ? max_def : def[i];
    if (rep[i] == 0) {
      if (rows >= max_rows) return -1;
      offsets[rows] = slots;
      row_valid[rows] = d >= list_def;
      ++rows;
    } else if (rows == 0) {
      return -1;
    }
    if (d > list_def) slot_valid[slots++] = d == max_def;
  }
  offsets[rows] = slots;
  return rows;
}

// out[i] = dict[idx[i]] for values of `width` bytes. Returns 0, or -1 if an
// index lies outside [0, n_dict).
int64_t dict_gather(const uint8_t* dict, int64_t n_dict, int64_t width, const int32_t* idx,
                    int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t j = idx[i];
    if (j < 0 || j >= n_dict) return -1;
    std::memcpy(out + i * width, dict + int64_t(j) * width, width);
  }
  return 0;
}

// `count` PLAIN BYTE_ARRAY values (each a 4-byte little-endian length, then
// its bytes) from src[0..n): their bytes back to back into data (at most n
// bytes), their starts into offsets (count + 1). Returns the bytes
// consumed, or -1.
int64_t byte_array_unpack(const uint8_t* src, int64_t n, int64_t count, int64_t* offsets,
                          uint8_t* data) {
  int64_t pos = 0, out = 0;
  for (int64_t i = 0; i < count; ++i) {
    if (pos + 4 > n) return -1;
    int64_t len = int64_t(load32(src + pos));
    pos += 4;
    if (pos + len > n) return -1;
    offsets[i] = out;
    std::memcpy(data + out, src + pos, len);
    pos += len;
    out += len;
  }
  offsets[count] = out;
  return pos;
}

// The inverse: values data[offsets[i]..offsets[i+1]) as PLAIN BYTE_ARRAY
// into dst (offsets[count] + 4 * count bytes). Returns the bytes written.
int64_t byte_array_pack(const uint8_t* data, const int64_t* offsets, int64_t count,
                        uint8_t* dst) {
  uint8_t* op = dst;
  for (int64_t i = 0; i < count; ++i) {
    uint32_t len = uint32_t(offsets[i + 1] - offsets[i]);
    std::memcpy(op, &len, 4);
    std::memcpy(op + 4, data + offsets[i], len);
    op += 4 + len;
  }
  return op - dst;
}

}  // extern "C"
