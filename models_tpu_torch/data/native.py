"""The host C++ loops of the data plane, bound with ``ctypes``, and their
plain numpy versions.

Two libraries, built from the checkout's sources at first use by
``ops/kernels.py`` (``g++ -O3 -shared -fPIC`` into ``build/models_tpu_torch/``;
a build that fails raises with the compiler's output):

- ``csrc/host/fastbatch.cc``, the port's copy of the JAX package's native
  batcher (``models_tpu/data/native/fastbatch.cc``): :func:`pad_ragged` and
  :func:`gather_rows`. The loader pads every list column through
  :func:`pad_ragged`, on every platform; ``gather_rows`` is bound beside it,
  as in the JAX package, which takes rows with numpy.
- ``csrc/host/parquet_codec.cc``, the loops of ``data/parquet.py``: snappy,
  the RLE / bit-packed hybrid, levels to rows, the dictionary gather and
  ``BYTE_ARRAY`` values.

Each function here calls its library; ``plain_<name>`` beside it computes
the same result in Python and numpy. The tests hold the one to the other;
nothing on the reader's, the writer's or the loader's path calls a plain
version. The GIL is released while a library function runs (``ctypes``), so
the loader's prefetch thread decodes while the main thread trains.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..ops import kernels

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_SIGNATURES = {
    "fastbatch": {
        **{f"pad_ragged_{t}": ([_P, _P, _I64, _I64, _I64, _P, _P], None)
           for t in ("f32", "i32", "i64")},
        **{f"gather_rows_{t}": ([_P, _P, _I64, _I64, _P], None) for t in ("f32", "i32")},
    },
    "parquet_codec": {
        "snappy_uncompressed_length": ([_P, _I64], _I64),
        "snappy_decompress": ([_P, _I64, _P, _I64], _I64),
        "snappy_max_compressed_length": ([_I64], _I64),
        "snappy_compress": ([_P, _I64, _P], _I64),
        "rle_decode": ([_P, _I64, _I32, _P, _I64], _I64),
        "rle_max_encoded_length": ([_I64, _I32], _I64),
        "rle_encode": ([_P, _I64, _I32, _P], _I64),
        "levels_to_rows": ([_P, _P, _I64, _I32, _I32, _P, _P, _P, _I64], _I64),
        "dict_gather": ([_P, _I64, _I64, _P, _I64, _P], _I64),
        "byte_array_unpack": ([_P, _I64, _I64, _P, _P], _I64),
        "byte_array_pack": ([_P, _P, _I64, _P], _I64),
    },
}


def _lib(name: str) -> ctypes.CDLL:
    lib = kernels.load(name)
    if not getattr(lib, "_signed", False):
        for fn, (args, res) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        lib._signed = True
    return lib


def _ptr(a) -> Optional[int]:
    """The address of a contiguous numpy array or of a ``bytes`` object."""
    if a is None:
        return None
    if isinstance(a, (bytes, bytearray, memoryview)):
        a = np.frombuffer(a, np.uint8)
    return a.ctypes.data


def _u8(buf) -> np.ndarray:
    return np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf


def _fail(what: str):
    raise ValueError(f"parquet: malformed {what}")


# ---------------------------------------------------------------------------
# the native batcher
# ---------------------------------------------------------------------------

# by element width: a float64 or uint32 element is copied as the int64 or
# int32 of the same bits (the loops copy, they compute nothing)
_PAD = {4: "pad_ragged_i32", 8: "pad_ragged_i64"}


def _check_offsets(offsets: np.ndarray, n_values: int) -> np.ndarray:
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if len(offsets) < 1 or offsets[0] < 0 or offsets[-1] > n_values or (
            len(offsets) > 1 and (np.diff(offsets) < 0).any()):
        raise ValueError(f"offsets must rise from 0 to at most {n_values} values")
    return offsets


def pad_ragged(values: np.ndarray, offsets: np.ndarray, max_len: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged rows -> (padded (n, max_len, ...) values, (n, max_len) bool
    mask), in C++ (``pad_ragged_{f32,i32,i64}``). Rows are cut at
    ``max_len``; padded positions hold 0. Values of 4 or 8 bytes an element;
    any other width raises."""
    values = np.ascontiguousarray(values)
    fn = _PAD.get(values.dtype.itemsize)
    if fn is None or values.dtype == object:
        raise TypeError(f"pad_ragged takes 4- or 8-byte values, not {values.dtype}")
    offsets = _check_offsets(offsets, len(values))
    batch = len(offsets) - 1
    width = int(np.prod(values.shape[1:], dtype=np.int64))
    out = np.empty((batch, max_len) + values.shape[1:], dtype=values.dtype)
    mask = np.empty((batch, max_len), dtype=np.uint8)
    getattr(_lib("fastbatch"), fn)(_ptr(values), _ptr(offsets), batch, max_len, width,
                                   _ptr(out), _ptr(mask))
    return out, mask.view(bool)


def plain_pad_ragged(values: np.ndarray, offsets: np.ndarray, max_len: int):
    """:func:`pad_ragged` in numpy."""
    lengths = np.diff(offsets)
    pos = np.arange(max_len)[None, :]
    mask = pos < np.minimum(lengths, max_len)[:, None]
    if len(values) == 0:
        return np.zeros((len(lengths), max_len) + values.shape[1:], dtype=values.dtype), mask
    idx = np.minimum(offsets[:-1, None] + pos, len(values) - 1)
    zero = np.zeros((), dtype=values.dtype)
    m = mask.reshape(mask.shape + (1,) * (values.ndim - 1))
    return np.where(m, values[idx], zero), mask


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` for a (n, ...) array of 4-byte elements, in C++
    (``gather_rows_{f32,i32}``); indices outside [0, n) raise."""
    src = np.ascontiguousarray(src)
    if src.dtype.itemsize != 4 or src.dtype == object:
        raise TypeError(f"gather_rows takes 4-byte elements, not {src.dtype}")
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"gather_rows: an index outside [0, {len(src)})")
    width = int(np.prod(src.shape[1:], dtype=np.int64))
    out = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    _lib("fastbatch").gather_rows_i32(_ptr(src), _ptr(idx), len(idx), width, _ptr(out))
    return out


def plain_gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return np.asarray(src)[np.asarray(idx, np.int64)]


# ---------------------------------------------------------------------------
# snappy
# ---------------------------------------------------------------------------

def snappy_decompress(buf) -> np.ndarray:
    """A raw snappy stream -> its bytes (uint8); a malformed stream raises."""
    src = _u8(buf)
    lib = _lib("parquet_codec")
    n = lib.snappy_uncompressed_length(_ptr(src), len(src))
    if n < 0:
        _fail("snappy stream")
    out = np.empty(n, np.uint8)
    if lib.snappy_decompress(_ptr(src), len(src), _ptr(out), n) != n:
        _fail("snappy stream")
    return out


def snappy_compress(buf) -> bytes:
    src = _u8(buf)
    lib = _lib("parquet_codec")
    out = np.empty(lib.snappy_max_compressed_length(len(src)), np.uint8)
    n = lib.snappy_compress(_ptr(src), len(src), _ptr(out))
    return out[:n].tobytes()


def _varint(data: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(data):
            _fail("varint")
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _put_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def plain_snappy_decompress(buf) -> bytes:
    data = bytes(buf)
    want, pos = _varint(data, 0)
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            n = tag >> 2
            if n >= 60:
                nb = n - 59
                n = int.from_bytes(data[pos:pos + nb], "little")
                pos += nb
            n += 1
            out += data[pos:pos + n]
            pos += n
            continue
        if kind == 1:
            n, off = ((tag >> 2) & 7) + 4, ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            n, off = (tag >> 2) + 1, int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:
            n, off = (tag >> 2) + 1, int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            _fail("snappy stream")
        for _ in range(n):
            out.append(out[-off])
    if len(out) != want:
        _fail("snappy stream")
    return bytes(out)


def _emit_literal(out: bytearray, lit: bytes) -> None:
    n = len(lit) - 1
    if n < 60:
        out.append(n << 2)
    else:
        nb = (n.bit_length() + 7) // 8
        out.append((59 + nb) << 2)
        out += n.to_bytes(nb, "little")
    out += lit


def _emit_copy(out: bytearray, off: int, n: int) -> None:
    def upto64(n):
        if n < 12 and off < 2048:
            out.append(1 | ((n - 4) << 2) | ((off >> 8) << 5))
            out.append(off & 0xFF)
        else:
            out.append(2 | ((n - 1) << 2))
            out.extend(off.to_bytes(2, "little"))
    while n >= 68:
        upto64(64)
        n -= 64
    if n > 64:
        upto64(60)
        n -= 60
    upto64(n)


def plain_snappy_compress(buf) -> bytes:
    """:func:`snappy_compress`'s greedy match finder, step for step (the
    same bytes out)."""
    data = bytes(buf)
    out = bytearray()
    _put_varint(out, len(data))
    bits, block, margin = 14, 1 << 16, 15
    for start in range(0, len(data), block):
        b = data[start:start + block]
        end, emit = len(b), 0
        if end >= margin:
            table = [0] * (1 << bits)
            limit, ip, skip = end - margin, 1, 32
            while ip < limit:
                word = b[ip:ip + 4]
                h = ((int.from_bytes(word, "little") * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - bits)
                cand = table[h]
                table[h] = ip
                if cand < ip and b[cand:cand + 4] == word:
                    if ip > emit:
                        _emit_literal(out, b[emit:ip])
                    m = 4
                    while ip + m < end and b[cand + m] == b[ip + m]:
                        m += 1
                    _emit_copy(out, ip - cand, m)
                    ip += m
                    emit = ip
                    skip = 32
                    if ip < limit:
                        w = int.from_bytes(b[ip - 1:ip + 3], "little")
                        table[((w * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - bits)] = ip - 1
                else:
                    ip += skip >> 5
                    skip += 1
        if emit < end:
            _emit_literal(out, b[emit:end])
    return bytes(out)


# ---------------------------------------------------------------------------
# the RLE / bit-packed hybrid
# ---------------------------------------------------------------------------

def rle_decode(buf, bit_width: int, count: int) -> Tuple[np.ndarray, int]:
    """``count`` values of ``bit_width`` bits from the hybrid stream ``buf``
    -> (int32 values, bytes consumed)."""
    src = _u8(buf)
    out = np.empty(count, np.int32)
    used = _lib("parquet_codec").rle_decode(_ptr(src), len(src), bit_width, _ptr(out), count)
    if used < 0:
        _fail("RLE / bit-packed run")
    return out, int(used)


def plain_rle_decode(buf, bit_width: int, count: int) -> Tuple[np.ndarray, int]:
    data = bytes(buf)
    out: list = []
    pos, vbytes = 0, (bit_width + 7) // 8
    while len(out) < count:
        header, pos = _varint(data, pos)
        if header & 1:
            groups = header >> 1
            raw = np.frombuffer(data[pos:pos + groups * bit_width], np.uint8)
            bits = np.unpackbits(raw, bitorder="little").reshape(-1, bit_width) \
                if bit_width else np.zeros((groups * 8, 0), np.uint8)
            vals = (bits.astype(np.int64) << np.arange(bit_width)).sum(axis=1)
            out.extend(vals[:count - len(out)].tolist())
            pos += groups * bit_width
        else:
            v = int.from_bytes(data[pos:pos + vbytes], "little")
            pos += vbytes
            out.extend([v] * min(header >> 1, count - len(out)))
    return np.asarray(out, np.int64).astype(np.uint32).view(np.int32), pos


def rle_encode(values: np.ndarray, bit_width: int) -> bytes:
    """``values`` (each in [0, 2**bit_width)) as the hybrid: runs of at
    least 8 equal values as RLE runs, the rest bit-packed in groups of 8."""
    vals = np.ascontiguousarray(values, dtype=np.int32)
    lib = _lib("parquet_codec")
    out = np.empty(lib.rle_max_encoded_length(len(vals), bit_width), np.uint8)
    n = lib.rle_encode(_ptr(vals), len(vals), bit_width, _ptr(out))
    return out[:n].tobytes()


def plain_rle_encode(values: np.ndarray, bit_width: int) -> bytes:
    vals = [int(v) for v in np.asarray(values, np.int64)]
    out, pending, vbytes = bytearray(), [], (bit_width + 7) // 8

    def flush():
        groups = -(-len(pending) // 8)
        padded = pending + [0] * (groups * 8 - len(pending))
        _put_varint(out, (groups << 1) | 1)
        bits = np.asarray([[(v >> k) & 1 for k in range(bit_width)] for v in padded], np.uint8)
        out.extend(np.packbits(bits.reshape(-1), bitorder="little").tobytes())
        pending.clear()

    i = 0
    while i < len(vals):
        run = 1
        while i + run < len(vals) and vals[i + run] == vals[i]:
            run += 1
        fill = (8 - len(pending) % 8) % 8
        if run - fill >= 8:
            pending.extend([vals[i]] * fill)
            if pending:
                flush()
            _put_varint(out, (run - fill) << 1)
            out += (vals[i] & 0xFFFFFFFF).to_bytes(4, "little")[:vbytes]
        else:
            pending.extend([vals[i]] * run)
        i += run
    if pending:
        flush()
    return bytes(out)


# ---------------------------------------------------------------------------
# levels, dictionaries, byte arrays
# ---------------------------------------------------------------------------

def levels_to_rows(def_levels: Optional[np.ndarray], rep_levels: Optional[np.ndarray],
                   count: int, list_def: int, max_def: int):
    """Levels -> (offsets or None, row validity, slot validity). A flat
    column (no repetition levels) has one row and one slot a level; in a
    list column a level of repetition 0 starts a row, non-null where its
    definition is at least ``list_def``, and a level defined beyond
    ``list_def`` is an element slot, valid where defined to ``max_def``."""
    d = None if def_levels is None else np.ascontiguousarray(def_levels, np.int32)
    r = None if rep_levels is None else np.ascontiguousarray(rep_levels, np.int32)
    offsets = np.empty(count + 1, np.int64) if r is not None else None
    row_valid = np.empty(count, np.uint8)
    slot_valid = np.empty(count, np.uint8)
    rows = _lib("parquet_codec").levels_to_rows(
        _ptr(d), _ptr(r), count, list_def, max_def, _ptr(offsets), _ptr(row_valid),
        _ptr(slot_valid), count)
    if rows < 0:
        _fail("repetition levels")
    if offsets is None:
        return None, row_valid.view(bool), slot_valid.view(bool)
    slots = int(offsets[rows])
    return offsets[:rows + 1], row_valid[:rows].view(bool), slot_valid[:slots].view(bool)


def plain_levels_to_rows(def_levels, rep_levels, count: int, list_def: int, max_def: int):
    d = np.full(count, max_def) if def_levels is None else np.asarray(def_levels)
    if rep_levels is None:
        valid = d == max_def
        return None, valid, valid.copy()
    r = np.asarray(rep_levels)
    starts = r == 0
    slot = d > list_def
    offsets = np.concatenate([np.cumsum(slot)[starts] - slot[starts], [slot.sum()]])
    return offsets.astype(np.int64), d[starts] >= list_def, d[slot] == max_def


def dict_gather(dictionary: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``dictionary[idx]`` for a 1-D array of fixed-width values; an index
    outside the dictionary raises."""
    dictionary = np.ascontiguousarray(dictionary)
    idx = np.ascontiguousarray(idx, np.int32)
    out = np.empty(len(idx), dictionary.dtype)
    if _lib("parquet_codec").dict_gather(_ptr(dictionary), len(dictionary),
                                         dictionary.dtype.itemsize, _ptr(idx), len(idx),
                                         _ptr(out)) != 0:
        _fail("dictionary index")
    return out


def plain_dict_gather(dictionary: np.ndarray, idx: np.ndarray) -> np.ndarray:
    idx = np.asarray(idx)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(dictionary)):
        _fail("dictionary index")
    return np.asarray(dictionary)[idx]


def byte_array_unpack(buf, count: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """``count`` PLAIN ``BYTE_ARRAY`` values -> (their bytes back to back,
    int64 offsets (count + 1), bytes consumed)."""
    src = _u8(buf)
    offsets = np.empty(count + 1, np.int64)
    data = np.empty(len(src), np.uint8)
    used = _lib("parquet_codec").byte_array_unpack(_ptr(src), len(src), count, _ptr(offsets),
                                                   _ptr(data))
    if used < 0:
        _fail("BYTE_ARRAY values")
    return data[:offsets[-1]], offsets, int(used)


def plain_byte_array_unpack(buf, count: int):
    data, pos, parts, offsets = bytes(buf), 0, [], [0]
    for _ in range(count):
        n = int.from_bytes(data[pos:pos + 4], "little")
        parts.append(data[pos + 4:pos + 4 + n])
        pos += 4 + n
        offsets.append(offsets[-1] + n)
    return np.frombuffer(b"".join(parts), np.uint8), np.asarray(offsets, np.int64), pos


def byte_array_pack(data: np.ndarray, offsets: np.ndarray) -> bytes:
    """The inverse of :func:`byte_array_unpack`."""
    data = np.ascontiguousarray(data, np.uint8)
    offsets = _check_offsets(offsets, len(data))
    count = len(offsets) - 1
    out = np.empty(int(offsets[-1] - offsets[0]) + 4 * count, np.uint8)
    n = _lib("parquet_codec").byte_array_pack(_ptr(data), _ptr(offsets), count, _ptr(out))
    return out[:n].tobytes()


def plain_byte_array_pack(data: np.ndarray, offsets: np.ndarray) -> bytes:
    raw = np.asarray(data, np.uint8).tobytes()
    return b"".join(int(b - a).to_bytes(4, "little") + raw[a:b]
                    for a, b in zip(offsets[:-1], offsets[1:]))
