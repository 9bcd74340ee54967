"""The port's parquet codec: the file format read and written without
``pyarrow`` (the card's host has none), for the tables of ``data/dataset.py``.

A table is a dict of numpy columns in the layout ``table_to_numpy`` gives
the JAX package (``models_tpu/data/dataset.py``): a flat column is one
array; a list column is ``<name>__values`` (every row's values, back to
back) and ``<name>__offsets`` (int64, rows + 1). Strings are object arrays of
``str``, binary values of ``bytes``. Where a column chunk holds nulls it
comes back as pyarrow's ``to_numpy`` gives it: integers as float64 with NaN,
floats with NaN, booleans and strings as object arrays with ``None``; a null
list row has no values (its offsets repeat), a null element is a null value.

Reading (:class:`ParquetFile`): the footer (``FileMetaData``, Thrift's
compact protocol) gives the row count, the row groups and the columns, so
``num_rows`` and the column names read nothing else. A row group is the unit
of reading (the loader streams them). It reads:

- data pages v1 and v2 (a dictionary page first where there is one);
- the encodings ``PLAIN``, ``PLAIN_DICTIONARY`` / ``RLE_DICTIONARY`` and
  ``RLE`` (booleans), with levels in the RLE / bit-packed hybrid;
- the codecs ``UNCOMPRESSED``, ``SNAPPY`` and ``GZIP``;
- the types ``BOOLEAN``, ``INT32`` (with its 8-, 16- and unsigned
  annotations), ``INT64``, ``FLOAT``, ``DOUBLE`` and ``BYTE_ARRAY`` (UTF-8
  strings, or bytes);
- required and optional top-level columns, and lists of them (the
  three-level ``list<element>`` ``pq.write_table`` writes, and the legacy
  two-level form).

Any other codec (ZSTD, LZ4, BROTLI, LZO), encoding (the DELTA ones,
BYTE_STREAM_SPLIT, BIT_PACKED levels), type (INT96, FIXED_LEN_BYTE_ARRAY),
date or time annotation, or nesting (a struct, a map, a list of lists)
raises ``NotImplementedError`` naming it.

Writing (:func:`write_table`): one data page (v1) per column chunk, values
``PLAIN`` (booleans bit-packed, strings and bytes with their 4-byte length),
definition and repetition levels in the RLE / bit-packed hybrid, the page
SNAPPY-compressed (``pq.write_table``'s default codec; the compressor finds
matches). Every column is optional, as pyarrow writes a nullable field;
strings are ``BYTE_ARRAY`` annotated UTF-8; a list column, or a 2-D array,
is a three-level ``list<element>``. Row groups of ``row_group_size`` rows
(pyarrow's default, 1,048,576). pyarrow reads such a file back to the table
it would have written.

The loops over every value (snappy, the hybrid, levels to rows, the
dictionary gather, ``BYTE_ARRAY`` values) are C++ (``data/native.py``).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import native

MAGIC = b"PAR1"
DEFAULT_ROW_GROUP_SIZE = 1 << 20
VALUES, OFFSETS = "__values", "__offsets"

# parquet.thrift's enums
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
TYPE_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY",
              "FIXED_LEN_BYTE_ARRAY")
REQUIRED, OPTIONAL, REPEATED = range(3)
CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4", 6: "ZSTD",
          7: "LZ4_RAW"}
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
             8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
CT_UTF8, CT_LIST = 0, 3
# converted types of INT32 / INT64 columns -> the numpy type pyarrow gives
_CONVERTED_INTS = {11: np.uint8, 12: np.uint16, 13: np.uint32, 14: np.uint64, 15: np.int8,
                   16: np.int16, 17: np.int32, 18: np.int64}
_CONVERTED_UNSUPPORTED = {1: "MAP", 2: "MAP_KEY_VALUE", 4: "ENUM", 5: "DECIMAL", 6: "DATE",
                          7: "TIME_MILLIS", 8: "TIME_MICROS", 9: "TIMESTAMP_MILLIS",
                          10: "TIMESTAMP_MICROS", 19: "JSON", 20: "BSON", 21: "INTERVAL"}
_LOGICAL_UNSUPPORTED = {2: "MAP", 4: "ENUM", 5: "DECIMAL", 6: "DATE", 7: "TIME", 8: "TIMESTAMP",
                        12: "JSON", 13: "BSON", 14: "UUID", 15: "FLOAT16"}
_PHYSICAL = {BOOLEAN: np.dtype(bool), INT32: np.dtype(np.int32), INT64: np.dtype(np.int64),
             FLOAT: np.dtype(np.float32), DOUBLE: np.dtype(np.float64)}


# ---------------------------------------------------------------------------
# Thrift's compact protocol
# ---------------------------------------------------------------------------

# compact type ids
_T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64, _T_DOUBLE, _T_BINARY = range(1, 9)
_T_LIST, _T_SET, _T_MAP, _T_STRUCT = 9, 10, 11, 12


class ThriftReader:
    """A struct as ``{field id: value}`` (nested structs as dicts, lists as
    lists, binary as bytes); fields it does not know are read and kept."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf if isinstance(buf, bytes) else memoryview(buf)
        self.pos = pos

    def _byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ValueError("parquet: the Thrift structure runs past its buffer")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def _varint(self) -> int:
        v = shift = 0
        while True:
            b = self._byte()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    def _zigzag(self) -> int:
        v = self._varint()
        return (v >> 1) ^ -(v & 1)

    def struct(self) -> dict:
        out, last = {}, 0
        while True:
            header = self._byte()
            if header == 0:
                return out
            kind, delta = header & 0x0F, header >> 4
            last = last + delta if delta else self._zigzag()
            out[last] = self._value(kind)

    def _value(self, kind: int):
        if kind in (_T_TRUE, _T_FALSE):
            return kind == _T_TRUE
        if kind == _T_BYTE:
            b = self._byte()
            return b - 256 if b > 127 else b
        if kind in (_T_I16, _T_I32, _T_I64):
            return self._zigzag()
        if kind == _T_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if kind == _T_BINARY:
            n = self._varint()
            v = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return v
        if kind in (_T_LIST, _T_SET):
            header = self._byte()
            size, elem = header >> 4, header & 0x0F
            if size == 15:
                size = self._varint()
            if elem in (_T_TRUE, _T_FALSE):
                return [self._byte() == _T_TRUE for _ in range(size)]
            return [self._value(elem) for _ in range(size)]
        if kind == _T_MAP:
            size = self._varint()
            if not size:
                return {}
            kv = self._byte()
            return {self._value(kv >> 4): self._value(kv & 0x0F) for _ in range(size)}
        if kind == _T_STRUCT:
            return self.struct()
        raise ValueError(f"parquet: unknown Thrift compact type {kind}")


class ThriftWriter:
    """Writes structs given as lists of ``(field id, type, value)``; a
    ``None`` value is left out. Types: ``"bool"``, ``"i8"``, ``"i32"``,
    ``"i64"``, ``"binary"`` (bytes or str), ``"struct"`` (a field list),
    ``("list", elem type)``."""

    _KIND = {"i8": _T_BYTE, "i16": _T_I16, "i32": _T_I32, "i64": _T_I64, "binary": _T_BINARY,
             "struct": _T_STRUCT}

    def __init__(self):
        self.out = bytearray()

    def _varint(self, v: int) -> None:
        while v >= 0x80:
            self.out.append((v & 0x7F) | 0x80)
            v >>= 7
        self.out.append(v)

    def _zigzag(self, v: int) -> None:
        self._varint((v << 1) ^ (v >> 63))

    def struct(self, fields: Sequence[tuple]) -> "ThriftWriter":
        last = 0
        for fid, kind, value in fields:
            if value is None:
                continue
            ck = (_T_TRUE if value else _T_FALSE) if kind == "bool" else self._kind(kind)
            delta = fid - last
            if 0 < delta <= 15:
                self.out.append((delta << 4) | ck)
            else:
                self.out.append(ck)
                self._zigzag(fid)
            last = fid
            if kind != "bool":
                self._value(kind, value)
        self.out.append(0)
        return self

    def _kind(self, kind) -> int:
        return _T_LIST if isinstance(kind, tuple) else self._KIND[kind]

    def _value(self, kind, value) -> None:
        if isinstance(kind, tuple):
            elem = kind[1]
            ek = (_T_TRUE if elem == "bool" else self._kind(elem))
            if len(value) < 15:
                self.out.append((len(value) << 4) | ek)
            else:
                self.out.append(0xF0 | ek)
                self._varint(len(value))
            for v in value:
                if elem == "bool":
                    self.out.append(_T_TRUE if v else _T_FALSE)
                else:
                    self._value(elem, v)
        elif kind == "i8":
            self.out.append(value & 0xFF)
        elif kind in ("i16", "i32", "i64"):
            self._zigzag(int(value))
        elif kind == "binary":
            raw = value.encode() if isinstance(value, str) else bytes(value)
            self._varint(len(raw))
            self.out += raw
        elif kind == "struct":
            self.struct(value)
        else:
            raise ValueError(f"unknown Thrift type {kind!r}")


# ---------------------------------------------------------------------------
# the schema: top-level columns and their leaves
# ---------------------------------------------------------------------------

class Column:
    """A top-level column: its name, leaf (physical type, annotations), and
    levels: ``max_def`` / ``max_rep`` of the leaf, ``list_def`` the level at
    which a list row is non-null (``is_list``)."""

    def __init__(self, name: str, leaf: dict, is_list: bool, max_def: int, max_rep: int,
                 list_def: int):
        self.name, self.leaf, self.is_list = name, leaf, is_list
        self.max_def, self.max_rep, self.list_def = max_def, max_rep, list_def
        self.physical = leaf.get(1)
        if self.physical not in _PHYSICAL and self.physical != BYTE_ARRAY:
            kind = TYPE_NAMES[self.physical] if self.physical is not None else "a group"
            raise NotImplementedError(f"parquet: column {name!r} has type {kind}, which the "
                                      "port does not read")
        converted, logical = leaf.get(6), leaf.get(10) or {}
        for fid in logical:
            if fid in _LOGICAL_UNSUPPORTED:
                raise NotImplementedError(f"parquet: column {name!r} is annotated "
                                          f"{_LOGICAL_UNSUPPORTED[fid]}, which the port does "
                                          "not read")
        if converted in _CONVERTED_UNSUPPORTED:
            raise NotImplementedError(f"parquet: column {name!r} is annotated "
                                      f"{_CONVERTED_UNSUPPORTED[converted]}, which the port "
                                      "does not read")
        self.is_string = self.physical == BYTE_ARRAY and (converted == CT_UTF8 or 1 in logical)
        dtype = _PHYSICAL.get(self.physical)
        if converted in _CONVERTED_INTS:
            dtype = np.dtype(_CONVERTED_INTS[converted])
        elif 10 in logical:
            bits, signed = logical[10].get(1, 32), logical[10].get(2, True)
            dtype = np.dtype(f"{'i' if signed else 'u'}{bits // 8}")
        self.dtype = dtype  # None for BYTE_ARRAY

    def arrow_kind(self) -> Tuple[str, int]:
        """("int", bits), ("float", bits) or ("other", 0): what ``_infer_schema``
        asks of the arrow type."""
        if self.dtype is not None and self.dtype.kind in "iu":
            return "int", self.dtype.itemsize * 8
        if self.dtype is not None and self.dtype.kind == "f":
            return "float", self.dtype.itemsize * 8
        return "other", 0


def _columns(elements: List[dict]) -> List[Column]:
    """The top-level columns of a flattened schema (its root first)."""
    cols, i = [], 1
    for _ in range(elements[0].get(5, 0)):
        el = elements[i]
        name = el[4].decode()
        opt = int(el.get(3, REQUIRED) == OPTIONAL)
        children = el.get(5, 0)
        if el.get(3) == REPEATED:
            raise NotImplementedError(f"parquet: the repeated top-level field {name!r} (a "
                                      "one-level list) is not read by the port")
        if not children:
            cols.append(Column(name, el, False, opt, 0, 0))
            i += 1
            continue
        is_list = el.get(6) == CT_LIST or 3 in (el.get(10) or {})
        rep = elements[i + 1]
        if not is_list or children != 1 or rep.get(3) != REPEATED:
            raise NotImplementedError(f"parquet: column {name!r} is a struct or map, which "
                                      "the port does not read")
        if rep.get(5, 0) == 0:  # two-level list: the repeated field is the element
            cols.append(Column(name, rep, True, opt + 1, 1, opt))
            i += 2
            continue
        elem = elements[i + 2]
        if rep.get(5) != 1 or elem.get(5, 0):
            raise NotImplementedError(f"parquet: column {name!r} nests lists or structs, "
                                      "which the port does not read")
        elem_opt = int(elem.get(3, REQUIRED) == OPTIONAL)
        cols.append(Column(name, elem, True, opt + 1 + elem_opt, 1, opt))
        i += 3
    return cols


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _decompress(codec: int, buf: np.ndarray, size: int) -> np.ndarray:
    if codec == 0:
        return buf
    if codec == 1:
        out = native.snappy_decompress(buf)
    elif codec == 2:
        out = np.frombuffer(zlib.decompress(buf.tobytes(), 47), np.uint8)
    else:
        raise NotImplementedError(f"parquet: the {CODECS.get(codec, codec)} codec is not read "
                                  "by the port (it reads UNCOMPRESSED, SNAPPY and GZIP)")
    if len(out) != size:
        raise ValueError(f"parquet: a page decompressed to {len(out)} bytes, its header "
                         f"says {size}")
    return out


def _bit_width(v: int) -> int:
    return int(v).bit_length()


def _strings(data: np.ndarray, offsets: np.ndarray, as_str: bool) -> np.ndarray:
    """(bytes, offsets) -> an object array of ``str`` (or ``bytes``)."""
    n = len(offsets) - 1
    out = np.empty(n, dtype=object)
    if n == 0:
        return out
    if not (data == 0).any():  # split at inserted NULs, in C
        joined = np.insert(data, offsets[1:-1], 0).tobytes()
        out[:] = joined.decode().split("\0") if as_str else joined.split(b"\0")
        return out
    raw = data.tobytes()
    out[:] = [raw[a:b].decode() if as_str else raw[a:b]
              for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]
    return out


class _Chunk:
    """One column chunk decoded page by page: levels and non-null values."""

    def __init__(self, col: Column, meta: dict, buf: np.ndarray):
        self.col, self.codec = col, meta.get(4, 0)
        self.defs: List[np.ndarray] = []
        self.reps: List[np.ndarray] = []
        self.values: List[np.ndarray] = []
        self.dictionary: Optional[np.ndarray] = None
        pos, n_levels, total = 0, 0, meta[5]
        while n_levels < total:
            if pos >= len(buf):
                raise ValueError(f"parquet: column {col.name!r}: its chunk ends after "
                                 f"{n_levels} of {total} values")
            reader = ThriftReader(buf, pos)
            header = reader.struct()
            pos = reader.pos
            size = header[3]
            page = buf[pos:pos + size]
            pos += size
            kind = header[1]
            if kind == DICTIONARY_PAGE:
                self._dictionary(header[7], _decompress(self.codec, page, header[2]))
            elif kind == DATA_PAGE:
                n_levels += self._page_v1(header[5], _decompress(self.codec, page, header[2]))
            elif kind == DATA_PAGE_V2:
                n_levels += self._page_v2(header[8], page, header[2])
            elif kind != INDEX_PAGE:
                raise NotImplementedError(f"parquet: page type {kind} is not read by the port")

    def _plain(self, buf: np.ndarray, n: int) -> np.ndarray:
        col = self.col
        if col.physical == BOOLEAN:
            bits = np.unpackbits(buf[:(n + 7) // 8], bitorder="little")
            return bits[:n].astype(bool)
        if col.physical == BYTE_ARRAY:
            data, offsets, _ = native.byte_array_unpack(buf, n)
            return _strings(data, offsets, col.is_string)
        width = _PHYSICAL[col.physical].itemsize
        if len(buf) < n * width:
            raise ValueError(f"parquet: column {col.name!r}: a page holds {len(buf)} bytes "
                             f"for {n} values of {width}")
        vals = np.frombuffer(buf, _PHYSICAL[col.physical], count=n)
        return vals.astype(col.dtype) if col.dtype != vals.dtype else vals

    def _dictionary(self, header: dict, buf: np.ndarray) -> None:
        encoding = header.get(2, PLAIN)
        if encoding not in (PLAIN, PLAIN_DICTIONARY):
            raise NotImplementedError(f"parquet: a dictionary page encoded "
                                      f"{ENCODINGS.get(encoding, encoding)}")
        self.dictionary = self._plain(buf, header[1])

    def _levels(self, buf: np.ndarray, max_level: int, count: int, prefixed: bool,
                encoding: int = RLE) -> Tuple[Optional[np.ndarray], int]:
        """(levels or None where max_level is 0, bytes used)."""
        if max_level == 0:
            return None, 0
        if encoding != RLE:
            raise NotImplementedError(f"parquet: levels encoded "
                                      f"{ENCODINGS.get(encoding, encoding)} are not read by "
                                      "the port")
        if prefixed:
            n = int(np.frombuffer(buf[:4], "<u4")[0])
            levels, _ = native.rle_decode(buf[4:4 + n], _bit_width(max_level), count)
            return levels, 4 + n
        levels, _ = native.rle_decode(buf, _bit_width(max_level), count)
        return levels, len(buf)

    def _values(self, encoding: int, buf: np.ndarray, n: int) -> None:
        col = self.col
        if encoding == PLAIN:
            vals = self._plain(buf, n)
        elif encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if self.dictionary is None:
                raise ValueError(f"parquet: column {col.name!r}: a dictionary-encoded page "
                                 "with no dictionary page")
            idx, _ = native.rle_decode(buf[1:], int(buf[0]) if len(buf) else 0, n)
            if self.dictionary.dtype == object:
                if n and (idx.min() < 0 or idx.max() >= len(self.dictionary)):
                    raise ValueError("parquet: malformed dictionary index")
                vals = self.dictionary[idx]
            else:
                vals = native.dict_gather(self.dictionary, idx)
        elif encoding == RLE and col.physical == BOOLEAN:
            size = int(np.frombuffer(buf[:4], "<u4")[0])
            vals = native.rle_decode(buf[4:4 + size], 1, n)[0].astype(bool)
        else:
            raise NotImplementedError(f"parquet: column {col.name!r} has a page encoded "
                                      f"{ENCODINGS.get(encoding, encoding)}, which the port "
                                      "does not read")
        self.values.append(vals)

    def _count_valid(self, defs: Optional[np.ndarray], count: int) -> int:
        return count if defs is None else int(np.count_nonzero(defs == self.col.max_def))

    def _page_v1(self, header: dict, page: np.ndarray) -> int:
        count, col = header[1], self.col
        reps, used = self._levels(page, col.max_rep, count, True, header.get(4, RLE))
        pos = used
        defs, used = self._levels(page[pos:], col.max_def, count, True, header.get(3, RLE))
        pos += used
        self._keep(reps, defs)
        self._values(header[2], page[pos:], self._count_valid(defs, count))
        return count

    def _page_v2(self, header: dict, page: np.ndarray, uncompressed: int) -> int:
        count, col = header[1], self.col
        def_len, rep_len = header[5], header[6]
        reps, _ = self._levels(page[:rep_len], col.max_rep, count, False)
        defs, _ = self._levels(page[rep_len:rep_len + def_len], col.max_def, count, False)
        body = page[rep_len + def_len:]
        if header.get(7, True):
            body = _decompress(self.codec, body, uncompressed - rep_len - def_len)
        self._keep(reps, defs)
        self._values(header[4], body, self._count_valid(defs, count))
        return count

    def _keep(self, reps, defs) -> None:
        if reps is not None:
            self.reps.append(reps)
        if defs is not None:
            self.defs.append(defs)

    def columns(self, n_rows: int) -> Dict[str, np.ndarray]:
        """The chunk as ``table_to_numpy`` gives it (strings not hashed)."""
        col = self.col
        values = _concat(self.values, col)
        if not self.defs and not col.is_list:  # required, flat: nothing is null
            return {col.name: values}
        count = sum(len(d) for d in self.defs) if self.defs else sum(len(r) for r in self.reps)
        defs = np.concatenate(self.defs) if self.defs else None
        reps = np.concatenate(self.reps) if self.reps else None
        offsets, _, slot_valid = native.levels_to_rows(defs, reps, count, col.list_def,
                                                       col.max_def)
        if len(slot_valid) != len(values) + int(np.count_nonzero(~slot_valid)):
            raise ValueError(f"parquet: column {col.name!r}: levels and values disagree")
        values = _with_nulls(values, slot_valid)
        if not col.is_list:
            if len(values) != n_rows:
                raise ValueError(f"parquet: column {col.name!r} has {len(values)} rows, its "
                                 f"row group {n_rows}")
            return {col.name: values}
        if len(offsets) - 1 != n_rows:
            raise ValueError(f"parquet: column {col.name!r} has {len(offsets) - 1} rows, its "
                             f"row group {n_rows}")
        return {col.name + VALUES: values, col.name + OFFSETS: offsets}


def _concat(parts: List[np.ndarray], col: Column) -> np.ndarray:
    if not parts:
        return np.empty(0, dtype=object if col.dtype is None else col.dtype)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _with_nulls(values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Non-null values spread over their slots, the nulls as pyarrow's
    ``to_numpy`` gives them."""
    if valid.all():
        return values
    if values.dtype.kind in "iuf":
        dtype = values.dtype if values.dtype.kind == "f" else np.dtype(np.float64)
        out = np.full(len(valid), np.nan, dtype)
    else:
        out = np.full(len(valid), None, dtype=object)
    out[valid] = values
    return out


class ParquetFile:
    """A parquet file's footer: ``num_rows``, ``num_row_groups``,
    ``row_group_rows(g)``, ``columns`` and ``column_names``; the data is read
    a row group at a time (:meth:`read_row_group`) or whole (:meth:`read`)."""

    def __init__(self, path: str):
        self.path = str(path)
        with open(self.path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < 12:
                raise ValueError(f"{self.path} is not a parquet file (too short)")
            f.seek(size - 8)
            tail = f.read(8)
            if tail[4:] != MAGIC:
                raise ValueError(f"{self.path} is not a parquet file (no PAR1 at its end)")
            n = struct.unpack("<I", tail[:4])[0]
            f.seek(size - 8 - n)
            self.meta = ThriftReader(f.read(n)).struct()
        self.num_rows = int(self.meta[3])
        self.row_groups = self.meta.get(4, [])
        self.num_row_groups = len(self.row_groups)
        self.columns = _columns(self.meta[2])
        self.column_names = [c.name for c in self.columns]

    def row_group_rows(self, g: int) -> int:
        return int(self.row_groups[g][3])

    def read_row_group(self, g: int, columns: Optional[Iterable[str]] = None
                       ) -> Dict[str, np.ndarray]:
        """Row group ``g`` as a table (``columns``: these, in file order)."""
        rg = self.row_groups[g]
        want = None if columns is None else set(columns)
        out: Dict[str, np.ndarray] = {}
        with open(self.path, "rb") as f:
            for col, chunk in zip(self.columns, rg[1]):
                if want is not None and col.name not in want:
                    continue
                meta = chunk[3]
                start = meta.get(11) if meta.get(11, 0) > 0 else meta[9]
                f.seek(start)
                buf = np.frombuffer(f.read(meta[7]), np.uint8)
                out.update(_Chunk(col, meta, buf).columns(int(rg[3])))
        return out

    def read(self, columns: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
        parts = [self.read_row_group(g, columns) for g in range(self.num_row_groups)]
        if not parts:
            return {}
        return concat_tables(parts)


def concat_tables(parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Tables of the same columns, one after the other (list offsets
    shifted)."""
    if len(parts) == 1:
        return parts[0]
    out = {}
    for name in parts[0]:
        if name.endswith(OFFSETS):
            shifted, base = [parts[0][name]], parts[0][name][-1]
            for p in parts[1:]:
                shifted.append(p[name][1:] - p[name][0] + base)
                base = shifted[-1][-1] if len(shifted[-1]) else base
            out[name] = np.concatenate(shifted)
        else:
            out[name] = np.concatenate([p[name] for p in parts])
    return out


def read_table(path: str, columns: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    return ParquetFile(path).read(columns)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

_INT_LOGICAL = {np.dtype(np.int8): (8, True), np.dtype(np.int16): (16, True),
                np.dtype(np.uint8): (8, False), np.dtype(np.uint16): (16, False),
                np.dtype(np.uint32): (32, False), np.dtype(np.uint64): (64, False)}
_INT_CONVERTED = {np.dtype(np.int8): 15, np.dtype(np.int16): 16, np.dtype(np.uint8): 11,
                  np.dtype(np.uint16): 12, np.dtype(np.uint32): 13, np.dtype(np.uint64): 14}


class _Leaf:
    """A column to write: its name, values (non-null), per-row lengths for
    a list, validity for a nullable flat column, and its parquet type."""

    def __init__(self, name: str, values, offsets: Optional[np.ndarray]):
        self.name, self.offsets = name, offsets
        values = np.asarray(values)
        self.valid: Optional[np.ndarray] = None
        self.string = None
        if values.dtype.kind in "US" or values.dtype == object:
            flat = values.tolist()
            valid = np.fromiter((v is not None for v in flat), bool, len(flat))
            kinds = {type(v) for v, ok in zip(flat, valid) if ok}
            if not kinds <= {str} and not kinds <= {bytes}:
                raise TypeError(f"parquet: column {name!r} holds {sorted(k.__name__ for k in kinds)}; "
                                "the port writes numbers, booleans, strings and bytes")
            self.string = kinds != {bytes}
            if not valid.all():
                if offsets is not None:
                    raise TypeError(f"parquet: list column {name!r} has null elements; the "
                                    "port writes them only in flat columns")
                self.valid = valid
                flat = [v for v, ok in zip(flat, valid) if ok]
            self.physical, self.dtype = BYTE_ARRAY, None
            self.values = flat
            return
        if values.dtype == bool:
            self.physical = BOOLEAN
        elif values.dtype.kind in "iu":
            self.physical = INT64 if values.dtype.itemsize == 8 else INT32
        elif values.dtype in (np.float32, np.float64):
            self.physical = FLOAT if values.dtype == np.float32 else DOUBLE
        else:
            raise TypeError(f"parquet: column {name!r} has dtype {values.dtype}, which the "
                            "port does not write")
        self.dtype = values.dtype
        self.values = values

    def schema(self) -> List[list]:
        leaf = [(1, "i32", self.physical), (3, "i32", OPTIONAL)]
        converted = logical = None
        if self.physical == BYTE_ARRAY and self.string:
            converted, logical = CT_UTF8, [(1, "struct", [])]
        elif self.dtype in _INT_LOGICAL:
            bits, signed = _INT_LOGICAL[self.dtype]
            converted = _INT_CONVERTED[self.dtype]
            logical = [(10, "struct", [(1, "i8", bits), (2, "bool", signed)])]
        if self.offsets is None:
            return [leaf + [(4, "binary", self.name), (6, "i32", converted),
                            (10, "struct", logical)]]
        return [
            [(3, "i32", OPTIONAL), (4, "binary", self.name), (5, "i32", 1),
             (6, "i32", CT_LIST), (10, "struct", [(3, "struct", [])])],
            [(3, "i32", REPEATED), (4, "binary", "list"), (5, "i32", 1)],
            leaf + [(4, "binary", "element"), (6, "i32", converted), (10, "struct", logical)],
        ]

    def page(self, lo: int, hi: int) -> Tuple[bytes, int]:
        """Rows [lo, hi) as one uncompressed v1 data page body, and its
        level count."""
        body = bytearray()
        if self.offsets is None:
            rows = hi - lo
            valid = None if self.valid is None else self.valid[lo:hi]
            defs = np.ones(rows, np.int32) if valid is None else valid.astype(np.int32)
            level = native.rle_encode(defs, 1)
            body += struct.pack("<I", len(level)) + level
            if valid is None:
                body += self._plain(lo, hi)
            else:
                before = int(np.count_nonzero(self.valid[:lo]))
                body += self._plain(before, before + int(np.count_nonzero(valid)))
            return bytes(body), rows
        offs = self.offsets[lo:hi + 1]
        lengths = np.diff(offs)
        n_levels = int(np.maximum(lengths, 1).sum())
        starts = np.zeros(len(lengths), np.int64)
        np.cumsum(np.maximum(lengths, 1)[:-1], out=starts[1:])
        reps = np.ones(n_levels, np.int32)
        reps[starts] = 0
        defs = np.full(n_levels, 3, np.int32)
        defs[starts[lengths == 0]] = 1
        for levels, width in ((reps, 1), (defs, 2)):
            enc = native.rle_encode(levels, width)
            body += struct.pack("<I", len(enc)) + enc
        body += self._plain(int(offs[0]), int(offs[-1]))
        return bytes(body), n_levels

    def _plain(self, a: int, b: int) -> bytes:
        if self.physical == BYTE_ARRAY:
            return _pack_strings(self.values[a:b], self.string)
        vals = self.values[a:b]
        if self.physical == BOOLEAN:
            return np.packbits(vals, bitorder="little").tobytes()
        return np.ascontiguousarray(vals, dtype=_PHYSICAL[self.physical]).tobytes()


def _pack_strings(values: list, as_str: bool) -> bytes:
    """str (or bytes) values as PLAIN ``BYTE_ARRAY``."""
    if not values:
        return b""
    sep = "\0" if as_str else b"\0"
    joined = sep.join(values)
    raw = joined.encode() if as_str else joined
    data = np.frombuffer(raw, np.uint8)
    cuts = np.flatnonzero(data == 0)
    if len(cuts) == len(values) - 1:  # no value holds a NUL: the cuts are the separators
        offsets = np.concatenate([[0], cuts - np.arange(len(cuts)), [len(data) - len(cuts)]])
        data = np.delete(data, cuts)
    else:
        parts = [v.encode() if as_str else v for v in values]
        data = np.frombuffer(b"".join(parts), np.uint8)
        offsets = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    return native.byte_array_pack(data, offsets.astype(np.int64))


def _leaves(table: Dict[str, np.ndarray], names: Sequence[str]) -> List[_Leaf]:
    leaves = []
    for name in names:
        if name + OFFSETS in table:
            leaves.append(_Leaf(name, table[name + VALUES],
                                np.asarray(table[name + OFFSETS], np.int64)))
            continue
        col = np.asarray(table[name]) if not isinstance(table[name], np.ndarray) else table[name]
        if col.ndim == 2:  # a fixed-length list, as the JAX package writes a 2-D column
            k = col.shape[1]
            leaves.append(_Leaf(name, col.reshape(-1), np.arange(len(col) + 1, dtype=np.int64) * k))
        elif col.ndim == 1:
            leaves.append(_Leaf(name, col, None))
        else:
            raise TypeError(f"parquet: column {name!r} has {col.ndim} dimensions")
    return leaves


def table_names(table: Dict[str, np.ndarray]) -> List[str]:
    """The column names of a table, a list column once."""
    names = []
    for n in table:
        if n.endswith(VALUES) and n[: -len(VALUES)] + OFFSETS in table:
            continue
        names.append(n[: -len(OFFSETS)] if n.endswith(OFFSETS) else n)
    return names


def table_rows(table: Dict[str, np.ndarray]) -> int:
    for name, col in table.items():
        if name.endswith(OFFSETS):
            return len(col) - 1
        if not name.endswith(VALUES):
            return len(col)
    return 0


def write_table(table: Dict[str, np.ndarray], path: str,
                row_group_size: Optional[int] = None) -> str:
    """Write a table (the module's layout) to ``path`` as one parquet file
    (the module's note says how)."""
    names = table_names(table)
    leaves = _leaves(table, names)
    n = table_rows(table)
    group = int(row_group_size or DEFAULT_ROW_GROUP_SIZE)
    schema = [[(4, "binary", "schema"), (5, "i32", len(leaves))]]
    for leaf in leaves:
        schema += leaf.schema()
    row_groups = []
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        for ordinal, lo in enumerate(range(0, max(n, 1), group)):
            hi = min(lo + group, n)
            chunks, total, total_c, first = [], 0, 0, f.tell()
            for leaf in leaves:
                body, n_levels = leaf.page(lo, hi)
                comp = native.snappy_compress(body)
                header = ThriftWriter().struct([
                    (1, "i32", DATA_PAGE), (2, "i32", len(body)), (3, "i32", len(comp)),
                    (5, "struct", [(1, "i32", n_levels), (2, "i32", PLAIN), (3, "i32", RLE),
                                   (4, "i32", RLE)])]).out
                offset = f.tell()
                f.write(header)
                f.write(comp)
                usize, csize = len(header) + len(body), len(header) + len(comp)
                total += usize
                total_c += csize
                path_in_schema = [leaf.name] if leaf.offsets is None else [
                    leaf.name, "list", "element"]
                chunks.append([(2, "i64", offset), (3, "struct", [
                    (1, "i32", leaf.physical), (2, ("list", "i32"), [PLAIN, RLE]),
                    (3, ("list", "binary"), path_in_schema), (4, "i32", 1),
                    (5, "i64", n_levels), (6, "i64", usize), (7, "i64", csize),
                    (9, "i64", offset)])])
            row_groups.append([(1, ("list", "struct"), chunks), (2, "i64", total),
                               (3, "i64", hi - lo), (5, "i64", first), (6, "i64", total_c),
                               (7, "i16", ordinal)])
        footer = ThriftWriter().struct([
            (1, "i32", 2), (2, ("list", "struct"), schema), (3, "i64", n),
            (4, ("list", "struct"), row_groups), (6, "binary", "models_tpu_torch parquet")]).out
        f.write(footer)
        f.write(struct.pack("<I", len(footer)))
        f.write(MAGIC)
    os.replace(tmp, path)
    return path
