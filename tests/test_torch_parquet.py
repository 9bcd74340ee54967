"""The port's parquet codec (``models_tpu_torch/data/parquet.py`` and the C++
loops of ``csrc/host/parquet_codec.cc`` / ``fastbatch.cc``) against pyarrow
and the JAX package, on the CPU.

- The port reads what the JAX package's ``Dataset.to_parquet`` writes for each
  of the twenty synthetic schemas (two partitions, row groups of 50 rows),
  bit-equal to JAX's ``to_numpy_dict`` of the same files (values and dtypes;
  strings hashed by both), schema and column names included.
- It reads ``pq.write_table``'s output under each compression (none, snappy,
  gzip), with and without dictionaries, data pages v1 and v2 and small row
  groups, for a table of every type it reads (nulls in flat and list columns,
  strings, bytes, booleans, narrow and unsigned integers), equal to JAX's
  ``table_to_numpy`` of pyarrow's read; ZSTD and LZ4 raise naming the codec.
- pyarrow and the JAX package read the port's files back to the same table.
- Each C++ entry point equals its plain Python / numpy version on seeded
  inputs.

Sizes: 120 rows a schema, 2,000 rows for the typed table.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import models_tpu as mm
from models_tpu.data.dataset import table_to_numpy as jax_table_to_numpy
from models_tpu.data.synthetic import KNOWN_DATASETS as JAX_KNOWN

import models_tpu_torch as mt
from models_tpu_torch.data import native, parquet


def assert_same_columns(got, want, what=""):
    """Columns equal in name, dtype and value (NaN equal to NaN, None to
    None)."""
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        assert g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")  # NaNs equal
        elif w.dtype == object:
            assert g.tolist() == w.tolist(), (what, k)
        else:
            assert np.array_equal(g, w), (what, k)


# ---- the JAX package's files ------------------------------------------------

@pytest.mark.parametrize("name", sorted(JAX_KNOWN))
def test_reads_what_the_jax_package_writes(tmp_path, name):
    jds = mm.data.generate_data(name, num_rows=120, seed=7)
    path = jds.to_parquet(str(tmp_path / "p"), row_group_size=50, num_partitions=2)
    want = mm.data.Dataset.from_parquet(path)
    got = mt.Dataset(path)
    assert got.files == want._files and len(got.files) == 2
    assert got.num_rows == want.num_rows == 120
    assert got.column_names == list(want.column_names)
    assert got.schema.to_dict() == want.schema.to_dict()
    assert_same_columns(got.to_numpy_dict(), want.to_numpy_dict(), name)


def typed_table(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "i32": pa.array(rng.integers(0, 50, n), pa.int32()),
        "i64": pa.array(rng.integers(-2**40, 2**40, n), pa.int64()),
        "i_null": pa.array([None if k % 7 == 0 else int(k) for k in range(n)], pa.int32()),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "f_null": pa.array([None if k % 5 == 0 else float(k) for k in range(n)], pa.float32()),
        "f64": pa.array(rng.standard_normal(n)),
        "flag": pa.array(rng.integers(0, 2, n).astype(bool)),
        "flag_null": pa.array([None if k % 3 == 0 else bool(k % 2) for k in range(n)]),
        "text": pa.array([f"s{k % 37}é" for k in range(n)]),
        "text_null": pa.array([None if k % 11 == 0 else f"x{k}" for k in range(n)]),
        "blob": pa.array([bytes([k % 256, 0, 1]) for k in range(n)], pa.binary()),
        "i8": pa.array(rng.integers(-100, 100, n), pa.int8()),
        "u16": pa.array(rng.integers(0, 60000, n), pa.uint16()),
        "u32": pa.array(rng.integers(0, 2**32 - 1, n), pa.uint32()),
        "ids": pa.array([list(range(k % 5)) if k % 13 else None for k in range(n)],
                        pa.list_(pa.int64())),
        "scores": pa.array([[None, 1.5] if k % 4 == 0 else [2.0] * (k % 3) for k in range(n)],
                           pa.list_(pa.float64())),
        "tags": pa.array([[f"a{k % 3}", "b"] if k % 2 else [] for k in range(n)],
                         pa.list_(pa.string())),
        "i32_list": pa.array([[k, k + 1] for k in range(n)], pa.list_(pa.int32())),
    })


@pytest.mark.parametrize("compression", ["NONE", "SNAPPY", "GZIP"])
@pytest.mark.parametrize("use_dictionary", [True, False])
@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_reads_pyarrows_options(tmp_path, compression, use_dictionary, version):
    table = typed_table()
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path, compression=compression, use_dictionary=use_dictionary,
                   data_page_version=version, row_group_size=700)
    f = parquet.ParquetFile(path)
    assert (f.num_rows, f.num_row_groups, f.column_names) == (2000, 3, table.column_names)
    assert_same_columns(mt.Dataset(path).to_numpy_dict(),
                        jax_table_to_numpy(pq.read_table(path)), "whole")
    for g in range(3):  # the loader's unit, one row group
        assert_same_columns(mt.data.dataset.table_to_numpy(f.read_row_group(g)),
                            jax_table_to_numpy(pq.ParquetFile(path).read_row_group(g)),
                            f"row group {g}")


@pytest.mark.parametrize("codec", ["ZSTD", "LZ4", "BROTLI"])
def test_other_codecs_raise_naming_the_codec(tmp_path, codec):
    path = str(tmp_path / "z.parquet")
    pq.write_table(typed_table(50), path, compression=codec)
    f = parquet.ParquetFile(path)  # the footer is not compressed
    assert f.num_rows == 50
    name = "LZ4_RAW" if codec == "LZ4" else codec
    with pytest.raises(NotImplementedError, match=name):
        f.read()


def test_other_encodings_and_nesting_raise_naming_them(tmp_path):
    path = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"x": pa.array(np.arange(100))}), path, use_dictionary=False,
                   column_encoding={"x": "DELTA_BINARY_PACKED"})
    with pytest.raises(NotImplementedError, match="DELTA_BINARY_PACKED"):
        parquet.read_table(path)
    pq.write_table(pa.table({"s": pa.array([{"a": 1}, {"a": 2}])}), path)
    with pytest.raises(NotImplementedError, match="struct"):
        parquet.ParquetFile(path)
    pq.write_table(pa.table({"t": pa.array(np.arange(3).astype("datetime64[ms]"))}), path)
    with pytest.raises(NotImplementedError, match="TIMESTAMP"):
        parquet.ParquetFile(path)


def test_a_truncated_file_raises(tmp_path):
    path = tmp_path / "t.parquet"
    pq.write_table(typed_table(100), str(path))
    raw = path.read_bytes()
    path.write_bytes(raw[:len(raw) // 2])
    with pytest.raises(ValueError, match="not a parquet file"):
        parquet.ParquetFile(str(path))


# ---- the port's files, read by pyarrow and by the JAX package ---------------

@pytest.mark.parametrize("name", sorted(JAX_KNOWN))
def test_jax_and_pyarrow_read_the_ports_files(tmp_path, name):
    tds = mt.generate_data(name, num_rows=120, seed=7)
    path = tds.to_parquet(str(tmp_path / "p"), row_group_size=50, num_partitions=2)
    jds = mm.data.Dataset.from_parquet(path)  # the schema.json sidecar
    assert jds.schema.to_dict() == tds.schema.to_dict()
    assert_same_columns(jds.to_numpy_dict(), tds.to_numpy_dict(), name)
    back = mt.Dataset(path)
    assert back.column_names == tds.column_names
    assert_same_columns(back.to_numpy_dict(), tds.to_numpy_dict(), f"{name}, port")
    # pyarrow reads a file to the table the JAX package builds from its rows
    table = pq.read_table(f"{path}/part_0.parquet")
    want = mm.data.dataset._dict_to_table(tds.take(60).columns())
    assert table.num_rows == 60
    assert table.cast(want.schema).equals(want), name


def test_pyarrow_reads_every_type_the_port_writes(tmp_path):
    """Nulls in a string column, narrow and unsigned integers, booleans,
    bytes, a 2-D column (a fixed-length list), an empty list, row groups of
    7 rows, and a table of no rows."""
    n = 40
    rng = np.random.default_rng(3)
    cols = {
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "u16": rng.integers(0, 60000, n).astype(np.uint16),
        "u32": rng.integers(0, 2**32 - 1, n).astype(np.uint32),
        "u64": rng.integers(0, 2**63, n).astype(np.uint64),
        "flag": rng.integers(0, 2, n).astype(bool),
        "text": np.array([None if k % 6 == 0 else f"té{k}" for k in range(n)], object),
        "blob": np.array([bytes([k, 0, k]) for k in range(n)], object),
        "emb": rng.standard_normal((n, 3)).astype(np.float32),
        "seq__values": np.arange(50, dtype=np.int64),
        "seq__offsets": np.concatenate([[0, 0], np.linspace(0, 50, n).astype(np.int64)[1:]]),
    }
    path = str(tmp_path / "w.parquet")
    parquet.write_table(cols, path, row_group_size=7)
    table = pq.read_table(path)
    assert pq.ParquetFile(path).metadata.num_row_groups == 6
    assert pq.ParquetFile(path).metadata.row_group(0).column(0).compression == "SNAPPY"
    want = pa.table({
        "i8": pa.array(cols["i8"]), "u16": pa.array(cols["u16"]), "u32": pa.array(cols["u32"]),
        "u64": pa.array(cols["u64"]), "flag": pa.array(cols["flag"]),
        "text": pa.array(cols["text"].tolist(), pa.string()),
        "blob": pa.array(cols["blob"].tolist(), pa.binary()),
        "emb": pa.array([r.tolist() for r in cols["emb"]], pa.list_(pa.float32())),
        "seq": pa.ListArray.from_arrays(pa.array(cols["seq__offsets"].astype(np.int32)),
                                        pa.array(cols["seq__values"])),
    })
    assert table.equals(want)
    got = parquet.read_table(path)
    assert_same_columns({k: v for k, v in got.items() if not k.startswith("emb")},
                        {k: v for k, v in cols.items() if k != "emb"})
    np.testing.assert_array_equal(got["emb__values"], cols["emb"].reshape(-1))
    parquet.write_table({k: v[:0] for k, v in cols.items() if "seq" not in k}, path)
    assert pq.read_table(path).num_rows == 0 == parquet.ParquetFile(path).num_rows


def test_snappy_finds_matches_and_pyarrow_reads_it():
    data = (b"the port writes parquet " * 4000) + np.arange(20000, dtype=np.int32).tobytes()
    packed = native.snappy_compress(data)
    codec = pa.Codec("snappy")
    # the text compresses to almost nothing, the counting integers hardly:
    # within 1% of the snappy library's own size
    assert len(packed) < len(data) // 2
    assert len(packed) <= 1.01 * len(codec.compress(data))
    assert bytes(codec.decompress(packed, decompressed_size=len(data))) == data
    assert bytes(native.snappy_decompress(bytes(codec.compress(data)))) == data
    with pytest.raises(ValueError, match="malformed snappy"):
        native.snappy_decompress(packed[:len(packed) // 2])


# ---- the C++ loops against their plain versions -----------------------------

def _inputs(seed):
    rng = np.random.default_rng(seed)
    bw = int(rng.integers(1, 21))
    vals = rng.integers(0, 1 << bw, 3000)
    vals[500:900] = vals[500]  # a long run
    vals[1200:1207] = vals[1200]  # a run too short for RLE
    return rng, bw, vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snappy_cpp_matches_plain(seed):
    rng = np.random.default_rng(seed)
    for data in (b"", b"x", rng.integers(0, 4, 70_000).astype(np.uint8).tobytes(),
                 rng.integers(0, 256, 5_000).astype(np.uint8).tobytes(),
                 b"abcabcabd" * 9000):
        packed = native.snappy_compress(data)
        assert packed == native.plain_snappy_compress(data)
        assert bytes(native.snappy_decompress(packed)) == data
        assert native.plain_snappy_decompress(packed) == data


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_hybrid_cpp_matches_plain(seed):
    _, bw, vals = _inputs(seed)
    for width, v in ((bw, vals), (0, np.zeros(17, np.int64)), (32, vals.astype(np.int64) << 11),
                     (1, vals[:9] % 2)):
        enc = native.rle_encode(v, width)
        assert enc == native.plain_rle_encode(v, width)
        got, used = native.rle_decode(enc, width, len(v))
        want, wused = native.plain_rle_decode(enc, width, len(v))
        assert used == wused == len(enc)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, v.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_levels_to_rows_cpp_matches_plain(seed):
    rng = np.random.default_rng(seed)
    n = 500
    defs = rng.integers(0, 4, n).astype(np.int32)  # a 3-level list: null row, empty, null, value
    reps = (rng.random(n) < 0.6).astype(np.int32)
    reps[0] = 0
    reps[defs < 2] = 0  # a null or empty row has one level
    for d, r, list_def, max_def in ((defs, reps, 1, 3), (defs % 2, None, 0, 1),
                                    (None, reps, 0, 1)):
        count = n
        got = native.levels_to_rows(d, r, count, list_def, max_def)
        want = native.plain_levels_to_rows(d, r, count, list_def, max_def)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_dictionary_and_byte_arrays_cpp_match_plain(seed):
    rng = np.random.default_rng(seed)
    for dictionary in (rng.standard_normal(40), rng.integers(0, 9, 40).astype(np.int32)):
        idx = rng.integers(0, 40, 1000)
        np.testing.assert_array_equal(native.dict_gather(dictionary, idx),
                                      native.plain_dict_gather(dictionary, idx))
    with pytest.raises(ValueError, match="dictionary index"):
        native.dict_gather(np.arange(4.0), np.array([0, 4]))
    words = [bytes(rng.integers(0, 256, int(k)).astype(np.uint8)) for k in
             rng.integers(0, 12, 300)]
    data = np.frombuffer(b"".join(words), np.uint8)
    offsets = np.concatenate([[0], np.cumsum([len(w) for w in words])]).astype(np.int64)
    packed = native.byte_array_pack(data, offsets)
    assert packed == native.plain_byte_array_pack(data, offsets)
    for got, want in zip(native.byte_array_unpack(packed, len(words)),
                         native.plain_byte_array_unpack(packed, len(words))):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="BYTE_ARRAY"):
        native.byte_array_unpack(packed[:-1], len(words))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64, np.float64, np.uint32])
def test_native_batcher_matches_plain(dtype):
    rng = np.random.default_rng(4)
    lengths = rng.integers(0, 9, 300)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    values = (rng.standard_normal(int(offsets[-1])) * 100).astype(dtype)
    for L in (1, 6, 12):
        got, mask = native.pad_ragged(values, offsets, L)
        want, wmask = native.plain_pad_ragged(values, offsets, L)
        assert got.dtype == values.dtype and mask.dtype == bool
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(mask, wmask)
    wide = rng.standard_normal((int(offsets[-1]), 3)).astype(np.float32)  # vector elements
    np.testing.assert_array_equal(native.pad_ragged(wide, offsets, 5)[0],
                                  native.plain_pad_ragged(wide, offsets, 5)[0])
    if np.dtype(dtype).itemsize == 4:
        src = values.reshape(-1, 1)[: 200]
        idx = rng.integers(0, 200, 77)
        np.testing.assert_array_equal(native.gather_rows(src, idx),
                                      native.plain_gather_rows(src, idx))
    with pytest.raises(TypeError):
        native.pad_ragged(values.astype(np.int16), offsets, 4)
    with pytest.raises(ValueError, match="offsets"):
        native.pad_ragged(values, offsets[::-1].copy(), 4)
