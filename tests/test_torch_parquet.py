"""The port's Parquet codec and snappy decompressor against pandas and
pyarrow, and the feature shards both packages write.

``pd.read_parquet`` of a shard the port writes equals, exactly, the
DataFrame the JAX package's ``_feature_table`` builds for the same rows
(NaN features, the string ``plate`` column and the column order
included); the port reads what ``DataFrame.to_parquet`` writes with its
defaults and with small page limits (several pages, a dictionary with
its plain fallback, nulls, several row groups); both packages' harvests
count the same sites; snappy decodes pyarrow's buffers and hand-built
streams whose copies overlap their own output.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.workflow import schedule as j_schedule
from tmlibrary_tpu.workflow.steps.jterator import ImageAnalysisRunner as JRunner
from tmlibrary_tpu_torch.io import parquet, snappy
from tmlibrary_tpu_torch.models.experiment import grid_experiment
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow import schedule
from tmlibrary_tpu_torch.workflow.steps.jterator import feature_table

M = 8


def site_meta(sites):
    return [{"site_index": s, "plate": f"plate{s % 2:02d}", "well_row": s // 4,
             "well_col": s % 4, "site_y": (s // 2) % 2, "site_x": s % 2} for s in sites]


def batch(seed, n_sites=6, nan_share=0.1):
    """Counts, features and site metadata of one batch, some of them NaN."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, M + 3, n_sites)
    counts[0] = 0
    feats = {"Morphology_area": rng.integers(1, 90, (n_sites, M)).astype(np.float32),
             "Intensity_mean_DAPI": rng.normal(size=(n_sites, M)).astype(np.float32),
             "Texture_contrast_DAPI_1": rng.normal(size=(n_sites, M)).astype(np.float32)}
    holes = rng.random((n_sites, M)) < nan_share
    feats["Intensity_mean_DAPI"][holes] = np.nan
    feats["Texture_contrast_DAPI_1"][:, 0] = np.nan
    sites = sorted(rng.choice(16, n_sites, replace=False).tolist())
    return counts, feats, site_meta(sites)


# ----------------------------------------------------- port -> pandas
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_port_shards_read_in_pandas_as_the_reference_table(tmp_path, seed):
    counts, feats, meta = batch(seed)
    want = JRunner._feature_table("nuclei", counts, feats, meta, M)
    path = parquet.write_table(tmp_path / "batch_000.parquet",
                               feature_table(counts, feats, meta, M))
    got = pd.read_parquet(path)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert list(got.columns) == list(want.columns)
    assert str(got["plate"].dtype) == str(want["plate"].dtype)
    assert got["Texture_contrast_DAPI_1"].isna().sum() == (np.minimum(counts, M) > 0).sum()
    # pyarrow's schema: flat OPTIONAL columns, the string one UTF8
    schema = pq.ParquetFile(path).schema_arrow
    assert schema.field("plate").type == pa.string()
    assert schema.field("site_index").type == pa.int64()


def test_port_store_shards_read_in_the_reference_store(tmp_path):
    exp = grid_experiment("pq", well_rows=2, well_cols=2, sites_per_well=(2, 2),
                          channel_names=("DAPI",), site_shape=(8, 8))
    st = ExperimentStore.create(tmp_path / "s", exp)
    frames = []
    for i, seed in enumerate((5, 6, 7)):
        counts, feats, meta = batch(seed)
        st.append_features("cells", feature_table(counts, feats, meta, M), f"batch_{i:03d}")
        frames.append(JRunner._feature_table("cells", counts, feats, meta, M))
    pd.testing.assert_frame_equal(JStore.open(st.root).read_features("cells"),
                                  pd.concat(frames, ignore_index=True))
    got = st.read_features("cells")
    want = pd.concat(frames, ignore_index=True)
    assert list(got) == list(want.columns)
    for k in got:
        if k == "plate":
            assert got[k].tolist() == want[k].tolist()
        else:
            np.testing.assert_array_equal(got[k], want[k].to_numpy(), err_msg=k)


def test_an_empty_shard_round_trips(tmp_path):
    cols = feature_table(np.zeros(3, np.int32), {"f": np.zeros((3, M), np.float32)},
                         site_meta([0, 1, 2]), M)
    path = parquet.write_table(tmp_path / "e.parquet", cols)
    back = parquet.read_table(path)
    assert list(back) == list(cols)
    assert all(len(v) == 0 for v in back.values())
    assert back["f"].dtype == np.float64 and back["label"].dtype == np.int64
    assert len(pd.read_parquet(path)) == 0


# ----------------------------------------------------- pandas -> port
def column_pages(path, name: str) -> list[tuple[str, str]]:
    """``(page type, encoding)`` of every page of column ``name``, in file
    order, walked with the codec's Thrift decoder."""
    data = path.read_bytes()
    meta = parquet.read_metadata(data)
    index = [leaf[0] for leaf in parquet._leaves(meta)].index(name)
    out = []
    for rg in meta[4]:
        cm = rg[1][index][3]
        pos, seen = cm.get(11, cm[9]), 0
        while seen < cm[5]:
            rd = parquet._ThriftReader(data, pos)
            header = rd.struct()
            pos = rd.pos + header[3]
            if header[1] == parquet.DICTIONARY_PAGE:
                enc = header[7].get(2, parquet.PLAIN)
            else:
                enc = header[5][2]
                seen += header[5][1]
            out.append((parquet.PAGE_NAMES[header[1]], parquet.ENCODING_NAMES[enc]))
    return out


REFERENCE_WRITES = {
    "defaults": {},
    "small_pages": {"data_page_size": 256},
    "dictionary_fallback": {"data_page_size": 512, "dictionary_pagesize_limit": 256},
    "plain": {"use_dictionary": False},
    "uncompressed": {"compression": None, "data_page_size": 300},
    "row_groups": {"row_group_size": 700, "data_page_size": 1024},
    "statistics_off": {"write_statistics": False},
}


def wide_frame(n=2500, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "site_index": rng.integers(0, 400, n),
        "plate": [f"plate{i % 3:02d}" for i in range(n)],
        "label": np.arange(n) % 97 + 1,
        "name": [f"object-{i}-{rng.integers(1 << 30)}" for i in range(n)],
        "Intensity_mean_DAPI": rng.normal(size=n),
        "Morphology_area": rng.integers(1, 50, n).astype(np.float64),
    })
    df.loc[rng.random(n) < 0.05, "Intensity_mean_DAPI"] = np.nan
    df.loc[:10, "Morphology_area"] = np.nan
    return df


@pytest.mark.parametrize("case", sorted(REFERENCE_WRITES))
def test_the_port_reads_what_pandas_writes(tmp_path, case):
    df = wide_frame()
    path = tmp_path / "r.parquet"
    df.to_parquet(path, index=False, **REFERENCE_WRITES[case])
    got = parquet.read_table(path)
    assert list(got) == list(df.columns)
    for k in df.columns:
        if k in ("plate", "name"):
            assert got[k].tolist() == df[k].tolist(), k
        else:
            np.testing.assert_array_equal(got[k], df[k].to_numpy(), err_msg=k)
    assert got["site_index"].dtype == np.int64 and got["Morphology_area"].dtype == np.float64
    pages = column_pages(path, "name")
    if case == "dictionary_fallback":
        assert pages[0] == ("DICTIONARY_PAGE", "PLAIN")
        assert ("DATA_PAGE", "RLE_DICTIONARY") in pages and ("DATA_PAGE", "PLAIN") in pages
    if case in ("small_pages", "uncompressed"):
        assert sum(p[0] == "DATA_PAGE" for p in pages) > 2
    if case == "row_groups":
        assert pq.ParquetFile(path).metadata.num_row_groups == 4
    only = parquet.read_table(path, columns=["site_index"])
    assert list(only) == ["site_index"]


def test_what_the_port_cannot_read_raises_naming_it(tmp_path):
    df = wide_frame(200)
    cases = {
        "ZSTD": {"compression": "zstd"},
        "DATA_PAGE_V2": {"data_page_version": "2.0"},
        "DELTA_BINARY_PACKED": {"use_dictionary": False,
                                "column_encoding": {"site_index": "DELTA_BINARY_PACKED"}},
    }
    for name, kw in cases.items():
        path = tmp_path / f"{name}.parquet"
        df.to_parquet(path, index=False, **kw)
        with pytest.raises(parquet.ParquetError, match=name):
            parquet.read_table(path)
    # LIST columns are read (test_list_columns_*); other nested shapes raise
    for name, table in {"struct": pa.table({"a": [{"x": 1}, {"x": 2}]}),
                        "list of lists": pa.table({"a": [[[1, 2]], [[3]]]}),
                        "list of strings": pa.table({"a": [["x"], ["y", "z"]]})}.items():
        nested = tmp_path / "nested.parquet"
        pq.write_table(table, nested)
        with pytest.raises(parquet.ParquetError, match="nested group|LIST|BYTE_ARRAY"):
            parquet.read_table(nested)
    (tmp_path / "junk.parquet").write_bytes(b"not parquet")
    with pytest.raises(parquet.ParquetError, match="PAR1"):
        parquet.read_table(tmp_path / "junk.parquet")
    with pytest.raises(parquet.ParquetError):
        parquet.write_table(tmp_path / "x.parquet", {"a": np.zeros(2), "b": np.zeros(3)})
    for cells in ([[[1, 2], [3, 4]]], [["x", "y"]]):  # nested and string list cells
        with pytest.raises(parquet.ParquetError, match="list"):
            parquet.write_table(tmp_path / "x.parquet", {"a": parquet.list_column(cells)})


# ------------------------------------------------------------- LIST columns
LIST_ROWS = {
    "ints": [[0, 5, 5, 0, 0], [], [1, 2, 3], [7], None, [-(2**40), 2**40]],
    "floats": [[1.5, float("nan")], None, [], [0.25] * 20, [-3.0]],
    "all empty": [[], [], []],
    "one row": [[9, 8, 7, 6, 5, 4, 3, 2, 1]],
}


def assert_same_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            w = np.asarray(w, dtype=np.asarray(g).dtype if len(w) == 0 else None)
            assert np.asarray(g).dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", sorted(LIST_ROWS))
def test_list_columns_written_by_the_port_read_in_pyarrow(tmp_path, case):
    rows = LIST_ROWS[case]
    path = tmp_path / "l.parquet"
    parquet.write_table(path, {"name": np.asarray([f"r{i}" for i in range(len(rows))]),
                               "v": parquet.list_column(rows),
                               "x": np.arange(len(rows), dtype=np.float64)})
    table = pq.read_table(path)
    assert str(table.schema.field("v").type).startswith("list<element: ")
    assert table.column("v").to_pylist() == [
        None if r is None else [None if isinstance(v, float) and np.isnan(v) else v
                                for v in r] for r in rows]
    df = pd.read_parquet(path)
    assert list(df.columns) == ["name", "v", "x"]
    assert_same_lists(df["v"].tolist(), rows)
    assert_same_lists(parquet.read_table(path)["v"], rows)


@pytest.mark.parametrize("case", sorted(LIST_ROWS))
@pytest.mark.parametrize("element", ["element", "item"])
@pytest.mark.parametrize("codec", ["snappy", "none"])
def test_list_columns_written_by_pyarrow_read_in_the_port(tmp_path, case, element, codec):
    rows = LIST_ROWS[case]
    kind = pa.float64() if case == "floats" or case == "all empty" else pa.int64()
    path = tmp_path / "l.parquet"
    pq.write_table(pa.table({"v": pa.array(rows, pa.list_(kind)),
                             "n": pa.array(range(len(rows)), pa.int64())}), path,
                   use_compliant_nested_type=element == "element", compression=codec)
    assert pq.ParquetFile(path).schema.column(0).path.endswith(f"list.{element}")
    got = parquet.read_table(path)
    assert list(got) == ["v", "n"]
    assert_same_lists(got["v"], [None if r is None else
                                 np.asarray(r, np.float64 if kind == pa.float64() else np.int64)
                                 for r in rows])
    np.testing.assert_array_equal(got["n"], np.arange(len(rows)))


def test_list_columns_across_pages_and_row_groups(tmp_path):
    rng = np.random.default_rng(4)
    rows = [rng.integers(-99, 99, rng.integers(0, 9)).tolist() for _ in range(600)]
    rows[17] = None
    df = pd.DataFrame({"v": rows, "s": [f"x{i % 7}" for i in range(600)]})
    path = tmp_path / "p.parquet"
    df.to_parquet(path, index=False, data_page_size=256, row_group_size=150)
    got = parquet.read_table(path)
    assert_same_lists(got["v"], [None if r is None else np.asarray(r, np.int64) for r in rows])
    assert got["s"].tolist() == df["s"].tolist()


# --------------------------------------------------------------- harvest
def test_both_harvests_count_the_same_sites(tmp_path):
    """One store with shards from both packages: nuclei from the port's
    writer, cells from ``to_parquet``, a family with an empty shard."""
    exp = grid_experiment("pq", well_rows=2, well_cols=2, sites_per_well=(2, 2),
                          channel_names=("DAPI",), site_shape=(8, 8))
    st = ExperimentStore.create(tmp_path / "s", exp)
    ref = JStore.open(st.root)
    for i, seed in enumerate((10, 11)):
        counts, feats, meta = batch(seed, n_sites=8)
        st.append_features("nuclei", feature_table(counts, feats, meta, M), f"batch_{i:03d}")
        counts = counts + 2
        ref.append_features("cells", JRunner._feature_table("cells", counts, feats, meta, M),
                            f"batch_{i:03d}")
    st.append_features("empty", feature_table(np.zeros(2, np.int32), {},
                                              site_meta([0, 1]), M), "batch_000")
    got, want = schedule.harvest_store_counts(st), j_schedule.harvest_store_counts(ref)
    assert got == want and len(got) > 4


def test_thrift_structs_round_trip():
    fields = [(1, parquet.T_I32, -7), (2, parquet.T_BOOL, True), (3, parquet.T_BOOL, False),
              (20, parquet.T_I64, 1 << 40), (21, parquet.T_BINARY, "x" * 300),
              (22, parquet.T_LIST, (parquet.T_I32, list(range(-20, 20)))),
              (23, parquet.T_STRUCT, [(1, parquet.T_DOUBLE, 2.5), (40, parquet.T_BYTE, -3)]),
              (24, parquet.T_I16, None)]
    got = parquet._ThriftReader(parquet.encode_struct(fields)).struct()
    assert got == {1: -7, 2: True, 3: False, 20: 1 << 40, 21: b"x" * 300,
                   22: list(range(-20, 20)), 23: {1: 2.5, 40: -3}}


# ---------------------------------------------------------------- snappy
@pytest.mark.parametrize("kind", ["random", "runs", "text", "zeros", "empty", "mixed"])
def test_snappy_decodes_pyarrow_buffers(kind):
    rng = np.random.default_rng(3)
    data = {
        "random": rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
        "runs": np.repeat(rng.integers(0, 4, 3000, dtype=np.uint8), 37).tobytes(),
        "text": (" ".join(f"site{i % 97} label{i}" for i in range(8000))).encode(),
        "zeros": bytes(200000),
        "empty": b"",
        "mixed": rng.normal(size=20000).round(1).tobytes(),
    }[kind]
    packed = pa.compress(data, codec="snappy", asbytes=True)
    assert snappy.decompress(packed) == data


def _stream(ops) -> tuple[bytes, bytes]:
    """A raw snappy stream of literal and copy elements, and what it
    decodes to (built byte by byte, the format's definition)."""
    out = bytearray()
    body = bytearray()
    for op in ops:
        if op[0] == "lit":
            raw = op[1]
            n = len(raw) - 1
            if n < 60:
                body.append(n << 2)
            else:
                width = (n.bit_length() + 7) // 8
                body.append((59 + width) << 2)
                body += n.to_bytes(width, "little")
            body += raw
            out += raw
        else:
            _, offset, length, form = op
            offset = min(offset, len(out))
            if form == 1 and 4 <= length <= 11 and offset < 2048:
                body.append(1 | (length - 4) << 2 | (offset >> 8) << 5)
                body.append(offset & 0xFF)
            elif form == 4:
                body.append(3 | (length - 1) << 2)
                body += offset.to_bytes(4, "little")
            else:
                body.append(2 | (length - 1) << 2)
                body += offset.to_bytes(2, "little")
            for _ in range(length):
                out.append(out[-offset])
    head = bytearray()
    parquet._put_varint(head, len(out))
    return bytes(head + body), bytes(out)


_ops = st.lists(
    st.one_of(
        st.tuples(st.just("lit"), st.binary(min_size=1, max_size=80)),
        st.tuples(st.just("copy"), st.integers(1, 40), st.integers(1, 64),
                  st.sampled_from([1, 2, 4])),
    ),
    min_size=1, max_size=30,
)


@settings(max_examples=200, deadline=None)
@given(first=st.binary(min_size=1, max_size=70), ops=_ops)
def test_snappy_copies_that_overlap_their_output(first, ops):
    stream, want = _stream([("lit", first), *ops])
    assert snappy.decompress(stream) == want


def test_snappy_rejects_broken_streams():
    stream, _ = _stream([("lit", b"abc"), ("copy", 3, 9, 2)])
    with pytest.raises(snappy.SnappyError):
        snappy.decompress(stream[:-1])
    with pytest.raises(snappy.SnappyError, match="offset"):
        snappy.decompress(bytes([5, 2 | 0 << 2]) + (9).to_bytes(2, "little"))
    with pytest.raises(snappy.SnappyError, match="preamble"):
        snappy.decompress(bytes([9]) + stream[1:])
