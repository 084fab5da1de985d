"""The port's HDF5 subset (:mod:`tmlibrary_tpu_torch.io.hdf5`) against
``h5py``, and what reads and writes through it: ``IMSReader``,
``DatasetReader``/``DatasetWriter``, ``TablesReader``/``TablesWriter``
and ``export --illumstats``, against the JAX package's.

Hypothesis draws datasets (integer, float and string types of either
byte order, scalars, shapes with empty axes, chunks with partial edges,
gzip levels, shuffle, fletcher32, fill values, unlimited axes) with
attributes: files h5py writes read in the port with equal values, and
files the port writes read in h5py with equal shape, dtype, values,
attributes, compression and ``maxshape``, and in the JAX package's
``DatasetReader``.  Groups of more than 16 children (split B-trees),
``S1`` and variable-length string attributes, the formats the port
still refuses by name, ``tests/test_readers_writers.py:60-88``, ``tests/test_ims.py``,
``tests/test_experiment_store.py:112-220`` and the IMS fuzz mutations of
``tests/test_reader_fuzz.py:218-227`` are mirrored.  Tolerance: exact.
"""

import h5py
import numpy as np
import pandas as pd
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import test_ims
from test_torch_containers import mutations, outcome
from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu.readers import DatasetReader as JDatasetReader
from tmlibrary_tpu_torch import cli, container_writers, readers
from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError, StoreError
from tmlibrary_tpu_torch.io import hdf5
from tmlibrary_tpu_torch.models.experiment import grid_experiment
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.readers import DatasetReader, IMSReader, TablesReader
from tmlibrary_tpu_torch.writers import DatasetWriter, TablesWriter

DTYPES = ["u1", "<u2", "<i4", ">i2", "<u4", "<i8", ">u8", "<f4", ">f4", "<f8", ">f8", "S4"]
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.function_scoped_fixture,
                                           HealthCheck.too_slow])


@st.composite
def datasets(draw):
    dtype = np.dtype(draw(st.sampled_from(DTYPES)))
    shape = tuple(draw(st.lists(st.integers(0, 9), min_size=0, max_size=3)))
    n = int(np.prod(shape))
    seed = draw(st.integers(0, 2**16))
    rng = np.random.default_rng(seed)
    if dtype.kind == "S":
        data = np.array([bytes(rng.integers(97, 123, 3)) for _ in range(n)],
                        dtype).reshape(shape)
    elif dtype.kind == "f":
        data = rng.normal(0, 1000, shape).astype(dtype)
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, shape, dtype=dtype.newbyteorder("=")) \
            .astype(dtype)
    chunked = bool(shape) and 0 not in shape and draw(st.booleans())  # h5py's rule
    opts = {}
    if chunked:
        opts["chunks"] = tuple(draw(st.integers(1, max(d, 1))) for d in shape)
        if draw(st.booleans()):
            opts["compression"] = "gzip"
            opts["compression_opts"] = draw(st.integers(0, 9))
        opts["shuffle"] = draw(st.booleans())
        opts["fletcher32"] = draw(st.booleans())
        if draw(st.booleans()):
            opts["maxshape"] = (None,) + shape[1:]
        if dtype.kind != "S" and draw(st.booleans()):
            opts["fillvalue"] = data.flat[0] if n else dtype.type(3)
    return data, opts


def attributes(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"name": "vlen text", "S1": np.frombuffer(b"512", dtype="S1"),
            "fixed": np.bytes_(b"ab"), "int": np.int64(rng.integers(0, 99)),
            "floats": rng.random(3), "u16": rng.integers(0, 9, (2, 2)).astype("<u2")}


def assert_same_attrs(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k]
        else:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k])


@SETTINGS
@given(datasets())
def test_h5py_files_read_in_the_port(tmp_path, drawn):
    data, opts = drawn
    path = tmp_path / "h.h5"
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("g/inner/data", data=data, **opts)
        ds.attrs.update(attributes(data.size))
        f.attrs["top"] = "root"
    with h5py.File(path, "r") as f:
        want = f["g/inner/data"]
        node = hdf5.File(path).node("g/inner/data")
        got = node.read()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want[()])
        assert node.chunks == want.chunks and node.maxshape == want.maxshape
        assert node.compression == want.compression
        assert_same_attrs(node.attrs, dict(want.attrs))
        if data.ndim:
            np.testing.assert_array_equal(node[..., 1:] if data.shape[-1] > 1 else node[()],
                                          want[..., 1:] if data.shape[-1] > 1 else want[()])
    with DatasetReader(path) as r, JDatasetReader(path) as j:
        np.testing.assert_array_equal(r.read("g/inner/data"), j.read("g/inner/data"))
        assert r.list_datasets() == j.list_datasets()


@SETTINGS
@given(datasets())
def test_port_files_read_in_h5py(tmp_path, drawn):
    data, opts = drawn
    filters = []
    if "compression" in opts:
        filters.append((1, (opts["compression_opts"],)))
    if opts.get("shuffle"):
        filters.insert(0, (2, (data.dtype.itemsize,)))
    if opts.get("fletcher32"):
        filters.append((3, ()))
    fill = opts.get("fillvalue")
    root = hdf5.Group({"top": "root"})
    root.put("g/inner/data", hdf5.Dataset(
        data, chunks=opts.get("chunks"), filters=filters, maxshape=opts.get("maxshape"),
        fillvalue=None if fill is None else np.asarray(fill, data.dtype).tobytes(),
        attrs=attributes(data.size)))
    path = tmp_path / "p.h5"
    hdf5.write(path, root)
    with h5py.File(path, "r") as f:
        got = f["g/inner/data"]
        assert got.dtype == data.dtype and got.shape == data.shape
        np.testing.assert_array_equal(got[()], data)
        assert got.compression == ("gzip" if "compression" in opts else None)
        assert got.maxshape == (opts.get("maxshape") or data.shape)
        assert got.shuffle == bool(opts.get("shuffle")) and \
            got.fletcher32 == bool(opts.get("fletcher32"))
        if fill is not None:
            assert got.fillvalue == fill
        assert_same_attrs(dict(got.attrs), attributes(data.size))
        assert f.attrs["top"] == "root"
    with JDatasetReader(path) as j:
        np.testing.assert_array_equal(j.read("g/inner/data"), data)
    again = hdf5.load(path)  # and back through the port
    np.testing.assert_array_equal(again["g/inner/data"].read(), data)


def test_groups_that_split_their_b_trees(tmp_path):
    path = tmp_path / "many.h5"
    with h5py.File(path, "w") as f:
        for i in range(70):
            f.create_dataset(f"many/d{i:03d}", data=np.full(3, i))
        for i in range(20):
            f.create_group(f"deep/g{i:02d}/leaf")
    port = hdf5.File(path)
    assert sorted(port.members("many")) == [f"d{i:03d}" for i in range(70)]
    for i in (0, 17, 33, 69):
        np.testing.assert_array_equal(port.node(f"many/d{i:03d}").read(), np.full(3, i))
    assert port.resolve("many/d070") is None and port.resolve("nope/x") is None
    with DatasetReader(path) as r, JDatasetReader(path) as j:
        assert r.list_datasets() == j.list_datasets()
    # the port writes big groups too
    root = hdf5.load(path)
    for i in range(70, 140):
        root.put(f"many/d{i:03d}", hdf5.Dataset(np.full(2, i, np.int16)))
    hdf5.write(tmp_path / "more.h5", root)
    with h5py.File(tmp_path / "more.h5", "r") as f:
        assert len(f["many"]) == 140 and len(f["deep"]) == 20
        assert f["many/d139"][()].tolist() == [139, 139]


def test_a_chunk_index_deeper_than_one_node(tmp_path):
    data = np.arange(90 * 70, dtype="<u2").reshape(90, 70)
    root = hdf5.Group()
    root.put("d", hdf5.Dataset(data, chunks=(4, 4), filters=[(1, (1,))]))  # 414 chunks
    hdf5.write(tmp_path / "c.h5", root)
    with h5py.File(tmp_path / "c.h5", "r") as f:
        np.testing.assert_array_equal(f["d"][()], data)
        np.testing.assert_array_equal(f["d"][37:41, 5:9], data[37:41, 5:9])
    with h5py.File(tmp_path / "h.h5", "w") as f:
        f.create_dataset("d", data=data, chunks=(3, 3), compression="gzip")
    node = hdf5.File(tmp_path / "h.h5").node("d")
    np.testing.assert_array_equal(node.read(), data)
    np.testing.assert_array_equal(node[11, 40:], data[11, 40:])


def test_newer_formats_are_refused_by_name(tmp_path):
    """What this test once saw refused now reads as the reference reads
    it (``libver='latest'``, compound and enum datasets, ``DatasetWriter``
    on a new-style file); what the port still refuses is refused by
    name: external links, the szip, scale-offset and nbit filters."""
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(4))
    for reader in (DatasetReader, JDatasetReader):
        with reader(path) as r:
            np.testing.assert_array_equal(r.read("x"), np.arange(4))
            assert r.list_datasets() == ["x"]
    with DatasetWriter(path) as w:
        w.append("x2", np.arange(2))
    with JDatasetReader(path) as j:
        assert j.list_datasets() == ["x", "x2"]
        np.testing.assert_array_equal(j.read("x"), np.arange(4))
    with h5py.File(tmp_path / "big.h5", "w") as f:
        f.create_dataset("c", data=np.zeros(3, [("a", "i4"), ("b", "f8")]))
        f.create_dataset("e", data=np.zeros(3, bool))
    with DatasetReader(tmp_path / "big.h5") as r, JDatasetReader(tmp_path / "big.h5") as j:
        for name in ("c", "e"):
            got, want = r.read(name), j.read(name)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    from h5py import h5d, h5p, h5s, h5t, h5z

    refused = tmp_path / "refused.h5"
    with h5py.File(refused, "w") as f:
        f["ext"] = h5py.ExternalLink("other.h5", "/x")
        f.create_dataset("scaleoffset", data=np.arange(40).reshape(4, 10), scaleoffset=0)
        f.create_dataset("szip", data=np.arange(40, dtype="i4").reshape(4, 10),
                         chunks=(4, 10), compression="szip")
        dcpl = h5p.create(h5p.DATASET_CREATE)
        dcpl.set_chunk((4,))
        dcpl.set_filter(h5z.FILTER_NBIT, 0, ())
        h5py.Dataset(h5d.create(f.id, b"nbit", h5t.NATIVE_INT32, h5s.create_simple((8,)),
                                dcpl=dcpl))[...] = np.arange(8)
    before = refused.read_bytes()
    port = hdf5.File(refused)
    for name, what in (("ext", "external links"), ("scaleoffset", "scale-offset"),
                       ("szip", "szip"), ("nbit", "nbit")):
        with pytest.raises(NotSupportedError, match=what):
            port.node(name)
    with pytest.raises(NotSupportedError, match="external links"):
        DatasetWriter(refused).__enter__()
    assert refused.read_bytes() == before  # not rewritten
    (tmp_path / "zeros.h5").write_bytes(bytes(64))
    with pytest.raises(MetadataError, match="not an HDF5"):
        hdf5.File(tmp_path / "zeros.h5")


# ------------------------------------- tests/test_readers_writers.py:60-88
def test_hdf5_roundtrip(tmp_path):
    path = tmp_path / "d.h5"
    data = np.random.default_rng(0).random((8, 8)).astype(np.float32)
    with DatasetWriter(path) as w:
        w.write("group/stats/mean", data)
        w.write("scalar", 5)
    for reader in (DatasetReader, JDatasetReader):
        with reader(path) as r:
            np.testing.assert_array_equal(r.read("group/stats/mean"), data)
            assert int(r.read("scalar")) == 5
            assert r.exists("group/stats/mean")
            assert not r.exists("nope")
            assert "group/stats/mean" in r.list_datasets()
        with reader(path) as r:
            with pytest.raises(KeyError):
                r.read("missing/path")
    with h5py.File(path, "r") as f:
        assert f["group/stats/mean"].compression == "gzip" and f["scalar"].shape == ()


def test_hdf5_append(tmp_path):
    path = tmp_path / "a.h5"
    with DatasetWriter(path) as w:
        w.append("rows", np.ones((2, 3)))
        w.append("rows", np.full((3, 3), 2.0))
    with DatasetWriter(path) as w:  # a second writer appends to the file
        w.append("rows", np.full((1, 3), 3.0))
    for reader in (DatasetReader, JDatasetReader):
        with reader(path) as r:
            got = r.read("rows")
        assert got.shape == (6, 3)
        assert got[2:5].mean() == 2.0 and got[5].tolist() == [3.0] * 3
    with h5py.File(path, "r") as f:
        assert f["rows"].maxshape == (None, 3)
    # a reference-written file, appended to and rewritten by the port
    from tmlibrary_tpu.writers import DatasetWriter as JDatasetWriter

    ref = tmp_path / "ref.h5"
    with JDatasetWriter(ref) as w:
        w.append("rows", np.arange(6).reshape(2, 3))
        w.write("x", np.arange(5))
        w.write("flat", np.arange(4), compression=None)
    with DatasetWriter(ref) as w:
        w.append("rows", np.arange(3).reshape(1, 3))
        # h5py's refusals: a chunked dataset at its maximal size, a contiguous one
        with pytest.raises(ValueError, match="Unable to extend"):
            w.append("x", np.arange(2))
        with pytest.raises(TypeError, match="Only chunked datasets"):
            w.append("flat", np.arange(2))
    with h5py.File(ref, "r") as f:
        assert f["rows"][()].tolist() == [[0, 1, 2], [3, 4, 5], [0, 1, 2]]
        assert f["x"][()].tolist() == list(range(5)) and f["x"].compression == "gzip"


def test_tables_read_as_pandas_columns(tmp_path):
    frame = pd.DataFrame({"a": [1, 2, 3], "b": [0.5, np.nan, 2.25], "c": ["x", "y,z", "w"],
                          "d": [True, False, True], "e": [1.0, 2.0, 3.5]})
    from tmlibrary_tpu.readers import TablesReader as JTablesReader
    from tmlibrary_tpu.writers import TablesWriter as JTablesWriter

    for suffix, cols in ((".csv", "abcde"), (".parquet", "abce")):
        ref = tmp_path / f"ref{suffix}"
        JTablesWriter(ref).write(frame[list(cols)])
        got, want = TablesReader(ref).read(), JTablesReader(ref).read()
        assert list(got) == list(want.columns)
        for c in got:
            assert got[c].dtype == want[c].to_numpy().dtype, c
            np.testing.assert_array_equal(got[c], want[c].to_numpy())
        port = tmp_path / f"port{suffix}"
        TablesWriter(port).write({c: frame[c].to_numpy() for c in cols})
        back = JTablesReader(port).read()
        assert list(back.columns) == list(cols)
        for c in cols:
            np.testing.assert_array_equal(back[c].to_numpy(), frame[c].to_numpy())
    with pytest.raises(NotSupportedError, match="unsupported table format"):
        TablesReader(tmp_path / "t.xlsx").read()


# ---------------------------------------------------- tests/test_ims.py
@pytest.fixture
def planes():
    rng = np.random.default_rng(9)
    return rng.integers(0, 60000, (2, 3, 2, 18, 22), dtype=np.uint16)


@pytest.mark.parametrize("writer", ["h5py", "port", "port_chunked"])
def test_ims_reader(tmp_path, planes, writer):
    path = tmp_path / "s.ims"
    if writer == "h5py":
        test_ims.write_ims(path, planes, ["DAPI", "GFP"])
    else:
        container_writers.write_ims(path, planes, ["DAPI", "GFP"],
                                    **({"chunks": (1, 16, 16), "compression": "gzip"}
                                       if writer == "port_chunked" else {}))
    for pkg in (readers, j_readers):
        with pkg.IMSReader(path) as r:
            assert (r.width, r.height) == (22, 18)
            assert (r.n_channels, r.n_zplanes, r.n_tpoints) == (2, 3, 2)
            assert r.channel_names() == ["DAPI", "GFP"]
            for c in range(2):
                for z in range(3):
                    for t in range(2):
                        np.testing.assert_array_equal(r.read_plane(z, c, t), planes[c, z, t])
                        np.testing.assert_array_equal(
                            r.read_plane_linear((c * 3 + z) * 2 + t), planes[c, z, t])


def test_ims_uint32_clips_not_wraps(tmp_path):
    arr = np.zeros((1, 1, 1, 8, 8), np.uint32)
    arr[0, 0, 0, 0, 0] = 70000
    arr[0, 0, 0, 0, 1] = 123
    path = tmp_path / "u32.ims"
    test_ims.write_ims(path, arr)
    with IMSReader(path) as r:
        plane = r.read_plane(0, 0, 0)
        assert plane.dtype == np.uint16
        assert plane[0, 0] == 65535 and plane[0, 1] == 123


def test_ims_rejects_non_imaris(tmp_path):
    p = tmp_path / "x.ims"
    p.write_bytes(b"not hdf5")
    with pytest.raises(MetadataError):
        IMSReader(p).__enter__()
    p2 = tmp_path / "plain.ims"
    with h5py.File(p2, "w") as f:
        f.create_dataset("other", data=np.zeros(3))
    with pytest.raises(MetadataError):
        IMSReader(p2).__enter__()


def test_ims_ingest_end_to_end(tmp_path, planes):
    from tmlibrary_tpu_torch.models.experiment import Experiment
    from tmlibrary_tpu_torch.workflow import get_step

    src = tmp_path / "source"
    src.mkdir()
    container_writers.write_ims(src / "scan_A02.ims", planes, ["DAPI", "GFP"])
    root = tmp_path / "exp"
    store = ExperimentStore.create(root, Experiment(name="ims", plates=[], channels=[],
                                                    site_height=1, site_width=1))
    meta = get_step("metaconfig")(store, device="cpu")
    meta.init({"source_dir": str(src), "handler": "auto"})
    assert meta.run(0)["n_files"] == 2 * 3 * 2
    exp = ExperimentStore.open(root).experiment
    assert exp.n_sites == 1 and {c.name for c in exp.channels} == {"DAPI", "GFP"}
    assert exp.n_zplanes == 3 and exp.n_tpoints == 2
    assert {(w.row, w.column) for p in exp.plates for w in p.wells} == {(0, 1)}
    ime = get_step("imextract")(store, device="cpu")
    ime.init({})
    for j in ime.list_batches():
        ime.run(j)
    store = ExperimentStore.open(root)
    names = {c.name: i for i, c in enumerate(store.experiment.channels)}
    for ch_name, c in (("DAPI", 0), ("GFP", 1)):
        for z in range(3):
            for t in range(2):
                px = store.read_sites(None, channel=names[ch_name], tpoint=t, zplane=z)
                np.testing.assert_array_equal(px[0], planes[c, z, t])


def test_ims_fuzz_mutations_give_the_reference_outcome(tmp_path):
    """tests/test_reader_fuzz.py:218-227: every mutation gives the
    reference's planes or its error class."""
    rng = np.random.default_rng(9)
    valid = tmp_path / "valid.ims"
    test_ims.write_ims(valid, rng.integers(0, 60000, (2, 2, 1, 8, 9), dtype=np.uint16))
    target = tmp_path / "mut.ims"
    blob = valid.read_bytes()
    for i, mutated in enumerate([blob, *mutations(blob, rng)]):
        target.write_bytes(mutated)
        assert outcome(readers, "IMSReader", target) == \
            outcome(j_readers, "IMSReader", target), i


# ----------------------------------- tests/test_experiment_store.py:112-220
def illumstats_store(tmp_path, name):
    exp = grid_experiment(name, well_rows=1, well_cols=1, sites_per_well=(1, 1),
                          channel_names=("DAPI",), site_shape=(8, 8))
    return ExperimentStore.create(tmp_path / "exp", exp)


def test_export_illumstats_hdf5(tmp_path):
    store = illumstats_store(tmp_path, "h5")
    rng = np.random.default_rng(0)
    stats = {"mean_log": rng.random((8, 8)).astype(np.float32),
             "std_log": rng.random((8, 8)).astype(np.float32),
             "percentile_keys": np.asarray([0.1, 50.0, 99.9], np.float32),
             "percentile_values": np.asarray([10.0, 500.0, 4000.0], np.float32),
             "n": np.asarray(16.0, np.float32)}
    store.write_illumstats(stats, channel=0)
    out = tmp_path / "stats.h5"
    store.export_illumstats_hdf5(out, channel=0)
    for reader in (DatasetReader, JDatasetReader):
        with reader(out) as r:
            np.testing.assert_array_equal(r.read("stats/mean"), stats["mean_log"])
            np.testing.assert_array_equal(r.read("stats/std"), stats["std_log"])
            np.testing.assert_array_equal(r.read("stats/percentiles/keys"),
                                          stats["percentile_keys"])
            assert float(np.asarray(r.read("stats/n"))) == 16.0


def test_export_illumstats_hdf5_snapshots_and_validates(tmp_path):
    store = illumstats_store(tmp_path, "h5b")
    base = {"mean_log": np.zeros((8, 8), np.float32), "std_log": np.ones((8, 8), np.float32),
            "n": np.asarray(4.0, np.float32)}
    out = tmp_path / "stats.h5"
    store.write_illumstats({**base, "percentile_keys": np.asarray([50.0], np.float32),
                            "percentile_values": np.asarray([100.0], np.float32)}, channel=0)
    store.export_illumstats_hdf5(out, channel=0)
    store.write_illumstats(base, channel=0)
    store.export_illumstats_hdf5(out, channel=0)
    with h5py.File(out, "r") as f:
        assert "stats/percentiles" not in f
        assert float(f["stats/n"][()]) == 4.0
    store.write_illumstats({k: v for k, v in base.items() if k != "n"}, channel=0)
    with pytest.raises(StoreError, match="required fields"):
        store.export_illumstats_hdf5(out, channel=0)
    with h5py.File(out, "r") as f:
        assert float(f["stats/n"][()]) == 4.0  # untouched


def test_cli_export_illumstats(tmp_path):
    store = illumstats_store(tmp_path, "h5c")
    store.write_illumstats({"mean_log": np.zeros((8, 8), np.float32),
                            "std_log": np.ones((8, 8), np.float32),
                            "n": np.asarray(1.0, np.float32)}, channel=0)
    out = tmp_path / "s.h5"
    assert cli.main(["export", "--root", str(store.root), "--illumstats", "0", "--out",
                     str(out), "--device", "cpu"]) == 0
    with JDatasetReader(out) as r:
        assert float(r.read("stats/n")) == 1.0
    assert cli.main(["export", "--root", str(store.root), "--out", str(tmp_path / "x.csv"),
                     "--device", "cpu"]) == 1
    with pytest.raises(StoreError, match="missing"):
        store.export_illumstats_hdf5(out, channel=3)
