"""The port's HDF5 code on the files h5py writes past its default
``libver``, and the types and compressions of the JAX package's
``DatasetWriter``, against ``h5py`` and the JAX package.

Hypothesis draws datasets over ``libver`` in {earliest, v108, v110,
latest}, every chunk index (contiguous, the type-1 B-tree, single chunk,
fixed array, extensible array, v2 B-tree), bool, enum, compound,
complex and variable-length string types beside the integers and floats,
gzip levels, shuffle, fletcher32 and LZF, fill values, ``track_order``
and more than 8 attributes and links (dense storage): files h5py writes
read in the port equal to h5py and to the JAX package's
``DatasetReader``, and files the port writes read in h5py.  The edges
of each index (paged fixed arrays, extensible-array super blocks and
pages, deep v2 B-trees, unallocated chunks, the "don't filter partial
edge chunks" flag), soft, external and hard links, virtual datasets,
the LZF host codec against h5py's filter, lookup3 checksums, the
committed fixtures of ``chip_smoke.py``'s HDF5 well
(``tests/make_hdf5_well.py``) against their manifest, ``DatasetWriter``
parity on every fixture, rewrites that h5py reads with the same
committed datatypes, attributes (hypothesis around the 64 KiB edge of a
version-1 header message x ``libver`` x ``track_order``), links and
creation order, new-style ``.ims`` files through both
packages' ingest and config 3, and the palette and 1-bit PNGs once
refused (now read as cv2 reads them; a truncated one raises
``MetadataError``) are held.  Sites are 64x64 to 96x96 except the
committed fixtures (256x256).  Tolerance: exact.
"""

import ctypes
import glob
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from test_torch_codec_ingest import jterator
from test_torch_ingest import assert_same_ingest, ingest
from test_torch_workflow_steps import assert_same_labels
from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.readers import DatasetReader as JDatasetReader
from tmlibrary_tpu.writers import DatasetWriter as JDatasetWriter
from tmlibrary_tpu_torch import benchmarks, native
from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError
from tmlibrary_tpu_torch.io import hdf5
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.readers import DatasetReader, IMSReader
from tmlibrary_tpu_torch.writers import DatasetWriter

torch.set_num_threads(1)

LIBVERS = ["earliest", "v108", "v110", "latest"]
SETTINGS = settings(max_examples=40, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.function_scoped_fixture,
                                           HealthCheck.too_slow])
STRUCT = np.dtype([("a", "<i4"), ("b", ">f8"), ("c", "S3"), ("d", "u1", (2, 3)), ("e", "?"),
                   ("z", "<c8"), ("n", [("x", "<i2"), ("y", "<f4")])])
ENUM = h5py.enum_dtype({"RED": 0, "GREEN": 1, "BLUE": 42}, basetype="u2")
KINDS = ["<u2", ">i4", "<f8", ">f4", "S4", "bool", "c8", ">c16", "struct", "enum", "vlen"]


def values(kind: str, shape: tuple, rng) -> "tuple[np.ndarray, object]":
    """``(array, dtype to create with)`` of a drawn kind."""
    n = int(np.prod(shape))
    if kind == "bool":
        return rng.integers(0, 2, shape).astype(bool), None
    if kind in ("c8", ">c16"):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(kind), None
    if kind == "struct":
        arr = np.zeros(shape, STRUCT)
        arr["a"] = rng.integers(-9, 9, shape)
        arr["b"] = rng.normal(size=shape)
        arr["c"] = b"xy"
        arr["d"] = rng.integers(0, 255, shape + (2, 3))
        arr["e"] = rng.integers(0, 2, shape).astype(bool)
        arr["z"] = 1 - 2j
        arr["n"]["x"] = 3
        return arr, None
    if kind == "enum":
        return rng.choice(np.array([0, 1, 42], "u2"), shape), ENUM
    if kind == "vlen":
        arr = np.empty(n, object)
        arr[:] = [bytes(rng.integers(97, 123, int(rng.integers(0, 9)))) for _ in range(n)]
        return arr.reshape(shape), h5py.string_dtype()
    if kind == "S4":
        return np.array([bytes(rng.integers(97, 123, 3)) for _ in range(n)], "S4").reshape(
            shape), None
    dt = np.dtype(kind)
    if dt.kind == "f":
        return rng.normal(0, 1000, shape).astype(dt), None
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt.newbyteorder("=")).astype(dt), None


@st.composite
def drawn_files(draw):
    libver = draw(st.sampled_from(LIBVERS))
    kind = draw(st.sampled_from(KINDS))
    shape = tuple(draw(st.lists(st.integers(1, 9), min_size=1, max_size=3)))
    layout = draw(st.sampled_from(["contiguous", "chunked", "single", "unlimited1",
                                   "unlimited2"]))
    opts = {}
    if layout != "contiguous":
        opts["chunks"] = shape if layout == "single" else \
            tuple(draw(st.integers(1, d)) for d in shape)
        if layout == "unlimited1":
            opts["maxshape"] = (None,) + shape[1:]
        elif layout == "unlimited2":
            opts["maxshape"] = (None,) * len(shape)
        comp = draw(st.sampled_from([None, "gzip", "lzf", "level"]))
        if comp == "level":
            opts["compression"] = draw(st.integers(0, 9))
        elif comp:
            opts["compression"] = comp
        if kind != "vlen":
            opts["shuffle"] = draw(st.booleans())
            opts["fletcher32"] = draw(st.booleans())
    track = draw(st.booleans())
    n_attrs = draw(st.sampled_from([0, 3, 12]))
    n_links = draw(st.sampled_from([1, 12]))
    seed = draw(st.integers(0, 2**16))
    return libver, kind, shape, opts, track, n_attrs, n_links, seed


def write_drawn(path, drawn) -> "tuple[np.ndarray, dict]":
    libver, kind, shape, opts, track, n_attrs, n_links, seed = drawn
    rng = np.random.default_rng(seed)
    data, dtype = values(kind, shape, rng)
    with h5py.File(path, "w", libver=libver, track_order=track) as f:
        g = f.create_group("g", track_order=track)
        ds = g.create_dataset("data", data=data, dtype=dtype, **opts)
        for i in range(n_attrs):
            ds.attrs[f"a{i:02d}"] = np.arange(i + 1, dtype="<i2")
        ds.attrs["text"] = "vlen text"
        ds.attrs["flag"] = np.bool_(True)
        for i in range(n_links - 1):
            g.create_dataset(f"z{n_links - i:02d}", data=np.full(2, i))
        if kind != "vlen" and "maxshape" in opts:  # unallocated chunks: the fill value
            ds.resize(tuple(s + 2 if m is None else s for s, m in zip(ds.shape, ds.maxshape)))
    return data, opts


def assert_h5py_keeps(before, after, added=()) -> None:
    """h5py reads ``after`` (a rewrite of ``before``) to the same objects:
    every attribute (values exact, in h5py's order: creation order where
    tracked), every group's links in order (``added`` names aside), the
    creation-order flags, dataset values, and each committed datatype
    kept, with the datasets that use it still naming it."""
    with h5py.File(before, "r") as a, h5py.File(after, "r") as b:
        def check(name, obj):
            other = b[name]
            assert type(other) is type(obj), name
            assert list(other.attrs) == list(obj.attrs), (name, list(other.attrs))
            for k, v in obj.attrs.items():
                got = other.attrs[k]
                assert got == v if isinstance(v, str) else same(got, v), (name, k)
            plist, want = other.id.get_create_plist(), obj.id.get_create_plist()
            assert plist.get_attr_creation_order() == want.get_attr_creation_order(), name
            if isinstance(obj, h5py.Group):
                assert plist.get_link_creation_order() == want.get_link_creation_order(), name
                assert [k for k in other if k not in added] == list(obj), name
            elif isinstance(obj, h5py.Datatype):
                assert other.dtype == obj.dtype, name
            else:
                assert same(other[()], obj[()]), name
                theirs, ours = obj.id.get_type(), other.id.get_type()
                assert ours.committed() == theirs.committed(), name
                if theirs.committed():
                    assert h5py.h5i.get_name(ours) == h5py.h5i.get_name(theirs), name

        a.visititems(check)
        check("/", a["/"])


def h5py_goes_on_writing(*paths, group: str = "g") -> None:
    """What a caller does next with a file through h5py's "a" mode (the
    reference's ``DatasetWriter`` opens it so), alike in each of
    ``paths``, on ``group``: a small attribute, one of 160 KB where the
    object has a version-2 header in every path (h5py takes it into no
    other), 12 more links, and one attribute and one link deleted."""
    big = all(_header_version(p, group) == 2 for p in paths)
    for p in paths:
        with h5py.File(p, "a") as f:
            g = f[group]
            g.attrs["late"] = np.arange(3)
            if big:
                g.attrs["late_big"] = np.arange(20000)
            for i in range(12):
                g.create_dataset(f"late{i:02d}", data=np.full(2, i))
            del g.attrs["late"], g["late03"]


def _header_version(path, name: str) -> int:
    port = hdf5.File(path)
    return 2 if port._bytes(port.resolve(name), 4) == b"OHDR" else 1


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind in "fc":
        return bool(np.array_equal(a, b, equal_nan=True))
    return bool(np.array_equal(a, b))


def assert_same_attrs(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            assert same(got[k], v), k


def assert_port_reads_as_h5py(path) -> None:
    """Every group's members and attributes, every committed datatype and
    every dataset's values, dtype, shape, chunks, maxshape, compression
    and attributes equal h5py's; ``list_datasets`` and ``read`` equal the
    JAX package's."""
    port = hdf5.File(path)
    with h5py.File(path, "r") as f:
        def check(name, obj):
            node = port.node(name)
            assert_same_attrs(node.attrs, dict(obj.attrs))
            if isinstance(obj, h5py.Datatype):
                assert isinstance(node, hdf5.Datatype), name
                return
            if isinstance(obj, h5py.Group):
                assert port.members(name) == list(obj.keys()), name
                return
            assert same(node.read(), obj[()]), name
            assert (node.chunks, node.maxshape, node.compression) == \
                (obj.chunks, obj.maxshape, obj.compression), name
            if obj.ndim and obj.shape[-1] > 1:
                assert same(node[..., 1:], obj[..., 1:]), name

        f.visititems(check)
        check("/", f)
    with DatasetReader(path) as r, JDatasetReader(path) as j:
        assert r.list_datasets() == j.list_datasets()
        for name in j.list_datasets():
            assert same(r.read(name), j.read(name)), name


@SETTINGS
@given(drawn_files())
def test_h5py_files_of_every_libver_read_in_the_port(tmp_path, drawn):
    path = tmp_path / "h.h5"
    write_drawn(path, drawn)
    assert_port_reads_as_h5py(path)


@SETTINGS
@given(drawn_files())
def test_port_files_of_every_type_read_in_h5py(tmp_path, drawn):
    """What h5py wrote, loaded by the port and written again (old format):
    h5py reads the same values, types, chunks, maxshape, compression,
    attributes and links; ``DatasetWriter`` writes the drawn array with
    each compression the reference takes."""
    src, out = tmp_path / "h.h5", tmp_path / "p.h5"
    data, _ = write_drawn(src, drawn)
    hdf5.write(out, hdf5.load(src))
    with h5py.File(src, "r") as a, h5py.File(out, "r") as b:
        names = []
        a.visititems(lambda n, o: names.append(n))
        got = []
        b.visititems(lambda n, o: got.append(n))
        assert names == got
        for n in names:
            assert_same_attrs(dict(b[n].attrs), dict(a[n].attrs))
            if isinstance(a[n], h5py.Dataset):
                assert same(b[n][()], a[n][()]), n
                for k in ("chunks", "maxshape", "compression", "shuffle", "fletcher32"):
                    assert getattr(b[n], k) == getattr(a[n], k), (n, k)
    if drawn[1] == "vlen":
        return
    comp = drawn[3].get("compression", "gzip")
    with DatasetWriter(tmp_path / "w.h5") as w:
        w.write("x", data, compression=comp)
    with JDatasetWriter(tmp_path / "j.h5") as w:
        w.write("x", data, compression=comp)
    with h5py.File(tmp_path / "w.h5", "r") as b, h5py.File(tmp_path / "j.h5", "r") as a:
        assert same(b["x"][()], a["x"][()])
        for k in ("chunks", "maxshape", "compression", "compression_opts"):
            assert getattr(b["x"], k) == getattr(a["x"], k), k


# ------------------------------------------------------ the chunk indexes
def _set_chunk_opts(dcpl, opts: int) -> None:
    """``H5Pset_chunk_opts``, which h5py does not bind, from the libhdf5
    it loaded."""
    found = glob.glob(os.path.join(os.path.dirname(h5py.__file__) + ".libs", "libhdf5-*"))
    lib = ctypes.CDLL(found[0]) if found else ctypes.CDLL("libhdf5.so")
    lib.H5Pset_chunk_opts.argtypes = [ctypes.c_int64, ctypes.c_uint]
    assert lib.H5Pset_chunk_opts(dcpl.id, opts) >= 0


def low_level(f, name, data, chunks, *, deflate=0, early=False, opts=0, fill=None):
    from h5py import h5d, h5p, h5s, h5t

    dcpl = h5p.create(h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    if deflate:
        dcpl.set_deflate(deflate)
    if early:
        dcpl.set_alloc_time(h5d.ALLOC_TIME_EARLY)
    if opts:
        _set_chunk_opts(dcpl, opts)
    if fill is not None:
        dcpl.set_fill_value(np.array([fill], data.dtype))
    dsid = h5d.create(f.id, name.encode(), h5t.py_create(data.dtype),
                      h5s.create_simple(data.shape), dcpl=dcpl)
    return h5py.Dataset(dsid)


INDEX_CASES = {
    # (storage the port reports, writer)
    "fixed_array_paged": ("fixed_array", lambda f, r: f.create_dataset(
        "d", data=r.integers(0, 9, (3000, 2)).astype("u2"), chunks=(1, 2))),
    "fixed_array_sparse": ("fixed_array", lambda f, r: f.create_dataset(
        "d", shape=(40, 40), chunks=(7, 7), dtype="<i4", fillvalue=-5).__setitem__(
        (slice(3, 9), slice(30, None)), 5)),
    "fixed_array_paged_sparse": ("fixed_array", lambda f, r: f.create_dataset(
        "d", shape=(3000,), chunks=(1,), dtype="u2", fillvalue=4).__setitem__(
        slice(1500, 2200, 7), 9)),
    "extensible_array_super_blocks": ("extensible_array", lambda f, r: f.create_dataset(
        "d", data=r.integers(0, 9, 12000).astype("u1"), chunks=(1,), maxshape=(None,))),
    "extensible_array_middle_axis": ("extensible_array", lambda f, r: f.create_dataset(
        "d", data=r.integers(0, 9, (4, 50, 3)), chunks=(2, 1, 2), maxshape=(4, None, 3),
        compression="lzf", fillvalue=-3)),
    "extensible_array_sparse": ("extensible_array", lambda f, r: f.create_dataset(
        "d", shape=(100, 5), chunks=(3, 5), maxshape=(None, 5), dtype="f4",
        fillvalue=9.5).__setitem__(slice(50, 53), 1)),
    "btree2_deep": ("btree2", lambda f, r: f.create_dataset(
        "d", data=r.integers(0, 9, (80, 70)).astype("i2"), chunks=(1, 1),
        maxshape=(None, None))),
    "btree2_filtered_resized": ("btree2", lambda f, r: f.create_dataset(
        "d", data=r.normal(size=(9, 11)).astype("f4"), chunks=(2, 3), maxshape=(None, None),
        compression=3, shuffle=True, fletcher32=True).resize((12, 15))),
    "single_chunk_filtered": ("single", lambda f, r: low_level(
        f, "d", r.integers(0, 99, (10, 12)).astype("i4"), (10, 12), deflate=5)),
    "single_chunk_plain": ("single", lambda f, r: low_level(
        f, "d", r.integers(0, 99, (10, 12)).astype("i4"), (10, 12)).__setitem__(
        Ellipsis, 7)),
    "implicit": ("implicit", lambda f, r: low_level(
        f, "d", np.zeros((10, 10), "u2"), (4, 4), early=True, fill=3).__setitem__(
        (slice(0, 5), slice(None)), 1)),
    "partial_edges_unfiltered": ("fixed_array", lambda f, r: low_level(
        f, "d", np.zeros((10, 10), "i4"), (4, 4), deflate=4, opts=2).__setitem__(
        Ellipsis, np.arange(100).reshape(10, 10))),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_chunk_indexes_at_their_edges(tmp_path, case):
    storage, make = INDEX_CASES[case]
    path = tmp_path / "i.h5"
    with h5py.File(path, "w", libver="latest") as f:
        make(f, np.random.default_rng(len(case)))
    assert hdf5.File(path).node("d").storage == storage
    assert_port_reads_as_h5py(path)
    again = tmp_path / "again.h5"
    hdf5.write(again, hdf5.load(path))
    with h5py.File(path, "r") as a, h5py.File(again, "r") as b:
        assert same(b["d"][()], a["d"][()]) and b["d"].fillvalue == a["d"].fillvalue


def test_extensible_array_pages(tmp_path):
    """Data blocks of 2048 chunk addresses in pages of 1024, every third
    chunk written: the page bits run on across a super block's blocks."""
    path = tmp_path / "p.h5"
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("d", shape=(140000,), chunks=(1,), maxshape=(None,), dtype="u1",
                             fillvalue=5)
        d[::3] = np.arange(0, 140000, 3) % 251
        d[-50:] = 1
    node = hdf5.File(path).node("d")
    assert node.storage == "extensible_array"
    with h5py.File(path, "r") as f:
        assert same(node.read(), f["d"][()])


# ------------------------------------------------------ groups and links
def test_dense_links_attributes_and_huge_objects(tmp_path):
    path = tmp_path / "dense.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for track in (False, True):
            g = f.create_group(f"g{int(track)}", track_order=track)
            for i in range(100):
                g.create_dataset(f"d{(7 * i) % 100:03d}", data=np.full(2, i))
            for i in range(30):
                g.attrs[f"a{(13 * i) % 30:02d}"] = np.arange(i + 1)
            g.attrs["big"] = np.arange(20000)  # 160 KB: a huge heap object
            g["n" * 300] = np.arange(3)  # a long link name
    assert_port_reads_as_h5py(path)
    port = hdf5.File(path)
    assert port.members("g1")[:3] == ["d000", "d007", "d014"]  # creation order
    assert port.members("g0")[:3] == ["d000", "d001", "d002"]  # name order
    # 'big' is past 64 KiB: the writer keeps it in dense storage
    (tmp_path / "again.h5").write_bytes(hdf5.encode(hdf5.load(path)))
    assert_h5py_keeps(path, tmp_path / "again.h5")
    assert_port_reads_as_h5py(tmp_path / "again.h5")


@pytest.mark.parametrize("libver", LIBVERS)
def test_soft_hard_and_external_links(tmp_path, libver):
    path = tmp_path / "links.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("a/b/data", data=np.arange(5))
        f["abs"] = h5py.SoftLink("/a/b/data")
        f["a/rel"] = h5py.SoftLink("b/data")
        f["a/up"] = h5py.SoftLink("/a/b")
        f["chain"] = h5py.SoftLink("/abs")
        f["dangling"] = h5py.SoftLink("/nope")
        f["hard"] = f["a/b/data"]
        f["loop"] = h5py.SoftLink("/loop")
    port = hdf5.File(path)
    with h5py.File(path, "r") as f:
        for p in ("abs", "a/rel", "a/up/data", "chain", "dangling", "hard", "nope", "a/up",
                  "dangling/x", "abs/x", "loop"):
            assert port.exists(p) == (p in f), p
            if p != "loop" and isinstance(f.get(p), h5py.Dataset):
                assert same(port.node(p).read(), f[p][()]), p
    with DatasetReader(path) as r, JDatasetReader(path) as j:
        assert r.list_datasets() == j.list_datasets() == ["a/b/data"]  # each object once
        for p in ("abs", "a/rel", "dangling", "nope"):
            assert r.exists(p) == j.exists(p), p
        with pytest.raises(KeyError):
            r.read("dangling")
    # the port's writer keeps soft links and one object under two names
    shutil.copy(path, tmp_path / "p.h5")
    with DatasetWriter(tmp_path / "p.h5") as w:
        w.write("new", np.arange(3))
    with h5py.File(tmp_path / "p.h5", "r") as f:
        assert f.get("a/rel", getlink=True).path == "b/data"
        assert f["chain"][()].tolist() == list(range(5))
        assert f["hard"].id == f["a/b/data"].id
    with h5py.File(tmp_path / "ext.h5", "w", libver=libver) as f:
        f["e"] = h5py.ExternalLink("links.h5", "/abs")
        f.create_dataset("x", data=np.arange(2))
    before = (tmp_path / "ext.h5").read_bytes()
    with pytest.raises(NotSupportedError, match="external links"):
        hdf5.File(tmp_path / "ext.h5").node("e")
    with pytest.raises(NotSupportedError, match="external links"):
        DatasetWriter(tmp_path / "ext.h5").__enter__()
    assert (tmp_path / "ext.h5").read_bytes() == before
    assert same(hdf5.File(tmp_path / "ext.h5").node("x").read(), np.arange(2))


# ------------------------------------------------------- virtual datasets
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_virtual_datasets(tmp_path, libver):
    """Sources in the same file and beside it, regular hyperslabs (block
    lists under ``earliest``), a missing file and a missing dataset read
    as the fill value; the port's writer keeps the mappings."""
    rng = np.random.default_rng(7)
    with h5py.File(tmp_path / "src.h5", "w") as f:
        f.create_dataset("planes", data=rng.integers(0, 999, (3, 20, 30)).astype("i4"))
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("own", data=np.arange(40, dtype="i4").reshape(4, 10))
        lay = h5py.VirtualLayout(shape=(6, 10, 15), dtype="i4")
        src = h5py.VirtualSource("src.h5", "planes", shape=(3, 20, 30))
        lay[0:3] = src[:, ::2, 5:20]
        lay[3, :4, :10] = h5py.VirtualSource(".", "own", shape=(4, 10))[:, :]
        lay[4] = h5py.VirtualSource("missing.h5", "x", shape=(10, 15))
        lay[5, 1:3, ::3] = h5py.VirtualSource("src.h5", "nope", shape=(2, 5))
        f.create_virtual_dataset("v", lay, fillvalue=-1)
    assert hdf5.File(path).node("v").storage == "virtual"
    assert_port_reads_as_h5py(path)
    shutil.copy(path, tmp_path / "p.h5")
    with DatasetWriter(tmp_path / "p.h5") as w:
        w.write("other", np.arange(2))
    with h5py.File(tmp_path / "p.h5", "r") as f, h5py.File(path, "r") as g:
        assert f["v"].is_virtual and same(f["v"][()], g["v"][()])


def test_unlimited_virtual_mappings_are_refused_by_name(tmp_path):
    from h5py import h5d, h5p, h5s, h5t

    with h5py.File(tmp_path / "src.h5", "w") as f:
        f.create_dataset("d", data=np.arange(10), maxshape=(None,), chunks=(5,))
    path = tmp_path / "v.h5"
    with h5py.File(path, "w", libver="latest") as f:
        spaces = [h5s.create_simple((10,), (h5s.UNLIMITED,)) for _ in range(2)]
        for sp in spaces:
            sp.select_hyperslab((0,), (h5s.UNLIMITED,), stride=(1,), block=(1,))
        dcpl = h5p.create(h5p.DATASET_CREATE)
        dcpl.set_virtual(spaces[0], b"src.h5", b"d", spaces[1])
        h5d.create(f.id, b"v", h5t.NATIVE_INT64, h5s.create_simple((10,), (h5s.UNLIMITED,)),
                   dcpl=dcpl)
    with pytest.raises(NotSupportedError, match="unlimited"):
        hdf5.File(path).node("v")


# ------------------------------------------------ codecs and checksums
@pytest.mark.parametrize("data", ["zeros", "runs", "noise", "text", "one_byte", "long"])
def test_lzf_codec_against_h5py(tmp_path, data):
    rng = np.random.default_rng(3)
    arr = {"zeros": np.zeros(5000, "u1"), "runs": np.repeat(rng.integers(0, 4, 300), 17)
           .astype("u1"), "noise": rng.integers(0, 256, 4096).astype("u1"),
           "text": np.frombuffer(b"the quick brown fox jumps over the lazy dog " * 99, "u1"),
           "one_byte": np.array([7], "u1"),
           "long": np.tile(rng.integers(0, 256, 300).astype("u1"), 40)}[data]
    with h5py.File(tmp_path / "h.h5", "w") as f:
        f.create_dataset("x", data=arr, chunks=arr.shape, compression="lzf")
    with h5py.File(tmp_path / "h.h5", "r") as f:
        mask, raw = f["x"].id.read_direct_chunk((0,))
    if not mask & 1:  # h5py's filter shrank it: the host decoder gives the bytes back
        assert native.lzf_decompress(raw, arr.nbytes) == arr.tobytes()
        with pytest.raises(MetadataError):
            native.lzf_decompress(raw, arr.nbytes - 1)
    packed = native.lzf_compress(arr.tobytes())
    if packed is not None:
        assert len(packed) < arr.nbytes
        assert native.lzf_decompress(packed, arr.nbytes) == arr.tobytes()
    root = hdf5.Group()
    root.put("x", hdf5.Dataset(arr, chunks=arr.shape, filters=[(hdf5.LZF, ())]))
    hdf5.write(tmp_path / "p.h5", root)
    with h5py.File(tmp_path / "p.h5", "r") as f:
        assert same(f["x"][()], arr) and f["x"].compression == "lzf"
        assert bool(f["x"].id.read_direct_chunk((0,))[0] & 1) == (packed is None)
    assert same(hdf5.File(tmp_path / "h.h5").node("x").read(), arr)


def test_damaged_lzf_streams_are_metadata_errors():
    for bad in (b"\x05ab", b"\x20\x00", b"\xe0", b"\x00"):
        with pytest.raises(MetadataError):
            native.lzf_decompress(bad, 64) if bad != b"\x00" else \
                native.lzf_decompress(b"\x01a", 1)


def test_lookup3_and_damaged_checksums(tmp_path):
    # Bob Jenkins' published values of hashlittle
    assert native.lookup3(b"", 0) == 0xDEADBEEF
    assert native.lookup3(b"Four score and seven years ago", 0) == 0x17770551
    assert native.lookup3(b"Four score and seven years ago", 1) == 0xCD628161
    path = tmp_path / "l.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(4))
    blob = bytearray(path.read_bytes())
    for at in (12, blob.find(b"OHDR") + 8):  # the superblock, the root's object header
        bad = bytearray(blob)
        bad[at] ^= 0x40
        (tmp_path / "bad.h5").write_bytes(bytes(bad))
        with pytest.raises(MetadataError):
            hdf5.File(tmp_path / "bad.h5").node("x").read()
        with pytest.raises(MetadataError):
            with DatasetReader(tmp_path / "bad.h5") as r:
                r.list_datasets()


# ------------------------------------------- the HDF5 well's fixtures
FIXTURES = sorted([name for name, _ in chip_smoke.HDF5_WELL.values()]
                  + [chip_smoke.HDF5_DATASET_FILE, chip_smoke.HDF5_KEEP_FILE])


def test_fixtures_read_to_their_manifest_without_h5py():
    """The committed files, read in a process where h5py cannot be
    imported, give the manifest's digests of the JAX package's reads."""
    code = (
        "import json, sys\n"
        "sys.modules['h5py'] = None\n"
        "import chip_smoke\n"
        "from tmlibrary_tpu_torch import readers\n"
        "d = chip_smoke.HDF5_WELL_DIR\n"
        "m = json.loads((d / 'manifest.json').read_text())\n"
        "out = {}\n"
        "for e in m['ims']:\n"
        "    with readers.IMSReader(d / e['file']) as r:\n"
        "        c = r.channel_names().index(e['channel'])\n"
        "        out[e['file'] + ':' + e['channel']] = chip_smoke.hdf5_digest(r.read_plane(0, c, 0))\n"
        "with readers.DatasetReader(d / chip_smoke.HDF5_DATASET_FILE) as r:\n"
        "    for e in m['datasets']:\n"
        "        out[e['path']] = chip_smoke.hdf5_digest(r.read(e['path']))\n"
        "print(json.dumps(out))\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert done.returncode == 0, done.stderr
    got = json.loads(done.stdout.strip().splitlines()[-1])
    manifest = json.loads((chip_smoke.HDF5_WELL_DIR / "manifest.json").read_text())
    want = {f"{e['file']}:{e['channel']}": e["sha256"] for e in manifest["ims"]}
    want.update({e["path"]: e["sha256"] for e in manifest["datasets"]})
    assert got == want
    size = sum(p.stat().st_size for p in chip_smoke.HDF5_WELL_DIR.iterdir())
    assert size < 1.5 * 2**20


@pytest.mark.parametrize("name", FIXTURES)
def test_fixtures_read_as_the_reference(name):
    path = chip_smoke.HDF5_WELL_DIR / name
    assert_port_reads_as_h5py(path)
    if name.endswith(".ims"):
        with IMSReader(path) as r, j_readers.IMSReader(path) as j:
            assert (r.width, r.height, r.n_channels, r.channel_names()) == \
                (j.width, j.height, j.n_channels, j.channel_names())
            for page in range(r.n_channels):
                assert same(r.read_plane_linear(page), j.read_plane_linear(page))
    storages = {"plate_A01.ims": "contiguous", "plate_A02.ims": "fixed_array",
                "plate_A03.ims": "extensible_array", "plate_A04.ims": "btree2"}
    if name in storages:
        node = hdf5.File(path).node("DataSet/ResolutionLevel 0/TimePoint 0/Channel 0/Data")
        assert node.storage == storages[name]
        assert hdf5.File(path).version == 3


def dataset_writer_ops(writer, path) -> None:
    """The same writes and appends through either package's writer."""
    with writer(path) as w:
        w.write("new/bool", np.array([True, False, True]), compression="lzf")
        w.write("new/complex", np.arange(6).reshape(2, 3) * (1 + 1j), compression=7)
        w.write("new/struct", np.zeros(5, [("a", "<i4"), ("b", "<f8")]), compression=None)
        w.write("new/gzip", np.arange(100.0).reshape(10, 10))
        w.write("new/scalar", 3)
        w.append("rows", np.ones((2, 3)))
        w.append("rows", np.full((1, 3), 2.0))


@pytest.mark.parametrize("name", FIXTURES)
def test_dataset_writer_parity_on_every_fixture(tmp_path, name):
    """The same writes and appends through each package's
    ``DatasetWriter`` on a copy of a fixture: the reference's reader gives
    equal datasets, arrays, dtypes, shapes, ``maxshape``, compression and
    attributes."""
    for d in ("j", "p"):
        shutil.copytree(chip_smoke.HDF5_WELL_DIR, tmp_path / d)
    dataset_writer_ops(JDatasetWriter, tmp_path / "j" / name)
    dataset_writer_ops(DatasetWriter, tmp_path / "p" / name)
    if name.endswith(".ims"):  # Imaris' growable Z: one more plane, both packages
        for d, writer in (("j", JDatasetWriter), ("p", DatasetWriter)):
            data = "DataSet/ResolutionLevel 0/TimePoint 0/Channel 1/Data"
            with h5py.File(tmp_path / d / name, "r") as f:
                growable = f[data].maxshape[0] is None
                plane = f[data][:1]
            if growable:
                with writer(tmp_path / d / name) as w:
                    w.append(data, plane[:, ::-1])
    with JDatasetReader(tmp_path / "j" / name) as a, JDatasetReader(tmp_path / "p" / name) as b:
        assert a.list_datasets() == b.list_datasets()
        names = a.list_datasets()
        for n in names:
            assert same(a.read(n), b.read(n)), n
    with h5py.File(tmp_path / "j" / name, "r") as a, h5py.File(tmp_path / "p" / name, "r") as b:
        for n in names:
            for k in ("dtype", "shape", "maxshape", "compression"):
                assert getattr(a[n], k) == getattr(b[n], k), (n, k)
        for n in [n for n in a] + names:
            assert_same_attrs(dict(b[n].attrs), dict(a[n].attrs))


@pytest.mark.parametrize("compression", [None, "gzip", "lzf", 0, 4, 9])
@pytest.mark.parametrize("dtype", ["bool", "complex64", "complex128", "struct", "uint16"])
def test_dataset_writer_types_and_compressions(tmp_path, dtype, compression):
    rng = np.random.default_rng(11)
    data = values({"bool": "bool", "complex64": "c8", "complex128": ">c16",
                   "struct": "struct", "uint16": "<u2"}[dtype], (7, 9), rng)[0]
    if dtype == "complex128":
        data = data.astype("<c16")
    for writer, path in ((JDatasetWriter, tmp_path / "j.h5"), (DatasetWriter, tmp_path / "p.h5")):
        with writer(path) as w:
            w.write("x", data, compression=compression)
            w.append("rows", data[:2])
        with writer(path) as w:
            w.append("rows", data[2:5])
    with JDatasetReader(tmp_path / "j.h5") as a, JDatasetReader(tmp_path / "p.h5") as b, \
            DatasetReader(tmp_path / "j.h5") as c:
        for n in ("x", "rows"):
            assert same(a.read(n), b.read(n)) and same(c.read(n), a.read(n)), n
    with h5py.File(tmp_path / "j.h5", "r") as a, h5py.File(tmp_path / "p.h5", "r") as b:
        for n in ("x", "rows"):
            for k in ("dtype", "chunks", "maxshape", "compression", "compression_opts"):
                assert getattr(a[n], k) == getattr(b[n], k), (n, k)


def test_dataset_writer_refusals_leave_the_file_untouched(tmp_path):
    """A committed datatype is kept (h5py reads a ``Datatype`` and the
    dataset's type ``committed()``); a refused write leaves the file as
    it was; blosc and ``<U`` are refused, as h5py refuses them."""
    path = tmp_path / "t.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["t"] = np.dtype("<i4")  # a committed datatype
        f.create_dataset("x", data=np.arange(3), dtype=f["t"])
    assert same(DatasetReader(path).__enter__().read("x"), np.arange(3, dtype="<i4"))
    shutil.copy(path, tmp_path / "before.h5")
    with DatasetWriter(path) as w:
        w.append("rows", np.arange(4))
    assert_h5py_keeps(tmp_path / "before.h5", path, added=("rows",))
    with h5py.File(path, "r") as f:
        assert isinstance(f["t"], h5py.Datatype) and f["x"].id.get_type().committed()
    before = path.read_bytes()
    with DatasetWriter(path) as w:
        with pytest.raises(ValueError, match="unavailable"):
            w.write("y", np.arange(3), compression="blosc")
    assert path.read_bytes() == before
    with DatasetWriter(tmp_path / "n.h5") as w:
        with pytest.raises(ValueError, match="unavailable"):
            w.write("x", np.arange(3), compression="blosc")
        with pytest.raises(NotSupportedError):
            w.write("u", np.array(["a", "b"]))


@settings(max_examples=24, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(st.integers(65536 - 160, 65536 + 160), st.sampled_from(["earliest"] + LIBVERS[1:]),
       st.booleans(), st.integers(0, 10))
def test_attributes_around_the_64_kib_edge(tmp_path_factory, nbytes, libver, track, others):
    """An attribute of about 64 KiB (h5py keeps it in the object header
    below the edge, in dense storage above it, and under ``earliest``
    refuses it), beside ``others`` small ones, on a group with or without
    ``track_order``: the port's ``DatasetWriter`` rewrite reads in h5py
    with the same attributes, links and creation order."""
    tmp = tmp_path_factory.mktemp("edge")
    path = tmp / "e.h5"
    try:
        with h5py.File(path, "w", libver=libver) as f:
            g = f.create_group("g", track_order=track)
            for i in range(others):
                g.attrs[f"s{(7 * i) % 11}"] = np.arange(i + 1)
            g.attrs["edge"] = np.arange(nbytes, dtype=np.uint8)
            g["b"], g["a"] = np.arange(2), np.arange(3)
            f.attrs["edge"] = np.arange(nbytes - 8, dtype=np.uint8)
    except (ValueError, RuntimeError, OSError) as exc:  # h5py refuses it under 'earliest'
        assert libver == "earliest" and "too large" in str(exc), exc
        return
    shutil.copy(path, tmp / "p.h5")
    with DatasetWriter(tmp / "p.h5") as w:
        w.write("new", np.arange(5))
    assert_h5py_keeps(path, tmp / "p.h5", added=("new",))
    assert_port_reads_as_h5py(tmp / "p.h5")
    with JDatasetWriter(path) as w:
        w.write("new", np.arange(5))
    h5py_goes_on_writing(path, tmp / "p.h5")
    assert_h5py_keeps(path, tmp / "p.h5")
    assert_port_reads_as_h5py(tmp / "p.h5")


def test_the_keep_fixture_rewrites_as_the_reference(tmp_path):
    """Phase 13's hold of ``committed_dense.h5`` on the CPU: the port's
    ``DatasetWriter`` appends to a copy, which reads back to the manifest
    (the reference's writer and reader on the same copy), and h5py reads
    both packages' rewrites alike."""
    manifest = json.loads((chip_smoke.HDF5_WELL_DIR / "manifest.json").read_text())
    src = chip_smoke.HDF5_WELL_DIR / chip_smoke.HDF5_KEEP_FILE
    for d in ("p", "j"):
        (tmp_path / d).mkdir()
        shutil.copy(src, tmp_path / d / "k.h5")
    held = chip_smoke.hdf5_keep_hold(tmp_path / "p" / "k.h5", manifest["keep"])
    assert held["committed"] == 2 and held["datasets"] == 6
    with JDatasetWriter(tmp_path / "j" / "k.h5") as w:
        chip_smoke.hdf5_keep_appends(w)
    assert_h5py_keeps(tmp_path / "j" / "k.h5", tmp_path / "p" / "k.h5")
    for group in ("ordered", "/"):
        h5py_goes_on_writing(tmp_path / "j" / "k.h5", tmp_path / "p" / "k.h5", group=group)
    assert_h5py_keeps(tmp_path / "j" / "k.h5", tmp_path / "p" / "k.h5")
    assert_port_reads_as_h5py(tmp_path / "p" / "k.h5")


def _many_links(f, n: int, name_len: int) -> None:
    f["t"] = np.dtype("<i4")
    g = f.create_group("g", track_order=True)
    for i in range(n):
        name = f"{(7 * i) % n:05d}".ljust(name_len, "n")
        if i % 500:
            g.create_group(name)
        else:  # a few of the committed type (h5py names it by searching the file)
            g.create_dataset(name, data=np.full(1, i), dtype=f["t"])


def _many_attrs(f, n: int, name_len: int) -> None:
    g = f.create_group("g", track_order=True)
    g["x"] = np.arange(2)
    for i in range(n):
        g.attrs[f"{(7 * i) % n:05d}".ljust(name_len, "a")] = np.arange(i % 40)


DENSE_CASES = {
    # a huge heap object past the direct blocks' 64 KiB, and past 16 MiB
    "attribute_20_mb": lambda f: f.attrs.__setitem__("big", np.arange(2_500_000)),
    # link messages past one block: a root indirect block of direct blocks
    "links_3000_committed": lambda f: _many_links(f, 3000, 5),
    "links_200_of_300_chars": lambda f: _many_links(f, 200, 300),
    # attributes past the 64 KiB rows: indirect blocks under the root one
    "attributes_3000_of_300_chars": lambda f: _many_attrs(f, 3000, 300),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_storage_past_one_heap_block(tmp_path, case):
    """Attributes and links that fill more than one fractal heap block,
    or an attribute far past 64 KiB, under ``track_order``: the port's
    ``DatasetWriter`` rewrite reads in h5py as the reference's does, and
    h5py goes on writing it in "a" mode as it goes on writing the
    reference's."""
    path = tmp_path / "j.h5"
    with h5py.File(path, "w", libver="latest") as f:
        DENSE_CASES[case](f)
    shutil.copy(path, tmp_path / "p.h5")
    for writer, p in ((DatasetWriter, tmp_path / "p.h5"), (JDatasetWriter, path)):
        with writer(p) as w:
            w.append("rows", np.arange(4))
    assert_h5py_keeps(path, tmp_path / "p.h5")
    group = "g" if "g" in h5py.File(path, "r") else "/"
    h5py_goes_on_writing(path, tmp_path / "p.h5", group=group)
    assert_h5py_keeps(path, tmp_path / "p.h5")
    assert_port_reads_as_h5py(tmp_path / "p.h5")


# --------------------------------------- new-style .ims through the ingest
def ims_sites(n: int, size: int) -> dict:
    data = benchmarks.synthetic_cell_painting_batch(n, size=size, n_cells=10, seed=0)
    return {ch: data[ch].astype(np.uint16) for ch in ("DAPI", "Actin")}


@pytest.mark.parametrize("size", [64, 96])
def test_new_style_ims_ingest_and_segment_as_the_reference(tmp_path, size):
    """Four ``.ims`` wells in the four structures of the HDF5 well (at 64²
    and 96²) through both packages' metaconfig (``auto``), imextract and
    jterator (config 3) on the CPU: equal ingest, planes and labels."""
    import make_hdf5_well

    src = tmp_path / "src"
    src.mkdir()
    px = ims_sites(4, size)
    for s, (well, (name, _)) in enumerate(sorted(chip_smoke.HDF5_WELL.items())):
        make_hdf5_well.write_ims(src / name, np.stack([px["DAPI"][s], px["Actin"][s]]), s + 1,
                                 chunks=(1, 32, 32))
    args = {"source_dir": str(src), "handler": "auto"}
    ref = ingest(tmp_path / "ref", args, port=False)
    assert ingest(tmp_path / "port", args, port=True) == ref
    assert_same_ingest(tmp_path / "ref", tmp_path / "port")
    port, want = ExperimentStore.open(tmp_path / "port"), JStore.open(tmp_path / "ref")
    assert port.n_sites == 4
    jterator(want, port=False)
    jterator(port, port=True)
    assert_same_labels(port, want)
    assert port.read_labels(None, "nuclei").max() > 0


# ------------------------------------------------------------ PNG repair
def png_variants(tmp_path) -> dict:
    from PIL import Image

    rng = np.random.default_rng(5)
    grey = rng.integers(0, 256, (20, 30)).astype(np.uint8)
    out = {}
    out["palette"] = tmp_path / "palette.png"
    Image.fromarray(np.stack([grey, grey // 2, 255 - grey], -1)).convert("P").save(
        out["palette"])
    out["1-bit"] = tmp_path / "bit.png"
    Image.fromarray(grey > 127).convert("1").save(out["1-bit"])
    return out


@pytest.mark.parametrize("variant", ["palette", "1-bit"])
def test_refused_pngs_raise_metadata_error(tmp_path, variant):
    """A Pillow palette PNG and a 1-bit PNG, which the port refused with a
    ``MetadataError`` naming the file until it read what libpng reads,
    now decode as the reference's ``ImageReader`` and imextract read them;
    a truncated one still raises naming the file."""
    from tmlibrary_tpu.readers import ImageReader as JImageReader
    from tmlibrary_tpu.workflow.steps.imextract import ImageExtractor as JImageExtractor
    from tmlibrary_tpu_torch.readers import ImageReader
    from tmlibrary_tpu_torch.workflow.steps.imextract import ImageExtractor

    path = png_variants(tmp_path)[variant]
    want = JImageReader(path).read()
    assert want.shape == (20, 30)  # cv2 reads it
    np.testing.assert_array_equal(ImageReader(path).read(), want)
    np.testing.assert_array_equal(ImageExtractor._read_plane(str(path), None, 20, 30),
                                  JImageExtractor._read_plane(str(path), None, 20, 30))
    cut = tmp_path / f"cut_{path.name}"
    cut.write_bytes(path.read_bytes()[:-30])
    with pytest.raises(MetadataError) as err:
        ImageReader(cut).read()
    assert str(cut) in str(err.value)
    with pytest.raises(MetadataError) as err:
        ImageExtractor._read_plane(str(cut), None, 20, 30)
    assert str(cut) in str(err.value)
