"""Write the HDF5 files of ``chip_smoke.py`` phase 13's HDF5 well into
``tests/data/hdf5_well/``, with ``manifest.json``.

The card's machine has no h5py, so these files are committed.  Four
Imaris ``.ims`` files, one well of one site each (``plate_A01.ims`` ..
``plate_A04.ims``, as the ``ims`` metaconfig handler lays them out), hold
DAPI and Actin of sites 0-3 of
``benchmarks.synthetic_cell_painting_batch(384, size=256, seed=0)``
(phase 13's plate) at full width, uint16, in the layout of
``container_writers.write_ims`` (planes padded by 7 rows and columns, the
true size in ``DataSetInfo/Image``), each in another structure that
h5py writes (:data:`chip_smoke.HDF5_WELL`):

1. ``libver='latest'``, contiguous data, ``DataSetInfo/Image``'s 13
   attributes in dense storage (a fractal heap and v2 B-trees);
2. a fixed-array chunk index, shuffle and gzip;
3. an extensible-array chunk index (unlimited Z), LZF;
4. a version-2 B-tree chunk index (unlimited Z and Y), gzip, every group
   with ``track_order=True``.

``datasetwriter.h5`` holds what the JAX package's ``DatasetWriter``
writes and h5py reads back -- bool, complex, structured and
variable-length string datasets, a gzip level, LZF -- with a single-chunk
and an implicit-index dataset (h5py's low-level ``h5p``/``h5d``), a soft
link, and two virtual datasets: the four DAPI planes mapped from the
``.ims`` files beside it (plus a fifth slot from a missing file, which
reads as the fill value) and a row of its own complex dataset.

``committed_dense.h5`` (:data:`chip_smoke.HDF5_KEEP_FILE`) holds what
the port's ``DatasetWriter`` must keep when it rewrites a file: two
committed datatypes (a ``uint16`` and a compound, each with an
attribute), a dataset using each (the compound one growable), a
160 KB attribute (``np.arange(20000)``, dense storage) on the root and
a group with ``track_order=True`` whose links and attributes were made
out of name order.

Every object is written with ``track_times=False`` (groups through
``h5p``, committed datatypes through ``H5Tcommit2`` of h5py's own
libhdf5), so the script writes the same bytes on every run.  The
manifest holds, for each plane and dataset, the sha256
(``chip_smoke.hdf5_digest``: dtype, shape and values) of the JAX
package's read of it (``IMSReader.read_plane``, ``DatasetReader.read``).

The manifest's ``keep`` entry holds what the JAX package's
``DatasetWriter`` makes of a copy of ``committed_dense.h5`` after
:func:`chip_smoke.hdf5_keep_appends`: the digests of every dataset its
``DatasetReader`` reads and of every attribute, the order of the ordered
group's links and attributes, and which dataset uses which committed
type.

Run from the repository root, on a machine with h5py and the JAX
package::

    python tests/make_hdf5_well.py

``tests/test_torch_hdf5_v2.py`` checks that the committed files read in
the port to the manifest's digests.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

#: phase 13's plate: its first 4 sites are the HDF5 well's
PLATE_SITES, SIZE, PAD = 384, 256, 7
CHUNKS = (1, 96, 96)
#: Imaris' ``DataSetInfo/Image`` attributes besides X, Y and Z (more than
#: 8 attributes in all go to dense storage)
IMAGE_ATTRS = {"Unit": "um", "ExtMin0": "0", "ExtMin1": "0", "ExtMin2": "0",
               "ExtMax0": "256", "ExtMax1": "256", "ExtMax2": "1", "Noc": "2",
               "RecordingDate": "2026-01-01 00:00:00.000", "Description": "hdf5 well"}


def well_sites(n: int = PLATE_SITES, size: int = SIZE) -> dict:
    """The first 4 sites of the seeded plate, uint16 as phase 13 casts them."""
    from tmlibrary_tpu_torch import benchmarks

    data = benchmarks.synthetic_cell_painting_batch(n, size=size, seed=0)
    return {ch: data[ch][:4].astype(np.uint16) for ch in ("DAPI", "Actin")}


def new_file(path: Path, track_order: bool = False):
    """An h5py file of ``libver='latest'`` whose root records no times
    (and tracks link and attribute creation order when asked)."""
    import h5py
    from h5py import h5f, h5p

    fcpl = h5p.create(h5p.FILE_CREATE)
    fcpl.set_obj_track_times(False)
    if track_order:
        fcpl.set_link_creation_order(h5p.CRT_ORDER_TRACKED | h5p.CRT_ORDER_INDEXED)
        fcpl.set_attr_creation_order(h5p.CRT_ORDER_TRACKED | h5p.CRT_ORDER_INDEXED)
    fapl = h5p.create(h5p.FILE_ACCESS)
    fapl.set_libver_bounds(h5f.LIBVER_LATEST, h5f.LIBVER_LATEST)
    return h5py.File(h5f.create(str(path).encode(), h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl))


def group(parent, path: str, track_order: bool = False):
    """The group at ``path`` below ``parent``, each level made without
    times."""
    import h5py
    from h5py import h5g, h5p

    node = parent
    for part in [p for p in path.split("/") if p]:
        if part in node:
            node = node[part]
            continue
        gcpl = h5p.create(h5p.GROUP_CREATE)
        gcpl.set_obj_track_times(False)
        if track_order:
            gcpl.set_link_creation_order(h5p.CRT_ORDER_TRACKED | h5p.CRT_ORDER_INDEXED)
            gcpl.set_attr_creation_order(h5p.CRT_ORDER_TRACKED | h5p.CRT_ORDER_INDEXED)
        node = h5py.Group(h5g.create(node.id, part.encode(), gcpl=gcpl))
    return node


def write_ims(path: Path, planes: np.ndarray, structure: int, chunks: tuple = CHUNKS) -> None:
    """One site of DAPI and Actin (``planes``: (2, H, W)) in the
    structure numbered ``structure`` (see the module docstring), chunked
    as ``chunks`` where the structure is chunked."""
    track = structure == 4
    with new_file(path, track_order=track) as f:
        info = group(f, "DataSetInfo/Image", track)
        h, w = planes.shape[1:]
        attrs = {"X": str(w), "Y": str(h), "Z": "1"}
        if structure == 1:
            attrs.update(IMAGE_ATTRS)
        for name, val in attrs.items():
            info.attrs[name] = np.frombuffer(val.encode(), dtype="S1")
        for c, name in enumerate(("DAPI", "Actin")):
            group(f, f"DataSetInfo/Channel {c}", track).attrs["Name"] = \
                np.frombuffer(name.encode(), dtype="S1")
        for c in range(2):
            padded = np.zeros((1, h + PAD, w + PAD), np.uint16)
            padded[0, :h, :w] = planes[c]
            g = group(f, f"DataSet/ResolutionLevel 0/TimePoint 0/Channel {c}", track)
            opts = {1: {},
                    2: {"chunks": chunks, "shuffle": True, "compression": "gzip"},
                    3: {"chunks": chunks, "maxshape": (None, h + PAD, w + PAD),
                        "compression": "lzf"},
                    4: {"chunks": chunks, "maxshape": (None, None, w + PAD),
                        "compression": "gzip", "compression_opts": 1}}[structure]
            g.create_dataset("Data", data=padded, track_times=False, **opts)


def low_level(f, name: str, data: np.ndarray, chunks: tuple, deflate: bool) -> None:
    """A chunked dataset made through ``h5p``/``h5d``: one chunk of the
    whole array with deflate (a filtered single-chunk index), or early
    allocation with no filter (the implicit index)."""
    import h5py
    from h5py import h5d, h5p, h5s, h5t

    dcpl = h5p.create(h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    dcpl.set_obj_track_times(False)
    if deflate:
        dcpl.set_deflate(6)
    else:
        dcpl.set_alloc_time(h5d.ALLOC_TIME_EARLY)
    dsid = h5d.create(f.id, name.encode(), h5t.py_create(data.dtype),
                      h5s.create_simple(data.shape), dcpl=dcpl)
    h5py.Dataset(dsid)[...] = data


def virtual(f, name: str, layout, fillvalue=None) -> None:
    """``f.create_virtual_dataset`` with no times recorded."""
    import h5py
    from h5py import h5d, h5s, h5t

    dcpl = layout._get_dcpl(f.filename)
    dcpl.set_obj_track_times(False)
    if fillvalue is not None:
        dcpl.set_fill_value(np.array([fillvalue], layout.dtype))
    parent = f[name.rsplit("/", 1)[0]] if "/" in name else f
    h5py.Dataset(h5d.create(parent.id, name.rsplit("/", 1)[-1].encode(),
                            h5t.py_create(np.dtype(layout.dtype), logical=1),
                            h5s.create_simple(layout.shape), dcpl=dcpl))


def write_dataset_file(path: Path, px: dict) -> None:
    """``datasetwriter.h5`` (see the module docstring)."""
    import h5py

    rng = np.random.default_rng(26)
    with new_file(path) as f:
        def ds(name, data, **kw):
            return f.create_dataset(name, data=data, track_times=False, **kw)

        ds("bool", rng.integers(0, 2, (6, 7)).astype(bool), compression="gzip")
        ds("complex", (rng.normal(size=(4, 5)) + 1j * rng.normal(size=(4, 5))),
           compression="gzip")
        st = np.dtype([("site", "<i4"), ("mean", "<f8"), ("well", "S3"), ("box", "<u2", (2, 2)),
                       ("valid", "?"), ("phase", "<c8")])
        rec = np.zeros(4, st)
        rec["site"] = np.arange(4)
        rec["mean"] = [float(px["DAPI"][s].mean()) for s in range(4)]
        rec["well"] = [b"A01", b"A02", b"A03", b"A04"]
        rec["box"] = [[[0, 0], [256, 256]]] * 4
        rec["valid"] = [True, True, False, True]
        rec["phase"] = np.exp(1j * np.arange(4))
        ds("structured", rec, compression="lzf")
        ds("strings", np.array([b"DAPI", b"Actin", b"", "µm".encode()], dtype=object),
           dtype=h5py.string_dtype())
        ds("gzip_level", px["Actin"][0, :64, :64], compression=7)
        ds("lzf_noise", rng.integers(0, 256, (64, 64)).astype(np.uint8), chunks=(32, 32),
           compression="lzf")  # noise lzf cannot shrink: chunks stored as they are
        low_level(f, "single_chunk", px["DAPI"][1, :40, :50].astype(np.int32), (40, 50), True)
        low_level(f, "implicit", px["Actin"][2, :50, :60], (16, 16), False)
        f["soft"] = h5py.SoftLink("/complex")
        n = 5
        layout = h5py.VirtualLayout(shape=(n, SIZE, SIZE), dtype=np.uint16)
        for s in range(4):
            src = h5py.VirtualSource(f"plate_A0{s + 1}.ims",
                                     "DataSet/ResolutionLevel 0/TimePoint 0/Channel 0/Data",
                                     shape=(1, SIZE + PAD, SIZE + PAD), dtype=np.uint16)
            layout[s] = src[0, :SIZE, :SIZE]
        layout[4] = h5py.VirtualSource("missing.ims", "Data", shape=(SIZE, SIZE),
                                       dtype=np.uint16)
        group(f, "virtual")
        virtual(f, "virtual/dapi", layout, fillvalue=7)
        row = h5py.VirtualLayout(shape=(5,), dtype=np.complex128)
        row[:] = h5py.VirtualSource(".", "complex", shape=(4, 5))[1]
        virtual(f, "virtual/complex_row", row)


def commit(f, name: str, dtype) -> None:
    """``f[name] = dtype`` (a committed datatype) with no times recorded:
    ``H5Tcommit2`` of h5py's libhdf5 with a datatype creation property
    list that tracks none (h5py passes no such list)."""
    import ctypes
    import glob
    import os

    import h5py
    from h5py import h5t

    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(h5py.__file__) + ".libs",
                                             "libhdf5-*"))[0])
    lib.H5open()
    lib.H5Pcreate.argtypes = [ctypes.c_int64]
    lib.H5Pcreate.restype = ctypes.c_int64
    lib.H5Pset_obj_track_times.argtypes = [ctypes.c_int64, ctypes.c_uint]
    lib.H5Tcommit2.argtypes = [ctypes.c_int64, ctypes.c_char_p] + [ctypes.c_int64] * 4
    lib.H5Pclose.argtypes = [ctypes.c_int64]
    tcpl = lib.H5Pcreate(ctypes.c_int64.in_dll(lib, "H5P_CLS_DATATYPE_CREATE_ID_g").value)
    assert tcpl >= 0 and lib.H5Pset_obj_track_times(tcpl, 0) >= 0
    tid = h5t.py_create(np.dtype(dtype))
    assert lib.H5Tcommit2(f.id.id, name.encode(), tid.id, 0, tcpl, 0) >= 0
    lib.H5Pclose(tcpl)


def write_keep_file(path: Path, px: dict) -> None:
    """``committed_dense.h5`` (see the module docstring)."""
    with new_file(path) as f:
        commit(f, "pixel_t", "<u2")
        commit(f, "object_t", chip_smoke.HDF5_OBJECT_T)
        f["pixel_t"].attrs["unit"] = "counts"
        f["object_t"].attrs["fields"] = 2
        f.create_dataset("sites", data=px["DAPI"][3, :48, :48], dtype=f["pixel_t"],
                         track_times=False)
        rows = np.zeros(5, chip_smoke.HDF5_OBJECT_T)
        rows["label"], rows["area"] = np.arange(1, 6), np.arange(5) * 10.5
        f.create_dataset("objects", data=rows, dtype=f["object_t"], maxshape=(None,),
                         chunks=(4,), track_times=False)
        f.attrs["big"] = np.arange(20000)  # 160 KB: only dense storage holds it
        ordered = group(f, "ordered", track_order=True)
        for name, value in (("z_last", 1), ("a_first", 2), ("m_mid", 3)):
            ordered.create_dataset(name, data=np.full(3, value), track_times=False)
        ordered.attrs["zeta"] = 1.5
        ordered.attrs["alpha"] = "first made second"


def keep_entry(out_dir: Path) -> dict:
    """The JAX package's ``DatasetWriter`` and ``DatasetReader`` (h5py)
    on a copy of ``committed_dense.h5``: the manifest's ``keep`` entry."""
    import shutil
    import tempfile

    import h5py

    from tmlibrary_tpu.readers import DatasetReader
    from tmlibrary_tpu.writers import DatasetWriter

    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / chip_smoke.HDF5_KEEP_FILE
        shutil.copy(out_dir / chip_smoke.HDF5_KEEP_FILE, copy)
        with DatasetWriter(copy) as w:
            chip_smoke.hdf5_keep_appends(w)
        datasets = []
        with DatasetReader(copy) as r:
            for name in r.list_datasets():
                arr = r.read(name)
                datasets.append({"path": name, "shape": list(arr.shape), "dtype": str(arr.dtype),
                                 "sha256": chip_smoke.hdf5_digest(arr)})
        attrs, committed = [], {}
        with h5py.File(copy, "r") as f:
            def visit(name, obj):
                for key, value in obj.attrs.items():
                    attrs.append({"object": name, "name": key,
                                  "sha256": chip_smoke.hdf5_attr_digest(value)})
                if isinstance(obj, h5py.Dataset) and obj.id.get_type().committed():
                    committed[name] = next(n for n in ("pixel_t", "object_t")
                                           if f[n].id == obj.id.get_type())
            visit("/", f)
            f.visititems(visit)
            order = {"links": list(f["ordered"]), "attrs": list(f["ordered"].attrs)}
    return {"file": chip_smoke.HDF5_KEEP_FILE, "datasets": datasets, "attrs": attrs,
            "ordered": order, "committed": committed}


def reference_entries(out_dir: Path) -> dict:
    """The JAX package's reads of every file, as manifest entries."""
    from tmlibrary_tpu.readers import DatasetReader, IMSReader

    ims = []
    for well, (name, structure) in sorted(chip_smoke.HDF5_WELL.items()):
        with IMSReader(out_dir / name) as r:
            for c, channel in enumerate(r.channel_names()):
                plane = r.read_plane(0, c, 0)
                ims.append({"file": name, "well": well, "structure": structure,
                            "channel": channel, "shape": list(plane.shape),
                            "dtype": str(plane.dtype), "sha256": chip_smoke.hdf5_digest(plane)})
    datasets = []
    with DatasetReader(out_dir / chip_smoke.HDF5_DATASET_FILE) as r:
        for path in r.list_datasets() + ["soft"]:
            arr = r.read(path)
            datasets.append({"path": path, "shape": list(arr.shape), "dtype": str(arr.dtype),
                             "sha256": chip_smoke.hdf5_digest(arr)})
    return {"ims": ims, "datasets": datasets, "keep": keep_entry(out_dir)}


def main() -> int:
    out_dir = chip_smoke.HDF5_WELL_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    px = well_sites()
    for s, (_well, (name, _)) in enumerate(sorted(chip_smoke.HDF5_WELL.items())):
        write_ims(out_dir / name, np.stack([px["DAPI"][s], px["Actin"][s]]), s + 1)
    write_dataset_file(out_dir / chip_smoke.HDF5_DATASET_FILE, px)
    write_keep_file(out_dir / chip_smoke.HDF5_KEEP_FILE, px)
    manifest = {"source": "DAPI and Actin of the first 4 sites of benchmarks."
                          "synthetic_cell_painting_batch(384, size=256, seed=0), uint16",
                **reference_entries(out_dir)}
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in out_dir.iterdir())
    print(f"wrote {len(list(out_dir.iterdir()))} files ({total} bytes) to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
