"""Image writers of the port.

Counterpart: ``tmlibrary_tpu/writers.py`` ``ImageWriter`` (``:33-38``,
reference ``tmlib/writers.py``), which writes with ``cv2.imwrite``.  The
port's target machine has no ``cv2``: :class:`ImageWriter` writes a
``.tif``/``.tiff`` as an uncompressed classic TIFF of one strip
(:func:`encode_tiff`) and a ``.png`` through the port's PNG codec
(:mod:`tmlibrary_tpu_torch.io.png`), 8- or 16-bit greyscale; any other
suffix or image raises :class:`~tmlibrary_tpu_torch.errors.NotSupportedError`.
:class:`OMETiffWriter` and :func:`minimal_ome_xml` (``:95-197``) write
multi-page OME-TIFFs byte for byte as the JAX package's do.
:class:`DatasetWriter` (``:41-71``, ``h5py`` there) writes HDF5 through
the port's HDF5 subset (:mod:`tmlibrary_tpu_torch.io.hdf5`), and
:class:`TablesWriter` (``:84-92``, pandas there) writes a ``{column:
array}`` table as Parquet or CSV.  :class:`JsonWriter` and
:class:`XmlWriter` (``:74-81``) are the reference's; every writer derives
from :class:`Writer` (``:21-30``).
"""

from __future__ import annotations

import csv
import json
import struct
from pathlib import Path
from xml.etree import ElementTree

import numpy as np

from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.io import hdf5, png


def encode_tiff(image: np.ndarray) -> bytes:
    """An ``(H, W)`` uint8/uint16 image as a little-endian classic TIFF:
    the pixels in one uncompressed strip right after the header, then the
    IFD (BlackIsZero, one sample a pixel)."""
    img = np.asarray(image)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16) or 0 in img.shape:
        raise NotSupportedError(
            f"TIFF encode takes (H, W) uint8 or uint16 greyscale, got {img.shape} {img.dtype}")
    h, w = img.shape
    data = np.ascontiguousarray(img, "<u2" if img.dtype == np.uint16 else "u1").tobytes()
    ifd_at = 8 + len(data) + (len(data) & 1)  # the IFD starts on a word boundary
    short, long_ = 3, 4
    tags = [(256, long_, w), (257, long_, h), (258, short, img.dtype.itemsize * 8),
            (259, short, 1), (262, short, 1), (273, long_, 8), (277, short, 1),
            (278, long_, h), (279, long_, len(data))]
    ifd = struct.pack("<H", len(tags))
    for tag, typ, value in tags:
        field = struct.pack("<H", value) + b"\0\0" if typ == short else struct.pack("<I", value)
        ifd += struct.pack("<HHI", tag, typ, 1) + field
    ifd += struct.pack("<I", 0)
    return (b"II" + struct.pack("<HI", 42, ifd_at) + data + b"\0" * (ifd_at - 8 - len(data))
            + ifd)


class Writer:
    """Base context-manager writer (reference ``tmlib.writers.Writer``):
    the file's directory is made on construction."""

    def __init__(self, filename):
        self.filename = Path(filename)
        self.filename.parent.mkdir(parents=True, exist_ok=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ImageWriter(Writer):
    """Write one greyscale image, the format chosen by the suffix."""

    def write(self, image: np.ndarray) -> None:
        suffix = self.filename.suffix.lower()
        if suffix in (".tif", ".tiff"):
            self.filename.write_bytes(encode_tiff(image))
        elif suffix == ".png":
            png.write(self.filename, image)
        else:
            raise NotSupportedError(
                f"{self.filename.name}: the port writes .tif, .tiff and .png images only")


def minimal_ome_xml(name: str, height: int, width: int, n_zplanes: int = 1,
                    pixel_type: str = "uint16") -> str:
    """A one-Image OME-XML document for an exported plane stack, in the
    namespace of the metaconfig OME parser."""
    from tmlibrary_tpu_torch.workflow.steps.omexml import OME_NS as ns

    ElementTree.register_namespace("", ns)
    root = ElementTree.Element(f"{{{ns}}}OME")
    img = ElementTree.SubElement(root, f"{{{ns}}}Image")
    img.set("ID", "Image:0")
    img.set("Name", name)
    px = ElementTree.SubElement(img, f"{{{ns}}}Pixels")
    px.set("ID", "Pixels:0")
    px.set("DimensionOrder", "XYZCT")
    px.set("Type", pixel_type)
    px.set("SizeX", str(width))
    px.set("SizeY", str(height))
    px.set("SizeC", "1")
    px.set("SizeZ", str(n_zplanes))
    px.set("SizeT", "1")
    ch = ElementTree.SubElement(px, f"{{{ns}}}Channel")
    ch.set("ID", "Channel:0:0")
    ch.set("SamplesPerPixel", "1")
    ElementTree.SubElement(px, f"{{{ns}}}TiffData")
    return ElementTree.tostring(root, encoding="unicode")


class OMETiffWriter(ImageWriter):
    """A little-endian classic TIFF of uint8/uint16 greyscale pages, one
    uncompressed strip a page, the OME-XML in page 0's
    ``ImageDescription`` (the Bio-Formats convention)."""

    def write(self, pixels: np.ndarray, description: str = "") -> None:
        pixels = np.asarray(pixels)
        if pixels.ndim == 2:
            pixels = pixels[None]
        if pixels.ndim != 3:
            raise NotSupportedError("OMETiffWriter expects (H, W) or (Z, H, W)")
        if pixels.dtype == np.uint8:
            bits = 8
        elif pixels.dtype == np.uint16:
            bits = 16
        else:
            raise NotSupportedError(f"OMETiffWriter writes uint8/uint16, got {pixels.dtype}")
        n_pages, h, w = pixels.shape

        buf = bytearray(b"II*\x00\x00\x00\x00\x00")  # header + IFD0 pointer
        data_off = []
        for p in range(n_pages):
            data_off.append(len(buf))
            buf += pixels[p].astype(f"<u{bits // 8}").tobytes()
            if len(buf) % 2:  # values begin on word boundaries
                buf += b"\x00"
        desc = description.encode() + b"\x00"
        if description and len(desc) > 4:
            desc_off = len(buf)
            buf += desc
            if len(buf) % 2:
                buf += b"\x00"
        elif description:
            # at most 4 bytes sit inline in the IFD value field
            desc_off = int.from_bytes(desc.ljust(4, b"\x00"), "little")

        def entry(tag: int, typ: int, count: int, value: int) -> bytes:
            return struct.pack("<HHII", tag, typ, count, value)

        next_ptr_pos = []
        ifd_off = []
        for p in range(n_pages):
            entries = [entry(256, 3, 1, w), entry(257, 3, 1, h), entry(258, 3, 1, bits),
                       entry(259, 3, 1, 1), entry(262, 3, 1, 1)]
            if p == 0 and description:
                entries.append(entry(270, 2, len(desc), desc_off))
            entries += [entry(273, 4, 1, data_off[p]), entry(277, 3, 1, 1),
                        entry(278, 3, 1, h), entry(279, 4, 1, h * w * bits // 8)]
            ifd_off.append(len(buf))
            buf += struct.pack("<H", len(entries)) + b"".join(entries)
            next_ptr_pos.append(len(buf))
            buf += b"\x00\x00\x00\x00"  # next-IFD pointer, patched below

        struct.pack_into("<I", buf, 4, ifd_off[0])
        for p in range(n_pages - 1):
            struct.pack_into("<I", buf, next_ptr_pos[p], ifd_off[p + 1])
        self.filename.write_bytes(bytes(buf))


class JsonWriter(Writer):
    def write(self, data) -> None:
        self.filename.write_text(json.dumps(data, indent=2, default=str))


class XmlWriter(Writer):
    def write(self, element: ElementTree.Element) -> None:
        self.filename.write_bytes(ElementTree.tostring(element))


class DatasetWriter(Writer):
    """HDF5 dataset writer with the reference's ``write``/``append``
    surface, the semantics of ``h5py.File(path, "a")``: an existing file
    is read whole on entry (:func:`~tmlibrary_tpu_torch.io.hdf5.load`; a
    file outside the port's HDF5 subset raises
    :class:`~tmlibrary_tpu_torch.errors.NotSupportedError` and is left
    untouched), changed in memory, and written again on exit to a
    temporary name and moved over it with ``os.replace``; a missing file
    is created."""

    def __init__(self, filename):
        super().__init__(filename)
        self._root = None
        self._changed = False

    def __enter__(self):
        self._root = hdf5.load(self.filename) if self.filename.exists() else hdf5.Group()
        self._changed = not self.filename.exists()
        return self

    def __exit__(self, *exc):
        if self._changed:
            hdf5.write(self.filename, self._root)
        return False

    def write(self, path: str, data, compression: "str | None" = "gzip") -> None:
        """Create (or replace) ``path`` with ``data``: deflated in h5py's
        chunk shape (``guess_chunk``) when ``compression='gzip'``,
        contiguous otherwise; scalars always contiguous."""
        arr = np.asarray(data)
        if compression not in (None, "gzip"):
            raise NotSupportedError(f"the port's HDF5 writer compresses with gzip only, "
                                    f"not {compression!r}")
        if compression == "gzip" and arr.ndim > 0:
            ds = hdf5.Dataset(arr, chunks=hdf5.guess_chunk(arr.shape, arr.shape,
                                                           arr.dtype.itemsize),
                              filters=[(1, (4,))])
        else:
            ds = hdf5.Dataset(arr)
        self._root.delete(path)
        self._root.put(path, ds)
        self._changed = True

    def append(self, path: str, data) -> None:
        """Append rows along axis 0, creating a dataset resizable along
        it (``maxshape=(None, ...)``, chunked as h5py chunks it)."""
        arr = np.atleast_1d(np.asarray(data))
        ds = self._root.get(path)
        if ds is None:
            maxshape = (None,) + arr.shape[1:]
            self._root.put(path, hdf5.Dataset(
                arr, chunks=hdf5.guess_chunk(arr.shape, maxshape, arr.dtype.itemsize),
                maxshape=maxshape))
        else:
            if not isinstance(ds, hdf5.Dataset) or ds.chunks is None:
                raise TypeError("Only chunked datasets can be resized")
            if ds.maxshape[0] is not None and ds.shape[0] + arr.shape[0] > ds.maxshape[0]:
                raise ValueError("Unable to extend dataset (dimension cannot exceed the "
                                 "existing maximal size)")
            old = ds.read()
            new = np.concatenate([old, arr.astype(old.dtype, copy=False).reshape(
                (arr.shape[0],) + old.shape[1:])])
            ds._data, ds._reader, ds.shape = new, None, new.shape
        self._changed = True


class TablesWriter(Writer):
    """Write a table, ``{column: array}`` (or any mapping of column names
    to arrays in order), as ``.parquet`` (:mod:`tmlibrary_tpu_torch.io.parquet`)
    or ``.csv`` (pandas' ``to_csv(index=False)`` layout: a header row,
    NaN and None as empty fields, floats by ``repr``); the reference
    writes a DataFrame with pandas."""

    def write(self, table) -> None:
        suffix = self.filename.suffix.lower()
        columns = {str(k): np.asarray(table[k]) for k in table}
        if suffix == ".parquet":
            from tmlibrary_tpu_torch.io import parquet

            parquet.write_table(self.filename, columns)
        elif suffix == ".csv":
            n = len(next(iter(columns.values()))) if columns else 0

            def field(v):
                if v is None or (isinstance(v, (float, np.floating)) and np.isnan(v)):
                    return ""
                return str(v)  # a numpy float prints as pandas writes it

            with open(self.filename, "w", newline="") as f:
                w = csv.writer(f, lineterminator="\n")
                w.writerow(list(columns))
                for i in range(n):
                    w.writerow([field(c[i]) for c in columns.values()])
        else:
            raise NotSupportedError(f"unsupported table format '{suffix}'")
