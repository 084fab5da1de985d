"""Image writers of the port.

Counterpart: ``tmlibrary_tpu/writers.py`` ``ImageWriter`` (``:33-38``,
reference ``tmlib/writers.py``), which writes with ``cv2.imwrite``.  The
port's target machine has no ``cv2``: :class:`ImageWriter` writes what
``cv2.imwrite`` writes for ``.png``, ``.tif``/``.tiff``, ``.jpg``/
``.jpeg``/``.jpe`` (byte for byte), ``.bmp``/``.dib`` and ``.pbm``/
``.pgm``/``.ppm``/``.pnm`` through the port's encoders
(:func:`encode_image`); the other suffixes cv2 writes raise
:class:`~tmlibrary_tpu_torch.errors.NotSupportedError` naming them.
:class:`OMETiffWriter` and :func:`minimal_ome_xml` (``:95-197``) write
multi-page OME-TIFFs byte for byte as the JAX package's do.
:class:`DatasetWriter` (``:41-71``, ``h5py`` there) writes HDF5 through
the port's HDF5 code (:mod:`tmlibrary_tpu_torch.io.hdf5`: every type and
compression the reference's takes), and
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
from tmlibrary_tpu_torch import native
from tmlibrary_tpu_torch.io import bmp, hdf5, png, pnm


#: numpy dtypes a TIFF holds as cv2 writes them: (BitsPerSample, SampleFormat)
_TIFF_TYPES = {np.dtype(np.uint8): 1, np.dtype(np.int8): 2, np.dtype(np.uint16): 1,
               np.dtype(np.int16): 2, np.dtype(np.uint32): 1, np.dtype(np.int32): 2,
               np.dtype(np.float32): 3, np.dtype(np.float64): 3}


def encode_tiff(image: np.ndarray) -> bytes:
    """An ``(H, W)`` grey, ``(H, W, 3)`` BGR or ``(H, W, 4)`` BGRA image of
    8-, 16-, 32- or 64-bit samples (uint8, int8, uint16, int16, uint32,
    int32, float32, float64) as a little-endian classic TIFF: the pixels
    in one uncompressed strip right after the header (colour as RGB(A),
    no ExtraSamples, as cv2 writes it), then the IFD."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    channels = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if channels not in (1, 3, 4) or img.dtype not in _TIFF_TYPES or 0 in img.shape:
        raise NotSupportedError(
            "TIFF encode takes (H, W), (H, W, 3) or (H, W, 4) of uint8, int8, uint16, int16, "
            f"uint32, int32, float32 or float64, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if channels > 1:
        img = img[:, :, [2, 1, 0, 3][:channels]]  # BGR(A) -> the file's RGB(A)
    data = np.ascontiguousarray(img, img.dtype.newbyteorder("<")).tobytes()
    ifd_at = 8 + len(data) + (len(data) & 1)  # the IFD starts on a word boundary
    short, long_ = 3, 4
    bits = img.dtype.itemsize * 8
    # (tag, type, values); values past 4 bytes go after the IFD
    tags = [(256, long_, [w]), (257, long_, [h]), (258, short, [bits] * channels),
            (259, short, [1]), (262, short, [1 if channels == 1 else 2]), (273, long_, [8]),
            (277, short, [channels]), (278, long_, [h]), (279, long_, [len(data)]),
            (284, short, [1]), (339, short, [_TIFF_TYPES[img.dtype]] * channels)]
    ifd = struct.pack("<H", len(tags))
    extra = b""
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    for tag, typ, values in tags:
        packed = struct.pack(f"<{len(values)}{'H' if typ == short else 'I'}", *values)
        if len(packed) <= 4:
            field = packed.ljust(4, b"\0")
        else:
            field = struct.pack("<I", extra_at + len(extra))
            extra += packed
        ifd += struct.pack("<HHI", tag, typ, len(values)) + field
    ifd += struct.pack("<I", 0)
    return (b"II" + struct.pack("<HI", 42, ifd_at) + data + b"\0" * (ifd_at - 8 - len(data))
            + ifd + extra)


#: suffix -> the encoder cv2.imwrite picks for it (what the port writes)
_WRITERS = {".png": "png", ".tif": "tiff", ".tiff": "tiff", ".jpg": "jpeg", ".jpeg": "jpeg",
            ".jpe": "jpeg", ".bmp": "bmp", ".dib": "bmp", ".pbm": "pbm", ".pgm": "pgm",
            ".ppm": "ppm", ".pnm": "pnm"}
#: suffixes cv2 5.0 writes that the port does not (ROADMAP A)
UNPORTED_SUFFIXES = (".webp", ".jp2", ".sr", ".ras", ".hdr", ".pic", ".pfm", ".avif", ".pam",
                     ".gif", ".exr")
#: the depths each encoder keeps; any other is saturated to uint8 first
_KEEPS = {"png": ("u1", "u2"), "jpeg": ("u1",), "bmp": ("u1",),
          "pbm": ("u1", "u2"), "pgm": ("u1", "u2"), "ppm": ("u1", "u2"), "pnm": ("u1", "u2"),
          "tiff": ("u1", "i1", "u2", "i2", "u4", "i4", "f4", "f8")}


def saturate_u8(image: np.ndarray) -> np.ndarray:
    """``image.convertTo(CV_8U)`` as cv2 does it before an encoder that
    takes 8 bits only: integers clamped to 0-255, floats rounded half to
    even first (``cvRound``), a float that is not finite or lies outside
    32-bit integers 0 (``cvRound``'s sentinel, clamped), booleans 0/1."""
    img = np.asarray(image)
    if img.dtype == np.uint8:
        return img
    if img.dtype == np.bool_:
        return img.astype(np.uint8)
    if img.dtype.kind in "iu":
        return np.clip(img.astype(np.int64), 0, 255).astype(np.uint8)
    x = np.rint(img.astype(np.float64))
    with np.errstate(invalid="ignore"):
        x = np.where(np.isfinite(x) & (x >= -2.0**31) & (x < 2.0**31), x, 0)
    return np.clip(x, 0, 255).astype(np.uint8)


def encode_image(suffix: str, image: np.ndarray) -> bytes:
    """The bytes ``cv2.imwrite`` would give a file of this ``suffix``
    (any case) for ``image``, by the port's encoders: PNG
    (:mod:`~tmlibrary_tpu_torch.io.png`), TIFF (:func:`encode_tiff`), JPEG
    byte for byte as cv2 writes it at quality 95
    (:func:`~tmlibrary_tpu_torch.native.jpeg_encode`; BGRA loses its
    alpha), BMP (:mod:`~tmlibrary_tpu_torch.io.bmp`) and binary PBM, PGM,
    PPM (:mod:`~tmlibrary_tpu_torch.io.pnm`; ``.pnm`` as PGM or PPM by
    channels).  Depths an encoder does not keep are saturated to uint8
    first (:func:`saturate_u8`), as ``imwrite`` converts them.  Where cv2
    refuses (2 channels, an empty image, colour in ``.pgm``/``.pbm``, grey
    in ``.ppm``, BGRA in PNM, a suffix with no writer) it raises
    :class:`IOError`; a suffix cv2 writes and the port does not
    (:data:`UNPORTED_SUFFIXES`) raises
    :class:`~tmlibrary_tpu_torch.errors.NotSupportedError` naming it."""
    suffix = suffix.lower()
    if suffix in UNPORTED_SUFFIXES:
        raise NotSupportedError(f"the port does not write {suffix} images (cv2 does)")
    kind = _WRITERS.get(suffix)
    if kind is None:
        raise IOError(f"no image writer for the suffix {suffix!r}")
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    channels = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if channels not in (1, 3, 4) or img.size == 0:
        raise IOError(f"cannot write a {img.shape} image (cv2 writes 1, 3 or 4 channels)")
    if img.dtype.kind not in "biuf" or img.dtype.itemsize > 8 or \
            (img.dtype.kind in "iu" and img.dtype.itemsize == 8):
        raise NotSupportedError(f"the port does not write {img.dtype} images")
    if img.dtype.str[1:] not in _KEEPS[kind]:
        img = saturate_u8(img)
    if kind == "png":
        return png.encode(img)
    if kind == "tiff":
        return encode_tiff(img)
    if kind == "jpeg":
        return native.jpeg_encode(img[:, :, :3] if channels == 4 else img, quality=95)
    if kind == "bmp":
        return bmp.encode(img)
    if kind == "pnm":
        kind = "pgm" if channels == 1 else "ppm"
    if channels != (3 if kind == "ppm" else 1):
        raise IOError(f"cannot write a {channels}-channel image as {suffix} (cv2 refuses)")
    return pnm.encode(img, {"pbm": 4, "pgm": 5, "ppm": 6}[kind])


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
    """Write one image, the format chosen by the suffix, as
    ``cv2.imwrite`` writes it (:func:`encode_image`)."""

    def write(self, image: np.ndarray) -> None:
        data = encode_image(self.filename.suffix, image)
        self.filename.write_bytes(data)


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
    (any ``libver`` h5py writes) is read whole on entry
    (:func:`~tmlibrary_tpu_torch.io.hdf5.load`; what the port's writer
    cannot keep -- external links, a structure the reader refuses --
    raises :class:`~tmlibrary_tpu_torch.errors.NotSupportedError` and the
    file is left untouched), changed in memory, and written again on exit
    to a temporary name and moved over it with ``os.replace``: in the old
    format (superblock 0), with version-2 object headers and dense storage
    for the objects that keep their creation order or hold an attribute
    past 64 KiB; committed datatypes stay committed.  A missing file is
    created."""

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

    @staticmethod
    def _filters(compression) -> list:
        """h5py's filter for ``create_dataset(compression=...)``: ``'gzip'``
        (level 4), a gzip level 0-9, or ``'lzf'``."""
        if compression == "gzip":
            return [(1, (4,))]
        if compression == "lzf":
            return [(hdf5.LZF, ())]
        if isinstance(compression, (int, np.integer)) and int(compression) in range(10):
            return [(1, (int(compression),))]
        if compression == "szip":
            raise NotSupportedError("the port's HDF5 writer does not write szip")
        raise ValueError(f'Compression filter "{compression}" is unavailable')

    def write(self, path: str, data, compression: "str | int | None" = "gzip") -> None:
        """Create (or replace) ``path`` with ``data``: compressed in h5py's
        chunk shape (``guess_chunk``) with ``compression`` ('gzip', a gzip
        level 0-9 or 'lzf'), contiguous when it is None; scalars always
        contiguous."""
        arr = np.asarray(data)
        hdf5._dtype_message(arr.dtype)  # a type the writer cannot take fails here, as in h5py
        if compression is not None and arr.ndim > 0:
            ds = hdf5.Dataset(arr, chunks=hdf5.guess_chunk(arr.shape, arr.shape,
                                                           arr.dtype.itemsize),
                              filters=self._filters(compression))
        else:
            ds = hdf5.Dataset(arr)
        self._root.delete(path)
        self._root.put(path, ds)
        self._changed = True

    def append(self, path: str, data) -> None:
        """Append rows along axis 0, creating a dataset resizable along
        it (``maxshape=(None, ...)``, chunked as h5py chunks it)."""
        arr = np.atleast_1d(np.asarray(data))
        ds = self._root.get(path, follow=True)
        if ds is None:
            hdf5._dtype_message(arr.dtype)
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
            new = np.empty((old.shape[0] + arr.shape[0],) + old.shape[1:], old.dtype)
            new[:old.shape[0]] = old  # not np.concatenate: it makes a field's byte order native
            new[old.shape[0]:] = arr.astype(old.dtype, copy=False).reshape(
                (arr.shape[0],) + old.shape[1:])
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
