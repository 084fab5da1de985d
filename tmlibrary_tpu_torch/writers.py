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
``DatasetWriter`` (HDF5) is not ported (ROADMAP A item 12b).
"""

from __future__ import annotations

import struct
from pathlib import Path
from xml.etree import ElementTree

import numpy as np

from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.io import png


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


class ImageWriter:
    """Write one greyscale image, the format chosen by the suffix (a
    context manager, as the reference's writers are); the file's
    directory is made on construction."""

    def __init__(self, filename):
        self.filename = Path(filename)
        self.filename.parent.mkdir(parents=True, exist_ok=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

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
