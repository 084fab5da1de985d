"""Image writers of the port.

Counterpart: ``tmlibrary_tpu/writers.py`` ``ImageWriter`` (``:33-38``,
reference ``tmlib/writers.py``), which writes with ``cv2.imwrite``.  The
port's target machine has no ``cv2``: :class:`ImageWriter` writes a
``.tif``/``.tiff`` as an uncompressed classic TIFF of one strip
(:func:`encode_tiff`) and a ``.png`` through the port's PNG codec
(:mod:`tmlibrary_tpu_torch.io.png`), 8- or 16-bit greyscale; any other
suffix or image raises :class:`~tmlibrary_tpu_torch.errors.NotSupportedError`.
``DatasetWriter`` (HDF5) is not ported (ROADMAP A item 12).
"""

from __future__ import annotations

import struct
from pathlib import Path

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
