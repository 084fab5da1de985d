"""BMP without ``cv2``: the port's reader and writer of Windows bitmaps.

The JAX package reads a BMP through ``cv2.imread(path,
IMREAD_UNCHANGED)`` (imextract, ``ImageReader``, the site-shape probe)
and writes one with ``cv2.imwrite`` (``ImageWriter``).  This module does
both as OpenCV 5.0's ``BmpDecoder`` and ``BmpEncoder`` do
(``grfmt_bmp.cpp``):

- :func:`decode` takes a ``BITMAPINFOHEADER`` or a later one (40 bytes or
  more; OS/2's 12-byte core header too), 1-, 4- and 8-bit palette images
  (RLE4 and RLE8 through ``csrc/host/raster.cpp``), 16-bit 5-5-5 and, with
  ``BI_BITFIELDS`` masks of 5-6-5, 5-6-5, 24-bit BGR and 32-bit, bottom-up
  or top-down (a negative height).  It gives ``(H, W)`` uint8 for a
  palette whose every entry is grey (the entry's value) and for an OS/2
  bitmap (cv2's ``BGR2Gray`` of its colours, 14-bit weights), ``(H, W, 4)``
  BGRA for 32 bits with ``BI_BITFIELDS`` (the bytes as stored, masks
  unread), and ``(H, W, 3)`` BGR otherwise (16 bits widened as
  ``(v << 3) & 0xf8`` with no bit replication, 32-bit ``BI_RGB``'s fourth
  byte dropped).  What cv2 refuses raises
  :class:`~tmlibrary_tpu_torch.errors.MetadataError`.
- :func:`encode` writes ``(H, W)`` as 8 bits with a grey palette, ``(H,
  W, 3)`` as 24-bit BGR and ``(H, W, 4)`` as 32-bit ``BI_BITFIELDS`` BGRA
  under cv2's 124-byte header, rows bottom-up, each padded to 4 bytes.
- :func:`info` reads the header alone (the site-shape probe).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.errors import MetadataError
from tmlibrary_tpu_torch.io.png import gray14

SIGNATURE = b"BM"
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def _header(data: bytes, name: str) -> dict:
    """The fields of a BMP's headers as cv2's ``readHeader`` reads them;
    raises where it fails."""
    if len(data) < 18 or data[:2] != SIGNATURE:
        raise MetadataError(f"{name}: not a BMP (bad signature)")
    offset, size = struct.unpack_from("<II", data, 10)
    palette = np.zeros((256, 4), np.uint8)  # B, G, R, reserved
    colour = False
    if size >= 36:
        if len(data) < 50:
            raise MetadataError(f"{name}: truncated BMP header")
        width, height, _planes, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
        (clrused,) = struct.unpack_from("<I", data, 46)
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 16, 24, 32) and comp == BI_RGB)
            or (bpp in (16, 32) and comp == BI_BITFIELDS)
            or (bpp == 4 and comp == BI_RLE4) or (bpp == 8 and comp == BI_RLE8))
        if not ok:
            raise MetadataError(f"{name}: a {bpp}-bit BMP with compression {comp} "
                                "(cv2 reads none)")
        colour = True
        at = 14 + size
        if bpp <= 8:
            if clrused > 256:
                raise MetadataError(f"{name}: {clrused} palette entries")
            n = clrused or 1 << bpp
            if at + 4 * n > len(data):
                raise MetadataError(f"{name}: truncated BMP palette")
            palette[:n] = np.frombuffer(data, np.uint8, 4 * n, at).reshape(n, 4)
            used = palette[:1 << bpp]
            colour = bool(((used[:, 0] != used[:, 1]) | (used[:, 0] != used[:, 2])).any())
        elif bpp == 16 and comp == BI_BITFIELDS:
            if at + 12 > len(data):
                raise MetadataError(f"{name}: truncated BMP masks")
            red, green, blue = struct.unpack_from("<III", data, at)
            if (blue, green, red) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (blue, green, red) != (0x1F, 0x7E0, 0xF800):
                raise MetadataError(f"{name}: 16-bit masks {red:#x}/{green:#x}/{blue:#x} "
                                    "(cv2 reads 5-5-5 and 5-6-5)")
        elif bpp == 16:
            bpp = 15
        channels = (4 if bpp == 32 and comp != BI_RGB else 3) if colour else 1
    elif size == 12:  # OS/2 core header: cv2 reads it as grey
        if len(data) < 26:
            raise MetadataError(f"{name}: truncated BMP header")
        width, height, _planes, bpp = struct.unpack_from("<HHHH", data, 18)
        comp = BI_RGB
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise MetadataError(f"{name}: a {bpp}-bit OS/2 BMP (cv2 reads none)")
        if bpp <= 8:
            n = 1 << bpp
            if 26 + 3 * n > len(data):
                raise MetadataError(f"{name}: truncated BMP palette")
            palette[:n, :3] = np.frombuffer(data, np.uint8, 3 * n, 26).reshape(n, 3)
        channels = 1
    else:
        raise MetadataError(f"{name}: a BMP header of {size} bytes (cv2 reads 12, or 36 "
                            "and more)")
    if width * abs(height) * channels >= 1 << 30 or width > 1 << 20 or abs(height) > 1 << 20:
        raise MetadataError(f"{name}: a {width}x{abs(height)} BMP (cv2 reads under 1 GiB, "
                            "at most 2^20 pixels a side)")
    return {"offset": offset, "width": width, "height": height, "bpp": bpp, "comp": comp,
            "palette": palette, "colour": colour, "channels": channels}


def info(path) -> tuple[int, int]:
    """``(height, width)`` from the headers alone; raises where cv2's
    header check fails."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(14 + 124 + 1024)
    h = _header(head, path.name)
    return abs(h["height"]), h["width"]


def _rows(data: bytes, at: int, height: int, pitch: int, name: str) -> np.ndarray:
    if at < 0 or at + height * pitch > len(data):
        raise MetadataError(f"{name}: BMP pixel data ends before its {height} rows")
    return np.frombuffer(data, np.uint8, height * pitch, at).reshape(height, pitch)


def decode(data: bytes, name: str = "BMP") -> np.ndarray:
    """The pixels of a BMP file's bytes as ``cv2.imread(...,
    IMREAD_UNCHANGED)`` gives them (module docstring)."""
    h = _header(data, name)
    width, height, bpp, comp = h["width"], abs(h["height"]), h["bpp"], h["comp"]
    palette, colour, at = h["palette"], h["colour"], h["offset"]
    pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    if comp in (BI_RLE4, BI_RLE8):
        from tmlibrary_tpu_torch import native

        if at > len(data):
            raise MetadataError(f"{name}: BMP pixel data past the file")
        try:
            idx = native.bmp_rle(data[at:], width, height, bpp)
        except ValueError as e:
            raise MetadataError(f"{name}: RLE{bpp} stream: {e}") from None
    elif bpp <= 8:
        rows = _rows(data, at, height, pitch, name)
        idx = np.unpackbits(rows, axis=1) if bpp < 8 else rows
        if bpp < 8:
            weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)
            idx = (idx[:, :width * bpp].reshape(height, width, bpp) * weights).sum(
                axis=2, dtype=np.uint8)
        idx = idx[:, :width]
    if bpp <= 8:
        table = palette[:, :3]
        out = table[idx] if colour else \
            gray14(table[:, 0], table[:, 1], table[:, 2]).astype(np.uint8)[idx]
    else:
        rows = _rows(data, at, height, pitch, name)
        if bpp in (15, 16):
            t = rows[:, :2 * width].view("<u2").astype(np.uint16)
            if bpp == 15:
                bgr = [(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8]
            else:
                bgr = [(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8]
            out = np.stack(bgr, -1).astype(np.uint8)
        else:
            px = rows[:, :width * bpp // 8].reshape(height, width, bpp // 8)
            if h["channels"] == 1:  # OS/2: BGR(A)2Gray
                out = gray14(px[:, :, 0], px[:, :, 1], px[:, :, 2]).astype(np.uint8)
            else:
                out = px[:, :, :h["channels"]]
    if h["height"] > 0:  # bottom-up rows
        out = out[::-1]
    return np.ascontiguousarray(out)


def read(path) -> np.ndarray:
    """:func:`decode` of the file at ``path``."""
    path = Path(path)
    return decode(path.read_bytes(), path.name)


def is_bmp(path) -> bool:
    """Whether the file starts with ``BM`` (cv2's signature check)."""
    try:
        with open(path, "rb") as f:
            return f.read(2) == SIGNATURE
    except OSError:
        return False


#: cv2's 124-byte header of a 32-bit image after its size, width and
#: height: planes, bits, BI_BITFIELDS, sizes and resolutions 0, the R, G,
#: B and A masks, 'sRGB', the rest zero
_V5_TAIL = (struct.pack("<HHIIIIII", 1, 32, BI_BITFIELDS, 0, 0, 0, 0, 0)
            + struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000) + b"BGRs" + bytes(64))


def encode(image: np.ndarray) -> bytes:
    """BMP bytes of an ``(H, W)``, ``(H, W, 3)`` or ``(H, W, 4)`` uint8
    image as ``cv2.imwrite(".bmp")`` lays it out (module docstring)."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype != np.uint8 or channels not in (1, 3, 4) or 0 in img.shape:
        raise ValueError(f"BMP encode takes (H, W[, 3|4]) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    step = (w * channels + 3) & -4
    header = 124 if channels == 4 else 40
    palette = b""
    if channels == 1:
        grey = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        grey[:, 3] = 0
        palette = grey.tobytes()
    offset = 14 + header + len(palette)
    rows = np.zeros((h, step), np.uint8)
    rows[:, :w * channels] = img.reshape(h, -1)
    if channels == 4:
        info_header = struct.pack("<Iii", header, w, h) + _V5_TAIL
    else:
        info_header = struct.pack("<IiiHHIIiiII", header, w, h, 1, channels * 8, BI_RGB, 0, 0,
                                  0, 0, 0)
    return (SIGNATURE + struct.pack("<IHHI", offset + h * step, 0, 0, offset) + info_header
            + palette + rows[::-1].tobytes())
