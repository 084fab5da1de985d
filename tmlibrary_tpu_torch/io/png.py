"""PNG without ``cv2``: the port's codec for tiles, probes and ingest.

The JAX package writes illuminati's tiles with ``cv2.imwrite``, decodes
PNG planes in imextract with ``cv2.imread(..., IMREAD_UNCHANGED)`` and
``cvtColor(..., COLOR_BGR2GRAY)``, and probes a site's shape with
``cv2.imread``.  The port's target machine has no ``cv2``, so this module
reads and writes the format itself with ``zlib``:

- :func:`encode` / :func:`write` take 8- or 16-bit greyscale ``(H, W)``
  arrays, or 8-bit ``(H, W, 3)`` BGR ones (the figures), and write one
  ``IDAT`` of rows with filter type 0.  The bytes are
  not cv2's; the decoded pixels are the array's.
- :func:`decode` / :func:`read` take 8- and 16-bit greyscale, greyscale
  with alpha, RGB and RGBA, non-interlaced, any of the five filter types,
  any number of ``IDAT`` chunks, and give what ``cv2.imread(path,
  IMREAD_UNCHANGED)`` gives: ``(H, W)`` for greyscale, ``(H, W, 3)`` BGR
  for RGB, ``(H, W, 4)`` BGRA for RGBA and for greyscale with alpha (the
  grey value in B, G and R).
- :func:`to_gray` is ``cvtColor(img, COLOR_BGR2GRAY)``: cv2's fixed-point
  rule, ``(3735 B + 19235 G + 9798 R + 2**14) >> 15``, the alpha channel
  ignored.
- :func:`info` reads the header alone (the site-shape probe).

Ancillary chunks are skipped, and so is the suggested palette (``PLTE``)
of a colour image.  Adam7 interlace, palette images, bit depths below 8,
a ``tRNS`` transparency chunk and unknown critical chunks raise
:class:`~tmlibrary_tpu_torch.errors.NotSupportedError` naming what was
met; a bad signature, CRC or stream raises
:class:`~tmlibrary_tpu_torch.errors.MetadataError`.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> (samples per pixel, name)
COLOR_TYPES = {0: (1, "greyscale"), 2: (3, "RGB"), 3: (1, "palette"),
               4: (2, "greyscale with alpha"), 6: (4, "RGBA")}
#: cv2's BGR2GRAY weights (15-bit fixed point) for B, G, R
GRAY_WEIGHTS = (3735, 19235, 9798)
GRAY_SHIFT = 15


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


# ------------------------------------------------------------------ encode
def encode(image: np.ndarray) -> bytes:
    """PNG bytes of an ``(H, W)`` uint8 or uint16 greyscale image, or of
    an ``(H, W, 3)`` uint8 BGR image written as RGB, as ``cv2.imwrite``
    takes it (``zlib`` at level 1, cv2's default)."""
    img = np.asarray(image)
    colour = img.ndim == 3 and img.shape[-1] == 3 and img.dtype == np.uint8
    if not colour and (img.ndim != 2 or img.dtype not in (np.uint8, np.uint16)):
        raise NotSupportedError(
            "PNG encode takes (H, W) uint8 or uint16 greyscale or (H, W, 3) uint8 BGR, "
            f"got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise NotSupportedError(f"PNG encode of an empty image {img.shape}")
    depth = 8 if img.dtype == np.uint8 else 16
    if colour:
        img = img[..., ::-1]  # BGR -> the file's RGB
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else "u1").view(np.uint8)
    raw = np.zeros((h, 1 + rows.reshape(h, -1).shape[1]), np.uint8)  # column 0: filter 0
    raw[:, 1:] = rows.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, depth, 2 if colour else 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + _chunk(b"IEND", b""))


def write(path, image: np.ndarray) -> Path:
    """Write :func:`encode` of ``image`` to ``path``."""
    path = Path(path)
    path.write_bytes(encode(image))
    return path


# ------------------------------------------------------------------ decode
def _chunks(data: bytes, name: str):
    """``(kind, payload)`` of every chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise MetadataError(f"{name}: not a PNG (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise MetadataError(f"{name}: truncated chunk header at byte {pos}")
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + n
        if end + 4 > len(data):
            raise MetadataError(f"{name}: chunk {kind!r} runs past the file")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack_from(">I", data, end)
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise MetadataError(f"{name}: CRC mismatch in chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise MetadataError(f"{name}: no IEND chunk")


def _header(payload: bytes, name: str) -> tuple[int, int, int, int]:
    """``(height, width, bit depth, colour type)`` of an IHDR, refusing what
    the decoder does not take."""
    if len(payload) != 13:
        raise MetadataError(f"{name}: IHDR of {len(payload)} bytes")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
    if ctype not in COLOR_TYPES:
        raise MetadataError(f"{name}: unknown PNG colour type {ctype}")
    if ctype == 3:
        raise NotSupportedError(f"{name}: palette PNG images are not supported")
    if interlace:
        raise NotSupportedError(f"{name}: Adam7-interlaced PNG images are not supported")
    if depth not in (8, 16):
        raise NotSupportedError(
            f"{name}: {depth}-bit {COLOR_TYPES[ctype][1]} PNG images are not supported "
            "(8 and 16 bits only)")
    if comp or filt:
        raise MetadataError(f"{name}: unknown compression {comp} / filter method {filt}")
    if w == 0 or h == 0:
        raise MetadataError(f"{name}: empty image {w}x{h}")
    return h, w, depth, ctype


def _paeth_row(x: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Paeth filter of one row (a byte lane per sample byte)."""
    out = np.zeros(len(x) + bpp, np.int32)
    up = np.concatenate([np.zeros(bpp, np.int32), prior.astype(np.int32)])
    xs = x.astype(np.int32)
    for i in range(0, len(x), bpp):
        a = out[i:i + bpp]
        b = up[i + bpp:i + 2 * bpp]
        c = up[i:i + bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out[i + bpp:i + 2 * bpp] = (xs[i:i + bpp] + pred) & 0xFF
    return out[bpp:].astype(np.uint8)


def _average_row(x: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Average filter of one row."""
    out = np.zeros(len(x) + bpp, np.int32)
    up = prior.astype(np.int32)
    xs = x.astype(np.int32)
    for i in range(0, len(x), bpp):
        pred = (out[i:i + bpp] + up[i:i + bpp]) >> 1
        out[i + bpp:i + 2 * bpp] = (xs[i:i + bpp] + pred) & 0xFF
    return out[bpp:].astype(np.uint8)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """``(h, stride)`` bytes of the image from the decompressed rows."""
    if len(raw) < h * (stride + 1):
        raise MetadataError(f"{name}: image data ends after {len(raw)} of "
                            f"{h * (stride + 1)} bytes")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, x = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = x
        elif kind == 1:  # Sub: a running sum per byte lane
            lanes = x.reshape(-1, bpp).astype(np.uint64)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = x + prior  # uint8 arithmetic wraps modulo 256
        elif kind == 3:
            cur = _average_row(x, prior, bpp)
        elif kind == 4:
            cur = _paeth_row(x, prior, bpp)
        else:
            raise MetadataError(f"{name}: row {y} has unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def decode(data: bytes, name: str = "PNG") -> np.ndarray:
    """The pixels of a PNG file's bytes, as ``cv2.imread(...,
    IMREAD_UNCHANGED)`` gives them (module docstring)."""
    header = None
    idat = []
    for kind, payload in _chunks(data, name):
        if header is None:
            if kind != b"IHDR":
                raise MetadataError(f"{name}: first chunk is {kind!r}, not IHDR")
            header = _header(payload, name)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IHDR":
            raise MetadataError(f"{name}: a second IHDR chunk")
        elif kind == b"tRNS":
            raise NotSupportedError(f"{name}: PNG transparency chunks (tRNS) are not supported")
        elif kind not in (b"PLTE", b"IEND") and not kind[0] & 0x20:
            # an unknown critical chunk; a PLTE beside colour is a suggested
            # palette (palette images were refused with the header)
            raise NotSupportedError(f"{name}: PNG chunk {kind.decode('latin-1')!r} is not "
                                    "supported")
    if header is None:
        raise MetadataError(f"{name}: no IHDR chunk")
    if not idat:
        raise MetadataError(f"{name}: no image data (IDAT)")
    h, w, depth, ctype = header
    samples = COLOR_TYPES[ctype][0]
    bps = depth // 8
    stride = w * samples * bps
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), h * (stride + 1) + 1)
    except zlib.error as e:
        raise MetadataError(f"{name}: corrupt image data ({e})") from None
    plane = _unfilter(raw, h, stride, samples * bps, name)
    img = (plane.view(">u2").astype(np.uint16) if depth == 16 else plane)
    img = img.reshape(h, w, samples)
    if ctype == 0:
        return np.ascontiguousarray(img[..., 0])
    if ctype == 4:  # grey + alpha -> BGRA, as libpng's gray_to_rgb gives cv2
        return np.ascontiguousarray(img[..., [0, 0, 0, 1]])
    order = [2, 1, 0] if ctype == 2 else [2, 1, 0, 3]
    return np.ascontiguousarray(img[..., order])


def read(path) -> np.ndarray:
    """:func:`decode` of the file at ``path``."""
    path = Path(path)
    return decode(path.read_bytes(), path.name)


def info(path) -> tuple[int, int, int, int]:
    """``(height, width, bit depth, colour type)`` from the file's header
    alone; refuses what :func:`decode` refuses in the header."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE:
        raise MetadataError(f"{path.name}: not a PNG (bad signature)")
    if len(head) < 33 or head[12:16] != b"IHDR":
        raise MetadataError(f"{path.name}: no IHDR chunk")
    return _header(head[16:29], path.name)


def is_png(path) -> bool:
    """Whether the file starts with the PNG signature."""
    try:
        with open(path, "rb") as f:
            return f.read(8) == SIGNATURE
    except OSError:
        return False


def to_gray(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_BGR2GRAY)`` of an ``(H, W, 3|4)`` uint8
    or uint16 BGR(A) image: cv2's 15-bit fixed-point weights, rounded."""
    img = np.asarray(image)
    if img.ndim != 3 or img.shape[2] not in (3, 4) or img.dtype not in (np.uint8, np.uint16):
        raise NotSupportedError(f"to_gray takes (H, W, 3|4) uint8/uint16, got "
                                f"{img.shape} {img.dtype}")
    x = img.astype(np.int64)
    b, g, r = GRAY_WEIGHTS
    out = (x[..., 0] * b + x[..., 1] * g + x[..., 2] * r + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT
    return out.astype(img.dtype)

