"""PNG without ``cv2``: the port's codec for tiles, probes and ingest.

The JAX package writes illuminati's tiles with ``cv2.imwrite``, decodes
PNG planes in imextract with ``cv2.imread(..., IMREAD_UNCHANGED)`` and
``cvtColor(..., COLOR_BGR2GRAY)``, and probes a site's shape with
``cv2.imread``.  The port's target machine has no ``cv2``, so this module
reads and writes the format itself with ``zlib``:

- :func:`encode` / :func:`write` take 8- or 16-bit greyscale ``(H, W)``,
  BGR ``(H, W, 3)`` and BGRA ``(H, W, 4)`` arrays and write one ``IDAT``
  of rows with filter type 0.  The bytes are not cv2's; the decoded
  pixels are the array's.
- :func:`decode` / :func:`read` take every colour type at every bit depth
  libpng takes (greyscale at 1, 2, 4, 8 and 16 bits, palette at 1, 2, 4
  and 8, RGB, greyscale with alpha and RGBA at 8 and 16), plain or
  Adam7-interlaced (each pass its own filtered rows), any of the five
  filter types (undone in ``csrc/host/raster.cpp``), any number of
  ``IDAT`` chunks, and give what ``cv2.imread(path, IMREAD_UNCHANGED)``
  gives through libpng 1.6's transforms: ``(H, W)`` for greyscale (1, 2
  and 4 bits scaled to 8 as ``expand_gray_1_2_4_to_8`` scales them, a
  ``tRNS`` chunk ignored), ``(H, W, 3)`` BGR for RGB and palette images
  (palette entries past ``PLTE`` black), ``(H, W, 4)`` BGRA for RGBA, for
  greyscale with alpha (the grey value in B, G and R), and for RGB and
  palette images with ``tRNS`` (the key colour transparent; palette
  entries past ``tRNS`` opaque).  A ``tRNS`` chunk libpng drops (of the
  wrong size, out of place, a second one) is dropped.
- :func:`to_gray` is ``cvtColor(img, COLOR_BGR2GRAY)``: cv2's fixed-point
  rule, ``(3735 B + 19235 G + 9798 R + 2**14) >> 15``, the alpha channel
  ignored.
- :func:`info` reads the header alone (the site-shape probe).

Ancillary chunks other than ``tRNS`` are skipped, and so is the
suggested palette (``PLTE``) of a colour image.  Unknown critical chunks
raise :class:`~tmlibrary_tpu_torch.errors.NotSupportedError` naming the
chunk; a bad signature, CRC, bit depth or stream raises
:class:`~tmlibrary_tpu_torch.errors.MetadataError`, as libpng fails there.
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


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


# ------------------------------------------------------------------ encode
def encode(image: np.ndarray) -> bytes:
    """PNG bytes of an ``(H, W)`` greyscale, ``(H, W, 3)`` BGR or ``(H, W,
    4)`` BGRA image of uint8 or uint16, written as grey, RGB or RGBA as
    ``cv2.imwrite`` takes it (``zlib`` at level 1, cv2's default)."""
    img = np.asarray(image)
    channels = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if channels not in (1, 3, 4) or img.dtype not in (np.uint8, np.uint16):
        raise NotSupportedError(
            "PNG encode takes (H, W), (H, W, 3) BGR or (H, W, 4) BGRA of uint8 or uint16, "
            f"got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise NotSupportedError(f"PNG encode of an empty image {img.shape}")
    depth = 8 if img.dtype == np.uint8 else 16
    if channels > 1:
        img = img[..., [2, 1, 0, 3][:channels]]  # BGR(A) -> the file's RGB(A)
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else "u1").view(np.uint8)
    raw = np.zeros((h, 1 + rows.reshape(h, -1).shape[1]), np.uint8)  # column 0: filter 0
    raw[:, 1:] = rows.reshape(h, -1)
    ctype = {1: 0, 3: 2, 4: 6}[channels]
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + _chunk(b"IEND", b""))


def write(path, image: np.ndarray) -> Path:
    """Write :func:`encode` of ``image`` to ``path``."""
    path = Path(path)
    path.write_bytes(encode(image))
    return path


# ------------------------------------------------------------------ decode
#: bit depths libpng takes for each colour type
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
#: Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


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


def _header(payload: bytes, name: str) -> tuple[int, int, int, int, int]:
    """``(height, width, bit depth, colour type, interlace)`` of an IHDR,
    refusing what libpng refuses."""
    if len(payload) != 13:
        raise MetadataError(f"{name}: IHDR of {len(payload)} bytes")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
    if ctype not in COLOR_TYPES:
        raise MetadataError(f"{name}: unknown PNG colour type {ctype}")
    if depth not in DEPTHS[ctype]:
        raise MetadataError(f"{name}: a {depth}-bit {COLOR_TYPES[ctype][1]} PNG (libpng takes "
                            f"{', '.join(map(str, DEPTHS[ctype]))} bits)")
    if comp or filt or interlace > 1:
        raise MetadataError(f"{name}: unknown compression {comp} / filter method {filt} / "
                            f"interlace method {interlace}")
    if w == 0 or h == 0:
        raise MetadataError(f"{name}: empty image {w}x{h}")
    return h, w, depth, ctype, interlace


def _samples(plane: np.ndarray, h: int, w: int, spp: int, depth: int) -> np.ndarray:
    """``(h, w, spp)`` samples of unfiltered rows (uint8 below 16 bits)."""
    if depth == 16:
        return plane.view(">u2").astype(np.uint16)[:, :w * spp].reshape(h, w, spp)
    if depth == 8:
        return plane[:, :w * spp].reshape(h, w, spp)
    bits = np.unpackbits(plane, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :, None]


def _pixels(raw: bytes, h: int, w: int, depth: int, spp: int, interlace: int,
            name: str) -> np.ndarray:
    """The ``(h, w, spp)`` samples of the decompressed image data, pass by
    pass for Adam7 (each pass its own filtered rows; an empty pass has
    none)."""
    from tmlibrary_tpu_torch import native

    bpp = max(1, depth * spp // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.empty((h, w, spp), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0
        if pw == 0 or ph == 0:
            continue
        stride = -(-pw * spp * depth // 8)
        need = ph * (stride + 1)
        if at + need > len(raw):
            raise MetadataError(f"{name}: image data ends after {len(raw)} of "
                                f"{at + need} bytes")
        try:
            plane = native.png_unfilter(raw[at:at + need], ph, stride, bpp)
        except ValueError as e:
            raise MetadataError(f"{name}: {e}") from None
        at += need
        out[y0::dy, x0::dx] = _samples(plane, ph, pw, spp, depth)
    return out


def _need(h: int, w: int, depth: int, spp: int, interlace: int) -> int:
    """Bytes of decompressed image data the header asks for."""
    total = 0
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0
        if pw and ph:
            total += ph * (1 + -(-pw * spp * depth // 8))
    return total


def decode(data: bytes, name: str = "PNG") -> np.ndarray:
    """The pixels of a PNG file's bytes, as ``cv2.imread(...,
    IMREAD_UNCHANGED)`` gives them through libpng (module docstring)."""
    header = None
    idat = []
    plte = trns = None
    for kind, payload in _chunks(data, name):
        if header is None:
            if kind != b"IHDR":
                raise MetadataError(f"{name}: first chunk is {kind!r}, not IHDR")
            header = _header(payload, name)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IHDR":
            raise MetadataError(f"{name}: a second IHDR chunk")
        elif kind == b"PLTE":
            if idat:
                raise MetadataError(f"{name}: PLTE after IDAT")
            if plte is None:
                if header[3] == 3 and (len(payload) % 3 or not payload):
                    raise MetadataError(f"{name}: invalid PLTE of {len(payload)} bytes")
                plte = payload
        elif kind == b"tRNS":
            # what libpng keeps: the first, before IDAT, of the colour
            # type's size (a palette's after PLTE, at most its entries)
            ctype = header[3]
            ok = not idat and trns is None and (
                (ctype == 0 and len(payload) == 2) or (ctype == 2 and len(payload) == 6)
                or (ctype == 3 and plte is not None
                    and 0 < len(payload) <= min(len(plte) // 3, 1 << header[2])))
            if ok:
                trns = payload
        elif kind != b"IEND" and not kind[0] & 0x20:  # an unknown critical chunk
            raise NotSupportedError(f"{name}: PNG chunk {kind.decode('latin-1')!r} is not "
                                    "supported")
    if header is None:
        raise MetadataError(f"{name}: no IHDR chunk")
    h, w, depth, ctype, interlace = header
    if ctype == 3 and plte is None:
        raise MetadataError(f"{name}: a palette image without PLTE")
    if not idat:
        raise MetadataError(f"{name}: no image data (IDAT)")
    spp = COLOR_TYPES[ctype][0]
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat),
                                              _need(h, w, depth, spp, interlace) + 1)
    except zlib.error as e:
        raise MetadataError(f"{name}: corrupt image data ({e})") from None
    img = _pixels(raw, h, w, depth, spp, interlace, name)
    if ctype == 0:  # libpng's expand_gray_1_2_4_to_8 scales low depths
        grey = img[..., 0]
        return grey * np.uint8({1: 255, 2: 85, 4: 17}[depth]) if depth < 8 else \
            np.ascontiguousarray(grey)
    if ctype == 4:  # grey + alpha -> BGRA, as libpng's gray_to_rgb gives cv2
        return np.ascontiguousarray(img[..., [0, 0, 0, 1]])
    if ctype == 3:  # palette_to_rgb: a palette of 256 entries, zero past its own
        n = min(len(plte) // 3, 1 << depth)
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[:n, :3] = np.frombuffer(plte, np.uint8, 3 * n).reshape(n, 3)[:, ::-1]
        if trns is None:
            return table[:, :3][img[..., 0]]
        table[:len(trns), 3] = np.frombuffer(trns, np.uint8)
        return table[img[..., 0]]
    order = [2, 1, 0] if ctype == 2 else [2, 1, 0, 3]
    out = np.ascontiguousarray(img[..., order])
    if ctype == 2 and trns is not None:  # tRNS_to_alpha: the key colour transparent
        key = np.array(struct.unpack(">3H", trns), np.int64)
        if depth == 8:
            key &= 0xFF
        opaque = (img != key.astype(img.dtype)).any(axis=2)
        alpha = np.where(opaque, np.iinfo(img.dtype).max, 0).astype(img.dtype)
        return np.ascontiguousarray(np.concatenate([out, alpha[..., None]], axis=2))
    return out


def read(path) -> np.ndarray:
    """:func:`decode` of the file at ``path``."""
    path = Path(path)
    return decode(path.read_bytes(), path.name)


def info(path) -> tuple[int, int, int, int]:
    """``(height, width, bit depth, colour type)`` from the file's header
    alone (the site-shape probe); refuses what :func:`decode` refuses in
    the header."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE:
        raise MetadataError(f"{path.name}: not a PNG (bad signature)")
    if len(head) < 33 or head[12:16] != b"IHDR":
        raise MetadataError(f"{path.name}: no IHDR chunk")
    return _header(head[16:29], path.name)[:4]


def is_png(path) -> bool:
    """Whether the file starts with the PNG signature."""
    try:
        with open(path, "rb") as f:
            return f.read(8) == SIGNATURE
    except OSError:
        return False


def gray14(b, g, r) -> np.ndarray:
    """OpenCV imgcodecs' own grey of B, G, R samples (``icvCvt_BGR2Gray``,
    which its BMP, TIFF and PAM decoders call; not ``cvtColor``'s):
    ``(1868 B + 9617 G + 4899 R + 2**13) >> 14`` as int64."""
    return ((np.asarray(b).astype(np.int64) * 1868 + np.asarray(g).astype(np.int64) * 9617
             + np.asarray(r).astype(np.int64) * 4899 + 8192) >> 14)


def to_gray(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_BGR2GRAY)`` of an ``(H, W, 3|4)`` BGR(A)
    image, the alpha channel dropped: uint8 and uint16 with cv2's 15-bit
    fixed-point weights, rounded; float32 with its float weights, bit for
    bit as cv2 rounds them (:func:`tmlibrary_tpu_torch.native.bgr2gray_int`,
    :func:`~tmlibrary_tpu_torch.native.bgr2gray_f32`).
    Other dtypes raise, as ``cvtColor`` does."""
    img = np.asarray(image)
    if img.ndim != 3 or img.shape[2] not in (3, 4) or \
            img.dtype not in (np.uint8, np.uint16, np.float32):
        raise NotSupportedError(f"to_gray takes (H, W, 3|4) uint8/uint16/float32, got "
                                f"{img.shape} {img.dtype}")
    from tmlibrary_tpu_torch import native

    return native.bgr2gray_f32(img) if img.dtype == np.float32 else native.bgr2gray_int(img)
