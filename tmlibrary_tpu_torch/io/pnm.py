"""PBM, PGM, PPM and PAM without ``cv2``: the port's Netpbm codec.

The JAX package reads these through ``cv2.imread(path,
IMREAD_UNCHANGED)`` and writes ``.pbm``, ``.pgm``, ``.ppm`` and ``.pnm``
through ``cv2.imwrite``.  This module follows OpenCV 5.0's
``PxMDecoder``/``PxMEncoder`` (``grfmt_pxm.cpp``) and ``PAMDecoder``
(``grfmt_pam.cpp``):

- :func:`decode` takes P1-P6, ASCII and binary, and P7 (PAM).  P1/P4 give
  0 for a set bit and 255 for a clear one.  ASCII 8-bit samples are
  scaled as ``v * 255 // maxval`` after a value above ``maxval`` is cut
  to it; binary 8-bit samples and every 16-bit sample (``maxval`` above
  255) are returned as stored, 16-bit big-endian in the file.  P3/P6 come
  back BGR.  A number is read as cv2's ``ReadNumber`` reads it (spaces and
  ``#`` comments before it, one byte after it), so an ASCII file that ends
  right after its last digit fails, as there.  PAM gives its tuples as
  stored (``DEPTH`` channels, no colour swap, no scaling; ``MAXVAL 1``
  reads each row's first bits, a set bit 255 in every channel; without
  ``TUPLTYPE`` only 1 or 3 channels of 8 bits).  What cv2 does not read
  raises :class:`~tmlibrary_tpu_torch.errors.MetadataError`.
- :func:`encode` writes binary P4, P5 or P6 as cv2 does: P4 sets the bit
  of every zero pixel, P5/P6 carry ``maxval`` 255 or 65535.
- :func:`info` reads the header alone (the site-shape probe).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.errors import MetadataError

_SPACE = b" \t\n\v\f\r"
#: PAM tuple types cv2 reads, with their depths
_TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
              b"RGB_ALPHA": 4}


class _Stream:
    """A byte stream read as cv2's ``RLByteStream``: reading past the end
    fails."""

    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise MetadataError(f"{self.name}: unexpected end of the Netpbm data")
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self, maxdigits: int = 0) -> int:
        """cv2's ``ReadNumber``: spaces and comments skipped, digits read,
        then one byte more unless ``maxdigits`` stopped it."""
        code = self.byte()
        while not 48 <= code <= 57:
            if code == 35:  # '#': to the end of the line
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise MetadataError(f"{self.name}: unexpected byte {code:#x} where a number "
                                    "was due")
        val = digits = 0
        while True:
            val = val * 10 + code - 48
            if val > 2**31 - 1:
                raise MetadataError(f"{self.name}: a number past 2^31")
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            code = self.byte()
            if not 48 <= code <= 57:
                break
        return val


def _header(data: bytes, name: str) -> dict:
    """The header fields of a P1-P7 file; raises where cv2's fails."""
    if len(data) < 3 or data[0] != 80 or not 49 <= data[1] <= 55 or data[2] not in _SPACE:
        raise MetadataError(f"{name}: not a Netpbm file (bad signature)")
    kind = data[1] - 48
    if kind == 7:
        return _pam_header(data, name)
    s = _Stream(data, name)
    s.pos = 2
    width, height = s.number(), s.number()
    maxval = s.number() if kind not in (1, 4) else 1
    if not (width > 0 and height > 0 and 0 < maxval < 1 << 16):
        raise MetadataError(f"{name}: a {width}x{height} P{kind} of maxval {maxval}")
    channels = 3 if kind in (3, 6) else 1
    return {"kind": kind, "width": width, "height": height, "maxval": maxval,
            "channels": channels, "offset": s.pos}


def _pam_header(data: bytes, name: str) -> dict:
    """A PAM header: ``WIDTH``, ``HEIGHT``, ``DEPTH``, ``MAXVAL``,
    ``TUPLTYPE`` lines up to ``ENDHDR``, ``#`` comment lines skipped."""
    fields: dict = {}
    pos = 3
    while True:
        end = data.find(b"\n", pos)
        if end < 0:
            raise MetadataError(f"{name}: a PAM header without ENDHDR")
        line = data[pos:end].strip()
        pos = end + 1
        if not line or line.startswith(b"#"):
            continue
        key, _, value = line.partition(b" ")
        if key == b"ENDHDR":
            break
        fields[key] = value.strip()
    try:
        width, height = int(fields[b"WIDTH"]), int(fields[b"HEIGHT"])
        depth, maxval = int(fields[b"DEPTH"]), int(fields[b"MAXVAL"])
    except (KeyError, ValueError):
        raise MetadataError(f"{name}: a PAM header without WIDTH, HEIGHT, DEPTH and "
                            "MAXVAL") from None
    tupl = fields.get(b"TUPLTYPE")
    if tupl is None:  # cv2 guesses grey or RGB of 8 bits
        ok = depth in (1, 3) and maxval < 256
    else:  # an alpha channel needs more than one bit
        ok = _TUPLTYPES.get(tupl) == depth and (maxval > 1 or depth in (1, 3))
    if not (ok and width > 0 and height > 0 and 0 < maxval < 1 << 16):
        raise MetadataError(f"{name}: a PAM of {width}x{height}, depth {depth}, maxval "
                            f"{maxval}, tuple type {tupl!r} (cv2 reads none)")
    return {"kind": 7, "width": width, "height": height, "maxval": maxval,
            "channels": depth, "offset": pos}


def info(path) -> tuple[int, int]:
    """``(height, width)`` from the header alone."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(4096)
    h = _header(head, path.name)
    return h["height"], h["width"]


def _ascii_numbers(body: bytes, count: int, name: str, single: bool) -> np.ndarray:
    """The first ``count`` numbers of an ASCII body as ``ReadNumber``
    reads them: ``single`` takes one digit at a time (P1)."""
    text = re.sub(rb"#[^\n\r]*[\n\r]", b" ", body)
    if b"#" in text:
        raise MetadataError(f"{name}: unexpected end of the Netpbm data in a comment")
    if single:
        digits = text.translate(None, _SPACE)
        if len(digits) < count:
            raise MetadataError(f"{name}: unexpected end of the Netpbm data")
        vals = np.frombuffer(digits[:count], np.uint8)
        if ((vals < 48) | (vals > 57)).any():
            raise MetadataError(f"{name}: a byte other than a digit in P1 data")
        return (vals - 48).astype(np.int64)
    tokens = text.split(None, count)
    numbers = tokens[:count]
    # ReadNumber reads one byte past each number: the last needs a byte after it
    if len(numbers) < count or (len(tokens) == count and not text[-1:].isspace()):
        raise MetadataError(f"{name}: unexpected end of the Netpbm data")
    try:
        vals = np.array(numbers, dtype=np.bytes_).astype(np.int64)
    except ValueError:
        raise MetadataError(f"{name}: a token other than a number in ASCII data") from None
    if (vals > 2**31 - 1).any():
        raise MetadataError(f"{name}: a number past 2^31")
    return vals


def decode(data: bytes, name: str = "PNM") -> np.ndarray:
    """The pixels of a P1-P7 file's bytes as ``cv2.imread(...,
    IMREAD_UNCHANGED)`` gives them (module docstring)."""
    h = _header(data, name)
    kind, width, height, maxval, ch = (h["kind"], h["width"], h["height"], h["maxval"],
                                       h["channels"])
    body = data[h["offset"]:]
    wide = maxval > 255
    n = width * height * ch
    if kind == 7 and maxval == 1:  # each row's first bits, a set bit 255 in every channel
        if len(body) < n:
            raise MetadataError(f"{name}: unexpected end of the PAM data")
        rows = np.frombuffer(body, np.uint8, n).reshape(height, width * ch)
        bits = np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255)
        return bits if ch == 1 else np.repeat(bits[:, :, None], ch, axis=2)
    if kind in (1, 4):
        if kind == 1:
            bits = _ascii_numbers(body, n, name, True) != 0
        else:
            pitch = -(-width // 8)
            if len(body) < pitch * height:
                raise MetadataError(f"{name}: unexpected end of the P4 data")
            rows = np.frombuffer(body, np.uint8, pitch * height).reshape(height, pitch)
            bits = np.unpackbits(rows, axis=1)[:, :width]
        return np.where(bits.reshape(height, width) != 0, 0, 255).astype(np.uint8)
    if kind in (2, 3):
        vals = np.minimum(_ascii_numbers(body, n, name, False), maxval)
        out = (vals if wide else vals * 255 // maxval).astype(np.uint16 if wide else np.uint8)
    else:
        size = n * (2 if wide else 1)
        if len(body) < size:
            raise MetadataError(f"{name}: unexpected end of the P{kind} data")
        out = np.frombuffer(body, ">u2" if wide else np.uint8, n).astype(
            np.uint16 if wide else np.uint8)
    out = out.reshape(height, width, ch)
    if ch == 1:
        return out[:, :, 0]
    return np.ascontiguousarray(out[:, :, ::-1] if kind in (3, 6) else out)


def read(path) -> np.ndarray:
    """:func:`decode` of the file at ``path``."""
    path = Path(path)
    return decode(path.read_bytes(), path.name)


def is_pnm(path) -> bool:
    """Whether the file starts as cv2's Netpbm decoders check: ``P1`` to
    ``P7`` and a space."""
    try:
        with open(path, "rb") as f:
            head = f.read(3)
    except OSError:
        return False
    return len(head) == 3 and head[0] == 80 and 49 <= head[1] <= 55 and head[2] in _SPACE


def encode(image: np.ndarray, kind: int) -> bytes:
    """Binary Netpbm bytes of ``image`` as cv2 writes them: ``kind`` 4
    (PBM: a set bit for every zero pixel), 5 (PGM) or 6 (PPM, from BGR);
    uint8 or uint16 (``maxval`` 255 or 65535)."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    head = f"P{kind}\n{w} {h}\n".encode()
    if kind == 4:
        return head + np.packbits(img.reshape(h, w) == 0, axis=1).tobytes()
    wide = img.dtype == np.uint16
    px = img[:, :, ::-1] if kind == 6 else img
    return (head + (b"65535\n" if wide else b"255\n")
            + np.ascontiguousarray(px, ">u2" if wide else np.uint8).tobytes())
