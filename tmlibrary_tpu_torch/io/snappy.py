"""Raw snappy decompression in pure Python.

Parquet pages that ``pandas``/``pyarrow`` write are snappy-compressed by
default (the raw format, no framing).  The port's target machine has no
snappy binding, so :func:`decompress` reads the format directly: a
varint of the uncompressed length, then elements whose tag byte's low
two bits say what follows:

- ``00`` a literal: its length minus one in the tag's upper six bits,
  or (values 60-63) in the next 1-4 bytes, little-endian;
- ``01`` a copy of 4-11 bytes at an 11-bit offset (3 bits in the tag,
  8 in the next byte);
- ``10`` a copy of 1-64 bytes at a 16-bit little-endian offset;
- ``11`` the same with a 32-bit offset.

A copy whose offset is shorter than its length repeats the bytes it has
just written (run-length encoding by overlap).
"""

from __future__ import annotations


class SnappyError(ValueError):
    """The input is not a valid raw snappy stream."""


def _varint(buf, pos: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise SnappyError("truncated length preamble")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise SnappyError("length preamble longer than 5 bytes")


def decompress(data: bytes) -> bytes:
    """The bytes a raw snappy stream encodes."""
    buf = memoryview(data)
    n, pos = _varint(buf, 0)
    out = bytearray()
    end = len(buf)
    while pos < end:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                if pos + extra > end:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(buf[pos:pos + extra], "little")
                pos += extra
            length += 1
            if pos + length > end:
                raise SnappyError("literal runs past the input")
            out += buf[pos:pos + length]
            pos += length
            continue
        if kind == 1:
            if pos + 1 > end:
                raise SnappyError("truncated copy")
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        else:
            width = 2 if kind == 2 else 4
            if pos + width > end:
                raise SnappyError("truncated copy")
            length = 1 + (tag >> 2)
            offset = int.from_bytes(buf[pos:pos + width], "little")
            pos += width
        if offset == 0 or offset > len(out):
            raise SnappyError(f"copy offset {offset} outside the {len(out)} bytes written")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:
            # the copy overlaps its own output: the last `offset` bytes repeat
            pattern = bytes(out[start:])
            reps, rest = divmod(length, offset)
            out += pattern * reps + pattern[:rest]
    if len(out) != n:
        raise SnappyError(f"stream decodes to {len(out)} bytes, preamble says {n}")
    return bytes(out)
