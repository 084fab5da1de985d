"""Image readers of the port: the TIFF half.

Counterpart: ``tmlibrary_tpu/readers.py`` (reference ``tmlib/readers.py``):
the Python TIFF reader that imextract uses for the pages the C++ reader
(:mod:`tmlibrary_tpu_torch.native`) declines -- BigTIFF and deflate
strips -- with its bounded parse cache (``:193-265``), the IFD walk and
strip decode shared with it (``:1936-2113``, ``:2480-2525``), and the
container entry points imextract and metaconfig call first
(``read_container_plane``, ``container_dimensions``, ``:157-190``).

Of the containers the port reads OME-NGFF (``.zarr`` directories,
through :class:`tmlibrary_tpu_torch.ngff.NGFFReader`); every other
suffix the JAX package maps to a container reader (``.nd2 .czi .lif .dv
.r3d .ims .stk .lsm .oib .oif .flex``) raises
:class:`~tmlibrary_tpu_torch.errors.NotSupportedError` naming the
ROADMAP item that ports them (:data:`CONTAINER_ITEM`).  The JAX package
decodes a TIFF-flavoured container (``.stk .lsm .flex``) that its reader
declines as a plain TIFF; that needs the reader to decline it, so the
port raises there too.  A plain ``.tif``/``.png`` gives None, as in the
JAX package.
"""

from __future__ import annotations

import collections
import mmap
import os
import struct
import threading
import zlib

import numpy as np

from tmlibrary_tpu_torch import native
from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError

#: the ROADMAP item that ports the container readers other than OME-NGFF
CONTAINER_ITEM = "ROADMAP A item 12"

#: container suffix -> the format the JAX package reads it as
CONTAINER_SUFFIXES = {
    ".nd2": "Nikon ND2", ".czi": "Zeiss CZI", ".lif": "Leica LIF",
    ".dv": "DeltaVision", ".r3d": "DeltaVision", ".ims": "Imaris IMS",
    ".stk": "MetaMorph STK", ".lsm": "Zeiss LSM", ".oib": "Olympus OIB",
    ".oif": "Olympus OIF", ".flex": "Opera FLEX", ".zarr": "OME-NGFF",
}


def container_format(path) -> "str | None":
    """The container format the JAX package would read ``path`` as, or
    None for a plain image."""
    name = str(path).lower()
    return next((fmt for suf, fmt in CONTAINER_SUFFIXES.items() if name.endswith(suf)), None)


def _refuse_container(path) -> None:
    fmt = container_format(path)
    if fmt is not None and fmt != "OME-NGFF":
        raise NotSupportedError(
            f"{path}: {fmt} containers are not read by the port yet ({CONTAINER_ITEM})")


#: (path, mtime_ns, size) -> open NGFF reader: imextract reads a plate
#: plane by plane, and each open parses every well's and field's metadata
_OPEN_NGFF: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()
_OPEN_NGFF_CAP = 64
_OPEN_NGFF_LOCK = threading.Lock()


def _ngff_reader(path):
    """The open :class:`~tmlibrary_tpu_torch.ngff.NGFFReader` of an
    OME-NGFF directory, cached on its path and modification time."""
    from tmlibrary_tpu_torch.ngff import NGFFReader

    st = os.stat(path)
    key = (str(path), st.st_mtime_ns, st.st_size)
    with _OPEN_NGFF_LOCK:
        reader = _OPEN_NGFF.get(key)
    if reader is None:
        reader = NGFFReader(path).__enter__()
        with _OPEN_NGFF_LOCK:
            while len(_OPEN_NGFF) >= _OPEN_NGFF_CAP:
                _OPEN_NGFF.popitem(last=False)
            reader = _OPEN_NGFF.setdefault(key, reader)
    return reader


def read_container_plane(path, page: int) -> "np.ndarray | None":
    """One container plane by linear page index; None for a plain image.
    OME-NGFF directories are read (``NGFFReader.read_plane_linear``);
    every other container raises :class:`NotSupportedError`."""
    _refuse_container(path)
    if container_format(path) is None:
        return None
    return _ngff_reader(path).read_plane_linear(page)


def container_dimensions(path) -> "tuple[int, int] | None":
    """(height, width) of a container's planes, or None for a plain image
    (metaconfig's site-shape probe); containers other than OME-NGFF raise."""
    _refuse_container(path)
    if container_format(path) is None:
        return None
    from tmlibrary_tpu_torch.ngff import NGFFReader

    with NGFFReader(path) as r:
        return r.height, r.width


# ---------------------------------------------------------------- TIFF walk
#: TIFF value-type sizes (BYTE, ASCII, SHORT, LONG, RATIONAL, signed/float,
#: IFD, and the BigTIFF 8-byte types LONG8/SLONG8/IFD8)
_TIFF_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
                   10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}


def _tiff_parse(buf, spans: "list | None" = None) -> tuple[str, list[dict]]:
    """IFD walk over an in-memory buffer -- classic (magic 42) and BigTIFF
    (magic 43, 8-byte offsets and counts, 20-byte entries).

    Returns ``(byteorder, ifds)``, each IFD ``{tag: (type, count,
    value_data_offset)}`` with the value offset resolved at parse time
    (inline when the value fits the entry's value field, else the pointer
    dereferenced).  When ``spans`` is a list, the byte range of every IFD
    table walked is appended to it (the parse cache's freshness key)."""
    bo = {b"II": "<", b"MM": ">"}.get(bytes(buf[0:2]))
    if bo is None or len(buf) < 8:
        raise MetadataError("not a TIFF (bad byte-order mark)")
    (magic,) = struct.unpack_from(bo + "H", buf, 2)
    if magic == 42:
        big = False
        (off,) = struct.unpack_from(bo + "I", buf, 4)
    elif magic == 43:
        if len(buf) < 16:
            raise MetadataError("truncated BigTIFF header")
        osize, zero = struct.unpack_from(bo + "HH", buf, 4)
        if osize != 8 or zero != 0:
            raise MetadataError(f"BigTIFF with unsupported offset size {osize}")
        big = True
        (off,) = struct.unpack_from(bo + "Q", buf, 8)
    else:
        raise MetadataError(f"not a TIFF (magic {magic})")
    # (IFD-count fmt, entry-count fmt, entry size, value-field offset
    # within an entry, inline capacity, offset fmt)
    nfmt, cfmt, esize, vfield, inline, off_fmt = (
        ("Q", "Q", 20, 12, 8, "Q") if big else ("H", "I", 12, 8, 4, "I")
    )
    csize = struct.calcsize(nfmt)
    ifds: list[dict] = []
    seen: set = set()
    while off and off not in seen and len(ifds) < 65535:
        seen.add(off)
        if off + csize > len(buf):
            break
        (n,) = struct.unpack_from(bo + nfmt, buf, off)
        p = off + csize
        nextsize = struct.calcsize(off_fmt)
        if n > (len(buf) - p) // esize or p + esize * n + nextsize > len(buf):
            break
        if spans is not None:
            spans.append((off, p + esize * n + nextsize))
        entries: dict = {}
        for _ in range(n):
            tag, typ = struct.unpack_from(bo + "HH", buf, p)
            (cnt,) = struct.unpack_from(bo + cfmt, buf, p + 4)
            total = _TIFF_TYPE_SIZE.get(typ, 1) * cnt
            if total <= inline:
                voff = p + vfield
            else:
                (voff,) = struct.unpack_from(bo + off_fmt, buf, p + vfield)
            entries[tag] = (typ, cnt, voff)
            p += esize
        ifds.append(entries)
        (off,) = struct.unpack_from(bo + off_fmt, buf, p)
    if not ifds:
        raise MetadataError("TIFF contains no parseable IFD")
    return bo, ifds


def _tiff_value_offset(bo: str, buf, entry) -> int:
    """Offset of an entry's value data (resolved at parse time)."""
    return entry[2]


def _tiff_ints(bo: str, buf, entry, limit: "int | None" = None) -> list[int]:
    """Integer values of a BYTE/SHORT/LONG/LONG8 entry."""
    typ, cnt, _ = entry
    fmt = {1: "B", 3: "H", 4: "I", 16: "Q"}.get(typ)
    if fmt is None:
        return []
    if limit is not None:
        cnt = min(cnt, limit)
    base = _tiff_value_offset(bo, buf, entry)
    return list(struct.unpack_from(f"{bo}{cnt}{fmt}", buf, base))


def _tiff_int(bo: str, buf, ifd: dict, tag: int, default: int) -> int:
    entry = ifd.get(tag)
    if entry is None:
        return default
    vals = _tiff_ints(bo, buf, entry, limit=1)
    return vals[0] if vals else default


def _tiff_strips(bo: str, buf, ifd: dict, filename) -> tuple[list, list]:
    """StripOffsets/StripByteCounts of an IFD; a tiled or corrupt IFD
    raises :class:`MetadataError`."""
    try:
        offs = _tiff_ints(bo, buf, ifd[273])
        counts = _tiff_ints(bo, buf, ifd[279])
    except KeyError as exc:
        raise MetadataError(f"TIFF IFD without strip tags (tiled or corrupt): {filename}") \
            from exc
    except struct.error as exc:
        raise MetadataError(f"corrupt TIFF tag data in {filename}") from exc
    if not offs or len(offs) != len(counts):
        raise MetadataError(f"corrupt TIFF strip layout in {filename}")
    return offs, counts


def _decode_strip(chunk: bytes, compression: int, expect: int, filename) -> bytes:
    """One TIFF strip -> exactly ``expect`` decoded bytes."""
    if compression == 1:
        if len(chunk) < expect:
            raise MetadataError(f"truncated strip in {filename}")
        return chunk[:expect]
    if compression == 5:
        out = native.lzw_decode(chunk, expect)
    elif compression in (8, 32946):
        # Adobe deflate (8) and the old deflate id (32946): one zlib stream
        # a strip; max_length bounds the expansion, one byte past the
        # expectation so an oversized stream is rejected, not truncated
        try:
            raw = zlib.decompressobj().decompress(chunk, expect + 1)
        except zlib.error:
            raw = None
        out = raw if raw is not None and len(raw) == expect else None
    elif compression == 32773:
        out = native.packbits_decode(chunk, expect)
    else:
        raise NotSupportedError(f"unsupported TIFF compression {compression} in {filename}")
    if out is None:
        raise MetadataError(f"corrupt compressed strip in {filename}")
    return out


def _apply_predictor(plane: np.ndarray, predictor: int) -> np.ndarray:
    """TIFF predictor 2 (horizontal differencing): cumulative sum along
    rows with the sample width's wraparound."""
    if predictor == 2:
        return np.cumsum(plane.astype(np.uint32), axis=1).astype(plane.dtype)
    return plane


def _decode_ifd_plane(bo, buf, ifd, width, height, dtype, filename) -> np.ndarray:
    """Strip-decode one grayscale IFD to a ``(height, width)`` array."""
    compression = _tiff_int(bo, buf, ifd, 259, 1)
    predictor = _tiff_int(bo, buf, ifd, 317, 1)
    rows_per_strip = _tiff_int(bo, buf, ifd, 278, height)
    offs, counts = _tiff_strips(bo, buf, ifd, filename)
    row_bytes = width * dtype.itemsize
    raw = bytearray()
    rows_left = height
    for off, cnt in zip(offs, counts):
        rows = min(rows_per_strip, rows_left)
        raw += _decode_strip(bytes(buf[off:off + cnt]), compression, rows * row_bytes,
                             filename)
        rows_left -= rows
    if len(raw) < height * row_bytes:
        raise MetadataError(f"truncated TIFF plane in {filename}")
    plane = np.frombuffer(bytes(raw[:height * row_bytes]), dtype).reshape(height, width)
    return _apply_predictor(plane, predictor)


def _gray_ifd_plane(bo, buf, ifd, filename, what) -> np.ndarray:
    """Check one IFD is 8/16-bit single-sample grayscale and strip-decode
    it (``what`` names the caller's format in the error)."""
    width = _tiff_int(bo, buf, ifd, 256, 0)
    height = _tiff_int(bo, buf, ifd, 257, 0)
    bits = _tiff_int(bo, buf, ifd, 258, 8)
    samples = _tiff_int(bo, buf, ifd, 277, 1)
    if width <= 0 or height <= 0:
        raise MetadataError(f"corrupt TIFF dimensions in {filename}")
    if bits not in (8, 16) or samples != 1:
        raise NotSupportedError(
            f"{what} are 8/16-bit grayscale; got {bits}-bit x{samples} in {filename}")
    dtype = np.dtype(bo + ("u1" if bits == 8 else "u2"))
    return _decode_ifd_plane(bo, buf, ifd, width, height, dtype, filename)


# ------------------------------------------------------------- parse cache
#: path -> (stat key, span crcs, (byteorder, ifds)): a bounded LRU, so a
#: per-plane loop over a multi-page file walks its IFDs once, not once per
#: plane.  Shared by imextract's decode threads, so every mutation holds
#: the lock.
_TIFF_PY_PARSE_CACHE: "collections.OrderedDict[str, tuple]" = collections.OrderedDict()
_TIFF_PY_PARSE_CACHE_MAX = 64
_TIFF_PY_PARSE_LOCK = threading.Lock()


def _tiff_parse_spans_key(m, spans) -> tuple:
    """Freshness key of a cached parse: a crc per byte range the parse
    read (the header and every IFD table), so an in-place rewrite of the
    same size within one timestamp tick is seen too."""
    return tuple((s, e, zlib.crc32(m[s:e])) for s, e in [(0, min(len(m), 16))] + spans)


def read_tiff_page(path, page: int) -> np.ndarray:
    """Page ``page`` of an 8/16-bit grayscale strip TIFF (classic or
    BigTIFF; none, LZW, deflate or PackBits strips; predictor 2) as
    stored; raises :class:`MetadataError` or :class:`NotSupportedError`
    naming what it cannot read."""
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        st = os.fstat(f.fileno())
        stat_key = (st.st_mtime_ns, st.st_size, st.st_ino)
        spath = str(path)
        with _TIFF_PY_PARSE_LOCK:
            entry = _TIFF_PY_PARSE_CACHE.get(spath)
        hit = None
        if entry is not None and entry[0] == stat_key:
            # re-crc the ranges the cached parse read (outside the lock)
            if all(e <= len(m) and zlib.crc32(m[s:e]) == c for s, e, c in entry[1]):
                hit = entry[2]
                with _TIFF_PY_PARSE_LOCK:
                    if spath in _TIFF_PY_PARSE_CACHE:
                        _TIFF_PY_PARSE_CACHE.move_to_end(spath)
        if hit is None:
            spans: list = []
            hit = _tiff_parse(m, spans)
            key = _tiff_parse_spans_key(m, spans)
            with _TIFF_PY_PARSE_LOCK:
                _TIFF_PY_PARSE_CACHE[spath] = (stat_key, key, hit)
                _TIFF_PY_PARSE_CACHE.move_to_end(spath)
                while len(_TIFF_PY_PARSE_CACHE) > _TIFF_PY_PARSE_CACHE_MAX:
                    _TIFF_PY_PARSE_CACHE.popitem(last=False)
        bo, ifds = hit
        if not 0 <= page < len(ifds):
            raise MetadataError(f"{path}: no page {page} (the file has {len(ifds)})")
        return _gray_ifd_plane(bo, m, ifds[page], path, "plain TIFF pages")


def read_tiff_page_py(path, page: int) -> "np.ndarray | None":
    """:func:`read_tiff_page`, or None when the file is not such a TIFF
    (the JAX package's ``read_tiff_page_py``: its caller goes on)."""
    try:
        return read_tiff_page(path, page)
    except (OSError, ValueError, MetadataError, NotSupportedError, struct.error):
        return None


def tiff_dimensions(path) -> "tuple[int, int] | None":
    """(height, width) of a TIFF's first page from its header, or None
    when the file is not a TIFF."""
    try:
        with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
            bo, ifds = _tiff_parse(m)
            height = _tiff_int(bo, m, ifds[0], 257, 0)
            width = _tiff_int(bo, m, ifds[0], 256, 0)
    except (OSError, ValueError, MetadataError, struct.error):
        return None
    return (height, width) if height > 0 and width > 0 else None
