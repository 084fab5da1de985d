"""Image readers of the port: TIFF, the microscope containers, and the
context-manager readers of user scripts.

Counterpart: ``tmlibrary_tpu/readers.py`` (reference ``tmlib/readers.py``),
read with no JVM and no codec library:

- the container dispatch imextract and metaconfig call first
  (:func:`read_container_plane`, :func:`container_dimensions`,
  ``:40-190``), the one home of each format's linear page formula
  (:func:`_container_plane`), and the reader cache ``_OPEN_READERS``
  with its ``_DECLINED`` sentinel;
- the Python TIFF reader for the pages the C++ reader
  (:mod:`tmlibrary_tpu_torch.native`) declines -- BigTIFF and deflate
  strips -- with its bounded parse cache, and the IFD walk and strip
  decode the TIFF-flavoured containers share (``:1936-2113``,
  ``:2480-2525``);
- the decode of every TIFF page the JAX package hands to ``cv2``
  (:func:`tiff_page_plan` and :func:`decode_tiff_page`: tiles, colour,
  planes, float, 1- to 64-bit samples, orientations, YCbCr, CMYK,
  CIELab, JPEG-in-TIFF) and the order of the decoders after the grey
  TIFF readers (:func:`decode_image_file`: BMP, JPEG, PNG, Netpbm, TIFF,
  as cv2 sniffs them; :func:`image_dimensions` for the probe);
- the container parsers: Nikon ND2, Zeiss CZI and LSM, Leica LIF,
  DeltaVision DV/R3D, MetaMorph STK, Olympus OIF/OIB (the OLE2 file
  through :mod:`tmlibrary_tpu_torch.cfb`), PerkinElmer Opera FLEX, and
  OME-NGFF through :mod:`tmlibrary_tpu_torch.ngff`;
- ``ImageReader`` and ``BFImageReader``; ``IMSReader``,
  ``DatasetReader`` and ``TablesReader``.

A TIFF-flavoured container (``.stk .lsm .flex``) that its reader
declines with :class:`~tmlibrary_tpu_torch.errors.NotSupportedError`
goes to the plain TIFF path, as in the JAX package.  CZI subblocks
compressed as JPEG (compression 1) or zstd (5 and 6) are decoded by the
port's own codecs (:mod:`tmlibrary_tpu_torch.native`); Imaris ``.ims``
and ``DatasetReader`` read through the port's HDF5 code
(:mod:`tmlibrary_tpu_torch.io.hdf5`); ``TablesReader`` returns columns
as a dict of arrays where the JAX package returns a DataFrame.
"""

from __future__ import annotations

import collections
import json
import mmap
import os
import re
import struct
import threading
import zlib
from pathlib import Path
from xml.etree import ElementTree

import numpy as np

from tmlibrary_tpu_torch import native
from tmlibrary_tpu_torch.cfb import CompoundFile
from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError
from tmlibrary_tpu_torch.io import bmp, hdf5, png, pnm


class Reader:
    """Base context-manager reader (reference ``tmlib.readers.Reader``)."""

    def __init__(self, filename):
        self.filename = Path(filename)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ------------------------------------------------------------ dispatch
def _container_reader(path):
    """The container Reader class for ``path``, or None for plain images."""
    name = str(path).lower()
    if name.endswith(".nd2"):
        return ND2Reader
    if name.endswith(".czi"):
        return CZIReader
    if name.endswith(".lif"):
        return LIFReader
    if name.endswith((".dv", ".r3d")):
        return DVReader
    if name.endswith(".ims"):
        return IMSReader
    if name.endswith(".stk"):
        return STKReader
    if name.endswith(".lsm"):
        return LSMReader
    if name.endswith(".oib"):
        return OIBReader
    if name.endswith(".oif"):
        return OIFReader
    if name.endswith(".flex"):
        return FlexReader
    if name.endswith(".zarr"):  # OME-NGFF plate directory (covers .ome.zarr)
        from tmlibrary_tpu_torch.ngff import NGFFReader

        return NGFFReader
    return None


def _container_plane(reader, page: int) -> np.ndarray:
    """One plane from an OPEN container reader by the linear page index
    its metaconfig handler writes (the single home of that convention:
    ND2 ``seq * n_components + comp``, CZI ``(((s*M+m)*C+c)*Z+z)*T+t``,
    LIF ``series * C*Z*T + (c*Z+z)*T + t``)."""
    if isinstance(reader, ND2Reader):
        seq, comp = divmod(page, reader.n_components)
        return reader.read_plane(seq, comp)
    if isinstance(reader, LIFReader):
        return reader.read_plane_global(page)
    # CZI/NGFF/DV/STK/LSM/FLEX and Olympus OIF/OIB share the linear decode
    return reader.read_plane_linear(page)


#: (path, mtime_ns, size) -> open container reader.  imextract reads a
#: container plane by plane: re-parsing its chunk map, subblock directory
#: or XML for every plane would be O(planes^2).  Readers are read-only
#: once entered, so imextract's decode threads share them; eviction only
#: drops the reference (the mapping closes with its last user).
_OPEN_READERS: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()
_OPEN_READERS_CAP = 64
_OPEN_READERS_LOCK = threading.Lock()

#: TIFF-flavoured containers: one its reader declines (RGB, 32-bit, a
#: compressed single-IFD stack) is still a TIFF for the plain TIFF path
_TIFF_FLAVORED = (".stk", ".lsm", ".flex")

#: cached for a TIFF-flavoured container its reader declined, so the
#: per-plane loop does not re-parse the declined header for every plane
_DECLINED = object()


def _open_container(path):
    """``cls(path).__enter__()`` for a container path; None for a plain
    image or a TIFF-flavoured container whose reader declines it (the
    caller then takes the TIFF path)."""
    cls = _container_reader(path)
    if cls is None:
        return None
    try:
        return cls(path).__enter__()
    except NotSupportedError:
        if str(path).lower().endswith(_TIFF_FLAVORED):
            return None
        raise


def _cache_put(key, value):
    """Insert under the lock, evicting the oldest entries past the cap;
    returns the entry that won (another thread's, if it came first)."""
    with _OPEN_READERS_LOCK:
        while len(_OPEN_READERS) >= _OPEN_READERS_CAP:
            _OPEN_READERS.popitem(last=False)
        return _OPEN_READERS.setdefault(key, value)


def _cached_container_reader(path):
    if _container_reader(path) is None:
        return None
    st = os.stat(path)
    key = (str(path), st.st_mtime_ns, st.st_size)
    with _OPEN_READERS_LOCK:
        reader = _OPEN_READERS.get(key)
    if reader is _DECLINED:
        return None
    if reader is not None:
        return reader
    reader = _open_container(path)
    if reader is None:
        _cache_put(key, _DECLINED)
        return None
    winner = _cache_put(key, reader)
    if winner is not reader:  # lost an open race: release this one now
        reader.__exit__()
    return winner


def read_container_plane(path, page: int) -> "np.ndarray | None":
    """One container plane by linear page index; None for a plain image
    or a declined TIFF-flavoured container.  The parsed container stays
    cached across calls (``_OPEN_READERS``)."""
    reader = _cached_container_reader(path)
    if reader is None:
        return None
    return _container_plane(reader, page)


def container_dimensions(path) -> "tuple[int, int] | None":
    """(height, width) of a container's planes, or None for a plain image
    or a declined TIFF-flavoured container (metaconfig's site-shape probe)."""
    r = _open_container(path)
    if r is None:
        return None
    try:
        return r.height, r.width
    finally:
        r.__exit__()


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
    offs, counts = _tiff_chunk_table(bo, buf, ifd, False, filename)
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


def _grey_plane(raw: bytes, predictor: int, height: int, width: int,
                dtype: np.dtype) -> np.ndarray:
    """A grey reader's decoded plane after its predictor: 2 as
    :func:`_unpredict` applies it, any other value ignored; in ``dtype``,
    the file's byte order, as the JAX package's grey readers return it."""
    plane = _unpredict(raw, 2 if predictor == 2 else 1, (height, width, 1), dtype)
    return plane[:, :, 0].astype(dtype, copy=False)


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
    return _grey_plane(bytes(raw[:height * row_bytes]), predictor, height, width, dtype)


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


def _cached_tiff_parse(f, m, path) -> tuple[str, list[dict]]:
    """``(byteorder, ifds)`` of the open TIFF ``f`` mapped as ``m``, from
    the parse cache while the file's stat key and the crc of every IFD
    table the cached parse read still match (a tag's value outside its
    IFD is read from ``m`` at decode time, so no tag goes stale)."""
    st = os.fstat(f.fileno())
    stat_key = (st.st_mtime_ns, st.st_size, st.st_ino)
    spath = str(path)
    with _TIFF_PY_PARSE_LOCK:
        entry = _TIFF_PY_PARSE_CACHE.get(spath)
    if entry is not None and entry[0] == stat_key:
        # re-crc the ranges the cached parse read (outside the lock)
        if all(e <= len(m) and zlib.crc32(m[s:e]) == c for s, e, c in entry[1]):
            with _TIFF_PY_PARSE_LOCK:
                if spath in _TIFF_PY_PARSE_CACHE:
                    _TIFF_PY_PARSE_CACHE.move_to_end(spath)
            return entry[2]
    spans: list = []
    hit = _tiff_parse(m, spans)
    key = _tiff_parse_spans_key(m, spans)
    with _TIFF_PY_PARSE_LOCK:
        _TIFF_PY_PARSE_CACHE[spath] = (stat_key, key, hit)
        _TIFF_PY_PARSE_CACHE.move_to_end(spath)
        while len(_TIFF_PY_PARSE_CACHE) > _TIFF_PY_PARSE_CACHE_MAX:
            _TIFF_PY_PARSE_CACHE.popitem(last=False)
    return hit


def read_tiff_page(path, page: int) -> np.ndarray:
    """Page ``page`` of an 8/16-bit grayscale strip TIFF (classic or
    BigTIFF; none, LZW, deflate or PackBits strips; predictor 2) as
    stored; raises :class:`MetadataError` or :class:`NotSupportedError`
    naming what it cannot read."""
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        bo, ifds = _cached_tiff_parse(f, m, path)
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


# ------------------------------------------------ the TIFF pages cv2 reads
#: what the grey readers above decline and ``cv2.imread(...,
#: IMREAD_UNCHANGED)`` reads: tiles, 1-4 samples, chunky or planar,
#: 8/16/32/64-bit samples, JPEG (7) chunks, SGILog (34676, 34677);
#: TIFF's name for each refusal
_TIFF_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "palette", 4: "mask",
                     5: "separated (CMYK)", 6: "YCbCr", 8: "CIELab", 9: "ICCLab",
                     10: "ITULab", 32844: "LogL", 32845: "LogLuv"}


def _tiff_refuse(filename, what: str) -> NotSupportedError:
    return NotSupportedError(f"{filename}: {what} is not supported")


def _tiff_chunk_table(bo, buf, ifd, tiled: bool, filename) -> tuple[list, list]:
    """The offsets and byte counts of an IFD's strips or tiles."""
    off_tag, cnt_tag = (324, 325) if tiled else (273, 279)
    try:
        offs = _tiff_ints(bo, buf, ifd[off_tag])
        counts = _tiff_ints(bo, buf, ifd[cnt_tag])
    except KeyError as exc:
        raise MetadataError(f"TIFF IFD without {'tile' if tiled else 'strip'} offsets or "
                            f"byte counts: {filename}") from exc
    except struct.error as exc:
        raise MetadataError(f"corrupt TIFF tag data in {filename}") from exc
    return offs, counts


def _unpredict(raw, predictor: int, shape: tuple, dtype: np.dtype) -> np.ndarray:
    """One decoded chunk as ``shape = (rows, cols, samples)`` of ``dtype``
    (the file's byte order) after libtiff's predictor: 2 adds each sample
    to the one ``samples`` before it in its row, modulo its width; 3
    (floating point) adds bytes so, then gathers each value's bytes from
    the row's byte planes, most significant first."""
    rows, cols, spp = shape
    if predictor == 1:
        return np.frombuffer(raw, dtype).reshape(shape)
    if predictor == 2:  # the sum wraps at the sample's width, as libtiff's
        unsigned = np.dtype(f"u{dtype.itemsize}")
        u = np.frombuffer(raw, unsigned.newbyteorder(dtype.byteorder)).reshape(shape)
        return np.cumsum(u, axis=1, dtype=unsigned).view(dtype.newbyteorder("="))
    bps = dtype.itemsize
    x = np.frombuffer(raw, np.uint8).reshape(rows, cols * bps, spp)
    x = np.cumsum(x, axis=1, dtype=np.uint8).reshape(rows, bps, cols * spp)
    le = np.ascontiguousarray(x[:, ::-1, :].transpose(0, 2, 1))
    return le.view(dtype.newbyteorder("<")).reshape(shape)


def _tiff_jpeg_chunk(chunk: bytes, tables: "bytes | None", ycc: bool, want: tuple,
                     last_strip: bool, sampling: tuple, filename) -> np.ndarray:
    """One JPEG (compression 7) strip or tile as libtiff's JPEG codec
    gives it to ``TIFFReadRGBA*``: the ``JPEGTables`` stream read first,
    YCbCr converted by libjpeg (``JPEGCOLORMODE_RGB``) or the components
    as stored, the stream's size, component count and sampling checked
    against the segment as ``JPEGPreDecode`` checks them; a stream smaller
    than its segment fills its corner, the rest zero (libtiff decodes the
    stream's lines and no more).  ``(rows, cols, components)`` uint8,
    colour in R, G, B order."""
    rows, cols, ncomp = want
    stream = chunk
    if tables:
        head = bytes(tables[:-2]) if bytes(tables[-2:]) == b"\xff\xd9" else bytes(tables)
        stream = head + bytes(chunk[2:]) if bytes(chunk[:2]) == b"\xff\xd8" else head + bytes(chunk)
    try:
        img = native.jpeg_decode_array(stream, native.JPEG_YCC if ycc else native.JPEG_RAW)
    except MetadataError as e:
        raise MetadataError(f"corrupt JPEG strip or tile in {filename}: {e}") from e
    img = img.reshape(img.shape[0], img.shape[1], -1)
    if img.shape[2] != ncomp:
        raise MetadataError(f"{filename}: improper JPEG component count {img.shape[2]}")
    h, w = img.shape[:2]
    if not (w == cols and h > rows and last_strip) and (w > cols or h > rows):
        raise MetadataError(f"{filename}: JPEG strip/tile size exceeds expected dimensions, "
                            f"expected {cols}x{rows}, got {w}x{h}")
    hv = native.jpeg_sampling(stream, native.JPEG_YCC if ycc else native.JPEG_RAW)
    if hv[0] != sampling or any(f != (1, 1) for f in hv[1:]):
        raise MetadataError(f"{filename}: improper JPEG sampling factors {hv}, apparently "
                            f"should be {sampling}")
    img = img[:rows, :cols]
    if ycc:
        img = img[:, :, ::-1]  # the decoder's BGR back to R, G, B
    if w < cols or h < rows:
        out = np.zeros((rows, cols, ncomp), np.uint8)
        out[:img.shape[0], :img.shape[1]] = img
        return out
    return img


def _ycbcr_units(raw, rows: int, cols: int, hs: int, vs: int, visible: int = 0) -> np.ndarray:
    """A chunk of 8-bit YCbCr data units (``hs * vs`` luma samples, then
    Cb and Cr, units in raster order) as ``(rows, cols, 3)`` Y, Cb, Cr,
    each pixel given its unit's chroma (libtiff's putcontig8bitYCbCr*
    routines).  ``visible`` > 0 reads a 4x4 tile clipped to its first
    ``visible`` columns as ``putcontig8bitYCbCr44tile`` reads it: after
    each row of units it skips the clipped units as 10 bytes each (the 4x2
    unit) where they hold 18, so each later row starts inside the row
    above's skipped units; columns past ``visible`` are left 0."""
    uy, ux = -(-rows // vs), -(-cols // hs)
    unit = hs * vs + 2
    data = np.frombuffer(raw, np.uint8)
    if visible:
        ux = -(-visible // hs)
        step = ux * unit + ((cols - visible) // 4) * 10
        at = (np.arange(uy)[:, None] * step + np.arange(ux)[None, :] * unit)[..., None]
        units = data[at + np.arange(unit)]
    else:
        units = data[:uy * ux * unit].reshape(uy, ux, unit)
    y = units[:, :, :hs * vs].reshape(uy, ux, vs, hs).transpose(0, 2, 1, 3).reshape(uy * vs,
                                                                                  ux * hs)
    out = np.zeros((rows, cols, 3), np.uint8)
    w = min(cols, ux * hs)
    out[:, :w, 0] = y[:rows, :w]
    for c in (1, 2):
        out[:, :w, c] = np.repeat(np.repeat(units[:, :, hs * vs + c - 1], vs, 0), hs,
                                  1)[:rows, :w]
    return out


def _tiff_floats(bo: str, buf, ifd: dict, tag: int, default: list) -> list:
    """A RATIONAL or FLOAT tag's values as libtiff reads them into floats
    (``float(num) / float(den)``, 0 for a zero denominator)."""
    entry = ifd.get(tag)
    if entry is None:
        return list(np.float32(default))
    typ, cnt, voff = entry
    if typ == 5:
        pairs = np.frombuffer(bytes(buf[voff:voff + 8 * cnt]), np.dtype(bo + "u4")).reshape(-1, 2)
        num, den = pairs[:, 0].astype(np.float32), pairs[:, 1].astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            return list(np.where(den == 0, np.float32(0), num / np.where(den == 0, 1, den)))
    if typ == 11:
        return list(np.frombuffer(bytes(buf[voff:voff + 4 * cnt]), np.dtype(bo + "f4")))
    return list(np.float32(default))


def _skewed_grey_rows(block: np.ndarray, h: int, w: int, tw: int) -> np.ndarray:
    """The grey samples libtiff's ``putgreytile``/``putagreytile`` read
    from an edge tile of grey pixels of several samples (``w`` of the
    tile's ``tw`` columns in the image): they step from one row to the
    next by ``tw - w`` bytes past the row's ``w`` pixels, not by the
    tile's row, so row ``r`` starts ``r * (w * pixel_bytes + tw - w)``
    bytes into the tile."""
    native_order = np.ascontiguousarray(block, block.dtype.newbyteorder("="))
    raw = native_order.view(np.uint8).reshape(-1)
    isz = block.dtype.itemsize
    pixel = block.shape[-1] * isz
    at = (np.arange(h)[:, None] * (w * pixel + tw - w) + np.arange(w)[None, :] * pixel)
    vals = raw[at].astype(np.uint16)
    if isz == 2:  # a little-endian host's sample bytes, wherever they start
        vals |= raw[at + 1].astype(np.uint16) << 8
    return vals.astype(block.dtype.newbyteorder("=")) if isz == 2 else \
        vals.astype(np.uint8).view(block.dtype.newbyteorder("="))


def _channels(x: np.ndarray, order: list) -> np.ndarray:
    """``x[:, :, order]``, C-contiguous, one strided copy a channel
    (numpy's fancy index or a reversed stride copies several times
    slower)."""
    out = np.empty(x.shape[:2] + (len(order),), x.dtype)
    for i, c in enumerate(order):
        out[:, :, i] = x[:, :, c]
    return out


#: libtiff's YCbCr put routines, by (horizontal, vertical) subsampling
_YCBCR_SAMPLINGS = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}


def _none(filename, what: str) -> MetadataError:
    """A page cv2 5.0 returns None for (the reference then raises)."""
    return MetadataError(f"{filename}: {what} (cv2 reads no such TIFF page)")


def _tiff_tiling(tag, ifd: dict, width: int, height: int, filename) -> tuple:
    """``(tiled, chunk rows, chunk columns)`` of a page: its tiles, or its
    strips of RowsPerStrip rows."""
    tiled = 322 in ifd or 323 in ifd
    if tiled:
        th, tw = tag(323, 0), tag(322, 0)
        if th <= 0 or tw <= 0:
            raise MetadataError(f"corrupt TIFF tile size in {filename}")
    else:
        th, tw = min(tag(278, 0xFFFFFFFF) or 0xFFFFFFFF, height), width
    return tiled, th, tw


def _cv2_limits(width: int, height: int, th: int, tw: int, spp: int, itemsize: int,
                filename) -> None:
    """cv2's limits (its validateInputImageSize, its TIFF decoder's tile
    checks), held before the file's sizes size anything."""
    if width > 1 << 20 or height > 1 << 20 or width * height > 1 << 30:
        raise MetadataError(f"{filename}: a {width}x{height} TIFF page (cv2 reads at most "
                            f"2^20 pixels a side and 2^30 in all)")
    if th > 1 << 24 or tw > 1 << 24 or th * tw * spp * itemsize >= 1 << 30:
        raise MetadataError(f"{filename}: a {tw}x{th} TIFF tile of {spp} samples "
                            f"(cv2 reads tiles under 1 GiB)")


#: libtiff's SGILog compressions (``tif_luv.c``): 34676 (LogL16 and
#: LogLuv32, run-length coded byte planes) and 34677 (LogLuv24)
_SGILOG = (34676, 34677)


def _sgilog_plan(tag, ifd: dict, filename, width: int, height: int, bits: int, spp: int,
                 fmt: int, phot: int, planar: int, compression: int, orientation: int) -> dict:
    """:func:`tiff_page_plan` of a LogL or LogLuv page, as cv2 5.0 reads it:
    LogLuv (3 chunky samples, 34676 or 34677, any BitsPerSample: cv2 asks
    libtiff for floats) as float32 X, Y, Z turned into BGR; LogL (1
    sample of 8 or 16 bits, unsigned or signed, 34676) through libtiff's
    RGBA interface as 8-bit grey.  Any other mix of an SGILog compression
    and a photometric is a page cv2 returns None for."""
    if phot == 32845 and compression in _SGILOG and spp == 3 and planar == 1:
        kind = native.SGILOG_LUV24 if compression == 34677 else native.SGILOG_LUV32
        rgba8, itemsize = False, 4
    elif phot == 32844 and compression == 34676 and spp == 1 and bits in (8, 16) and \
            fmt in (1, 2):
        kind, rgba8, itemsize = native.SGILOG_L16, True, 1
    else:
        name = _TIFF_PHOTOMETRIC.get(phot, f"photometric {phot}")
        raise _none(filename, f"a {name} TIFF page of {spp} {bits}-bit samples"
                              f"{' in planes' if planar == 2 else ''} with compression "
                              f"{compression}")
    tiled, th, tw = _tiff_tiling(tag, ifd, width, height, filename)
    _cv2_limits(width, height, th, tw, 3 if kind != native.SGILOG_L16 else 1, itemsize,
                filename)
    return {"width": width, "height": height, "bits": bits, "spp": spp, "fmt": fmt,
            "phot": phot, "planar": planar, "compression": compression, "predictor": 1,
            "orientation": orientation, "extra": [], "rgba8": rgba8, "packed": False,
            "sampling": (1, 1), "tiled": tiled, "th": th, "tw": tw,
            "fdtype": np.dtype(np.uint8 if rgba8 else np.float32), "sgilog": kind}


def _sgilog_page(bo: str, buf, ifd: dict, plan: dict, filename) -> np.ndarray:
    """An SGILog page (:func:`_sgilog_plan`) as cv2 returns it: every strip
    or tile decoded by ``native.sgilog_decode`` (a chunk short of its data
    fails the read, as libtiff fails it), LogL grey as uint8 (int8 when
    signed) oriented as the RGBA interface orients it, LogLuv's X, Y, Z
    oriented whole, then turned into BGR as ``cvtColor(COLOR_XYZ2BGR)``
    turns them."""
    width, height, tiled, th, tw = (plan[k] for k in ("width", "height", "tiled", "th", "tw"))
    kind, grey = plan["sgilog"], plan["sgilog"] == native.SGILOG_L16
    what = "tile" if tiled else "strip"
    ny, nx = -(-height // th), -(-width // tw)
    offs, counts = _tiff_chunk_table(bo, buf, ifd, tiled, filename)
    if len(offs) < ny * nx or len(counts) < ny * nx:
        raise MetadataError(f"corrupt TIFF {what} layout in {filename}: {len(offs)} offsets "
                            f"for {ny * nx} {what}s")
    page = np.empty((ny * th, nx * tw) + (() if grey else (3,)),
                    np.uint8 if grey else np.float32)
    for k in range(ny * nx):
        iy, ix = divmod(k, nx)
        rows = th if tiled else min(th, height - iy * th)
        off, cnt = offs[k], counts[k]
        if off + cnt > len(buf) or cnt <= 0:
            raise MetadataError(f"truncated TIFF {what} {k} in {filename}")
        try:
            block = native.sgilog_decode(buf[off:off + cnt], kind, tw, rows)
        except ValueError as e:
            raise _none(filename, f"SGILog {what} {k}: {e}") from e
        page[iy * th:iy * th + rows, ix * tw:(ix + 1) * tw] = block
    page = page[:height, :width]
    if grey:
        out = np.ascontiguousarray(page).view(np.int8 if plan["fmt"] == 2 else np.uint8)
        return _orient(out, plan["orientation"], tw, True)
    return native.xyz_to_bgr(_orient(page, plan["orientation"], tw, False))


def tiff_page_plan(bo: str, buf, ifd: dict, filename) -> dict:
    """The layout of one IFD and the route its pixels take to ``cv2``'s
    result, every check ``decode_tiff_page`` makes before it reads a
    chunk: raises :class:`MetadataError` where cv2 5.0 returns None (or
    the page is corrupt) and :class:`NotSupportedError` for what the
    port leaves out; the site-shape probe calls it alone."""
    tag = lambda t, d: _tiff_int(bo, buf, ifd, t, d)  # noqa: E731
    width, height = tag(256, 0), tag(257, 0)
    if width <= 0 or height <= 0:
        raise MetadataError(f"corrupt TIFF dimensions in {filename}")
    bits_all = _tiff_ints(bo, buf, ifd[258]) if 258 in ifd else [1]
    bits = bits_all[0] if bits_all else 1
    if any(b != bits for b in bits_all):
        raise MetadataError(f"{filename}: different BitsPerSample per sample {bits_all}")
    spp = tag(277, 1)
    fmt = tag(339, 1)
    if 262 not in ifd:
        raise _tiff_refuse(filename, "a TIFF page without PhotometricInterpretation")
    phot = tag(262, 1)
    planar = tag(284, 1) if spp > 1 else 1
    compression = tag(259, 1)
    predictor = tag(317, 1)
    orientation = tag(274, 1)
    extra = _tiff_ints(bo, buf, ifd[338]) if 338 in ifd else []
    if not 1 <= orientation <= 8:
        raise MetadataError(f"{filename}: Orientation {orientation}")
    if orientation > 4 and width != height:
        raise _none(filename, f"Orientation {orientation} on a {width}x{height} page "
                              "(cv2 5.0 transposes only square pages)")
    if compression == 6:
        raise _tiff_refuse(filename, "old-style JPEG TIFF (compression 6)")
    if compression in _SGILOG or phot in (32844, 32845):
        return _sgilog_plan(tag, ifd, filename, width, height, bits, spp, fmt, phot, planar,
                            compression, orientation)
    if compression not in (1, 5, 7, 8, 32946, 32773):
        raise _tiff_refuse(filename, f"TIFF compression {compression}")
    if spp > 4:
        raise MetadataError(f"{filename}: {spp} samples a pixel (cv2 reads 1 to 4)")
    if planar not in (1, 2):
        raise MetadataError(f"{filename}: PlanarConfiguration {planar}")
    name = _TIFF_PHOTOMETRIC.get(phot, f"photometric {phot}")
    what = f"a {name} TIFF page of {spp} {bits}-bit samples" + (" in planes" if planar == 2
                                                               else "")
    grey = phot in (0, 1)
    # cv2's readHeader: above 8 bits, a photometric past RGB or 2 samples
    # go through libtiff's RGBA interface as 8 bits do
    rgba8 = bits in (1, 4, 8) or (bits in (10, 12, 14, 16) and (phot > 2 or spp == 2))
    if bits in (2, 24) or bits not in (1, 4, 8, 10, 12, 14, 16, 32, 64):
        raise _none(filename, f"{bits}-bit TIFF samples")
    if bits == 1 and not (phot in (0, 1, 3) and spp == 1):
        raise _none(filename, what)
    if bits == 4 and phot != 3:
        raise _none(filename, f"{what} (4 bits only for a palette)")
    if bits in (10, 12, 14) and (rgba8 or phot == 3):
        raise _none(filename, what)
    if rgba8 or bits in (10, 12, 14, 16):
        if fmt not in (1, 2):
            raise MetadataError(f"{filename}: SampleFormat {fmt} at {bits} bits")
    elif (bits, fmt) not in ((32, 1), (32, 2), (32, 3), (64, 3)):
        raise MetadataError(f"{filename}: SampleFormat {fmt} at {bits} bits")
    if spp == 2 and not rgba8:
        raise MetadataError(f"{filename}: grey with alpha at {bits} bits")
    sampling = (1, 1)
    if rgba8:  # what libtiff's TIFFRGBAImageOK and put routines take
        if grey:
            ok = spp == 1 or bits in (8, 16)
        elif phot == 2:
            ok = spp in (3, 4) and bits == 8
        elif phot == 3:
            ok = spp == 1 and bits in (1, 4, 8)
        elif phot == 5:  # CMYK, InkSet 1
            ok = spp == 4 and bits == 8 and tag(332, 1) == 1
        elif phot == 6:
            ok = spp == 3 and bits == 8
            if ok and compression != 7:
                sub = _tiff_ints(bo, buf, ifd[530]) if 530 in ifd else [2, 2]
                sampling = tuple(sub[:2]) if len(sub) >= 2 else (2, 2)
                ok = sampling in _YCBCR_SAMPLINGS and (planar == 1 or sampling == (1, 1))
            elif ok:
                ok = planar == 1
        elif phot == 8:
            ok = spp == 3 and bits in (8, 16) and planar == 1
        else:
            ok = False
    else:
        ok = grey or (phot == 2 and spp in (3, 4))
    if not ok:
        raise _none(filename, what + (f" with compression {compression}" if phot == 6 else ""))
    if compression == 7 and bits != 8:
        raise _tiff_refuse(filename, f"{bits}-bit JPEG TIFF")
    packed = bits not in (8, 16, 32, 64)
    if compression != 7:
        if predictor == 2 and packed:
            raise MetadataError(f"{filename}: horizontal predictor at {bits} bits")
        if predictor == 2 and phot == 6 and sampling != (1, 1):
            raise _tiff_refuse(filename, f"the horizontal predictor on YCbCr {sampling}")
        if predictor == 3 and fmt != 3:
            raise MetadataError(f"{filename}: floating-point predictor on SampleFormat {fmt}")
        if predictor not in (1, 2, 3):
            raise MetadataError(f"{filename}: Predictor {predictor}")
    else:
        predictor = 1

    tiled, th, tw = _tiff_tiling(tag, ifd, width, height, filename)
    if phot == 6 and compression != 7 and sampling == (4, 4) and not tiled and \
            -(-width // 4) % 2:
        # libtiff reads such a 4x4 strip a whole number of scanlines short
        # (a row of units is not a multiple of 4 bytes) and converts memory
        # it never wrote (ROADMAP C); a clipped 4x4 tile it misreads
        # deterministically, which _ycbcr_units models
        raise _tiff_refuse(filename, "a 4x4-subsampled YCbCr strip page whose units libtiff "
                                     "reads from memory it never wrote")
    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    fdtype = np.dtype(f"{bo}{kind}{bits // 8}") if not packed else np.dtype("=u2")
    _cv2_limits(width, height, th, tw, spp, fdtype.itemsize, filename)
    return {"width": width, "height": height, "bits": bits, "spp": spp, "fmt": fmt,
            "phot": phot, "planar": planar, "compression": compression,
            "predictor": predictor, "orientation": orientation, "extra": extra,
            "rgba8": rgba8, "packed": packed, "sampling": sampling, "tiled": tiled,
            "th": th, "tw": tw, "fdtype": fdtype}


def _orient(img: np.ndarray, orientation: int, tile_width: int, rgba8: bool) -> np.ndarray:
    """The page ``img`` (stored order) as cv2 5.0 orients it.  Through
    libtiff's RGBA interface (``rgba8``) a horizontal flip acts within
    each tile's columns (``TIFFReadRGBATile`` flips the tile it reads)
    and Orientation 5-8 read as 1-4, then transposed (6 and 8 turned
    half round first); other pages take the EXIF transform whole."""
    if orientation == 1:
        return img
    if not rgba8:
        out = {2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1], 5: img.swapaxes(0, 1),
               6: img[::-1].swapaxes(0, 1), 7: img[::-1, ::-1].swapaxes(0, 1),
               8: img[:, ::-1].swapaxes(0, 1)}[orientation]
        return np.ascontiguousarray(out)
    base = (orientation - 1) % 4 + 1
    out = img
    if base in (2, 3):
        out = out.copy()
        for x in range(0, img.shape[1], tile_width):
            out[:, x:x + tile_width] = img[:, x:x + tile_width][:, ::-1]
    if base in (3, 4):
        out = out[::-1]
    if orientation > 4:
        if orientation in (6, 8):
            out = out[::-1, ::-1]
        out = out.swapaxes(0, 1)
    return np.ascontiguousarray(out)


def decode_tiff_page(bo: str, buf, ifd: dict, filename) -> np.ndarray:
    """One IFD as ``cv2.imread(path, IMREAD_UNCHANGED)`` returns it with
    this repo's OpenCV (5.0, libtiff 4.7): ``(H, W)`` or ``(H, W, 3|4)`` in
    B, G, R(, A) order.

    - 1-, 4- and 8-bit samples (and 16-bit grey with alpha, 16-bit CIELab)
      go through libtiff's RGBA interface as cv2 sends them: 1-bit grey
      as 0/255, MinIsWhite inverted (chunky pages), palette through its
      colour map (a map with no entry above 255 taken as 8-bit; a 1-bit
      palette page comes back grey, cv2's ``BGRA2Gray`` of its colours),
      unassociated alpha premultiplied (``(v * a + 127) // 255``), 16-bit
      grey cut to its high byte, grey of 2-4 samples returned as its first
      sample, CMYK as libtiff's ``(255 - k) * (255 - c) / 255`` with alpha
      255, CIELab and YCbCr (any libtiff put routine's subsampling) as
      libtiff's ``tif_color.c`` converts them (``native``); edge tiles of
      grey with alpha as libtiff misreads them (:func:`_skewed_grey_rows`);
      JPEG chunks through the port's decoder, YCbCr as libjpeg converts
      it, a stream smaller than its chunk zero past its corner.
    - 10- to 64-bit samples are returned as stored (uint16/int16,
      uint32/int32/float32, float64) with R and B swapped; grey of 3 or 4
      samples at 10-16 bits as cv2's ``BGRA2Gray`` of the first three; 10,
      12 and 14 bits shifted to the top of 16.
    - SGILog pages (compression 34676/34677) as :func:`_sgilog_page`:
      LogLuv as float32 BGR (libtiff's X, Y, Z, then cv2's
      ``COLOR_XYZ2BGR``), LogL as 8-bit grey.
    - Orientation 2-8 as :func:`_orient` (5-8 on square pages; cv2 5.0
      returns None for others).

    Strips or tiles (BigTIFF too), chunky or planar (cv2 reads a planar
    16-, 32- or 64-bit page from memory it never wrote; this returns the
    stored samples), none/LZW/deflate/PackBits with predictors 2 and 3,
    JPEG with ``JPEGTables`` (every stream the port's JPEG decoder reads:
    arithmetic-coded, lossless, CMYK), a clipped 4x4 YCbCr tile as
    libtiff misreads it (:func:`_ycbcr_units`).  What cv2 does not read
    raises :class:`MetadataError`, what the port leaves out (old-style
    JPEG, a 4x4 YCbCr strip page whose units libtiff reads from memory it
    never wrote) :class:`NotSupportedError`, each naming it
    (:func:`tiff_page_plan`)."""
    plan = tiff_page_plan(bo, buf, ifd, filename)
    if "sgilog" in plan:
        return _sgilog_page(bo, buf, ifd, plan, filename)
    width, height, bits, spp = plan["width"], plan["height"], plan["bits"], plan["spp"]
    fmt, phot, planar, compression = plan["fmt"], plan["phot"], plan["planar"], \
        plan["compression"]
    tiled, th, tw, fdtype = plan["tiled"], plan["th"], plan["tw"], plan["fdtype"]
    rgba8, packed, extra = plan["rgba8"], plan["packed"], plan["extra"]
    ycc_units = phot == 6 and compression != 7 and planar == 1
    planes = spp if planar == 2 else 1
    cspp = 1 if planar == 2 else spp
    what = "tile" if tiled else "strip"
    ny, nx = -(-height // th), -(-width // tw)
    n = planes * ny * nx
    offs, counts = _tiff_chunk_table(bo, buf, ifd, tiled, filename)
    if len(offs) < n or len(counts) < n:
        raise MetadataError(f"corrupt TIFF {what} layout in {filename}: {len(offs)} offsets "
                            f"for {n} {what}s")
    if compression == 7:
        tables = None
        if 347 in ifd:
            typ, cnt, voff = ifd[347]
            tables = bytes(buf[voff:voff + cnt])
        ycc = phot == 6
        if ycc:
            sub = _tiff_ints(bo, buf, ifd[530]) if 530 in ifd else []
            sampling = tuple(sub[:2]) if len(sub) >= 2 else \
                native.jpeg_sampling(buf[offs[0]:offs[0] + counts[0]], native.JPEG_YCC)[0]
        else:
            sampling = (1, 1)
    hs, vs = plan["sampling"]
    # every chunk decoded into one (n * th, tw, cspp) array, the short last
    # strip padded; the predictor, the tile layout and the crop then act
    # on the whole page at once
    chunk_bytes = th * tw * cspp * fdtype.itemsize
    flat = np.empty(n * chunk_bytes, np.uint8)
    for k in range(n):
        rows = th if tiled else min(th, height - (k % ny) * th)
        off, cnt = offs[k], counts[k]
        if off + cnt > len(buf) or cnt <= 0:
            raise MetadataError(f"truncated TIFF {what} {k} in {filename}")
        at = k * chunk_bytes
        if compression == 7:
            block = _tiff_jpeg_chunk(buf[off:off + cnt], tables, ycc, (rows, tw, cspp),
                                     not tiled and k % ny == ny - 1, sampling, filename)
            flat[at:at + block.size] = block.reshape(-1)
        elif ycc_units:
            expect = -(-rows // vs) * -(-tw // hs) * (hs * vs + 2)
            raw = _decode_strip(buf[off:off + cnt], compression, expect, filename)
            clipped = (width % tw) if tiled and (hs, vs) == (4, 4) and k % nx == nx - 1 else 0
            block = _ycbcr_units(raw, rows, tw, hs, vs, clipped)
            flat[at:at + block.size] = block.reshape(-1)
        elif packed:
            row_bytes = -(-tw * cspp * bits // 8)
            raw = _decode_strip(buf[off:off + cnt], compression, rows * row_bytes, filename)
            block = native.unpack_bits(np.frombuffer(raw, np.uint8), rows, row_bytes,
                                       tw * cspp, bits)
            flat[at:at + block.nbytes] = block.view(np.uint8).reshape(-1)
        else:
            expect = rows * tw * cspp * fdtype.itemsize
            raw = _decode_strip(buf[off:off + cnt], compression, expect, filename)
            flat[at:at + expect] = np.frombuffer(raw, np.uint8)
    blocks = _unpredict(flat, plan["predictor"], (n * th, tw, cspp), fdtype).reshape(
        planes, ny, nx, th, tw, cspp)
    if rgba8 and phot in (0, 1) and spp > 1 and tiled and planar == 1 and width % tw:
        w = width - (nx - 1) * tw
        for iy in range(ny):
            h = min(th, height - iy * th)
            blocks[0, iy, nx - 1, :h, :w, 0] = _skewed_grey_rows(blocks[0, iy, nx - 1], h, w, tw)
    samples = blocks.transpose(1, 3, 2, 4, 0, 5).reshape(ny * th, nx * tw, spp)[
        :height, :width].astype(fdtype.newbyteorder("="))
    out = _tiff_rgba8(samples, plan, bo, buf, ifd, filename) if rgba8 else \
        _tiff_stored(samples, plan)
    return _orient(out, plan["orientation"], tw, rgba8)


def _tiff_stored(samples: np.ndarray, plan: dict) -> np.ndarray:
    """A page of 10- to 64-bit samples as cv2 returns it (see
    :func:`decode_tiff_page`)."""
    spp, bits = plan["spp"], plan["bits"]
    if spp == 1:
        out = samples[:, :, 0]
    elif plan["phot"] in (0, 1) and bits <= 16:  # icvCvt_BGRA2Gray_16u_CnC1R
        u = samples.view(np.uint16)
        out = png.gray14(u[:, :, 2], u[:, :, 1], u[:, :, 0]).astype(np.uint16).view(samples.dtype)
    else:
        out = _channels(samples, [2, 1, 0, 3] if spp == 4 else [2, 1, 0])
    if plan["packed"]:
        out = (out.view(np.uint16) << np.uint16(16 - bits)).view(
            np.int16 if plan["fmt"] == 2 else np.uint16)
    return out


def _tiff_rgba8(samples: np.ndarray, plan: dict, bo: str, buf, ifd: dict,
                filename) -> np.ndarray:
    """A page through libtiff's RGBA interface as cv2 copies it out (see
    :func:`decode_tiff_page`)."""
    spp, bits, phot, planar, fmt = plan["spp"], plan["bits"], plan["phot"], plan["planar"], \
        plan["fmt"]
    extra = plan["extra"]
    u8 = np.dtype(np.int8 if fmt == 2 else np.uint8)
    if phot in (0, 1):
        unsigned = samples.view(samples.dtype.str.replace("i", "u")).astype(np.int64)
        g = unsigned[:, :, 0]
        if bits == 1:
            g = g * 255
        elif planar == 2:  # libtiff's separate-plane RGB routines: 16 bits rounded to 8
            a = unsigned[:, :, 1]
            if bits == 16:
                g, a = (g * 255 + 32767) // 65535, (a * 255 + 32767) // 65535
            if extra and extra[0] == 2:  # unassociated alpha: premultiplied
                g = (g * a + 127) // 255
        elif bits == 16:
            g = g >> 8
        if phot == 0 and planar == 1:
            g = 255 - g
        return g.astype(np.uint8).view(u8)
    if phot == 3:
        cmap = np.asarray(_tiff_ints(bo, buf, ifd[320]) if 320 in ifd else [], np.int64)
        if cmap.size != 3 << bits:
            raise MetadataError(f"{filename}: a {bits}-bit palette page without a "
                                f"{1 << bits}-entry ColorMap")
        cmap = cmap.reshape(3, 1 << bits)
        if cmap.max() > 255:
            cmap = cmap >> 8
        idx = samples[:, :, 0].view(samples.dtype.str.replace("i", "u")).astype(np.intp)
        if bits == 1:  # cv2 asks for one channel: BGRA2Gray of the colours
            return png.gray14(cmap[2][idx], cmap[1][idx], cmap[0][idx]).astype(np.uint8).view(u8)
        return np.ascontiguousarray(np.stack([cmap[2][idx], cmap[1][idx], cmap[0][idx]], -1)
                                    .astype(np.uint8)).view(u8)
    if phot == 5:  # CMYK: putRGBcontig8bitCMYKtile / putCMYKseparate8bittile
        x = samples.view(np.uint8).astype(np.int32)
        k = 255 - x[:, :, 3]
        out = np.empty(x.shape[:2] + (4,), np.uint8)
        for i, c in enumerate((2, 1, 0)):
            out[:, :, i] = k * (255 - x[:, :, c]) // 255
        out[:, :, 3] = 255
        return out.view(u8)
    if phot == 8:
        return np.ascontiguousarray(native.tiff_cielab_to_rgb(samples)[:, :, ::-1]).view(u8)
    if phot == 6 and plan["compression"] != 7:
        x = samples.view(np.uint8)
        luma = _tiff_floats(bo, buf, ifd, 529, [0.299, 0.587, 0.114])
        refbw = _tiff_floats(bo, buf, ifd, 532, [0, 255, 128, 255, 128, 255])
        if len(luma) < 3 or len(refbw) < 6 or np.isnan(luma[:3]).any() or luma[1] == 0:
            raise _none(filename, "YCbCr with invalid YCbCrCoefficients or "
                                  "ReferenceBlackWhite")
        rgb = native.tiff_ycbcr_to_rgb(x[:, :, 0], x[:, :, 1], x[:, :, 2], luma[:3], refbw[:6])
        return _channels(rgb, [2, 1, 0]).view(u8)
    rgb = samples.view(np.uint8)
    if spp == 4:
        if extra and extra[0] == 2:  # unassociated alpha: libtiff premultiplies
            a = rgb[:, :, 3:4].astype(np.int32)
            rgb = np.concatenate([((rgb[:, :, :3] * a + 127) // 255).astype(np.uint8),
                                  rgb[:, :, 3:4]], axis=2)
        return _channels(rgb, [2, 1, 0, 3]).view(u8)
    return _channels(rgb, [2, 1, 0]).view(u8)


def read_tiff_page_cv2(path, page: int) -> np.ndarray:
    """Page ``page`` of a TIFF as :func:`decode_tiff_page` gives it, the
    IFDs from the parse cache."""
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        bo, ifds = _cached_tiff_parse(f, m, path)
        if not 0 <= page < len(ifds):
            raise MetadataError(f"{path}: no page {page} (the file has {len(ifds)})")
        return decode_tiff_page(bo, m, ifds[page], path)


# ------------------------------------------------------- image readers
_TIFF_MAGICS = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")


def _sniff(path) -> "str | None":
    """The format cv2 would pick for the file by its leading bytes, in
    cv2's order of decoders (BMP, JPEG, PNG, Netpbm, TIFF, PAM), or None."""
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except OSError:
        return None
    if head.startswith(bmp.SIGNATURE):
        return "BMP"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if head.startswith(png.SIGNATURE):
        return "PNG"
    if len(head) >= 3 and head[0] == 80 and 49 <= head[1] <= 55 and head[2] in b" \t\n\v\f\r":
        return "PAM" if head[1] == 55 else "PNM"
    if head[:4] in _TIFF_MAGICS:
        return "TIFF"
    return None


def _decode(path: Path, fmt: str, page: int) -> np.ndarray:
    """The image cv2 would return for a file of format ``fmt`` (colour
    left as it is), each codec's own errors raised."""
    if fmt == "BMP":
        return bmp.read(path)
    if fmt == "JPEG":
        return native.jpeg_decode_array(path.read_bytes())
    if fmt == "PNG":
        return png.read(path)
    if fmt in ("PNM", "PAM"):
        return pnm.read(path)
    return read_tiff_page_cv2(path, page)


def image_dimensions(path) -> "tuple[int, int] | None":
    """``(height, width)`` of the image cv2 reads from a file (the
    site-shape probe, which reads the file whole as the reference's
    ``cv2.imread`` does; a JPEG by its markers up to the first SOS), or
    None when no decoder of
    :func:`decode_image_file` takes its leading bytes.  Raises
    :class:`MetadataError` where cv2 reads no image; a file the port
    leaves out (``NotSupportedError``) gives its header's size."""
    path = Path(path)
    fmt = _sniff(path)
    if fmt is None:
        return None
    try:
        if fmt == "JPEG":
            return native.jpeg_dimensions(path.read_bytes())
        return _decode(path, fmt, 0).shape[:2]
    except NotSupportedError:
        if fmt == "PNG":
            return png.info(path)[:2]
        return tiff_dimensions(path) if fmt == "TIFF" else None
    except (struct.error, ValueError, MemoryError) as e:
        raise MetadataError(f"cannot read image {path}: {e}") from e


def decode_image_file(path, page: int) -> "np.ndarray | None":
    """The decoders the port puts after the grey TIFF readers, in cv2's
    order of sniffing (:func:`_sniff`: the BMP codec, the JPEG decoder,
    the PNG codec, the Netpbm codec, then the TIFF pages cv2 reads:
    :func:`decode_tiff_page`), each plane as ``cv2`` hands it to
    ``cvtColor``: grey as stored, colour converted by
    :func:`~tmlibrary_tpu_torch.io.png.to_gray` (a PAM of 2 channels,
    which ``cvtColor`` refuses, raises).  ``page`` is read where the
    format has pages (the reference's ``ImageReader`` returns page 0 of a
    file that reaches cv2, whatever ``page`` says).  None when no such
    decoder takes the file; a file one takes and cannot decode raises
    :class:`MetadataError` naming the file and the feature."""
    path = Path(path)
    fmt = _sniff(path)
    if fmt is None:
        return None
    if page and fmt != "TIFF":
        raise MetadataError(f"cannot read page {page} of {path}: a {fmt} file has one")
    try:
        img = _decode(path, fmt, page)
        if img.ndim == 3 and img.shape[2] not in (3, 4):
            raise MetadataError(f"a {img.shape[2]}-channel image, which cvtColor refuses")
        return png.to_gray(img) if img.ndim == 3 else img
    except (NotSupportedError, struct.error, ValueError, MemoryError) as e:
        raise MetadataError(f"cannot read image {path}: a {fmt} file the port's readers "
                            f"do not decode: {e}") from e
    except MetadataError as e:
        raise MetadataError(f"cannot read image {path}: {e}") from e


class ImageReader(Reader):
    """Read one 2-D plane of an image file, in the JAX package's order: a
    container by its linear page index, then the C++ TIFF reader, the
    Python TIFF reader (``.tif``/``.tiff``), then what the JAX package
    hands to ``cv2`` (:func:`decode_image_file`: BMP, every JPEG cv2
    reads -- baseline, progressive, arithmetic-coded or lossless, grey,
    colour, CMYK or YCCK --, PNG, PBM/PGM/PPM/PAM, and the TIFF pages cv2
    reads, SGILog among them),
    colour converted to grey as cv2 converts it.  Pages are read as asked
    where the reference's cv2 path reads page 0 (ROADMAP C).  A file no
    reader takes raises :class:`~tmlibrary_tpu_torch.errors.MetadataError`."""

    def __enter__(self):
        self._container = _open_container(self.filename)
        return self

    def __exit__(self, *exc):
        if getattr(self, "_container", None) is not None:
            self._container.__exit__()
            self._container = None
        return False

    def read(self, page: int = 0) -> np.ndarray:
        container = getattr(self, "_container", None)
        if container is not None:
            return _container_plane(container, page)
        out = read_container_plane(self.filename, page)  # non-context use
        if out is not None:
            return out
        img = native.tiff_read_page(self.filename, page)
        if img is not None:
            return img
        if str(self.filename).lower().endswith((".tif", ".tiff")):
            img = read_tiff_page_py(self.filename, page)
            if img is not None:
                return img
        if not self.filename.exists():
            raise FileNotFoundError(f"cannot read image: {self.filename}")
        img = decode_image_file(self.filename, page)
        if img is not None:
            return img
        raise MetadataError(f"cannot read image {self.filename}: no reader of the port "
                            "decodes it")


class BFImageReader(Reader):
    """Bio-Formats-compatible facade over the first-party container
    readers.

    The reference reads vendor microscope formats through the Java
    Bio-Formats library (``python-bioformats``/``javabridge``,
    ``tmlib/readers.py`` ``BFImageReader.read(filename)``).  This image
    has no JVM; instead the call delegates to the native parsers —
    Nikon ND2, Zeiss CZI/LSM, Leica LIF, DeltaVision DV/R3D,
    MetaMorph STK, Olympus OIF/OIB, Opera FLEX, Imaris IMS, OME-NGFF — and
    to the plain TIFF/PNG path for everything else, so reference analysis
    scripts using this class keep working for every format the port reads.
    An unsupported file still raises a clear
    :class:`~tmlibrary_tpu_torch.errors.NotSupportedError` up front instead of
    failing deep inside a job.
    """

    def read(self, page: int = 0) -> np.ndarray:
        # MetadataError (corrupt/truncated container; a colour image,
        # which the reference reads through cv2) propagates as-is —
        # it names the structural problem; only "nothing can read this
        # EXISTING file" becomes the NotSupportedError of the reference's
        # API contract.  A missing path is a path problem, not a format
        # problem — advising format conversion for a typo would mislead.
        try:
            return ImageReader(self.filename).read(page)
        except (OSError, ValueError, NotSupportedError) as exc:
            if not self.filename.exists():
                raise FileNotFoundError(
                    f"no such image file: {self.filename}"
                ) from exc
            raise NotSupportedError(
                f"no native reader for {self.filename} (Bio-Formats/JVM "
                "is not available; supported containers: nd2, czi, lif, "
                "dv/r3d, ims, stk, lsm, oif/oib, flex, zarr, plus "
                "TIFF/PNG) — convert other vendor containers to one of "
                f"these: {exc}"
            ) from exc


class ND2Reader(Reader):
    """First-party reader for Nikon NIS-Elements ``.nd2`` containers
    (modern chunk-map layout, "v3").

    The reference reads ND2 through the Java Bio-Formats library; this
    is a parser with no JVM for the common high-content layout: XY-position sequences x
    interleaved channel components, uint16.

    Container structure parsed here:

    - every chunk starts with a 16-byte header ``<u32 magic=0x0ABECEDA>
      <u32 name_len> <u64 data_len>`` followed by the ASCII chunk name
      (ending ``!``) and ``data_len`` bytes of payload;
    - the last 8 bytes of the file hold the offset of the chunk-map
      chunk, whose payload lists ``name + <u64 offset> <u64 size>``
      entries terminated by the map's own signature name;
    - ``ImageAttributesLV!`` holds dimensions in the "lite variants"
      key-value encoding (``uiWidth``/``uiHeight``/``uiComp``/
      ``uiBpcInMemory``/``uiSequenceCount`` under ``SLxImageAttributes``);
    - ``ImageDataSeq|<n>!`` holds one sequence's pixels: an 8-byte
      acquisition timestamp (f64) followed by row-major uint16 samples
      interleaved across components.

    Acquisition loops (time / XY-position / Z-stack nesting) decode from
    the ``ImageMetadataLV!`` SLxExperiment tree (:meth:`loop_shape` /
    :meth:`seq_coords`), with an unmodeled or inconsistent experiment
    falling back to flat sequences-as-sites; compressed payloads or
    non-uint16 samples raise
    :class:`~tmlibrary_tpu_torch.errors.MetadataError` with a clear message
    rather than mis-decoding.
    """

    MAGIC = 0x0ABECEDA
    SIG_FILE = b"ND2 FILE SIGNATURE CHUNK NAME01!"
    SIG_MAP = b"ND2 CHUNK MAP SIGNATURE 0000001!"

    def __enter__(self):
        # mmap, not read_bytes(): imextract's thread pool opens one reader
        # per plane, and holding whole multi-GB containers per thread would
        # OOM the host — the chunk map lets every access touch only its
        # own chunk's pages
        self._file = open(self.filename, "rb")
        try:
            self._data = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as exc:  # empty file
            self._file.close()
            raise MetadataError(f"not an ND2 v3 container: {self.filename}") from exc
        if len(self._data) < 56 or self._data[16:48] != self.SIG_FILE:
            self.__exit__()
            raise MetadataError(f"not an ND2 v3 container: {self.filename}")
        try:
            self._chunks = self._parse_chunk_map()
            attrs = self._attributes()
        except MetadataError:
            self.__exit__()
            raise
        except (struct.error, OverflowError, IndexError, ValueError,
                UnicodeDecodeError) as exc:
            # a truncated file keeps a valid signature but its trailing
            # bytes parse as garbage offsets — callers (the nd2 metaconfig
            # handler) skip on MetadataError, not on raw struct errors
            self.__exit__()
            raise MetadataError(
                f"corrupt ND2 container {self.filename}: "
                f"{type(exc).__name__}: {exc}"
            ) from exc
        try:
            # .get + coercion guard: a corrupt LV tree can drop uiHeight
            # or retype any value to a string/bytes (fuzz-caught) — both
            # must land in the nonsensical-attributes MetadataError below
            self.width = int(attrs.get("uiWidth", 0))
            self.height = int(attrs.get("uiHeight", 0))
            self.n_components = int(attrs.get("uiComp", 1))
            self.bits = int(attrs.get("uiBpcInMemory", 16))
        except (TypeError, ValueError):
            self.width = self.height = self.n_components = -1
            self.bits = 16
        if self.width <= 0 or self.height <= 0 or self.n_components < 1:
            # uiComp=0 would reach divmod(page, 0) at decode time
            self.__exit__()
            raise MetadataError(
                f"{self.filename}: nonsensical attributes (width="
                f"{self.width}, height={self.height}, "
                f"components={self.n_components})"
            )
        if self.bits != 16:
            self.__exit__()
            raise MetadataError(
                f"{self.filename}: only uint16 ND2 payloads are supported "
                f"(uiBpcInMemory={self.bits})"
            )
        # eCompression per the public nd2 attribute convention:
        # 0 = lossless (zlib stream after the 8-byte timestamp),
        # 1 = lossy (JPEG2000 — no first-party decoder), else/absent = raw
        comp = attrs.get("eCompression")
        self._lossless = comp == 0
        if comp == 1:
            self.__exit__()
            raise NotSupportedError(
                f"{self.filename}: lossy-compressed ND2 (eCompression=1) "
                "is not supported (lossless zlib and uncompressed are)"
            )
        n_chunks = sum(1 for n in self._chunks if n.startswith(b"ImageDataSeq|"))
        try:
            declared = int(attrs.get("uiSequenceCount", n_chunks))
        except (TypeError, ValueError):
            # same corrupt-retyped-LV-value class as the block above:
            # fall back to counting what was actually written
            declared = n_chunks
        # an aborted acquisition can declare more sequences than were
        # written; trusting the attribute would emit phantom planes
        self.n_sequences = min(declared, n_chunks)
        return self

    def __exit__(self, *exc):
        if getattr(self, "_data", None) is not None:
            try:
                self._data.close()
            except (ValueError, AttributeError):
                pass
            self._data = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None
        return False

    # ------------------------------------------------------------ container
    def _chunk_payload(self, offset: int) -> bytes:
        magic, name_len, data_len = struct.unpack_from("<IIQ", self._data, offset)
        if magic != self.MAGIC:
            raise MetadataError(
                f"{self.filename}: bad chunk magic at offset {offset}"
            )
        start = offset + 16 + name_len
        return bytes(self._data[start:start + data_len])

    def _parse_chunk_map(self) -> dict[bytes, int]:
        (map_offset,) = struct.unpack_from("<Q", self._data, len(self._data) - 8)
        payload = self._chunk_payload(map_offset)
        chunks: dict[bytes, int] = {}
        pos = 0
        while pos < len(payload):
            end = payload.find(b"!", pos)
            if end < 0:
                raise MetadataError(f"{self.filename}: corrupt chunk map")
            name = payload[pos:end + 1]
            if name == self.SIG_MAP:
                break
            offset, _size = struct.unpack_from("<QQ", payload, end + 1)
            chunks[name] = offset
            pos = end + 1 + 16
        if not chunks:
            raise MetadataError(f"{self.filename}: empty chunk map")
        return chunks

    # ------------------------------------------------------- LV metadata
    @classmethod
    def _parse_lv(cls, buf: bytes, pos: int = 0, end: int | None = None) -> dict:
        """Parse "lite variants" key-value metadata: ``<u8 type><u8 name
        chars>`` + UTF-16LE name, value by type (1 u8, 2 i32, 3 u32,
        4 u64, 5 f64, 6 UTF-16 string, 8 length-prefixed bytes,
        11 nested compound with ``<u32 count><u64 byte length>``)."""
        out: dict = {}
        next_suffix: dict = {}

        def store(name, value):
            # list compounds (e.g. XYPosLoop Points) repeat one name per
            # element; index-suffix later occurrences so every element
            # survives into the dict in document order instead of each
            # overwriting the last
            if name in out:
                i = next_suffix.get(name, 1)
                while f"{name}~{i}" in out:
                    i += 1
                next_suffix[name] = i + 1
                name = f"{name}~{i}"
            out[name] = value

        end = len(buf) if end is None else end
        while pos < end - 1:
            vtype, name_chars = struct.unpack_from("<BB", buf, pos)
            pos += 2
            name = buf[pos:pos + 2 * name_chars].decode("utf-16-le").rstrip("\x00")
            pos += 2 * name_chars
            if vtype == 1:
                store(name, buf[pos])
                pos += 1
            elif vtype == 2:
                store(name, struct.unpack_from("<i", buf, pos)[0])
                pos += 4
            elif vtype == 3:
                store(name, struct.unpack_from("<I", buf, pos)[0])
                pos += 4
            elif vtype == 4:
                store(name, struct.unpack_from("<Q", buf, pos)[0])
                pos += 8
            elif vtype == 5:
                store(name, struct.unpack_from("<d", buf, pos)[0])
                pos += 8
            elif vtype == 6:
                stop = pos
                while stop < end and buf[stop:stop + 2] != b"\x00\x00":
                    stop += 2
                store(name, buf[pos:stop].decode("utf-16-le"))
                pos = stop + 2
            elif vtype == 8:
                (blen,) = struct.unpack_from("<Q", buf, pos)
                store(name, buf[pos + 8:pos + 8 + blen])
                pos += 8 + blen
            elif vtype == 11:
                _count, blen = struct.unpack_from("<IQ", buf, pos)
                pos += 12
                store(name, cls._parse_lv(buf, pos, pos + blen))
                pos += blen
            else:
                raise MetadataError(
                    f"unsupported LV value type {vtype} for key '{name}'"
                )
        return out

    def _attributes(self) -> dict:
        off = self._chunks.get(b"ImageAttributesLV!")
        if off is None:
            raise MetadataError(f"{self.filename}: no ImageAttributesLV chunk")
        tree = self._parse_lv(self._chunk_payload(off))
        # attributes live under an SLxImageAttributes compound
        for v in tree.values():
            if isinstance(v, dict) and "uiWidth" in v:
                return v
        if "uiWidth" in tree:
            return tree
        raise MetadataError(f"{self.filename}: uiWidth missing from attributes")

    # -------------------------------------------------------- loop shape
    #: SLxExperiment eType -> axis kind (values per the public nd2
    #: loop-type enum: TimeLoop=1, XYPosLoop=2, ZStackLoop=4,
    #: NETimeLoop=8); anything else is unmodeled
    _LOOP_KINDS = {1: "T", 2: "XY", 4: "Z", 8: "T"}

    def loop_shape(self) -> "list[tuple[str, int]] | None":
        """Ordered acquisition loops (outermost first, innermost varies
        fastest in the sequence index): ``[("T"|"XY"|"Z", size), ...]``
        from the ``ImageMetadataLV!`` SLxExperiment tree — or None when
        the chunk is absent, a loop type is unmodeled, a kind repeats,
        or the loop product does not equal the written sequence count
        (callers then fall back to sequences = flat sites, the
        pre-loop-support behavior).  Parsed once per open reader."""
        if not hasattr(self, "_loops"):
            self._loops = self._compute_loop_shape()
        return self._loops

    def _compute_loop_shape(self) -> "list[tuple[str, int]] | None":
        off = self._chunks.get(b"ImageMetadataLV!")
        if off is None:
            return None
        try:
            tree = self._parse_lv(self._chunk_payload(off))
        except (MetadataError, struct.error, OverflowError, IndexError,
                UnicodeDecodeError):
            return None

        def find_level(node):
            if isinstance(node, dict):
                if "eType" in node:
                    return node
                for v in node.values():
                    found = find_level(v)
                    if found is not None:
                        return found
            return None

        def find_experiment(node):
            # anchor on the SLxExperiment compound: other metadata
            # blocks carry their own 'eType' fields, and the first one
            # in tree order would silently defeat loop decode
            if isinstance(node, dict):
                exp = node.get("SLxExperiment")
                if isinstance(exp, dict):
                    return exp
                for v in node.values():
                    found = find_experiment(v)
                    if found is not None:
                        return found
            return None

        loops: list = []
        experiment = find_experiment(tree)
        level = find_level(experiment if experiment is not None else tree)
        while level is not None:
            kind = self._LOOP_KINDS.get(level.get("eType"))
            size = level.get("uiLoopSize") or (
                level.get("uLoopPars") or {}
            ).get("uiCount")
            if kind is None or not isinstance(size, int) or size < 1:
                return None
            if any(k == kind for k, _ in loops):
                return None  # nested loops of one kind are unmodeled
            if kind == "XY":
                self._xy_level = level  # stage positions live here
            loops.append((kind, size))
            level = find_level(level.get("ppNextLevelEx"))
        product = 1
        for _, size in loops:
            product *= size
        if not loops or product != self.n_sequences:
            return None
        return loops

    def xy_positions(self) -> "list[tuple[float, float]] | None":
        """(stage_y, stage_x) per XY position, from the XYPosLoop's
        ``uLoopPars`` point list — or None when the loop structure is
        unmodeled or the point count disagrees with the loop size.  The
        nd2 handler turns these into within-well grid coordinates."""
        loops = self.loop_shape()  # also binds self._xy_level
        level = getattr(self, "_xy_level", None)
        if not loops or level is None:
            return None
        n_xy = dict(loops).get("XY")

        def collect(node, out):
            if isinstance(node, dict):
                x, y = node.get("dPosX"), node.get("dPosY")
                if isinstance(x, (int, float)) and isinstance(y, (int, float)):
                    out.append((float(y), float(x)))
                    return  # a point's children are calibration noise
                # document order, NOT sorted(): point keys are not
                # guaranteed zero-padded, and 'a10' sorts before 'a2' —
                # same convention as channel_names' plane iteration
                for v in node.values():
                    collect(v, out)

        points: list = []
        collect(level.get("uLoopPars"), points)
        return points if n_xy and len(points) == n_xy else None

    def channel_names(self) -> "list[str] | None":
        """Component names from ``ImageMetadataSeqLV|0!``'s
        ``SLxPictureMetadata.sPicturePlanes`` plane descriptions
        (``sDescription`` per plane compound, key order = component
        order) — or None when absent or disagreeing with the component
        count.  Names are a courtesy: any parse problem degrades to the
        ``C00``… fallback."""
        off = self._chunks.get(b"ImageMetadataSeqLV|0!")
        if off is None:
            return None
        try:
            tree = self._parse_lv(self._chunk_payload(off))
        except (MetadataError, struct.error, OverflowError, IndexError,
                UnicodeDecodeError):
            return None

        def find(node, key):
            if isinstance(node, dict):
                if key in node and isinstance(node[key], dict):
                    return node[key]
                for v in node.values():
                    found = find(v, key)
                    if found is not None:
                        return found
            return None

        planes = find(tree, "sPicturePlanes")
        if planes is None:
            return None
        # insertion order IS component order (_parse_lv preserves the
        # document order); sorting keys would put "a10" before "a2" and
        # silently mislabel every channel past the ninth
        names = [
            str(v["sDescription"])
            for v in planes.values()
            if isinstance(v, dict) and isinstance(v.get("sDescription"), str)
        ]
        if len(names) != self.n_components or not any(names):
            return None
        return names

    def seq_coords(self, sequence: int) -> tuple[int, int, int]:
        """(xy_position, zplane, tpoint) of a sequence index under
        :meth:`loop_shape`; flat ``(sequence, 0, 0)`` without loops."""
        loops = self.loop_shape()
        if not loops:
            return sequence, 0, 0
        coords = {"XY": 0, "Z": 0, "T": 0}
        rem = sequence
        for kind, size in reversed(loops):  # innermost varies fastest
            rem, coords[kind] = divmod(rem, size)
        return coords["XY"], coords["Z"], coords["T"]

    # ------------------------------------------------------------- pixels
    def read_plane(self, sequence: int, component: int = 0) -> np.ndarray:
        """One ``(height, width)`` uint16 plane: ``sequence`` selects the
        ``ImageDataSeq`` chunk (XY position), ``component`` the interleaved
        channel."""
        if not 0 <= component < self.n_components:
            raise MetadataError(
                f"component {component} out of range 0..{self.n_components - 1}"
            )
        name = b"ImageDataSeq|%d!" % sequence
        off = self._chunks.get(name)
        if off is None:
            raise MetadataError(
                f"{self.filename}: no sequence {sequence} "
                f"(have {self.n_sequences})"
            )
        try:
            payload = self._chunk_payload(off)
        except (struct.error, OverflowError) as exc:
            # a chunk-map offset near EOF surfaces here at READ time; the
            # skip-on-MetadataError contract must hold on this path too
            raise MetadataError(
                f"{self.filename}: corrupt sequence chunk {sequence}: {exc}"
            ) from exc
        n_px = self.height * self.width * self.n_components
        if getattr(self, "_lossless", False):
            try:
                # max_length bounds the expansion: a crafted chunk must
                # fail the size check below, not OOM the ingest job.
                # Requested one byte PAST the expectation so an oversized
                # stream is detectable — it means mis-modeled geometry or
                # component count, and truncating it would hand back
                # plausible-looking wrong pixels (overflow
                # and shortfall are both MetadataError)
                decoded = zlib.decompressobj().decompress(
                    payload[8:], 2 * n_px + 1)
            except zlib.error as exc:
                raise MetadataError(
                    f"{self.filename}: corrupt lossless sequence "
                    f"{sequence}: {exc}"
                ) from exc
            if len(decoded) != 2 * n_px:
                raise MetadataError(
                    f"{self.filename}: lossless sequence {sequence} "
                    f"decodes to {'>' if len(decoded) > 2 * n_px else ''}"
                    f"{len(decoded)} bytes, expected {2 * n_px}"
                )
            samples = np.frombuffer(decoded, np.uint16, count=n_px)
            plane = samples.reshape(self.height, self.width,
                                    self.n_components)
            return np.ascontiguousarray(plane[:, :, component])
        expect = 8 + 2 * n_px  # f64 timestamp + uint16 samples
        if len(payload) < expect:
            raise MetadataError(
                f"{self.filename}: sequence {sequence} holds "
                f"{len(payload)} bytes, expected {expect}"
            )
        samples = np.frombuffer(payload, np.uint16, count=n_px, offset=8)
        plane = samples.reshape(self.height, self.width, self.n_components)
        return np.ascontiguousarray(plane[:, :, component])

    def timestamp(self, sequence: int) -> float:
        """Acquisition timestamp (ms since experiment start) of a sequence."""
        off = self._chunks.get(b"ImageDataSeq|%d!" % sequence)
        if off is None:
            raise MetadataError(
                f"{self.filename}: no sequence {sequence} "
                f"(have {self.n_sequences})"
            )
        try:
            return struct.unpack_from("<d", self._chunk_payload(off), 0)[0]
        except (struct.error, OverflowError) as exc:
            raise MetadataError(
                f"{self.filename}: corrupt sequence chunk {sequence}: {exc}"
            ) from exc


def _czi_zstd_plane(raw: bytes, h: int, w: int, zstd1: bool, filename,
                    itemsize: int = 2) -> np.ndarray:
    """A zstd-compressed Gray8/Gray16 CZI subblock payload as an ``(h, w)``
    plane, decoded by the port's Zstandard decoder
    (:func:`tmlibrary_tpu_torch.native.zstd_decompress`).

    ``zstd0`` (compression 5) is a bare frame.  ``zstd1`` (6, ZEN's
    default) prefixes a header -- byte 0 its size including itself, then
    (field id, value) byte pairs -- whose field 1 set means the
    uncompressed stream holds all low bytes, then all high bytes (libCZI's
    hi-lo packing), re-interleaved here; on an 8-bit subblock that flag is
    an error.  A frame declaring another size than the plane's is refused
    before it is decoded; the first frame is decoded and what follows it
    ignored.  Counterpart: ``tmlibrary_tpu/readers.py:860-929``, with its
    messages."""
    expect = itemsize * h * w
    hilo = False
    if zstd1:
        if not raw or raw[0] < 1 or raw[0] > len(raw):
            raise MetadataError(f"corrupt zstd1 subblock header in {filename}")
        fields = raw[1:raw[0]]
        for i in range(0, len(fields) - 1, 2):
            if fields[i] == 1:
                hilo = bool(fields[i + 1])
        raw = raw[raw[0]:]
    try:
        declared = native.zstd_frame_content_size(raw)
        if declared not in (-1, expect):
            raise MetadataError(
                f"zstd subblock in {filename} declares {declared} bytes, expected {expect}")
        out = native.zstd_decompress(raw, expect, all_frames=False)
    except MetadataError as exc:
        if "declares" in str(exc):
            raise
        raise MetadataError(f"corrupt zstd subblock in {filename}: {exc}") from exc
    if len(out) != expect:
        raise MetadataError(
            f"zstd subblock in {filename} decodes to {len(out)} bytes, expected {expect}")
    if hilo:
        if itemsize != 2:
            raise MetadataError(
                f"zstd1 hi-lo packing on a non-16-bit subblock in {filename}")
        half = expect // 2
        lo = np.frombuffer(out, np.uint8, count=half)
        hi = np.frombuffer(out, np.uint8, count=half, offset=half)
        return (lo.astype(np.uint16) | (hi.astype(np.uint16) << 8)).reshape(h, w)
    dtype = np.uint8 if itemsize == 1 else np.dtype("<u2")
    return np.frombuffer(out, dtype).reshape(h, w).copy()


def _jpeg_plane(raw: bytes, h: int, w: int, dtype, filename) -> np.ndarray:
    """A JPEG (compression 1, ZEN's legacy lossy option) CZI subblock as an
    ``(h, w)`` plane of ``dtype``, decoded by the port's JPEG decoder
    (:func:`tmlibrary_tpu_torch.native.jpeg_decode_array`: every stream
    cv2 reads), colour converted to grey as cv2
    converts it; a stream it cannot decode or another geometry than the
    directory's raises :class:`MetadataError`.  Counterpart:
    ``tmlibrary_tpu/readers.py:1324-1354`` (``cv2.imdecode`` and
    ``cvtColor``)."""
    try:
        img = native.jpeg_decode_array(raw)
    except MetadataError as exc:
        raise MetadataError(f"{filename}: corrupt JPEG subblock: {exc}") from exc
    if img.ndim == 3:
        img = png.to_gray(img)
    if img.shape != (h, w):
        raise MetadataError(
            f"{filename}: JPEG subblock decodes to {img.shape}, directory says {(h, w)}")
    return np.asarray(img, dtype)


class CZIReader(Reader):
    """First-party reader for Zeiss ``.czi`` containers (ZISRAW layout).

    Covers the common high-content layout: scene (S) × mosaic tile (M) ×
    channel (C) × z (Z) × time (T) Gray8/Gray16 subblocks.

    Container structure parsed here:

    - the file is a sequence of segments, each with a 32-byte header:
      16-byte ASCII id (null-padded), ``<i64 allocated_size>``
      ``<i64 used_size>``, then the payload;
    - ``ZISRAWFILE`` (at offset 0) holds the directory position at payload
      offset 36 (``major, minor, reserved×2, guid×2, file_part`` precede);
    - ``ZISRAWDIRECTORY`` lists ``DirectoryEntryDV`` records: pixel type,
      file position, compression, and per-dimension
      ``(name, start, size, …)`` entries (X/Y/C/Z/T/S/M);
    - ``ZISRAWSUBBLOCK`` holds ``metadata_size, attachment_size,
      data_size`` + its own directory entry; pixel data starts at payload
      offset ``max(256, 16 + entry_size) + metadata_size``.

    Gray8/Gray16 planes decode uncompressed, JPEG (1) through
    :func:`_jpeg_plane` and zstd0/zstd1 (5, 6) through
    :func:`_czi_zstd_plane`; mosaic tiles (M dimension, slide scans) read
    per tile with pyramid copies skipped.  JPEG-XR (4) and float files
    raise :class:`~tmlibrary_tpu_torch.errors.MetadataError` as the JAX
    package does.
    """

    #: DirectoryEntryDV pixel types handled -> numpy dtype
    #: (0 = Gray8, 1 = Gray16 per the public ZISRAW enum)
    _PIXEL_DTYPES = {0: np.dtype(np.uint8), 1: np.dtype("<u2")}

    def __enter__(self):
        self._file = open(self.filename, "rb")
        try:
            self._data = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as exc:
            self._file.close()
            raise MetadataError(f"not a CZI container: {self.filename}") from exc
        if len(self._data) < 64 or self._data[0:10] != b"ZISRAWFILE":
            self.__exit__()
            raise MetadataError(f"not a CZI container: {self.filename}")
        try:
            payload = self._segment_payload(0, b"ZISRAWFILE")
            # FileHeaderSegment: major(4) minor(4) reserved(4+4)
            # primary_guid(16) file_guid(16) file_part(4) = 52 bytes,
            # then DirectoryPosition(i64)
            (dir_pos,) = struct.unpack_from("<q", payload, 52)
            # MetadataPosition follows DirectoryPosition; 0/absent = none
            (meta_pos,) = (
                struct.unpack_from("<q", payload, 60)
                if len(payload) >= 68 else (0,)
            )
            self.channel_names = self._channel_names_from_xml(meta_pos)
            all_planes = self._parse_directory(dir_pos)
            # pyramidal files interleave subsampled copies with the
            # acquisition planes; only pyramid-0 subblocks are data
            self._planes = [p for p in all_planes if not p["pyramid"]]
            if not self._planes:
                raise MetadataError(
                    f"{self.filename}: only pyramid subblocks present"
                )
            # every plane needs X/Y dims NOW: a corrupt entry without
            # them would KeyError at read time, past the skip-unreadable
            # guard (fuzz-caught)
            for p in self._planes:
                if "w" not in p or "h" not in p or p["w"] <= 0 or p["h"] <= 0:
                    raise MetadataError(
                        f"{self.filename}: subblock entry without valid "
                        "X/Y dimensions"
                    )
            # raw dimension starts need not be 0-based (substack
            # acquisitions): normalize EVERY axis through sorted id lists
            self._scene_ids = sorted({p["S"] for p in self._planes})
            self._channel_ids = sorted({p["C"] for p in self._planes})
            self._z_ids = sorted({p["Z"] for p in self._planes})
            self._t_ids = sorted({p["T"] for p in self._planes})
            # mosaic tiles rank PER SCENE: ZEN commonly numbers M
            # globally across scenes (scene 0: 0..5, scene 1: 6..11), so
            # a global id list would leave most (scene, tile) pairs empty
            tiles_by_scene: dict = {}
            for p in self._planes:
                tiles_by_scene.setdefault(p["S"], set()).add(p["M"])
            tile_counts = {len(v) for v in tiles_by_scene.values()}
            if len(tile_counts) != 1:
                raise MetadataError(
                    f"{self.filename}: scenes carry differing mosaic "
                    f"tile counts {sorted(len(v) for v in tiles_by_scene.values())}"
                )
            self.n_tiles = tile_counts.pop()
            tile_rank = {
                (s, m): i
                for s, ms in tiles_by_scene.items()
                for i, m in enumerate(sorted(ms))
            }
            # O(1) lookups: a linear scan per plane would be O(planes^2)
            # over a production-scale subblock directory
            self._plane_index = {
                (p["S"], tile_rank[(p["S"], p["M"])],
                 p["C"], p["Z"], p["T"]): p
                for p in self._planes
            }
            # per-(scene, tile) mosaic pixel origin (first plane wins;
            # c/z/t share the tile's frame) — adjacency for slide scans
            self._tile_origins: dict = {}
            for p in self._planes:
                key = (p["S"], tile_rank[(p["S"], p["M"])])
                self._tile_origins.setdefault(
                    key, (p.get("y0", 0), p.get("x0", 0))
                )
            # a sparse or duplicated (scene, tile, c, z, t) grid would
            # fail mid-extract with half the sites written; fail the OPEN
            # instead so the handler skips the file with a logged reason
            expected = (
                len(self._scene_ids) * self.n_tiles
                * len(self._channel_ids) * len(self._z_ids)
                * len(self._t_ids)
            )
            if len(self._plane_index) != len(self._planes):
                raise MetadataError(
                    f"{self.filename}: duplicate subblocks for one "
                    "(scene, tile, channel, z, t) coordinate"
                )
            if len(self._planes) != expected:
                raise MetadataError(
                    f"{self.filename}: sparse subblock grid "
                    f"({len(self._planes)} planes for {expected} "
                    "coordinates)"
                )
            self.width = self._planes[0]["w"]
            self.height = self._planes[0]["h"]
        except MetadataError:
            self.__exit__()
            raise
        except (struct.error, OverflowError, IndexError, KeyError,
                ValueError) as exc:
            self.__exit__()
            raise MetadataError(
                f"corrupt CZI container {self.filename}: "
                f"{type(exc).__name__}: {exc}"
            ) from exc
        self.n_scenes = len(self._scene_ids)
        self.n_channels = len(self._channel_ids)
        self.n_zplanes = len(self._z_ids)
        self.n_tpoints = len(self._t_ids)
        if self.channel_names is not None and len(self.channel_names) != (
            self.n_channels
        ):
            # a substack/split export keeps the full acquisition's XML
            # channel list: labeling rank c with names[c] would silently
            # mislabel scientific data — degrade to C00… instead
            self.channel_names = None
        return self

    def __exit__(self, *exc):
        if getattr(self, "_data", None) is not None:
            try:
                self._data.close()
            except (ValueError, AttributeError):
                pass
            self._data = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None
        return False

    # ------------------------------------------------------------ container
    def _segment_payload(self, offset: int, expect: bytes) -> bytes:
        sid = bytes(self._data[offset:offset + 16]).rstrip(b"\x00")
        if sid != expect:
            raise MetadataError(
                f"{self.filename}: expected {expect.decode()} segment at "
                f"{offset}, found {sid!r}"
            )
        _alloc, used = struct.unpack_from("<qq", self._data, offset + 16)
        return bytes(self._data[offset + 32:offset + 32 + used])

    @staticmethod
    def _parse_entry(buf: bytes, pos: int) -> tuple[dict, int]:
        """One DirectoryEntryDV at ``pos`` → (plane dict, end pos)."""
        if buf[pos:pos + 2] != b"DV":
            raise MetadataError("directory entry is not DV-typed")
        pixel_type, file_pos, _file_part, compression = struct.unpack_from(
            "<iqii", buf, pos + 2
        )
        (dim_count,) = struct.unpack_from("<i", buf, pos + 28)
        plane = {
            "pixel_type": pixel_type,
            "compression": compression,
            "file_pos": file_pos,
            # pyramid byte follows compression: non-zero marks a
            # subsampled copy of tiles, not an acquisition plane
            "pyramid": buf[pos + 22] != 0,
            "C": 0, "Z": 0, "T": 0, "S": 0, "M": 0,
        }
        p = pos + 32
        for _ in range(dim_count):
            name = buf[p:p + 4].rstrip(b"\x00").decode("ascii", "replace")
            start, size = struct.unpack_from("<ii", buf, p + 4)
            if name == "X":
                # start = the tile's pixel origin in the mosaic frame —
                # the adjacency information the spatial layout needs
                plane["w"] = size
                plane["x0"] = start
            elif name == "Y":
                plane["h"] = size
                plane["y0"] = start
            elif name in ("C", "Z", "T", "S", "M"):
                # M = mosaic tile index (slide scans / large areas): each
                # tile is exposed as its own plane, tiles -> sites
                plane[name] = start
            p += 20
        return plane, p

    def _channel_names_from_xml(self, meta_pos: int) -> "list[str] | None":
        """Channel names from the ZISRAWMETADATA document
        (``Information/Image/Dimensions/Channels/Channel`` ``Name``
        attributes, in element order = C index order), or None — names
        are a courtesy, so ANY parse problem degrades to the ``C00``
        fallback rather than failing the open."""
        if meta_pos <= 0:
            return None
        try:
            payload = self._segment_payload(meta_pos, b"ZISRAWMETADATA")
            # MetadataSegment data: xml_size(i32) attachment_size(i32)
            # + 248 spare bytes, then the XML document
            (xml_size,) = struct.unpack_from("<i", payload, 0)
            # bytes, not a decoded str: an XML encoding declaration makes
            # fromstring(str) raise and would silently drop valid names
            root = ElementTree.fromstring(bytes(payload[256:256 + xml_size]))
        except Exception:
            return None

        def child(node, local):
            for el in node:
                if el.tag.rsplit("}", 1)[-1] == local:
                    return el
            return None

        # the EXPLICIT Information/Image/Dimensions/Channels path: ZEN
        # documents carry other Channels lists (DisplaySetting,
        # acquisition blocks) that can precede it in document order
        node = root
        if node.tag.rsplit("}", 1)[-1] != "Metadata":
            meta = child(node, "Metadata")
            node = node if meta is None else meta  # Element truthiness trap
        for local in ("Information", "Image", "Dimensions", "Channels"):
            node = child(node, local)
            if node is None:
                return None
        names = [
            ch.get("Name") or ""
            for ch in node
            if ch.tag.rsplit("}", 1)[-1] == "Channel"
        ]
        return names if any(names) else None

    def _parse_directory(self, dir_pos: int) -> list[dict]:
        payload = self._segment_payload(dir_pos, b"ZISRAWDIRECTORY")
        (count,) = struct.unpack_from("<i", payload, 0)
        pos = 128  # 4-byte count + 124 reserved
        planes = []
        for _ in range(count):
            plane, pos = self._parse_entry(payload, pos)
            planes.append(plane)
        if not planes:
            raise MetadataError(f"{self.filename}: empty subblock directory")
        return planes

    # ------------------------------------------------------------- pixels
    def read_plane(
        self, scene: int = 0, channel: int = 0, zplane: int = 0,
        tpoint: int = 0, tile: int = 0
    ) -> np.ndarray:
        for name, idx, n in (
            ("scene", scene, self.n_scenes),
            ("tile", tile, self.n_tiles),
            ("channel", channel, self.n_channels),
            ("zplane", zplane, self.n_zplanes),
            ("tpoint", tpoint, self.n_tpoints),
        ):
            if not 0 <= idx < n:
                # a negative index would silently WRAP through the sorted
                # id lists; match the sibling readers' MetadataError contract
                raise MetadataError(
                    f"{self.filename}: {name} {idx} out of range 0..{n - 1}"
                )
        plane = self._plane_index.get((
            self._scene_ids[scene],
            tile,  # already a per-scene rank (see __enter__)
            self._channel_ids[channel],
            self._z_ids[zplane],
            self._t_ids[tpoint],
        ))
        if plane is None:
            raise MetadataError(
                f"{self.filename}: no subblock for "
                f"scene={scene} tile={tile} channel={channel} "
                f"z={zplane} t={tpoint}"
            )
        compression = plane["compression"]
        if compression not in (0, 1, 5, 6):
            # 4 = JPEG-XR: no conformant decoder in either package
            raise MetadataError(
                f"{self.filename}: compressed CZI subblocks "
                f"(compression={compression}) are not supported "
                "(JPEG-XR is read by neither package)"
            )
        dtype = self._PIXEL_DTYPES.get(plane["pixel_type"])
        if dtype is None:
            raise MetadataError(
                f"{self.filename}: only Gray8/Gray16 subblocks are "
                f"supported (pixel_type={plane['pixel_type']})"
            )
        payload_off = plane["file_pos"] + 32
        sid = bytes(self._data[plane["file_pos"]:plane["file_pos"] + 16])
        if sid.rstrip(b"\x00") != b"ZISRAWSUBBLOCK":
            raise MetadataError(
                f"{self.filename}: directory points at a non-subblock segment"
            )
        try:
            meta_size, _att_size, data_size = struct.unpack_from(
                "<iiq", self._data, payload_off
            )
            # the DV entry embedded in the subblock mirrors the directory's;
            # data starts after max(256, 16 + entry bytes) + metadata
            entry_buf = bytes(
                self._data[payload_off + 16:payload_off + 16 + 32 + 20 * 16]
            )
            _, entry_end = self._parse_entry(entry_buf, 0)
        except (struct.error, OverflowError, IndexError) as exc:
            # truncation inside the subblock header surfaces at READ
            # time; the skip-on-MetadataError contract must hold here too
            raise MetadataError(
                f"{self.filename}: corrupt subblock at "
                f"{plane['file_pos']}: {exc}"
            ) from exc
        data_off = payload_off + max(256, 16 + entry_end) + meta_size
        h, w = plane["h"], plane["w"]
        expect = dtype.itemsize * h * w
        if compression != 0:
            if data_size <= 0 or data_off + data_size > len(self._data):
                raise MetadataError(
                    f"{self.filename}: compressed subblock claims "
                    f"{data_size} bytes, {len(self._data) - data_off} in file"
                )
            raw = bytes(self._data[data_off:data_off + data_size])
            if compression == 1:
                return _jpeg_plane(raw, h, w, dtype, self.filename)
            return _czi_zstd_plane(raw, h, w, compression == 6, self.filename,
                                   itemsize=dtype.itemsize)
        if data_size < expect or data_off + expect > len(self._data):
            # data_size is the writer's CLAIM; a truncated file can keep an
            # intact directory while the pixels run past EOF
            raise MetadataError(
                f"{self.filename}: subblock holds {data_size} bytes "
                f"({len(self._data) - data_off} in file), expected {expect}"
            )
        samples = np.frombuffer(
            self._data, dtype, count=h * w, offset=data_off
        )
        return samples.reshape(h, w).copy()

    def tile_origin(self, scene: int, tile: int) -> tuple[int, int]:
        """(y0, x0) mosaic pixel origin of a tile (0-based per-scene
        rank), for grid derivation; (0, 0) when the directory carried no
        origins."""
        if not (0 <= scene < self.n_scenes and 0 <= tile < self.n_tiles):
            # same contract as read_plane: a negative index must not
            # silently wrap through the sorted id lists
            raise MetadataError(
                f"{self.filename}: tile origin ({scene}, {tile}) out of "
                f"range ({self.n_scenes} scenes, {self.n_tiles} tiles)"
            )
        return self._tile_origins.get(
            (self._scene_ids[scene], tile), (0, 0)
        )

    def read_plane_linear(self, page: int) -> np.ndarray:
        """Decode by linear page index, the encoding the czi metaconfig
        handler writes: ``(((s * M + m) * C + c) * Z + z) * T + t``
        (sites = scenes × mosaic tiles; M = 1 reduces to the pre-mosaic
        convention)."""
        per_site = self.n_channels * self.n_zplanes * self.n_tpoints
        sm, rem = divmod(page, per_site)
        s, m = divmod(sm, self.n_tiles)
        c, rem = divmod(rem, self.n_zplanes * self.n_tpoints)
        z, t = divmod(rem, self.n_tpoints)
        return self.read_plane(s, c, z, t, tile=m)


class LIFReader(Reader):
    """First-party reader for Leica Image Files (``.lif``).

    Covers uint16/uint8 grayscale image series — the high-content layout
    where each series is one field/site with C/Z/T planes.

    Container structure parsed here:

    - the file is a sequence of blocks, each ``<u32 0x70> <u32 len>``
      followed by a test byte ``0x2A``;
    - the FIRST block holds the XML header: ``<u8 0x2A> <u32 n_chars>``
      + UTF-16LE document (``LMSDataContainerHeader``, whose ``Version``
      selects 4- vs 8-byte memory sizes);
    - every following block is a memory block: ``<u8 0x2A> <u32|u64
      mem_size> <u8 0x2A> <u32 id_chars>`` + UTF-16LE block id + the raw
      pixel bytes;
    - the XML's ``Element/Data/Image/ImageDescription`` carries
      ``ChannelDescription`` (``Resolution`` bits, ``BytesInc``) and
      ``DimensionDescription`` (``DimID`` 1=X 2=Y 3=Z 4=T,
      ``NumberOfElements``, ``BytesInc``) entries, and the sibling
      ``Memory`` element names the block holding the series' pixels.

    Plane addressing is pure ``BytesInc`` arithmetic, so interleaved and
    planar channel layouts both decode.  Non-8/16-bit resolutions raise
    :class:`~tmlibrary_tpu_torch.errors.MetadataError`.
    """

    MAGIC = 0x70

    def __enter__(self):
        self._file = open(self.filename, "rb")
        try:
            self._data = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as exc:
            self._file.close()
            raise MetadataError(f"not a LIF container: {self.filename}") from exc
        try:
            if len(self._data) < 13 or struct.unpack_from("<I", self._data, 0)[0] != self.MAGIC:
                raise MetadataError(f"not a LIF container: {self.filename}")
            xml, pos = self._read_header()
            root = ElementTree.fromstring(xml)
            version = int(root.get("Version") or 1)
            self._blocks = self._scan_memory_blocks(pos, version)
            self.series = self._parse_xml(root)
        except MetadataError:
            self.__exit__()
            raise
        except (struct.error, OverflowError, IndexError, KeyError,
                ValueError, UnicodeDecodeError, SyntaxError) as exc:
            # SyntaxError: a truncated UTF-16 header decodes to malformed
            # XML and ElementTree.ParseError subclasses SyntaxError
            self.__exit__()
            raise MetadataError(
                f"corrupt LIF container {self.filename}: "
                f"{type(exc).__name__}: {exc}"
            ) from exc
        if not self.series:
            self.__exit__()
            raise MetadataError(
                f"{self.filename}: no decodable image series "
                "(only 8/16-bit grayscale series are supported)"
            )
        self.n_series = len(self.series)
        self.height = self.series[0]["height"]
        self.width = self.series[0]["width"]
        return self

    def __exit__(self, *exc):
        if getattr(self, "_data", None) is not None:
            try:
                self._data.close()
            except (ValueError, AttributeError):
                pass
            self._data = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None
        return False

    # ------------------------------------------------------------ container
    def _read_header(self) -> tuple[str, int]:
        _magic, _blen = struct.unpack_from("<II", self._data, 0)
        if self._data[8] != 0x2A:
            raise MetadataError(f"{self.filename}: bad header test byte")
        (n_chars,) = struct.unpack_from("<I", self._data, 9)
        xml = bytes(self._data[13:13 + 2 * n_chars]).decode("utf-16-le")
        return xml, 13 + 2 * n_chars

    def _scan_memory_blocks(
        self, pos: int, version: int
    ) -> dict[str, tuple[int, int]]:
        """block id -> (data offset, size).  ``version`` comes from the
        parsed header root (it selects 4- vs 8-byte memory sizes; a
        substring sniff would misread files whose Version attribute sits
        past the first decode window)."""
        blocks: dict[str, tuple[int, int]] = {}
        n = len(self._data)
        while pos + 8 <= n:
            magic, _blen = struct.unpack_from("<II", self._data, pos)
            if magic != self.MAGIC:
                raise MetadataError(
                    f"{self.filename}: bad block magic at offset {pos}"
                )
            p = pos + 8
            if self._data[p] != 0x2A:
                raise MetadataError(f"{self.filename}: bad block test byte")
            if version >= 2:
                (mem_size,) = struct.unpack_from("<Q", self._data, p + 1)
                p += 9
            else:
                (mem_size,) = struct.unpack_from("<I", self._data, p + 1)
                p += 5
            if self._data[p] != 0x2A:
                raise MetadataError(f"{self.filename}: bad id test byte")
            (id_chars,) = struct.unpack_from("<I", self._data, p + 1)
            p += 5
            block_id = bytes(self._data[p:p + 2 * id_chars]).decode("utf-16-le")
            p += 2 * id_chars
            if p + mem_size > n:
                raise MetadataError(
                    f"{self.filename}: memory block '{block_id}' runs past "
                    f"EOF (truncated file?)"
                )
            if mem_size:
                blocks[block_id] = (p, mem_size)
            pos = p + mem_size
        return blocks

    def _parse_xml(self, root) -> list[dict]:
        series: list[dict] = []
        for el in root.iter("Element"):
            image = el.find("./Data/Image")
            memory = el.find("./Memory")
            if image is None or memory is None:
                continue
            desc = image.find("ImageDescription")
            if desc is None:
                continue
            channels = [
                {
                    "bits": int(c.get("Resolution", "16")),
                    "bytes_inc": int(c.get("BytesInc", "0")),
                    # LUTName is how Leica labels acquisition channels
                    # (Bio-Formats surfaces the same attribute)
                    "name": c.get("LUTName") or "",
                }
                for c in desc.iter("ChannelDescription")
            ]
            dims = {1: None, 2: None, 3: None, 4: None}
            for d in desc.iter("DimensionDescription"):
                dim_id = int(d.get("DimID", "0"))
                if dim_id in dims:
                    dims[dim_id] = {
                        "n": int(d.get("NumberOfElements", "1")),
                        "bytes_inc": int(d.get("BytesInc", "0")),
                    }
            if not channels or dims[1] is None or dims[2] is None:
                continue
            if any(c["bits"] not in (8, 16) for c in channels):
                continue  # counted as undecodable; __enter__ errors if none
            if dims[1]["bytes_inc"] <= 0 or dims[2]["bytes_inc"] <= 0:
                # a zero X/Y stride would reach as_strided and replicate
                # one pixel silently instead of erroring
                continue
            block_id = memory.get("MemoryBlockID", "")
            if block_id not in self._blocks:
                continue
            series.append({
                "name": el.get("Name", f"Series{len(series)}"),
                "channels": channels,
                "width": dims[1]["n"],
                "x_inc": dims[1]["bytes_inc"],
                "height": dims[2]["n"],
                "y_inc": dims[2]["bytes_inc"],
                "n_zplanes": dims[3]["n"] if dims[3] else 1,
                "z_inc": dims[3]["bytes_inc"] if dims[3] else 0,
                "n_tpoints": dims[4]["n"] if dims[4] else 1,
                "t_inc": dims[4]["bytes_inc"] if dims[4] else 0,
                "block": block_id,
            })
        return series

    # ------------------------------------------------------------- pixels
    def read_plane(
        self, series: int = 0, channel: int = 0, zplane: int = 0, tpoint: int = 0
    ) -> np.ndarray:
        if not 0 <= series < len(self.series):
            raise MetadataError(
                f"{self.filename}: no series {series} (have {len(self.series)})"
            )
        s = self.series[series]
        if not 0 <= channel < len(s["channels"]):
            raise MetadataError(
                f"{self.filename}: series {series} has "
                f"{len(s['channels'])} channels, asked for {channel}"
            )
        if not 0 <= zplane < s["n_zplanes"] or not 0 <= tpoint < s["n_tpoints"]:
            raise MetadataError(
                f"{self.filename}: plane z={zplane} t={tpoint} out of range "
                f"Z={s['n_zplanes']} T={s['n_tpoints']}"
            )
        ch = s["channels"][channel]
        itemsize = ch["bits"] // 8
        base, size = self._blocks[s["block"]]
        start = ch["bytes_inc"] + zplane * s["z_inc"] + tpoint * s["t_inc"]
        h, w = s["height"], s["width"]
        last = start + (h - 1) * s["y_inc"] + (w - 1) * s["x_inc"] + itemsize
        if last > size:
            raise MetadataError(
                f"{self.filename}: series {series} plane runs past its "
                f"memory block ({last} > {size} bytes)"
            )
        dtype = np.uint8 if itemsize == 1 else np.dtype("<u2")
        # copy the plane's byte span out of the mmap FIRST: a frombuffer
        # view would pin the mapping open past __exit__ (BufferError)
        span = bytes(self._data[base + start:base + last])
        plane = np.lib.stride_tricks.as_strided(
            np.frombuffer(span, np.uint8),
            shape=(h, w, itemsize),
            strides=(s["y_inc"], s["x_inc"], 1),
        )
        out = np.ascontiguousarray(plane).view(dtype)[:, :, 0]
        return out.astype(np.uint16) if itemsize == 1 else out

    def read_plane_linear(self, series: int, page: int) -> np.ndarray:
        """Decode by per-series linear page index, the encoding the lif
        metaconfig handler writes: ``(c * Z + z) * T + t``."""
        s = self.series[series]
        c, rem = divmod(page, s["n_zplanes"] * s["n_tpoints"])
        z, t = divmod(rem, s["n_tpoints"])
        return self.read_plane(series, c, z, t)

    def channel_names(self) -> "list[str] | None":
        """Per-channel ``LUTName`` labels when every series agrees — or
        None (names are a courtesy; the ``C00``… fallback applies)."""
        if not self.series:
            return None
        first = [c.get("name", "") for c in self.series[0]["channels"]]
        for s in self.series[1:]:
            if [c.get("name", "") for c in s["channels"]] != first:
                return None
        return first if any(first) else None

    def uniform_dims(self) -> tuple[int, int, int]:
        """(C, Z, T), required identical across series — as is the plane
        shape (the HCS layout the lif handler maps: series = sites of one
        well; a mixed-size file, e.g. an overview scan plus field series,
        must not silently set the experiment's site shape)."""
        dims = {
            (len(s["channels"]), s["n_zplanes"], s["n_tpoints"])
            for s in self.series
        }
        if len(dims) != 1:
            raise MetadataError(
                f"{self.filename}: series disagree on (C, Z, T) {sorted(dims)} "
                "— not a uniform HCS acquisition"
            )
        shapes = {(s["height"], s["width"]) for s in self.series}
        if len(shapes) != 1:
            raise MetadataError(
                f"{self.filename}: series disagree on plane shape "
                f"{sorted(shapes)} — not a uniform HCS acquisition"
            )
        return next(iter(dims))

    def read_plane_global(self, page: int) -> np.ndarray:
        """Decode by whole-file linear page index
        ``series * C*Z*T + (c*Z + z)*T + t`` (uniform series required)."""
        c, z, t = self.uniform_dims()
        series, rem = divmod(page, c * z * t)
        return self.read_plane_linear(series, rem)


class DVReader(Reader):
    """First-party reader for DeltaVision ``.dv`` / ``.r3d`` stacks
    (the MRC-variant format of GE/Applied Precision widefield scopes).

    A 1024-byte fixed header (image dims, pixel mode, extended-header
    size) followed by the extended header and row-major section planes.
    Byte order is detected from the DVID magic (``0xC0A0`` little- or
    big-endian at byte 96); sections interleave Z/wavelength/time in one
    of three documented orders (byte 182): 0 = ZTW, 1 = WZT, 2 = ZWT.

    Linear page convention (shared with the ``dv`` metaconfig handler):
    ``page = (c * Z + z) * T + t``.
    """

    #: pixel mode -> numpy dtype character (endianness applied at parse)
    _MODES = {0: "u1", 1: "i2", 2: "f4", 6: "u2"}

    def __enter__(self):
        try:
            # header only — never the whole file: imextract's thread pool
            # opens one reader per plane, and multi-GB stacks would be
            # read N times over (see the ND2Reader mmap note)
            with open(self.filename, "rb") as f:
                header = f.read(1024)
        except OSError as exc:
            raise MetadataError(f"unreadable DV file: {self.filename}") from exc
        if len(header) < 1024:
            raise MetadataError(f"not a DV stack (short header): {self.filename}")
        (dvid_le,) = struct.unpack_from("<h", header, 96)
        (dvid_be,) = struct.unpack_from(">h", header, 96)
        if dvid_le == -16224:
            self._bo = "<"
        elif dvid_be == -16224:
            self._bo = ">"
        else:
            raise MetadataError(
                f"not a DV stack (no DVID magic at byte 96): {self.filename}"
            )
        bo = self._bo
        nx, ny, nsec, mode = struct.unpack_from(f"{bo}4i", header, 0)
        (ext_size,) = struct.unpack_from(f"{bo}i", header, 92)
        (n_times,) = struct.unpack_from(f"{bo}h", header, 180)
        (sequence,) = struct.unpack_from(f"{bo}h", header, 182)
        (n_waves,) = struct.unpack_from(f"{bo}h", header, 196)
        if mode not in self._MODES:
            raise MetadataError(
                f"unsupported DV pixel mode {mode} in {self.filename} "
                f"(supported: {sorted(self._MODES)})"
            )
        if sequence not in (0, 1, 2):
            raise MetadataError(
                f"unknown DV image sequence {sequence} in {self.filename}"
            )
        n_waves = max(1, n_waves)
        n_times = max(1, n_times)
        if nx <= 0 or ny <= 0 or nsec <= 0 or ext_size < 0:
            raise MetadataError(f"corrupt DV header in {self.filename}")
        if nsec % (n_waves * n_times) != 0:
            raise MetadataError(
                f"DV section count {nsec} does not factor into "
                f"{n_waves} waves x {n_times} times in {self.filename}"
            )
        self.width, self.height = nx, ny
        self.n_channels = n_waves
        self.n_tpoints = n_times
        self.n_zplanes = nsec // (n_waves * n_times)
        self._sequence = sequence
        self._dtype = np.dtype(bo + self._MODES[mode])
        self._data_start = 1024 + ext_size
        self._plane_bytes = nx * ny * self._dtype.itemsize
        expected = self._data_start + nsec * self._plane_bytes
        actual = self.filename.stat().st_size
        if actual < expected:
            raise MetadataError(
                f"truncated DV stack {self.filename}: "
                f"{actual} bytes < {expected} expected"
            )
        return self

    def _section(self, z: int, c: int, t: int) -> int:
        zn, wn = self.n_zplanes, self.n_channels
        if self._sequence == 0:  # ZTW: Z fastest, then time, then wave
            return (c * self.n_tpoints + t) * zn + z
        if self._sequence == 1:  # WZT: wave fastest, then Z, then time
            return (t * zn + z) * wn + c
        return (t * wn + c) * zn + z  # ZWT: Z fastest, then wave, then time

    def read_plane(self, z: int, c: int, t: int) -> np.ndarray:
        sec = self._section(z, c, t)
        off = self._data_start + sec * self._plane_bytes
        with open(self.filename, "rb") as f:
            f.seek(off)
            raw = f.read(self._plane_bytes)
        plane = np.frombuffer(raw, self._dtype).reshape(self.height, self.width)
        # store planes are uint16.  Signed int16 (mode 1, the most common
        # DV mode) can carry negative intensities after deconvolution —
        # clip at 0 rather than letting the cast wrap them to ~65535
        if plane.dtype.kind == "i":
            return np.clip(plane, 0, None).astype(np.uint16)
        if plane.dtype.kind == "u":
            return plane.astype(np.uint16)
        return plane.astype(np.float32)

    def read_plane_linear(self, page: int) -> np.ndarray:
        ct, rem_t = divmod(page, self.n_tpoints)
        c, z = divmod(ct, self.n_zplanes)
        return self.read_plane(z, c, rem_t)


class STKReader(Reader):
    """First-party reader for MetaMorph ``.stk`` stacks.

    An STK file is a classic TIFF whose FIRST IFD describes plane
    0 while the remaining planes of the Z-series follow contiguously in
    the pixel data — the plane count lives in the UIC2 private tag's
    ``count`` field (tag 33629), NOT in the IFD chain, so a plain paged
    TIFF reader sees one page and silently drops the rest of the stack
    (which would misread the metamorph handler's ``page`` indices).
    Some writers emit per-plane IFDs instead; both layouts are handled.

    Linear page convention (shared with the metamorph handler and the
    ``stk`` container handler): ``page = z``.
    """

    _UIC2 = 33629

    def __enter__(self):
        # mmap, not read_bytes(): imextract's thread pool opens one reader
        # per plane, and multi-GB stacks would be read N times over
        self._file = open(self.filename, "rb")
        try:
            self._data = mmap.mmap(self._file.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        except ValueError as exc:
            self._file.close()
            raise MetadataError(f"empty STK file: {self.filename}") from exc
        try:
            bo, ifds = _tiff_parse(self._data)
            self._parse_stk(bo, ifds)
        except (MetadataError, NotSupportedError):
            self.__exit__()
            raise
        except (KeyError, IndexError, struct.error) as exc:
            self.__exit__()
            raise MetadataError(
                f"corrupt STK structure in {self.filename}: {exc}"
            ) from exc
        return self

    def _parse_stk(self, bo: str, ifds: list) -> None:
        self._bo = bo
        buf = self._data
        first = ifds[0]
        self.width = _tiff_int(bo, buf, first, 256, 0)
        self.height = _tiff_int(bo, buf, first, 257, 0)
        bits = _tiff_int(bo, buf, first, 258, 8)
        self._compression = _tiff_int(bo, buf, first, 259, 1)
        self._predictor = _tiff_int(bo, buf, first, 317, 1)
        samples = _tiff_int(bo, buf, first, 277, 1)
        if self.width <= 0 or self.height <= 0:
            raise MetadataError(f"corrupt STK dimensions in {self.filename}")
        if bits not in (8, 16) or samples != 1:
            raise NotSupportedError(
                f"STK reader handles 8/16-bit grayscale, got {bits}-bit "
                f"x{samples} in {self.filename}"
            )
        self._dtype = np.dtype(bo + ("u1" if bits == 8 else "u2"))
        uic2 = first.get(self._UIC2)
        n_uic = uic2[1] if uic2 else 0
        if len(ifds) == 1 and n_uic >= 1:
            # canonical STK: one IFD, planes appended after plane 0's data
            if self._compression != 1:
                raise NotSupportedError(
                    f"compressed single-IFD STK is not supported "
                    f"({self.filename}): plane offsets are only defined "
                    "for contiguous uncompressed planes"
                )
            self.n_zplanes = n_uic
            self._layout = "contiguous"
            offs, counts = _tiff_strips(bo, buf, first, self.filename)
            self._strip_offsets = offs
            self._strip_counts = counts
            self._plane_bytes = self.width * self.height * self._dtype.itemsize
            if sum(counts) < self._plane_bytes:
                raise MetadataError(f"truncated STK plane 0 in {self.filename}")
            end = offs[-1] + counts[-1] + (self.n_zplanes - 1) * self._plane_bytes
            size = len(buf)
            if end > size:
                raise MetadataError(
                    f"truncated STK stack {self.filename}: {size} bytes "
                    f"< {end} expected for {self.n_zplanes} planes"
                )
        else:
            # per-plane IFDs (paged variant some writers emit)
            self.n_zplanes = len(ifds)
            self._layout = "paged"
            self._ifds = ifds
        self.n_channels = 1
        self.n_tpoints = 1

    def __exit__(self, *exc):
        if getattr(self, "_data", None) is not None:
            self._data.close()
            self._data = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None
        return False

    def _read_ifd_plane(self, ifd: dict) -> np.ndarray:
        return _decode_ifd_plane(self._bo, self._data, ifd, self.width,
                                 self.height, self._dtype, self.filename)

    def read_plane(self, z: int) -> np.ndarray:
        if not 0 <= z < self.n_zplanes:
            raise MetadataError(
                f"plane {z} out of range for {self.filename}: "
                f"Z={self.n_zplanes}"
            )
        if self._layout == "paged":
            return self._read_ifd_plane(self._ifds[z])
        shift = z * self._plane_bytes
        raw = bytearray()
        need = self._plane_bytes
        for off, cnt in zip(self._strip_offsets, self._strip_counts):
            take = min(cnt, need - len(raw))
            base = off + shift
            raw += self._data[base:base + take]
            if len(raw) >= need:
                break
        return _grey_plane(bytes(raw), self._predictor, self.height, self.width,
                           self._dtype)

    def read_plane_linear(self, page: int) -> np.ndarray:
        return self.read_plane(page)


class LSMReader(Reader):
    """First-party reader for Zeiss LSM 510/710 confocal stacks.

    An ``.lsm`` file is a
    classic TIFF in which every full-resolution plane IFD is followed by
    a thumbnail IFD (``NewSubfileType`` = 1, skipped here), channels are
    stored planar (``PlanarConfiguration`` = 2) as one strip per channel
    inside each plane IFD, and the acquisition dimensions live in the
    private CZ_LSMINFO tag (34412: DimensionZ / Channels / Time at byte
    offsets 16/20/24 of the struct).  Full-resolution IFDs are ordered Z
    fastest, then T — cross-checked against ``Z * T`` at open.

    Linear page convention (shared with the ``lsm`` metaconfig handler,
    same as DV/IMS): ``page = (c * Z + z) * T + t``.
    """

    _CZ_LSMINFO = 34412
    #: CZ_LSMINFO magic numbers (LSM 5 / LSM 7 series)
    _MAGIC = (0x00300494, 0x00400494)

    def __enter__(self):
        self._file = open(self.filename, "rb")
        try:
            self._data = mmap.mmap(self._file.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        except ValueError as exc:
            self._file.close()
            raise MetadataError(f"empty LSM file: {self.filename}") from exc
        try:
            bo, ifds = _tiff_parse(self._data)
            self._parse_lsm(bo, ifds)
        except (MetadataError, NotSupportedError):
            self.__exit__()
            raise
        except (KeyError, IndexError, struct.error) as exc:
            self.__exit__()
            raise MetadataError(
                f"corrupt LSM structure in {self.filename}: {exc}"
            ) from exc
        return self

    def _parse_lsm(self, bo: str, ifds: list) -> None:
        buf = self._data
        self._bo = bo
        full = [
            ifd for ifd in ifds if _tiff_int(bo, buf, ifd, 254, 0) == 0
        ]
        if not full:
            raise MetadataError(f"no full-resolution IFDs in {self.filename}")
        info = ifds[0].get(self._CZ_LSMINFO)
        if info is None:
            raise MetadataError(
                f"not an LSM file (no CZ_LSMINFO tag): {self.filename}"
            )
        info_off = _tiff_value_offset(bo, buf, info)
        # the CZ_LSMINFO struct is always little-endian (as is every real
        # LSM file; the tag layout predates any big-endian writer)
        magic, _size, _x, _y, dim_z, dim_c, dim_t = struct.unpack_from(
            "<IiiiiiI", buf, info_off
        )
        if magic not in self._MAGIC:
            raise MetadataError(
                f"bad CZ_LSMINFO magic 0x{magic:08x} in {self.filename}"
            )
        first = full[0]
        self.width = _tiff_int(bo, buf, first, 256, 0)
        self.height = _tiff_int(bo, buf, first, 257, 0)
        bits = _tiff_int(bo, buf, first, 258, 8)
        samples = _tiff_int(bo, buf, first, 277, 1)
        planar = _tiff_int(bo, buf, first, 284, 1)
        if self.width <= 0 or self.height <= 0:
            raise MetadataError(f"corrupt LSM dimensions in {self.filename}")
        if bits not in (8, 16):
            raise NotSupportedError(
                f"LSM reader handles 8/16-bit data, got {bits}-bit "
                f"in {self.filename}"
            )
        if samples > 1 and planar != 2:
            raise NotSupportedError(
                f"interleaved (chunky) multi-channel LSM is not supported "
                f"in {self.filename}"
            )
        self.n_channels = max(dim_c, 1)
        if samples != self.n_channels:
            raise MetadataError(
                f"LSM channel mismatch in {self.filename}: CZ_LSMINFO says "
                f"{self.n_channels}, IFD SamplesPerPixel says {samples}"
            )
        self.n_zplanes = max(dim_z, 1)
        self.n_tpoints = max(dim_t, 1)
        if len(full) != self.n_zplanes * self.n_tpoints:
            raise MetadataError(
                f"LSM plane-count mismatch in {self.filename}: "
                f"{len(full)} full-resolution IFDs != Z {self.n_zplanes} "
                f"x T {self.n_tpoints}"
            )
        self._dtype = np.dtype(bo + ("u1" if bits == 8 else "u2"))
        self._full = full

    def __exit__(self, *exc):
        if getattr(self, "_data", None) is not None:
            self._data.close()
            self._data = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None
        return False

    def read_plane(self, z: int, c: int, t: int) -> np.ndarray:
        for name, val, n in (("zplane", z, self.n_zplanes),
                             ("channel", c, self.n_channels),
                             ("tpoint", t, self.n_tpoints)):
            if not 0 <= val < n:
                raise MetadataError(
                    f"{name} {val} out of range for {self.filename} "
                    f"(Z={self.n_zplanes} C={self.n_channels} "
                    f"T={self.n_tpoints})"
                )
        bo, buf = self._bo, self._data
        ifd = self._full[t * self.n_zplanes + z]
        offs, counts = _tiff_strips(bo, buf, ifd, self.filename)
        if len(offs) != self.n_channels:
            raise MetadataError(
                f"LSM strip layout in {self.filename}: {len(offs)} strips "
                f"for {self.n_channels} channels (expected one per channel)"
            )
        compression = _tiff_int(bo, buf, ifd, 259, 1)
        predictor = _tiff_int(bo, buf, ifd, 317, 1)
        expect = self.width * self.height * self._dtype.itemsize
        raw = _decode_strip(bytes(buf[offs[c]:offs[c] + counts[c]]),
                            compression, expect, self.filename)
        return _grey_plane(raw, predictor, self.height, self.width, self._dtype)

    def read_plane_linear(self, page: int) -> np.ndarray:
        ct, t = divmod(page, self.n_tpoints)
        c, z = divmod(ct, self.n_zplanes)
        return self.read_plane(z, c, t)


def _decode_oif_text(raw: bytes) -> str:
    """Olympus INI text is UTF-16-LE with BOM on real scopes; tolerate
    BOM-less UTF-16 and plain 8-bit too (fixtures, resaved files)."""
    if raw[:2] in (b"\xff\xfe", b"\xfe\xff"):
        # "replace", not strict: a corrupt odd-length tail must degrade
        # to unparseable text (-> MetadataError downstream), not leak
        # UnicodeDecodeError past the skip-unreadable guard (fuzz-caught)
        return raw.decode("utf-16", "replace")
    if b"\x00" in raw[:64]:
        return raw.decode("utf-16-le", "replace")
    return raw.decode("utf-8", "replace")


def _parse_oif_dims(text: str) -> dict[str, int]:
    """Axis sizes from an OIF main file: ``[Axis N Parameters Common]``
    sections carry ``AxisCode`` (X/Y/Z/T/C/…) and ``MaxSize``.  Returns
    ``{axis_code: size}`` for POSITIVE sizes only — FV1000 files declare
    every axis slot and unused ones carry ``MaxSize=0``, which must not
    shadow the decode-from-first-plane fallback (X/Y) or the observed
    plane grid (C/Z/T)."""
    dims: dict[str, int] = {}
    code = size = None
    section_ok = False

    def flush():
        if section_ok and code and size and size > 0:
            dims[code] = size

    for line in text.splitlines():
        line = line.strip()
        if line.startswith("["):
            flush()
            code = size = None
            section_ok = bool(
                re.match(r"\[Axis \d+ Parameters Common\]", line)
            )
            continue
        if not section_ok or "=" not in line:
            continue
        key, _, val = line.partition("=")
        val = val.strip().strip('"')
        if key.strip() == "AxisCode":
            code = val.upper() or None
        elif key.strip() == "MaxSize":
            try:
                size = int(val)
            except ValueError:
                size = None
    flush()
    return dims


def _parse_oif_plane_name(name: str) -> "tuple[int, int, int] | None":
    """(c, z, t) 0-based from an Olympus plane filename
    (``s_C001Z002T003.tif`` with any subset of the axis tokens, 1-based),
    or None for non-plane files."""
    base = name.rsplit("/", 1)[-1]
    if not base.lower().endswith((".tif", ".tiff")):
        return None
    c = re.search(r"[Cc](\d{2,})", base)
    z = re.search(r"[Zz](\d{2,})", base)
    t = re.search(r"[Tt](\d{2,})", base)
    if not (c or z or t):
        return None
    take = lambda m: max(0, int(m.group(1)) - 1) if m else 0
    return take(c), take(z), take(t)


def _tiff_single_plane(buf, filename) -> np.ndarray:
    """Decode IFD 0 of a single-plane grayscale TIFF held in ``buf``
    (bytes/mmap) — the payload format of Olympus plane files, shared by
    the on-disk ``.oif.files`` TIFFs and the in-memory OIB streams."""
    bo, ifds = _tiff_parse(buf)
    return _gray_ifd_plane(bo, buf, ifds[0], filename,
                           "Olympus plane TIFFs")


def _parse_oif_channel_names(text: str) -> "list[str] | None":
    """Dye names from ``[Channel N Parameters]`` sections (``DyeName``,
    ``CH Name`` fallback), ordered by channel number — or None."""
    by_num: dict[int, str] = {}
    num = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("["):
            m = re.match(r"\[Channel (\d+) Parameters\]", line)
            num = int(m.group(1)) if m else None
            continue
        if num is None or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip().strip('"')
        if key == "DyeName" and val:
            by_num[num] = val
        elif key == "CH Name" and val:
            by_num.setdefault(num, val)
    if not by_num:
        return None
    return [by_num[n] for n in sorted(by_num)]


class _OlympusBase(Reader):
    """Shared OIF/OIB logic: dims from the main-file INI, plane lookup
    from C/Z/T filename tokens, the linear page convention
    ``page = (c * Z + z) * T + t`` (same as DV/IMS/LSM)."""

    def _finish_open(self, text: str, plane_names) -> None:
        dims = _parse_oif_dims(text)
        self._planes: dict[tuple, object] = {}
        for name in plane_names:
            czt = _parse_oif_plane_name(str(name))
            if czt is not None:
                # first wins: OIBs occasionally carry duplicate preview
                # copies of plane 0 under another storage
                self._planes.setdefault(czt, name)
        if not self._planes:
            raise MetadataError(
                f"no C/Z/T plane files found in {self.filename}"
            )
        # the planes actually present are authoritative — the INI of an
        # aborted acquisition still declares the PLANNED sizes, and
        # enumerating those would make every missing (c,z,t) a
        # MetadataError at extract time.  An aborted scan's trailing
        # partial timepoint is trimmed the same way; any hole elsewhere
        # in the grid means real corruption and fails the open (the
        # handler's skip-unreadable loop logs and moves on).
        self.n_channels = max(k[0] for k in self._planes) + 1
        self.n_zplanes = max(k[1] for k in self._planes) + 1
        n_t = max(k[2] for k in self._planes) + 1
        full_cz = self.n_channels * self.n_zplanes
        while n_t > 1 and sum(
            1 for k in self._planes if k[2] == n_t - 1
        ) < full_cz:
            n_t -= 1
        self.n_tpoints = n_t
        missing = [
            (c, z, t)
            for c in range(self.n_channels)
            for z in range(self.n_zplanes)
            for t in range(self.n_tpoints)
            if (c, z, t) not in self._planes
        ]
        if missing:
            raise MetadataError(
                f"incomplete Olympus plane grid in {self.filename}: "
                f"missing {missing[:4]}{'…' if len(missing) > 4 else ''}"
            )
        # plane shape: X/Y axis sizes when the INI carries them, else
        # decoded from the first plane (container_dimensions probes this)
        if dims.get("X", 0) > 0 and dims.get("Y", 0) > 0:
            self.width, self.height = dims["X"], dims["Y"]
        else:
            first = _tiff_single_plane(
                *self._plane_buf(self._planes[min(self._planes)])
            )
            self.height, self.width = first.shape
        # dye names, count-guarded against the observed channel grid
        names = _parse_oif_channel_names(text)
        self.channel_names = (
            names if names and len(names) == self.n_channels else None
        )

    def _plane_buf(self, key):  # pragma: no cover - abstract
        raise NotImplementedError

    def read_plane(self, c: int, z: int, t: int) -> np.ndarray:
        name = self._planes.get((c, z, t))
        if name is None:
            raise MetadataError(
                f"missing plane C{c} Z{z} T{t} in {self.filename}"
            )
        buf, label = self._plane_buf(name)
        return _tiff_single_plane(buf, label)

    def read_plane_linear(self, page: int) -> np.ndarray:
        cz, t = divmod(page, self.n_tpoints)
        c, z = divmod(cz, self.n_zplanes)
        return self.read_plane(c, z, t)


class OIFReader(_OlympusBase):
    """First-party reader for Olympus ``.oif`` acquisitions (FluoView
    FV1000 and kin): a UTF-16 INI main file next to a
    ``<name>.oif.files/`` directory of single-plane TIFFs named by axis
    tokens (``s_C001Z002.tif``).

    Dims come from the ``[Axis N Parameters Common]`` sections
    (MaxSize per AxisCode), cross-checked against the plane files
    actually present.
    """

    def __enter__(self):
        try:
            text = _decode_oif_text(self.filename.read_bytes())
        except OSError as exc:
            raise MetadataError(
                f"unreadable OIF file: {self.filename}"
            ) from exc
        if "[Axis" not in text and "OibSaveInfo" not in text:
            raise MetadataError(
                f"not an Olympus OIF main file: {self.filename}"
            )
        files_dir = self.filename.with_name(self.filename.name + ".files")
        if not files_dir.is_dir():
            raise MetadataError(
                f"OIF companion directory missing: {files_dir}"
            )
        self._dir = files_dir  # before _finish_open: the shape probe reads a plane
        self._finish_open(
            text, [p.name for p in sorted(files_dir.iterdir())]
        )
        return self

    def _plane_buf(self, name):
        path = self._dir / name
        try:
            return path.read_bytes(), path
        except OSError as exc:
            raise MetadataError(f"unreadable OIF plane: {path}") from exc


class OIBReader(_OlympusBase):
    """First-party reader for Olympus ``.oib`` acquisitions — the same
    FluoView data as :class:`OIFReader` packed into one OLE2 compound
    file (parsed by :class:`tmlibrary_tpu_torch.cfb.CompoundFile`, no JVM).

    The root ``OibInfo.txt``
    stream maps storage streams back to their original OIF-tree names
    (``Stream00001=s_C001Z001.tif``); when it is absent the raw stream
    names are used directly.  The embedded ``.oif`` main file supplies
    the axis dims, cross-checked against the planes present.
    """

    def __enter__(self):
        # mmap + lazy CompoundFile streams: an open reader holds the
        # directory tables, not the pixel payloads (the imextract reader
        # cache keeps up to 64 containers open — see _OPEN_READERS)
        self._file = open(self.filename, "rb")
        try:
            self._data = mmap.mmap(self._file.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        except ValueError as exc:
            self._file.close()
            self._file = None
            raise MetadataError(f"empty OIB file: {self.filename}") from exc
        try:
            cf = CompoundFile(self._data, self.filename)
            # OibInfo.txt (any storage depth) maps CFB stream names back
            # to OIF-tree names.  Keys may be flat (``[OibSaveInfo]``
            # ``Stream00000=…``) or grouped in per-storage sections
            # (``[Storage00001]``): when the section names a real
            # storage, the rename is keyed by the full path so equal
            # stream basenames in different storages cannot collide.
            renames: dict[str, str] = {}
            storages = {
                p.rsplit("/", 1)[0] for p in cf.stream_paths if "/" in p
            }
            for path in cf.stream_paths:
                if path.rsplit("/", 1)[-1].lower() != "oibinfo.txt":
                    continue
                section = ""
                for line in _decode_oif_text(
                    cf.read_stream(path)
                ).splitlines():
                    line = line.strip()
                    if line.startswith("[") and line.endswith("]"):
                        section = line[1:-1]
                        continue
                    key, _, val = line.partition("=")
                    key, val = key.strip(), val.strip().strip('"')
                    if not (
                        _parse_oif_plane_name(val)
                        or val.lower().endswith(".oif")
                    ):
                        continue
                    full = f"{section}/{key}" if section in storages else key
                    renames.setdefault(full, val)
            # resolution: full-path rename, then basename rename, then
            # the bare basename; first wins in sorted storage order so a
            # later storage's preview duplicate cannot shadow the
            # acquisition plane
            named: dict[str, str] = {}
            for p in sorted(cf.stream_paths):
                base = p.rsplit("/", 1)[-1]
                named.setdefault(renames.get(p, renames.get(base, base)), p)
            main = next(
                (n for n in sorted(named) if n.lower().endswith(".oif")),
                None,
            )
            text = (
                _decode_oif_text(cf.read_stream(named[main])) if main else ""
            )
            self._cf = cf
            self._named = named
            self._finish_open(text, list(named))
        except MetadataError:
            self.__exit__()
            raise
        return self

    def __exit__(self, *exc):
        self._cf = None
        if getattr(self, "_data", None) is not None:
            try:
                self._data.close()
            except BufferError:
                # a failed parse's traceback pins memoryview exports of
                # the mmap; the mapping is freed when the last view dies
                pass
            self._data = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None
        return False

    def _plane_buf(self, name):
        return self._cf.read_stream(self._named[name]), f"{self.filename}:{name}"


class FlexReader(Reader):
    """First-party reader for PerkinElmer Opera/Operetta ``.flex``
    containers — the reference's own instrument class (high-content
    screening), read upstream through Bio-Formats' FlexReader.

    A ``.flex`` file holds one well: a paged TIFF whose IFD pages cycle
    channel-fastest through the well's fields, with the acquisition
    described by the FLEX XML document in private tag 65200.  The
    channel set is the ordered unique ``Name`` attributes of the XML's
    ``Array`` elements (one per page, repeating per field); when the XML
    is absent or does not factor the page count, the file degrades to
    one channel with pages as fields.

    Linear page convention (shared with the ``flex`` metaconfig
    handler): ``page = field * n_channels + c`` — the raw IFD index.
    """

    _FLEX_XML = 65200

    def __enter__(self):
        self._file = open(self.filename, "rb")
        try:
            self._data = mmap.mmap(self._file.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        except ValueError as exc:
            self._file.close()
            self._file = None
            raise MetadataError(f"empty FLEX file: {self.filename}") from exc
        try:
            bo, ifds = _tiff_parse(self._data)
            self._parse_flex(bo, ifds)
        except (MetadataError, NotSupportedError):
            self.__exit__()
            raise
        except (KeyError, IndexError, struct.error) as exc:
            self.__exit__()
            raise MetadataError(
                f"corrupt FLEX structure in {self.filename}: {exc}"
            ) from exc
        return self

    def _parse_flex(self, bo: str, ifds: list) -> None:
        self._bo, self._ifds = bo, ifds
        buf = self._data
        first = ifds[0]
        self.width = _tiff_int(bo, buf, first, 256, 0)
        self.height = _tiff_int(bo, buf, first, 257, 0)
        bits = _tiff_int(bo, buf, first, 258, 8)
        samples = _tiff_int(bo, buf, first, 277, 1)
        if self.width <= 0 or self.height <= 0:
            raise MetadataError(f"corrupt FLEX dimensions in {self.filename}")
        if bits not in (8, 16) or samples != 1:
            raise NotSupportedError(
                f"FLEX reader handles 8/16-bit grayscale, got {bits}-bit "
                f"x{samples} in {self.filename}"
            )
        self._dtype = np.dtype(bo + ("u1" if bits == 8 else "u2"))
        for i, ifd in enumerate(ifds[1:], start=1):
            # Bio-Formats' FlexReader models per-plane sizes; this one
            # assumes page-0 geometry for every page, so a mismatched
            # page must fail loudly here rather than decode later pages
            # with misaligned rows (silently scrambled pixels)
            page = (_tiff_int(bo, buf, ifd, 256, 0),
                    _tiff_int(bo, buf, ifd, 257, 0),
                    _tiff_int(bo, buf, ifd, 258, 8),
                    _tiff_int(bo, buf, ifd, 277, 1))
            if page != (self.width, self.height, bits, samples):
                raise NotSupportedError(
                    f"FLEX page {i} geometry {page} differs from page 0 "
                    f"{(self.width, self.height, bits, samples)} in "
                    f"{self.filename}; per-page sizes are not supported"
                )
        names = self._channel_names_from_xml(bo, buf, first)
        n_pages = len(ifds)
        if names and n_pages % len(names) == 0:
            self.n_channels = len(names)
            self.channel_names = names
        else:
            self.n_channels = 1
            self.channel_names = None
        self.n_fields = n_pages // self.n_channels

    def _channel_names_from_xml(self, bo, buf, ifd) -> "list[str] | None":
        """Ordered unique Array Names of the FLEX document, or None."""
        entry = ifd.get(self._FLEX_XML)
        if entry is None:
            return None
        typ, cnt, _ = entry
        if typ not in (1, 2, 7):  # BYTE/ASCII/UNDEFINED
            return None
        base = _tiff_value_offset(bo, buf, entry)
        if base + cnt > len(buf):
            return None
        raw = bytes(buf[base:base + cnt]).rstrip(b"\x00")
        try:
            # bytes, not a decoded str: an XML encoding declaration makes
            # fromstring(str) raise (same latent issue as the CZI helper)
            root = ElementTree.fromstring(raw)
        except (ElementTree.ParseError, ValueError):
            return None
        names: list[str] = []
        for el in root.iter():
            tag = el.tag.rsplit("}", 1)[-1]
            if tag == "Array" and el.get("Name"):
                name = el.get("Name")
                if name not in names:
                    names.append(name)
        return names or None

    def __exit__(self, *exc):
        if getattr(self, "_data", None) is not None:
            self._data.close()
            self._data = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None
        return False

    def read_plane(self, field: int, channel: int) -> np.ndarray:
        if not (0 <= field < self.n_fields
                and 0 <= channel < self.n_channels):
            raise MetadataError(
                f"plane field={field} channel={channel} out of range for "
                f"{self.filename}: fields={self.n_fields} "
                f"channels={self.n_channels}"
            )
        return self.read_plane_linear(field * self.n_channels + channel)

    def read_plane_linear(self, page: int) -> np.ndarray:
        if not 0 <= page < len(self._ifds):
            raise MetadataError(
                f"page {page} out of range for {self.filename}: "
                f"{len(self._ifds)} pages"
            )
        return _decode_ifd_plane(self._bo, self._data, self._ifds[page],
                                 self.width, self.height, self._dtype,
                                 self.filename)


class IMSReader(Reader):
    """Bitplane Imaris ``.ims`` files (HDF5), read through the port's HDF5
    code (:mod:`tmlibrary_tpu_torch.io.hdf5`).

    Resolution level 0 lives at ``/DataSet/ResolutionLevel 0/TimePoint
    <t>/Channel <c>/Data`` as a (Z, Y, X) dataset padded up to chunk
    multiples; the true size comes from ``/DataSetInfo/Image`` attributes
    ``X``/``Y``/``Z``, which Imaris stores as byte-character arrays
    (``[b'5', b'1', b'2']``).  Linear page convention (shared with the
    ``ims`` metaconfig handler): ``page = (c * Z + z) * T + t``.  Integer
    data is clipped to the store's uint16 range, anything else becomes
    float32.  Every ``libver`` and chunk index h5py writes is read.  A
    damaged file raises :class:`MetadataError`; one holding a structure
    the port's HDF5 code refuses raises :class:`NotSupportedError` naming
    it.  Counterpart: ``tmlibrary_tpu/readers.py:1793-1938``."""

    def __enter__(self):
        try:
            self._f = hdf5.File(self.filename)
        except MetadataError as exc:
            raise MetadataError(f"not an HDF5/Imaris file: {self.filename}: {exc}") from exc
        try:
            info = self._f.node("DataSetInfo/Image")
            self._f.node("DataSet/ResolutionLevel 0")
        except KeyError as exc:
            raise MetadataError(f"no Imaris DataSet layout in {self.filename}: {exc}") from exc
        try:
            self.width = int(self._decode_attr(info.attrs["X"]))
            self.height = int(self._decode_attr(info.attrs["Y"]))
            self.n_zplanes = int(self._decode_attr(info.attrs["Z"]))
        except (KeyError, ValueError, UnicodeDecodeError) as exc:
            raise MetadataError(
                f"bad Imaris image-size attributes in {self.filename}: {exc}") from exc
        if self.width < 1 or self.height < 1 or self.n_zplanes < 1:
            raise MetadataError(
                f"nonsensical Imaris image size in {self.filename}: "
                f"X={self.width} Y={self.height} Z={self.n_zplanes}")
        tps = sorted(k for k in self._f.members("DataSet/ResolutionLevel 0")
                     if k.startswith("TimePoint "))
        if not tps:
            raise MetadataError(f"no TimePoints in {self.filename}")
        chans = sorted(k for k in self._f.members(f"DataSet/ResolutionLevel 0/{tps[0]}")
                       if k.startswith("Channel "))
        if not chans:
            raise MetadataError(f"no Channels in {self.filename}")
        self.n_tpoints = len(tps)
        self.n_channels = len(chans)
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def _decode_attr(val) -> str:
        """The one decoder for Imaris attribute values: byte-character
        arrays (``[b'5', b'1', b'2']``), bytes, or plain scalars."""
        if isinstance(val, np.ndarray):
            return b"".join(val.astype("S1")).decode()
        if isinstance(val, bytes):
            return val.decode()
        return str(val)

    def channel_names(self) -> "list[str] | None":
        """Names from ``/DataSetInfo/Channel <c>`` ``Name`` attributes, or
        None when absent."""
        names = []
        for c in range(self.n_channels):
            try:
                names.append(self._decode_attr(
                    self._f.node(f"DataSetInfo/Channel {c}").attrs["Name"]))
            except KeyError:
                return None
        return names

    def read_plane(self, z: int, c: int, t: int) -> np.ndarray:
        path = f"DataSet/ResolutionLevel 0/TimePoint {t}/Channel {c}/Data"
        try:
            data = self._f.node(path)
            if not isinstance(data, hdf5.Dataset):
                raise KeyError(path)
            if len(data.shape) != 3:
                raise MetadataError(
                    f"corrupt Imaris data in {self.filename}: {path} has shape {data.shape}")
            plane = data[z, : self.height, : self.width]
        except KeyError as exc:
            raise MetadataError(f"missing {path} in {self.filename}") from exc
        except IndexError as exc:
            raise MetadataError(
                f"corrupt Imaris data in {self.filename}: IndexError: {exc}") from exc
        if plane.dtype.kind in "iu":
            return np.clip(plane, 0, 65535).astype(np.uint16)
        return plane.astype(np.float32)

    def read_plane_linear(self, page: int) -> np.ndarray:
        ct, t = divmod(page, self.n_tpoints)
        c, z = divmod(ct, self.n_zplanes)
        return self.read_plane(z, c, t)


class DatasetReader(Reader):
    """HDF5 dataset reader (reference ``DatasetReader``,
    ``tmlibrary_tpu/readers.py:2945-2974``) on the port's HDF5 code:
    ``read`` (KeyError for a missing path or a dangling soft link; the
    array as h5py returns it), ``list_datasets`` and ``exists`` (h5py's
    ``in``: a dangling soft link exists)."""

    def __enter__(self):
        self._f = hdf5.File(self.filename)
        return self

    def __exit__(self, *exc):
        return False

    def read(self, path: str) -> np.ndarray:
        node = self._f.resolve(path)
        if node is None:
            raise KeyError(f"no dataset '{path}' in {self.filename}")
        return np.asarray(self._f.node(path).read())

    def list_datasets(self, group: str = "/") -> "list[str]":
        """Every dataset below ``group``, relative to it, in h5py's
        ``visititems`` order (no data is read)."""
        return self._f.datasets(group)

    def exists(self, path: str) -> bool:
        return self._f.exists(path)


class JsonReader(Reader):
    def read(self):
        return json.loads(self.filename.read_text())


class XmlReader(Reader):
    def read(self) -> ElementTree.Element:
        return ElementTree.fromstring(self.filename.read_text())


class TablesReader(Reader):
    """Tabular reader (reference ``TablesReader``,
    ``tmlibrary_tpu/readers.py:2986-2997``, which returns a pandas
    DataFrame): ``.parquet`` through :mod:`tmlibrary_tpu_torch.io.parquet`
    and ``.csv`` through :mod:`csv`, read into an ordered ``{column:
    np.ndarray}`` whose names, order, dtypes and values are the
    DataFrame's ``df[c].to_numpy()``.  CSV columns take pandas' inference:
    int64 when every field is an integer, float64 when every field is a
    number or empty (empty as NaN), bool for ``True``/``False``, else
    object strings (empty as NaN)."""

    def read(self) -> "dict[str, np.ndarray]":
        suffix = self.filename.suffix.lower()
        if suffix == ".parquet":
            from tmlibrary_tpu_torch.io import parquet

            return {k: v.astype(object) if v.dtype.kind == "U" else v
                    for k, v in parquet.read_table(self.filename).items()}
        if suffix == ".csv":
            return _read_csv(self.filename)
        raise NotSupportedError(f"unsupported table format '{suffix}'")


def _csv_column(values: "list[str]") -> np.ndarray:
    """One CSV column with pandas' ``read_csv`` type inference."""
    present = [v for v in values if v != ""]
    if present:
        try:
            ints = [int(v) for v in present]
            if len(present) == len(values) and all(-2**63 <= i < 2**63 for i in ints):
                return np.array(ints, np.int64)
        except ValueError:
            pass
        try:
            return np.array([float(v) if v != "" else np.nan for v in values], np.float64)
        except ValueError:
            pass
        if len(present) == len(values) and set(present) <= {"True", "False", "true", "false",
                                                           "TRUE", "FALSE"}:
            return np.array([v.lower() == "true" for v in values])
    else:
        return np.full(len(values), np.nan)
    return np.array([v if v != "" else np.nan for v in values], dtype=object)


def _read_csv(path) -> "dict[str, np.ndarray]":
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise MetadataError(f"{path}: no columns to parse from file")
    header, body = rows[0], rows[1:]
    return {name: _csv_column([r[i] if i < len(r) else "" for r in body])
            for i, name in enumerate(header)}
